"""Tables 1 and 2 and the shared helpers of the port's paper outputs:
`repro_torch.benchmarks.paper_table1`/`paper_table2` print the
reference's rows exactly; the port's `_util.perf_block` of a port
`SweepResult` equals the reference's `perf_block` of the same numbers;
a `FigureRecord` survives emit -> from_json; ``run.py --smoke --only
paper_table1 --device cpu`` exits 0 without touching the reference's
``BENCH_smla_sweep.json``."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import torch_paper  # noqa: E402,F401  (puts the repository root on sys.path)

from benchmarks import _util as ref_util  # noqa: E402
from benchmarks import paper_table1 as ref_t1  # noqa: E402
from benchmarks import paper_table2 as ref_t2  # noqa: E402
from repro_torch.benchmarks import _util  # noqa: E402
from repro_torch.benchmarks import assert_early_exit  # noqa: E402
from repro_torch.benchmarks import paper_table1 as port_t1  # noqa: E402
from repro_torch.benchmarks import paper_table2 as port_t2  # noqa: E402
from repro_torch.core.smla import sweep  # noqa: E402
from repro_torch.core.smla.engine import SimOptions  # noqa: E402
from repro_torch.core.smla.traces import WORKLOADS  # noqa: E402


@pytest.mark.parametrize("ref, port", [(ref_t1, port_t1), (ref_t2, port_t2)],
                         ids=["table1", "table2"])
def test_table_rows_match_reference(ref, port):
    assert port.PAPER == ref.PAPER
    assert port.run() == ref.run()


@pytest.fixture(scope="module")
def small_result():
    """A port sweep on the CPU: 2 workloads x 5 IO models, n_req 12."""
    wls = [w for w in WORKLOADS if w.name in ("stream.1", "stream.3")]
    cells = sweep.paper_grid([(w.name, [w], 0) for w in wls], n_req=12)
    spec = sweep.SweepSpec(tuple(cells), SimOptions(horizon=3000,
                                                    device="cpu"))
    res, wall, launches = _util.timed_sweep("small", spec)
    assert launches == 0 and res.device == "cpu"
    return res, wall


def test_perf_block_matches_reference(small_result):
    res, wall = small_result
    got = _util.perf_block(wall, res, 3000)
    assert got == ref_util.perf_block(wall, res, 3000)
    assert got["chunks_run_total"] == int(
        res.scalars(("chunks_run",))["chunks_run"].sum())


def test_figure_record_round_trip(small_result, tmp_path):
    res, wall = small_result
    path = str(tmp_path / "bench.json")
    rec = _util.FigureRecord.from_sweep("fig_small", res, wall,
                                        horizon=3000, launches=0,
                                        extra={"n_req": 12})
    rec.emit(path)
    data = json.loads(open(path).read())
    assert data["fig_small"]["n_req"] == 12
    assert data["fig_small"]["launches"] == 0
    assert "compiles" not in data["fig_small"]
    back = _util.FigureRecord.from_json("fig_small", data["fig_small"])
    assert back.backend == "cpu" and back.launches == 0
    assert back.cell_names == res.names and back.perf == rec.perf
    np.testing.assert_array_equal(back.scalars["chunks_run"],
                                  rec.scalars["chunks_run"])
    assert back.early_exit_cells() == rec.early_exit_cells()
    assert assert_early_exit.check_figure("fig_small", data) is None
    assert "no fig11 perf section" in assert_early_exit.check_figure(
        "fig11", data)


def test_bench_json_default_is_the_ports_own(monkeypatch, tmp_path):
    assert _util.BENCH_JSON_DEFAULT == "BENCH_smla_sweep_torch.json"
    assert ref_util.BENCH_JSON_DEFAULT != _util.BENCH_JSON_DEFAULT
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("BENCH_JSON", raising=False)
    assert _util.emit_json("s", {"x": 1}) == "BENCH_smla_sweep_torch.json"
    assert os.listdir(tmp_path) == ["BENCH_smla_sweep_torch.json"]


def test_run_smoke_table1(tmp_path):
    root = torch_paper.TESTS.parent
    before = (root / "BENCH_smla_sweep.json").read_bytes()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(root / "src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--smoke",
         "--only", "paper_table1", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "1/1 benchmarks ok" in r.stdout
    assert "Read wo Standby (nJ),1.93,1.93,1.93,1.93,True" in r.stdout
    assert (root / "BENCH_smla_sweep.json").read_bytes() == before


def test_run_rejects_unknown_module(tmp_path):
    from repro_torch.benchmarks import run
    assert run.main(["--only", "paper_fig_nope"]) == 2


def test_figures_ask_for_the_card_by_default(monkeypatch, tmp_path):
    """A figure run with no device named goes to the card and raises
    where there is none; it never falls back to the CPU."""
    import torch
    from repro_torch.benchmarks import paper_fig14
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("BENCH_JSON", str(tmp_path / "bench.json"))
    assert paper_fig14.grid(8).options.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper_fig14.run(n_req=8)
    assert not (tmp_path / "bench.json").exists()
