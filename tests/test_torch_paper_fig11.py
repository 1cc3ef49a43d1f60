"""Fig. 11 through the port (`repro_torch.benchmarks.paper_fig11`) against
the reference's module on the same reduced workload list: every cell's
metrics (ints exact, floats rtol=1e-6), the printed rows and the JSON
record's `extra`; the port's second pass (the plain version on named
cells) and its record."""
import json

import pytest

pytest.importorskip("torch")

from torch_paper import assert_same, run_both, same_value  # noqa: E402

from benchmarks import paper_fig11 as ref_fig  # noqa: E402
from repro_torch.benchmarks import paper_fig11 as port_fig  # noqa: E402
from repro_torch.core.smla.traces import WORKLOADS  # noqa: E402

#: two memory-bound workloads: short makespans at a tiny n_req
SUBSET = [w for w in WORKLOADS if w.name in ("high.10", "stream.3")]
PROBE = "L4/cascaded_mlr/stream.3"


def test_fig11_matches_reference(monkeypatch, tmp_path):
    got, want = run_both(monkeypatch, tmp_path, ref_fig, port_fig, "fig11",
                         {"WORKLOADS": SUBSET}, n_req=16)
    # the port's second pass (the plain version, every cell off smoke
    # at this size) is held to the reference's cells too
    plain_sweep = got["sweeps"].pop()
    assert [len(s["names"]) for s in got["sweeps"]] == [10]
    assert_same(got, want, "fig11")
    main = want["sweeps"][0]
    assert plain_sweep["names"] == main["names"]
    same_value(plain_sweep["cells"], main["cells"], "fig11.plain")
    plain = [r for r in got["rows"] if r.startswith("# plain version")]
    assert plain and plain[0].startswith("# plain version [cpu]: 10 cells")


def test_fig11_plain_pass_takes_named_cells(monkeypatch, tmp_path):
    monkeypatch.setattr(port_fig, "WORKLOADS", SUBSET)
    monkeypatch.delenv("SMLA_SMOKE", raising=False)
    bench = tmp_path / "bench.json"
    monkeypatch.setenv("BENCH_JSON", str(bench))
    rows = port_fig.run(n_req=16, device="cpu", plain_cells=[PROBE])
    assert any(r.startswith("# plain version [cpu]: 1 cells") for r in rows)
    data = json.loads(bench.read_text())
    assert data["fig11.plain"]["cell_names"] == [PROBE]
    assert data["fig11.plain"]["backend"] == "cpu"
    assert data["fig11"]["launches"] == 0
    assert data["fig11"]["n_cells"] == 10
