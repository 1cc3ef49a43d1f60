"""fig_fault through the port (`repro_torch.benchmarks.paper_fig_fault`)
against the reference's module on the same reduced grid (cascaded_slr,
the figure's headline config, x its 9 fault rows): every cell's metrics
(ints exact, floats rtol=1e-6), the printed rows and the JSON record's
`extra`; the figure's own gates (work conserved, monotone bandwidth,
RETIME beats COLLAPSE) hold on the port, and the early-exit gate's
fig_fault section passes on its record and fails on a doctored one."""
import json

import pytest

pytest.importorskip("torch")

from torch_paper import assert_same, run_both  # noqa: E402

from benchmarks import paper_fig_fault as ref_fig  # noqa: E402
from repro_torch.benchmarks import assert_early_exit  # noqa: E402
from repro_torch.benchmarks import paper_fig_fault as port_fig  # noqa: E402
from repro_torch.core.smla import sweep  # noqa: E402


@pytest.mark.parametrize("validate", [False, True])
def test_fig_fault_matches_reference(monkeypatch, tmp_path, validate):
    got, want = run_both(monkeypatch, tmp_path, ref_fig, port_fig,
                         "fig_fault", {"CONFIG_NAMES": ("cascaded_slr",)},
                         n_req=12, validate=validate)
    assert [len(s["names"]) for s in got["sweeps"]] == [9]
    assert got["extra"]["validate"] is validate
    assert len(got["extra"]["rows"]) == 9
    assert_same(got, want, "fig_fault")
    bench = json.loads((tmp_path / f"{port_fig.__name__}.json").read_text())
    assert bench["fig_fault"]["launches"] == 0          # the CPU: no kernel
    assert assert_early_exit.check_figure("fig_fault", bench) is None
    doctored = json.loads(json.dumps(bench))
    sec = doctored["fig_fault"]
    sec["scalars"]["chunks_run"] = list(sec["perf"]["cell_n_chunks_max"])
    assert "not engaging" in assert_early_exit.check_figure("fig_fault",
                                                           doctored)


def test_fig_fault_is_one_shape_group_under_record():
    spec = port_fig.grid(n_req=8)
    assert len(spec.cells) == len(port_fig.CONFIG_NAMES) * 9 == 27
    assert sweep.shape_groups(spec) == 1
    assert spec.on_error == "record"
    assert spec.options.device == "cuda"
