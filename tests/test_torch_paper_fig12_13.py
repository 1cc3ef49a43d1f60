"""Figs. 12 and 13 through the port (`repro_torch.benchmarks.paper_fig12`,
`paper_fig13`) against the reference's modules on the same reduced grids
(two core counts / two layer counts, one mix of three memory-bound
workloads): every cell's metrics (ints exact, floats rtol=1e-6), the
printed rows and the JSON record's `extra` (rows, mixes)."""
import pytest

pytest.importorskip("torch")

from torch_paper import assert_same, run_both  # noqa: E402

from benchmarks import paper_fig12 as ref_fig12  # noqa: E402
from benchmarks import paper_fig13 as ref_fig13  # noqa: E402
from repro_torch.benchmarks import paper_fig12 as port_fig12  # noqa: E402
from repro_torch.benchmarks import paper_fig13 as port_fig13  # noqa: E402
from repro_torch.core.smla import sweep  # noqa: E402
from repro_torch.core.smla.traces import WORKLOADS  # noqa: E402

SUBSET = [w for w in WORKLOADS
          if w.name in ("high.10", "stream.2", "stream.3")]


def test_fig12_matches_reference(monkeypatch, tmp_path):
    got, want = run_both(monkeypatch, tmp_path, ref_fig12, port_fig12,
                         "fig12", {"WORKLOADS": SUBSET, "CORES": (4, 8)},
                         n_mixes=1, n_req=12)
    assert [len(s["names"]) for s in got["sweeps"]] == [10]
    assert got["extra"]["mixes"].keys() == {"c4/m0", "c8/m0"}
    assert_same(got, want, "fig12")


def test_fig13_matches_reference(monkeypatch, tmp_path):
    got, want = run_both(monkeypatch, tmp_path, ref_fig13, port_fig13,
                         "fig13", {"WORKLOADS": SUBSET, "LAYERS": (2, 8)},
                         n_mixes=1, n_req=12)
    assert [len(s["names"]) for s in got["sweeps"]] == [10]
    assert_same(got, want, "fig13")


def test_fig12_13_shape_groups(monkeypatch):
    """A card launches the kernel once per shape group: one per core
    count in Fig. 12 (cores/4 per channel), one for all of Fig. 13's
    layer counts (ranks are padded, not grouped on)."""
    spec12, _ = port_fig12.grid(n_mixes=1, n_req=8)
    assert sweep.shape_groups(spec12) == len(port_fig12.CORES) == 3
    assert sweep.shape_groups(port_fig13.grid(n_mixes=1, n_req=8)) == 1
