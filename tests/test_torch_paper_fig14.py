"""Fig. 14 through the port (`repro_torch.benchmarks.paper_fig14`) against
the reference's module on the same reduced MPKI ladder: every cell's
metrics (ints exact, floats rtol=1e-6), the printed rows and the JSON
record's `extra`."""
import pytest

pytest.importorskip("torch")

from torch_paper import assert_same, run_both  # noqa: E402

from benchmarks import paper_fig14 as ref_fig  # noqa: E402
from repro_torch.benchmarks import paper_fig14 as port_fig  # noqa: E402


def test_fig14_matches_reference(monkeypatch, tmp_path):
    got, want = run_both(monkeypatch, tmp_path, ref_fig, port_fig, "fig14",
                         {"MPKIS": (25.6, 51.2)}, n_req=16)
    assert [len(s["names"]) for s in got["sweeps"]] == [10]
    assert got["extra"]["n_req"] == 16
    assert_same(got, want, "fig14")
