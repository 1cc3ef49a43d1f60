"""fig_policy through the port (`repro_torch.benchmarks.paper_fig_policy`)
against the reference's module on the same reduced grid (one
memory-bound workload, three controller presets): every cell's metrics
(ints exact, floats rtol=1e-6), the printed rows and the JSON record's
`extra`."""
import pytest

pytest.importorskip("torch")

from torch_paper import assert_same, run_both  # noqa: E402

from benchmarks import paper_fig_policy as ref_fig  # noqa: E402
from repro.core.smla import policies as ref_policies  # noqa: E402
from repro_torch.benchmarks import paper_fig_policy as port_fig  # noqa: E402
from repro_torch.core.smla import policies as port_policies  # noqa: E402
from repro_torch.core.smla import sweep  # noqa: E402

PRESETS = ("default", "closed_page", "self_refresh")


def test_fig_policy_matches_reference(monkeypatch, tmp_path):
    for pol in (ref_policies, port_policies):
        monkeypatch.setattr(pol, "POLICY_PRESETS", {
            k: pol.POLICY_PRESETS[k] for k in PRESETS})
    got, want = run_both(monkeypatch, tmp_path, ref_fig, port_fig,
                         "fig_policy", {"WORKLOAD_IDS": (28,)}, n_req=12)
    assert [len(s["names"]) for s in got["sweeps"]] == [15]
    assert got["extra"]["n_policies"] == 3
    assert_same(got, want, "fig_policy")


def test_fig_policy_is_one_shape_group():
    spec = port_fig.grid(n_req=8)
    assert len(sweep._sweep_cells(spec)) == 10 * len(
        port_policies.POLICY_PRESETS)
    assert sweep.shape_groups(spec) == 1
