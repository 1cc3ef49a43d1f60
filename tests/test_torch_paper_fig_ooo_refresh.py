"""fig_ooo and fig_refresh through the port
(`repro_torch.benchmarks.paper_fig_ooo`, `paper_fig_refresh`) against the
reference's modules on the same reduced grids: every cell's metrics (ints
exact, floats rtol=1e-6), the printed rows and the JSON record's
`extra`; fig_refresh's own gates (debt repaid, self-refresh cuts idle
standby energy) hold on the port."""
import pytest

pytest.importorskip("torch")

from torch_paper import assert_same, run_both  # noqa: E402

from benchmarks import paper_fig_ooo as ref_ooo  # noqa: E402
from benchmarks import paper_fig_refresh as ref_refresh  # noqa: E402
from repro.core.smla import policies as ref_policies  # noqa: E402
from repro_torch.benchmarks import paper_fig_ooo as port_ooo  # noqa: E402
from repro_torch.benchmarks import paper_fig_refresh as port_refresh  # noqa: E402
from repro_torch.core.smla import policies as port_policies  # noqa: E402
from repro_torch.core.smla import sweep  # noqa: E402


def test_fig_ooo_matches_reference(monkeypatch, tmp_path):
    sel = ("in_order", "row_dir")
    patches = {"WORKLOAD_IDS": (28,), "WINDOWS": (1, 4)}
    for mod in (ref_ooo, port_ooo):
        monkeypatch.setattr(mod, "OOO_POLICIES",
                            {k: mod.OOO_POLICIES[k] for k in sel})
    got, want = run_both(monkeypatch, tmp_path, ref_ooo, port_ooo,
                         "fig_ooo", patches, n_req=12)
    assert [(s["window"], len(s["names"])) for s in got["sweeps"]] == \
        [(1, 10), (4, 10)]
    assert got["extra"]["launches_per_window"] == {"1": 0, "4": 0}
    assert_same(got, want, "fig_ooo")


def test_fig_refresh_matches_reference(monkeypatch, tmp_path):
    for pol in (ref_policies, port_policies):
        monkeypatch.setattr(pol, "REFRESH_PRESETS", {
            k: pol.REFRESH_PRESETS[k] for k in ("default", "self_refresh")})
    got, want = run_both(monkeypatch, tmp_path, ref_refresh, port_refresh,
                         "fig_refresh", {}, n_req=8)
    assert [len(s["names"]) for s in got["sweeps"]] == [20]
    assert_same(got, want, "fig_refresh")


def test_fig_ooo_one_launch_per_window():
    specs = port_ooo.grid(n_req=8)
    assert list(specs) == list(port_ooo.WINDOWS)
    assert [sweep.shape_groups(s) for s in specs.values()] == [1, 1, 1]
    assert sweep.shape_groups(port_refresh.grid(n_req=8)) == 1
