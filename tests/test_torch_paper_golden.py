"""The golden file of the reference's full-size run
(``tests/torch_golden/paper_figs.json``) is fresh: Tables 1-2 and Fig. 14
regenerated from the reference by the generator's own `make_section`
equal it, every port module's grid at the golden's sizes has the
golden's cells, horizons and window depths (grids built, not run), and
the fig_scale section was made from the port's sizes, grids and prune
configuration."""
import json

import pytest

pytest.importorskip("torch")

from torch_paper import assert_same, make_paper_figs  # noqa: E402

from repro_torch.benchmarks import (paper_fig11, paper_fig12,  # noqa: E402
                                    paper_fig13, paper_fig14,
                                    paper_fig_fault, paper_fig_ooo,
                                    paper_fig_policy, paper_fig_refresh,
                                    paper_fig_scale)
from repro_torch.core.smla import sweep  # noqa: E402

GOLDEN = json.loads(make_paper_figs.GOLDEN.read_text())


@pytest.mark.parametrize("section", ["table1", "table2", "fig14"])
def test_golden_is_fresh(section, monkeypatch):
    monkeypatch.delenv("SMLA_SMOKE", raising=False)
    assert_same(make_paper_figs.make_section(section), GOLDEN[section],
                section)


def _port_specs(section: str, n_req: int) -> list:
    if section == "fig11":
        return [paper_fig11.grid(n_req)]
    if section == "fig12":
        return [paper_fig12.grid(GOLDEN["fig12"]["extra"]["n_mixes"],
                                 n_req)[0]]
    if section == "fig13":
        return [paper_fig13.grid(GOLDEN["fig13"]["extra"]["n_mixes"],
                                 n_req)]
    if section == "fig14":
        return [paper_fig14.grid(n_req)]
    if section == "fig_policy":
        return [paper_fig_policy.grid(n_req)]
    if section == "fig_ooo":
        return list(paper_fig_ooo.grid(n_req).values())
    if section == "fig_fault":
        return [paper_fig_fault.grid(n_req)]
    return [paper_fig_refresh.grid(n_req)]


@pytest.mark.parametrize("section", ["fig11", "fig12", "fig13", "fig14",
                                     "fig_policy", "fig_ooo",
                                     "fig_refresh", "fig_fault"])
def test_golden_cells_are_the_ports_grid(section, monkeypatch):
    monkeypatch.delenv("SMLA_SMOKE", raising=False)
    want = GOLDEN[section]["sweeps"]
    specs = _port_specs(section, want[0]["n_req"])
    got = [(s.options.horizon, s.core.window,
            [c.name for c in sweep._sweep_cells(s)]) for s in specs]
    assert got == [(w["horizon"], w["window"], w["names"]) for w in want]


def test_golden_provenance():
    prov = GOLDEN["provenance"]
    assert prov["jax"] and prov["commit"]
    assert make_paper_figs.GOLDEN.stat().st_size < 1 << 20
    assert set(make_paper_figs.SECTIONS) <= set(GOLDEN)


def test_golden_fig_scale_provenance():
    """fig_scale's section: the port's full sizes, request count,
    horizon, workload and layers, each size's cell names in the port's
    grid order with a bandwidth and a checksum each, and the prune
    child's configuration and accounting."""
    sec = GOLDEN["fig_scale"]
    cfg = sec["config"]
    w = paper_fig_scale.STREAM
    assert cfg["sizes"] == list(paper_fig_scale.SIZES_FULL)
    assert (cfg["n_req"], cfg["horizon"]) == (120, 6_000)
    assert cfg["layers"] == list(paper_fig_scale.LAYERS)
    assert cfg["workload"] == [w.name, w.mpki, w.row_hit, w.write_frac]
    for k in paper_fig_scale.SIZES_FULL:
        got = sec["sizes"][str(k)]
        names = [c.name for c in paper_fig_scale.size_cells(k, 8)]
        assert got["names"] == names and got["n_cells"] == 10 * k
        assert len(got["bandwidth_gbps"]) == len(names)
        assert abs(sum(got["bandwidth_gbps"]) - got["checksum_bandwidth"]) \
            <= 1e-9 * got["checksum_bandwidth"]
    pc, pr = cfg["prune"], paper_fig_scale.PRUNE
    assert (pc["n_cells"], pc["n_req"], pc["horizon"]) == (20_000, 10, 1_024)
    assert (pc["horizon_frac"], pc["keep_frac"], pc["rounds"]) == \
        (pr.horizon_frac, pr.keep_frac, pr.rounds)
    prune = sec["prune"]
    cells = paper_fig_scale.prune_cells(pc["n_cells"], 4)
    assert prune["n_cells"] == len(cells) == 20_000
    assert set(prune["promoted"]) <= {c.name for c in cells}
    assert prune["n_promoted"] == len(prune["promoted"]) == 5_000
    assert prune["prune_work"]["saved_frac"] >= 0.5
