"""Paper Fig. 14: energy vs. memory intensity (MPKI micro-benchmarks)
(port of ``benchmarks/paper_fig14.py``).

(a) absolute energy normalised to baseline @ lowest MPKI;
(b) energy relative to baseline at the same MPKI.

The micro-benchmarks carry a 25% write mix; each point's energy prices the
engine's *measured* write count and power-down residency (low-MPKI points
spend most rank-cycles powered down, which is exactly the regime where the
SMLA clock-energy overhead dominates).

The MPKI ladder x 5 configs is one shape group: one kernel launch on a
card."""
from repro_torch.benchmarks._util import (FigureRecord, main_args,
                                          perf_block, scaled, timed_sweep)
from repro_torch.core.smla import sweep
from repro_torch.core.smla.analytic import default_horizon
from repro_torch.core.smla.config import paper_configs
from repro_torch.core.smla.energy import energy_from_metrics
from repro_torch.core.smla.engine import SimOptions
from repro_torch.core.smla.traces import WorkloadSpec

MPKIS = (0.4, 1.6, 6.4, 12.8, 25.6, 51.2)


def grid(n_req: int, horizon: int | None = None,
         device: str = "cuda") -> sweep.SweepSpec:
    """The figure's sweep: the MPKI ladder (two cores each) x 5 IO
    models at 4 layers."""
    workloads = [(f"u{mpki}",
                  [WorkloadSpec(f"u{mpki}", mpki, 0.5, write_frac=0.25)] * 2,
                  0)
                 for mpki in MPKIS]
    cells = sweep.paper_grid(workloads, layers=(4,), n_req=n_req)
    if horizon is None:
        horizon = scaled(default_horizon(cells), 6_000)
    return sweep.SweepSpec(tuple(cells), options=SimOptions(
        horizon=horizon, device=device))


def run(n_req: int = 500, horizon: int | None = None, *,
        device: str = "cuda") -> list[str]:
    n_req = scaled(n_req, 80)
    cfgs = paper_configs(4)
    spec = grid(n_req, horizon, device)
    cells, horizon = spec.cells, spec.options.horizon
    res, wall, launches = timed_sweep("fig14", spec)

    def energy(cname, wname):
        return energy_from_metrics(cfgs[cname],
                                   res[f"L4/{cname}/{wname}"]).total_nj

    rows = ["mpki,E_base_norm,E_dio_rel,E_cio_rel,base_pd_frac,n_wr"]
    base0 = None
    rels_d, rels_c, table = [], [], []
    for mpki in MPKIS:
        wname = f"u{mpki}"
        base = energy("baseline", wname)
        if base0 is None:
            base0 = base
        d = energy("dedicated_slr", wname) / base
        c = energy("cascaded_slr", wname) / base
        bm = res[f"L4/baseline/{wname}"]
        pd, nw = float(bm["pd_frac"]), int(bm["n_wr"])
        rels_d.append(d)
        rels_c.append(c)
        table.append(dict(mpki=mpki, base_norm=base / base0,
                          dio_rel=d, cio_rel=c, base_pd_frac=pd, n_wr=nw))
        rows.append(f"{mpki},{base / base0:.3f},{d:.3f},{c:.3f},"
                    f"{pd:.3f},{nw}")
    rows.append(f"# relative overhead shrinks with MPKI: "
                f"dio {rels_d[0]:.3f}->{rels_d[-1]:.3f}, "
                f"cio {rels_c[0]:.3f}->{rels_c[-1]:.3f} "
                f"(paper: overhead decays, CIO ~30% below DIO)")
    perf = perf_block(wall, res, horizon)
    rows.append(f"# sweep: {len(cells)} cells on {res.device}, {launches} "
                f"launches, {wall:.3f}s wall, early-exit saved "
                f"{perf['early_exit_frac']:.0%} of chunks")
    FigureRecord.from_sweep("fig14", res, wall, horizon=horizon,
                            launches=launches, include_scalars=False,
                            extra={"n_req": n_req, "rows": table}).emit()
    return rows


if __name__ == "__main__":
    print("\n".join(run(device=main_args(__doc__).device)))
