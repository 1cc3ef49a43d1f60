"""Paper Fig. 11: single-core performance + energy across 31 workloads,
both rank organisations (port of ``benchmarks/paper_fig11.py``).
Synthetic-trace stand-ins (see core/smla/traces): suite means are the
comparison target; paper values in the footer.

The whole 31-workload x 5-config grid is one shape group: on a card,
ONE launch of the cycle kernel, whatever its buckets' chunk widths.  A
second pass runs cells of the grid through the other executor, the
plain PyTorch version on the CPU, and holds their served counts to the
main pass's."""
import numpy as np

from repro_torch.benchmarks._util import (FigureRecord, main_args,
                                          perf_block, scaled, smoke_mode,
                                          timed_sweep)
from repro_torch.core.smla import sweep
from repro_torch.core.smla.analytic import default_horizon
from repro_torch.core.smla.config import paper_configs
from repro_torch.core.smla.energy import energy_from_metrics
from repro_torch.core.smla.engine import SimOptions
from repro_torch.core.smla.traces import WORKLOADS

#: cells of the plain pass off smoke, as the reference's interpreter pass
PLAIN_CELLS = 25


def grid(n_req: int, horizon: int | None = None,
         device: str = "cuda") -> sweep.SweepSpec:
    """The figure's sweep: every workload x 5 IO models at 4 layers."""
    workloads = [(w.name, [w], 0) for w in WORKLOADS]
    cells = sweep.paper_grid(workloads, layers=(4,), n_req=n_req)
    if horizon is None:
        # analytic worst case for the full run; smoke keeps the historic
        # tiny horizon so its numbers stay comparable across commits
        horizon = scaled(default_horizon(cells), 6_000)
    return sweep.SweepSpec(tuple(cells), options=SimOptions(
        horizon=horizon, device=device))


def run(n_req: int = 600, horizon: int | None = None, *,
        device: str = "cuda", plain_cells=None) -> list[str]:
    """`plain_cells`: names of the cells the plain pass runs; by default
    every cell in smoke, the first PLAIN_CELLS otherwise."""
    n_req = scaled(n_req, 80)
    cfgs = paper_configs(4)
    spec = grid(n_req, horizon, device)
    cells, horizon = spec.cells, spec.options.horizon
    res, wall, launches = timed_sweep("fig11", spec)

    def metrics(cname, wname):
        return res[f"L4/{cname}/{wname}"]

    rows = ["workload,mpki,dio_slr,cio_slr,dio_mlr,cio_mlr,"
            "E_dio_slr,E_cio_slr"]
    per = {k: [] for k in ("dio_slr", "cio_slr", "dio_mlr", "cio_mlr",
                           "e_dio", "e_cio")}
    table = []
    for w in WORKLOADS:
        base = metrics("baseline", w.name)
        base_e = energy_from_metrics(cfgs["baseline"], base).total_nj

        def ws(cname):
            m = metrics(cname, w.name)
            return float(np.mean(m["ipc"] / np.maximum(base["ipc"], 1e-9)))

        def erel(cname):
            return energy_from_metrics(cfgs[cname],
                                       metrics(cname, w.name)).total_nj / base_e

        vals = {
            "dio_slr": ws("dedicated_slr"), "cio_slr": ws("cascaded_slr"),
            "dio_mlr": ws("dedicated_mlr"), "cio_mlr": ws("cascaded_mlr"),
            "e_dio": erel("dedicated_slr"), "e_cio": erel("cascaded_slr"),
        }
        for k, v in vals.items():
            per[k].append(v)
        table.append(dict(workload=w.name, mpki=w.mpki, **vals))
        rows.append(f"{w.name},{w.mpki},{vals['dio_slr']:.3f},"
                    f"{vals['cio_slr']:.3f},{vals['dio_mlr']:.3f},"
                    f"{vals['cio_mlr']:.3f},{vals['e_dio']:.3f},"
                    f"{vals['e_cio']:.3f}")
    gm = lambda v: float(np.exp(np.mean(np.log(np.maximum(v, 1e-9)))))  # noqa: E731
    rows.append(f"GEOMEAN,,{gm(per['dio_slr']):.3f},{gm(per['cio_slr']):.3f},"
                f"{gm(per['dio_mlr']):.3f},{gm(per['cio_mlr']):.3f},"
                f"{gm(per['e_dio']):.3f},{gm(per['e_cio']):.3f}")
    rows.append("# paper (SPEC/TPC/STREAM): SLR +19.2% DIO / +23.9% CIO; "
                "MLR +8.8%; energy +8.6%/+4.6% (single-core)")
    # write / refresh / power-down residency over the whole grid (the
    # energy relatives above already price these via the measured metrics)
    scal = res.scalars()
    rows.append(f"# traffic: {int(scal['n_wr'].sum())} writes retired, "
                f"mean pd_frac {float(scal['pd_frac'].mean()):.3f}, "
                f"{int(scal['refresh_cycles'].sum())} refresh cycles")
    perf = perf_block(wall, res, horizon)
    rows.append(f"# sweep: {len(cells)} cells on {res.device}, {launches} "
                f"launches, {wall:.3f}s wall, {perf['cells_per_s']:.1f} "
                f"cells/s, early-exit saved {perf['early_exit_frac']:.0%} "
                f"of chunks")
    FigureRecord.from_sweep("fig11", res, wall, horizon=horizon,
                            launches=launches, extra={
        "n_req": n_req,
        "geomean": {k: gm(v) for k, v in per.items()},
        "total_n_wr": int(scal["n_wr"].sum()),
        "mean_pd_frac": float(scal["pd_frac"].mean()),
        "total_refresh_cycles": int(scal["refresh_cycles"].sum()),
        "rows": table,
    }).emit()

    # ---- the other executor: cells of the same grid through the plain
    # PyTorch version on the CPU (where the reference runs its Pallas
    # kernel in interpreter mode); on the CPU both passes are the plain
    # version.  Full runs bound it to a sub-grid: the plain version runs
    # hundreds of small tensor ops per simulated cycle.
    if plain_cells is None:
        pl_cells = cells if smoke_mode() else cells[:PLAIN_CELLS]
    else:
        pl_cells = [c for c in cells if c.name in set(plain_cells)]
    spec_p = sweep.SweepSpec(tuple(pl_cells), options=SimOptions(
        horizon=horizon, device="cpu"))
    res_p, wall_p, _ = timed_sweep("fig11.plain", spec_p)
    # cross-executor fidelity (ints must match exactly)
    for name in res_p.names:
        assert np.array_equal(res[name]["served"], res_p[name]["served"]), \
            f"plain version diverged from the {res.device} run on {name}'s " \
            f"served counts"
    rec_p = FigureRecord.from_sweep(
        "fig11.plain", res_p, wall_p, horizon=horizon, launches=0, extra={
            "n_req": n_req, "cells_per_s_main": perf["cells_per_s"]})
    rec_p.emit()
    rows.append(f"# plain version [cpu]: {len(pl_cells)} cells, "
                f"{wall_p:.1f}s wall, {rec_p.perf['cells_per_s']:.1f} "
                f"cells/s ({res.device}: {perf['cells_per_s']:.1f})")
    return rows


if __name__ == "__main__":
    print("\n".join(run(device=main_args(__doc__).device)))
