"""Paper Fig. 13: sensitivity to stacked-layer count (2/4/8 layers) (port
of ``benchmarks/paper_fig13.py``).

All layer counts share one batch (rank axes padded to the 8-layer SLR
width): cells group by their core count and banks per rank only, so on a
card the whole figure is one kernel launch per shape group."""
import numpy as np

from repro_torch.benchmarks._util import (FigureRecord, main_args,
                                          perf_block, scaled, timed_sweep)
from repro_torch.core.smla import sweep
from repro_torch.core.smla.analytic import default_horizon
from repro_torch.core.smla.config import paper_configs
from repro_torch.core.smla.energy import energy_from_metrics
from repro_torch.core.smla.engine import SimOptions
from repro_torch.core.smla.traces import WORKLOADS

SMLA = ("dedicated_slr", "cascaded_slr", "dedicated_mlr", "cascaded_mlr")
LAYERS = (2, 4, 8)


def grid(n_mixes: int, n_req: int, horizon: int | None = None,
         seed: int = 1, device: str = "cuda") -> sweep.SweepSpec:
    """The figure's sweep: layer counts x mixes of two workloads x 5 IO
    models."""
    rng = np.random.default_rng(seed)
    cells = []
    for layers in LAYERS:
        cfgs = paper_configs(layers)
        for m in range(n_mixes):
            specs = [WORKLOADS[i] for i in
                     rng.choice(len(WORKLOADS), 2, replace=False)]
            for cname, sc in cfgs.items():
                cells.append(sweep.make_cell(
                    f"L{layers}/m{m}/{cname}", sc, specs, n_req,
                    seed=seed + m))
    if horizon is None:
        horizon = scaled(default_horizon(cells), 6_000)
    return sweep.SweepSpec(tuple(cells), options=SimOptions(
        horizon=horizon, device=device))


def run(n_mixes: int = 4, n_req: int = 500, horizon: int | None = None,
        seed: int = 1, *, device: str = "cuda") -> list[str]:
    n_mixes = scaled(n_mixes, 2)
    n_req = scaled(n_req, 80)
    spec = grid(n_mixes, n_req, horizon, seed, device)
    cells, horizon = spec.cells, spec.options.horizon
    cfg_of = {c.name: c.stack for c in cells}
    res, wall, launches = timed_sweep("fig13", spec)

    rows = ["layers,config,ws_vs_baseline,energy_vs_baseline,pd_frac"]
    table = []
    for layers in LAYERS:
        acc = {k: ([], [], []) for k in SMLA}
        for m in range(n_mixes):
            base = res[f"L{layers}/m{m}/baseline"]
            base_e = energy_from_metrics(
                cfg_of[f"L{layers}/m{m}/baseline"], base).total_nj
            for k in acc:
                name = f"L{layers}/m{m}/{k}"
                mm = res[name]
                acc[k][0].append(float(np.mean(
                    mm["ipc"] / np.maximum(base["ipc"], 1e-9))))
                acc[k][1].append(
                    energy_from_metrics(cfg_of[name], mm).total_nj / base_e)
                acc[k][2].append(float(mm["pd_frac"]))
        for k, (ws, en, pd) in acc.items():
            rows.append(f"{layers},{k},{np.mean(ws):.3f},{np.mean(en):.3f},"
                        f"{np.mean(pd):.3f}")
            table.append(dict(layers=layers, config=k,
                              ws=float(np.mean(ws)),
                              energy=float(np.mean(en)),
                              pd_frac=float(np.mean(pd))))
    rows.append("# paper: benefits grow with layer count under SLR; "
                "8-layer DIO edges CIO (upper-layer command bandwidth)")
    perf = perf_block(wall, res, horizon)
    rows.append(f"# sweep: {len(cells)} cells on {res.device}, {launches} "
                f"launches, {wall:.3f}s wall, early-exit saved "
                f"{perf['early_exit_frac']:.0%} of chunks")
    FigureRecord.from_sweep("fig13", res, wall, horizon=horizon,
                            launches=launches, include_scalars=False,
                            extra={"n_mixes": n_mixes, "n_req": n_req,
                                   "rows": table}).emit()
    return rows


if __name__ == "__main__":
    print("\n".join(run(device=main_args(__doc__).device)))
