"""Paper Fig. 12: multi-programmed weighted speedup + energy, 4/8/16 cores
(port of ``benchmarks/paper_fig12.py``).

Channel model: the paper's 16-core system has 4 channels -> 4 cores/channel;
we simulate one channel with cores/4 cores and report per-config means over
`n_mixes` random mixes (paper: 16 mixes/pool).

The full grid (3 core counts x mixes x 5 configs) runs through the batched
sweep engine — cells sharing a core count share one shape group, so on a
card the whole figure is one kernel launch per core count.  One grid cell
is cross-checked bit-for-bit against a standalone `simulate()` call on the
same device (on a card, one more launch)."""
import numpy as np

from repro_torch.benchmarks._util import (FigureRecord, main_args,
                                          perf_block, scaled, timed_sweep)
from repro_torch.core.smla import engine, sweep
from repro_torch.core.smla.analytic import default_horizon
from repro_torch.core.smla.config import paper_configs
from repro_torch.core.smla.energy import energy_from_metrics
from repro_torch.core.smla.engine import SimOptions
from repro_torch.core.smla.traces import WORKLOADS

SMLA = ("dedicated_slr", "cascaded_slr", "dedicated_mlr", "cascaded_mlr")
CORES = (4, 8, 16)


def grid(n_mixes: int, n_req: int, horizon: int | None = None,
         seed: int = 0, device: str = "cuda"
         ) -> tuple[sweep.SweepSpec, dict]:
    """The figure's sweep and its workload mixes {(cores, m): names}."""
    rng = np.random.default_rng(seed)
    cfgs = paper_configs(4)
    cells, mixes = [], {}
    for cores in CORES:
        per_chan = max(cores // 4, 1)
        for m in range(n_mixes):
            specs = [WORKLOADS[i] for i in
                     rng.choice(len(WORKLOADS), per_chan, replace=False)]
            mixes[(cores, m)] = [s.name for s in specs]
            for cname, sc in cfgs.items():
                cells.append(sweep.make_cell(
                    f"c{cores}/m{m}/{cname}", sc, specs, n_req,
                    seed=seed + m))
    if horizon is None:
        horizon = scaled(default_horizon(cells), 6_000)
    return sweep.SweepSpec(tuple(cells), options=SimOptions(
        horizon=horizon, device=device)), mixes


def run(n_mixes: int = 6, n_req: int = 500, horizon: int | None = None,
        seed: int = 0, *, device: str = "cuda") -> list[str]:
    n_mixes = scaled(n_mixes, 2)
    n_req = scaled(n_req, 80)
    cfgs = paper_configs(4)
    spec, mixes = grid(n_mixes, n_req, horizon, seed, device)
    cells, horizon = spec.cells, spec.options.horizon
    res, wall, launches = timed_sweep("fig12", spec)

    # acceptance cross-check: one cell must equal the per-config path exactly
    probe = cells[0]
    ref = engine.simulate(probe.stack, probe.traces, spec.options)
    assert np.array_equal(ref["ipc"].cpu().numpy(), res[probe.name]["ipc"]), \
        "sweep metrics diverge from per-config simulate()"

    rows = ["cores,config,ws_vs_baseline,energy_vs_baseline,"
            "pd_frac,wr_share"]
    table = []
    for cores in CORES:
        acc = {k: ([], [], [], []) for k in SMLA}
        for m in range(n_mixes):
            base = res[f"c{cores}/m{m}/baseline"]
            base_e = energy_from_metrics(cfgs["baseline"], base).total_nj
            for k in acc:
                mm = res[f"c{cores}/m{m}/{k}"]
                acc[k][0].append(float(np.mean(
                    mm["ipc"] / np.maximum(base["ipc"], 1e-9))))
                acc[k][1].append(
                    energy_from_metrics(cfgs[k], mm).total_nj / base_e)
                acc[k][2].append(float(mm["pd_frac"]))
                acc[k][3].append(int(mm["n_wr"])
                                 / max(int(np.asarray(mm["served"]).sum()),
                                       1))
        for k, (ws, en, pd, wshare) in acc.items():
            rows.append(f"{cores},{k},{np.mean(ws):.3f},{np.mean(en):.3f},"
                        f"{np.mean(pd):.3f},{np.mean(wshare):.3f}")
            table.append(dict(cores=cores, config=k,
                              ws=float(np.mean(ws)),
                              energy=float(np.mean(en)),
                              pd_frac=float(np.mean(pd)),
                              wr_share=float(np.mean(wshare))))
    rows.append("# paper: 16-core SLR ws +50.4% DIO / +55.8% CIO; "
                "energy -17.9% (CIO SLR); MLR below SLR")
    perf = perf_block(wall, res, horizon)
    rows.append(f"# sweep: {len(cells)} cells on {res.device}, {launches} "
                f"launches, {wall:.3f}s wall, early-exit saved "
                f"{perf['early_exit_frac']:.0%} of chunks")
    FigureRecord.from_sweep("fig12", res, wall, horizon=horizon,
                            launches=launches, include_scalars=False,
                            extra={
        "n_mixes": n_mixes, "n_req": n_req,
        "mixes": {f"c{c}/m{m}": v for (c, m), v in mixes.items()},
        "rows": table,
    }).emit()
    return rows


if __name__ == "__main__":
    print("\n".join(run(device=main_args(__doc__).device)))
