"""Out-of-order controller sweep: transaction-window depth x OooSelect
across all five IO models (port of ``benchmarks/paper_fig_ooo.py``).

The paper's bandwidth claims assume the controller keeps every layer's
global bitlines busy; this figure measures how much *controller
sophistication* it takes.  The engine's tagged split-transaction window
(`CoreParams.window`, a static depth knob like `q_size`) is swept against
the `OooSelect` selection policy (IN_ORDER | ROW_GROUP | DIR_BATCH |
ROW_DIR) over every IO model x a read-mostly and a write-heavy workload.
Each row reports weighted speedup relative to the *degenerate point* —
window=1 + IN_ORDER, i.e. the plain FR-FCFS engine — plus the two
attribution counters that say WHERE a gain came from: row-hit rate
(`n_row_hit`/served, what ROW_GROUP chases) and the write-turnaround
stall fraction (`wtr_stall_cycles`/makespan, what DIR_BATCH amortises).

Launch structure, checked: the OooSelect axis is a per-cell selector, so
within one window depth the whole selection x IO-model grid is ONE shape
group.  The window depth sizes the in-flight arrays, so each depth is its
own `SweepSpec` and its own launch on a card — 3 depths => 3 launches,
never 3 x 4 selections.
"""
import numpy as np

from repro_torch.benchmarks._util import (FigureRecord, main_args,
                                          perf_block, scaled, timed_sweep)
from repro_torch.core.smla import sweep
from repro_torch.core.smla.analytic import default_horizon
from repro_torch.core.smla.config import (ControllerPolicy, OooSelect,
                                          paper_configs)
from repro_torch.core.smla.engine import CoreParams, SimOptions
from repro_torch.core.smla.traces import WORKLOADS

#: the two ends of the reorder-sensitivity range: a read-mostly low-MPKI
#: mix (row grouping dominates) and a write-heavy stream (turnaround
#: batching dominates)
WORKLOAD_IDS = (4, 26)                     # low.05, stream.1

#: transaction-window depths (multiplies the MSHR file; 1 = the
#: degenerate in-order-window point the golden grid pins)
WINDOWS = (1, 2, 4)

OOO_POLICIES = {o.name.lower(): ControllerPolicy(ooo=o) for o in OooSelect}


def grid(n_req: int, horizon: int | None = None, seed: int = 0,
         device: str = "cuda") -> dict[int, sweep.SweepSpec]:
    """The figure's sweeps, one per window depth: the workloads (two
    cores each) x 5 IO models, crossed with every OooSelect."""
    wls = [WORKLOADS[i] for i in WORKLOAD_IDS]
    cells = sweep.paper_grid([(w.name, [w, w], seed) for w in wls],
                             layers=(4,), n_req=n_req)
    pols = tuple(OOO_POLICIES.values())
    specs = {}
    for w in WINDOWS:
        core = CoreParams(window=w)
        hz = horizon if horizon is not None else scaled(default_horizon(
            sweep.policy_cells(cells, pols), core), 6_000)
        specs[w] = sweep.SweepSpec(tuple(cells), options=SimOptions(
            horizon=hz, device=device), policies=pols, core=core)
    return specs


def run(n_req: int = 400, horizon: int | None = None,
        seed: int = 0, *, device: str = "cuda") -> list[str]:
    n_req = scaled(n_req, 80)
    cfgs = paper_configs(4)
    wls = [WORKLOADS[i] for i in WORKLOAD_IDS]
    specs = grid(n_req, horizon, seed, device)
    n_cells = len(specs[WINDOWS[0]].cells)

    results, launches_per_window, wall = {}, {}, 0.0
    for w, spec in specs.items():
        res, dt, n = timed_sweep(f"fig_ooo window={w}", spec)
        results[w] = res
        launches_per_window[w] = n
        wall += dt

    def metrics(w, cname, wname, pol):
        return results[w][f"L4/{cname}/{wname}|{pol.tag}"]

    rows = ["config,window,ooo,ws_vs_inorder_w1,row_hit_rate,"
            "wtr_stall_frac,ooo_retire_per_req,complete_frac"]
    table = []
    n_incomplete = 0
    for cname in cfgs:
        for w in WINDOWS:
            for pname, pol in OOO_POLICIES.items():
                ws, hitr, stallf, oooq, compl = [], [], [], [], []
                for wl in wls:
                    base = metrics(1, cname, wl.name,
                                   OOO_POLICIES["in_order"])
                    m = metrics(w, cname, wl.name, pol)
                    ws.append(float(np.mean(
                        m["ipc"] / np.maximum(base["ipc"], 1e-9))))
                    served = max(int(np.asarray(m["served"]).sum()), 1)
                    hitr.append(int(m["n_row_hit"]) / served)
                    mk_cyc = max(float(m["makespan_ns"])
                                 / cfgs[cname].unit_ns, 1.0)
                    stallf.append(int(m["wtr_stall_cycles"]) / mk_cyc)
                    oooq.append(int(m["n_ooo_retire"]) / served)
                    done = bool(np.asarray(m["complete"]).all())
                    compl.append(float(done))
                    n_incomplete += not done
                vals = dict(config=cname, window=w, ooo=pname,
                            ws=float(np.mean(ws)),
                            row_hit_rate=float(np.mean(hitr)),
                            wtr_stall_frac=float(np.mean(stallf)),
                            ooo_retire_per_req=float(np.mean(oooq)),
                            complete_frac=float(np.mean(compl)))
                table.append(vals)
                rows.append(
                    f"{cname},{w},{pname},{vals['ws']:.3f},"
                    f"{vals['row_hit_rate']:.3f},"
                    f"{vals['wtr_stall_frac']:.4f},"
                    f"{vals['ooo_retire_per_req']:.3f},"
                    f"{vals['complete_frac']:.2f}")
    rows.append("# ws is relative to window=1 + IN_ORDER (the plain "
                "FR-FCFS engine) per IO model; row_hit_rate and "
                "wtr_stall_frac attribute the gain (ROW_GROUP raises the "
                "former, DIR_BATCH lowers the latter).  complete_frac < 1 "
                "(smoke's pinned horizon) marks horizon-truncated "
                "trend-only rows")
    res_last = results[WINDOWS[-1]]
    hz_last = specs[WINDOWS[-1]].options.horizon
    perf = perf_block(wall, res_last, hz_last)
    total_launches = sum(launches_per_window.values())
    rows.append(f"# sweep: {sum(len(r.names) for r in results.values())} "
                f"cells ({n_cells} x {len(OOO_POLICIES)} selections x "
                f"{len(WINDOWS)} windows) on {res_last.device}, "
                f"{total_launches} launches ({dict(launches_per_window)} "
                f"per depth — the OoO axis itself adds none), {wall:.3f}s "
                f"wall, early-exit saved {perf['early_exit_frac']:.0%} of "
                f"chunks")
    FigureRecord.from_sweep("fig_ooo", res_last, wall, horizon=hz_last,
                            launches=total_launches, extra={
        "n_req": n_req, "windows": list(WINDOWS),
        "n_selections": len(OOO_POLICIES),
        "launches_per_window": {str(k): v
                                for k, v in launches_per_window.items()},
        "n_incomplete": n_incomplete,
        "rows": table,
    }).emit()
    return rows


if __name__ == "__main__":
    print("\n".join(run(device=main_args(__doc__).device)))
