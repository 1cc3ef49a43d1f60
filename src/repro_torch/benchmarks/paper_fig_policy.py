"""Controller-policy sensitivity sweep (beyond the paper's fixed
controller) across all five IO models (port of
``benchmarks/paper_fig_policy.py``).

The paper evaluates one memory controller — FR-FCFS, open-page, all-bank
refresh, writes inline.  This figure sweeps the controller-policy
cross-product (`core/smla/policies.POLICY_PRESETS`: the default plus one
single-axis flip per dimension plus the all-flipped corner) over every IO
model x a read-mostly and a write-heavy workload, and reports each
policy's weighted speedup and energy *relative to the same IO model under
the default policy* — i.e. how sensitive each SMLA organisation is to the
controller in front of it.

The whole (config x workload x policy) grid is ONE shape group: policy
selectors are per-cell data, so the policy axis multiplies cells without
multiplying launches (one kernel launch on a card, checked).
"""
import dataclasses

import numpy as np

from repro_torch.benchmarks._util import (FigureRecord, main_args,
                                          perf_block, scaled, timed_sweep)
from repro_torch.core.smla import policies, sweep
from repro_torch.core.smla.analytic import default_horizon
from repro_torch.core.smla.config import paper_configs
from repro_torch.core.smla.energy import energy_from_metrics
from repro_torch.core.smla.engine import SimOptions
from repro_torch.core.smla.traces import WORKLOADS

#: one read-mostly low-MPKI and one write-heavy streaming workload — the
#: two ends of the write-drain / row-policy sensitivity range
WORKLOAD_IDS = (4, 26)                     # low.05, stream.1


def grid(n_req: int, horizon: int | None = None, seed: int = 0,
         device: str = "cuda") -> sweep.SweepSpec:
    """The figure's sweep: the workloads (two cores each) x 5 IO models,
    crossed with every preset of POLICY_PRESETS."""
    wls = [WORKLOADS[i] for i in WORKLOAD_IDS]
    cells = sweep.paper_grid([(w.name, [w, w], seed) for w in wls],
                             layers=(4,), n_req=n_req)
    presets = tuple(policies.POLICY_PRESETS.values())
    if horizon is None:
        # smoke keeps a pinned tiny horizon for cross-commit
        # comparability (cells may not complete — `complete_frac` says
        # which rows to trust); full runs derive the analytic worst case
        # over the POLICY-EXPANDED grid, so e.g. per-bank refresh cells
        # get their own (lighter) refresh inflation
        horizon = scaled(default_horizon(
            sweep.policy_cells(cells, presets)), 6_000)
    return sweep.SweepSpec(tuple(cells), options=SimOptions(
        horizon=horizon, device=device), policies=presets)


def run(n_req: int = 400, horizon: int | None = None,
        seed: int = 0, *, device: str = "cuda") -> list[str]:
    n_req = scaled(n_req, 80)
    cfgs = paper_configs(4)
    wls = [WORKLOADS[i] for i in WORKLOAD_IDS]
    presets = policies.POLICY_PRESETS
    spec = grid(n_req, horizon, seed, device)
    cells, horizon = spec.cells, spec.options.horizon
    res, wall, launches = timed_sweep("fig_policy", spec)

    def metrics(cname, wname, tag):
        return res[f"L4/{cname}/{wname}|{tag}"]

    rows = ["config,policy,ws_vs_default,energy_vs_default,"
            "acts_per_req,rank_blocked_frac,complete_frac"]
    table = []
    n_incomplete = 0
    for cname in cfgs:
        for pname, pol in presets.items():
            tag = pol.tag
            ws, erel, apr, blocked, compl = [], [], [], [], []
            for w in wls:
                base = metrics(cname, w.name, "default")
                m = metrics(cname, w.name, tag)
                ws.append(float(np.mean(
                    m["ipc"] / np.maximum(base["ipc"], 1e-9))))
                base_e = energy_from_metrics(cfgs[cname], base).total_nj
                # price under the swept policy: the clock-gating axis
                # bills gated layers at their reduced standby frequency
                cfg_p = dataclasses.replace(cfgs[cname], policy=pol)
                erel.append(
                    energy_from_metrics(cfg_p, m).total_nj / base_e)
                served = max(int(np.asarray(m["served"]).sum()), 1)
                apr.append(int(m["n_act"]) / served)
                mk_cyc = max(float(m["makespan_ns"])
                             / cfgs[cname].unit_ns, 1.0)
                blocked.append(int(m["ref_rank_blocked_cycles"])
                               / (mk_cyc * cfgs[cname].n_ranks))
                done = bool(np.asarray(m["complete"]).all())
                compl.append(float(done))
                n_incomplete += not done
            vals = dict(config=cname, policy=pname,
                        ws=float(np.mean(ws)), energy=float(np.mean(erel)),
                        acts_per_req=float(np.mean(apr)),
                        rank_blocked_frac=float(np.mean(blocked)),
                        complete_frac=float(np.mean(compl)))
            table.append(vals)
            rows.append(f"{cname},{pname},{vals['ws']:.3f},"
                        f"{vals['energy']:.3f},{vals['acts_per_req']:.3f},"
                        f"{vals['rank_blocked_frac']:.4f},"
                        f"{vals['complete_frac']:.2f}")
    rows.append("# default = the paper's controller (FR-FCFS, open-page, "
                "all-bank refresh, inline writes); ws/energy are relative "
                "to it per IO model.  complete_frac < 1 (smoke's pinned "
                "horizon) means that row's ipc is horizon-truncated — "
                "trend-only; full runs derive a policy-aware horizon and "
                "complete every cell")
    perf = perf_block(wall, res, horizon)
    rows.append(f"# sweep: {len(res.names)} cells "
                f"({len(cells)} x {len(presets)} policies) on {res.device}, "
                f"{launches} launches, {wall:.3f}s wall, early-exit saved "
                f"{perf['early_exit_frac']:.0%} of chunks")
    FigureRecord.from_sweep("fig_policy", res, wall, horizon=horizon,
                            launches=launches, extra={
        "n_req": n_req, "n_policies": len(presets),
        "n_incomplete": n_incomplete,
        "policy_tags": {k: v.tag for k, v in presets.items()},
        "rows": table,
    }).emit()
    return rows


if __name__ == "__main__":
    print("\n".join(run(device=main_args(__doc__).device)))
