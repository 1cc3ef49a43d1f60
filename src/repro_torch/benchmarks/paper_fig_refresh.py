"""Refresh-management & deep power-state sensitivity across the five IO
models (beyond the paper's fixed controller) (port of
``benchmarks/paper_fig_refresh.py``).

The paper's 18% average energy win leans on Cascaded-IO's per-layer clock
domains, but its controller models one shallow power state and refreshes
rigidly on deadline.  This figure sweeps `policies.REFRESH_PRESETS` —
self-refresh entry (a deeper state below power-down, exit charges t_xsr),
JEDEC-style 8x refresh postponing with drain-aware pull-in, their
combination, and per-bank + postpone — over every IO model with one
idle-heavy and one write-heavy streaming workload, single-core, and
reports each preset *relative to the same IO model under the default
policy*: weighted speedup, standby energy, self-refresh / power-down
residency, and the refresh debt trajectory.

Refresh cadence is tightened to the trace scale (t_refi_ns=1200, exactly
as the golden grid does): stock tREFI fires once or twice inside a
smoke-sized trace, underrepresenting the interference this subsystem
manages.

Like fig_policy, the whole (config x workload x preset) grid is ONE
shape group: the refresh selectors are per-cell data, so the refresh axis
multiplies cells without multiplying launches (one on a card, checked).
The gate: on the idle-heavy workload, self-refresh must cut standby
energy on every multi-rank (SLR/baseline) organisation — single-rank MLR
stacks cannot idle a rank while serving, which the figure reports rather
than hides."""
import dataclasses

import numpy as np

from repro_torch.benchmarks._util import (FigureRecord, main_args,
                                          perf_block, scaled, timed_sweep)
from repro_torch.core.smla import policies, sweep
from repro_torch.core.smla.analytic import default_horizon
from repro_torch.core.smla.config import StackConfig, paper_configs
from repro_torch.core.smla.energy import energy_from_metrics
from repro_torch.core.smla.engine import SimOptions
from repro_torch.core.smla.traces import WorkloadSpec

#: one deep-idle stream (long per-rank gaps — the self-refresh regime)
#: and one write-heavy stream (drain windows — the pull-in regime)
WORKLOADS_FIG = (WorkloadSpec("idle.03", 0.3, 0.6),
                 WorkloadSpec("stream.w", 50.0, 0.85, write_frac=1 / 3))
T_REFI_NS = 1200.0


def configs() -> dict[str, StackConfig]:
    """The 5 IO models at 4 layers, refresh cadence T_REFI_NS."""
    return {n: dataclasses.replace(sc, t_refi_ns=T_REFI_NS)
            for n, sc in paper_configs(4).items()}


def grid(n_req: int, horizon: int | None = None, seed: int = 2,
         device: str = "cuda") -> sweep.SweepSpec:
    """The figure's sweep: the IO models x the workloads (one core
    each), crossed with every preset of REFRESH_PRESETS."""
    presets = tuple(policies.REFRESH_PRESETS.values())
    cells = tuple(sweep.make_cell(f"L4/{cname}/{w.name}", sc, [w],
                                  n_req, seed)
                  for cname, sc in configs().items() for w in WORKLOADS_FIG)
    if horizon is None:
        # smoke pins a horizon sized to the idle stream's arrival span so
        # rows stay cross-commit comparable; full runs derive the
        # policy-aware analytic worst case (self-refresh cells price
        # their t_xsr wakes into it)
        horizon = scaled(default_horizon(
            sweep.policy_cells(cells, presets)), 24_000)
    return sweep.SweepSpec(cells, options=SimOptions(
        horizon=horizon, device=device), policies=presets)


def run(n_req: int = 400, horizon: int | None = None,
        seed: int = 2, *, device: str = "cuda") -> list[str]:
    n_req = scaled(n_req, 60)
    cfgs = configs()
    presets = policies.REFRESH_PRESETS
    spec = grid(n_req, horizon, seed, device)
    cells, horizon = spec.cells, spec.options.horizon
    res, wall, launches = timed_sweep("fig_refresh", spec)

    def metrics(cname, wname, tag):
        return res[f"L4/{cname}/{wname}|{tag}"]

    rows = ["config,preset,workload,ws_vs_default,standby_vs_default,"
            "sr_frac,pd_frac,refresh_cycles,postponed,pulled_in,"
            "debt_max,complete"]
    table = []
    sr_gate_failures = []
    for cname, sc in cfgs.items():
        for pname, pol in presets.items():
            for w in WORKLOADS_FIG:
                base = metrics(cname, w.name, "default")
                m = metrics(cname, w.name, pol.tag)
                ws = float(np.mean(m["ipc"]
                                   / np.maximum(base["ipc"], 1e-9)))
                sc_pol = dataclasses.replace(sc, policy=pol)
                standby0 = energy_from_metrics(sc, base).standby_nj
                standby = energy_from_metrics(sc_pol, m).standby_nj
                srel = standby / max(standby0, 1e-9)
                done = bool(np.asarray(m["complete"]).all())
                vals = dict(
                    config=cname, preset=pname, workload=w.name,
                    ws=round(ws, 4), standby_rel=round(srel, 4),
                    sr_frac=round(float(m["sr_frac"]), 4),
                    pd_frac=round(float(m["pd_frac"]), 4),
                    refresh_cycles=int(m["refresh_cycles"]),
                    postponed=int(m["ref_postponed"]),
                    pulled_in=int(m["ref_pulled_in"]),
                    debt_max=int(m["ref_debt_max"]),
                    debt_end=int(m["ref_debt_end"]),
                    complete=done)
                table.append(vals)
                rows.append(
                    f"{cname},{pname},{w.name},{ws:.3f},{srel:.3f},"
                    f"{vals['sr_frac']:.3f},{vals['pd_frac']:.3f},"
                    f"{vals['refresh_cycles']},{vals['postponed']},"
                    f"{vals['pulled_in']},{vals['debt_max']},{done:d}")
                # debt must always be repaid, everywhere in the grid
                assert vals["debt_end"] == 0, (cname, pname, w.name)
                if (pname == "self_refresh" and w.name == "idle.03"
                        and cfgs[cname].n_ranks > 1 and srel >= 1.0):
                    sr_gate_failures.append((cname, srel))

    # the subsystem's acceptance gate: self-refresh reduces standby
    # energy on the idle-heavy workload for every multi-rank IO model
    assert not sr_gate_failures, \
        f"self-refresh failed to cut idle standby energy: {sr_gate_failures}"

    rows.append("# default = the paper's controller (power-down only, "
                "refresh on deadline); standby_vs_default < 1 on idle.03 "
                "multi-rank rows is the self-refresh win; single-rank MLR "
                "stacks cannot idle a rank while serving, so sr_frac ~ 0 "
                "there.  postponed/pulled_in/debt_max show the JEDEC 8x "
                "debt machinery; debt always drains to zero")
    perf = perf_block(wall, res, horizon)
    rows.append(f"# sweep: {len(res.names)} cells "
                f"({len(cells)} x {len(presets)} presets) on {res.device}, "
                f"{launches} launches, {wall:.3f}s wall, early-exit saved "
                f"{perf['early_exit_frac']:.0%} of chunks")
    FigureRecord.from_sweep("fig_refresh", res, wall, horizon=horizon,
                            launches=launches, extra={
        "n_req": n_req, "n_presets": len(presets), "t_refi_ns": T_REFI_NS,
        "preset_tags": {k: v.tag for k, v in presets.items()},
        "rows": table,
    }).emit()
    return rows


if __name__ == "__main__":
    print("\n".join(run(device=main_args(__doc__).device)))
