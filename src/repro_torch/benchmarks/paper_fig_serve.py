"""Serve↔sim loop: LM-serving traffic classes x rank organisation x
controller policy, driven by streams captured from the serving engine
(port of ``benchmarks/paper_fig_serve.py``).

Beyond the paper's Pin traces: the serving engine
(`repro_torch.serve.engine`) generates real prefill/decode steps on a
reduced model; the bridge (`repro_torch.serve.bridge`) captures the
per-step memory-request stream (weight sweeps, KV reads, exact per-token
KV-append writes, keyed by lane/tenant), reduces it to a measured
per-token profile, and scales it out into multi-tenant traces under three
parameterised traffic classes (`traces.TrafficMix`): a decode-dominated
steady tail, an ingest-heavy prefill front, and a bursty Gamma-arrival
multi-tenant mix.  Each class then sweeps both SMLA rank organisations
(cascaded MLR vs SLR) across the full controller-policy cross-product —
including the DVFS-style per-layer clock-gating axis
(`LayerClockPolicy`) — answering which controller + placement suits each
traffic class.

The whole (traffic x organisation x policy) grid is ONE shape group —
policy selectors (clock gating included) are data, so the policy axis
multiplies cells without multiplying launches: one kernel launch per
shape group on a card (asserted below), none on the CPU.

The capture runs the reduced tinyllama-1.1b (bf16, attn_impl "chunked",
as the reference) on the run's device.  Its params and prompt batch
default to the port's own draws; the reference draws them from JAX keys
(and folds a per-process string hash into the batch's), which this
package cannot reproduce, so a caller holding the reference's arrays
passes them in (``run(params=..., batch=...)``).
"""
import dataclasses

import numpy as np

from repro_torch.benchmarks._util import (FigureRecord, perf_block, scaled,
                                          timed_sweep)
from repro_torch.core.smla import policies, sweep
from repro_torch.core.smla.analytic import default_horizon
from repro_torch.core.smla.config import paper_configs
from repro_torch.core.smla.energy import energy_from_metrics
from repro_torch.core.smla.engine import SimOptions
from repro_torch.core.smla.traces import TrafficMix

#: the three serving traffic classes; all share n_tenants so the whole
#: figure stays one static shape group
TRAFFIC_CLASSES = (
    TrafficMix("decode_steady", prefill_frac=0.05, arrival="poisson",
               n_tenants=4, intensity=1.0),
    TrafficMix("prefill_heavy", prefill_frac=0.5, arrival="poisson",
               n_tenants=4, intensity=1.0),
    TrafficMix("bursty_tenants", prefill_frac=0.2, arrival="gamma",
               cv2=8.0, n_tenants=4, intensity=1.0),
)

#: the two SMLA rank organisations the placement policies map onto
ORGS = ("cascaded_mlr", "cascaded_slr")

#: the captured serving run: the reduced config, its prompt batch
#: (lanes x prompt tokens) and serving settings, as the reference's
CAPTURE_ARCH = "tinyllama-1.1b"
CAPTURE_BATCH, CAPTURE_PROMPT = 4, 8
CAPTURE_MAX_SEQ, CAPTURE_EOS = 64, 3


def capture_config():
    """The reduced config the capture serves."""
    from repro_torch.configs import get_config, reduce_config
    return reduce_config(get_config(CAPTURE_ARCH))


def _capture_profile(max_new_tokens: int, *, device: str = "cuda",
                     params=None, batch=None):
    """One real captured run on a reduced serving engine -> (profile,
    stats, generated tokens).  `params` (float32, nested as
    ``configs.base._param_shapes``) default to ``init(0, ...)``, `batch`
    ({"tokens": (4, 8) int32}) to ``make_batch(1, ..., kind="serve")``."""
    from repro_torch import models
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.serve import bridge
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = capture_config()
    model = models.get_model(cfg)
    if params is None:
        params = model.init(0, cfg, device=device)
    pcfg = ParallelConfig(attn_impl="chunked", moe_impl="dense",
                          remat="none")
    eng = Engine(cfg, pcfg, ServeConfig(max_seq=CAPTURE_MAX_SEQ,
                                        eos_id=CAPTURE_EOS), params,
                 device=device)
    if batch is None:
        batch = models.make_batch(1, cfg, CAPTURE_BATCH, CAPTURE_PROMPT,
                                  kind="serve")
    out, cap = bridge.capture_generate(eng, batch, max_new_tokens)
    prof = bridge.StreamProfile.from_capture(cap)
    stats = {
        "n_lanes": cap.n_lanes,
        "prompt_tokens": [int(x) for x in cap.prompt_tokens],
        "live_decode_tokens": [int(x) for x in cap.live_decode_tokens],
        "generated_shape": list(out.shape),
        "profile": dataclasses.asdict(prof),
    }
    return prof, stats, out


def configs() -> dict:
    """The figure's two rank organisations at 4 layers."""
    return {name: paper_configs(4)[name] for name in ORGS}


def grid(prof, n_req: int, horizon: int | None = None, seed: int = 0,
         device: str = "cuda") -> sweep.SweepSpec:
    """The figure's sweep for a captured profile `prof`: each traffic
    class's trace x both organisations, crossed with every policy
    preset."""
    from repro_torch.serve import bridge

    cfgs = configs()
    r_max = max(sc.n_ranks for sc in cfgs.values())
    banks = next(iter(cfgs.values())).banks_per_rank

    # one trace per traffic class, shared by both organisations (the
    # workload does not change with placement; the engine takes trace
    # ranks mod the config's rank count)
    cells = []
    for mix in TRAFFIC_CLASSES:
        traces = bridge.mix_trace(seed, mix, prof, n_req, r_max, banks)
        for org, sc in cfgs.items():
            cells.append(sweep.SweepCell(f"{mix.name}/{org}", sc, traces))

    presets = policies.POLICY_PRESETS
    if horizon is None:
        # derived over the POLICY-EXPANDED grid (clock-gated cells get
        # their stretched-transfer inflation); generosity is nearly free
        # — the chunked engine exits at the measured makespan
        horizon = default_horizon(
            sweep.policy_cells(cells, tuple(presets.values())))

    return sweep.SweepSpec(tuple(cells),
                           options=SimOptions(horizon=horizon,
                                              device=device),
                           policies=tuple(presets.values()))


def run(n_req: int = 600, horizon: int | None = None, seed: int = 0, *,
        device: str = "cuda", params=None, batch=None) -> list[str]:
    n_req = scaled(n_req, 120)
    prof, cap_stats, _ = _capture_profile(scaled(16, 8), device=device,
                                          params=params, batch=batch)
    cfgs = configs()
    presets = policies.POLICY_PRESETS
    spec = grid(prof, n_req, horizon, seed, device)
    horizon = spec.options.horizon
    cells = spec.cells
    res, wall, launches = timed_sweep("fig_serve", spec)
    bound = sweep.shape_groups(spec) if res.device == "cuda" else 0
    assert launches <= bound, \
        f"policy/clock axes multiplied launches: {launches} (want <= " \
        f"{bound} shape groups — selectors must stay data)"

    rows = ["traffic,config,policy,bandwidth_gbps,ws_vs_default,"
            "energy_vs_default,write_frac,complete_frac"]
    table = []
    for mix in TRAFFIC_CLASSES:
        for org, sc in cfgs.items():
            base = res[f"{mix.name}/{org}|default"]
            base_e = energy_from_metrics(sc, base).total_nj
            for pname, pol in presets.items():
                m = res[f"{mix.name}/{org}|{pol.tag}"]
                ws = float(np.mean(m["ipc"]
                                   / np.maximum(base["ipc"], 1e-9)))
                # price energy under the swept policy (clock gating
                # changes the standby frequency the layer is billed at)
                e = energy_from_metrics(
                    dataclasses.replace(sc, policy=pol), m).total_nj
                served = max(int(np.asarray(m["served"]).sum()), 1)
                vals = dict(
                    traffic=mix.name, config=org, policy=pname,
                    bandwidth_gbps=float(m["bandwidth_gbps"]),
                    ws=ws, energy=float(e / base_e),
                    write_frac=float(int(m["n_wr"]) / served),
                    complete_frac=float(
                        np.asarray(m["complete"]).mean()))
                table.append(vals)
                rows.append(
                    f"{mix.name},{org},{pname},"
                    f"{vals['bandwidth_gbps']:.2f},{vals['ws']:.3f},"
                    f"{vals['energy']:.3f},{vals['write_frac']:.3f},"
                    f"{vals['complete_frac']:.2f}")
    # the reference's note, word for word: the rows are held to its
    rows.append("# traces captured from the serving engine "
                "(repro.serve.bridge) and scaled out per traffic class; "
                "ws/energy are relative to the same traffic x config "
                "under the paper's default controller")
    perf = perf_block(wall, res, horizon)
    rows.append(f"# sweep: {len(res.names)} cells ({len(cells)} x "
                f"{len(presets)} policies) on {res.device}, {launches} "
                f"launches, {wall:.1f}s wall, early-exit saved "
                f"{perf['early_exit_frac']:.0%} of chunks")
    FigureRecord.from_sweep("fig_serve", res, wall, horizon=horizon,
                            launches=launches, extra={
        "n_req": n_req, "n_policies": len(presets),
        "traffic_classes": [dataclasses.asdict(m)
                            for m in TRAFFIC_CLASSES],
        "capture": cap_stats,
        "policy_tags": {k: v.tag for k, v in presets.items()},
        "rows": table,
    }).emit()
    return rows


def main(argv=None) -> int:
    import argparse
    import os

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized grid (same as SMLA_SMOKE=1)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.smoke:
        os.environ["SMLA_SMOKE"] = "1"
    print("\n".join(run(device=args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
