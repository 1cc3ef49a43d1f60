#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of the SMLA cycle simulator
(``src/repro_torch``) on one NVIDIA GPU, end to end, and check it.

    python3 chip_smoke.py

Phases (each prints one line with its seconds; any failed check raises
and the script exits non-zero):

1. card      the GPU's name and power limit (nvidia-smi) and CUDA version.
2. build     nvcc builds the kernel library from ``src/repro_torch/csrc``.
3. golden    the golden grid (``tests/golden/smla_small_grid.json``)
             through ``run_sweep`` on the kernel: ints exact, floats to
             rtol=1e-6.
4. parity    the kernel against the plain PyTorch version on the card:
             POLICY_PRESETS x 5 IO models (L4, horizon 3000, n_req 60),
             the fault scenarios of ``benchmarks/paper_fig_fault.py`` x
             its 3 IO models, and window {1, 4} x the four OooSelect
             values.
5. grid      the README's evaluation grid — 31 workloads x 5 IO models x
             layers (2, 4, 8), n_req 600, horizon from
             ``analytic.default_horizon`` (465 cells) — through
             ``run_sweep`` on the kernel, launch counter reset just before
             and read just after; every cell must complete its fixed work;
             one workload's 5 IO-model cells at full n_req are held
             against the plain version, and the kernel, the plain version
             and the whole grid's launches are timed with CUDA events;
             the grid is also timed as one launch, whose metrics must
             equal the main path's.
6. kernels   one JSON line: each kernel with its launches on the main
             path, its error against the plain version, its time, the
             plain version's time and its bound (`bound_ms`: the work
             the cells' own data needs, at the card's peak rates).

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout of the repository, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

GOLDEN = ROOT / "tests" / "golden" / "smla_small_grid.json"
GOLDEN_INT = ("n_act", "n_row_conflicts", "n_wr", "bus_cycles",
              "wr_bus_cycles", "refresh_cycles", "pd_cycles", "n_grants",
              "n_slot_grants", "n_enqueued", "n_outstanding",
              "ref_postponed", "ref_pulled_in", "ref_debt_max",
              "ref_debt_end", "sr_cycles", "n_sr_exit")
GOLDEN_FLOAT = ("bandwidth_gbps", "bus_util", "pd_frac", "sr_frac",
                "makespan_ns", "horizon_ns")
RTOL = 1e-6

#: published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth and
#: the float32 rate outside the tensor cores, the rate the kernel's scalar
#: integer work is held against
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def phase(name):
    """Decorator: run the phase, print its line with its seconds."""
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out, msg = fn(*a, **kw)
            print(f"[{name}] {msg} ({time.perf_counter() - t0:.2f} s)",
                  flush=True)
            return out
        return run
    return wrap


def compare(got: dict, want: dict, what: str, skip=()) -> float:
    """Ints/bools exact, floats to RTOL; returns the max abs difference
    over every compared metric; raises on any disagreement."""
    import torch
    worst = 0.0
    for k in want:
        if k in skip:
            continue
        g, w = got[k], want[k]
        if g.dtype != w.dtype or g.shape != w.shape:
            raise RuntimeError(f"{what}: {k} {g.dtype}{tuple(g.shape)} vs "
                               f"{w.dtype}{tuple(w.shape)}")
        if w.dtype.is_floating_point:
            ok = torch.allclose(g, w, rtol=RTOL, atol=0.0)
        else:
            ok = torch.equal(g, w)
        diff = (g.double() - w.double()).abs()
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
        if not ok:
            raise RuntimeError(f"{what}: {k} differs, max abs "
                               f"{float(diff.max())}")
    return worst


def stacked(cells, device, r_max=None):
    """One padded batch of port cells as tensors on `device`, padded as
    the sweep pads a shape group (rank axis to `r_max`)."""
    from repro_torch.convert import from_reference
    from repro_torch.core.smla.sweep import stack_cells
    return from_reference(*stack_cells(cells, r_max), device)


def cuda_ms(fn, reps=1):
    """Median CUDA-event time of `fn()` in ms (synchronised)."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2], out


def work_ops(params, out, banks):
    """Integer operations this batch's simulation needs (compares, adds,
    selects and index arithmetic of ``csrc/smla_cycle.cuh``; loads and
    stores not counted), counted per cell from its own data, not from the
    kernel's padded loops:

    * every cycle up to the cell's own makespan costs 45 + 12*B per real
      rank (refresh 8B+25, power 4B+20), 25 per real bus group
      (transfer arbitration), 18 per core (retire, progress) and 55 more
      (enqueue, schedule);
    * every cycle a request holds a window slot costs 82, that slot's
      share of the stages' scans.  Slot-cycles are counted from below: a
      request holds its slot at least for its access latency (tCL on a
      row hit, tRCD+tCL on a closed bank, tRP+tRCD+tCL on a conflict)
      plus its bus transfer."""
    def cell(d, k):
        return d[k].double().cpu().reshape(d[k].shape[0], -1).sum(-1)
    cycles = (cell(out, "makespan_ns") / cell(params, "unit_ns")).round()
    per_cycle = (cell(params, "n_ranks") * (45 + 12 * banks)
                 + cell(params, "n_groups").clamp_min(1) * 25
                 + out["served"].shape[-1] * 18 + 55)
    conflict = cell(out, "n_row_conflicts")
    closed = cell(out, "n_act") - conflict
    t_cl, t_rcd, t_rp = (cell(params, k) for k in ("t_cl", "t_rcd", "t_rp"))
    slot_cycles = (cell(out, "n_row_hit") * t_cl + closed * (t_rcd + t_cl)
                   + conflict * (t_rp + t_rcd + t_cl)
                   + cell(out, "bus_cycles"))
    return float((cycles * per_cycle + 82 * slot_cycles).sum())


def bound_ms(params, traces, out, banks):
    """The least time the card could take for one batch: the larger of
    its bytes (each cell's real inputs read once: its ranks of the
    per-rank params, its own requests of the traces; the outputs written
    once) over HBM bandwidth, and `work_ops` over the peak scalar rate."""
    R = params["dur"].shape[1]
    ranks = int(params["n_ranks"].sum())
    n_in = sum(t.element_size() * (ranks if t.dim() == 2 and t.shape[1] == R
                                   else t.numel()) for t in params.values())
    reqs = int(params["n_req"].sum()) * traces["inst"].shape[1]
    n_in += sum(t.element_size() * reqs for t in traces.values())
    n_out = sum(t.numel() * t.element_size() for t in out.values())
    ops = work_ops(params, out, banks)
    t_bytes = (n_in + n_out) / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), ops


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core.smla import cuda_engine, engine, sweep
    from repro_torch.core.smla.analytic import default_horizon
    from repro_torch.core.smla.config import (ControllerPolicy, OooSelect,
                                              paper_configs)
    from repro_torch.core.smla.faults import DegradeMode, FaultConfig
    from repro_torch.core.smla.policies import POLICY_PRESETS
    from repro_torch.core.smla.traces import WORKLOADS, WorkloadSpec

    dev = torch.device("cuda", 0)
    kern = cuda_engine.sim_cell_blocks
    worst_err = [0.0]

    @phase("card")
    def card():
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        return smi, (f"{torch.cuda.get_device_name(0)}; torch "
                     f"{torch.__version__}, CUDA {torch.version.cuda}")

    @phase("build")
    def build():
        lib = cuda_engine.build()
        return lib, f"nvcc built {cuda_engine.KERNEL_SOURCES}"

    @phase("golden")
    def golden():
        golden = json.loads(GOLDEN.read_text())["cells"]
        cells = []
        for layers in (2, 4):
            for cname, sc in paper_configs(layers).items():
                sc = dataclasses.replace(sc, t_refi_ns=1200.0)
                for w in (WORKLOADS[4], WORKLOADS[26]):
                    cells.append(sweep.make_cell(
                        f"L{layers}/{cname}/{w.name}", sc, [w, w], 80,
                        seed=13))
        res = sweep.run_sweep(sweep.SweepSpec(
            tuple(cells), engine.SimOptions(horizon=4000)))
        if res.device != "cuda" or sorted(res.names) != sorted(golden):
            raise RuntimeError("golden grid: wrong device or cell set")
        for name, g in golden.items():
            m = res[name]
            for k in GOLDEN_INT:
                if int(m[k]) != g[k]:
                    raise RuntimeError(f"golden {name}:{k} {int(m[k])} != "
                                       f"{g[k]}")
            if m["served"].astype(int).tolist() != g["served"]:
                raise RuntimeError(f"golden {name}: served")
            for k in GOLDEN_FLOAT:
                if not np.isclose(float(m[k]), g[k], rtol=RTOL, atol=0.0):
                    raise RuntimeError(f"golden {name}:{k} {float(m[k])!r} "
                                       f"!= {g[k]!r}")
            if not np.allclose(m["ipc"], g["ipc"], rtol=RTOL, atol=0.0):
                raise RuntimeError(f"golden {name}: ipc")
        return None, f"{len(golden)} cells match the golden file"

    mix = WorkloadSpec("mix.1", 18.0, 0.6, write_frac=0.2)

    def io_cells(spec, n_req, layers=4, seed=7):
        return [sweep.make_cell(n, sc, [spec, spec], n_req, seed=seed)
                for n, sc in paper_configs(layers).items()]

    def kernel_vs_plain(cells, horizon, chunk, core, what):
        params, traces = stacked(cells, dev)
        got = kern(params, traces, horizon=horizon, core=core, banks=2,
                   chunk=chunk)
        want = engine._sim_core(params, traces, horizon, core, 2, chunk)
        torch.cuda.synchronize()
        worst_err[0] = max(worst_err[0], compare(got, want, what))

    @phase("parity")
    def parity():
        cells = sweep.policy_cells(io_cells(mix, 60),
                                   tuple(POLICY_PRESETS.values()))
        kernel_vs_plain(cells, 3000, 256, engine.CoreParams(),
                        "POLICY_PRESETS x IO")
        n = len(cells)
        # the fault axis of benchmarks/paper_fig_fault.py on its 3 configs
        faults = [FaultConfig()]
        for kills in ((3,), (2, 3)):
            faults += [FaultConfig(dead_layers=kills, degrade=m)
                       for m in DegradeMode]
        faults += [FaultConfig(weak_ranks=(0, 1), retention_derate=4),
                   FaultConfig(ecc_rate=0.05)]
        base = [c for c in io_cells(mix, 60) if c.name in
                ("cascaded_mlr", "cascaded_slr", "dedicated_slr")]
        base = [dataclasses.replace(c, stack=dataclasses.replace(
            c.stack, t_refi_ns=1200.0)) for c in base]
        cells = sweep.fault_cells(base, faults)
        kernel_vs_plain(cells, 3000, 256, engine.CoreParams(),
                        "faults x IO")
        n += len(cells)
        ooo = WorkloadSpec("ooo", 25.0, 0.6, write_frac=0.4)
        for window in (1, 4):
            cells = sweep.policy_cells(
                io_cells(ooo, 60),
                tuple(ControllerPolicy(ooo=o) for o in OooSelect))
            kernel_vs_plain(cells, 3000, 256,
                            engine.CoreParams(window=window),
                            f"window {window} x OooSelect")
            n += len(cells)
        return None, (f"kernel == plain on {n} cells (max abs err "
                      f"{worst_err[0]})")

    @phase("grid")
    def grid():
        cells = sweep.paper_grid([(w.name, [w], 0) for w in WORKLOADS],
                                 layers=(2, 4, 8), n_req=600)
        horizon = default_horizon(cells)
        spec = sweep.SweepSpec(tuple(cells),
                               engine.SimOptions(horizon=horizon))
        torch.cuda.synchronize()
        kern.launches = 0
        t0 = time.perf_counter()
        res = sweep.run_sweep(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kern.launches
        if launches < 1 or launches != len(res.buckets):
            raise RuntimeError(f"main path launched the kernel {launches} "
                               f"times for {len(res.buckets)} buckets")
        sc = res.scalars(("chunks_run", "bandwidth_gbps", "makespan_ns"))
        for name in res.names:
            m = res[name]
            if not (bool(m["complete"].all()) and (m["served"] == 600).all()):
                raise RuntimeError(f"{name}: fixed work not completed")
        if not (np.isfinite(sc["bandwidth_gbps"]).all()
                and (sc["bandwidth_gbps"] > 0).all()):
            raise RuntimeError("grid: non-finite or zero bandwidth")

        # one workload's 5 IO-model cells at full n_req, at the main
        # path's shapes (rank axis padded to the grid's widest): kernel vs
        # plain
        five = [c for c in cells if c.name.startswith("L4/")
                and c.name.endswith("/stream.3")]
        chunk = res.chunks[res.names.index(five[0].name)]
        core = engine.CoreParams()
        params, traces = stacked(five, dev,
                                 max(c.stack.n_ranks for c in cells))
        run_k = lambda: kern(params, traces, horizon=horizon, core=core,  # noqa: E731
                             banks=2, chunk=chunk)
        ms, got = cuda_ms(run_k, reps=3)
        plain_ms, want = cuda_ms(lambda: engine._sim_core(
            params, traces, horizon, core, 2, chunk))
        err = compare(got, want, "stream.3 x IO at n_req 600")
        worst_err[0] = max(worst_err[0], err)
        for i, c in enumerate(five):        # the main path's own numbers
            compare({k: v[i].cpu() for k, v in got.items()},
                    {k: torch.from_numpy(np.asarray(v))
                     for k, v in res[c.name].items()}, c.name)
        b_ms, b_by, ops = bound_ms(params, traces, got, 2)

        # the whole grid's kernel time: each bucket's launch, timed alone
        def launch(bkt):
            p_np, t_np = sweep._build_arrays(bkt)
            p_b, t_b = (engine._on_device(p_np, dev),
                        engine._on_device(t_np, dev))
            return cuda_ms(lambda: kern(p_b, t_b, horizon=horizon,
                                        core=core, banks=bkt.banks,
                                        chunk=bkt.chunk))
        bucket_ms = [launch(bkt)[0] for bkt in sweep._plan(spec, cells)]
        grid_ms = sum(bucket_ms)
        # the same grid as one launch (one bucket, no makespan batching);
        # its metrics must equal the main path's
        (one,) = sweep._plan(dataclasses.replace(
            spec, makespan_batching=False), cells)
        one_ms, one_out = launch(one)
        compare({k: v.cpu() for k, v in one_out.items()},
                {k: torch.from_numpy(np.stack([res[one.group[j].name][k]
                                               for j in one.positions]))
                 for k in one_out}, "grid as one launch",
                skip=("chunks_run",))
        stats = {
            "cells": len(res.names), "horizon": horizon, "wall_s": wall,
            "cells_per_s": len(res.names) / wall, "launches": launches,
            "grid_kernel_ms": grid_ms, "grid_one_launch_ms": one_ms,
            "one_launch_chunk": one.chunk,
            "chunks_run_sum": int(sc["chunks_run"].sum()),
            "bucket_ms": bucket_ms,
            "bucket_max_chunks": [b["chunks_run"] for b in res.buckets],
            "compare_cells": [c.name for c in five], "compare_ms": ms,
            "compare_plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "compare_ops": ops,
            "mean_bandwidth_gbps": float(sc["bandwidth_gbps"].mean()),
        }
        print(json.dumps({"grid": stats}), flush=True)
        return stats, (f"{len(res.names)} cells in {wall:.3f} s "
                       f"({len(res.names) / wall:.1f} cells/s), kernel "
                       f"{grid_ms:.3f} ms over {launches} launches "
                       f"({one_ms:.3f} ms as one launch), chunks_run "
                       f"sum {stats['chunks_run_sum']}")

    t_start = time.perf_counter()
    card()
    build()
    golden()
    parity()
    stats = grid()

    @phase("kernels")
    def kernels():
        line = {"kernels": [{
            "name": "smla_sim_kernel", "route": "cuda",
            "source": "src/repro_torch/csrc/smla_engine.cu",
            "replaces": "src/repro/core/smla/pallas_engine.py:96",
            "launches": stats["launches"], "max_abs_err": worst_err[0],
            "ms": stats["compare_ms"], "plain_ms": stats["compare_plain_ms"],
            "bound_ms": stats["bound_ms"], "bound_by": stats["bound_by"],
            "library_ms": None,
            "shape": "5 cells (L4 IO models x stream.3), n_req 600, "
                     "rank axis 8",
            "grid_ms": stats["grid_kernel_ms"],
            "grid_one_launch_ms": stats["grid_one_launch_ms"],
            "check": "ok"}]}
        print(json.dumps(line), flush=True)
        return None, "1 kernel, all checks passed"

    kernels()
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
