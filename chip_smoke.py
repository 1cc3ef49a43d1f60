#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of the SMLA system (``src/repro_torch``)
on one NVIDIA GPU, end to end, and check it: the cycle simulator's sweep,
the paper's tables and figures, the serving path whose captured traffic
feeds it, the training path, the paper's Cascaded-IO datapath matmul and
its benchmark, and RWKV-6 training.

    python3 chip_smoke.py

Phases (each prints one line with its seconds; any failed check raises
and the script exits non-zero):

1. card      the GPU's name and power limit (nvidia-smi) and CUDA version.
2. build     nvcc builds the eight kernel libraries from
             ``src/repro_torch/csrc``, all at once.
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
             and read just after: one launch per shape group, whatever its
             makespan buckets; every cell must complete its fixed work;
             one workload's 5 IO-model cells at full n_req are held
             against the plain version, and the kernel, the plain version
             and the main path's launches are timed with CUDA events
             (with us per simulated cycle of the slowest cell); the
             bucketed plan (one launch per bucket) is timed once more for
             the record, its chunks and metrics equal to the main path's,
             and so is the grid as one launch at one chunk width.
6. attn_parity  the flash-attention and flash-decode kernels against
             their plain versions on the card: flash at (B 8, Hq 32,
             Hkv 4, hd 64) and (B 2, Hq 16, Hkv 8, hd 128), S in {256,
             192}, bf16 and float32, causal and full (`o` and `lse`);
             the bf16 tensor-core kernel's edges at (B 2, Hq 8, Hkv 2):
             hd 16, 32, 64 and 128 x S in {1, 200, 2000} (and 192, 256
             at hd 16 and 32), causal and full; one call of each dtype
             with the route counts read, so float32 shows it still runs
             the CUDA-core kernel (held at 1e-5); decode at Smax in
             {512, 300} with mixed lengths, bf16, and finite garbage
             past the lengths must change nothing; decode in bf16 (2^-7
             of max |o|) and float32 (1e-5), a lane of length 0 gives
             zeros, and the split-KV combine is bit-identical to
             ``ref.combine_splits`` on the split kernel's own partials.
             Each kernel is timed beside its plain version and one
             PyTorch call as a yardstick (SDPA; the port never calls it);
             decode also on the device (``benchmarks/decode_bench.py``: a
             replayed CUDA graph, and the profiler's device events), with
             its split count, and the combine kernel alone.
7. serve     the serving path at full width: tinyllama-1.1b (22 layers,
             d 2048, 32/4 heads, bf16), random weights from a seeded
             generator, `Engine` with attn_impl "pallas", 8 requests of
             256 prompt tokens, 64 new tokens, greedy, through
             `bridge.capture_generate`; launch counters reset just before
             and read just after (flash 22, decode 22 x 63 and its
             combine 22 x 63); then the
             same tokens teacher-forced through the plain path
             (attn_impl "naive").  bf16: every step's logits within
             max(5e-2, 1.5 x the gap between the reference's own two
             plain paths, chunked and naive, on the same tokens), and
             every generated token within twice that of the plain top
             logit; float32 replay of the same weights and tokens: the
             kernels' float32 builds against their plain versions,
             model-wide, logits within 1e-3.
8. serve_sim the captured stream through the rest of the serve<->sim loop:
             `StreamProfile.from_capture`, `mix_trace` for the three
             traffic classes of ``benchmarks/paper_fig_serve.py`` x
             cascaded MLR/SLR x POLICY_PRESETS (66 cells, n_req 600)
             through `run_sweep` on the kernel (one launch per shape
             group, counted; every cell must complete; timed, and the
             bucketed plan timed and held equal for the record), and one
             class x both organisations at n_req 120 held against the
             plain engine on the card.
9. figures   the paper's outputs through the port
             (``repro_torch.benchmarks``): Tables 1-2, Figs. 11-14,
             fig_policy, fig_ooo, fig_refresh and fig_fault (27 cells
             under ``on_error="record"``), each module's ``run()``
             at its default (full) size on the kernel, SMLA_SMOKE unset,
             BENCH_JSON in a temporary directory; every cell, printed data
             row and JSON `extra` held against the reference's own
             full-size run (``tests/torch_golden/paper_figs.json``: ints
             exact, floats rtol=1e-6); launch counter reset before each
             module and read after: one launch per shape group (Fig. 12
             one more, its cross-check `simulate`); Fig. 11's plain pass
             (the plain version on the CPU) on one probe cell; each
             module's cells, launches, wall, kernel ms (each launch timed
             alone once more, its result the same) and cells/s.
10. sweep_scale  the sweep engine's resilience and scaling on the card.
             On Fig. 12's full-size grid (90 cells, three shape groups in
             one sweep) through ``run_sweep`` (its card path with the
             launcher injected where a launch must fail): a journaled
             run whose second group's launch raises a non-transient
             error ends
             with exactly the first group's buckets journaled; the rerun
             launches 2 times and equals the golden's Fig. 12 sweep;
             ``on_error="record"`` with the same failed launch lists that
             group's buckets in ``failed_buckets``, every other cell
             equal to the golden, and the plain version never runs;
             ``streaming=False`` equals ``streaming=True``.  Then
             ``repro_torch.benchmarks.paper_fig_scale.main()`` at full
             size (60, 240 and 960 cells; sync, stream_cold, stream_warm,
             each a fresh process, the first two building the kernel with
             nvcc into fresh directories; the 2e4-cell prune child): per
             size every bandwidth and the checksum equal the golden's,
             the promoted cells and ``prune_work`` too, one launch per
             child (two for the prune child's sub-sweeps), and the
             early-exit gate's fig_scale section passes (best ratio >=
             1.3, saved >= 0.5); cells/s, buckets/s and nvcc seconds per
             size and mode, the prune child's wall.
11. attn_bwd_parity  the flash-attention backward kernel against its
             plain version (`ref.attention_bwd`) on the card: (B 4, S 2048,
             Hq 32, Hkv 4, hd 64), (B 2, S 512, Hq 16, Hkv 8, hd 128) and
             a ragged S 200, bf16 and float32, causal and full (dq, dk,
             dv); the bf16 tensor-core kernels' edges, the forward's cases
             above; every bf16 call twice, bit-identical; and gradients
             through `ops.flash_attention`'s autograd Function against
             autograd through the plain forward, float32 (1e-5) and bf16
             (2^-7 of max |g|).  The kernel is timed beside its plain
             version and the backward of SDPA, and the forward at the
             same shape beside SDPA's forward (yardsticks; the port never
             calls SDPA).
12. train    the training path at full width: tinyllama-1.1b (bf16
             compute, float32 master weights and AdamW state), random
             weights from a seed, `SyntheticLM` seed 0, batch 4 x 2048
             tokens, 6 steps through `launch/train.py`'s functions
             (`init_state`, `make_train_step`, `loop.train`; attn_impl
             "pallas", remat "full").  Launch counters reset just before
             and read just after: every step launches the forward kernel
             44 times (22 layers, each recomputed once under remat) and
             the backward 22 times.  Losses finite; step time, tokens/s,
             peak memory and the device-busy share of one profiled step.
             A float32 replay at full width holds the loss and every
             gradient leaf of one step against the same step with the
             kernels' plain versions swapped in; bf16 losses are held to
             the noise floor the phase measures (chunked vs naive).  A
             resume check (2 layers at full width): save after step 2,
             restore, take step 3: the same loss as the uninterrupted run.
13. pipe_parity  the SMLA cascaded-pipeline matmul (3xTF32 on wgmma:
             a staging kernel, the product kernel, and for Dedicated-IO L
             product launches + a sum kernel) against its plain versions
             and `matmul_striped`: the reference test's grid in float32
             and bf16, ragged M, N and stripes, the striping order; the
             staging kernel bit for bit against `ref.stage_tf32` at each
             of those shapes; then the main path,
             `benchmarks/smla_pipe_bench.run` at its two shapes (launch
             counters reset just before and read just after); at the
             realistic shape, x (8192, 2048) @ w (4, 512, 5632), the
             staging and the sum bit for bit against their plain versions,
             and every kernel's plain version timed.
14. wkv_parity  the WKV6 kernel against its plain version (the chunked
             path) and the sequential oracle, `y` and the final state, at
             (2,3,128,32) chunk {16,32,64}, (2,2,64,16) chunk 16 and the
             training shape (4,40,2048,64) chunk 64 with float32 and bf16
             r, k, v; strong decays (logw = -exp(n + 2), sums of hundreds
             within a chunk) at (2,3,128,32) chunk 64 and 16 and the
             training shape: finite, held to the sequential oracle and a
             float64 witness, and to the plain version within its own
             distance from the witness; the model's own call (bf16 r, k,
             v views of (B,S,H,hd) tensors) through `ops.wkv6_with_state`:
             one launch, two allocations (y, state), y bit-equal to the
             float32 kernel's rounded to bf16 and laid out (B,S,H,hd), the
             state equal; the launch (a block per chunk of each (batch,
             head)) printed; timed beside its plain version at the
             training shape, float32 and the model's call on the host and
             the device (`benchmarks/wkv6_bench.py` in a process of its
             own: one device event per call, the kernel), each with its
             bound; the autograd Function's backward timed there, its
             gradients equal, bit for bit, whichever forward ran.
15. train_rwkv  rwkv6-3b at full width (d 2560, 40 heads of 64, d_ff
             8960, vocab 65536, bf16 compute, float32 master weights) cut
             to 8 of its 32 layers, random weights from seed 0,
             `SyntheticLM` seed 0, batch 4 x 2048, 6 steps through
             `launch/train.py`'s functions (attn_impl "pallas", remat
             "full"): exactly 16 wkv6 launches per step (8 layers + their
             recomputes); first a float32 replay of one step from the
             initial weights: the loss against the kernel's plain version
             under the same autograd Function, every gradient leaf against
             a float64 witness (the plain and the sequential path in
             float64), within 1.5 x the farther of the two plain float32
             paths from it, at least 1e-5 (see W64_TOL's notes); after
             training, the bf16 loss against the chunked path, within 1.5
             x the gap between the chunked and the sequential path (at
             least 1e-3).
16. kernels  one JSON line: each kernel with its launches on its main
             path, its error against the plain version, its time, the
             plain version's time, one PyTorch call's time where there
             is one, and its bound (`bound_ms`: the work this run's
             inputs need, at the card's peak rates).

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout of the repository, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile
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
#: the reference's own full-size run of the paper's outputs
#: (``tests/torch_golden/make_paper_figs.py``)
GOLDEN_FIGS = ROOT / "tests" / "torch_golden" / "paper_figs.json"
#: golden section -> (port module of ``repro_torch.benchmarks``, its
#: ``run()`` keywords): every module at its default (the golden's) size;
#: Fig. 11's plain pass on the CPU takes one probe cell, a memory-bound
#: one of short makespan (5478 cycles), where the reference's default
#: (its first 25 cells, arrival-bound ones up to 193k cycles) would take
#: the plain version many minutes
FIGURES = {"table1": ("paper_table1", {}), "table2": ("paper_table2", {}),
           "fig11": ("paper_fig11",
                     {"plain_cells": ["L4/cascaded_mlr/stream.3"]}),
           "fig12": ("paper_fig12", {}), "fig13": ("paper_fig13", {}),
           "fig14": ("paper_fig14", {}),
           "fig_policy": ("paper_fig_policy", {}),
           "fig_ooo": ("paper_fig_ooo", {}),
           "fig_refresh": ("paper_fig_refresh", {}),
           "fig_fault": ("paper_fig_fault", {})}
#: kernel launches a figure makes beyond one per shape group of its
#: sweeps: Fig. 12's cross-check `engine.simulate` of one cell
FIGURE_EXTRA_LAUNCHES = {"fig12": 1}
#: printed rows that carry times or launch counts, not results
TIMING_ROWS = ("# sweep:", "# pallas", "# plain")
#: keys of a figure's JSON section that are its record, not its `extra`,
#: or that count compiles/launches or carry timings
NOT_EXTRA = ("backend", "horizon", "n_cells", "compiles", "launches",
             "wall_s", "perf", "chunk_widths", "cell_names", "scalars",
             "smoke", "compiles_per_window", "launches_per_window",
             "cells_per_s_main")

#: published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth and
#: the float32 rate outside the tensor cores, the rate the kernel's scalar
#: integer work is held against
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
#: dense bf16 tensor-core peak of one H100 SXM (NVIDIA data sheet), the
#: rate the attention kernels' FLOPs are held against
PEAK_BF16_FLOPS = 989e12
#: exps per second of one H100 SXM's special-function units: 16 results
#: per clock per SM at compute capability 9.0 (CUDA C++ Programming
#: Guide, arithmetic instruction throughput), 132 SMs at the 1,980 MHz
#: boost clock (NVIDIA data sheet); the rate WKV6's exps are held against
PEAK_SFU_S = 16 * 132 * 1.98e9

#: the serving config and run of phase `serve`
SERVE_ARCH = "tinyllama-1.1b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_MAX_SEQ = 8, 256, 64, 512
#: logits tolerance of the kernel path against the plain path; in bf16
#: the bound is raised to 1.5x the gap between the reference's own two
#: plain paths where bf16 rounding alone exceeds it (phase `serve`)
SERVE_TOL = 5e-2
#: the same in float32 math, kernels against their plain versions (the
#: float32 logits tolerance of tests/test_torch_transformer.py)
SERVE_TOL_F32 = 1e-3

#: backward-kernel shapes of phase `attn_bwd_parity`: (B, S, Hq, Hkv, hd)
BWD_SHAPES = ((4, 2048, 32, 4, 64), (2, 512, 16, 8, 128), (2, 200, 32, 4, 64))
#: the bf16 tensor-core kernels' edges, forward and backward, at (B 2,
#: Hq 8, Hkv 2): (hd, S) for every head dim, S one row, ragged at the
#: kernels' 64-row tiles (200, 2000) and, at hd 16 and 32, the S of the
#: cases above (192, 256)
FLASH_EDGES = tuple((hd, s) for hd in (16, 32, 64, 128)
                    for s in (1, 200, 2000)) + tuple(
    (hd, s) for hd in (16, 32) for s in (192, 256))
#: bf16 products against the plain version: this fraction of max |o| or
#: of max |g| (one bf16 ulp; the kernels round P and dS to bf16 before
#: their products, and the sums run in another order)
BF16_TOL = 2 ** -7
#: the training config and run of phase `train` (TinyLlama's published
#: context, 2048 tokens)
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 6
#: layers of the resume check's model (full width, reduced depth)
RESUME_LAYERS = 2
#: float32 replay, kernels against their plain versions: the loss to this
#: relative error, every gradient leaf to this fraction of its max |g|
#: (only summation order differs: H100 runs measured 1.2e-7 and 7.0e-7)
TRAIN_LOSS_TOL_F32 = 1e-6
TRAIN_GRAD_TOL_F32 = 1e-5
#: bf16 losses of the kernel path against the plain versions; raised to
#: 1.5x the reference's own two plain paths' gap where bf16 rounding
#: alone exceeds it (H100: gap 3.0e-5, chunked vs naive 2.1e-4)
TRAIN_LOSS_TOL_BF16 = 1e-3

#: the float32 rate of the tensor cores (TF32) of one H100 SXM (NVIDIA
#: data sheet, dense): the matmul kernel's bound, three TF32 products
#: (3xTF32, float32-accurate) per float32 product
PEAK_TF32_FLOPS = 495e12
#: phase `pipe_parity`: (M, K, N, L) of the reference test's grid
#: (tests/test_kernels.py:149-150) and ragged M, N and stripes: the CPU
#: test's (70, 800, 33, 4) and one whose K/L (37) and N are both odd, rows
#: no TMA tensor map could describe unpadded
PIPE_GRID = ((128, 256, 128, 2), (256, 512, 128, 4), (128, 512, 256, 8))
PIPE_RAGGED = ((192, 512, 128, 4), (128, 384, 192, 4), (70, 800, 33, 4),
               (65, 148, 33, 4))
#: the kernel against its plain versions and `matmul_striped`: this
#: fraction of max |ref| for both dtypes (bf16 inputs are upcast exactly;
#: only the order of the float32 sums differs)
PIPE_TOL = 1e-5
#: phase `wkv_parity`: ((B, H, S, hd), chunks); the last is the training
#: shape of rwkv6-3b (batch 4 x 2048, 40 heads of 64, chunk 64)
WKV_SHAPES = (((2, 3, 128, 32), (16, 32, 64)), ((2, 2, 64, 16), (16,)),
              ((4, 40, 2048, 64), (64,)))
#: y and the state against the plain version and the sequential oracle,
#: float32: this fraction of max |ref|
WKV_TOL = 1e-5
#: phase `wkv_parity`'s strong decays, logw = -exp(n + WKV_STRONG_SHIFT):
#: sums of hundreds within a chunk, which overflow a whole-chunk
#: factorisation of the decays; ((B, H, S, hd), chunk), the last the
#: training shape
WKV_STRONG_SHIFT = 2.0
WKV_STRONG = (((2, 3, 128, 32), 64), ((2, 3, 128, 32), 16),
              ((4, 40, 2048, 64), 64))
#: the training config and run of phase `train_rwkv`: rwkv6-3b at full
#: width (d 2560, 40 heads of 64, d_ff 8960, vocab 65536) with its depth
#: cut from 32 layers to 8 (full depth holds 36.9 GB of float32 params,
#: m and v, twice that during the out-of-place AdamW update: more than
#: one card's 80 GB)
RWKV_ARCH = "rwkv6-3b"
RWKV_LAYERS = 8
RWKV_BATCH, RWKV_SEQ, RWKV_STEPS = 4, 2048, 6
#: RWKV-6's float32 gradients are not held to TRAIN_GRAD_TOL_F32 alone:
#: two float32 evaluations of one step that differ only in summation
#: order differ by far more than 1e-5 of max |g| (H100: the plain chunked
#: path against the sequential one, 8.9e-3 at the initial weights).  So
#: each is measured against a float64 witness, the plain and the
#: sequential path run in float64, and the kernel path must come within
#: 1.5 x the farther of the two plain float32 paths (at least
#: TRAIN_GRAD_TOL_F32); the loss stays at TRAIN_LOSS_TOL_F32
#: (kernel against plain), and the Function's own gradients are the plain
#: recompute's, the same code on both paths.  The witness's two paths
#: must agree to W64_TOL of each leaf's max |g|: float64 rounding,
#: amplified as float32's is, stays far below it, and any float32 left
#: in the witness would not.
W64_TOL = 1e-8


def float64_mode():
    """A torch dispatch mode that runs float32 work in float64: every
    float32 dtype argument of an ATen op (``.float()``, ``.to``, the
    factories) becomes float64.  Phase `train_rwkv`'s float64 witness
    runs the model's own code under it; the mode stays on in the
    backward, and so in the recomputes of ``torch.utils.checkpoint``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    def up(a):
        return torch.float64 if a is torch.float32 else a

    class Float64(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return func(*map(up, args),
                        **{k: up(v) for k, v in (kwargs or {}).items()})

    return Float64()


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


def as_json(a):
    """A metric as the golden file holds it: ints as ints, floats as
    floats, arrays as lists."""
    import numpy as np
    a = np.asarray(a)
    if a.ndim:
        return [as_json(x) for x in a]
    return int(a) if a.dtype.kind in "biu" else float(a)


def same_numbers(got, want, where: str) -> None:
    """Ints, bools and strings exact, floats to RTOL, containers element
    by element; raises naming `where`."""
    import numpy as np
    if isinstance(want, dict):
        if set(got) != set(want):
            raise RuntimeError(f"{where}: keys {sorted(set(got) ^ set(want))}")
        for k in want:
            same_numbers(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        if len(got) != len(want):
            raise RuntimeError(f"{where}: {len(got)} != {len(want)} items")
        for i, (g, w) in enumerate(zip(got, want)):
            same_numbers(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        if not (isinstance(got, float)
                and np.isclose(got, want, rtol=RTOL, atol=0.0)):
            raise RuntimeError(f"{where}: {got!r} != {want!r}")
    elif got != want or type(got) is not type(want):
        raise RuntimeError(f"{where}: {got!r} != {want!r}")


def stacked(cells, device, r_max=None):
    """One padded batch of port cells as tensors on `device`, padded as
    the sweep pads a shape group (rank axis to `r_max`)."""
    from repro_torch.convert import from_reference
    from repro_torch.core.smla.sweep import stack_cells
    return from_reference(*stack_cells(cells, r_max), device)


def cuda_ms(fn, reps=1, calls=1):
    """Median over `reps` of the CUDA-event time of `calls` back-to-back
    calls of `fn()`, per call, in ms (synchronised); and the last output."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(calls):
            out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return sorted(times)[len(times) // 2], out


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def device_events(prof):
    """(name, ms) of a ``torch.profiler`` window's device events (kernels,
    copies, fills), largest first.  Device events only: a CPU op's device
    time repeats its kernels'."""
    import torch
    return sorted(((e.key, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda kv: -kv[1])


def attn_bound_ms(bytes_moved: float, flops: float):
    """The larger of bytes over HBM bandwidth and FLOPs over the bf16
    tensor-core peak, in ms, and which of the two it is."""
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def flash_work(q, k, causal=True):
    """(bytes, FLOPs) flash attention must move and do for q (B,S,Hq,hd),
    k/v (B,S,Hkv,hd): q, k, v read once, o and the float32 lse written
    once; QK^T and PV over the causal triangle (or the full square)."""
    b, s, hq, hd = q.shape
    n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        + 4 * b * hq * s
    pairs = s * (s + 1) // 2 if causal else s * s
    return n_bytes, 4.0 * b * hq * hd * pairs


def flash_bwd_work(q, k, causal=True):
    """(bytes, FLOPs) the flash-attention backward must move and do for q
    (B,S,Hq,hd), k/v (B,S,Hkv,hd): q, k, v, o, do and the float32 lse read
    once, dq, dk, dv written once; five S x S x hd products per (batch,
    q head) — s, dp, dv, dk, dq — over the causal triangle (or the full
    square)."""
    b, s, hq, hd = q.shape
    n_bytes = 4 * (q.numel() + k.numel()) * q.element_size() \
        + 4 * b * hq * s
    pairs = s * (s + 1) // 2 if causal else s * s
    return n_bytes, 10.0 * b * hq * hd * pairs


def decode_work(q, k_cache, lengths):
    """(bytes, FLOPs) flash-decode must move and do: q read and o written
    once, each lane's K and V read up to its length; QK^T and PV over
    those positions for every q head."""
    b, _, hq, hd = q.shape
    hkv = k_cache.shape[2]
    n_pos = int(lengths.clamp(0, k_cache.shape[1]).sum())
    n_bytes = 2 * q.numel() * q.element_size() \
        + 2 * n_pos * hkv * hd * k_cache.element_size()
    return n_bytes, 4.0 * n_pos * hq * hd


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.core.smla import cuda_engine, engine, sweep
    from repro_torch.core.smla.analytic import default_horizon
    from repro_torch.core.smla.config import (ControllerPolicy, OooSelect,
                                              paper_configs)
    from repro_torch.core.smla.faults import DegradeMode, FaultConfig
    from repro_torch.core.smla.policies import POLICY_PRESETS
    from repro_torch.core.smla.traces import (WORKLOADS, TrafficMix,
                                              WorkloadSpec)
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.decode_attention import kernel as dec_kernel
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.benchmarks import (decode_bench, smla_pipe_bench,
                                        wkv6_bench)
    from repro_torch.kernels.smla_pipe import kernel as pipe_kernel
    from repro_torch.kernels.smla_pipe import ref as pipe_ref
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6 import ref as wkv_ref
    from repro_torch.models import rwkv6
    from repro_torch.launch import train as launch_train
    from repro_torch.models import common as cm
    from repro_torch.models import get_model, logits_fn
    from repro_torch.serve import bridge
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import loop as train_loop
    from repro_torch.train.losses import chunked_lm_loss
    from repro_torch.train.step import (init_state, make_grad_fn,
                                        make_train_step)

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
        builds = {cuda_engine.KERNEL_SOURCES: cuda_engine.build,
                  fa_kernel.KERNEL_SOURCES: fa_kernel.build,
                  fa_kernel.BWD_SOURCES: fa_kernel.build_bwd,
                  fa_kernel.TC_SOURCES: fa_kernel.build_tc,
                  fa_kernel.TC_BWD_SOURCES: fa_kernel.build_bwd_tc,
                  dec_kernel.KERNEL_SOURCES: dec_kernel.build,
                  pipe_kernel.KERNEL_SOURCES: pipe_kernel.build,
                  wkv_kernel.KERNEL_SOURCES: wkv_kernel.build}
        with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
            libs = list(pool.map(lambda fn: fn(), builds.values()))
        return libs, "nvcc built " + ", ".join(map(str, builds))

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

    def launch_bucket(bkt, horizon, core):
        """One bucket of a sweep plan as one kernel launch, timed alone:
        (ms, metrics)."""
        p_np, t_np = sweep.stack_cells([bkt.group[j] for j in bkt.positions],
                                       bkt.r_max, bkt.n_req_max)
        p_b, t_b = (engine._on_device(p_np, dev),
                    engine._on_device(t_np, dev))
        return cuda_ms(lambda: kern(p_b, t_b, horizon=horizon, core=core,
                                    banks=bkt.banks, chunk=bkt.chunk))

    def timed_groups(spec):
        """The main path's dispatch — one launch per shape group, each
        cell with its bucket's chunk width — each launch timed alone (CUDA
        events): (ms per launch, the result as `run_sweep` assembles
        it)."""
        times = []

        def launch(*a, **kw):
            ms, out = cuda_ms(lambda: kern(*a, **kw))
            times.append(ms)
            return out
        return times, sweep._run(spec, launch)

    def timed_buckets(spec):
        """The bucketed plan — one launch per makespan bucket (the sweep's
        unit on the CPU, through `engine.batched_simulate`), as before the
        one launch per shape group — each launch timed alone: (ms per
        launch, the result as `run_sweep` assembles it)."""
        times, real = [], engine.batched_simulate

        def timed(*a, **kw):
            ms, out = cuda_ms(lambda: real(*a, **kw))
            times.append(ms)
            return out
        engine.batched_simulate = timed
        try:
            return times, sweep._run(spec, None)
        finally:
            engine.batched_simulate = real

    def same_sweep(got, want, what):
        """Two sweep results agree: names, chunk widths, the buckets'
        cells, widths, rows and chunks_run, and every metric of every
        cell (ints exact, floats to RTOL)."""
        keys = ("cells", "chunk", "n_rows", "chunks_run")
        if (got.names != want.names or got.chunks != want.chunks
                or [[b[k] for k in keys] for b in got.buckets]
                != [[b[k] for k in keys] for b in want.buckets]):
            raise RuntimeError(f"{what}: plans or chunks differ")
        for name in want.names:
            compare({k: torch.from_numpy(np.asarray(v))
                     for k, v in got[name].items()},
                    {k: torch.from_numpy(np.asarray(v))
                     for k, v in want[name].items()}, f"{what}: {name}")

    def cycle_times(res, cells, kernel_ms):
        """us per simulated cycle of the slowest cell: the kernel's ms over
        its makespan, and over the cycles its chunks ran."""
        unit = {c.name: c.stack.unit_ns for c in cells}
        span = max(float(res[n]["makespan_ns"]) / unit[n] for n in res.names)
        ran = max(int(res[n]["chunks_run"]) * ch
                  for n, ch in zip(res.names, res.chunks))
        return {"slowest_makespan_cycles": span, "slowest_cycles_run": ran,
                "us_per_cycle": kernel_ms * 1e3 / span,
                "us_per_cycle_run": kernel_ms * 1e3 / ran}

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
        groups = sweep.shape_groups(spec)
        torch.cuda.synchronize()
        kern.launches = 0
        t0 = time.perf_counter()
        res = sweep.run_sweep(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kern.launches
        if launches < 1 or launches != groups:
            raise RuntimeError(f"main path launched the kernel {launches} "
                               f"times for {groups} shape groups "
                               f"({len(res.buckets)} buckets)")
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

        # the whole grid's kernel time: the main path's launch per shape
        # group, timed alone; its result must be the main path's
        group_ms, again = timed_groups(spec)
        same_sweep(again, res, "grid timed")
        grid_ms = sum(group_ms)
        # the bucketed plan once more, for the record (one launch per
        # makespan bucket, each timed alone): its chunks and every metric
        # must equal the main path's
        bucket_ms, bucketed = timed_buckets(spec)
        same_sweep(bucketed, res, "grid bucketed vs one launch per group")
        # the same grid as one launch at one chunk width (one bucket, no
        # makespan batching); its metrics must equal the main path's
        (one,) = sweep._plan(dataclasses.replace(
            spec, makespan_batching=False), spec.options, cells, "cuda")
        one_ms, one_out = launch_bucket(one, horizon, core)
        compare({k: v.cpu() for k, v in one_out.items()},
                {k: torch.from_numpy(np.stack([res[one.group[j].name][k]
                                               for j in one.positions]))
                 for k in one_out}, "grid as one launch",
                skip=("chunks_run",))
        stats = {
            "cells": len(res.names), "horizon": horizon, "wall_s": wall,
            "cells_per_s": len(res.names) / wall, "launches": launches,
            "shape_groups": groups, "buckets": len(res.buckets),
            "grid_kernel_ms": grid_ms, "group_ms": group_ms,
            "grid_bucketed_ms": sum(bucket_ms),
            "grid_one_launch_ms": one_ms, "one_launch_chunk": one.chunk,
            **cycle_times(res, cells, grid_ms),
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
                       f"{grid_ms:.3f} ms over {launches} launch(es), one "
                       f"per shape group ({stats['grid_bucketed_ms']:.3f} "
                       f"ms over {len(bucket_ms)} bucket launches, "
                       f"{one_ms:.3f} ms as one launch at one width), "
                       f"{stats['us_per_cycle']:.4f} us per cycle of the "
                       f"slowest cell, chunks_run sum "
                       f"{stats['chunks_run_sum']}")

    bf16, f32 = torch.bfloat16, torch.float32
    attn_err = {"flash": 0.0, "decode": 0.0}

    def randn(gen, shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def flash_plain(q, k, v, causal=True):
        o, lse = fa_ref.attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal)
        return o.transpose(1, 2), lse

    def decode_plain(q, k_cache, v_cache, lengths):
        b, _, hq, hd = q.shape
        hkv = k_cache.shape[2]
        out = dec_ref.decode_attend(q[:, 0].reshape(b, hkv, hq // hkv, hd),
                                    k_cache.transpose(1, 2),
                                    v_cache.transpose(1, 2), lengths)
        return out.reshape(b, 1, hq, hd)

    def check(err, tol, what, kind):
        if not err <= tol:
            raise RuntimeError(f"{what}: max abs error {err} > {tol}")
        attn_err[kind] = max(attn_err[kind], err)

    @phase("attn_parity")
    def attn_parity():
        gen = torch.Generator(device=dev).manual_seed(0)
        n = 0
        for b, hq, hkv, hd in ((8, 32, 4, 64), (2, 16, 8, 128)):
            for s_len in (256, 192):
                for dt in (bf16, f32):
                    for causal in (True, False):
                        q = randn(gen, (b, s_len, hq, hd), dt)
                        k = randn(gen, (b, s_len, hkv, hd), dt)
                        v = randn(gen, (b, s_len, hkv, hd), dt)
                        o, lse = fa_kernel.flash_attention_fwd(
                            q, k, v, causal=causal)
                        want_o, want_lse = flash_plain(q, k, v, causal)
                        # bf16: one bf16 ulp at max|o| (the float32 sums
                        # run in another order); float32: 1e-5
                        tol_o = (1e-5 if dt == f32 else
                                 2 ** -7 * float(want_o.float().abs().max()))
                        what = (f"flash B{b} Hq{hq} Hkv{hkv} hd{hd} S{s_len}"
                                f" {dt} causal={causal}")
                        check(max_abs(o, want_o), tol_o, what + " o",
                              "flash")
                        check(max_abs(lse, want_lse),
                              1e-5 if dt == f32 else 1e-4, what + " lse",
                              "flash")
                        n += 1
        # the bf16 tensor-core kernel's edges: every head dim, one row,
        # S ragged at its 64-row tiles
        for hd, s_len in FLASH_EDGES:
            for causal in (True, False):
                q = randn(gen, (2, s_len, 8, hd), bf16)
                k = randn(gen, (2, s_len, 2, hd), bf16)
                v = randn(gen, (2, s_len, 2, hd), bf16)
                o, lse = fa_kernel.flash_attention_fwd(q, k, v,
                                                       causal=causal)
                want_o, want_lse = flash_plain(q, k, v, causal)
                what = f"flash edge hd{hd} S{s_len} causal={causal}"
                check(max_abs(o, want_o),
                      BF16_TOL * float(want_o.float().abs().max()),
                      what + " o", "flash")
                check(max_abs(lse, want_lse), 1e-4, what + " lse", "flash")
                n += 1
        # the route of each dtype, read from the wrapper's counts: bf16
        # on the tensor cores, float32 still on the CUDA cores (1e-5)
        for dt, path in ((bf16, "tensor_core"), (f32, "cuda_core")):
            q = randn(gen, (2, 200, 8, 64), dt)
            k = randn(gen, (2, 200, 2, 64), dt)
            v = randn(gen, (2, 200, 2, 64), dt)
            before = dict(fa_kernel.flash_attention_fwd.route_launches)
            o, _ = fa_kernel.flash_attention_fwd(q, k, v)
            after = fa_kernel.flash_attention_fwd.route_launches
            moved = {r: after[r] - before[r] for r in after}
            if moved != {r: int(r == path) for r in after}:
                raise RuntimeError(f"flash {dt}: route launches {moved}, "
                                   f"want one on {path}")
            want_o = flash_plain(q, k, v)[0]
            check(max_abs(o, want_o), 1e-5 if dt == f32 else
                  BF16_TOL * float(want_o.float().abs().max()),
                  f"flash route {path}", "flash")
            n += 1
        b, hq, hkv, hd = 8, 32, 4, 64
        dec_splits = {}
        for dt in (bf16, f32):
            for smax in (512, 300):
                q = randn(gen, (b, 1, hq, hd), dt)
                kc = randn(gen, (b, smax, hkv, hd), dt)
                vc = randn(gen, (b, smax, hkv, hd), dt)
                # 63: one below a chunk boundary; 1; full; odd lengths
                lens = torch.tensor([smax, 1, 63, 64, 65, 200, smax - 1,
                                     129], dtype=torch.int32, device=dev)
                what = f"decode Smax {smax} {dt}"
                o = dec_kernel.decode_attention(q, kc, vc, lens)
                want = decode_plain(q, kc, vc, lens)
                # bf16: one bf16 ulp at max|o|; float32: 1e-5 (the float32
                # sums run in another order)
                check(max_abs(o, want), 1e-5 if dt == f32 else
                      2 ** -7 * float(want.float().abs().max()), what,
                      "decode")
                # the combine, bit for bit: its plain version and the
                # combine kernel alone, on the split kernel's own partials
                o2, (m, l, acc) = dec_kernel.decode_attention_partials(
                    q, kc, vc, lens)
                if not (torch.equal(o2, o) and torch.equal(
                        dec_ref.combine_splits(m, l, acc, dt).reshape(
                            o.shape), o)
                        and torch.equal(dec_kernel.combine(m, l, acc, dt),
                                        o)):
                    raise RuntimeError(f"{what}: the combine differs from "
                                       f"ref.combine_splits")
                dec_splits[smax] = m.shape[2]
                # a lane of length 0 gives zeros; the others do not move
                lens0 = lens.clone()
                lens0[1] = 0
                o0 = dec_kernel.decode_attention(q, kc, vc, lens0)
                others = [i for i in range(b) if i != 1]
                if o0[1].any() or not torch.equal(o0[others], o[others]):
                    raise RuntimeError(f"{what}: a lane of length 0")
                kg, vg = kc.clone(), vc.clone()
                for i, n_len in enumerate(lens.tolist()):
                    kg[i, n_len:] = 1e4
                    vg[i, n_len:] = -1e4
                if not torch.equal(dec_kernel.decode_attention(q, kg, vg,
                                                               lens), o):
                    raise RuntimeError(f"{what}: values past the lengths "
                                       f"changed the output")
                n += 1

        # times at the serving path's shapes: prefill of 8 x 256 tokens,
        # and a decode step at the middle of the 63 steps (length 288 in
        # a 512-row cache)
        q = randn(gen, (SERVE_BATCH, SERVE_PROMPT, 32, 64), bf16)
        k = randn(gen, (SERVE_BATCH, SERVE_PROMPT, 4, 64), bf16)
        v = randn(gen, (SERVE_BATCH, SERVE_PROMPT, 4, 64), bf16)
        tq, tk, tv = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        fa = {"ms": cuda_ms(lambda: fa_kernel.flash_attention_fwd(q, k, v),
                            reps=5, calls=20)[0],
              "plain_ms": cuda_ms(lambda: flash_plain(q, k, v), reps=3,
                                  calls=5)[0],
              "library_ms": cuda_ms(lambda: sdpa(tq, tk, tv, is_causal=True,
                                                 enable_gqa=True),
                                    reps=5, calls=20)[0]}
        fa["bound_ms"], fa["bound_by"] = attn_bound_ms(*flash_work(q, k))
        # (`decode_bench`: the host's time per call, CUDA events around
        # back-to-back calls, and the device's, a replayed CUDA graph and
        # the profiler's device events), beside one SDPA call
        if decode_bench.SERVING != (SERVE_BATCH, 32, 4, 64, SERVE_MAX_SEQ,
                              SERVE_PROMPT + SERVE_NEW // 2):
            raise RuntimeError("decode_bench.SERVING is not phase serve's "
                               "decode step")
        bench = decode_bench.run()
        qd, kc, vc, lens = decode_bench.inputs(*decode_bench.SERVING)
        de = {"ms": bench["kernel_ms"],
              "device_ms": bench["kernel_device_ms"],
              "profiled_ms": bench["kernel_profiled_ms"],
              "plain_ms": cuda_ms(lambda: decode_plain(qd, kc, vc, lens),
                                  reps=3, calls=5)[0],
              "library_ms": bench["sdpa_ms"],
              "library_device_ms": bench["sdpa_device_ms"],
              "library_profiled_ms": bench["sdpa_profiled_ms"],
              "splits": dec_kernel.layout(qd, kc, vc, lens).ints[-2],
              "splits_mixed_lengths": dec_splits}
        de["bound_ms"], de["bound_by"] = attn_bound_ms(
            *decode_work(qd, kc, lens))
        # the combine kernel alone at the same shape, on the split
        # kernel's partials; its plain version ref.combine_splits
        _, (m, l, acc) = dec_kernel.decode_attention_partials(qd, kc, vc,
                                                              lens)
        comb = lambda: dec_kernel.combine(m, l, acc, bf16)  # noqa: E731
        parts_bytes = 4 * (m.numel() + l.numel() + acc.numel()) \
            + 2 * qd.numel()
        co = {"ms": decode_bench.host_ms(comb),
              "device_ms": decode_bench.device_ms(comb),
              "plain_ms": cuda_ms(lambda: dec_ref.combine_splits(
                  m, l, acc, bf16), reps=3, calls=5)[0],
              "library_ms": None,
              "bound_ms": parts_bytes / PEAK_BYTES_S * 1e3,
              "bound_by": "bytes"}
        out = {"flash": fa, "decode": de, "combine": co}
        print(json.dumps({"attn_parity": out}), flush=True)
        return out, (f"{n} kernel-vs-plain checks passed (max abs err "
                     f"flash {attn_err['flash']}, decode "
                     f"{attn_err['decode']}; the decode combine "
                     f"bit-identical); flash {fa['ms']:.4f} ms, decode "
                     f"{de['ms']:.4f} ms per call, device "
                     f"{de['device_ms']:.4f} ms ({de['splits']} splits; "
                     f"SDPA {de['library_ms']:.4f}, device "
                     f"{de['library_device_ms']:.4f}), combine "
                     f"{co['device_ms']:.4f} ms on the device")

    def flash_bwd_plain(q, k, v, o, lse, do, causal=True):
        t = lambda x: x.transpose(1, 2)  # noqa: E731
        return tuple(t(x) for x in fa_ref.attention_bwd(
            t(q), t(k), t(v), t(o), lse, t(do), causal=causal))

    def rel_err(got, want) -> float:
        """max |got - want| over max |want|."""
        return max_abs(got, want) / max(float(want.float().abs().max()),
                                        1e-30)

    bwd_err = {"max_abs": 0.0, "max_rel": 0.0}

    def bwd_twice(q, k, v, o, lse, do, causal):
        """The backward kernel's gradients; in bf16 it runs twice and the
        two must agree bit for bit (no atomics: one fixed order)."""
        got = fa_kernel.flash_attention_bwd(q, k, v, o, lse, do,
                                            causal=causal)
        if q.dtype == bf16:
            again = fa_kernel.flash_attention_bwd(q, k, v, o, lse, do,
                                                  causal=causal)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise RuntimeError(f"flash bwd {tuple(q.shape)} causal="
                                   f"{causal}: two calls differ")
        return got

    @phase("attn_bwd_parity")
    def attn_bwd_parity():
        gen = torch.Generator(device=dev).manual_seed(1)
        n = 0
        for b, s_len, hq, hkv, hd in BWD_SHAPES:
            for dt in (bf16, f32):
                for causal in (True, False):
                    q = randn(gen, (b, s_len, hq, hd), dt)
                    k = randn(gen, (b, s_len, hkv, hd), dt)
                    v = randn(gen, (b, s_len, hkv, hd), dt)
                    do = randn(gen, (b, s_len, hq, hd), dt)
                    o, lse = fa_kernel.flash_attention_fwd(q, k, v,
                                                           causal=causal)
                    got = bwd_twice(q, k, v, o, lse, do, causal)
                    want = flash_bwd_plain(q, k, v, o, lse, do, causal)
                    # float32: 1e-5 of max |grad| (sums in another
                    # order); bf16: one bf16 ulp at max |grad|
                    tol = 1e-5 if dt == f32 else 2 ** -7
                    for name, g, w in zip(("dq", "dk", "dv"), got, want):
                        if g.dtype != w.dtype or g.shape != w.shape:
                            raise RuntimeError(f"bwd {name}: {g.dtype}"
                                               f"{tuple(g.shape)}")
                        err = rel_err(g, w)
                        if not err <= tol:
                            raise RuntimeError(
                                f"flash bwd B{b} S{s_len} Hq{hq} Hkv{hkv} "
                                f"hd{hd} {dt} causal={causal} {name}: "
                                f"relative error {err} > {tol}")
                        bwd_err["max_rel"] = max(bwd_err["max_rel"], err)
                        bwd_err["max_abs"] = max(bwd_err["max_abs"],
                                                 max_abs(g, w))
                    n += 1

        # the bf16 tensor-core kernels' edges, as in attn_parity.  At
        # S = 1, dq and dk are zero in exact arithmetic and both sides
        # hold only rounding noise: there they are held to BF16_TOL of
        # max |dv| instead of their own max
        for hd, s_len in FLASH_EDGES:
            for causal in (True, False):
                q, do = (randn(gen, (2, s_len, 8, hd), bf16)
                         for _ in range(2))
                k, v = (randn(gen, (2, s_len, 2, hd), bf16)
                        for _ in range(2))
                o, lse = fa_kernel.flash_attention_fwd(q, k, v,
                                                       causal=causal)
                got = bwd_twice(q, k, v, o, lse, do, causal)
                want = flash_bwd_plain(q, k, v, o, lse, do, causal)
                for name, g, w in zip(("dq", "dk", "dv"), got, want):
                    scale = want[2] if s_len == 1 else w
                    err = max_abs(g, w) / max(
                        float(scale.float().abs().max()), 1e-30)
                    if not err <= BF16_TOL:
                        raise RuntimeError(
                            f"flash bwd edge hd{hd} S{s_len} causal="
                            f"{causal} {name}: relative error {err} > "
                            f"{BF16_TOL}")
                    bwd_err["max_rel"] = max(bwd_err["max_rel"], err)
                    bwd_err["max_abs"] = max(bwd_err["max_abs"],
                                             max_abs(g, w))
                n += 1
        # float32 still runs the CUDA-core backward (held at 1e-5 above)
        q, do = (randn(gen, (2, 200, 8, 64), f32) for _ in range(2))
        k, v = (randn(gen, (2, 200, 2, 64), f32) for _ in range(2))
        o, lse = fa_kernel.flash_attention_fwd(q, k, v)
        before = dict(fa_kernel.flash_attention_bwd.route_launches)
        fa_kernel.flash_attention_bwd(q, k, v, o, lse, do)
        moved = {r: fa_kernel.flash_attention_bwd.route_launches[r]
                 - before[r] for r in before}
        if moved != {"tensor_core": 0, "cuda_core": 1}:
            raise RuntimeError(f"flash bwd float32: route launches {moved}")

        # end to end: gradients through the autograd Function against
        # autograd through the plain forward (float32, 1e-5 of max |g|;
        # bf16, BF16_TOL); a ragged S with q/k/v strided views of one
        # fused projection, and the training shape
        def grads(x, b, s_len, hq, hkv, hd, kernel):
            q, k, v = torch.split(x, [hq * hd, hkv * hd, hkv * hd], -1)
            q, k, v = (t.view(b, s_len, -1, hd) for t in (q, k, v))
            if kernel:
                o = fa_ops.flash_attention(q, k, v, causal=True)
            else:
                o = flash_plain(q, k, v, True)[0]
            return torch.autograd.grad((o.float() ** 2).sum(), x)[0]
        e2e = {f32: 0.0, bf16: 0.0}
        for dt, tol in ((f32, 1e-5), (bf16, BF16_TOL)):
            for b, s_len, hq, hkv, hd in ((2, 200, 8, 2, 64), BWD_SHAPES[0]):
                x = randn(gen, (b, s_len, (hq + 2 * hkv) * hd),
                          dt).requires_grad_()
                fa_kernel.flash_attention_bwd.launches = 0
                got = grads(x, b, s_len, hq, hkv, hd, True)
                if fa_kernel.flash_attention_bwd.launches != 1:
                    raise RuntimeError("autograd did not launch the "
                                       "backward kernel once")
                err = rel_err(got, grads(x, b, s_len, hq, hkv, hd, False))
                if not err <= tol:
                    raise RuntimeError(f"flash autograd {dt} S{s_len}: "
                                       f"relative error {err} > {tol}")
                e2e[dt] = max(e2e[dt], err)
                n += 1

        # times at the training path's shape, bf16, causal
        b, s_len, hq, hkv, hd = BWD_SHAPES[0]
        q = randn(gen, (b, s_len, hq, hd), bf16)
        k = randn(gen, (b, s_len, hkv, hd), bf16)
        v = randn(gen, (b, s_len, hkv, hd), bf16)
        do = randn(gen, (b, s_len, hq, hd), bf16)
        o, lse = fa_kernel.flash_attention_fwd(q, k, v)
        tq, tk, tv = (x.transpose(1, 2).requires_grad_()
                      for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        so = sdpa(tq, tk, tv, is_causal=True, enable_gqa=True)
        tdo = do.transpose(1, 2)
        bw = {"ms": cuda_ms(lambda: fa_kernel.flash_attention_bwd(
                  q, k, v, o, lse, do), reps=5, calls=5)[0],
              "plain_ms": cuda_ms(lambda: flash_bwd_plain(
                  q, k, v, o, lse, do), reps=3, calls=3)[0],
              "library_ms": cuda_ms(lambda: torch.autograd.grad(
                  so, (tq, tk, tv), tdo, retain_graph=True),
                  reps=5, calls=5)[0],
              "fwd_ms": cuda_ms(lambda: fa_kernel.flash_attention_fwd(
                  q, k, v), reps=5, calls=5)[0],
              "fwd_library_ms": cuda_ms(lambda: sdpa(
                  tq, tk, tv, is_causal=True, enable_gqa=True),
                  reps=5, calls=5)[0]}
        bw["bound_ms"], bw["bound_by"] = attn_bound_ms(*flash_bwd_work(q, k))
        bw["fwd_bound_ms"] = attn_bound_ms(*flash_work(q, k))[0]
        bw["autograd_rel_err"] = e2e[f32]
        bw["autograd_rel_err_bf16"] = e2e[bf16]
        print(json.dumps({"attn_bwd_parity": bw}), flush=True)
        return bw, (f"{n} backward checks passed (max relative err "
                    f"{bwd_err['max_rel']}, autograd {e2e[f32]} float32, "
                    f"{e2e[bf16]} bf16); bwd "
                    f"{bw['ms']:.4f} ms per call at B{b} S{s_len} Hq{hq} "
                    f"(plain {bw['plain_ms']:.4f}, SDPA backward "
                    f"{bw['library_ms']:.4f}, bound {bw['bound_ms']:.5f}); "
                    f"fwd {bw['fwd_ms']:.4f} ms (SDPA "
                    f"{bw['fwd_library_ms']:.4f})")

    def decode_profile(eng, prefill_fn, decode_fn, tokens, out, n=8):
        """`n` decode steps of the serving run under torch.profiler: the
        window's wall time (the profiler slows the host), the device's
        busy time per step (the device events' own time: kernels, copies
        and fills) and the device events taking most of it."""
        from torch.profiler import ProfilerActivity, profile
        n = min(n, out.shape[1])
        with torch.inference_mode():
            cache = eng.model.init_cache(eng.cfg, SERVE_BATCH,
                                         SERVE_MAX_SEQ, eng.pcfg, device=dev)
            cache, _ = prefill_fn(eng.params,
                                  {"tokens": torch.from_numpy(tokens).to(dev)},
                                  cache)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for t in range(n):
                    cache, _ = decode_fn(eng.params, out[:, t:t + 1], cache)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = device_events(prof)
        busy_ms = sum(ms for _, ms in kernels)
        return {"steps": n, "profiled_wall_ms_per_step": wall_ms / n,
                "device_busy_ms_per_step": (busy_ms / n if busy_ms
                                            else "not measured"),
                "top_device_events_ms_per_step": [
                    (k[:80], ms / n) for k, ms in kernels[:8]]}

    @phase("serve")
    def serve():
        cfg = get_config(SERVE_ARCH)
        model = get_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        eng = Engine(cfg, ParallelConfig(attn_impl="pallas",
                                         moe_impl="dense", remat="none"),
                     ServeConfig(max_seq=SERVE_MAX_SEQ, eos_id=-1),
                     model.init(gen, cfg, device=dev), device=dev)
        tokens = SyntheticLM(cfg.vocab_size, SERVE_PROMPT, SERVE_BATCH,
                             seed=7).batch(0)["tokens"]
        eng.generate({"tokens": tokens}, 2)          # warm-up, not counted

        # record every step's logits and time it (CUDA events)
        logits, events = [], []

        def recorded(fn, kind):
            def run(*a):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                cache, lg = fn(*a)
                e1.record()
                events.append((kind, e0, e1))
                logits.append(lg[:, -1].clone())
                return cache, lg
            return run
        prefill_fn, decode_fn = eng.prefill_fn, eng.decode_fn
        eng.prefill_fn = recorded(prefill_fn, "prefill")
        eng.decode_fn = recorded(decode_fn, "decode")

        torch.cuda.synchronize()
        fa_kernel.flash_attention_fwd.launches = 0
        dec_kernel.decode_attention.launches = 0
        dec_kernel.decode_attention.combine_launches = 0
        t0 = time.perf_counter()
        out, cap = bridge.capture_generate(eng, {"tokens": tokens},
                                           SERVE_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash": fa_kernel.flash_attention_fwd.launches,
                    "decode": dec_kernel.decode_attention.launches,
                    "decode_combine":
                        dec_kernel.decode_attention.combine_launches}
        want = {"flash": cfg.n_layers,
                "decode": cfg.n_layers * (SERVE_NEW - 1),
                "decode_combine": cfg.n_layers * (SERVE_NEW - 1)}
        if launches != want:
            raise RuntimeError(f"serve: kernel launches {launches}, want "
                               f"{want}")
        if tuple(out.shape) != (SERVE_BATCH, SERVE_NEW) or not (
                (out >= 0) & (out < cfg.vocab_size)).all():
            raise RuntimeError(f"serve: bad tokens {tuple(out.shape)}")
        if not all(bool(torch.isfinite(lg).all()) for lg in logits):
            raise RuntimeError("serve: non-finite logits")
        times = {k: [e0.elapsed_time(e1) for kk, e0, e1 in events if kk == k]
                 for k in ("prefill", "decode")}
        profile = decode_profile(eng, prefill_fn, decode_fn, tokens, out)
        busy = profile["device_busy_ms_per_step"]
        # idle share of an unprofiled decode step of the main run
        profile["device_idle_share"] = (
            1 - busy * len(times["decode"]) / sum(times["decode"])
            if busy != "not measured" else busy)

        # the same tokens, teacher-forced, through the plain path
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = cm.cast_weights(eng.params, cfg32)   # the same weights

        def replay(impl, rcfg=cfg, kernels_plain=False):
            """Every step's logits of the same tokens, teacher-forced;
            with `kernels_plain`, the model's two kernel calls run the
            kernels' plain versions (on the card) instead."""
            pc = ParallelConfig(attn_impl=impl, moe_impl="dense",
                                remat="none")
            params = eng.params if rcfg is cfg else params32
            steps = []
            saved = fa_ops.flash_attention, dec_ops.decode_attention
            if kernels_plain:
                fa_ops.flash_attention = (
                    lambda q, k, v, causal=True: flash_plain(q, k, v,
                                                             causal)[0])
                dec_ops.decode_attention = decode_plain
            try:
                with torch.inference_mode():
                    cache = model.init_cache(rcfg, SERVE_BATCH,
                                             SERVE_MAX_SEQ, pc, device=dev)
                    cache, last = model.prefill(
                        params, {"tokens": torch.from_numpy(tokens).to(dev)},
                        cache, rcfg, pc)
                    steps.append(logits_fn(params, last, rcfg)[:, -1])
                    for t in range(SERVE_NEW - 1):
                        cache, lg = model.decode(params, out[:, t:t + 1],
                                                 cache, rcfg, pc)
                        steps.append(lg[:, -1])
            finally:
                fa_ops.flash_attention, dec_ops.decode_attention = saved
            return steps

        def gap(a, b):
            return max(max_abs(x, y) for x, y in zip(a, b))
        plain = replay("naive")
        exact = replay("naive", cfg32)
        gaps = {"kernel_vs_naive": gap(logits, plain),
                # the bf16 noise floor: the reference's other plain path
                "chunked_vs_naive": gap(replay("chunked"), plain),
                "kernel_vs_f32": gap(logits, exact),
                "naive_vs_f32": gap(plain, exact),
                # the same weights and tokens in float32 math: the kernels'
                # float32 builds against their plain versions, model-wide
                "kernel_f32_vs_plain_f32": gap(
                    replay("pallas", cfg32),
                    replay("pallas", cfg32, kernels_plain=True))}
        gaps["token_gap"] = max(float((lg.max(-1).values - lg.gather(
            1, out[:, t:t + 1].long())[:, 0]).max())
            for t, lg in enumerate(plain))
        print(json.dumps({"serve_vs_plain": gaps}), flush=True)
        # bf16: the kernel path must be as close to the plain path as the
        # reference's own two plain paths are to each other (x1.5), or
        # within SERVE_TOL; a generated token may trail the plain path's
        # top logit by at most twice that (a near-tie flipped by it).
        # float32: the kernels against their plain versions, model-wide,
        # within SERVE_TOL_F32.
        tol16 = max(SERVE_TOL, 1.5 * gaps["chunked_vs_naive"])
        if not (gaps["kernel_vs_naive"] <= tol16
                and gaps["token_gap"] <= 2 * tol16
                and gaps["kernel_f32_vs_plain_f32"] <= SERVE_TOL_F32):
            raise RuntimeError(f"serve: kernel path vs plain path {gaps} "
                               f"(bf16 tolerance {tol16}, float32 "
                               f"{SERVE_TOL_F32})")
        st = {"arch": SERVE_ARCH, "batch": SERVE_BATCH,
              "prompt": SERVE_PROMPT, "new_tokens": SERVE_NEW,
              "launches": launches, "wall_s": wall,
              "prefill_ms": times["prefill"][0],
              "decode_ms_per_step": sum(times["decode"])
              / len(times["decode"]),
              "tokens_per_s": SERVE_BATCH * SERVE_NEW / wall,
              "vs_plain": gaps, "bf16_tolerance": tol16,
              "decode_profile": profile, "card": smi}
        print(json.dumps({"serve": st}), flush=True)
        return (cap, st), (
            f"{SERVE_ARCH} B{SERVE_BATCH} prompt {SERVE_PROMPT} +"
            f"{SERVE_NEW}: prefill {st['prefill_ms']:.3f} ms, decode "
            f"{st['decode_ms_per_step']:.3f} ms/step, "
            f"{st['tokens_per_s']:.1f} tok/s ({smi}); launches {launches}; "
            f"logits vs plain {gaps['kernel_vs_naive']:.5f} (bf16, floor "
            f"{gaps['chunked_vs_naive']:.5f}), "
            f"{gaps['kernel_f32_vs_plain_f32']:.6f} (float32)")

    #: benchmarks/paper_fig_serve.py:37-47, in this package's TrafficMix
    traffic_classes = (
        TrafficMix("decode_steady", prefill_frac=0.05, arrival="poisson",
                   n_tenants=4, intensity=1.0),
        TrafficMix("prefill_heavy", prefill_frac=0.5, arrival="poisson",
                   n_tenants=4, intensity=1.0),
        TrafficMix("bursty_tenants", prefill_frac=0.2, arrival="gamma",
                   cv2=8.0, n_tenants=4, intensity=1.0),
    )
    orgs = ("cascaded_mlr", "cascaded_slr")

    @phase("serve_sim")
    def serve_sim(cap):
        prof = bridge.StreamProfile.from_capture(cap)
        cfgs = {name: paper_configs(4)[name] for name in orgs}
        r_max = max(sc.n_ranks for sc in cfgs.values())
        banks = next(iter(cfgs.values())).banks_per_rank

        def cells_for(mixes, n_req):
            return [sweep.SweepCell(f"{mix.name}/{org}", sc,
                                    bridge.mix_trace(0, mix, prof, n_req,
                                                     r_max, banks))
                    for mix in mixes for org, sc in cfgs.items()]
        cells = cells_for(traffic_classes, 600)
        presets = tuple(POLICY_PRESETS.values())
        horizon = default_horizon(sweep.policy_cells(cells, presets))
        spec = sweep.SweepSpec(tuple(cells),
                               engine.SimOptions(horizon=horizon),
                               policies=presets)
        groups = sweep.shape_groups(spec)
        torch.cuda.synchronize()
        kern.launches = 0
        t0 = time.perf_counter()
        res = sweep.run_sweep(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kern.launches
        if launches < 1 or launches != groups:
            raise RuntimeError(f"serve_sim: {launches} launches for "
                               f"{groups} shape groups ({len(res.buckets)} "
                               f"buckets)")
        for name in res.names:
            m = res[name]
            if not (bool(m["complete"].all()) and (m["served"] == 600).all()):
                raise RuntimeError(f"serve_sim {name}: fixed work not "
                                   f"completed")
        sc = res.scalars(("bandwidth_gbps",))
        if not (np.isfinite(sc["bandwidth_gbps"]).all()
                and (sc["bandwidth_gbps"] > 0).all()):
            raise RuntimeError("serve_sim: non-finite or zero bandwidth")
        group_ms, again = timed_groups(spec)
        same_sweep(again, res, "serve_sim timed")
        kernel_ms = sum(group_ms)
        bucket_ms, bucketed = timed_buckets(spec)
        same_sweep(bucketed, res, "serve_sim bucketed vs one launch per "
                   "group")
        # one class x both organisations, default policy, n_req 120:
        # kernel against the plain engine on the card
        small = cells_for(traffic_classes[:1], 120)
        if banks != 2:
            raise RuntimeError(f"serve_sim: {banks} banks per rank")
        kernel_vs_plain(small, default_horizon(small), 256,
                        engine.CoreParams(), "serve_sim decode_steady x orgs")
        st = {"cells": len(res.names), "horizon": horizon,
              "launches": launches, "shape_groups": groups,
              "buckets": len(res.buckets), "wall_s": wall,
              "kernel_ms": kernel_ms, "bucketed_kernel_ms": sum(bucket_ms),
              **cycle_times(res, sweep._sweep_cells(spec), kernel_ms),
              "profile": dataclasses.asdict(prof),
              "mean_bandwidth_gbps": float(sc["bandwidth_gbps"].mean())}
        print(json.dumps({"serve_sim": st}), flush=True)
        return st, (f"{len(res.names)} cells in {wall:.3f} s, {launches} "
                    f"launch(es), one per shape group, kernel "
                    f"{kernel_ms:.3f} ms ({st['bucketed_kernel_ms']:.3f} ms "
                    f"over {len(bucket_ms)} bucket launches), "
                    f"{st['us_per_cycle']:.4f} us per cycle of the slowest "
                    f"cell; kernel == plain on {len(small)} cells at n_req "
                    f"120")

    def sweep_json(spec, res):
        """A port sweep as the golden file holds one."""
        return {"horizon": int(spec.options.horizon),
                "n_req": max(int(c.traces["inst"].shape[1])
                             for c in spec.cells),
                "window": int(spec.core.window), "names": list(res.names),
                "chunks": [int(c) for c in res.chunks],
                "cells": {n: cell_json(res[n]) for n in res.names}}

    def cell_json(m):
        return {**{k: as_json(m[k]) for k in sweep.SCALAR_METRICS},
                "served": as_json(m["served"]), "ipc": as_json(m["ipc"])}

    def run_figure(section, gold):
        """One module of `FIGURES` through its ``run()`` on the card,
        every `run_sweep` recorded; held against its golden section."""
        import importlib
        mod_name, kw = FIGURES[section]
        mod = importlib.import_module(f"repro_torch.benchmarks.{mod_name}")
        runs, orig = [], sweep.run_sweep

        def recorded(spec):
            t0 = time.perf_counter()
            res = orig(spec)
            runs.append((spec, res, time.perf_counter() - t0))
            return res
        sweep.run_sweep = recorded
        torch.cuda.synchronize()
        kern.launches = 0
        t0 = time.perf_counter()
        try:
            rows = mod.run(**kw)
        finally:
            sweep.run_sweep = orig
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kern.launches
        card = [(sp, r, dt) for sp, r, dt in runs if r.device == "cuda"]
        groups = sum(sweep.shape_groups(sp) for sp, _, _ in card)
        want = groups + FIGURE_EXTRA_LAUNCHES.get(section, 0)
        if launches != want:
            raise RuntimeError(f"figures {section}: {launches} launches, "
                               f"want {want} ({groups} shape groups)")
        data = [r for r in rows if not r.startswith(TIMING_ROWS)]
        if data != [r for r in gold["rows"]
                    if not r.startswith(TIMING_ROWS)]:
            raise RuntimeError(f"figures {section}: printed rows differ")
        if len(card) != len(gold["sweeps"]):
            raise RuntimeError(f"figures {section}: {len(card)} card "
                               f"sweeps, golden {len(gold['sweeps'])}")
        for i, ((sp, r, _), w) in enumerate(zip(card, gold["sweeps"])):
            same_numbers(sweep_json(sp, r), w, f"{section}.sweeps[{i}]")
        # the other executor (Fig. 11's plain pass on the CPU)
        golden_cells = {n: c for w in gold["sweeps"]
                        for n, c in w["cells"].items()}
        plain = [(sp, r, dt) for sp, r, dt in runs if r.device != "cuda"]
        for _, r, _ in plain:
            for n in r.names:
                same_numbers(cell_json(r[n]), golden_cells[n],
                             f"{section} plain {n}")
        if "extra" in gold:
            emitted = json.loads(pathlib.Path(
                os.environ["BENCH_JSON"]).read_text())[section]
            same_numbers({k: v for k, v in emitted.items()
                          if k not in NOT_EXTRA},
                         {k: v for k, v in gold["extra"].items()
                          if k not in NOT_EXTRA}, f"{section}.extra")
        # each launch timed alone (CUDA events), its result the main's;
        # us per cycle of each sweep's slowest cell (chunks it ran)
        timing = []
        for sp, r, _ in card:
            ms, again = timed_groups(sp)
            same_sweep(again, r, f"{section} timed")
            ran = max(int(r[n]["chunks_run"]) * ch
                      for n, ch in zip(r.names, r.chunks))
            timing.append({"window": sp.core.window, "launch_ms": ms,
                           "slowest_cycles_run": ran,
                           "us_per_cycle_run": sum(ms) * 1e3 / ran})
        kernel_ms = sum(sum(t["launch_ms"]) for t in timing)
        cells = sum(len(r.names) for _, r, _ in card)
        sweep_s = sum(dt for _, _, dt in card)
        return {"cells": cells, "launches": launches,
                "shape_groups": groups, "wall_s": wall, "sweep_s": sweep_s,
                "kernel_ms": kernel_ms, "timing": timing,
                "cells_per_s": cells / sweep_s if card else None,
                "plain_cells": sum(len(r.names) for _, r, _ in plain),
                "plain_s": sum(dt for _, _, dt in plain),
                # the plain pass's simulated cycles: its cells' makespans
                "plain_cycles": sum(
                    round(float(r[c.name]["makespan_ns"]) / c.stack.unit_ns)
                    for sp, r, _ in plain for c in sp.cells),
                "n_req": [w["n_req"] for w in gold["sweeps"]]}

    @phase("figures")
    def figures():
        gold = json.loads(GOLDEN_FIGS.read_text())
        saved = {k: os.environ.pop(k, None)
                 for k in ("SMLA_SMOKE", "BENCH_JSON")}
        per = {}
        try:
            with tempfile.TemporaryDirectory() as tmp:
                for section in FIGURES:
                    os.environ["BENCH_JSON"] = os.path.join(
                        tmp, f"{section}.json")
                    st = per[section] = run_figure(section, gold[section])
                    rate = (f"{st['cells_per_s']:.1f} cells/s"
                            if st["cells"] else "no cells")
                    print(f"[figures] {section}: {st['cells']} cells, "
                          f"{st['launches']} launch(es) ({st['shape_groups']}"
                          f" shape groups), wall {st['wall_s']:.3f} s "
                          f"(sweeps {st['sweep_s']:.3f} s), kernel "
                          f"{st['kernel_ms']:.3f} ms, {rate} ({smi})",
                          flush=True)
        finally:
            for k, v in saved.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
        tot = {k: sum(st[k] for st in per.values())
               for k in ("cells", "launches", "kernel_ms", "wall_s",
                         "sweep_s", "plain_cells", "plain_s")}
        out = {"per_figure": per, **tot, "card": smi}
        print(json.dumps({"figures": out}), flush=True)
        return out, (f"{len(per)} tables and figures equal the reference's "
                     f"full-size run: {tot['cells']} cells on the kernel in "
                     f"{tot['launches']} launches, kernel "
                     f"{tot['kernel_ms']:.3f} ms, sweeps "
                     f"{tot['sweep_s']:.3f} s, plain pass "
                     f"{tot['plain_cells']} cell(s) in {tot['plain_s']:.2f} "
                     f"s on the host ({smi})")

    def poisoned(fail_on):
        """The kernel's wrapper, except that its `fail_on`-th call raises
        a non-transient error before launching (a failed launch); the
        plain version counted alongside, which must never run."""
        calls, plain, real_plain = [], [], engine._sim_core

        def launch(*a, **kw):
            calls.append(1)
            if len(calls) == fail_on:
                raise ValueError("injected failure of this shape group's "
                                 "launch")
            return kern(*a, **kw)

        def plain_counted(*a, **kw):
            plain.append(1)
            return real_plain(*a, **kw)
        return launch, plain, plain_counted

    def run_poisoned(spec, launch, plain_counted):
        """`run_sweep`'s card path (`sweep._run` with the kernel's
        launcher) with `launch` as the launcher, the plain version counted
        meanwhile."""
        real_plain = engine._sim_core
        engine._sim_core = plain_counted
        try:
            return sweep._run(spec, launch)
        finally:
            engine._sim_core = real_plain

    def resilience(gold12):
        """Journal, resume and on_error="record" on the card, on Fig. 12's
        full-size grid (90 cells, three shape groups in one sweep)."""
        from repro_torch.benchmarks import paper_fig12
        spec, _ = paper_fig12.grid(gold12["extra"]["n_mixes"],
                                   gold12["sweeps"][0]["n_req"])
        want = gold12["sweeps"][0]
        cells = sweep._sweep_cells(spec)
        plan = sweep._plan(spec, spec.options, cells, "cuda")
        groups = sweep._units(plan, per_group=True)
        if len(groups) != 3 or spec.options.horizon != want["horizon"]:
            raise RuntimeError("sweep_scale: Fig. 12's grid is not the "
                               "golden's three shape groups")
        second = [list(dict.fromkeys(b.group[j].name for j in b.positions))
                  for b in groups[1]]
        st, t_all = {"cells": len(cells)}, time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            jd = os.path.join(tmp, "journal")
            spec_j = dataclasses.replace(spec, journal=jd)
            launch, plain, plain_counted = poisoned(2)
            kern.launches = 0
            try:
                run_poisoned(spec_j, launch, plain_counted)
            except ValueError as exc:
                if "injected failure" not in str(exc):
                    raise
            else:
                raise RuntimeError("sweep_scale: the poisoned sweep did "
                                   "not raise")
            journaled = sorted(os.listdir(jd))
            first = sweep._plan(spec_j, spec.options, cells, "cuda")
            first = sorted(b.jkey + ".npz" for b in first
                           if b.group is first[0].group)
            if journaled != first or kern.launches != 1 or plain:
                raise RuntimeError(
                    f"sweep_scale: killed run journaled {len(journaled)} "
                    f"files (want the first group's {len(first)}), "
                    f"{kern.launches} launches, {len(plain)} plain runs")
            st["journaled_buckets"] = len(journaled)
            kern.launches = 0
            t0 = time.perf_counter()
            resumed = sweep.run_sweep(spec_j)
            torch.cuda.synchronize()
            st["resume_s"] = time.perf_counter() - t0
            st["resume_launches"] = kern.launches
            if kern.launches != 2 or resumed.dispatches != 2:
                raise RuntimeError(f"sweep_scale: the resume launched "
                                   f"{kern.launches} times (want 2)")
            same_numbers(sweep_json(spec, resumed), want,
                         "sweep_scale resumed fig12")
        launch, plain, plain_counted = poisoned(2)
        kern.launches = 0
        rec = run_poisoned(dataclasses.replace(spec, on_error="record"),
                           launch, plain_counted)
        failed = [fb["cells"] for fb in rec.failed_buckets]
        lost = {n for names in second for n in names}
        if (failed != second or kern.launches != 2 or plain
                or set(rec.names) != {c.name for c in cells} - lost
                or any(fb["attempts"] != 1 for fb in rec.failed_buckets)):
            raise RuntimeError(
                f"sweep_scale: on_error='record' recorded {failed} "
                f"(want the second group's {len(second)} buckets), "
                f"{kern.launches} launches, {len(plain)} plain runs")
        for name in rec.names:
            same_numbers(cell_json(rec[name]), want["cells"][name],
                         f"sweep_scale record {name}")
        st.update(recorded_buckets=len(failed), recorded_cells=len(lost),
                  record_launches=kern.launches)
        kern.launches = 0
        by_mode = {}
        for streaming in (False, True):
            t0 = time.perf_counter()
            res = sweep.run_sweep(dataclasses.replace(spec,
                                                      streaming=streaming))
            by_mode[streaming] = (res, time.perf_counter() - t0)
            same_numbers(sweep_json(spec, res), want,
                         f"sweep_scale fig12 streaming={streaming}")
        same_sweep(by_mode[False][0], by_mode[True][0],
                   "sweep_scale sync vs streaming")
        if kern.launches != 6:
            raise RuntimeError(f"sweep_scale: sync + streaming launched "
                               f"{kern.launches} times (want 3 + 3)")
        st.update(sync_s=by_mode[False][1], streaming_s=by_mode[True][1],
                  launches=1 + st["resume_launches"] + st["record_launches"]
                  + kern.launches, wall_s=time.perf_counter() - t_all)
        return st

    def scale_figure(gold):
        """`paper_fig_scale.main()` at full size on the card (fresh child
        processes), held against the golden's sizes and prune child, and
        the early-exit gate's fig_scale section on its record."""
        from repro_torch.benchmarks import assert_early_exit, paper_fig_scale
        with tempfile.TemporaryDirectory() as tmp:
            bench = os.path.join(tmp, "fig_scale.json")
            os.environ["BENCH_JSON"] = bench
            t0 = time.perf_counter()
            if paper_fig_scale.main(["--device", "cuda"]) != 0:
                raise RuntimeError("sweep_scale: paper_fig_scale failed")
            wall = time.perf_counter() - t0
            rec = json.loads(pathlib.Path(bench).read_text())["fig_scale"]
        for row in rec["rows"]:
            g = gold["sizes"][str(row["k"])]
            same_numbers({k: row[k] for k in ("n_cells", "n_buckets",
                                              "names", "bandwidth_gbps",
                                              "checksum_bandwidth")},
                         {k: g[k] for k in ("n_cells", "n_buckets", "names",
                                            "bandwidth_gbps",
                                            "checksum_bandwidth")},
                         f"sweep_scale fig_scale k={row['k']}")
            for mode in ("sync", "stream_cold", "stream_warm"):
                if row[mode]["launches"] != 1:
                    raise RuntimeError(f"sweep_scale: {mode} k={row['k']} "
                                       f"launched {row[mode]['launches']} "
                                       f"times (want 1)")
        pr, gp = rec["prune"], gold["prune"]
        same_numbers({k: pr[k] for k in ("n_cells", "n_promoted",
                                         "n_pruned", "promoted")},
                     {k: gp[k] for k in ("n_cells", "n_promoted",
                                         "n_pruned", "promoted")},
                     "sweep_scale prune")
        same_numbers({k: pr[k] for k in gp["prune_work"]}, gp["prune_work"],
                     "sweep_scale prune_work")
        if pr["launches"] != 2:
            raise RuntimeError(f"sweep_scale: prune child launched "
                               f"{pr['launches']} times (want 2 sub-sweeps)")
        msg = assert_early_exit.check_fig_scale({"fig_scale": rec})
        if msg:
            raise RuntimeError(f"sweep_scale: {msg}")
        launches = pr["launches"] + sum(
            row[m]["launches"] for row in rec["rows"]
            for m in ("sync", "stream_cold", "stream_warm"))
        return {"wall_s": wall, "launches": launches,
                "ratio_best": rec["ratio_best"],
                "saved_frac": pr["saved_frac"], "prune_wall_s": pr["wall_s"],
                "prune_build_s": pr["build_s"],
                "rows": [{"k": r["k"], "n_cells": r["n_cells"],
                          "n_buckets": r["n_buckets"], "ratio": r["ratio"],
                          **{m: {k: r[m][k] for k in (
                              "cells_per_s", "buckets_per_s", "build_s",
                              "wall_s", "launches")}
                             for m in ("sync", "stream_cold",
                                       "stream_warm")}}
                         for r in rec["rows"]]}

    @phase("sweep_scale")
    def sweep_scale():
        gold = json.loads(GOLDEN_FIGS.read_text())
        saved = {k: os.environ.pop(k, None)
                 for k in ("SMLA_SMOKE", "BENCH_JSON")}
        try:
            res = resilience(gold["fig12"])
            print(f"[sweep_scale] fig12 on the card: killed at the second "
                  f"group's launch with {res['journaled_buckets']} buckets "
                  f"journaled, resumed in {res['resume_launches']} launches "
                  f"({res['resume_s']:.3f} s) equal to the golden; "
                  f"on_error='record' isolated {res['recorded_buckets']} "
                  f"buckets ({res['recorded_cells']} cells), the other "
                  f"{res['cells'] - res['recorded_cells']} equal; sync "
                  f"{res['sync_s']:.3f} s == streaming "
                  f"{res['streaming_s']:.3f} s ({smi})", flush=True)
            scale = scale_figure(gold["fig_scale"])
        finally:
            for k, v in saved.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
        for r in scale["rows"]:
            for m in ("sync", "stream_cold", "stream_warm"):
                x = r[m]
                print(f"[sweep_scale] fig_scale {r['n_cells']} cells "
                      f"{m}: {x['cells_per_s']:.1f} cells/s, "
                      f"{x['buckets_per_s']:.2f} buckets/s, nvcc "
                      f"{x['build_s']:.2f} s, wall {x['wall_s']:.3f} s "
                      f"({smi})", flush=True)
        out = {"resilience": res, "fig_scale": scale,
               "launches": res["launches"] + scale["launches"], "card": smi}
        print(json.dumps({"sweep_scale": out}), flush=True)
        return out, (f"journal, resume and record on Fig. 12's "
                     f"{res['cells']} cells equal the golden; fig_scale "
                     f"at full size equal the golden, best ratio "
                     f"{scale['ratio_best']:.2f}x, prune saved "
                     f"{scale['saved_frac']:.0%} of 2e4 cells' work in "
                     f"{scale['prune_wall_s']:.2f} s; "
                     f"{out['launches']} launches ({smi})")

    def step_profile(step_fn, state, batch):
        """One train step under torch.profiler: its wall time (the
        profiler slows the host), the device's busy time in it (device
        events only: kernels, copies, fills) and the events taking most."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            float(m["loss"])
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = device_events(prof)
        busy = sum(ms for _, ms in events)
        return {"profiled_wall_ms": wall_ms,
                "device_busy_ms": busy if busy else "not measured",
                "top_device_events_ms": [(k[:80], ms)
                                         for k, ms in events[:10]]}

    @phase("train")
    def train():
        cfg = get_config(TRAIN_ARCH)
        pcfg = launch_train.PCFG
        data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
        torch.cuda.reset_peak_memory_stats(dev)
        state = init_state(0, cfg, device=dev)
        step_fn = make_train_step(cfg, pcfg, total=TRAIN_STEPS)
        per_step = []

        def counted(st, batch):
            """The step, with the kernel calls it made recorded."""
            f0 = fa_kernel.flash_attention_fwd.launches
            b0 = fa_kernel.flash_attention_bwd.launches
            out = step_fn(st, batch)
            per_step.append((fa_kernel.flash_attention_fwd.launches - f0,
                             fa_kernel.flash_attention_bwd.launches - b0))
            return out

        torch.cuda.synchronize()
        fa_kernel.flash_attention_fwd.launches = 0
        fa_kernel.flash_attention_bwd.launches = 0
        t0 = time.perf_counter()
        state, hist = train_loop.train(
            state, counted, data, train_loop.LoopConfig(
                total_steps=TRAIN_STEPS, log_every=1),
            log=lambda line: print(f"  {line}", flush=True))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash": fa_kernel.flash_attention_fwd.launches,
                    "flash_bwd": fa_kernel.flash_attention_bwd.launches}
        # per step: the forward kernel once per layer and once more in
        # the layer's recompute (remat "full"), the backward once per layer
        want_step = (2 * cfg.n_layers, cfg.n_layers)
        want = {"flash": TRAIN_STEPS * want_step[0],
                "flash_bwd": TRAIN_STEPS * want_step[1]}
        if launches != want or any(c != want_step for c in per_step):
            raise RuntimeError(f"train: kernel launches {launches} (per "
                               f"step {per_step}), want {want}")
        losses = hist["losses"]
        if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
            raise RuntimeError(f"train: losses {losses}")
        step_ms = sorted(hist["step_s"][2:])
        med_ms = 1e3 * (step_ms[1] + step_ms[2]) / 2   # median of steps 3-6
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        prof = step_profile(counted, state, data.batch(TRAIN_STEPS))
        busy = prof["device_busy_ms"]
        prof["device_busy_share"] = (busy / med_ms if busy != "not measured"
                                     else busy)

        # the same weights and batch, forward only: the bf16 loss of the
        # kernel path against its plain versions, and the bf16 noise floor
        # (the reference's two plain paths, chunked vs naive)
        batch0 = {k: torch.from_numpy(v).to(dev)
                  for k, v in data.batch(0).items()}
        model = get_model(cfg)

        @contextlib.contextmanager
        def plain_kernels():
            """The kernels' plain versions in their place, under the same
            autograd Function."""
            saved = (fa_kernel.flash_attention_fwd,
                     fa_kernel.flash_attention_bwd)
            fa_kernel.flash_attention_fwd = flash_plain
            fa_kernel.flash_attention_bwd = flash_bwd_plain
            try:
                yield
            finally:
                (fa_kernel.flash_attention_fwd,
                 fa_kernel.flash_attention_bwd) = saved

        def loss_of(rcfg, impl="pallas", plain=False):
            pc = dataclasses.replace(pcfg, attn_impl=impl)
            with (plain_kernels() if plain else contextlib.nullcontext()), \
                    torch.no_grad():
                h, _ = model.forward(state.params, batch0, rcfg, pc)
                return float(chunked_lm_loss(state.params, h,
                                             batch0["labels"], rcfg,
                                             chunk=pc.logit_chunk))
        l16 = {"kernel": loss_of(cfg), "plain": loss_of(cfg, plain=True),
               "naive": loss_of(cfg, "naive"),
               "chunked": loss_of(cfg, "chunked")}
        floor16 = abs(l16["chunked"] - l16["naive"])
        tol16 = max(TRAIN_LOSS_TOL_BF16, 1.5 * floor16)
        gap16 = abs(l16["kernel"] - l16["plain"])

        # float32 replay at full width: one step's loss and every gradient
        # leaf with the kernels against the same with their plain versions
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        grad32 = make_grad_fn(cfg32, pcfg)
        (lk, _), gk = grad32(state.params, batch0)
        with plain_kernels():
            (lp, _), gp = grad32(state.params, batch0)
        loss_err32 = abs(float(lk) - float(lp)) / abs(float(lp))
        flat_p = cm.flatten_paths(gp)
        grad_err32 = {name: rel_err(g, flat_p[name])
                      for name, g in cm.flatten_paths(gk).items()}
        worst32 = max(grad_err32.values())
        del gk, gp, flat_p
        replay = {"bf16_losses": l16, "bf16_gap": gap16,
                  "bf16_floor_chunked_vs_naive": floor16,
                  "bf16_tolerance": tol16, "f32_loss_kernel": float(lk),
                  "f32_loss_plain": float(lp), "f32_loss_rel_err": loss_err32,
                  "f32_grad_rel_err_max": worst32,
                  "f32_grad_rel_err": grad_err32}
        print(json.dumps({"train_replay": replay}), flush=True)
        if not (gap16 <= tol16 and loss_err32 <= TRAIN_LOSS_TOL_F32
                and worst32 <= TRAIN_GRAD_TOL_F32):
            raise RuntimeError(
                f"train: kernel path vs plain versions: bf16 loss gap "
                f"{gap16} (tolerance {tol16}), float32 loss {loss_err32} "
                f"(tolerance {TRAIN_LOSS_TOL_F32}), float32 grads {worst32} "
                f"(tolerance {TRAIN_GRAD_TOL_F32})")
        del state

        # resume: 2 layers at full width; save after step 2, restore, take
        # step 3 through the loop: the uninterrupted run's loss
        rcfg = dataclasses.replace(cfg, n_layers=RESUME_LAYERS)
        rstep = make_train_step(rcfg, pcfg, total=TRAIN_STEPS)
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            rstate, rhist = train_loop.train(
                init_state(1, rcfg, device=dev), rstep, data,
                train_loop.LoopConfig(total_steps=3, ckpt_dir=d,
                                      ckpt_every=2, log_every=100))
            restored = ckpt.restore(rstate, d, step=2)
            _, rhist2 = train_loop.train(
                restored, rstep, data, train_loop.LoopConfig(total_steps=3,
                                                             log_every=100))
        resume_err = abs(rhist2["losses"][0] - rhist["losses"][2])
        if not resume_err <= 1e-6:
            raise RuntimeError(f"train: resumed loss {rhist2['losses'][0]} "
                               f"vs {rhist['losses'][2]}")

        st = {"arch": TRAIN_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
              "steps": TRAIN_STEPS, "losses": losses,
              "step_ms": [1e3 * x for x in hist["step_s"]],
              "step_ms_median_3_6": med_ms,
              "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med_ms * 1e3,
              "wall_s": wall, "peak_memory_gb": peak_gb,
              "launches": launches, "launches_per_step": want_step,
              "profile": prof, "replay_f32_grad_rel_err": worst32,
              "replay_f32_loss_rel_err": loss_err32, "bf16_loss_gap": gap16,
              "resume_loss_err": resume_err, "card": smi}
        print(json.dumps({"train": st}), flush=True)
        return st, (
            f"{TRAIN_ARCH} B{TRAIN_BATCH} x {TRAIN_SEQ}: step "
            f"{med_ms:.1f} ms, {st['tokens_per_s']:.0f} tok/s, peak "
            f"{peak_gb:.1f} GB ({smi}); launches {launches}; losses "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}; float32 replay grads "
            f"{worst32:.2e}, loss {loss_err32:.2e}; bf16 loss gap {gap16:.5f}"
            f" (floor {floor16:.5f}); resume exact to {resume_err}")

    # ------------------------------------------------------------------
    # the paper's datapath kernel (smla_pipe) and RWKV-6's (wkv6)
    # ------------------------------------------------------------------
    pipe_err = {"cascaded": 0.0, "dedicated": 0.0}

    def pipe_check(got, want, what, kind):
        """float32 (M, N) within PIPE_TOL of max |want|."""
        tol = PIPE_TOL * float(want.abs().max())
        err = max_abs(got, want)
        if got.dtype != f32 or got.shape != want.shape or not err <= tol:
            raise RuntimeError(f"{what}: {got.dtype}{tuple(got.shape)}, max "
                               f"abs error {err} > {tol}")
        pipe_err[kind] = max(pipe_err[kind], err)

    def pipe_bits(got, want, what):
        """float32 tensors equal bit for bit."""
        if got.shape != want.shape or not torch.equal(
                got.view(torch.int32), want.view(torch.int32)):
            raise RuntimeError(f"{what}: not bit-identical to its plain "
                               f"version")

    def pipe_work(m, k, n):
        """(bytes, FLOPs) x (M, K) @ w (K, N) must move and do in float32:
        x and w read once, the output written once; 2 M K N."""
        return 4 * (m * k + k * n + m * n), 2.0 * m * k * n

    def bytes_bound(n_bytes):
        return {"bound_ms": n_bytes / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
                "bytes": n_bytes}

    @phase("pipe_parity")
    def pipe_parity():
        gen = torch.Generator(device=dev).manual_seed(2)
        n = 0
        for m, k, nn, l in PIPE_GRID + PIPE_RAGGED:
            for dt in (f32, bf16):
                x = randn(gen, (m, k), dt)
                w = randn(gen, (l, k // l, nn), dt)
                want = pipe_ref.matmul_striped(x, w)
                what = f"smla_pipe ({m},{k},{nn},{l}) {dt}"
                pipe_bits(pipe_kernel.stage_tf32(x, w),
                          pipe_ref.stage_tf32(x, w), what + " staging")
                cas = pipe_kernel.matmul_cascaded(x, w)
                ded = pipe_kernel.matmul_dedicated(x, w)
                pipe_check(cas, pipe_ref.cascaded(x, w),
                           what + " cascaded vs plain", "cascaded")
                pipe_check(ded, pipe_ref.dedicated(x, w),
                           what + " dedicated vs plain", "dedicated")
                pipe_check(cas, want, what + " cascaded vs matmul_striped",
                           "cascaded")
                pipe_check(ded, want, what + " dedicated vs matmul_striped",
                           "dedicated")
                n += 1
        # the striping order: layer 0's stripe first (tests/test_kernels.py
        # :163-171), to rtol 1e-6
        x = torch.eye(8, 32, device=dev)
        w = torch.arange(4 * 8 * 8, dtype=f32, device=dev).reshape(4, 8, 8)
        want = pipe_ref.matmul_striped(x, w)
        for got in (pipe_kernel.matmul_cascaded(x, w),
                    pipe_kernel.matmul_dedicated(x, w)):
            if not torch.allclose(got, want, rtol=1e-6, atol=0.0):
                raise RuntimeError("smla_pipe: striping order")
        n += 1

        # the main path: the benchmark at its two shapes, launch counters
        # reset just before and read just after
        counted = {"cascaded": pipe_kernel.matmul_cascaded,
                   "dedicated": pipe_kernel.matmul_dedicated,
                   "stage": pipe_kernel.stage_tf32,
                   "sum": pipe_kernel.sum_partials}
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.launches = 0
        rows = {name: {r["impl"]: r for r in smla_pipe_bench.run(
                    *shape, device=dev)}
                for name, shape in smla_pipe_bench.SHAPES.items()}
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counted.items()}
        calls = {impl: sum(r[impl]["calls"] for r in rows.values())
                 for impl in ("cascaded", "dedicated")}
        want_l = {"cascaded": calls["cascaded"],
                  "dedicated": sum(smla_pipe_bench.SHAPES[name][3]
                                   * r["dedicated"]["calls"]
                                   for name, r in rows.items()),
                  "stage": calls["cascaded"] + calls["dedicated"],
                  "sum": calls["dedicated"]}
        if launches != want_l:
            raise RuntimeError(f"smla_pipe bench: launches {launches}, want "
                               f"{want_l}")
        for name, r in rows.items():
            for impl in ("cascaded", "dedicated"):
                tol = PIPE_TOL * r[impl]["ref_max_abs"]
                if not r[impl]["max_abs_err"] <= tol:
                    raise RuntimeError(f"smla_pipe bench {name} {impl}: "
                                       f"error {r[impl]['max_abs_err']} > "
                                       f"{tol}")

        # the realistic shape: kernels against their plain versions, and
        # the plain versions' times (the matmuls' and torch.matmul's are
        # the bench's)
        m, k, nn, l = smla_pipe_bench.SHAPES["realistic"]
        x = randn(gen, (m, k), f32)
        w = randn(gen, (l, k // l, nn), f32)
        what = f"smla_pipe realistic ({m},{k},{nn},{l})"
        pipe_check(pipe_kernel.matmul_cascaded(x, w), pipe_ref.cascaded(x, w),
                   what + " cascaded", "cascaded")
        pipe_check(pipe_kernel.matmul_dedicated(x, w),
                   pipe_ref.dedicated(x, w), what + " dedicated", "dedicated")
        planes = pipe_kernel.stage_tf32(x, w)
        pipe_bits(planes, pipe_ref.stage_tf32(x, w), what + " staging")
        parts = randn(gen, (l, m, nn), f32)
        pipe_bits(pipe_kernel.sum_partials(parts),
                  pipe_ref.sum_partials(parts), what + " sum")
        n += 3
        n_bytes, flops = pipe_work(m, k, nn)
        t_bytes = n_bytes / PEAK_BYTES_S * 1e3
        t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
        real = rows["realistic"]
        out = {}
        for impl, plain in (("cascaded", pipe_ref.cascaded),
                            ("dedicated", pipe_ref.dedicated)):
            out[impl] = {
                "ms": real[impl]["ms"],
                "plain_ms": cuda_ms(lambda: plain(x, w), reps=3,
                                    calls=2)[0],
                "library_ms": real["torch_matmul"]["ms"],
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": ("bytes" if t_bytes >= t_ops
                             else "operations (3xTF32)"),
                "fp32_fma_bound_ms": flops / PEAK_OPS_S * 1e3,
                "tf32_bound_ms": flops / PEAK_TF32_FLOPS * 1e3,
                "bf16_bound_ms": flops / PEAK_BF16_FLOPS * 1e3,
                "launches": launches[impl], "flop": flops,
                "bytes": n_bytes}
        # the staging reads x and w and writes the planes; the sum reads L
        # partials and writes one
        out["stage"] = {
            "ms": cuda_ms(lambda: pipe_kernel.stage_tf32(x, w), reps=5,
                          calls=10)[0],
            "plain_ms": cuda_ms(lambda: pipe_ref.stage_tf32(x, w), reps=3,
                                calls=2)[0],
            "library_ms": None, "launches": launches["stage"],
            **bytes_bound(4 * (m * k + k * nn) + 4 * planes.numel())}
        out["sum"] = {
            "ms": cuda_ms(lambda: pipe_kernel.sum_partials(parts), reps=5,
                          calls=10)[0],
            "plain_ms": cuda_ms(lambda: pipe_ref.sum_partials(parts),
                                reps=3, calls=2)[0],
            "library_ms": cuda_ms(lambda: parts.sum(0), reps=5,
                                  calls=10)[0],
            "launches": launches["sum"],
            **bytes_bound(4 * (l + 1) * m * nn)}
        st = {"kernels": out, "bench": rows, "card": smi}
        print(json.dumps({"pipe_parity": st}), flush=True)
        return out, (f"{n} kernel checks passed (max abs err cascaded "
                     f"{pipe_err['cascaded']}, dedicated "
                     f"{pipe_err['dedicated']}; staging and sum "
                     f"bit-identical); at ({m},{k},{nn},{l}) "
                     f"cascaded {out['cascaded']['ms']:.3f} ms, dedicated "
                     f"{out['dedicated']['ms']:.3f} ms, torch.matmul "
                     f"{out['cascaded']['library_ms']:.3f} ms, bound "
                     f"{out['cascaded']['bound_ms']:.3f} ms (3xTF32); "
                     f"staging {out['stage']['ms']:.3f} ms, sum "
                     f"{out['sum']['ms']:.3f} ms; launches {launches}")

    wkv_err = {"max_abs": 0.0, "max_rel": 0.0}

    def wkv_inputs(gen, b, h, s, hd, dt=f32, shift=-2.0):
        """r, k, v (B,H,S,hd) in `dt`; logw = -exp(n + shift) (the
        reference test's decays at -2) and u = 0.4 + 0.2 n, float32."""
        r, k, v = (randn(gen, (b, h, s, hd), dt) for _ in range(3))
        logw = -torch.exp(randn(gen, (b, h, s, hd), f32) + shift)
        return r, k, v, logw, 0.4 + 0.2 * randn(gen, (h, hd), f32)

    def wkv_check(got, want, tol, what, record=True):
        """Raise unless max |got - want| <= tol x max |want|; return that
        fraction, and keep it in `wkv_err` when `record`."""
        scale = float(want.float().abs().max())
        err = max_abs(got, want)
        if got.shape != want.shape or not err <= tol * scale:
            raise RuntimeError(f"{what}: {tuple(got.shape)}, max abs error "
                               f"{err} > {tol} x {scale}")
        if record:
            wkv_err["max_abs"] = max(wkv_err["max_abs"], err)
            wkv_err["max_rel"] = max(wkv_err["max_rel"], err / scale)
        return err / scale

    def wkv_work(b, h, s, hd, cs, itemsize=4):
        """(bytes, float32 FLOP of the tensor-core products, other float32
        operations, exps) WKV6 must move and do from a zero state, counted
        from `csrc/wkv6.cu`'s arithmetic: r, k, v and y (`itemsize` bytes
        each), logw and u read or written once, and the float32 state;
        per chunk of nsb = cs / 16 sub-blocks, the products (the
        off-diagonal score blocks, scores v over each row block's columns
        j < its end, the state's increment and the inter-chunk term, 2
        FLOP a multiply-add), in each diagonal block per channel the six
        4 x 4 micro-tiles below its diagonal (7 exps, 7 subs, 7 scaling
        muls and 16 multiply-adds each) and the four on it (6 pairs of
        sub, exp, two muls and an add each), the state step (2 hd^2); per
        element the 16-row sum, r's and k's scalings (3) and their exps
        (2), the bonus (3), y's sums (3) and the operands' factors (2);
        per chunk and channel the factors' exps (2 nsb + pairs + 1)."""
        n_el = b * h * s * hd
        chunks = b * h * (s // cs)
        nsb = cs // 16
        pairs = nsb * (nsb - 1) // 2
        n_bytes = ((4 * itemsize + 4) * n_el + 4 * h * hd
                   + 4 * b * h * hd * hd)
        macs = (pairs * 256 * hd + 256 * hd * nsb * (nsb + 1) // 2
                + 2 * cs * hd * hd)
        tc_flop = 2.0 * macs * chunks
        diag_ops = nsb * hd * (6 * (7 + 7 + 7 + 2 * 16) + 4 * 6 * 5)
        ops = chunks * (diag_ops + 2 * hd * hd) + 12 * n_el
        exps = (chunks * nsb * hd * (6 * 7 + 4 * 6)
                + chunks * (2 * nsb + pairs + 1) * hd + 2 * n_el)
        return n_bytes, tc_flop, float(ops), float(exps)

    def wkv_bound(b, h, s, hd, cs, itemsize=4):
        """The bound of `wkv_work`: the bytes at the HBM rate; the
        products at three TF32 passes on the tensor cores, the other
        operations on the FMA pipe and the exps on the SFUs, each pipe on
        its own."""
        n_bytes, tc_flop, ops, exps = wkv_work(b, h, s, hd, cs, itemsize)
        ms = {"bytes_ms": n_bytes / PEAK_BYTES_S * 1e3,
              "tf32_ms": 3 * tc_flop / PEAK_TF32_FLOPS * 1e3,
              "fma_ms": ops / PEAK_OPS_S * 1e3,
              "sfu_ms": exps / PEAK_SFU_S * 1e3}
        t_ops = max(ms["tf32_ms"], ms["fma_ms"], ms["sfu_ms"])
        return {"bound_ms": max(ms["bytes_ms"], t_ops),
                "bound_by": ("bytes" if ms["bytes_ms"] >= t_ops
                             else "operations"),
                "bytes": n_bytes, "tc_flop": tc_flop, "flop": ops,
                "exp": exps, **ms}

    @phase("wkv_parity")
    def wkv_parity():
        gen = torch.Generator(device=dev).manual_seed(3)
        n = 0
        for (b, h, s, hd), chunks in WKV_SHAPES:
            for chunk in chunks:
                r, k, v, logw, u = wkv_inputs(gen, b, h, s, hd)
                y, st = wkv_kernel.wkv6(r, k, v, logw, u, chunk=chunk)
                py, pst = wkv_ops.plain(r, k, v, logw, u, chunk)
                sst, sy = wkv_ref.wkv(r, k, v, logw, u, torch.zeros(
                    (b, h, hd, hd), device=dev))
                what = f"wkv6 {(b, h, s, hd)} chunk {chunk}"
                for name, got, want in (("y vs plain", y, py),
                                        ("state vs plain", st, pst),
                                        ("y vs sequential", y, sy),
                                        ("state vs sequential", st, sst)):
                    wkv_check(got, want, WKV_TOL, f"{what} {name}")
                n += 1
        # strong decays: finite, and within WKV_TOL of the sequential
        # oracle and of a float64 witness (the sequential path in
        # float64).  The plain version's exponents are differences of
        # sums of hundreds here, so it is itself off the witness by more
        # than WKV_TOL (on the CPU 1.4e-5-3.5e-5 of max |y| at chunk 64):
        # against it the kernel is held to WKV_TOL plus that distance,
        # which is what WKV_TOL of the witness implies
        strong = []
        for (b, h, s, hd), chunk in WKV_STRONG:
            r, k, v, logw, u = wkv_inputs(gen, b, h, s, hd,
                                          shift=WKV_STRONG_SHIFT)
            y, st = wkv_kernel.wkv6(r, k, v, logw, u, chunk=chunk)
            what = f"wkv6 strong decays {(b, h, s, hd)} chunk {chunk}"
            if not (torch.isfinite(y).all() and torch.isfinite(st).all()):
                raise RuntimeError(f"{what}: inf or NaN")
            py, pst = wkv_ops.plain(r, k, v, logw, u, chunk)
            sst, sy = wkv_ref.wkv(r, k, v, logw, u, torch.zeros(
                (b, h, hd, hd), device=dev))
            wst, wy = wkv_ref.wkv(
                *(a.double() for a in (r, k, v, logw, u)),
                torch.zeros((b, h, hd, hd), device=dev, dtype=torch.float64))
            row = {"shape": [b, h, s, hd], "chunk": chunk,
                   "mean_chunk_logw_sum": float(
                       logw.unflatten(2, (-1, chunk)).sum(3).mean())}
            for name, got, plain, seq, witness in (("y", y, py, sy, wy),
                                                   ("state", st, pst, sst,
                                                    wst)):
                wkv_check(got, seq, WKV_TOL, f"{what} {name} vs sequential")
                row[f"{name}_kernel_vs_f64"] = wkv_check(
                    got, witness, WKV_TOL, f"{what} {name} vs float64")
                off = max_abs(plain, witness) / float(witness.abs().max())
                row[f"{name}_plain_vs_f64"] = off
                row[f"{name}_kernel_vs_plain"] = wkv_check(
                    got, plain, WKV_TOL + off, f"{what} {name} vs plain",
                    record=False)
            strong.append(row)
            n += 1
        del r, k, v, logw, u, y, st, py, pst, sy, sst, wy, wst
        # the training shape with bf16 r, k, v: the kernel on their
        # float32 casts against the plain version at WKV_TOL; `ops`'s y on
        # the bf16 tensors is that y rounded to bf16, its state that
        # state, exactly
        b, h, s, hd = WKV_SHAPES[-1][0]
        r, k, v, logw, u = wkv_inputs(gen, b, h, s, hd, bf16)
        f = [wkv_ops._f32(a) for a in (r, k, v, logw, u)]
        py, pst = wkv_ops.plain(*f, 64)
        y32, st32 = wkv_kernel.wkv6(*f, chunk=64)
        wkv_check(y32, py, WKV_TOL, "wkv6 bf16 inputs y")
        wkv_check(st32, pst, WKV_TOL, "wkv6 bf16 inputs state")
        y16, st16 = wkv_ops.wkv6_with_state(r, k, v, logw, u, 64)
        if (y16.dtype != bf16 or not torch.equal(st16, st32)
                or not torch.equal(y16, y32.to(bf16))):
            raise RuntimeError("wkv6: ops.wkv6_with_state on bf16 inputs")
        n += 1
        # the model's own call (`wkv6_bench.inputs`): bf16 r, k, v and
        # float32 logw as (B,H,S,hd) views of (B,S,H,hd) tensors; one call
        # of `ops` launches the kernel once and allocates y and the state
        # only; y, a view of a (B,S,H,hd) buffer, is the float32 kernel's
        # y on the same values rounded to bf16, the state equal
        if wkv6_bench.TRAINING != (b, h, s, hd, 64):
            raise RuntimeError("wkv6_bench.TRAINING is not the training "
                               "shape of WKV_SHAPES")
        r, k, v, logw, u = wkv6_bench.inputs(b, h, s, hd)
        f = [a.float().contiguous() for a in (r, k, v, logw)] + [u]
        y32, st32 = wkv_kernel.wkv6(*f, chunk=64)
        py, pst = wkv_ops.plain(*f, 64)
        wkv_check(y32, py, WKV_TOL, "wkv6 model call's values y")
        wkv_check(st32, pst, WKV_TOL, "wkv6 model call's values state")
        del py, pst
        torch.cuda.synchronize()
        launches0 = wkv_kernel.wkv6.launches
        allocs0 = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        y16, st16 = wkv_ops.wkv6_with_state(r, k, v, logw, u, 64)
        allocs = (torch.cuda.memory_stats(dev)["allocation.all.allocated"]
                  - allocs0)
        launched = wkv_kernel.wkv6.launches - launches0
        if launched != 1 or allocs != 2:
            raise RuntimeError(f"wkv6: one model call launched {launched} "
                               f"kernels and made {allocs} allocations, "
                               f"want 1 and 2 (y, state)")
        if (y16.dtype != bf16 or y16.shape != r.shape
                or not y16.transpose(1, 2).is_contiguous()
                or not torch.equal(y16, y32.to(bf16))
                or not torch.equal(st16, st32)):
            raise RuntimeError("wkv6: the model call's y is not the float32 "
                               "kernel's rounded to bf16 in (B,S,H,hd), or "
                               "its state differs")
        n += 1
        plan = wkv_kernel.plan(b, h, s, hd, 64)
        del r, k, v, logw, u, f, y32, st32, y16, st16

        # times at the training shape: float32 contiguous, and the model's
        # call on the host and the device (`wkv6_bench`), whose device
        # events per call must be the one kernel
        r, k, v, logw, u = f32_args = wkv_inputs(gen, b, h, s, hd)
        t = {"ms": cuda_ms(lambda: wkv_kernel.wkv6(*f32_args, chunk=64),
                           reps=5, calls=5)[0],
             "plain_ms": cuda_ms(lambda: wkv_ops.plain(*f32_args, 64),
                                 reps=3, calls=1)[0],
             "library_ms": None, "plan": plan}
        # (a process of its own: this one's earlier profiler windows can
        # make a new one lose device events)
        proc = subprocess.run(
            [sys.executable, str(ROOT / "src" / "repro_torch" / "benchmarks"
                                 / "wkv6_bench.py")],
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            capture_output=True, text=True, timeout=600)
        if proc.returncode:
            raise RuntimeError(f"wkv6_bench failed ({proc.returncode}):\n"
                               f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        bench = json.loads(proc.stdout.strip().splitlines()[-1])["wkv6_bench"]
        if bench["plan"] != plan:
            raise RuntimeError(f"wkv6_bench's launch {bench['plan']}, want "
                               f"{plan}")
        kernels = bench["model_call_device_kernels"]
        if bench["model_call_device_ms"] and (
                bench["model_call_device_events"] != 1
                or any("wkv6_kernel" not in name for name in kernels)):
            raise RuntimeError(f"wkv6: the model call runs "
                               f"{bench['model_call_device_events']} device "
                               f"events per call ({kernels}), want 1, the "
                               f"kernel")
        t.update({key: bench[key] for key in (
            "model_call_ms", "model_call_device_ms",
            "model_call_device_events", "model_call_device_kernels",
            "float32_ms", "float32_device_ms")})
        # the Function's backward at the training shape with bf16 r, k, v:
        # no kernel, the recompute through the chunked path; its gradients
        # for one dy must not depend on which forward ran
        xs = [a.detach().requires_grad_()
              for a in (r.bfloat16(), k.bfloat16(), v.bfloat16(), logw, u)]
        y = wkv_ops.wkv6(*xs, 64)
        dy = randn(gen, tuple(y.shape), bf16)
        t["function_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
            y, xs, dy, retain_graph=True), reps=3, calls=1)[0]
        g_kernel = torch.autograd.grad(y, xs, dy)
        saved = wkv_kernel.wkv6
        wkv_kernel.wkv6 = lambda *a, chunk: wkv_ops.plain(*a, chunk)
        try:
            g_plain = torch.autograd.grad(wkv_ops.wkv6(*xs, 64), xs, dy)
        finally:
            wkv_kernel.wkv6 = saved
        if not all(torch.equal(a, b) for a, b in zip(g_kernel, g_plain)):
            raise RuntimeError("wkv6: the Function's gradients depend on "
                               "which forward ran")
        del xs, y, dy, g_kernel, g_plain
        # the bounds of both calls (`wkv_work`): float32, and the model's
        # bf16 r, k, v and y
        t.update(wkv_bound(b, h, s, hd, 64))
        model = wkv_bound(b, h, s, hd, 64, itemsize=2)
        t.update(model_call_bound_ms=model["bound_ms"],
                 model_call_bound_by=model["bound_by"],
                 model_call_bytes=model["bytes"], strong=strong,
                 max_rel_err=wkv_err["max_rel"], card=smi)
        print(json.dumps({"wkv_parity": t}), flush=True)
        return t, (f"{n} kernel checks passed (max abs err "
                   f"{wkv_err['max_abs']}, relative {wkv_err['max_rel']}); "
                   f"{plan['blocks']} blocks ({plan['blocks_per_head']} "
                   f"chunks of each (batch, head) at once); "
                   f"{t['ms']:.4f} ms per call at "
                   f"{(b, h, s, hd)} chunk 64 float32 (plain "
                   f"{t['plain_ms']:.3f}, bound {t['bound_ms']:.4f} by "
                   f"{t['bound_by']}); the model's bf16 call "
                   f"{t['model_call_ms']:.4f} ms host, "
                   f"{t['model_call_device_ms']:.4f} ms device (bound "
                   f"{t['model_call_bound_ms']:.4f}); the Function's "
                   f"backward {t['function_bwd_ms']:.1f} ms")

    @phase("train_rwkv")
    def train_rwkv():
        cfg = dataclasses.replace(get_config(RWKV_ARCH), n_layers=RWKV_LAYERS)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        pcfg = launch_train.PCFG
        data = SyntheticLM(cfg.vocab_size, RWKV_SEQ, RWKV_BATCH, seed=0)
        batch0 = {k: torch.from_numpy(v).to(dev)
                  for k, v in data.batch(0).items()}
        state = init_state(0, cfg, device=dev)

        @contextlib.contextmanager
        def swapped(module, name, fn):
            saved = getattr(module, name)
            setattr(module, name, fn)
            try:
                yield
            finally:
                setattr(module, name, saved)

        def plain_kernel():
            """The kernel's plain version in its place, under the same
            autograd Function."""
            return swapped(wkv_kernel, "wkv6",
                           lambda *a, chunk: wkv_ops.plain(*a, chunk))

        def sequential_path():
            """The chunked path's WKV as the sequential one (time_mix's
            sequential branch: float32 r, k, v in, float32 y out)."""
            return swapped(rwkv6, "wkv_chunked",
                           lambda r, k, v, logw, u, st, chunk=0, **kw:
                           rwkv6.wkv_sequential(r.float(), k.float(),
                                                v.float(), logw, u, st))

        # float32 replay at full width, one step from the initial weights:
        # the loss of the kernel path against the same with its plain
        # version under the same Function; the gradients of both, and of
        # the sequential path, against a float64 witness: the plain and
        # the sequential path run in float64 (`float64_mode`), which must
        # agree with each other to W64_TOL
        def grads(impl="pallas", ctx=contextlib.nullcontext,
                  params=state.params):
            with ctx():
                (loss, _), g = make_grad_fn(cfg32, dataclasses.replace(
                    pcfg, attn_impl=impl))(params, batch0)
            return float(loss), cm.flatten_paths(g)

        def in_float64(ctx):
            @contextlib.contextmanager
            def both():
                with float64_mode(), ctx():
                    yield
            return both

        def leaf_errs(got, want):
            """Each leaf's max |got - want| over its max |want|, in
            float64."""
            return {name: float((got[name].double() - w).abs().max()
                                / w.abs().max().clamp_min(1e-300))
                    for name, w in want.items()}

        params64 = cm.map_tree(lambda t: t.double(), state.params)
        l64, g64 = grads(ctx=in_float64(plain_kernel), params=params64)
        l64s, g64s = grads("chunked", in_float64(sequential_path), params64)
        err64 = leaf_errs(g64s, g64)
        del g64s, params64
        lk, gk = grads()
        err_k = leaf_errs(gk, g64)
        lp, gp = grads(ctx=plain_kernel)
        err_p = leaf_errs(gp, g64)
        grad_err32 = leaf_errs(gk, gp)
        del gk
        ls, gs = grads("chunked", sequential_path)
        err_s = leaf_errs(gs, g64)
        gap32 = max(leaf_errs(gs, gp).values())
        del gs, gp, g64
        loss_err32 = abs(lk - lp) / abs(lp)
        worst64, worst_k = max(err64.values()), max(err_k.values())
        floor32 = max(*err_p.values(), *err_s.values())
        tol32 = max(TRAIN_GRAD_TOL_F32, 1.5 * floor32)

        step_fn = make_train_step(cfg, pcfg, total=RWKV_STEPS)
        per_step = []

        def counted(st, batch):
            """The step, with the kernel calls it made recorded."""
            w0 = wkv_kernel.wkv6.launches
            out = step_fn(st, batch)
            per_step.append(wkv_kernel.wkv6.launches - w0)
            return out

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        wkv_kernel.wkv6.launches = 0
        t0 = time.perf_counter()
        state, hist = train_loop.train(
            state, counted, data, train_loop.LoopConfig(
                total_steps=RWKV_STEPS, log_every=1),
            log=lambda line: print(f"  {line}", flush=True))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = wkv_kernel.wkv6.launches
        # per step: once per layer, and once more in the layer's recompute
        # (remat "full"); the backward recomputes through the chunked path
        want_step = 2 * cfg.n_layers
        if (launches != RWKV_STEPS * want_step
                or any(c != want_step for c in per_step)):
            raise RuntimeError(f"train_rwkv: wkv6 launches {launches} (per "
                               f"step {per_step}), want "
                               f"{RWKV_STEPS * want_step}")
        losses = hist["losses"]
        if len(losses) != RWKV_STEPS or not np.isfinite(losses).all():
            raise RuntimeError(f"train_rwkv: losses {losses}")
        step_ms = sorted(hist["step_s"][2:])
        med_ms = 1e3 * (step_ms[1] + step_ms[2]) / 2   # median of steps 3-6
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        prof = step_profile(counted, state, data.batch(RWKV_STEPS))
        busy = prof["device_busy_ms"]
        prof["device_busy_share"] = (busy / med_ms if busy != "not measured"
                                     else busy)

        # the trained weights, forward only: the bf16 loss of the kernel
        # path against the chunked path, and the bf16 noise floor (chunked
        # vs sequential)
        def loss_of(impl, ctx=contextlib.nullcontext):
            pc = dataclasses.replace(pcfg, attn_impl=impl)
            with ctx(), torch.no_grad():
                h, _ = rwkv6.forward(state.params, batch0, cfg, pc)
                return float(chunked_lm_loss(state.params, h,
                                             batch0["labels"], cfg,
                                             chunk=pc.logit_chunk))
        l16 = {"kernel": loss_of("pallas"), "chunked": loss_of("chunked"),
               "sequential": loss_of("chunked", sequential_path)}
        floor16 = abs(l16["chunked"] - l16["sequential"])
        tol16 = max(TRAIN_LOSS_TOL_BF16, 1.5 * floor16)
        gap16 = abs(l16["kernel"] - l16["chunked"])
        del state
        replay = {"bf16_losses": l16, "bf16_gap": gap16,
                  "bf16_floor_chunked_vs_sequential": floor16,
                  "bf16_tolerance": tol16, "f32_loss_kernel": lk,
                  "f32_loss_plain": lp, "f32_loss_sequential": ls,
                  "f64_loss_plain": l64, "f64_loss_sequential": l64s,
                  "f32_loss_rel_err": loss_err32,
                  "f64_grad_plain_vs_sequential_max": worst64,
                  "f64_grad_tolerance": W64_TOL,
                  "f32_grad_kernel_vs_f64_max": worst_k,
                  "f32_grad_plain_vs_f64_max": max(err_p.values()),
                  "f32_grad_sequential_vs_f64_max": max(err_s.values()),
                  "f32_grad_tolerance": tol32,
                  "f32_grad_kernel_vs_plain_max": max(grad_err32.values()),
                  "f32_grad_plain_vs_sequential_max": gap32,
                  "f32_grad_kernel_vs_f64": err_k,
                  "f32_grad_plain_vs_f64": err_p,
                  "f32_grad_sequential_vs_f64": err_s,
                  "f64_grad_plain_vs_sequential": err64}
        print(json.dumps({"train_rwkv_replay": replay}), flush=True)
        if not (gap16 <= tol16 and loss_err32 <= TRAIN_LOSS_TOL_F32
                and worst64 <= W64_TOL and worst_k <= tol32):
            raise RuntimeError(
                f"train_rwkv: kernel path: bf16 loss gap {gap16} to the "
                f"chunked path (tolerance {tol16}), float32 loss "
                f"{loss_err32} (tolerance {TRAIN_LOSS_TOL_F32}), float32 "
                f"grads {worst_k} from the float64 witness (tolerance "
                f"{tol32}); the witness's two paths {worst64} apart "
                f"(tolerance {W64_TOL})")
        st = {"arch": RWKV_ARCH, "n_layers": cfg.n_layers,
              "params": cfg.n_params(), "batch": RWKV_BATCH,
              "seq": RWKV_SEQ, "steps": RWKV_STEPS, "losses": losses,
              "step_ms": [1e3 * x for x in hist["step_s"]],
              "step_ms_median_3_6": med_ms,
              "tokens_per_s": RWKV_BATCH * RWKV_SEQ / med_ms * 1e3,
              "wall_s": wall, "peak_memory_gb": peak_gb,
              "launches": launches, "launches_per_step": want_step,
              "profile": prof, "replay_f32_grad_vs_f64": worst_k,
              "replay_f32_loss_rel_err": loss_err32,
              "replay_f32_grad_tolerance": tol32, "bf16_loss_gap": gap16,
              "bf16_tolerance": tol16, "card": smi}
        print(json.dumps({"train_rwkv": st}), flush=True)
        return st, (
            f"{RWKV_ARCH} ({cfg.n_layers} layers) B{RWKV_BATCH} x "
            f"{RWKV_SEQ}: step {med_ms:.1f} ms, {st['tokens_per_s']:.0f} "
            f"tok/s, peak {peak_gb:.1f} GB ({smi}); wkv6 launches "
            f"{launches}; losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
            f"float32 replay grads {worst_k:.2e} from float64 (plain and "
            f"sequential paths {floor32:.2e}; float64 paths {worst64:.1e} "
            f"apart), loss {loss_err32:.2e}; bf16 loss gap {gap16:.2e} (floor "
            f"{floor16:.2e})")

    t_start = time.perf_counter()
    smi = card()
    build()
    golden()
    parity()
    stats = grid()
    attn = attn_parity()
    cap, serve_stats = serve()
    sim_stats = serve_sim(cap)
    fig_stats = figures()
    scale_stats = sweep_scale()
    bwd = attn_bwd_parity()
    train_stats = train()
    pipe = pipe_parity()
    wkv = wkv_parity()
    rwkv_stats = train_rwkv()

    @phase("kernels")
    def kernels():
        line = {"kernels": [{
            "name": "smla_sim_kernel", "route": "cuda",
            "source": "src/repro_torch/csrc/smla_engine.cu",
            "replaces": "src/repro/core/smla/pallas_engine.py:96",
            "launches": (stats["launches"] + sim_stats["launches"]
                         + fig_stats["launches"]
                         + scale_stats["launches"]),
            "max_abs_err": worst_err[0],
            "ms": stats["compare_ms"], "plain_ms": stats["compare_plain_ms"],
            "bound_ms": stats["bound_ms"], "bound_by": stats["bound_by"],
            "library_ms": None,
            "shape": "5 cells (L4 IO models x stream.3), n_req 600, "
                     "rank axis 8",
            "grid_ms": stats["grid_kernel_ms"],
            "grid_launches": stats["launches"],
            "grid_bucketed_ms": stats["grid_bucketed_ms"],
            "grid_bucket_launches": stats["buckets"],
            "grid_one_launch_ms": stats["grid_one_launch_ms"],
            "grid_us_per_cycle": stats["us_per_cycle"],
            "grid_us_per_cycle_run": stats["us_per_cycle_run"],
            "serve_sim_launches": sim_stats["launches"],
            "serve_sim_kernel_ms": sim_stats["kernel_ms"],
            "serve_sim_bucketed_ms": sim_stats["bucketed_kernel_ms"],
            "serve_sim_us_per_cycle": sim_stats["us_per_cycle"],
            "figures_launches": fig_stats["launches"],
            "figures_cells": fig_stats["cells"],
            "figures_kernel_ms": fig_stats["kernel_ms"],
            "sweep_scale_launches": scale_stats["launches"],
            "fig_scale_ratio_best": scale_stats["fig_scale"]["ratio_best"],
            "check": "ok"}, {
            "name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_fwd_tc.cu",
            "float32_source": "src/repro_torch/csrc/flash_attention_fwd.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:82",
            "launches": serve_stats["launches"]["flash"],
            "train_launches": train_stats["launches"]["flash"],
            "max_abs_err": attn_err["flash"], **attn["flash"],
            "shape": "q (8,256,32,64), k/v (8,256,4,64) bf16, causal",
            "train_shape_ms": bwd["fwd_ms"],
            "train_shape_bound_ms": bwd["fwd_bound_ms"],
            "train_shape_library_ms": bwd["fwd_library_ms"],
            "check": "ok"}, {
            "name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd_tc.cu",
            "float32_source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:219",
            "launches": train_stats["launches"]["flash_bwd"],
            "max_abs_err": bwd_err["max_abs"],
            "max_rel_err": bwd_err["max_rel"],
            **{k: bwd[k] for k in ("ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by")},
            "shape": "q/o/do (4,2048,32,64), k/v (4,2048,4,64) bf16, causal",
            "check": "ok"}, {
            "name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:68",
            "launches": serve_stats["launches"]["decode"],
            "max_abs_err": attn_err["decode"], **attn["decode"],
            "shape": "q (8,1,32,64), caches (8,512,4,64) bf16, lengths 288",
            "check": "ok"}, {
            "name": "decode_attention_combine", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:68",
            "launches": serve_stats["launches"]["decode_combine"],
            "max_abs_err": 0.0, **attn["combine"],
            "shape": f"partials of {attn['decode']['splits']} splits of the "
                     f"decode shape, float32 -> o bf16",
            "check": "bit-identical"}, {
            "name": "smla_pipe_cascaded", "route": "cuda",
            "source": "src/repro_torch/csrc/smla_pipe.cu",
            "replaces": "src/repro/kernels/smla_pipe/kernel.py:54",
            "max_abs_err": pipe_err["cascaded"], **pipe["cascaded"],
            "shape": "x (8192,2048) @ w (4,512,5632) float32 "
                     "(smla_pipe_bench, realistic)",
            "check": "ok"}, {
            "name": "smla_pipe_dedicated", "route": "cuda",
            "source": "src/repro_torch/csrc/smla_pipe.cu",
            "replaces": "src/repro/kernels/smla_pipe/kernel.py:86",
            "max_abs_err": pipe_err["dedicated"], **pipe["dedicated"],
            "shape": "x (8192,2048) @ w (4,512,5632) float32: 4 launches + "
                     "a sum",
            "check": "ok"}, {
            "name": "smla_pipe_stage_tf32", "route": "cuda",
            "source": "src/repro_torch/csrc/smla_pipe.cu",
            "replaces": "src/repro/kernels/smla_pipe/kernel.py:71",
            "max_abs_err": 0.0, **pipe["stage"],
            "shape": "x (8192,2048), w (4,512,5632) float32 -> TF32 hi/lo "
                     "planes (one per matmul call)",
            "check": "bit-identical"}, {
            "name": "smla_pipe_sum_partials", "route": "cuda",
            "source": "src/repro_torch/csrc/smla_pipe.cu",
            "replaces": "src/repro/kernels/smla_pipe/kernel.py:97",
            "max_abs_err": 0.0, **pipe["sum"],
            "shape": "parts (4,8192,5632) float32 (one per matmul_dedicated "
                     "call)",
            "check": "bit-identical"}, {
            "name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6/kernel.py:74",
            "launches": rwkv_stats["launches"],
            "max_abs_err": wkv_err["max_abs"],
            **{k: wkv[k] for k in ("ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by", "max_rel_err",
                                   "plan", "model_call_ms",
                                   "model_call_device_ms",
                                   "model_call_bound_ms")},
            "shape": "r/k/v/logw (4,40,2048,64) float32, chunk 64; the "
                     "model call bf16 r/k/v views of (4,2048,40,64)",
            "check": "ok"}]}
        print(json.dumps(line), flush=True)
        return None, f"{len(line['kernels'])} kernels, all checks passed"

    kernels()
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
