#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of the SMLA system (``src/repro_torch``)
on one NVIDIA GPU, end to end, and check it: the cycle simulator's sweep,
the paper's tables and figures, the serving path whose captured traffic
feeds it, the training paths (the transformer, the hybrid and the
encoder-decoder families), the paper's Cascaded-IO datapath matmul and
its benchmark, RWKV-6 training, the cross-pod gradient sync of the
data-parallel train step over ranks that share the card, serving on
a ('data', 'model') mesh of the same ranks, and rwkv6-3b served on a
(1, 16) mesh of 16 ranks (the WKV state cut over its k dim).

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
             (with us per simulated cycle of the slowest cell); on the
             grid's cells of RETIME_WORKLOADS (75 of 465) the bucketed
             plan (one launch per bucket) and the cells as one launch at
             one chunk width are timed for the record, their chunks and
             metrics equal to the main path's on those cells.
6. attn_parity  the flash-attention and flash-decode kernels against
             their plain versions on the card: flash at (B 8, Hq 32,
             Hkv 4, hd 64), (B 2, Hq 16, Hkv 8, hd 128) and the two new
             families' shapes, (B 8, Hq 24, Hkv 8, hd 64) (granite-moe,
             G 3), (B 8, Hq 64, Hkv 8, hd 128) (qwen2-vl, G 8) and (B 8,
             Hq 32, Hkv 32, hd 112) (zamba2-7b, the padded path), S in
             {256, 192}, bf16 and float32, causal and full (`o` and `lse`);
             the bf16 tensor-core kernel's edges at (B 2, Hq 8, Hkv 2):
             hd 16, 32, 64, 112 and 128 x S in {1, 200, 2000} (and 192,
             256 at hd 16 and 32), causal and full; one call of each dtype
             with the route counts read, so float32 shows it still runs
             the CUDA-core kernel (held at 1e-5); decode at the B-8
             shapes above, Smax in {512, 300} with mixed lengths, bf16
             and float32, and finite garbage
             past the lengths must change nothing; decode in bf16 (2^-7
             of max |o|) and float32 (1e-5), a lane of length 0 gives
             zeros, and the split-KV combine is bit-identical to
             ``ref.combine_splits`` on the split kernel's own partials.
             Each kernel is timed beside its plain version and one
             PyTorch call as a yardstick (SDPA; the port never calls it);
             decode also on the device (``benchmarks/decode_bench.py``: a
             replayed CUDA graph, and the profiler's device events), with
             its split count, and the combine kernel alone; both kernels
             also at serve_hybrid's hd-112 shapes (flash (8, 256, 32/32,
             112), decode (8, 1, 32/32, 112) at length 288 of 512).
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
             `StreamProfile.from_capture`, ``paper_fig_serve.grid``: its
             three traffic classes x cascaded MLR/SLR x POLICY_PRESETS
             (66 cells, n_req 600)
             through `run_sweep` on the kernel (one launch per shape
             group, counted; every cell must complete; timed, and the
             bucketed plan on the same grid at n_req RETIME_SERVE_REQ
             timed and held equal to its main path for the record), and one
             class x both organisations at n_req 120 held against the
             plain engine on the card.
9. serve_moe the MoE family at full width and depth: granite-moe-3b-a800m
             (32 layers, d 1536, 24/8 heads of 64, 40 experts top-8 of
             width 512, vocab 49155, bf16), random weights from a seed,
             through `Engine` with attn_impl "pallas" as `serve` (8 x 256
             prompt tokens + 64 greedy; flash 32, decode and its combine
             32 x 63, exact); prefill ms, decode ms per step, tokens/s,
             device-busy ms per step.  Held against the plain full
             forward (no cache, attn_impl "chunked") on the generated
             tokens: bf16 logits within max(5e-2, 1.5 x naive vs
             chunked), the plain forwards taking the kernel path's
             experts (`routed`), so bf16 noise cannot flip a route
             between them; every decision where a plain path's own choice
             differs is counted, must number at most 1.5 x the two plain
             paths' own count (or FLIP_FRAC of the decisions), and must be
             a near-tie (`near_ties`); the same forward left free to
             route is reported.  float32 replay (the kernels' float32
             builds, a float32 cache) with routing free: flips counted and
             the first of each token a near-tie, logits within 1e-3 at
             every position whose routing agreed in every layer (at least
             half of them).
10. serve_vlm the VLM family: qwen2-vl-72b at its published width cut to
             4 of 80 layers, 8 x 256 + 16 greedy, prompts holding an image
             block (`vlm_positions`: three distinct M-RoPE streams), held
             as serve_moe holds (no router).
11. serve_hybrid  the hybrid family: zamba2-7b at its published width
             (d 3584, 32/32 heads of 112, d_ff 14336, 112 SSM heads of
             64, state 64, 2 groups, vocab 32000, bf16) cut to 15 of 81
             layers (two shared-block sites and a 3-layer tail), 8 x 256
             + 64 greedy, held as serve_moe holds (no router); flash 2,
             decode and its combine 2 x 63, exact.
12. serve_encdec  the encoder-decoder family: whisper-base at its full
             size (6 + 6 layers, d 512, 8 heads of 64, 1500 frames, vocab
             51865), 8 x 32 + 64 greedy, the frames from `make_batch`,
             held the same way; flash 6 (the decoder's prefill), decode
             and its combine 6 x 63.
13. figures  the paper's outputs through the port
             (``repro_torch.benchmarks``): Tables 1-2, Figs. 11-14,
             fig_policy, fig_ooo, fig_refresh, fig_fault (27 cells
             under ``on_error="record"``) and fig_serve (the capture fed
             the reference's recorded params and prompts,
             ``tests/torch_golden/fig_serve_capture.npz``; 66 cells),
             each module's ``run()``
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
14. sweep_scale  the sweep engine's resilience and scaling on the card.
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
             ``repro_torch.benchmarks.paper_fig_scale.main()`` at its
             smallest full size (60 cells, FIG_SCALE_SIZES; 240 and 960
             too until serve_kdim took their time; sync, stream_cold,
             stream_warm,
             each a fresh process, the first two building the kernel with
             nvcc into fresh directories; the 2e4-cell prune child): per
             size every bandwidth and the checksum equal the golden's,
             the promoted cells and ``prune_work`` too, one launch per
             child (two for the prune child's sub-sweeps), and the
             early-exit gate's fig_scale section passes (best ratio >=
             1.3, saved >= 0.5); cells/s, buckets/s and nvcc seconds per
             size and mode, the prune child's wall.
15. attn_bwd_parity  the flash-attention backward kernel against its
             plain version (`ref.attention_bwd`) on the card: (B 4, S 2048,
             Hq 32, Hkv 4, hd 64), (B 2, S 512, Hq 16, Hkv 8, hd 128), a
             ragged S 200, and at hd 112 zamba2-7b's training shape (B 4,
             S 2048, Hq 32, Hkv 32) and a ragged S 200 with G 4, and
             whisper-base's decoder self-attention in training (B 8, S
             448, Hq 8, Hkv 8, hd 64), bf16 and float32, causal and full
             (dq, dk, dv; and the forward's o and lse at attn_parity's
             bounds, so every training path's forward is held at its own
             shape); the bf16 tensor-core
             kernels' edges, the forward's cases above (hd 112 too); every
             bf16 call twice, bit-identical; and gradients through
             `ops.flash_attention`'s autograd Function against autograd
             through the plain forward, float32 (1e-5) and bf16 (2^-7 of
             max |g|).  The kernel is timed beside its plain version and
             the backward of SDPA, and the forward at the same shape beside
             its plain version and SDPA's forward (yardsticks; the port
             never calls SDPA), at the
             training shapes of `train` and `train_hybrid`.
16. train    the training path at full width: tinyllama-1.1b (bf16
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
17. train_hybrid  the hybrid family trained the same way and held the same
             way (`train_checked`): zamba2-7b at full width cut to 6 of
             81 layers (one group with its shared block's site; cut
             below serve_hybrid's 15 for the time budget; bf16
             compute, float32 master weights, m and v, the SSM leaves
             included), `train`'s batches (`SyntheticLM` seed
             0, 4 x 2048), 6 steps; per step the forward kernel twice
             (the site, again in its recompute) and the backward once,
             all at hd 112.
18. train_encdec  whisper-base at its full size, batches of 8 x 448
             decoder tokens over 1500 frames from `make_batch`, 6 steps,
             held the same way; per step the forward kernel 12 times and
             the backward 6 (the decoder's self-attention, hd 64; the
             encoder and the cross-attention on the plain chunked path, as
             in the reference).
19. pipe_parity  the SMLA cascaded-pipeline matmul (3xTF32 on wgmma:
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
20. wkv_parity  the WKV6 kernel against its plain version (the chunked
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
21. train_rwkv  rwkv6-3b at full width (d 2560, 40 heads of 64, d_ff
             8960, vocab 65536, bf16 compute, float32 master weights) cut
             to 2 of its 32 layers, random weights from
             seed 0, `SyntheticLM` seed 0, batch 4 x 2048, 6 steps through
             `launch/train.py`'s functions (attn_impl "pallas", remat
             "full"): exactly 4 wkv6 launches per step (2 layers + their
             recomputes); first a float32 replay of one step from the
             initial weights of the same model cut to 1 layer
             (RWKV_REPLAY_LAYERS): the loss against the kernel's plain version
             under the same autograd Function, every gradient leaf against
             a float64 witness (the plain and the sequential path in
             float64), within 1.5 x the farther of the two plain float32
             paths from it, at least 1e-5 (see W64_TOL's notes); after
             training, the bf16 loss against the chunked path, within 1.5
             x the gap between the chunked and the sequential path (at
             least 1e-3).
22. pod_sync  the cross-pod sync and the data-parallel train step: 4
             spawned ranks share the card on gloo (NCCL refuses two ranks
             on one device), a ('pod',) DeviceMesh, every transfer of a
             CUDA tensor staged through host memory (so no NVLink times);
             no fallback: a rank that fails fails the spawn.  (c)
             ``benchmarks/collective_schedules.measure`` on the card: the
             wire bytes per rank exact (786432, 786432, 197376); (b) one
             step's gradients of each rank's row through `tree_sync`
             (cascaded, dedicated, cascaded_int8), timed, against their
             float64 mean, which each rank forms alone from every row's
             gradients: 1e-6 of each leaf's max, int8 within 6 x its
             scale; (a) tinyllama-1.1b at
             full width cut to 4 layers, float32, `train`'s sequence, one
             row per rank, 2 steps through `make_train_step(..., mesh)`
             in "auto", "cascaded", "dedicated" and cascaded + int8,
             attn_impl "pallas" (flash forward 8 and backward 4 per step,
             exact, per rank and mode): every rank the same losses, each
             mode's within 2e-3 of auto's; cascaded and dedicated against
             one process on the whole batch (loss and grad norm 1e-5, m
             and v 5e-5 of each leaf's max, params 0.05 x the steps'
             largest lr).
23. serve_mesh  serving on a (2, 2) ('data', 'model') mesh, inside
             pod_sync's 4 ranks (its seconds are in pod_sync's; this
             phase prints the ranks' results): tinyllama-1.1b under MLR
             and SLR and granite-moe-3b-a800m under MLR (experts over
             'model', capacity factor 40 so no assignment is dropped, as
             the one-process dense FFN drops none), full width cut to 2
             layers, 8 x 64 prompt tokens + 8 greedy (16 until the
             budget took serve_kdim's time), attn_impl "pallas",
             through ``Engine(..., mesh=...)``, bf16, and float32 (a
             float32 cache) with 8 new tokens, MLR only (for the
             budget); per rank
             and run the flash launches 2 and decode and its combine 2 x
             7, exact, each on the rank's own
             heads (MLR: 16/2 of tinyllama's 32/4, 12/4 of granite's
             24/8), and the decode steps' CommLog bytes and calls equal to
             ``serve_policies.decode_comm``; rank 0 gathers every run's
             logits, tokens and routing and holds them to one process's
             `Engine` on the same params and batch: float32 logits within
             1e-5 of each step's max |logit| at every position no router
             flip and no earlier token difference reaches, tokens equal
             but at near-ties (bf16: top-2 gap within 0.1) or after a
             flip (in bf16 the MoE's one process takes the mesh run's
             experts, so none flips); per-step wall and staged bytes
             (loopback and PCIe, not NVLink: no limit).  Then the
             same ranks serve as a (1, 4) mesh (MLR; no FSDP
             gather; 8 x 64 + 16 greedy) every family that F3a left
             out, at full width:
             phi3-medium-14b at 2 layers (10 KV heads over 4: the
             cache's sequence is cut over 'model', each rank runs the
             split kernel on its block and the combine kernel merges
             every rank's partials: launches 2 and 2 x 15, every
             cross-rank combine of the first step bit-identical to
             `ref.combine_splits` on the same partials), rwkv6-3b at 2
             (no attention kernel), zamba2-7b at 6 (one shared-block
             site, hd 112: 1 and 1 x 15), whisper-base at full size over
             1500 frames (6 and 6 x 15), and zamba2-7b with 14 SSM heads
             of P 512 in place of its 112 (`SM_VARIANTS`) at 2 layers,
             whose SSM state is cut over P (each rank P/4 channels of
             every head, its normed channels relaid into w_out's row
             block), each bf16 and float32 and held as above; its
             seconds and each run's median step are printed.
24. train_mesh  sharded training on a (2, 2) ('data', 'model') mesh,
             inside pod_sync's 4 ranks after serve_mesh (its seconds are
             in pod_sync's): tinyllama-1.1b at full width (d 2048, 32 q
             / 4 KV heads, d_ff 5632, vocab 32000), 2 of 22 layers,
             float32, attn_impl "pallas", remat "full", SyntheticLM seed
             0 at 4 x 1024, 2 steps with sequence-parallel residuals and
             2 without, each from the seed-0 state cut into the rank's
             shards (FSDP over 'data', TP over 'model'); per rank every
             shard's shape (its block under the param rules), the flash
             forward 8 and backward 4 launches per run, exact, each on
             16 of 32 q and 2 of 4 KV heads, every step's CommLog (calls,
             wire and staged bytes) equal to
             ``collective_schedules.train_step_comm``; the state gathered
             whole and held on rank 0 against one process on the whole
             batch with pod_sync's bounds (loss and grad norm 1e-5, m and
             v 5e-5 of each leaf's max, params 0.05 x lr).
25. serve_kdim  rwkv6-3b at full width (40 heads of 64), 2 layers, on a
             (1, 16) ('data', 'model') mesh of 16 ranks forked from a
             server that has loaded torch and the port (RANK_PRELOAD),
             sharing the card over gloo (host-staged): 40 heads do not divide
             16, so the WKV state is cut over its k dim (4 rows of every
             head per rank; r, k, v gathered over 'model', the partial
             y summed in float32).  Each rank draws its blocks of the
             seed-0 params a leaf at a time and serves them through
             ``Engine(..., mesh=..., local=True)`` under MLR, 8 x 64 +
             16 greedy in bf16 and + 8 in float32 (a float32 state); no
             kernel launches (counters read), each rank's state (2, 8,
             40, 4, 64), every decode step's CommLog bytes and calls
             equal to ``serve_policies.decode_comm``; rank 0 holds both
             runs to one process's `Engine` on the whole tree with
             serve_mesh's bounds.  Prints the phase's seconds, the
             median decode step and the bytes and calls per token.
26. kernels  one JSON line: each kernel with its launches on its main
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
import multiprocessing
import multiprocessing.forkserver
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
import types

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
           "fig_fault": ("paper_fig_fault", {}),
           "fig_serve": ("paper_fig_serve", {})}
#: fig_serve's capture as the reference's full-size run drew it (its
#: params, prompt tokens and generated tokens; the reference draws them
#: from JAX keys no other process can repeat), beside the golden file
GOLDEN_CAPTURE = GOLDEN_FIGS.with_name("fig_serve_capture.npz")
#: kernel launches a figure makes beyond one per shape group of its
#: sweeps: Fig. 12's cross-check `engine.simulate` of one cell
FIGURE_EXTRA_LAUNCHES = {"fig12": 1}
#: phase `sweep_scale`: fig_scale's sizes as workload counts (the
#: benchmark's full sizes are 6, 24 and 96).  The 960- and 240-cell sizes,
#: ~30-45 s of fresh child processes each, went for the time budget when
#: `serve_kdim` came (with both 60 and 240 the script took 589.5 and
#: 613.5 s on one NVIDIA H100 80GB HBM3 at 700 W).  The golden holds each
#: size's rows, and the gate's ratio was 9.77 at 60 cells in that run
FIG_SCALE_SIZES = (6,)
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
#: phase `serve_moe`: granite-moe-3b-a800m at its published width and
#: depth (32 layers, d 1536, 24/8 heads of 64, 40 experts top-8 of width
#: 512, vocab 49155), served as `serve` serves tinyllama
MOE_ARCH = "granite-moe-3b-a800m"
#: phase `serve_vlm`: qwen2-vl-72b at its published width (d 8192, 64/8
#: heads of 128, d_ff 29568, vocab 152064) cut to 4 of its 80 layers (80
#: layers' float32 params are ~290 GB; 4 and the embedding and head
#: ~24 GB), 8 requests of 256 prompt tokens + 16 greedy
VLM_ARCH, VLM_LAYERS, VLM_NEW = "qwen2-vl-72b", 4, 16
#: the image block of each serve_vlm prompt: (height, width) patches
VLM_GRID = (12, 16)
#: router decisions of the kernel path that may differ from the plain
#: path's: 1.5 x as many as differ between the reference's own two plain
#: paths (naive and chunked attention), and at least this fraction of all
#: (layer, token) decisions
FLIP_FRAC = 1e-3

#: phase `serve_hybrid`: zamba2-7b at its published width (d 3584, 32/32
#: heads of 112, d_ff 14336, 112 SSM heads of 64, state 64, 2 groups, conv
#: 4, chunk 128, vocab 32000) cut to 15 of its 81 layers: two shared-block
#: sites (after layers 6 and 12) and a 3-layer tail, so both branches of
#: the model's layer loop run (the cut is the time budget's, as
#: serve_vlm's); 8 x 256 + 64 greedy, as `serve`
HYBRID_ARCH, HYBRID_LAYERS = "zamba2-7b", 15
#: phase `serve_encdec`: whisper-base at its full size (6 + 6 layers, d
#: 512, 8 heads of 64, 1500 encoder frames, vocab 51865), 8 requests of 32
#: prompt tokens + 64 greedy, frame embeddings from `make_batch`
ENCDEC_ARCH, ENCDEC_PROMPT = "whisper-base", 32
#: the README grid's workloads whose cells (75 of 465) phase `grid` runs
#: once more through the bucketed plan (a launch per makespan bucket) and
#: as one launch, for the record: a spread of makespans (several buckets)
#: without the arrival-bound low.0x cells that set the full grid's
#: slowest launches
RETIME_WORKLOADS = ("low.07", "mid.05", "high.05", "stream.3", "tpc.2")
#: requests per core of the serve_sim grid that `serve_sim` times through
#: the bucketed plan, for the record (the main path runs n_req 600)
RETIME_SERVE_REQ = 120
#: phase `attn_parity`'s (B, Hq, Hkv, hd) for flash and decode: the
#: earlier cases (G 8 at hd 64, G 2 at hd 128), granite-moe-3b-a800m's
#: (G 3, the first odd group), qwen2-vl-72b's (G 8 at hd 128, decode's
#: largest shared-memory request) and zamba2-7b's shared attention (G 1 at
#: hd 112, the padded path)
ATTN_SHAPES = ((8, 32, 4, 64), (2, 16, 8, 128), (8, 24, 8, 64),
               (8, 64, 8, 128), (8, 32, 32, 112))
#: decode at serve_hybrid's step halfway through its 64 new tokens:
#: (B, Hq, Hkv, hd, Smax, length), as `decode_bench.SERVING`
HYBRID_DECODE = (8, 32, 32, 112, 512, 288)
#: backward-kernel shapes of phase `attn_bwd_parity`: (B, S, Hq, Hkv, hd);
#: two at hd 112, zamba2-7b's training shape (G 1) and a ragged S with
#: G 4, and the last whisper-base's decoder self-attention in training
#: (train_encdec, G 1)
BWD_SHAPES = ((4, 2048, 32, 4, 64), (2, 512, 16, 8, 128), (2, 200, 32, 4, 64),
              (4, 2048, 32, 32, 112), (2, 200, 16, 4, 112),
              (8, 448, 8, 8, 64))
#: the backward timed at hd 112: zamba2-7b's training shape (train_hybrid)
BWD_HD112 = BWD_SHAPES[3]
#: the bf16 tensor-core kernels' edges, forward and backward, at (B 2,
#: Hq 8, Hkv 2): (hd, S) for every head dim, S one row, ragged at the
#: kernels' 64-row tiles (200, 2000) and, at hd 16 and 32, the S of the
#: cases above (192, 256)
FLASH_EDGES = tuple((hd, s) for hd in (16, 32, 64, 112, 128)
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
#: phase `train_encdec`: whisper-base at its full size, batches of 8 x 448
#: decoder tokens (whisper's published text context) over 1500 frames
#: from `make_batch`, 6 steps; phase `train_hybrid` trains zamba2-7b at
#: full width cut to TRAIN_HYBRID_LAYERS (one group with its shared-block
#: site; below serve_hybrid's 15, for the time budget beside `serve_mesh`
#: and `serve_kdim`: 9 with a 3-layer tail until the latter came) on
#: `train`'s batches
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ = 8, 448
TRAIN_HYBRID_LAYERS = 6
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
#: cut from 32 layers to 2 (full depth holds 36.9 GB of float32 params,
#: m and v, twice that during the out-of-place AdamW update: more than
#: one card's 80 GB; 2 keeps the script within its time budget beside
#: `serve_mesh`)
RWKV_ARCH = "rwkv6-3b"
RWKV_LAYERS = 2
#: the float32 replay and its float64 witness run a model of the same
#: width, batch and sequence cut to 1 layer (RWKV-6's layers are all of
#: one kind, so one holds every operation of the model): the witness is
#: most of the phase's time, ~27 s a layer
RWKV_REPLAY_LAYERS = 1
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
#: phase `pod_sync`: the cross-pod sync and the data-parallel train step
#: over POD_RANKS spawned ranks that share the one card (NCCL refuses two
#: ranks on one device: "Duplicate GPU detected"), on gloo, every transfer
#: of a CUDA tensor staged through host memory
#: (``collectives.stages_on_host``), so its wall times are not NVLink
#: figures.  tinyllama-1.1b at full width cut to POD_LAYERS layers (every
#: stacked leaf's leading dim divides by POD_RANKS and takes the ring; at 2
#: it would take the fused sum), float32 compute (a single-process run on
#: the whole batch then differs from the ranks' only in summation order,
#: which bf16 rounding of two batch splits would swamp), one TRAIN_SEQ row
#: per rank, POD_STEPS steps in each mode on `train`'s schedule (the
#: launcher's: lr 3e-4, warmup 100)
POD_RANKS, POD_LAYERS, POD_STEPS = 4, 4, 2
#: (label, pcfg.cross_pod_sync, pcfg.grad_compression)
POD_MODES = (("auto", "auto", "none"), ("cascaded", "cascaded", "none"),
             ("dedicated", "dedicated", "none"),
             ("cascaded_int8", "cascaded", "int8"))
#: each mode's losses within POD_LOSS_TOL of "auto" (the reference's own
#: bound, tests/test_collectives.py:130); `tree_sync` of one step's
#: gradients within POD_SYNC_TOL of each leaf's max |float64 mean|
#: (cascaded, dedicated; "auto" syncs as dedicated), int8 within 6 x its
#: quantisation scale (max |g| over the ranks / 127, the reference test's)
POD_LOSS_TOL = 2e-3
POD_SYNC_TOL = 1e-6
#: cascaded and dedicated against a single-process run of the same steps
#: on the whole batch (the bounds of tests/test_torch_train.py): loss and
#: grad norm rtol POD_REF_RTOL each step; m and v within POD_MV_TOL of each
#: leaf's max; params within POD_PARAM_TOL x the steps' largest learning
#: rate, an element whose single-process gradient is at most POD_NOISE of
#: its leaf's max in a step excused and counted (its update's sign is
#: float32 noise; as in tests/test_torch_train_families.py)
POD_REF_RTOL, POD_MV_TOL, POD_PARAM_TOL, POD_NOISE = 1e-5, 5e-5, 0.05, 1e-5
#: `collective_schedules`' wire bytes per rank, x (4, 2^17) float32: ring
#: and fused 2(n-1)/n x 512 KiB; the int8 ring 6 hops x (32768 + 128)
POD_WIRE = {"cascaded": 786432, "dedicated": 786432,
            "cascaded_int8": 197376}


#: phase `serve_mesh`: serving on a (2, 2) ('data', 'model') mesh carved
#: from `pod_sync`'s POD_RANKS spawned ranks (the card shared over gloo,
#: every transfer host-staged): SM_BATCH requests of SM_PROMPT prompt
#: tokens, SM_NEW greedy new tokens, attn_impl "pallas", through
#: ``Engine(..., mesh=...)``, per arch the depth of SM_LAYERS (full width)
#: and its policies; each run bf16 and float32 (a float32 cache), held on
#: rank 0 against one process's `Engine` on the same params and batch
SM_MESH = ((2, 2), ("data", "model"))
SM_BATCH, SM_PROMPT, SM_NEW, SM_MAX_SEQ = 8, 64, 16, 128
#: new tokens of the SM_MESH runs' bf16 runs, for the budget beside
#: `serve_kdim` (16 until then): their decode steps are nearly all the
#: FSDP gathers of every layer's weights, the same each step
SM_NEW_FSDP = 8
#: new tokens of the float32 runs, for the budget: every step gathers
#: twice the bf16 run's bytes (one NVIDIA H100 80GB HBM3 at 700 W, a slow
#: host: 60.0 s for the phase with 16)
SM_NEW_F32 = 8
#: the policies of the float32 runs: MLR alone, for the budget (the
#: whole script took 607.8 s with the float32 SLR run on a slow host)
SM_F32_POLICIES = ("mlr",)
#: (arch, layers, policies): 2 layers, for the budget (every decode step
#: gathers each layer's weights over 'data', host-staged: ~0.35 GB/s per
#: rank with four ranks on the card)
SM_RUNS = ((SERVE_ARCH, 2, ("mlr", "slr")), (MOE_ARCH, 2, ("mlr",)))
#: the same ranks as a (1, 4) ('data', 'model') mesh (no FSDP gather: only
#: the float32 'model' sums and the gathers of whole heads and partials
#: move), MLR, every family that F3a left out at full width: phi3-medium-
#: 14b's 10 KV heads do not divide 4 (its cache's sequence is cut over
#: 'model' and every decode step merges the ranks' partials with the
#: combine kernel), rwkv6-3b's 40 heads, zamba2-7b's 112 SSM and 32 KV
#: heads (6 layers: one shared-block site), whisper-base at full depth
#: over its 1500 frames (None), and zamba2-7b's SSM state cut over P (2
#: layers; SM_VARIANTS).  Each rank's whole tree is made on the card from
#: seed 0 and kept on the host until the engine cuts it
SM_WIDE_MESH = ((1, 4), ("data", "model"))
SM_WIDE_RUNS = (("phi3-medium-14b", 2, ("mlr",)), (RWKV_ARCH, 2, ("mlr",)),
                (HYBRID_ARCH, 6, ("mlr",)), (ENCDEC_ARCH, None, ("mlr",)),
                ("zamba2-7b-ssm14", 2, ("mlr",)))
#: runs of a published arch with its SSM heads replaced: name -> (arch,
#: n_ssm_heads).  zamba2-7b at full width (d_model 3584, d_inner 7168,
#: n_groups 2) with 14 SSM heads of P = 512 in place of its 112 of 64:
#: no published config reaches the P-cut SSM state (heads that do not
#: divide 'model') below 'model' = 32, and the head counts that divide
#: d_inner but not 4 are 1, 2, 7 and 14; 14 over 4 is 3.5 heads per rank,
#: so every rank's rows of w_out straddle heads, as rwkv6-3b's columns
#: do in `serve_kdim`
SM_VARIANTS = {"zamba2-7b-ssm14": (HYBRID_ARCH, 14)}
#: float32 decode logits against one process: this fraction of each
#: step's max |logit|, at every (request, step) that no router flip and no
#: earlier token difference reaches
SM_LOGIT_TOL = 1e-5
#: a bf16 token may differ from one process's only where that process's
#: top-2 logit gap is within this (twice phase `serve`'s bf16 bound), or
#: after a router flip in its request
SM_NEAR_TIE = 2 * SERVE_TOL
#: phase `serve_kdim`: rwkv6-3b at full width (d_model 2560, 40 heads of
#: 64), KD_LAYERS of its 32 layers, on a KD_MESH ('data', 'model') mesh
#: of KD_RANKS spawned ranks sharing the card over gloo (every transfer
#: host-staged; NCCL refuses two ranks on one device, so four cards
#: cannot host it either).  40 heads do not divide 16, so the WKV state
#: is cut over its k dim, 4 of every head's 64 rows per rank (no 'model'
#: of 4 or 8 reaches that layout at this width: 40 divides both).
#: MLR, SM_BATCH x SM_PROMPT + SM_NEW greedy in bf16 and + SM_NEW_F32
#: in float32 with a float32 state, through ``Engine(..., mesh=...,
#: local=True)``: each rank draws the seed-0 params a leaf at a time on
#: the card and keeps its block (16 whole float32 trees would be ~2.0 GB
#: each), and rank 0 holds the runs against one process's `Engine` on
#: the whole tree with `serve_mesh`'s bounds
KD_MESH = ((1, 16), ("data", "model"))
KD_RANKS, KD_LAYERS = 16, 2
#: modules the forkserver imports once, started with the script so its
#: imports overlap the first phases: `pod_sync`'s 4 and `serve_kdim`'s 16
#: ranks fork from it with torch and the port loaded, where each spawned
#: rank imported them itself (`serve_kdim`: 22.7 s before its rank 0
#: started, one NVIDIA H100 80GB HBM3 at 700 W)
RANK_PRELOAD = ["torch", "numpy", "repro_torch.serve.engine",
                "repro_torch.benchmarks.serve_policies",
                "repro_torch.benchmarks.collective_schedules",
                "repro_torch.train.step"]
#: phase `train_mesh`: sharded training on a (2, 2) ('data', 'model')
#: mesh carved from `pod_sync`'s POD_RANKS spawned ranks (the card shared
#: over gloo, every transfer host-staged): tinyllama-1.1b at full width
#: (d 2048, 32 q / 4 KV heads, d_ff 5632, vocab 32000) cut to TM_LAYERS
#: of its 22 layers, float32, attn "pallas", remat "full" (`launch/
#: train.py`'s PCFG), SyntheticLM seed 0 at TM_BATCH x TM_SEQ, TM_STEPS
#: steps with sequence-parallel residuals and TM_STEPS without, each
#: from the seed-0 state cut into the rank's shards; rank 0 holds the
#: assembled state to one process on the whole batch with `pod_sync`'s
#: bounds
TM_MESH = ((2, 2), ("data", "model"))
TM_LAYERS, TM_BATCH, TM_SEQ, TM_STEPS = 2, 4, 1024, 2


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


def pod_rank(rank: int, world: int, init: str, out_dir: str,
             t_spawn: float) -> None:
    """One rank of phase `pod_sync`, in a spawned process, the card shared
    with the others: its gloo process group, `pod_checks`, the results as
    ``rank<r>.json`` in `out_dir`.  A failed check raises, which fails the
    spawn and the phase.  `t_spawn` is the host's ``time.time()`` at the
    spawn, from which the results' ``marks_s`` count."""
    import datetime

    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    marks = {"started": time.time() - t_spawn}
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        res = pod_checks(rank, world, dev, marks, t_spawn)
        res["serve_mesh"] = serve_mesh_checks(rank, world, dev, marks,
                                              t_spawn)
        res["train_mesh"] = train_mesh_checks(rank, dev, marks, t_spawn)
        pathlib.Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def pod_checks(rank: int, world: int, dev, marks: dict,
               t_spawn: float) -> dict:
    """Phase `pod_sync`'s work in one rank of a ('pod',) mesh of `world`:
    (c) `collective_schedules.measure`, its wire bytes exact; (b) one
    step's gradients of this rank's row through `tree_sync` in each mode,
    timed, against their float64 mean; (a) POD_STEPS
    train steps through `make_train_step(..., mesh)` in each of POD_MODES
    from seed-0 weights, the flash kernels' launch counters reset just
    before each mode and read just after; rank 0 also runs the same steps
    in one process on the whole batch and holds the cascaded and
    dedicated states to it.  `marks` gets the seconds since `t_spawn`
    at which each part ended."""
    import torch
    import torch.distributed as dist

    from repro_torch.benchmarks import collective_schedules
    from repro_torch.configs import get_config
    from repro_torch.core import collectives as C
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import axis_group, make_test_mesh
    from repro_torch.models.common import flatten_paths
    from repro_torch.train.step import (init_state, make_grad_fn,
                                        make_train_step)

    def sync():
        torch.cuda.synchronize(dev)

    def mark(part):
        sync()
        marks[part] = time.time() - t_spawn

    mesh = make_test_mesh((world,), ("pod",), device_type=dev.type)
    group = axis_group(mesh, "pod")
    out = {"rank": rank, "backend": dist.get_backend(group), "marks_s": marks}
    mark("group")

    # (c) the benchmark's rows, x on the card
    rows = collective_schedules.measure(group, dev)
    wire = {r["schedule"]: r["wire_bytes_per_dev"] for r in rows}
    if wire != POD_WIRE:
        raise RuntimeError(f"pod_sync: collective_schedules wire bytes "
                           f"{wire}, want {POD_WIRE}")
    out["schedules"] = rows
    mark("schedules")

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=POD_LAYERS,
                              dtype="float32")
    pcfg = launch_train.PCFG
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, world, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()} for i in range(POD_STEPS)]
    local = [C.local_batch(b, mesh) for b in batches]
    grad_fn = make_grad_fn(cfg, pcfg)

    # (b) tree_sync of step 0's gradients against their float64 mean,
    # which every rank forms alone from the gradients of all the ranks'
    # rows (no transfer: the witness does not lean on the collectives)
    params = init_state(0, cfg, device=dev).params
    _, g = grad_fn(params, local[0])
    flat = flatten_paths(g)
    names = sorted(flat)
    mean64 = {k: flat[k].double() / world for k in names}
    gmax = torch.stack([flat[k].abs().max() for k in names])
    for j in range(world):
        if j == rank:
            continue
        _, gj = grad_fn(params, {k: v[j:j + 1]
                                 for k, v in batches[0].items()})
        gj = flatten_paths(gj)
        for k in names:
            mean64[k] += gj[k].double() / world
        gmax = torch.maximum(gmax, torch.stack([gj[k].abs().max()
                                                for k in names]))
        del gj
    del params
    gmax = gmax.cpu()
    mark("witness")
    out["tree_sync"] = {}
    for mode in C.MODES:
        log = C.CommLog()
        dist.barrier(group)
        sync()
        t0 = time.perf_counter()
        got = C.tree_sync(g, group, mode, log=log)
        sync()
        sec = time.perf_counter() - t0
        got = flatten_paths(got)
        worst = 0.0
        for j, k in enumerate(names):
            want = mean64[k].reshape(flat[k].shape)
            err = float((got[k].double() - want).abs().max())
            tol = (6 * float(gmax[j]) / 127 if mode == "cascaded_int8"
                   else POD_SYNC_TOL * float(want.abs().max()))
            if not err <= tol:
                raise RuntimeError(f"pod_sync: tree_sync {mode} {k} is "
                                   f"{err} from the float64 mean "
                                   f"(tolerance {tol})")
            worst = max(worst, err / tol)
        out["tree_sync"][mode] = {
            "seconds": sec, "worst_err_over_tol": worst, "ops": log.ops,
            "hops": log.hops, "wire_bytes": log.wire_bytes,
            "staged_bytes": log.staged_bytes}
        del got
    del g, flat, mean64
    mark("tree_sync")

    # (a) the train step over the ranks, in every mode
    ref = pod_single_process(cfg, pcfg, batches, grad_fn, dev) \
        if rank == 0 else None
    dist.barrier(group)
    mark("single_process")
    out["train"] = {}
    for label, sync_mode, comp in POD_MODES:
        pc = dataclasses.replace(pcfg, cross_pod_sync=sync_mode,
                                 grad_compression=comp)
        step = make_train_step(cfg, pc, mesh, total=POD_STEPS)
        state = init_state(0, cfg, device=dev)
        sync()
        fa_kernel.flash_attention_fwd.launches = 0
        fa_kernel.flash_attention_bwd.launches = 0
        losses, gnorms, step_s = [], [], []
        for i in range(POD_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, local[i])
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            step_s.append(time.perf_counter() - t0)
        launches = [fa_kernel.flash_attention_fwd.launches,
                    fa_kernel.flash_attention_bwd.launches]
        # per step: the forward once per layer and once more in its
        # recompute (remat "full"), the backward once per layer
        want = [POD_STEPS * 2 * cfg.n_layers, POD_STEPS * cfg.n_layers]
        if launches != want:
            raise RuntimeError(f"pod_sync: {label}: flash launches "
                               f"{launches}, want {want}")
        run = {"losses": losses, "grad_norms": gnorms, "step_s": step_s,
               "launches": launches}
        if ref is not None and label in ("cascaded", "dedicated"):
            run["vs_single_process"] = pod_compare(label, state, losses,
                                                   gnorms, ref)
        out["train"][label] = run
        del state
        mark(f"train_{label}")
    auto = out["train"]["auto"]["losses"]
    for label, run in out["train"].items():
        gap = max(abs(a - b) for a, b in zip(run["losses"], auto))
        if not gap <= POD_LOSS_TOL:
            raise RuntimeError(f"pod_sync: {label} losses {run['losses']} "
                               f"vs auto {auto}: {gap} > {POD_LOSS_TOL}")
        run["loss_gap_to_auto"] = gap
    if ref is not None:
        out["single_process"] = {k: ref[k] for k in
                                 ("losses", "grad_norms", "lrs", "seconds")}
    return out


def train_mesh_checks(rank: int, dev, marks: dict, t_spawn: float) -> dict:
    """Phase `train_mesh`'s work in one rank of `pod_sync`'s spawn, as a
    TM_MESH mesh: for sequence parallelism on and off, TM_STEPS steps of
    ``make_train_step(cfg, pcfg, mesh)`` from the seed-0 state cut into
    this rank's shards (``step.shard_state``) on its share of the batch
    (``collectives.local_batch``).  Checked per rank: every shard's
    shape (its block under the param rules: 1/'data' of each leaf cut
    over 'data'), the flash forward's and backward's launches (forward
    once per layer and once more in its recompute, backward once per
    layer, each step) and their heads (this rank's 16 of 32 q and 2 of 4
    KV), every rank the same losses, and each step's CommLog equal to
    ``collective_schedules.train_step_comm``.  The state is then
    gathered whole (``checkpoint.gather_whole``, every rank) and rank 0
    holds it to one process on the whole batch (`pod_single_process`,
    `pod_compare`)."""
    import torch
    import torch.distributed as dist

    from repro_torch.benchmarks.collective_schedules import train_step_comm
    from repro_torch.configs import get_config
    from repro_torch.configs.base import _param_shapes
    from repro_torch.core import partitioning as part
    from repro_torch.core.collectives import local_batch
    from repro_torch.core.comm import axis_sizes
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.common import flatten_paths
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.step import (init_state, make_grad_fn,
                                        make_train_step, shard_state)

    def sync():
        torch.cuda.synchronize(dev)

    torch.cuda.empty_cache()
    mesh = make_test_mesh(*TM_MESH, device_type=dev.type)
    sizes = axis_sizes(mesh)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TM_LAYERS,
                              dtype="float32")
    data = SyntheticLM(cfg.vocab_size, TM_SEQ, TM_BATCH, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i).items()} for i in range(TM_STEPS)]
    local = [local_batch(b, mesh) for b in batches]
    base = launch_train.PCFG
    ref = (pod_single_process(cfg, base, batches, make_grad_fn(cfg, base),
                              dev) if rank == 0 else None)
    heads = []
    orig = (fa_ops._forward, fa_ops._backward)

    def fwd(q, k, v, causal):
        heads.append(("fwd", q.shape[2], k.shape[2]))
        return orig[0](q, k, v, causal)

    def bwd(q, k, v, o, lse, do, causal):
        heads.append(("bwd", q.shape[2], k.shape[2]))
        return orig[1](q, k, v, o, lse, do, causal)

    m_size = sizes["model"]
    want_heads = (cfg.n_heads // m_size, cfg.n_kv_heads // m_size)
    out = {"mesh": TM_MESH, "runs": {}}
    fa_ops._forward, fa_ops._backward = fwd, bwd
    try:
        for sp in (True, False):
            label = "sp" if sp else "no_sp"
            pcfg = dataclasses.replace(base, seq_shard_activations=sp)
            # pod_single_process's schedule
            step = make_train_step(cfg, pcfg, mesh, total=POD_STEPS)
            specs = step.ctx.specs
            state = shard_state(init_state(0, cfg, device=dev), mesh)
            flat_specs = flatten_paths(specs)
            for tree in (state.params, state.opt.m, state.opt.v):
                for k, leaf in flatten_paths(tree).items():
                    want = part.local_shape(_param_shapes(cfg)[k],
                                            flat_specs[k], mesh)
                    if tuple(leaf.shape) != want:
                        raise RuntimeError(
                            f"train_mesh: {label}: {k} shard "
                            f"{tuple(leaf.shape)}, want {want} "
                            f"({flat_specs[k]})")
            want_comm = train_step_comm(cfg, pcfg, sizes, TM_BATCH, TM_SEQ)
            heads.clear()
            sync()
            fa_kernel.flash_attention_fwd.launches = 0
            fa_kernel.flash_attention_bwd.launches = 0
            losses, gnorms, step_s, comm = [], [], [], []
            for i in range(TM_STEPS):
                log = step.ctx.log
                before = (log.ops, log.wire_bytes, log.staged_bytes)
                t0 = time.perf_counter()
                state, m = step(state, local[i])
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
                step_s.append(time.perf_counter() - t0)
                got = {"ops": log.ops - before[0],
                       "wire_bytes": log.wire_bytes - before[1],
                       "staged_bytes": log.staged_bytes - before[2]}
                if got != want_comm:
                    raise RuntimeError(f"train_mesh: {label} step {i}: "
                                       f"CommLog {got}, want {want_comm}")
                comm.append(got)
            launches = [fa_kernel.flash_attention_fwd.launches,
                        fa_kernel.flash_attention_bwd.launches]
            want = [TM_STEPS * 2 * cfg.n_layers, TM_STEPS * cfg.n_layers]
            if launches != want:
                raise RuntimeError(f"train_mesh: {label}: flash launches "
                                   f"{launches}, want {want}")
            if sorted(set(h[1:] for h in heads)) != [want_heads] or \
                    len(heads) != sum(want):
                raise RuntimeError(f"train_mesh: {label}: flash calls on "
                                   f"(q, kv) heads {sorted(set(heads))}, "
                                   f"want {want_heads} each")
            peers = [None] * dist.get_world_size()
            dist.all_gather_object(peers, losses)
            if any(p != losses for p in peers):
                raise RuntimeError(f"train_mesh: {label}: ranks' losses "
                                   f"{peers}")
            whole = ckpt.gather_whole(state, mesh, specs)
            run = {"losses": losses, "grad_norms": gnorms, "step_s": step_s,
                   "launches": launches, "heads": list(want_heads),
                   "comm_per_step": comm[0]}
            if ref is not None:
                run["vs_single_process"] = pod_compare(
                    f"train_mesh {label}", whole, losses, gnorms, ref)
            out["runs"][label] = run
            del state, whole
            marks[f"train_mesh_{label}"] = time.time() - t_spawn
    finally:
        fa_ops._forward, fa_ops._backward = orig
    if ref is not None:
        out["single_process"] = {k: ref[k] for k in
                                 ("losses", "grad_norms", "lrs", "seconds")}
    return out


def pod_single_process(cfg, pcfg, batches, grad_fn, dev) -> dict:
    """`pod_checks`' single-process run: POD_STEPS steps of `cfg` from the
    same seed-0 weights on the whole batch, no mesh; each step's gradient
    read first (`grad_fn`) to mark the elements at most POD_NOISE of their
    leaf's max.  Returns the final state, the marks, losses, grad norms
    and the wall time."""
    from repro_torch.models.common import flatten_paths
    from repro_torch.train.step import init_state, make_train_step
    t0 = time.perf_counter()
    step = make_train_step(cfg, pcfg, total=POD_STEPS)
    state = init_state(0, cfg, device=dev)
    quiet, losses, gnorms, lrs = {}, [], [], []
    for batch in batches:
        _, g = grad_fn(state.params, batch)
        for k, v in flatten_paths(g).items():
            q = v.abs() <= POD_NOISE * v.abs().max()
            quiet[k] = q if k not in quiet else quiet[k] | q
        del g
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
    return {"state": state, "quiet": quiet, "losses": losses,
            "grad_norms": gnorms, "lrs": lrs,
            "seconds": time.perf_counter() - t0}


def pod_compare(label, state, losses, gnorms, ref) -> dict:
    """A mode's state and metrics after POD_STEPS steps on the ranks
    against the single-process run (`pod_single_process`); raises past
    the POD_* bounds, returns the worst of each."""
    from repro_torch.models.common import flatten_paths
    rel = [abs(a - b) / abs(b) for a, b in zip(losses + gnorms,
                                               ref["losses"]
                                               + ref["grad_norms"])]
    worst = {"loss_gnorm_rel": max(rel)}
    trees = {"params": (state.params, ref["state"].params),
             "m": (state.opt.m, ref["state"].opt.m),
             "v": (state.opt.v, ref["state"].opt.v)}
    p_tol = POD_PARAM_TOL * max(ref["lrs"])
    excused = 0
    for part, (got, want) in trees.items():
        got, want = flatten_paths(got), flatten_paths(want)
        w_part = 0.0
        for k, w in want.items():
            d = (got[k] - w).abs()
            if part == "params":
                q = ref["quiet"][k]
                excused += int((q & (d > p_tol)).sum())
                err = float(d.masked_fill(q, 0).max()) / p_tol
            else:
                err = float(d.max()) / (POD_MV_TOL * float(w.abs().max()))
            w_part = max(w_part, err)
        worst[f"{part}_err_over_tol"] = w_part
    worst["params_excused"] = excused
    if not (worst["loss_gnorm_rel"] <= POD_REF_RTOL
            and all(worst[f"{p}_err_over_tol"] <= 1.0 for p in trees)):
        raise RuntimeError(f"pod_sync: {label} against the single-process "
                           f"run: {worst}")
    return worst


class Float32Cache:
    """A model module whose ``init_cache`` makes every float tensor of the
    cache float32: a float32 run held to 1e-5 without the bf16 cache's
    rounding, which turns float32 summation-order noise into whole bf16
    steps."""

    def __init__(self, model):
        self._model = model

    def __getattr__(self, name):
        return getattr(self._model, name)

    def init_cache(self, *args, **kw):
        import torch
        return {k: v.float() if torch.is_tensor(v) and v.is_floating_point()
                else v for k, v in self._model.init_cache(*args, **kw).items()}


def serve_mesh_checks(rank: int, world: int, dev, marks: dict,
                      t_spawn: float) -> dict:
    """Phase `serve_mesh`'s work in one rank of `pod_sync`'s spawn: for
    each of SM_RUNS on a SM_MESH mesh and each of SM_WIDE_RUNS on a
    SM_WIDE_MESH one, full width from seed-0 weights, every policy
    through ``Engine(..., mesh=...)``, bf16 and float32; the kernels'
    launch counters reset just before each run and read just after
    (flash once per attention layer, decode and its combine once per
    attention layer and step: exact, per rank), the q / KV heads of
    every launch (this rank's share under MLR, or every head where the
    cache's sequence is cut), the decode steps' CommLog against
    ``serve_policies.decode_comm`` (exact), each step's wall time and
    staged bytes; over a sequence-sharded cache every cross-rank combine
    of the run's first decode step bit-identical to
    ``ref.combine_splits`` on the same gathered partials.  Rank 0 gathers
    every run's logits, tokens and routing and holds them to one
    process's `Engine` (`sm_compare`); in bf16 a MoE's one-process run
    takes the mesh run's experts (as serve_moe's plain paths take the
    kernel path's: bf16 rounding of the ranks' sums flips near-tie
    routes in every request), its weights its own probabilities at
    them."""
    import torch

    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.core.comm import axis_sizes
    from repro_torch.kernels.decode_attention import kernel as dec_kernel
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import common as cm
    from repro_torch.models import get_model, make_batch, moe
    from repro_torch.serve.engine import Engine, ServeConfig

    def sync():
        torch.cuda.synchronize(dev)

    torch.cuda.empty_cache()
    heads, routes, combines = [], [], []
    orig = (fa_ops.flash_attention, dec_ops.decode_attention,
            dec_ops.decode_attention_sharded, moe.route, dec_kernel.combine)

    def flash(q, k, v, **kw):
        heads.append(("flash", q.shape[2], k.shape[2]))
        return orig[0](q, k, v, **kw)

    def decode(q, k_cache, v_cache, lengths):
        heads.append(("decode", q.shape[2], k_cache.shape[2]))
        return orig[1](q, k_cache, v_cache, lengths)

    def decode_sharded(q, k_block, v_block, lengths, start, gather):
        heads.append(("decode", q.shape[2], k_block.shape[2]))
        return orig[2](q, k_block, v_block, lengths, start, gather)

    check_combines = [0]     # cross-rank combines left to hold bit for bit

    def combine(m, l, acc, dtype):
        o = orig[4](m, l, acc, dtype)
        if check_combines[0] > 0:
            check_combines[0] -= 1
            want = dec_ref.combine_splits(m, l, acc, dtype)
            combines.append(bool(torch.equal(o, want.reshape(o.shape))))
        return o

    forced = []

    def route(x, w, cfg, *stats):
        top_w, top_ids, aux = orig[3](x, w, cfg, *stats)
        if forced:                      # the mesh run's experts
            top_ids = forced.pop(0).to(top_ids.dtype)
            probs = torch.softmax(x.float() @ w.float(), dim=-1)
            top_w = probs.gather(-1, top_ids)
            top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
        routes.append(top_ids.sort(-1).values)
        return top_w, top_ids, aux

    (fa_ops.flash_attention, dec_ops.decode_attention,
     dec_ops.decode_attention_sharded, moe.route, dec_kernel.combine) = (
        flash, decode, decode_sharded, route, combine)
    import numpy as np
    prompt = np.random.default_rng(3).integers(0, 32000, (SM_BATCH,
                                                          SM_PROMPT))
    out = {}
    try:
        for mesh_shape, runs in ((SM_MESH, SM_RUNS),
                                 (SM_WIDE_MESH, SM_WIDE_RUNS)):
            mesh = make_test_mesh(*mesh_shape, device_type=dev.type)
            sizes = axis_sizes(mesh)
            for run_name, layers, policies in runs:
                arch, ssm_heads = SM_VARIANTS.get(run_name, (run_name, None))
                base = get_config(arch)
                if ssm_heads is not None:
                    base = dataclasses.replace(base, ssm=dataclasses.replace(
                        base.ssm, n_ssm_heads=ssm_heads))
                if layers is not None:
                    base = dataclasses.replace(base, n_layers=layers)
                if base.moe.n_experts:      # every assignment kept, as the
                    base = dataclasses.replace(  # one-process dense FFN
                        base, moe=dataclasses.replace(  # keeps
                            base.moe,
                            capacity_factor=float(base.moe.n_experts)))
                params = get_model(base).init(0, base, device=dev)
                if mesh_shape == SM_WIDE_MESH:    # the whole tree on the host
                    params = cm.map_tree(lambda t: t.cpu(), params)
                    torch.cuda.empty_cache()
                pcfg = ParallelConfig(attn_impl="pallas",
                                      moe_impl="shard_map", remat="none")
                for dtype in ("bfloat16", "float32"):
                    cfg = dataclasses.replace(base, dtype=dtype)
                    batch = {"tokens": torch.from_numpy(
                        prompt % cfg.vocab_size).to(torch.int32)}
                    if cfg.family == "encdec":
                        batch["enc_embed"] = make_batch(
                            3, cfg, SM_BATCH, SM_PROMPT, "prefill")[
                                "enc_embed"]
                    kept = sm_policies(policies, dtype)
                    for policy in kept + ("one",):
                        if policy == "one" and rank != 0:
                            continue
                        one = policy == "one"
                        eng = Engine(cfg, pcfg, ServeConfig(
                            max_seq=SM_MAX_SEQ,
                            policy="mlr" if one else policy),
                            params, mesh=None if one else mesh, device=dev)
                        if dtype == "float32":
                            eng.model = Float32Cache(eng.model)
                        logits, steps = [], []
                        for name in ("prefill_fn", "decode_fn"):
                            def rec(*a, _fn=getattr(eng, name), **kw):
                                cache, lg = _fn(*a, **kw)
                                logits.append(lg[:, -1].float())
                                return cache, lg
                            setattr(eng, name, rec)

                        def observer(kind, *, done, lengths, _eng=eng):
                            sync()
                            log = _eng.log
                            steps.append((time.perf_counter(),
                                          log.wire_bytes if log else 0,
                                          log.staged_bytes if log else 0,
                                          log.ops if log else 0))

                        heads.clear()
                        routes.clear()
                        combines.clear()
                        seq = sm_seq_sharded(cfg, policy, sizes)
                        check_combines[0] = sm_attention_layers(cfg) \
                            if seq else 0
                        if one and dtype == "bfloat16" and cfg.moe.n_experts:
                            forced[:] = out[f"{run_name}|{dtype}|mlr"][
                                "_keep"][2]
                        sync()
                        fa_kernel.flash_attention_fwd.launches = 0
                        dec_kernel.decode_attention.launches = 0
                        dec_kernel.decode_attention.combine_launches = 0
                        t0 = time.perf_counter()
                        new = SM_NEW_F32 if dtype == "float32" else \
                            SM_NEW_FSDP if mesh_shape == SM_MESH else SM_NEW
                        toks = eng.generate(batch, new, observer=observer)
                        sync()
                        wall = time.perf_counter() - t0
                        launches = [
                            fa_kernel.flash_attention_fwd.launches,
                            dec_kernel.decode_attention.launches,
                            dec_kernel.decode_attention.combine_launches]
                        label = f"{run_name}|{dtype}|{policy}"
                        run = sm_run_stats(label, cfg, policy, sizes,
                                           launches, heads, steps, wall, new,
                                           seq)
                        run["mesh"] = None if one else mesh_shape[0]
                        if seq:
                            if len(combines) != sm_attention_layers(cfg) \
                                    or not all(combines):
                                raise RuntimeError(
                                    f"serve_mesh: {label}: cross-rank "
                                    f"combines bit-identical to "
                                    f"ref.combine_splits: {combines}")
                            run["combines_bit_identical"] = len(combines)
                        lg = torch.stack(logits)           # (steps, B_l, V)
                        rt = list(routes)
                        if not one:               # the whole batch, rank 0
                            ctx = eng.ctx
                            lg = ctx.gather(lg, 1, ctx.batch_axes)
                            blk = moe._reference_block_axes(ctx, SM_BATCH)
                            rt = [ctx.gather(r, 0, blk) for r in rt]
                        if rank == 0:
                            run["_keep"] = (toks, lg, rt)
                        out[label] = run
                        del eng, lg, rt
                        torch.cuda.empty_cache()
                if rank == 0:
                    for dtype in ("bfloat16", "float32"):
                        want = out[f"{run_name}|{dtype}|one"].pop("_keep")
                        for policy in sm_policies(policies, dtype):
                            label = f"{run_name}|{dtype}|{policy}"
                            run = out[label]
                            run["vs_one_process"] = sm_compare(
                                label, run.pop("_keep"),
                                want, dtype, base.n_layers)
                del params
                torch.cuda.empty_cache()
                marks[f"serve_mesh_{run_name}"] = time.time() - t_spawn
    finally:
        (fa_ops.flash_attention, dec_ops.decode_attention,
         dec_ops.decode_attention_sharded, moe.route,
         dec_kernel.combine) = orig
    return out


def sm_policies(policies: tuple, dtype: str) -> tuple:
    """The policies of a `serve_mesh` run in `dtype` (SM_F32_POLICIES)."""
    if dtype == "float32":
        return tuple(p for p in policies if p in SM_F32_POLICIES)
    return policies


def sm_attention_layers(cfg) -> int:
    """The attention layers that read the KV cache in one step of `cfg`:
    every layer of a transformer or whisper's decoder, zamba's
    shared-block sites, none in RWKV-6."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def sm_seq_sharded(cfg, policy, sizes) -> bool:
    """True where the run's KV cache has its sequence cut over the mesh
    (MLR over 'model' sizes that the KV heads do not divide)."""
    return (policy == "mlr" and cfg.family != "ssm"
            and cfg.n_kv_heads % sizes["model"] != 0)


def sm_run_stats(label, cfg, policy, sizes, launches, heads, steps,
                 wall, new, seq=False) -> dict:
    """One `serve_mesh` run's checks on its rank: launches exact (flash once
    per attention layer that reads the cache, decode and its combine once
    per such layer and step), every launch on this rank's heads (MLR:
    the q and KV heads over 'model'; every head where the cache's
    sequence is cut, `seq`), the decode steps' wire bytes and calls
    equal to ``serve_policies.decode_comm`` (over a sequence-sharded
    cache its partials' gather counts the split kernel's splits per
    rank); its times and staged bytes."""
    from repro_torch.benchmarks import serve_policies
    n = sm_attention_layers(cfg)
    want = [n, n * (new - 1), n * (new - 1)]
    if launches != want:
        raise RuntimeError(f"serve_mesh: {label}: launches (flash, decode, "
                           f"combine) {launches}, want {want}")
    tp = sizes["model"] if policy == "mlr" and not seq else 1
    want_heads = (cfg.n_heads // tp, cfg.n_kv_heads // tp)
    if any(h[1:] != want_heads for h in heads) or len(heads) != sum(
            launches[:2]):
        raise RuntimeError(f"serve_mesh: {label}: kernel calls on heads "
                           f"{sorted(set(heads))}, want {want_heads}")
    dec = [tuple(y - x for x, y in zip(a, b))
           for a, b in zip(steps, steps[1:])]
    run = {"launches": launches, "heads": list(want_heads) if n else [],
           "wall_s": wall, "step_ms": [1e3 * d[0] for d in dec],
           "seq_sharded_cache": seq}
    if policy != "one":
        import torch
        splits = serve_policies.decode_splits(cfg, sizes, SM_BATCH, policy,
                                              SM_MAX_SEQ,
                                              torch.device("cuda", 0))
        wire, ops = serve_policies.decode_comm(
            cfg, sizes, SM_BATCH, policy, max_seq=SM_MAX_SEQ, splits=splits)
        got = {(d[1], d[3]) for d in dec}
        if got != {(wire, ops)}:
            raise RuntimeError(f"serve_mesh: {label}: decode steps' (wire "
                               f"bytes, calls) {sorted(got)}, the schedule "
                               f"says {(wire, ops)}")
        run.update(wire_bytes_per_tok=wire / SM_BATCH, calls_per_step=ops,
                   staged_bytes_per_step=dec[0][2], splits_per_rank=splits)
    return run


def sm_compare(label, got, want, dtype, layers) -> dict:
    """A mesh run (tokens, each step's logits and each route call's sorted
    top ids, the whole batch) against one process's: the requests whose
    routing differed (a flip reaches every later position of its request)
    counted from their first flip; float32: every (request, step) before
    a flip and before the first token difference within SM_LOGIT_TOL of
    the step's max |logit|, tokens equal but where a flip reaches; bf16:
    tokens equal up to the first difference of each request, which must
    be a near-tie of one process (top-2 gap <= SM_NEAR_TIE) or after a
    flip.  Raises past them; returns the worst gap and the counts."""
    import torch
    toks, lg, rt = got
    wtoks, wlg, wrt = want
    b, n = toks.shape
    flip = [SM_PROMPT + n] * b          # first position a flip reaches
    for j, (r, w) in enumerate(zip(rt, wrt)):
        call = j // layers              # 0: prefill, t: decode step t
        diff = (r != w).any(-1).reshape(b, -1).cpu()
        for lane in range(b):
            hit = torch.nonzero(diff[lane]).flatten()
            if len(hit):
                pos = int(hit[0]) + (0 if call == 0 else SM_PROMPT + call - 1)
                flip[lane] = min(flip[lane], pos)
    worst, held, excused, ties = 0.0, 0, 0, 0
    for lane in range(b):
        for t in range(n):
            pos = SM_PROMPT - 1 + t     # the position step t's logits read
            same = bool((toks[lane, :t] == wtoks[lane, :t]).all())
            if not same or pos >= flip[lane]:
                excused += 1
                continue
            if dtype == "float32":
                gap = float((lg[t, lane] - wlg[t, lane]).abs().max())
                scale = float(wlg[t].abs().max())
                if not gap <= SM_LOGIT_TOL * scale:
                    raise RuntimeError(f"serve_mesh: {label}: request "
                                       f"{lane} step {t} logits {gap} from "
                                       f"one process's (tolerance "
                                       f"{SM_LOGIT_TOL} x {scale})")
                worst = max(worst, gap / scale)
            if toks[lane, t] != wtoks[lane, t]:
                top2 = wlg[t, lane].topk(2).values
                tie = SM_NEAR_TIE if dtype != "float32" else \
                    2 * SM_LOGIT_TOL * float(wlg[t].abs().max())
                if float(top2[0] - top2[1]) > tie:
                    raise RuntimeError(f"serve_mesh: {label}: request "
                                       f"{lane} step {t} token "
                                       f"{int(toks[lane, t])} vs one "
                                       f"process's {int(wtoks[lane, t])} "
                                       f"(top-2 gap {float(top2[0] - top2[1])})")
                ties += 1
            held += 1
    return {"worst_logit_gap_over_max": worst if dtype == "float32"
            else "not held (bf16: tokens)", "positions_held": held,
            "positions_after_a_flip_or_token_difference": excused,
            "near_tie_token_differences": ties,
            "requests_with_router_flips": sum(f < SM_PROMPT + n
                                              for f in flip)}


def kdim_rank(rank: int, world: int, init: str, out_dir: str,
              t_spawn: float) -> None:
    """One rank of phase `serve_kdim`, in a spawned process, the card
    shared with the others: its gloo process group, `kdim_checks`, the
    results as ``rank<r>.json`` in `out_dir`.  A failed check raises,
    which fails the spawn and the phase."""
    import datetime

    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    marks = {"started": time.time() - t_spawn}
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        res = kdim_checks(rank, dev, marks, t_spawn)
        pathlib.Path(out_dir, f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def kdim_checks(rank: int, dev, marks: dict, t_spawn: float) -> dict:
    """Phase `serve_kdim`'s work in one rank of a KD_MESH mesh: this
    rank's blocks of rwkv6-3b's seed-0 params drawn a leaf at a time
    (`serve_policies.host_params`), then under MLR a bf16 run and a
    float32 one (a float32 state) through ``Engine(..., local=True)``,
    the kernels' launch counters reset just before each and read just
    after (serving RWKV-6 launches none), every decode step's CommLog
    against ``serve_policies.decode_comm`` (exact), each step's wall
    time.  Rank 0 also serves the whole tree in one process and holds
    every run to it (`sm_compare`)."""
    import torch

    from repro_torch.benchmarks import serve_policies
    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.core import partitioning as part
    from repro_torch.core.comm import axis_sizes
    from repro_torch.kernels.decode_attention import kernel as dec_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import common as cm
    from repro_torch.models import get_model
    from repro_torch.serve.engine import Engine, ServeConfig, param_specs

    def sync():
        torch.cuda.synchronize(dev)

    def mark(part_name):
        sync()
        marks[part_name] = time.time() - t_spawn

    mesh = make_test_mesh(*KD_MESH, device_type=dev.type)
    sizes = axis_sizes(mesh)
    base = dataclasses.replace(get_config(RWKV_ARCH), n_layers=KD_LAYERS,
                               dtype="float32")
    specs = cm.flatten_paths(param_specs(base, "mlr", mesh))
    coord = {a: int(c) for a, c in zip(mesh.mesh_dim_names,
                                        mesh.get_coordinate())}
    blocks = serve_policies.host_params(
        base, dev, block=lambda path, leaf: part.local_shard(
            leaf, specs[path], mesh, coord))
    whole = get_model(base).init(0, base, device=dev) if rank == 0 else None
    mark("params")
    import numpy as np
    prompt = np.random.default_rng(3).integers(0, 32000, (SM_BATCH,
                                                          SM_PROMPT))
    pcfg = ParallelConfig(attn_impl="pallas", remat="none")
    out, keep = {}, {}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(base, dtype=dtype)
        batch = {"tokens": torch.from_numpy(prompt % cfg.vocab_size).to(
            torch.int32)}
        new = SM_NEW if dtype == "bfloat16" else SM_NEW_F32
        for policy in ("mlr", "one") if rank == 0 else ("mlr",):
            one = policy == "one"
            eng = Engine(cfg, pcfg, ServeConfig(max_seq=SM_MAX_SEQ,
                                                policy="mlr"),
                         whole if one else blocks,
                         mesh=None if one else mesh, device=dev,
                         local=not one)
            if dtype == "float32":
                eng.model = Float32Cache(eng.model)
            logits, steps, states = [], [], set()
            for name in ("prefill_fn", "decode_fn"):
                def rec(*a, _fn=getattr(eng, name), **kw):
                    states.add(tuple(a[2]["wkv"].shape))
                    cache, lg = _fn(*a, **kw)
                    logits.append(lg[:, -1].float())
                    return cache, lg
                setattr(eng, name, rec)

            def observer(kind, *, done, lengths, _eng=eng):
                sync()
                log = _eng.log
                steps.append((time.perf_counter(),
                              log.wire_bytes if log else 0,
                              log.staged_bytes if log else 0,
                              log.ops if log else 0))

            sync()
            fa_kernel.flash_attention_fwd.launches = 0
            dec_kernel.decode_attention.launches = 0
            dec_kernel.decode_attention.combine_launches = 0
            t0 = time.perf_counter()
            toks = eng.generate(batch, new, observer=observer)
            sync()
            wall = time.perf_counter() - t0
            launches = [fa_kernel.flash_attention_fwd.launches,
                        dec_kernel.decode_attention.launches,
                        dec_kernel.decode_attention.combine_launches]
            label = f"{RWKV_ARCH}|{dtype}|{policy}"
            shape = get_model(cfg).cache_shapes(cfg, SM_BATCH,
                                                SM_MAX_SEQ)["wkv"]
            if not one:              # the k dim of every head cut
                shape = shape[:3] + (shape[3] // sizes["model"], shape[4])
            if states != {shape}:
                raise RuntimeError(f"serve_kdim: {label}: WKV states "
                                   f"{states}, want {shape}")
            run = sm_run_stats(label, cfg, policy, sizes, launches, [],
                               steps, wall, new)
            run["wkv_state"] = list(shape)
            run["mesh"] = None if one else KD_MESH[0]
            if rank == 0:
                keep[label] = (toks, torch.stack(logits), [])
            out[label] = run
            del eng
            torch.cuda.empty_cache()
        mark(f"serve_kdim_{dtype}")
    if rank == 0:
        for dtype in ("bfloat16", "float32"):
            label = f"{RWKV_ARCH}|{dtype}|mlr"
            out[label]["vs_one_process"] = sm_compare(
                label, keep[label], keep[f"{RWKV_ARCH}|{dtype}|one"], dtype,
                KD_LAYERS)
    out["marks_s"] = marks
    return out


#: each phase's seconds, in order
PHASE_S: dict = {}


def phase(name):
    """Decorator: run the phase, print its line with its seconds."""
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out, msg = fn(*a, **kw)
            PHASE_S[name] = time.perf_counter() - t0
            print(f"[{name}] {msg} ({PHASE_S[name]:.2f} s)", flush=True)
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
    time repeats its kernels'.  The windows trace the device alone
    (``ProfilerActivity.CUDA``): the same device events as with the
    host's ops traced too, without the host trace's processing, which
    grows with the host's op count (a zamba2-7b train step's busy time,
    H100: 1596.1 ms traced with the host, phase `train_hybrid` 84.1 s;
    1586.0 ms without it, 32.6 s)."""
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
    from repro_torch.core.smla.traces import WORKLOADS, WorkloadSpec
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.decode_attention import kernel as dec_kernel
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.benchmarks import (decode_bench, paper_fig_serve,
                                        smla_pipe_bench, wkv6_bench)
    from repro_torch.kernels.smla_pipe import kernel as pipe_kernel
    from repro_torch.kernels.smla_pipe import ref as pipe_ref
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6 import ref as wkv_ref
    from repro_torch.models import rwkv6
    from repro_torch.launch import train as launch_train
    from repro_torch.models import common as cm
    from repro_torch.models import get_model, logits_fn, make_batch
    from repro_torch.models import moe as moe_mod
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
        # the bucketed plan (one launch per makespan bucket, each timed
        # alone) and the grid as one launch at one chunk width (one
        # bucket, no makespan batching), for the record, on the README
        # grid's cells of RETIME_WORKLOADS: their chunks and every metric
        # must equal the main path's on those cells
        t_re = time.perf_counter()
        few = [c for c in cells if c.name.split("/")[-1] in RETIME_WORKLOADS]
        few_spec = sweep.SweepSpec(tuple(few), engine.SimOptions(
            horizon=default_horizon(few)))
        few_res = sweep.run_sweep(few_spec)
        bucket_ms, bucketed = timed_buckets(few_spec)
        same_sweep(bucketed, few_res, "grid bucketed vs one launch per "
                   "group")
        (one,) = sweep._plan(dataclasses.replace(
            few_spec, makespan_batching=False), few_spec.options, few,
            "cuda")
        one_ms, one_out = launch_bucket(one, few_spec.options.horizon, core)
        compare({k: v.cpu() for k, v in one_out.items()},
                {k: torch.from_numpy(np.stack([few_res[one.group[j].name][k]
                                               for j in one.positions]))
                 for k in one_out}, "grid as one launch",
                skip=("chunks_run",))
        retime_s = time.perf_counter() - t_re
        stats = {
            "cells": len(res.names), "horizon": horizon, "wall_s": wall,
            "cells_per_s": len(res.names) / wall, "launches": launches,
            "shape_groups": groups, "buckets": len(res.buckets),
            "grid_kernel_ms": grid_ms, "group_ms": group_ms,
            "retime_cells": len(few), "retime_s": retime_s,
            "retime_bucketed_ms": sum(bucket_ms),
            "retime_one_launch_ms": one_ms, "one_launch_chunk": one.chunk,
            **cycle_times(res, cells, grid_ms),
            "chunks_run_sum": int(sc["chunks_run"].sum()),
            "retime_bucket_ms": bucket_ms,
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
                       f"per shape group (on {len(few)} of its cells: "
                       f"{stats['retime_bucketed_ms']:.3f} ms over "
                       f"{len(bucket_ms)} bucket launches, {one_ms:.3f} ms "
                       f"as one launch at one width, {retime_s:.2f} s), "
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
        for b, hq, hkv, hd in ATTN_SHAPES:
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
        dec_splits = {}
        for (b, hq, hkv, hd), dt, smax in (
                (shape, dt, smax) for shape in ATTN_SHAPES if shape[0] == 8
                for dt in (bf16, f32) for smax in (512, 300)):
            q = randn(gen, (b, 1, hq, hd), dt)
            kc = randn(gen, (b, smax, hkv, hd), dt)
            vc = randn(gen, (b, smax, hkv, hd), dt)
            # 63: one below a chunk boundary; 1; full; odd lengths
            lens = torch.tensor([smax, 1, 63, 64, 65, 200, smax - 1,
                                 129], dtype=torch.int32, device=dev)
            what = f"decode B{b} Hq{hq} Hkv{hkv} hd{hd} Smax {smax} {dt}"
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
            dec_splits[f"Hq{hq} Hkv{hkv} hd{hd} Smax{smax}"] = m.shape[2]
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
        # zamba2-7b's shared attention (hd 112, the padded path) at
        # serve_hybrid's shapes, timed as above: its prefill (8 x 256,
        # 32/32 heads) and a decode step at length 288 of 512
        q, k, v = (randn(gen, (SERVE_BATCH, SERVE_PROMPT, 32, 112), bf16)
                   for _ in range(3))
        tq, tk, tv = (x.transpose(1, 2) for x in (q, k, v))
        fa112 = {"ms": cuda_ms(lambda: fa_kernel.flash_attention_fwd(
                     q, k, v), reps=5, calls=20)[0],
                 "plain_ms": cuda_ms(lambda: flash_plain(q, k, v), reps=3,
                                     calls=5)[0],
                 "library_ms": cuda_ms(lambda: sdpa(tq, tk, tv,
                                                    is_causal=True),
                                       reps=5, calls=20)[0]}
        fa112["bound_ms"], fa112["bound_by"] = attn_bound_ms(
            *flash_work(q, k))
        bench = decode_bench.run(HYBRID_DECODE)
        qd, kc, vc, lens = decode_bench.inputs(*HYBRID_DECODE)
        de112 = {"ms": bench["kernel_ms"],
                 "device_ms": bench["kernel_device_ms"],
                 "profiled_ms": bench["kernel_profiled_ms"],
                 "plain_ms": cuda_ms(lambda: decode_plain(qd, kc, vc, lens),
                                     reps=3, calls=5)[0],
                 "library_ms": bench["sdpa_ms"],
                 "library_device_ms": bench["sdpa_device_ms"],
                 "splits": dec_kernel.layout(qd, kc, vc, lens).ints[-2]}
        de112["bound_ms"], de112["bound_by"] = attn_bound_ms(
            *decode_work(qd, kc, lens))
        out = {"flash": fa, "decode": de, "combine": co,
               "flash_hd112": fa112, "decode_hd112": de112}
        print(json.dumps({"attn_parity": out}), flush=True)
        return out, (f"{n} kernel-vs-plain checks passed (max abs err "
                     f"flash {attn_err['flash']}, decode "
                     f"{attn_err['decode']}; the decode combine "
                     f"bit-identical); flash {fa['ms']:.4f} ms, decode "
                     f"{de['ms']:.4f} ms per call, device "
                     f"{de['device_ms']:.4f} ms ({de['splits']} splits; "
                     f"SDPA {de['library_ms']:.4f}, device "
                     f"{de['library_device_ms']:.4f}), combine "
                     f"{co['device_ms']:.4f} ms on the device; hd 112: "
                     f"flash {fa112['ms']:.4f} ms (SDPA "
                     f"{fa112['library_ms']:.4f}), decode device "
                     f"{de112['device_ms']:.4f} ms (SDPA "
                     f"{de112['library_device_ms']:.4f})")

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
                    # the forward at the training paths' shapes too, at
                    # attn_parity's bounds
                    want_o, want_lse = flash_plain(q, k, v, causal)
                    what = (f"flash B{b} S{s_len} Hq{hq} Hkv{hkv} hd{hd} "
                            f"{dt} causal={causal}")
                    check(max_abs(o, want_o), 1e-5 if dt == f32 else
                          BF16_TOL * float(want_o.float().abs().max()),
                          what + " o", "flash")
                    check(max_abs(lse, want_lse),
                          1e-5 if dt == f32 else 1e-4, what + " lse",
                          "flash")
                    del want_o, want_lse
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

        # the bf16 tensor-core kernels' edges, as in attn_parity, at every
        # head dim (hd 112: the padded tiles).  At S = 1, dq and dk are
        # zero in exact arithmetic and both sides hold only rounding
        # noise: there they are held to BF16_TOL of max |dv| instead of
        # their own max
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

        def times(b, s_len, hq, hkv, hd):
            """The backward kernel, its plain version and SDPA's backward,
            and the forward kernel, its plain version and SDPA's forward,
            at a training shape, bf16, causal; with their bounds."""
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
            t = {"ms": cuda_ms(lambda: fa_kernel.flash_attention_bwd(
                     q, k, v, o, lse, do), reps=5, calls=5)[0],
                 "plain_ms": cuda_ms(lambda: flash_bwd_plain(
                     q, k, v, o, lse, do), reps=3, calls=3)[0],
                 "library_ms": cuda_ms(lambda: torch.autograd.grad(
                     so, (tq, tk, tv), tdo, retain_graph=True),
                     reps=5, calls=5)[0],
                 "fwd_ms": cuda_ms(lambda: fa_kernel.flash_attention_fwd(
                     q, k, v), reps=5, calls=5)[0],
                 "fwd_plain_ms": cuda_ms(lambda: flash_plain(q, k, v),
                                         reps=3, calls=3)[0],
                 "fwd_library_ms": cuda_ms(lambda: sdpa(
                     tq, tk, tv, is_causal=True, enable_gqa=True),
                     reps=5, calls=5)[0]}
            t["bound_ms"], t["bound_by"] = attn_bound_ms(
                *flash_bwd_work(q, k))
            t["fwd_bound_ms"] = attn_bound_ms(*flash_work(q, k))[0]
            return t

        # times at the training paths' shapes: tinyllama's (hd 64, G 8)
        # and zamba2-7b's (hd 112, G 1)
        b, s_len, hq, hkv, hd = BWD_SHAPES[0]
        bw = times(*BWD_SHAPES[0])
        bw["hd112"] = h112 = times(*BWD_HD112)
        bw["autograd_rel_err"] = e2e[f32]
        bw["autograd_rel_err_bf16"] = e2e[bf16]
        print(json.dumps({"attn_bwd_parity": bw}), flush=True)
        return bw, (f"{n} backward checks passed (max relative err "
                    f"{bwd_err['max_rel']}, autograd {e2e[f32]} float32, "
                    f"{e2e[bf16]} bf16); bwd "
                    f"{bw['ms']:.4f} ms per call at B{b} S{s_len} Hq{hq} "
                    f"(plain {bw['plain_ms']:.4f}, SDPA backward "
                    f"{bw['library_ms']:.4f}, bound {bw['bound_ms']:.5f}); "
                    f"fwd {bw['fwd_ms']:.4f} ms (plain "
                    f"{bw['fwd_plain_ms']:.4f}, SDPA "
                    f"{bw['fwd_library_ms']:.4f}); hd 112 {BWD_HD112}: bwd "
                    f"{h112['ms']:.4f} ms (SDPA {h112['library_ms']:.4f}, "
                    f"bound {h112['bound_ms']:.5f}), fwd "
                    f"{h112['fwd_ms']:.4f} ms (plain "
                    f"{h112['fwd_plain_ms']:.4f}, SDPA "
                    f"{h112['fwd_library_ms']:.4f}, bound "
                    f"{h112['fwd_bound_ms']:.5f})")

    def decode_profile(eng, prefill_fn, decode_fn, batch, out, n=8):
        """`n` decode steps of the serving run (prompt `batch`, model
        inputs on the card) under torch.profiler: the window's wall time
        (the profiler slows the host), the device's busy time per step
        (the device events' own time: kernels, copies and fills) and the
        device events taking most of it."""
        from torch.profiler import ProfilerActivity, profile
        n = min(n, out.shape[1])
        with torch.inference_mode():
            cache = eng.model.init_cache(eng.cfg, out.shape[0],
                                         eng.scfg.max_seq, eng.pcfg,
                                         device=dev)
            cache, _ = prefill_fn(eng.params, batch, cache)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
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

    def attn_sites(cfg):
        """Causal self-attention layers of a model call: the hybrid
        family's shared-block sites (n_layers // attn_every), else one
        per (decoder) layer."""
        return (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
                else cfg.n_layers)

    def timed_serve(label, eng, batch, n_new, generate):
        """The timed serving run of `serve` and the serve_* family phases:
        `generate(batch, n_new)` (a call of ``eng.generate``; its result,
        or its result's first item, the (B, n_new) tokens) after a
        warm-up, every model call's last logits and CUDA-event time
        recorded, the kernels' launch counters reset just before and read
        just after (flash once per self-attention site, `attn_sites`,
        decode and its combine once per site and decode step: exact),
        tokens and logits checked, and the steady decode step profiled
        (`decode_profile`).  Returns
        (generate's result, the logits of each step, the run's stats)."""
        cfg = eng.cfg
        eng.generate(batch, 2)                       # warm-up, not counted

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
        torch.cuda.reset_peak_memory_stats(dev)
        fa_kernel.flash_attention_fwd.launches = 0
        dec_kernel.decode_attention.launches = 0
        dec_kernel.decode_attention.combine_launches = 0
        t0 = time.perf_counter()
        result = generate(batch, n_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out = result[0] if isinstance(result, tuple) else result
        launches = {"flash": fa_kernel.flash_attention_fwd.launches,
                    "decode": dec_kernel.decode_attention.launches,
                    "decode_combine":
                        dec_kernel.decode_attention.combine_launches}
        sites = attn_sites(cfg)
        want = {"flash": sites, "decode": sites * (n_new - 1),
                "decode_combine": sites * (n_new - 1)}
        if launches != want:
            raise RuntimeError(f"{label}: kernel launches {launches}, want "
                               f"{want}")
        b = batch["tokens"].shape[0]
        if tuple(out.shape) != (b, n_new) or not (
                (out >= 0) & (out < cfg.vocab_size)).all():
            raise RuntimeError(f"{label}: bad tokens {tuple(out.shape)}")
        if not all(bool(torch.isfinite(lg).all()) for lg in logits):
            raise RuntimeError(f"{label}: non-finite logits")
        times = {k: [e0.elapsed_time(e1) for kk, e0, e1 in events if kk == k]
                 for k in ("prefill", "decode")}
        profile = decode_profile(eng, prefill_fn, decode_fn, batch, out)
        busy = profile["device_busy_ms_per_step"]
        # idle share of an unprofiled decode step of the main run
        profile["device_idle_share"] = (
            1 - busy * len(times["decode"]) / sum(times["decode"])
            if busy != "not measured" else busy)
        return result, logits, {
            "launches": launches, "wall_s": wall,
            "prefill_ms": times["prefill"][0],
            "decode_ms_per_step": sum(times["decode"]) / len(times["decode"]),
            "tokens_per_s": b * n_new / wall, "decode_profile": profile,
            "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}

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
        batch = {"tokens": torch.from_numpy(tokens).to(dev)}
        (out, cap), logits, run = timed_serve(
            "serve", eng, batch, SERVE_NEW,
            lambda b, n: bridge.capture_generate(eng, b, n))

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
                    cache, last = model.prefill(params, batch, cache,
                                                rcfg, pc)
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
              "prompt": SERVE_PROMPT, "new_tokens": SERVE_NEW, **run,
              "vs_plain": gaps, "bf16_tolerance": tol16, "card": smi}
        print(json.dumps({"serve": st}), flush=True)
        return (cap, st), (
            f"{SERVE_ARCH} B{SERVE_BATCH} prompt {SERVE_PROMPT} +"
            f"{SERVE_NEW}: prefill {st['prefill_ms']:.3f} ms, decode "
            f"{st['decode_ms_per_step']:.3f} ms/step, "
            f"{st['tokens_per_s']:.1f} tok/s ({smi}); launches "
            f"{st['launches']}; "
            f"logits vs plain {gaps['kernel_vs_naive']:.5f} (bf16, floor "
            f"{gaps['chunked_vs_naive']:.5f}), "
            f"{gaps['kernel_f32_vs_plain_f32']:.6f} (float32)")

    @phase("serve_sim")
    def serve_sim(cap):
        # paper_fig_serve's grid for this capture: its three traffic
        # classes x cascaded MLR/SLR x POLICY_PRESETS
        prof = bridge.StreamProfile.from_capture(cap)
        spec = paper_fig_serve.grid(prof, 600)
        horizon = spec.options.horizon
        banks = spec.cells[0].stack.banks_per_rank
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
        # the bucketed plan, for the record, on the same grid at n_req
        # RETIME_SERVE_REQ: equal to the main path's on it
        t_re = time.perf_counter()
        few_spec = paper_fig_serve.grid(prof, RETIME_SERVE_REQ)
        bucket_ms, bucketed = timed_buckets(few_spec)
        same_sweep(bucketed, sweep.run_sweep(few_spec),
                   "serve_sim bucketed vs one launch per group")
        retime_s = time.perf_counter() - t_re
        # one class x both organisations, default policy, n_req 120:
        # kernel against the plain engine on the card
        small = list(paper_fig_serve.grid(prof, 120).cells[:2])
        if banks != 2:
            raise RuntimeError(f"serve_sim: {banks} banks per rank")
        kernel_vs_plain(small, default_horizon(small), 256,
                        engine.CoreParams(), "serve_sim decode_steady x orgs")
        st = {"cells": len(res.names), "horizon": horizon,
              "launches": launches, "shape_groups": groups,
              "buckets": len(res.buckets), "wall_s": wall,
              "kernel_ms": kernel_ms, "retime_n_req": RETIME_SERVE_REQ,
              "retime_bucketed_ms": sum(bucket_ms), "retime_s": retime_s,
              **cycle_times(res, sweep._sweep_cells(spec), kernel_ms),
              "profile": dataclasses.asdict(prof),
              "mean_bandwidth_gbps": float(sc["bandwidth_gbps"].mean())}
        print(json.dumps({"serve_sim": st}), flush=True)
        return st, (f"{len(res.names)} cells in {wall:.3f} s, {launches} "
                    f"launch(es), one per shape group, kernel "
                    f"{kernel_ms:.3f} ms (at n_req {RETIME_SERVE_REQ}: "
                    f"{st['retime_bucketed_ms']:.3f} ms over "
                    f"{len(bucket_ms)} bucket launches, {retime_s:.2f} s), "
                    f"{st['us_per_cycle']:.4f} us per cycle of the slowest "
                    f"cell; kernel == plain on {len(small)} cells at n_req "
                    f"120")

    def vlm_positions(b, s):
        """(3, b, s) M-RoPE ids of prompts laid out as Qwen2-VL lays out
        an image (arXiv:2409.12191 §2.1): lane i has 4 + 4i text tokens,
        then a VLM_GRID block of image tokens (one temporal id, height and
        width ids along the grid, all from the block's start), then text
        whose three ids continue from the block's largest id + 1."""
        gh, gw = VLM_GRID
        out = np.zeros((3, b, s), np.int32)
        r, c = np.divmod(np.arange(gh * gw), gw)
        for i in range(b):
            pre = 4 + 4 * i
            out[:, i, :pre] = np.arange(pre)
            blk = slice(pre, pre + gh * gw)
            out[0, i, blk] = pre
            out[1, i, blk] = pre + r
            out[2, i, blk] = pre + c
            rest = s - pre - gh * gw
            out[:, i, pre + gh * gw:] = pre + max(gh, gw) + np.arange(rest)
        if (out[0] == out[1]).all() or (out[1] == out[2]).all():
            raise RuntimeError("serve_vlm: the M-RoPE streams are equal")
        return torch.from_numpy(out).to(dev)

    @contextlib.contextmanager
    def routed(records, forced=None):
        """`moe.route` records (x, w_router, its own top_ids) of every
        call; with `forced` (per layer, the (B, T, k) experts of another
        path), each call returns those experts instead, weighted by its
        own probabilities renormalised as `route` does, so both paths run
        the same routing and differ only by rounding."""
        orig = moe_mod.route

        def route(x, w, cfg):
            top_w, ids, aux = orig(x, w, cfg)
            records.append((x, w, ids))
            if forced is not None:
                ids = forced[(len(records) - 1) % len(forced)]
                top_w = torch.softmax(torch.matmul(x.float(), w.float()),
                                      -1).gather(-1, ids)
                top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
            return top_w, ids, aux
        moe_mod.route = route
        try:
            yield
        finally:
            moe_mod.route = orig

    def routing(records, n_layers):
        """Per layer, (probabilities (B, T, E), chosen experts (B, T, k))
        over every token a path routed, in order (one `route` call per
        layer per model call); the probabilities recomputed as `route`
        computes them."""
        return [(torch.cat([torch.softmax(torch.matmul(x.float(), w.float()),
                                          -1) for x, w, _ in calls], 1),
                 torch.cat([ids for _, _, ids in calls], 1))
                for calls in (records[i::n_layers] for i in range(n_layers))]

    def route_diff(a, b):
        """Path a's router decisions against path b's (`routing` lists):
        (flipped (L, B, T): another expert set, b's gap between its k-th
        and (k+1)-th probability (L, B, T), max |a - b| of the
        probabilities (L, B, T))."""
        flip, gap, dp = [], [], []
        for (pa, ia), (pb, ib) in zip(a, b):
            k = ia.shape[-1]
            flip.append((ia.sort(-1).values != ib.sort(-1).values).any(-1))
            top = pb.topk(k + 1, dim=-1).values
            gap.append(top[..., k - 1] - top[..., k])
            dp.append((pa - pb).abs().amax(-1))
        return torch.stack(flip), torch.stack(gap), torch.stack(dp)

    def downstream(flip):
        """(L, B, T) decisions whose router input a flip can have moved:
        a flip at (layer l, token t) reaches every later layer at tokens
        >= t (the residual, then attention)."""
        seen = flip.cummax(0).values
        after = torch.zeros_like(flip)
        after[1:] = seen[:-1]
        return after.cummax(2).values

    def near_ties(kc, nc, what, forced=False):
        """The kernel path's router flips against the chunked plain path
        (`kc`, `route_diff`), held to the two plain paths' own (`nc`,
        naive against chunked): no more flips than 1.5 x the plain paths'
        count or FLIP_FRAC of the decisions, and each flip whose inputs
        differ by rounding only a near-tie: the plain path's k-th and
        (k+1)-th probabilities within twice the path's rounding, 1.5 x the
        plain paths' largest probability difference at decisions no flip
        reaches.  Inputs differ by rounding only at every flip when the
        plain paths ran the kernel path's experts (`forced`), else at the
        flips no earlier flip reaches (`downstream`)."""
        n_dec = kc[0].numel()
        if forced:
            primary, clean = kc[0], ~(kc[0] | nc[0])
        else:
            reached = downstream(kc[0]) | downstream(nc[0])
            primary = kc[0] & ~reached
            clean = ~(reached | kc[0] | nc[0])
        noise = float(nc[2][clean].max()) if clean.any() else 0.0
        rounding = 1.5 * noise
        gaps = kc[1][primary]
        st = {"decisions": n_dec, "flips": int(kc[0].sum()),
              "flips_checked": int(primary.sum()),
              "tokens_flipped": int(kc[0].any(0).sum()),
              "plain_flips": int(nc[0].sum()),
              "prob_noise_plain": noise, "rounding": rounding,
              "prob_gap_kernel_vs_plain": float(kc[2][clean].max())
              if clean.any() else 0.0,
              "max_gap_at_checked_flip": float(gaps.max()) if gaps.numel()
              else 0.0}
        allowed = max(1.5 * st["plain_flips"], FLIP_FRAC * n_dec)
        if (st["flips"] > allowed
                or st["max_gap_at_checked_flip"] > 2 * rounding):
            raise RuntimeError(f"{what}: router flips {st} (allowed "
                               f"{allowed} flips, gaps <= {2 * rounding})")
        return st

    def serve_family(label, cfg, batch, n_new, schedule_floor=False):
        """`cfg` (random weights from seed 0) served through `Engine` with
        attn_impl "pallas": the prompt `batch` (model inputs on the card)
        and `n_new` greedy tokens, launch counters reset just before and
        read just after, timed as `serve` times; then held against the
        plain full forward (no cache, attn_impl "chunked") on the same
        tokens: in bf16 within max(SERVE_TOL, 1.5 x naive vs chunked), a
        MoE's plain forwards taking the kernel path's experts; in float32
        (the kernels' float32 builds, a float32 cache) within
        SERVE_TOL_F32 at every position no router flip reaches
        (`downstream`), routing left free.  With `schedule_floor` (the
        hybrid family, whose Mamba2 layers run another schedule and other
        GEMM shapes when cached: a chunked SSD over the prompt and a
        sequential step per token, against one pass over all tokens), the
        bf16 logits are also held to the plain paths on the kernel path's
        own schedule, within max(SERVE_TOL, 1.5 x their naive vs chunked),
        and the bound against the full forward admits 1.5 x the
        schedule's own distance from it (plain cached vs plain full, both
        chunked)."""
        model = get_model(cfg)
        moe = cfg.family == "moe"
        n_layers = cfg.n_layers
        gen = torch.Generator(device=dev).manual_seed(0)
        params = model.init(gen, cfg, device=dev)          # float32
        pc = ParallelConfig(attn_impl="pallas", moe_impl="dense",
                            remat="none")
        eng = Engine(cfg, pc, ServeConfig(max_seq=SERVE_MAX_SEQ, eos_id=-1),
                     params, device=dev)
        b, s = batch["tokens"].shape
        rec_k = []

        def generate(bt, n):
            with routed(rec_k) if moe else contextlib.nullcontext():
                return eng.generate(bt, n)
        out, logits, run = timed_serve(label, eng, batch, n_new, generate)
        kernel16 = torch.stack(logits, 1)            # (B, n_new, V)

        # the generated tokens teacher-forced through the plain full
        # forward (no cache): logits at the positions the kernel path
        # sampled from (the batch's other inputs, such as whisper's
        # frames, as they are)
        full = dict(batch, tokens=torch.cat([batch["tokens"], out[:, :-1]],
                                            1))
        if "positions" in batch:      # decode's ids: the cache position
            t = torch.arange(s, s + n_new - 1, dtype=torch.int32,
                             device=dev).expand(3, b, n_new - 1)
            full["positions"] = torch.cat([batch["positions"], t], 2)
        cfg32 = dataclasses.replace(cfg, dtype="float32")

        def in_dtype(inputs, rcfg):
            """Model inputs with their float tensors (frame embeddings) in
            `rcfg`'s compute dtype."""
            return {k: v.to(cm.compute_dtype(rcfg))
                    if v.is_floating_point() else v
                    for k, v in inputs.items()}

        def plain(impl, rcfg, prm, forced=None):
            rec = []
            with torch.inference_mode(), (
                    routed(rec, forced) if moe else contextlib.nullcontext()):
                h, _ = model.forward(prm, in_dtype(full, rcfg), rcfg,
                                     dataclasses.replace(pc,
                                                         attn_impl=impl))
                lg = logits_fn(prm, h[:, s - 1:], rcfg)
            return lg, routing(rec, n_layers) if moe else None

        def cached(impl, rcfg, prm):
            """`impl`'s path through prefill and every decode step (the
            kernel path's schedule), teacher-forced on the generated
            tokens, with a float32 cache (every float tensor of it) in a
            float32 config: each step's logits."""
            rec, steps = [], []
            pcx = dataclasses.replace(pc, attn_impl=impl)
            with torch.inference_mode(), (
                    routed(rec) if moe else contextlib.nullcontext()):
                cache = model.init_cache(rcfg, b, SERVE_MAX_SEQ, pcx,
                                         device=dev)
                if rcfg.dtype == "float32":
                    cache = {k: v.float() if torch.is_tensor(v)
                             and v.is_floating_point() else v
                             for k, v in cache.items()}
                cache, last = model.prefill(prm, in_dtype(batch, rcfg),
                                            cache, rcfg, pcx)
                steps.append(logits_fn(prm, last, rcfg)[:, -1])
                for t in range(n_new - 1):
                    cache, lg = model.decode(prm, out[:, t:t + 1], cache,
                                             rcfg, pcx)
                    steps.append(lg[:, -1])
            return torch.stack(steps, 1), (routing(rec, n_layers) if moe
                                           else None)

        every = torch.ones((b, n_new), dtype=torch.bool, device=dev)
        vs = {}
        # bf16: a MoE's plain paths run the kernel path's experts
        forced = [ids for _, ids in routing(rec_k, n_layers)] if moe else None
        c16, rc16 = plain("chunked", cfg, eng.params, forced)
        n16, rn16 = plain("naive", cfg, eng.params, forced)
        floor16 = max_abs(n16, c16)
        tol16 = max(SERVE_TOL, 1.5 * floor16)
        vs["bf16"] = {"kernel_vs_chunked": max_abs(kernel16, c16),
                      "naive_vs_chunked": floor16}
        if schedule_floor:
            # the plain paths on the kernel path's own schedule (prefill,
            # then a decode step per token): the kernels alone against
            # them, and the schedule's own bf16 noise against the full
            # forward, which the bound above then admits
            cc16, cn16 = (cached(impl, cfg, eng.params)[0]
                          for impl in ("chunked", "naive"))
            cfloor16 = max_abs(cn16, cc16)
            vs["bf16"].update(
                kernel_vs_cached_chunked=max_abs(kernel16, cc16),
                cached_naive_vs_cached_chunked=cfloor16,
                cached_tolerance=max(SERVE_TOL, 1.5 * cfloor16),
                cached_chunked_vs_chunked=max_abs(cc16, c16))
            tol16 = max(tol16, 1.5 * vs["bf16"]["cached_chunked_vs_chunked"])
            del cc16, cn16
        vs["bf16"]["tolerance"] = tol16
        vs["bf16"]["token_gap"] = float((c16.max(-1).values - c16.gather(
            -1, out[..., None].long())[..., 0]).max())
        if moe:
            rk = routing(rec_k, n_layers)
            vs["bf16"]["routing"] = near_ties(
                route_diff(rk, rc16), route_diff(rn16, rc16),
                f"{label} bf16", forced=True)
            # the same forward free to route: how far bf16 noise alone
            # moves the experts (reported)
            free = route_diff(rk, plain("chunked", cfg, eng.params)[1])[0]
            vs["bf16"]["free_running"] = {
                "flips": int(free.sum()),
                "tokens_flipped": int(free.any(0).sum()),
                "tokens": int(free[0].numel())}
            del rec_k, rk, forced, rc16, rn16
        # float32: routing free; logits held at the positions no flip
        # reaches (every layer agreed there and at every earlier token)
        k32, rk32 = cached("pallas", cfg32, params)
        c32, rc32 = plain("chunked", cfg32, params)
        n32, rn32 = plain("naive", cfg32, params)
        kept_pos = every
        if moe:
            kc, nc = route_diff(rk32, rc32), route_diff(rn32, rc32)
            vs["float32"] = {"routing": near_ties(kc, nc,
                                                   f"{label} float32")}
            kept_pos = ~(kc[0] | nc[0]).any(0).cummax(1).values[:, s - 1:]
        held = bool(kept_pos.any())
        vs.setdefault("float32", {}).update(
            kernel_vs_chunked=max_abs(k32[kept_pos], c32[kept_pos])
            if held else float("inf"),
            naive_vs_chunked=max_abs(n32[kept_pos], c32[kept_pos])
            if held else float("inf"),
            positions_held=int(kept_pos.sum()),
            positions=int(kept_pos.numel()))
        print(json.dumps({f"{label}_vs_plain": vs}), flush=True)
        g16, g32 = vs["bf16"], vs["float32"]
        if not (g16["kernel_vs_chunked"] <= tol16
                and g16["token_gap"] <= 2 * tol16
                and g16.get("kernel_vs_cached_chunked", 0.0)
                <= g16.get("cached_tolerance", 0.0)
                and g32["kernel_vs_chunked"] <= SERVE_TOL_F32
                and 2 * g32["positions_held"] >= g32["positions"]):
            raise RuntimeError(f"{label}: kernel path vs plain path {vs} "
                               f"(bf16 tolerance {tol16}, float32 "
                               f"{SERVE_TOL_F32} on at least half the "
                               f"positions)")
        return {"arch": cfg.name, "n_layers": n_layers,
                "params": cfg.n_params(), "batch": b, "prompt": s,
                "new_tokens": n_new, **run, "vs_plain": vs, "card": smi}

    def family_line(st):
        vs = st["vs_plain"]
        route = ""
        if "routing" in vs["bf16"]:
            r16, r32 = vs["bf16"]["routing"], vs["float32"]["routing"]
            route = (f"; router flips vs plain: bf16 {r16['flips']} of "
                     f"{r16['decisions']} (plain paths {r16['plain_flips']};"
                     f" near-tie gaps <= {r16['max_gap_at_checked_flip']:.2e}"
                     f"), float32 {r32['flips']}")
        if "kernel_vs_cached_chunked" in vs["bf16"]:
            route += (f"; bf16 vs the plain paths on its own schedule "
                      f"{vs['bf16']['kernel_vs_cached_chunked']:.5f} (floor "
                      f"{vs['bf16']['cached_naive_vs_cached_chunked']:.5f}"
                      f"), schedule vs full forward "
                      f"{vs['bf16']['cached_chunked_vs_chunked']:.5f}")
        return (f"{st['arch']} ({st['n_layers']} layers) B{st['batch']} "
                f"prompt {st['prompt']} +{st['new_tokens']}: prefill "
                f"{st['prefill_ms']:.3f} ms, decode "
                f"{st['decode_ms_per_step']:.3f} ms/step, "
                f"{st['tokens_per_s']:.1f} tok/s ({smi}); launches "
                f"{st['launches']}; logits vs plain "
                f"{vs['bf16']['kernel_vs_chunked']:.5f} (bf16, floor "
                f"{vs['bf16']['naive_vs_chunked']:.5f}), "
                f"{vs['float32']['kernel_vs_chunked']:.6f} (float32, "
                f"{vs['float32']['positions_held']}/"
                f"{vs['float32']['positions']} positions){route}")

    @phase("serve_moe")
    def serve_moe():
        cfg = get_config(MOE_ARCH)
        tokens = SyntheticLM(cfg.vocab_size, SERVE_PROMPT, SERVE_BATCH,
                             seed=7).batch(0)["tokens"]
        st = serve_family("serve_moe", cfg,
                          {"tokens": torch.from_numpy(tokens).to(dev)},
                          SERVE_NEW)
        print(json.dumps({"serve_moe": st}), flush=True)
        return st, family_line(st)

    @phase("serve_vlm")
    def serve_vlm():
        cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)
        tokens = SyntheticLM(cfg.vocab_size, SERVE_PROMPT, SERVE_BATCH,
                             seed=7).batch(0)["tokens"]
        st = serve_family("serve_vlm", cfg, {
            "tokens": torch.from_numpy(tokens).to(dev),
            "positions": vlm_positions(SERVE_BATCH, SERVE_PROMPT)}, VLM_NEW)
        print(json.dumps({"serve_vlm": st}), flush=True)
        return st, family_line(st)

    @phase("serve_hybrid")
    def serve_hybrid():
        cfg = dataclasses.replace(get_config(HYBRID_ARCH),
                                  n_layers=HYBRID_LAYERS)
        tokens = SyntheticLM(cfg.vocab_size, SERVE_PROMPT, SERVE_BATCH,
                             seed=7).batch(0)["tokens"]
        st = serve_family("serve_hybrid", cfg,
                          {"tokens": torch.from_numpy(tokens).to(dev)},
                          SERVE_NEW, schedule_floor=True)
        print(json.dumps({"serve_hybrid": st}), flush=True)
        return st, family_line(st)

    @phase("serve_encdec")
    def serve_encdec():
        cfg = get_config(ENCDEC_ARCH)
        batch = make_batch(0, cfg, SERVE_BATCH, ENCDEC_PROMPT, "prefill",
                           device=dev)
        batch["tokens"] = torch.from_numpy(SyntheticLM(
            cfg.vocab_size, ENCDEC_PROMPT, SERVE_BATCH,
            seed=7).batch(0)["tokens"]).to(dev)
        st = serve_family("serve_encdec", cfg, batch, SERVE_NEW)
        print(json.dumps({"serve_encdec": st}), flush=True)
        return st, family_line(st)

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

    def capture_inputs():
        """fig_serve's recorded capture: ``run()``'s params and batch on
        the card, and the tokens the reference generated."""
        from repro_torch.convert import params_from_reference
        with np.load(GOLDEN_CAPTURE) as z:
            flat = {k[len("params/"):]: z[k] for k in z.files
                    if k.startswith("params/")}
            tokens, generated = z["tokens"], z["generated"]
        params = params_from_reference(
            flat, paper_fig_serve.capture_config(), device=dev)
        return ({"params": params,
                 "batch": {"tokens": torch.from_numpy(tokens).to(dev)}},
                generated)

    def run_figure(section, gold):
        """One module of `FIGURES` through its ``run()`` on the card,
        every `run_sweep` recorded; held against its golden section
        (fig_serve's capture fed the reference's recorded inputs)."""
        import importlib
        mod_name, kw = FIGURES[section]
        if section == "fig_serve":
            inputs, generated = capture_inputs()
            kw = dict(kw, **inputs)
            captured = []
            orig_capture = paper_fig_serve._capture_profile

            def capture(*a, **k):
                out = orig_capture(*a, **k)
                captured.append(out[2])
                return out
            paper_fig_serve._capture_profile = capture
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
            if section == "fig_serve":
                paper_fig_serve._capture_profile = orig_capture
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
        # the capture's stats and profile are held in `extra` above; its
        # greedy tokens (a bf16 model, cuBLAS against XLA on a CPU) are
        # counted against the reference's, not held
        tokens = ({"tokens_differing_from_reference": int(
            (captured[0].cpu().numpy() != generated).sum())}
            if section == "fig_serve" else {})
        return {"cells": cells, "launches": launches, **tokens,
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
        """`paper_fig_scale.main()` at FIG_SCALE_SIZES on the card (fresh
        child processes), held against the golden's sizes and prune
        child, and the early-exit gate's fig_scale section on its
        record."""
        from repro_torch.benchmarks import assert_early_exit, paper_fig_scale
        with tempfile.TemporaryDirectory() as tmp:
            bench = os.path.join(tmp, "fig_scale.json")
            os.environ["BENCH_JSON"] = bench
            t0 = time.perf_counter()
            if paper_fig_scale.main(["--device", "cuda", "--sizes", *(
                    str(k) for k in FIG_SCALE_SIZES)]) != 0:
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
                     f"at {[10 * k for k in FIG_SCALE_SIZES]} cells "
                     f"equal the golden, best ratio "
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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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

    @contextlib.contextmanager
    def plain_flash():
        """The flash kernels' plain versions in their place, under the
        same autograd Function."""
        saved = (fa_kernel.flash_attention_fwd,
                 fa_kernel.flash_attention_bwd)
        fa_kernel.flash_attention_fwd = flash_plain
        fa_kernel.flash_attention_bwd = flash_bwd_plain
        try:
            yield
        finally:
            (fa_kernel.flash_attention_fwd,
             fa_kernel.flash_attention_bwd) = saved

    def train_checked(label, cfg, data, steps, first_batch):
        """`steps` steps of `cfg` from seed-0 weights through
        `launch/train.py`'s functions (`init_state`, `make_train_step`,
        `loop.train`; attn_impl "pallas", remat "full"), `data.batch(i)`
        step i's batch, checked: the flash kernels' launch counters reset
        just before and read just after, every step launching the forward
        twice per self-attention site (once more in its recompute) and
        the backward once (`attn_sites`); losses finite; step time
        (median of steps 3-6), tokens/s, peak memory and the busy share of
        one profiled step.  Then, from the trained weights and
        `first_batch(c)` (step 0's batch for config c, on the card): the
        bf16 loss of the kernel path against its plain versions, within
        the noise floor the phase measures (chunked vs naive); a float32
        replay of one step, the loss and every gradient leaf, kernels
        against their plain versions under the same Function.  Returns
        the run's stats."""
        pcfg = launch_train.PCFG
        # the earlier phases' cached blocks go back to the card first: a
        # cache fragmented by other shapes once left zamba2-7b's step
        # short of one contiguous 3 GB block
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        state = init_state(0, cfg, device=dev)
        step_fn = make_train_step(cfg, pcfg, total=steps)
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
                total_steps=steps, log_every=1),
            log=lambda line: print(f"  {line}", flush=True))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash": fa_kernel.flash_attention_fwd.launches,
                    "flash_bwd": fa_kernel.flash_attention_bwd.launches}
        # per step: the forward kernel once per site and once more in the
        # site's recompute (remat "full"), the backward once per site
        sites = attn_sites(cfg)
        want_step = (2 * sites, sites)
        want = {"flash": steps * want_step[0],
                "flash_bwd": steps * want_step[1]}
        if launches != want or any(c != want_step for c in per_step):
            raise RuntimeError(f"{label}: kernel launches {launches} (per "
                               f"step {per_step}), want {want}")
        losses = hist["losses"]
        if len(losses) != steps or not np.isfinite(losses).all():
            raise RuntimeError(f"{label}: losses {losses}")
        med_ms = 1e3 * float(np.median(hist["step_s"][2:]))  # steps 3-6
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        reserved_gb = torch.cuda.max_memory_reserved(dev) / 1e9
        free_gb = (torch.cuda.get_device_properties(dev).total_memory / 1e9
                   - reserved_gb)
        prof = step_profile(counted, state, data.batch(steps))
        busy = prof["device_busy_ms"]
        prof["device_busy_share"] = (busy / med_ms if busy != "not measured"
                                     else busy)

        # the trained weights and step 0's batch, forward only: the bf16
        # loss of the kernel path against its plain versions, and the bf16
        # noise floor (the reference's two plain paths, chunked vs naive)
        t_checks = time.perf_counter()
        batch0 = first_batch(cfg)
        model = get_model(cfg)

        def loss_of(impl="pallas", plain=False):
            pc = dataclasses.replace(pcfg, attn_impl=impl)
            with (plain_flash() if plain else contextlib.nullcontext()), \
                    torch.no_grad():
                h, _ = model.forward(state.params, batch0, cfg, pc)
                return float(chunked_lm_loss(state.params, h,
                                             batch0["labels"], cfg,
                                             chunk=pc.logit_chunk))
        l16 = {"kernel": loss_of(), "plain": loss_of(plain=True),
               "naive": loss_of("naive"), "chunked": loss_of("chunked")}
        floor16 = abs(l16["chunked"] - l16["naive"])
        tol16 = max(TRAIN_LOSS_TOL_BF16, 1.5 * floor16)
        gap16 = abs(l16["kernel"] - l16["plain"])

        # float32 replay at full width: one step's loss and every gradient
        # leaf with the kernels against the same with their plain versions
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        grad32 = make_grad_fn(cfg32, pcfg)
        batch32 = first_batch(cfg32)
        (lk, _), gk = grad32(state.params, batch32)
        with plain_flash():
            (lp, _), gp = grad32(state.params, batch32)
        loss_err32 = abs(float(lk) - float(lp)) / abs(float(lp))
        flat_p = cm.flatten_paths(gp)
        grad_err32 = {name: rel_err(g, flat_p[name])
                      for name, g in cm.flatten_paths(gk).items()}
        worst32 = max(grad_err32.values())
        del gk, gp, flat_p, state
        checks_s = time.perf_counter() - t_checks
        replay = {"checks_wall_s": checks_s,
                  "bf16_losses": l16, "bf16_gap": gap16,
                  "bf16_floor_chunked_vs_naive": floor16,
                  "bf16_tolerance": tol16, "f32_loss_kernel": float(lk),
                  "f32_loss_plain": float(lp), "f32_loss_rel_err": loss_err32,
                  "f32_grad_rel_err_max": worst32,
                  "f32_grad_rel_err": grad_err32}
        print(json.dumps({f"{label}_replay": replay}), flush=True)
        if not (gap16 <= tol16 and loss_err32 <= TRAIN_LOSS_TOL_F32
                and worst32 <= TRAIN_GRAD_TOL_F32):
            raise RuntimeError(
                f"{label}: kernel path vs plain versions: bf16 loss gap "
                f"{gap16} (tolerance {tol16}), float32 loss {loss_err32} "
                f"(tolerance {TRAIN_LOSS_TOL_F32}), float32 grads {worst32} "
                f"(tolerance {TRAIN_GRAD_TOL_F32})")
        b, s_len = batch0["tokens"].shape
        return {"arch": cfg.name, "n_layers": cfg.n_layers,
                "params": cfg.n_params(), "batch": b, "seq": s_len,
                "steps": steps, "losses": losses,
                "step_ms": [1e3 * x for x in hist["step_s"]],
                "step_ms_median_3_6": med_ms,
                "tokens_per_s": b * s_len / med_ms * 1e3,
                "wall_s": wall, "checks_wall_s": checks_s,
                "peak_memory_gb": peak_gb, "peak_reserved_gb": reserved_gb,
                "free_at_peak_gb": free_gb, "launches": launches, "launches_per_step": want_step,
                "profile": prof, "replay_f32_grad_rel_err": worst32,
                "replay_f32_loss_rel_err": loss_err32,
                "bf16_loss_gap": gap16, "bf16_tolerance": tol16,
                "bf16_floor": floor16, "card": smi}

    def train_line(st):
        busy = st["profile"]["device_busy_share"]
        return (f"{st['arch']} ({st['n_layers']} layers) B{st['batch']} x "
                f"{st['seq']}: step {st['step_ms_median_3_6']:.1f} ms, "
                f"{st['tokens_per_s']:.0f} tok/s, busy "
                f"{busy if isinstance(busy, str) else f'{busy:.1%}'}, peak "
                f"{st['peak_memory_gb']:.1f} GB (reserved "
                f"{st['peak_reserved_gb']:.1f}, free "
                f"{st['free_at_peak_gb']:.1f}; {smi}); launches "
                f"{st['launches']}; losses {st['losses'][0]:.4f} -> "
                f"{st['losses'][-1]:.4f}; float32 replay grads "
                f"{st['replay_f32_grad_rel_err']:.2e}, loss "
                f"{st['replay_f32_loss_rel_err']:.2e}; bf16 loss gap "
                f"{st['bf16_loss_gap']:.5f} (floor {st['bf16_floor']:.5f})")

    def device_batch(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    @phase("train")
    def train():
        cfg = get_config(TRAIN_ARCH)
        data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
        st = train_checked("train", cfg, data, TRAIN_STEPS,
                           lambda c: device_batch(data.batch(0)))

        # resume: 2 layers at full width; save after step 2, restore, take
        # step 3 through the loop: the uninterrupted run's loss
        pcfg = launch_train.PCFG
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
        st["resume_loss_err"] = resume_err
        print(json.dumps({"train": st}), flush=True)
        return st, f"{train_line(st)}; resume exact to {resume_err}"

    @phase("train_hybrid")
    def train_hybrid():
        cfg = dataclasses.replace(get_config(HYBRID_ARCH),
                                  n_layers=TRAIN_HYBRID_LAYERS)
        data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
        st = train_checked("train_hybrid", cfg, data, TRAIN_STEPS,
                           lambda c: device_batch(data.batch(0)))
        print(json.dumps({"train_hybrid": st}), flush=True)
        return st, train_line(st)

    @phase("train_encdec")
    def train_encdec():
        cfg = get_config(ENCDEC_ARCH)

        def batch_of(c, step):
            """Step `step`'s batch for config `c`: tokens, labels and the
            frame embeddings in c's compute dtype."""
            return make_batch(step, c, ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ,
                              "train", device=dev)
        data = types.SimpleNamespace(batch=lambda step: batch_of(cfg, step))
        st = train_checked("train_encdec", cfg, data, TRAIN_STEPS,
                           lambda c: batch_of(c, 0))
        print(json.dumps({"train_encdec": st}), flush=True)
        return st, train_line(st)

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
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    n_layers=RWKV_REPLAY_LAYERS)
        pcfg = launch_train.PCFG
        data = SyntheticLM(cfg.vocab_size, RWKV_SEQ, RWKV_BATCH, seed=0)
        batch0 = {k: torch.from_numpy(v).to(dev)
                  for k, v in data.batch(0).items()}
        replay_params = init_state(0, cfg32, device=dev).params

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

        # float32 replay at full width and RWKV_REPLAY_LAYERS, one step
        # from the initial weights:
        # the loss of the kernel path against the same with its plain
        # version under the same Function; the gradients of both, and of
        # the sequential path, against a float64 witness: the plain and
        # the sequential path run in float64 (`float64_mode`), which must
        # agree with each other to W64_TOL
        def grads(impl="pallas", ctx=contextlib.nullcontext,
                  params=replay_params):
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

        t_replay = time.perf_counter()
        params64 = cm.map_tree(lambda t: t.double(), replay_params)
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
        replay_s = time.perf_counter() - t_replay

        state = init_state(0, cfg, device=dev)
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
        replay = {"layers": RWKV_REPLAY_LAYERS, "wall_s": replay_s,
                  "bf16_losses": l16, "bf16_gap": gap16,
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
            f"float32 replay ({RWKV_REPLAY_LAYERS} layers, {replay_s:.1f} "
            f"s) grads {worst_k:.2e} from float64 (plain and "
            f"sequential paths {floor32:.2e}; float64 paths {worst64:.1e} "
            f"apart), loss {loss_err32:.2e}; bf16 loss gap {gap16:.2e} (floor "
            f"{floor16:.2e})")

    # ------------------------------------------------------------------
    # the cross-pod gradient sync: ranks sharing the card
    # ------------------------------------------------------------------
    @phase("pod_sync")
    def pod_sync():
        import torch.multiprocessing as mp
        # the earlier phases' cached blocks go back to the card for the
        # ranks' four contexts
        torch.cuda.empty_cache()
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            t0 = time.perf_counter()
            mp.start_processes(pod_rank, args=(POD_RANKS, f"file://{d}/init",
                                               d, time.time()),
                               nprocs=POD_RANKS, start_method="forkserver")
            spawn_s = time.perf_counter() - t0
            ranks = [json.loads(pathlib.Path(d, f"rank{r}.json").read_text())
                     for r in range(POD_RANKS)]
        # the same ranks' serving and training on a ('data', 'model') mesh:
        # their own phases
        shared["serve_mesh"] = [r.pop("serve_mesh") for r in ranks]
        shared["train_mesh"] = [r.pop("train_mesh") for r in ranks]
        lead = ranks[0]
        for r in ranks[1:]:
            for label, run in r["train"].items():
                if run["losses"] != lead["train"][label]["losses"]:
                    raise RuntimeError(f"pod_sync: rank {r['rank']} {label} "
                                       f"losses {run['losses']} vs rank 0's "
                                       f"{lead['train'][label]['losses']}")
        launches = {"flash": sum(run["launches"][0] for r in ranks
                                 for run in r["train"].values()),
                    "flash_bwd": sum(run["launches"][1] for r in ranks
                                     for run in r["train"].values())}
        st = {"ranks": POD_RANKS, "backend": lead["backend"],
              "arch": TRAIN_ARCH, "n_layers": POD_LAYERS,
              "dtype": "float32", "batch": POD_RANKS, "seq": TRAIN_SEQ,
              "steps": POD_STEPS, "spawn_wall_s": spawn_s,
              "schedules": lead["schedules"],
              "tree_sync": lead["tree_sync"], "train": lead["train"],
              "single_process": lead["single_process"],
              "rank0_marks_s": lead["marks_s"],
              "launches": launches, "card": smi}
        print(json.dumps({"pod_sync": st}), flush=True)
        sched = "; ".join(
            f"{r['schedule']} {r['collective_ops']} ops, "
            f"{r['wire_bytes_per_dev']} B, {r['wall_us_host']:.0f} us"
            for r in st["schedules"])
        syncs = ", ".join(f"{m} {t['seconds']:.2f} s ({t['hops']} hops, "
                          f"{t['staged_bytes'] / 1e9:.2f} GB staged)"
                          for m, t in st["tree_sync"].items())
        trains = ", ".join(
            f"{label} {run['losses'][-1]:.6f} ("
            f"{sum(run['step_s']):.2f} s)" for label, run in
            st["train"].items())
        vs = {label: st["train"][label]["vs_single_process"]
              for label in ("cascaded", "dedicated")}
        return st, (
            f"{POD_RANKS} ranks on one card over {st['backend']} (every "
            f"transfer of a CUDA tensor staged through host memory: not "
            f"NVLink times; {smi}); {TRAIN_ARCH} ({POD_LAYERS} layers, "
            f"float32) B{POD_RANKS} x {TRAIN_SEQ}, {POD_STEPS} steps; "
            f"final losses {trains}; against one process: "
            + ", ".join(f"{label} loss/gnorm {v['loss_gnorm_rel']:.1e}, "
                        f"params {v['params_err_over_tol']:.2f}, m "
                        f"{v['m_err_over_tol']:.2f}, v "
                        f"{v['v_err_over_tol']:.2f} of tolerance "
                        f"({v['params_excused']} noise elements excused)"
                        for label, v in vs.items())
            + f"; tree_sync of one step's gradients: {syncs}; "
            f"collective_schedules: {sched}; flash launches {launches}; "
            f"rank 0's parts ended at (s since the spawn) "
            + ", ".join(f"{k} {v:.1f}" for k, v in
                        st["rank0_marks_s"].items()))

    t_start = time.perf_counter()
    shared: dict = {}
    smi = card()
    # the spawned ranks' server (RANK_PRELOAD), loading in the background
    multiprocessing.set_forkserver_preload(RANK_PRELOAD)
    multiprocessing.forkserver.ensure_running()
    build()
    golden()
    parity()
    stats = grid()
    attn = attn_parity()
    cap, serve_stats = serve()
    sim_stats = serve_sim(cap)
    moe_stats = serve_moe()
    vlm_stats = serve_vlm()
    hybrid_stats = serve_hybrid()
    encdec_stats = serve_encdec()
    fig_stats = figures()
    scale_stats = sweep_scale()
    bwd = attn_bwd_parity()
    train_stats = train()
    hybrid_train = train_hybrid()
    encdec_train = train_encdec()
    pipe = pipe_parity()
    wkv = wkv_parity()
    rwkv_stats = train_rwkv()
    pod_stats = pod_sync()

    # ------------------------------------------------------------------
    # serving on a ('data', 'model') mesh: pod_sync's ranks
    # ------------------------------------------------------------------
    @phase("serve_mesh")
    def serve_mesh():
        ranks = shared.pop("serve_mesh")
        marks = pod_stats["rank0_marks_s"]
        started = marks[f"train_{POD_MODES[-1][0]}"]
        rank_s = marks[f"serve_mesh_{SM_WIDE_RUNS[-1][0]}"] - started
        wide_s = rank_s - (marks[f"serve_mesh_{SM_RUNS[-1][0]}"] - started)
        combines = sum(run.get("combines_bit_identical", 0) for r in ranks
                       for run in r.values())
        launches = {"flash": sum(run["launches"][0] for r in ranks
                                 for k, run in r.items()
                                 if not k.endswith("|one")),
                    "decode": sum(run["launches"][1] for r in ranks
                                  for k, run in r.items()
                                  if not k.endswith("|one")),
                    "decode_combine": sum(run["launches"][2] for r in ranks
                                          for k, run in r.items()
                                          if not k.endswith("|one"))}
        st = {"ranks": POD_RANKS, "meshes": [SM_MESH, SM_WIDE_MESH],
              "backend": pod_stats["backend"], "batch": SM_BATCH,
              "prompt": SM_PROMPT,
              "new": {"bfloat16": {str(SM_MESH[0]): SM_NEW_FSDP,
                                   str(SM_WIDE_MESH[0]): SM_NEW},
                      "float32": SM_NEW_F32},
              "runs": {a: {"layers": n, "policies": p, "mesh": m[0]}
                       for m, runs in ((SM_MESH, SM_RUNS),
                                       (SM_WIDE_MESH, SM_WIDE_RUNS))
                       for a, n, p in runs},
              "rank0": ranks[0], "per_rank_launches": [
                  {k: run["launches"] for k, run in r.items()}
                  for r in ranks],
              "launches": launches, "seconds_in_ranks": rank_s,
              "seconds_of_the_1x4_runs": wide_s,
              "cross_rank_combines_bit_identical": combines, "card": smi}
        print(json.dumps({"serve_mesh": st}), flush=True)
        rows = []
        for label, run in ranks[0].items():
            if label.endswith("|one"):
                continue
            vs = run["vs_one_process"]
            gap = vs["worst_logit_gap_over_max"]
            rows.append(
                f"{label} on {run['mesh']}: {run['wall_s']:.2f} s, "
                f"{statistics.median(run['step_ms']):.1f} ms/step "
                f"(median), {run['wire_bytes_per_tok']:.4g} B/tok on the "
                f"wire ({run['calls_per_step']} calls/step, "
                f"{run['staged_bytes_per_step'] / 1e6:.1f} MB staged per "
                f"step), " + (f"logits {gap:.2e} of max, "
                              if isinstance(gap, float) else "")
                + f"{vs['positions_held']} positions held, "
                f"{vs['near_tie_token_differences']} near-tie tokens, "
                f"{vs['requests_with_router_flips']} requests with router "
                f"flips")
        return st, (
            f"{POD_RANKS} ranks of pod_sync's spawn on one card over "
            f"{st['backend']} as a {SM_MESH[0]} and a {SM_WIDE_MESH[0]} "
            f"{SM_MESH[1]} mesh (every "
            f"transfer host-staged: loopback and PCIe, not NVLink; {smi}); "
            f"{SM_BATCH} x {SM_PROMPT} + {SM_NEW_FSDP} greedy on "
            f"{SM_MESH[0]}, {SM_NEW} on {SM_WIDE_MESH[0]} (float32 "
            f"{SM_NEW_F32}), held against one "
            f"process: " + "; ".join(rows) + f"; launches {launches}; "
            f"{combines} cross-rank combines bit-identical to "
            f"ref.combine_splits; {rank_s:.1f} s inside the ranks, "
            f"{wide_s:.1f} of them the {SM_WIDE_MESH[0]} runs (in "
            f"pod_sync's time)")

    sm_stats = serve_mesh()

    # ------------------------------------------------------------------
    # sharded training on a ('data', 'model') mesh: pod_sync's ranks
    # ------------------------------------------------------------------
    @phase("train_mesh")
    def train_mesh():
        ranks = shared.pop("train_mesh")
        marks = pod_stats["rank0_marks_s"]
        rank_s = (marks["train_mesh_no_sp"]
                  - marks[f"serve_mesh_{SM_WIDE_RUNS[-1][0]}"])
        lead = ranks[0]
        launches = {"flash": sum(run["launches"][0] for r in ranks
                                 for run in r["runs"].values()),
                    "flash_bwd": sum(run["launches"][1] for r in ranks
                                     for run in r["runs"].values())}
        st = {"ranks": POD_RANKS, "mesh": TM_MESH,
              "backend": pod_stats["backend"], "arch": TRAIN_ARCH,
              "n_layers": TM_LAYERS, "dtype": "float32",
              "batch": TM_BATCH, "seq": TM_SEQ, "steps": TM_STEPS,
              "runs": lead["runs"], "single_process":
                  lead["single_process"],
              "per_rank_launches": [{k: run["launches"] for k, run
                                     in r["runs"].items()} for r in ranks],
              "launches": launches, "seconds_in_ranks": rank_s,
              "card": smi}
        print(json.dumps({"train_mesh": st}), flush=True)
        rows = []
        for label, run in lead["runs"].items():
            vs, comm = run["vs_single_process"], run["comm_per_step"]
            rows.append(
                f"{label}: losses {run['losses']}, steps "
                + ", ".join(f"{t:.2f}" for t in run["step_s"])
                + f" s, {comm['wire_bytes'] / 1e9:.4f} GB on the wire and "
                f"{comm['staged_bytes'] / 1e9:.4f} GB staged per rank per "
                f"step ({comm['ops']} calls, equal to train_step_comm), "
                f"against one process: loss/gnorm "
                f"{vs['loss_gnorm_rel']:.1e}, params "
                f"{vs['params_err_over_tol']:.2f}, m "
                f"{vs['m_err_over_tol']:.2f}, v {vs['v_err_over_tol']:.2f} "
                f"of tolerance ({vs['params_excused']} noise elements "
                f"excused)")
        return st, (
            f"{POD_RANKS} ranks of pod_sync's spawn on one card over "
            f"{st['backend']} as a {TM_MESH[0]} {TM_MESH[1]} mesh (every "
            f"transfer host-staged: not NVLink; {smi}); {TRAIN_ARCH} "
            f"({TM_LAYERS} layers, float32) B{TM_BATCH} x {TM_SEQ}, "
            f"{TM_STEPS} steps each: " + "; ".join(rows)
            + f"; flash launches {launches} (per rank and run "
            f"{lead['runs']['sp']['launches']}, on "
            f"{lead['runs']['sp']['heads']} (q, kv) heads); "
            f"{rank_s:.1f} s inside the ranks (in pod_sync's time)")

    tm_stats = train_mesh()

    # ------------------------------------------------------------------
    # the k-cut WKV state: rwkv6-3b over 16 ranks sharing the card
    # ------------------------------------------------------------------
    @phase("serve_kdim")
    def serve_kdim():
        import torch.multiprocessing as mp
        torch.cuda.empty_cache()
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            t0 = time.perf_counter()
            mp.start_processes(kdim_rank, args=(KD_RANKS, f"file://{d}/init",
                                                d, time.time()),
                               nprocs=KD_RANKS, start_method="forkserver")
            spawn_s = time.perf_counter() - t0
            ranks = [json.loads(pathlib.Path(d, f"rank{r}.json").read_text())
                     for r in range(KD_RANKS)]
        lead = ranks[0]
        marks = lead.pop("marks_s")
        runs = {label: run for label, run in lead.items()
                if not label.endswith("|one")}
        st = {"ranks": KD_RANKS, "mesh": KD_MESH, "arch": RWKV_ARCH,
              "n_layers": KD_LAYERS, "batch": SM_BATCH, "prompt": SM_PROMPT,
              "new": {"bfloat16": SM_NEW, "float32": SM_NEW_F32},
              "spawn_wall_s": spawn_s, "rank0_marks_s": marks,
              "rank0": lead, "card": smi}
        print(json.dumps({"serve_kdim": st}), flush=True)
        rows = []
        for label, run in runs.items():
            vs = run["vs_one_process"]
            gap = vs["worst_logit_gap_over_max"]
            rows.append(
                f"{label}: {run['wall_s']:.2f} s, "
                f"{statistics.median(run['step_ms']):.1f} ms/step "
                f"(median), {run['wire_bytes_per_tok']:.4g} B/tok on the "
                f"wire, {run['calls_per_step'] / SM_BATCH:.4g} calls/tok "
                f"({run['calls_per_step']} calls/step, "
                f"{run['staged_bytes_per_step'] / 1e6:.2f} MB staged per "
                f"step), state {run['wkv_state']}, "
                + (f"logits {gap:.2e} of max, "
                   if isinstance(gap, float) else "")
                + f"{vs['positions_held']} positions held, "
                f"{vs['near_tie_token_differences']} near-tie tokens")
        return st, (
            f"{RWKV_ARCH} ({KD_LAYERS} layers, full width) on a "
            f"{KD_MESH[0]} {KD_MESH[1]} mesh of {KD_RANKS} ranks sharing "
            f"one card over gloo (host-staged: not NVLink; {smi}), MLR, "
            f"the WKV state cut over its k dim; {SM_BATCH} x {SM_PROMPT} "
            f"+ {SM_NEW} greedy (float32 {SM_NEW_F32}), held against one "
            f"process: " + "; ".join(rows) + f"; spawn {spawn_s:.1f} s, "
            f"rank 0's parts ended at (s since the spawn) "
            + ", ".join(f"{k} {v:.1f}" for k, v in marks.items()))

    serve_kdim()

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
            "retime_cells": stats["retime_cells"],
            "retime_bucketed_ms": stats["retime_bucketed_ms"],
            "retime_bucket_launches": len(stats["retime_bucket_ms"]),
            "retime_one_launch_ms": stats["retime_one_launch_ms"],
            "grid_us_per_cycle": stats["us_per_cycle"],
            "grid_us_per_cycle_run": stats["us_per_cycle_run"],
            "serve_sim_launches": sim_stats["launches"],
            "serve_sim_kernel_ms": sim_stats["kernel_ms"],
            "serve_sim_retime_bucketed_ms": sim_stats["retime_bucketed_ms"],
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
            "serve_moe_launches": moe_stats["launches"]["flash"],
            "serve_vlm_launches": vlm_stats["launches"]["flash"],
            "serve_hybrid_launches": hybrid_stats["launches"]["flash"],
            "serve_encdec_launches": encdec_stats["launches"]["flash"],
            "train_launches": train_stats["launches"]["flash"],
            "train_hybrid_launches": hybrid_train["launches"]["flash"],
            "train_encdec_launches": encdec_train["launches"]["flash"],
            "pod_sync_launches": pod_stats["launches"]["flash"],
            "serve_mesh_launches": sm_stats["launches"]["flash"],
            "train_mesh_launches": tm_stats["launches"]["flash"],
            "max_abs_err": attn_err["flash"], **attn["flash"],
            "shape": "q (8,256,32,64), k/v (8,256,4,64) bf16, causal",
            "train_shape_ms": bwd["fwd_ms"],
            "train_shape_bound_ms": bwd["fwd_bound_ms"],
            "train_shape_plain_ms": bwd["fwd_plain_ms"],
            "train_shape_library_ms": bwd["fwd_library_ms"],
            "hd112": dict(attn["flash_hd112"],
                          shape="q/k/v (8,256,32,112) bf16, causal "
                                "(serve_hybrid's prefill)"),
            "hd112_train": {
                "ms": bwd["hd112"]["fwd_ms"],
                "bound_ms": bwd["hd112"]["fwd_bound_ms"],
                "plain_ms": bwd["hd112"]["fwd_plain_ms"],
                "library_ms": bwd["hd112"]["fwd_library_ms"],
                "shape": "q/k/v (4,2048,32,112) bf16, causal "
                         "(train_hybrid)"},
            "check": "ok"}, {
            "name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd_tc.cu",
            "float32_source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:219",
            "launches": train_stats["launches"]["flash_bwd"],
            "train_hybrid_launches": hybrid_train["launches"]["flash_bwd"],
            "train_encdec_launches": encdec_train["launches"]["flash_bwd"],
            "pod_sync_launches": pod_stats["launches"]["flash_bwd"],
            "train_mesh_launches": tm_stats["launches"]["flash_bwd"],
            "max_abs_err": bwd_err["max_abs"],
            "max_rel_err": bwd_err["max_rel"],
            **{k: bwd[k] for k in ("ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by")},
            "shape": "q/o/do (4,2048,32,64), k/v (4,2048,4,64) bf16, causal",
            "hd112": dict({k: bwd["hd112"][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
                shape="q/k/v/o/do (4,2048,32,112) bf16, causal "
                      "(train_hybrid)"),
            "check": "ok"}, {
            "name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:68",
            "launches": serve_stats["launches"]["decode"],
            "serve_moe_launches": moe_stats["launches"]["decode"],
            "serve_vlm_launches": vlm_stats["launches"]["decode"],
            "serve_hybrid_launches": hybrid_stats["launches"]["decode"],
            "serve_encdec_launches": encdec_stats["launches"]["decode"],
            "serve_mesh_launches": sm_stats["launches"]["decode"],
            "max_abs_err": attn_err["decode"], **attn["decode"],
            "shape": "q (8,1,32,64), caches (8,512,4,64) bf16, lengths 288",
            "hd112": dict(attn["decode_hd112"],
                          shape="q (8,1,32,112), caches (8,512,32,112) "
                                "bf16, lengths 288 (serve_hybrid's step)"),
            "check": "ok"}, {
            "name": "decode_attention_combine", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:68",
            "launches": serve_stats["launches"]["decode_combine"],
            "serve_moe_launches": moe_stats["launches"]["decode_combine"],
            "serve_vlm_launches": vlm_stats["launches"]["decode_combine"],
            "serve_hybrid_launches":
                hybrid_stats["launches"]["decode_combine"],
            "serve_encdec_launches":
                encdec_stats["launches"]["decode_combine"],
            "serve_mesh_launches": sm_stats["launches"]["decode_combine"],
            "serve_mesh_cross_rank_combines_bit_identical":
                sm_stats["cross_rank_combines_bit_identical"],
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
    print(json.dumps({"phase_s": PHASE_S}), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
