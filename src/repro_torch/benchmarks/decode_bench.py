"""Flash-decode at the serving shape: the port's kernel beside one
``scaled_dot_product_attention`` call (a yardstick; the port never calls
it), each timed two ways.

  PYTHONPATH=src python -m repro_torch.benchmarks.decode_bench

The shape is one decode step of ``chip_smoke.py``'s serving run halfway
through its 64 new tokens: q (8, 1, 32, 64), K/V caches (8, 512, 4, 64)
bf16, every lane's length 288, inputs from a seeded generator on the
card.  ``*_ms`` is the host's time per call: CUDA events around CALLS
back-to-back calls, median of REPS; at this shape the host's launch
cost, not the kernel, sets it.  ``*_device_ms`` is the device's: a CUDA
graph of CALLS calls, captured after a warm-up (so no build or one-time
setup falls inside it), replayed REPS times under CUDA events, per call.
Prints one JSON line with the card's name and power limit.  It needs a
card, and only ``kernel.decode_attention`` of the port, so it runs
against any version of the kernel.
"""
from __future__ import annotations

import json
import subprocess

import torch

from repro_torch.kernels.decode_attention import kernel

#: (B, Hq, Hkv, hd, Smax, length) of one serving decode step
SERVING = (8, 32, 4, 64, 512, 288)
REPS, CALLS = 5, 20
SEED = 0


def inputs(b, hq, hkv, hd, smax, length, dtype=torch.bfloat16, seed=SEED,
           device="cuda"):
    """q (B,1,Hq,hd), caches (B,Smax,Hkv,hd), lengths (B,) int32."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    return (randn(b, 1, hq, hd), randn(b, smax, hkv, hd),
            randn(b, smax, hkv, hd),
            torch.full((b,), length, dtype=torch.int32, device=device))


def host_ms(fn, reps=REPS, calls=CALLS) -> float:
    """Median over `reps` of the CUDA-event time of `calls` back-to-back
    calls, per call (ms)."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return sorted(times)[len(times) // 2]


def device_ms(fn, reps=REPS, calls=CALLS) -> float:
    """The device's time per call (ms): `calls` calls captured in one CUDA
    graph after a warm-up on a side stream, the graph replayed `reps`
    times under CUDA events, the median per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    return host_ms(graph.replay, reps, 1) / calls


def profiled_ms(fn, calls=CALLS) -> float:
    """The device events' own time per call (ms) in a ``torch.profiler``
    window of `calls` calls: kernels, copies and fills, without the gaps
    between them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 / calls


def sdpa_fn(q, k_cache, v_cache, lengths):
    """One SDPA call computing the same function: a length mask, GQA."""
    smax = k_cache.shape[1]
    mask = (torch.arange(smax, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    tq, tk, tv = (x.transpose(1, 2) for x in (q, k_cache, v_cache))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(tq, tk, tv, attn_mask=mask, enable_gqa=True)


def run(shape=SERVING) -> dict:
    """The four times at `shape`, and the card."""
    q, kc, vc, lens = inputs(*shape)
    dec = lambda: kernel.decode_attention(q, kc, vc, lens)  # noqa: E731
    lib = sdpa_fn(q, kc, vc, lens)
    out = {"shape": {"B": shape[0], "Hq": shape[1], "Hkv": shape[2],
                     "hd": shape[3], "Smax": shape[4], "length": shape[5],
                     "dtype": "bfloat16"}}
    for name, fn in (("kernel", dec), ("sdpa", lib)):
        out[f"{name}_ms"] = host_ms(fn)
        out[f"{name}_profiled_ms"] = profiled_ms(fn)
        out[f"{name}_device_ms"] = device_ms(fn)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return out


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("decode_bench: no CUDA device")
    print(json.dumps({"decode_bench": run()}), flush=True)
