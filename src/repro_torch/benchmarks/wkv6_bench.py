"""WKV6 at RWKV-6's training shape, the two ways the port calls it, each
timed on the host and on the device.

  PYTHONPATH=src python -m repro_torch.benchmarks.wkv6_bench

The shape is one layer of ``chip_smoke.py``'s rwkv6-3b training step:
(B 4, H 40, S 2048, hd 64), chunk 64, inputs from a seeded generator on
the card.  ``model_call``: ``ops.wkv6_with_state`` on what the model
passes, bf16 r, k, v and float32 logw as transposed views of (B, S, H,
hd) tensors, u (H, hd) float32.  ``float32``: ``kernel.wkv6`` on the
same values as contiguous float32 (B, H, S, hd) tensors.  ``*_ms`` is
the host's time per call: CUDA events around CALLS back-to-back calls,
median of REPS.  ``*_device_ms`` is the device's: the sum of the device
events' own times (kernels, copies, fills) in a ``torch.profiler`` window
of CALLS calls, per call, with ``*_device_events`` the device events per
call and ``*_device_kernels`` their names.  Run it in a process of its
own: in one that has had profiler windows before, a new window can lose
device events.  On a tree whose kernel has `plan`, ``plan`` is its
launch at this shape.  Prints one JSON line with the card's name and
power limit.  It needs a card and only ``ops.wkv6_with_state`` and
``kernel.wkv6`` of the port, so it also runs against an older tree
(``PYTHONPATH=<tree>/src python <this file>``).
"""
from __future__ import annotations

import json
import subprocess

import torch

from repro_torch.kernels.wkv6 import kernel, ops

#: (B, H, S, hd, chunk) of one rwkv6-3b layer at batch 4 x 2048
TRAINING = (4, 40, 2048, 64, 64)
REPS, CALLS = 5, 10
SEED = 0


def inputs(b, h, s, hd, seed=SEED, device="cuda"):
    """The model's call: r, k, v bf16 and logw float32 as (B, H, S, hd)
    views of (B, S, H, hd) tensors; u (H, hd) float32."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    r, k, v = (randn(b, s, h, hd).bfloat16().transpose(1, 2)
               for _ in range(3))
    logw = -torch.exp(randn(b, s, h, hd) - 2.0).transpose(1, 2)
    return r, k, v, logw, 0.4 + 0.2 * randn(h, hd)


def host_ms(fn, reps=REPS, calls=CALLS) -> float:
    """Median over `reps` of the CUDA-event time of `calls` back-to-back
    calls, per call (ms)."""
    fn()
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


def device_ms(fn, calls=CALLS) -> tuple[float, float, list]:
    """(device ms per call, device events per call, their names) in a
    ``torch.profiler`` window of `calls` calls: the device events' own
    times, without the gaps between them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in events) / 1e3 / calls,
            sum(e.count for e in events) / calls,
            sorted(e.key for e in events))


def run(shape=TRAINING) -> dict:
    """The times at `shape`, and the card."""
    b, h, s, hd, chunk = shape
    r, k, v, logw, u = inputs(b, h, s, hd)
    f32 = [x.float().contiguous() for x in (r, k, v, logw)] + [u]
    calls = {
        "model_call": lambda: ops.wkv6_with_state(r, k, v, logw, u, chunk),
        "float32": lambda: kernel.wkv6(*f32, chunk=chunk)}
    out = {"shape": {"B": b, "H": h, "S": s, "hd": hd, "chunk": chunk}}
    for name, fn in calls.items():
        out[f"{name}_ms"] = host_ms(fn)
        (out[f"{name}_device_ms"], out[f"{name}_device_events"],
         out[f"{name}_device_kernels"]) = device_ms(fn)
    if hasattr(kernel, "plan"):
        out["plan"] = kernel.plan(b, h, s, hd, chunk)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return out


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("wkv6_bench: no CUDA device")
    print(json.dumps({"wkv6_bench": run()}), flush=True)
