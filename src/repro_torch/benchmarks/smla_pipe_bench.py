"""The SMLA cascaded-pipeline matmul against Dedicated-IO and one
``torch.matmul`` of the flattened weights (port of
``benchmarks/smla_pipe_bench.py``).

  PYTHONPATH=src python -m repro_torch.benchmarks.smla_pipe_bench \
      [--device cpu] [--shape default|realistic|all]

Shapes: the reference bench's default (M 256, K 1024, N 256, L 4) and a
realistic one, the tinyllama-1.1b MLP up-projection over one training
batch of 4 x 2048 tokens striped over 4 layers: x (8192, 2048) @ w (4,
512, 5632), float32, 1.89e11 FLOP.  Rows ``impl,max_abs_err,ms``: each
implementation's max abs error against ``ref.matmul_striped`` and its
time per call, the median of REPS runs of CALLS back-to-back calls —
CUDA events on the card (the default), the host clock with
``--device cpu``, where the kernels' plain versions run.  The matmul is
float32 with TF32 off: a yardstick only, the port never calls it for
these kernels.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.kernels.smla_pipe import ops, ref

#: (M, K, N, L) of each shape
SHAPES = {"default": (256, 1024, 256, 4),
          "realistic": (8192, 2048, 5632, 4)}
#: each time is the median of REPS runs of CALLS back-to-back calls
REPS, CALLS = 5, 10
#: seed of the inputs
SEED = 0


def _time_ms(fn, device) -> float:
    """Median over REPS of the time of CALLS back-to-back calls, per call,
    in ms: CUDA events on the card, the host clock on the CPU."""
    times = []
    for _ in range(REPS):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            a.record()
            for _ in range(CALLS):
                fn()
            b.record()
            torch.cuda.synchronize(device)
            times.append(a.elapsed_time(b) / CALLS)
        else:
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / CALLS)
    return sorted(times)[len(times) // 2]


def run(m: int = 256, k: int = 1024, n: int = 256, layers: int = 4, *,
        device="cuda") -> list[dict]:
    """One row per implementation: impl, max_abs_err (against
    ``ref.matmul_striped``), ref_max_abs (max |ref|, the error's scale),
    ms, and calls (how often it was called, the error check and a
    warm-up included)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((m, k), generator=gen, device=dev)
    w = torch.randn((layers, k // layers, n), generator=gen, device=dev)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = ref.matmul_striped(x, w)
        rows = []
        for name, fn in (("cascaded", lambda: ops.matmul_cascaded(x, w)),
                         ("dedicated", lambda: ops.matmul_dedicated(x, w)),
                         ("torch_matmul",
                          lambda: ref.matmul_striped(x, w))):
            err = float((fn() - want).abs().max())
            fn()                                      # warm-up
            ms = _time_ms(fn, dev)
            rows.append({"impl": name, "max_abs_err": err,
                         "ref_max_abs": float(want.abs().max()), "ms": ms,
                         "calls": 2 + REPS * CALLS})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--shape", default="all", choices=(*SHAPES, "all"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run the plain versions")
    where = (torch.cuda.get_device_name(0) + " (CUDA events)"
             if args.device == "cuda" else "cpu (host clock; plain "
             "versions)")
    for name in (SHAPES if args.shape == "all" else (args.shape,)):
        m, k, n, layers = SHAPES[name]
        print(f"# {name}: M {m}, K {k}, N {n}, L {layers}, float32, "
              f"device {where}")
        print("impl,max_abs_err,ms")
        for row in run(m, k, n, layers, device=args.device):
            print(f"{row['impl']},{row['max_abs_err']:.2e},{row['ms']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
