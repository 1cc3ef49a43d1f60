"""Sweep-engine scaling figure: cells/s and buckets/s vs grid size, the
streaming pipeline vs the synchronous runner, plus the successive-halving
work saving on a 2e4-cell grid (port of ``benchmarks/paper_fig_scale.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.paper_fig_scale \
        [--smoke] [--device cuda|cpu]

Methodology — every measurement is a **fresh subprocess** timed around
`run_sweep` only (imports, grid construction and, on a card, the CUDA
context's creation excluded), because the quantity that matters for
large campaigns is the sweep latency a fresh process — a journal resume,
a fleet worker — actually pays:

* ``sync``        — `SweepSpec(streaming=False)` with a fresh, empty
                    `SimOptions.compile_cache_dir`: the strict
                    prepare->execute->harvest loop paying the kernel's
                    ``nvcc`` build in-process (as the reference's sync
                    pays XLA compilation).
* ``stream_cold`` — the pipeline with a fresh build directory: pays the
                    build once and *populates* the directory.
* ``stream_warm`` — the pipeline against the populated directory: what
                    every later process pays.  This is the headline
                    `ratio` row against ``sync``, gated >= 1.3x by
                    ``assert_early_exit`` on a record made on the card.

Each child reports the seconds its build took (the kernel library's
``compile_library``, timed inside the child: near zero where the
directory holds it).  With ``--device cpu`` the children run the plain
version, nothing is built, and the rows say so.

All three modes must produce the identical per-cell bandwidths and
checksum — the benchmark hard-fails on any numeric divergence, so the
perf row can never come from a wrong answer.  The `prune` section runs a
2e4-cell replicated grid under `PruneSpec(0.125, 0.5, 1)` (reusing the
last size's built library) and records the fraction of full-horizon
device work avoided (gated >= 50%).
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

from repro_torch.benchmarks._util import (emit_json, launches,
                                          progress_printer, scaled,
                                          smoke_mode)
from repro_torch.core.smla import cuda_engine, sweep
from repro_torch.core.smla.engine import SimOptions
from repro_torch.core.smla.traces import WorkloadSpec

#: grid sizes as workload counts: n_cells = k workloads x 2 layer counts
#: x 5 IO models (one static shape group — the steady-state regime)
SIZES_FULL = (6, 24, 96)
SIZES_SMOKE = (3, 12)
STREAM = WorkloadSpec("stream.t", 50.0, 0.85, write_frac=1 / 3)
LAYERS = (2, 4)
PRUNE = sweep.PruneSpec(horizon_frac=0.125, keep_frac=0.5, rounds=1)

#: a child process: one measurement (`child`), its config as argv[1]
_CHILD = ("import sys; from repro_torch.benchmarks import paper_fig_scale; "
          "paper_fig_scale.child(sys.argv[1])")


def size_cells(k: int, n_req: int) -> list[sweep.SweepCell]:
    """One size's grid: k seeds of STREAM x LAYERS x 5 IO models."""
    return sweep.paper_grid(
        [(f"w{s}", [STREAM, STREAM], s) for s in range(k)],
        layers=LAYERS, n_req=n_req)


def prune_cells(n_cells: int, n_req: int) -> tuple[sweep.SweepCell, ...]:
    """The prune grid: 4 base cells replicated to `n_cells` (shared trace
    arrays — building 2e4 distinct traces is host-side noise)."""
    base = sweep.paper_grid([("s", [STREAM, STREAM], 3)], layers=(2,),
                            n_req=n_req)[:4]
    reps = -(-n_cells // len(base))
    return tuple(sweep.SweepCell(f"{c.name}#r{i}", c.stack, c.traces)
                 for i in range(reps) for c in base)


def child(cfg_json: str) -> None:
    """Run one measurement in this (fresh) process and print its
    ``RESULT`` line: the sweep's wall, throughput, kernel launches,
    build seconds and bandwidths."""
    import torch
    cfg = json.loads(cfg_json)
    device = cfg["device"]
    build_s = [0.0]
    if device == "cuda":
        real = cuda_engine.compile_library

        def timed_build(*a, **kw):
            t = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                build_s[0] += time.perf_counter() - t
        cuda_engine.compile_library = timed_build
        torch.zeros(1, device="cuda")          # the context, not the sweep
        torch.cuda.synchronize()
    opts = SimOptions(horizon=cfg["horizon"], device=device,
                      compile_cache_dir=cfg.get("cache_dir"))
    if cfg["kind"] == "prune":
        spec = sweep.SweepSpec(prune_cells(cfg["n_cells"], cfg["n_req"]),
                               options=opts, prune=PRUNE,
                               on_bucket=progress_printer(cfg["label"]))
    else:
        spec = sweep.SweepSpec(tuple(size_cells(cfg["k"], cfg["n_req"])),
                               options=opts, streaming=cfg["streaming"],
                               on_bucket=progress_printer(cfg["label"]))
    l0 = launches()
    t0 = time.time()
    res = sweep.run_sweep(spec)
    wall = max(time.time() - t0, 1e-9)
    out = {"device": res.device, "launches": launches() - l0,
           "build_s": round(build_s[0], 3), "wall_s": round(wall, 3)}
    if cfg["kind"] == "prune":
        out.update(res.prune_work, n_promoted=len(res.names),
                   n_pruned=len(res.pruned), promoted=list(res.names),
                   cells_per_s=round(res.prune_work["n_cells"] / wall, 3))
    else:
        bw = res.scalars(keys=("bandwidth_gbps",))["bandwidth_gbps"]
        out.update(n_cells=len(res.names),
                   cells_per_s=round(len(res.names) / wall, 3),
                   n_buckets=len(res.buckets),
                   buckets_per_s=round(len(res.buckets) / wall, 3),
                   checksum_bandwidth=float(bw.sum()),
                   names=list(res.names),
                   bandwidth_gbps=[float(x) for x in bw])
    print("RESULT " + json.dumps(out), flush=True)


def _run_child(cfg: dict) -> dict:
    src = str(pathlib.Path(sweep.__file__).resolve().parents[3])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    r = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(cfg)],
                       capture_output=True, text=True, env=env)
    if r.returncode != 0:
        raise RuntimeError(f"fig_scale child failed ({cfg.get('label')}):\n"
                           f"{r.stdout}\n{r.stderr}")
    for line in r.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"fig_scale child printed no RESULT:\n{r.stdout}")


def run_size(k: int, n_req: int, horizon: int, cache_root: str,
             device: str = "cuda") -> dict:
    """One size in three fresh processes (sync, stream_cold,
    stream_warm); raises unless the three agree on every bandwidth."""
    base = {"kind": "size", "k": k, "n_req": n_req, "horizon": horizon,
            "device": device}
    cache = os.path.join(cache_root, f"build-k{k}")
    sync = _run_child(dict(base, streaming=False,
                           cache_dir=os.path.join(cache_root,
                                                  f"build-sync-k{k}"),
                           label=f"fig_scale:sync:k{k}"))
    cold = _run_child(dict(base, streaming=True, cache_dir=cache,
                           label=f"fig_scale:cold:k{k}"))
    warm = _run_child(dict(base, streaming=True, cache_dir=cache,
                           label=f"fig_scale:warm:k{k}"))
    modes = (sync, cold, warm)
    checks = {m["checksum_bandwidth"] for m in modes}
    if len(checks) != 1 or any(m["bandwidth_gbps"] != sync["bandwidth_gbps"]
                               or m["names"] != sync["names"]
                               for m in modes):
        raise RuntimeError(f"fig_scale k={k}: modes disagree on the "
                           f"bandwidths: checksums {checks}")
    strip = ("names", "bandwidth_gbps")
    return {"k": k, "n_cells": sync["n_cells"],
            "n_buckets": sync["n_buckets"], "device": sync["device"],
            "names": sync["names"], "bandwidth_gbps": sync["bandwidth_gbps"],
            "checksum_bandwidth": sync["checksum_bandwidth"],
            **{mode: {key: v for key, v in m.items() if key not in strip}
               for mode, m in zip(("sync", "stream_cold", "stream_warm"),
                                  modes)},
            "ratio": round(warm["cells_per_s"]
                           / max(sync["cells_per_s"], 1e-9), 3)}


def _build_note(row: dict) -> str:
    if row["device"] != "cuda":
        return "nothing built (plain version on the cpu)"
    return (f"nvcc {row['sync']['build_s']:.2f}s sync, "
            f"{row['stream_cold']['build_s']:.2f}s cold, "
            f"{row['stream_warm']['build_s']:.2f}s warm")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes for CI (sets SMLA_SMOKE=1)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.smoke:
        os.environ["SMLA_SMOKE"] = "1"

    n_req = scaled(120, 24)
    horizon = scaled(6_000, 2_000)
    sizes = SIZES_SMOKE if smoke_mode() else SIZES_FULL
    rows = []
    with tempfile.TemporaryDirectory(prefix="fig-scale-") as cache_root:
        for k in sizes:
            row = run_size(k, n_req, horizon, cache_root, args.device)
            rows.append(row)
            print(f"n_cells={row['n_cells']:5d}  "
                  f"sync={row['sync']['cells_per_s']:8.1f}  "
                  f"stream_cold={row['stream_cold']['cells_per_s']:8.1f}  "
                  f"stream_warm={row['stream_warm']['cells_per_s']:8.1f} "
                  f"cells/s  ratio={row['ratio']:.2f}x  "
                  f"({row['n_buckets']} buckets; {_build_note(row)})",
                  flush=True)
        prune = _run_child({
            "kind": "prune", "n_cells": scaled(20_000, 10_000),
            "n_req": scaled(10, 6), "horizon": scaled(1_024, 512),
            "device": args.device, "label": "fig_scale:prune",
            "cache_dir": os.path.join(cache_root, f"build-k{sizes[-1]}")})
    print(f"prune: {prune['n_cells']} cells -> {prune['n_promoted']} "
          f"promoted, saved {prune['saved_frac']:.0%} of full-horizon "
          f"work in {prune['wall_s']:.1f}s on {prune['device']}",
          flush=True)

    path = emit_json("fig_scale", {
        "rows": rows,
        "ratio_best": max(r["ratio"] for r in rows),
        "prune": prune,
        "device": args.device,
        "methodology": ("per-mode fresh subprocess timed around run_sweep; "
                        "sync = streaming=False with a fresh build "
                        "directory (nvcc in-process), stream_warm = "
                        "pipeline + a populated build directory")})
    print(f"fig_scale -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
