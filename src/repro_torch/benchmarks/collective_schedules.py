"""Cascaded vs dedicated collective schedules (port of
``benchmarks/collective_schedules.py``): the cross-pod all-reduce of x
(4, 2^17) float32, split over 4 ranks of a 'pod' group, in the three
schedules of ``core/collectives.py`` — what each issues, the bytes each
rank puts on the wire, and the host's wall time of one call.

    PYTHONPATH=src python -m repro_torch.benchmarks.collective_schedules \
        [--device cuda|cpu]

The cascade shows 2(n-1) ring hops each moving 1/n of the vector (the
paper's time-sliced slots); dedicated is one fused all-reduce.  Columns:
``collective_ops`` and ``permute_hops`` count the communication calls this
rank issued and the ring hops among them (``collectives.CommLog``; the
reference's columns count ops in its compiled program's text, another
quantity by design); ``wire_bytes_per_dev`` the bytes this rank sent, the
fused all-reduce at the ring model's 2(n-1)/n of its bytes;
``wall_us_host`` one call after a warm-up, on rank 0's host clock (the
card synchronised).  ``--device cuda`` (the default) runs NCCL, one card
per rank, where 4 cards are visible; with fewer, NCCL refuses two ranks on
one device, so the 4 ranks share card 0 on gloo and every transfer of x
goes through host memory (``core.comm.stages_on_host``): those wall times
are not NVLink figures, and a comment line after the rows says which
transport ran.  ``--device cpu`` runs gloo on the host.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

#: ranks of the 'pod' group and elements of x per rank (x (4, 2^17))
RANKS = 4
N = 1 << 17
HEADER = ("schedule,collective_ops,wire_bytes_per_dev,permute_hops,"
          "wall_us_host")


def schedules():
    """name -> fn(x, group, log): the sum of x over the group."""
    from repro_torch.core import collectives as C
    from repro_torch.train.compression import compressed_ring_all_reduce
    return {
        "cascaded": C.cascaded_all_reduce,
        "dedicated": C.dedicated_all_reduce,
        "cascaded_int8": lambda x, g, log: compressed_ring_all_reduce(
            x.reshape(-1), g, log=log),
    }


def measure(group, device) -> list[dict]:
    """Run inside every rank of `group`: this rank's row of x (n, N),
    ``arange`` values, through each schedule once with its `CommLog`, then
    once more timed.  Checks the sums (exact for the float32 schedules,
    within the int8 ring's quantisation bound) and returns one dict per
    schedule."""
    import torch.distributed as dist

    from repro_torch.core.collectives import CommLog
    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = torch.arange(n * N, dtype=torch.float32, device=device).reshape(
        n, N)
    want = x.sum(0)
    mine = x[r].clone()
    rows = []
    for name, fn in schedules().items():
        log = CommLog()
        out = fn(mine, group, log)
        err = float((out - want).abs().max())
        tol = 0.0 if name != "cascaded_int8" else \
            6 * n * float(x.abs().max()) / 127
        if not (out.shape == want.shape and err <= tol):
            raise RuntimeError(f"collective_schedules: {name} sum off by "
                               f"{err} (tolerance {tol})")
        dist.barrier(group)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn(mine, group, None)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        us = (time.perf_counter() - t0) * 1e6
        rows.append({"schedule": name, "collective_ops": log.ops,
                     "wire_bytes_per_dev": log.wire_bytes,
                     "permute_hops": log.hops, "wall_us_host": us,
                     "staged_bytes": log.staged_bytes, "max_abs_err": err,
                     "transport": transport(group, log)})
    return rows


def transport(group, log) -> str:
    """The backend that moved a schedule's bytes, and "host-staged" where
    they went through host memory on their way."""
    import torch.distributed as dist
    backend = dist.get_backend(group)
    return f"{backend}, host-staged" if log.staged_bytes else backend


def format_rows(rows: list[dict]) -> list[str]:
    out = [HEADER]
    out += [f"{r['schedule']},{r['collective_ops']},"
            f"{r['wire_bytes_per_dev']:.3e},{r['permute_hops']},"
            f"{r['wall_us_host']:.0f}" for r in rows]
    out.append("# same wire volume, different schedule: the ring exposes "
               "per-hop overlap points; int8 ring moves ~3.9x fewer bytes")
    out.append("# transport: " + "; ".join(sorted({r["transport"]
                                                   for r in rows})))
    return out


def _rank(rank: int, world: int, init: str, backend: str, device: str,
          shared: bool, out_path: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import axis_group, make_test_mesh
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0 if shared else rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = make_test_mesh((world,), ("pod",), device_type=dev.type)
        rows = measure(axis_group(mesh, "pod"), dev)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(rows, f)
    finally:
        dist.destroy_process_group()


def run(device: str = "cuda") -> list[dict]:
    """Spawn RANKS processes and return rank 0's rows.  On cards: NCCL,
    one card per rank, where RANKS cards are visible, else gloo with every
    rank on card 0 and each transfer staged through host memory (the
    rows' ``transport`` says so); no card raises.  ``device="cpu"``: gloo
    on the host."""
    import torch.multiprocessing as mp

    from repro_torch.models.common import check_device
    dev = check_device(device)
    shared = dev.type == "cuda" and torch.cuda.device_count() < RANKS
    backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "rows.json")
        mp.spawn(_rank, args=(RANKS, f"file://{d}/init", backend, dev.type,
                              shared, out), nprocs=RANKS)
        with open(out) as f:
            return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    rows = run(args.device)
    print("\n".join(format_rows(rows)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
