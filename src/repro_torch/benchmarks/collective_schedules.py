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
import math
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


def train_step_comm(cfg, pcfg, sizes: dict, batch: int, seq: int) -> dict:
    """What one sharded train step of a dense transformer (``train/step.py``
    on a ('pod', 'data', 'model') mesh of `sizes`, remat "full", the
    batch's global `batch` x `seq` tokens) puts in each rank's
    ``CommLog`` (the 'pod' sync is not counted there), counted from the
    shapes: {"ops", "wire_bytes",
    "staged_bytes"}, staged as on gloo with the tensors on a card (every
    buffer through the host).  The ring model's wire bytes: an all-gather
    of an n-way cut sends (n - 1) blocks, a reduce-scatter to a block the
    same, an all-reduce 2(n - 1)/n of its bytes; staged, the buffer each
    call hands the backend (a reduce-scatter's is its n blocks).

    Element sizes: the float32 params' layer weights, the tensor-parallel
    exits' float32 partial sums, the loss's reductions and the gradients'
    sums in float32; the embedding's rows, the sequence-parallel
    gathers of the normed rows, the final rows and the head (cast before
    its gather) in ``cfg.dtype``; each adjoint in its forward's dtype.

    Forward: the token ids and the embedding's feature blocks gathered
    (over 'data', then 'model' and 'data'); per layer the seven FSDP
    gathers over 'data', and with sequence parallelism a gather of the
    normed rows over 'model' before attention and the MLP and a
    reduce-scatter at each exit (``sp_boundary`` "layer": one gather at
    the layer's entry, an all-reduce at the attention's exit; without
    it, an all-reduce at each exit); the final hidden rows gathered; per
    loss chunk the head's gather (a tied head: the table's feature blocks
    over 'model', then 'data') and three all-reduces over 'model' (max,
    sum of exponentials, the label's logit).  Remat: each layer's
    recompute re-issues its collectives up to its last saved tensor (all
    but the MLP's exit), a loss chunk's all of them.  Backward: each
    forward collective that carries a gradient once more as its adjoint
    (same wire bytes; a gather's staged bytes become its reduce-scatter's
    n blocks and back); the token ids and the max carry none.  Then one
    all-reduce per axis of the replicated leaves' gradients, the loss's
    sum over 'data', and the clip's two scalar sums."""
    from repro_torch.configs.base import _param_shapes
    from repro_torch.core.comm import MeshShape
    from repro_torch.core.partitioning import config_specs
    from repro_torch.models.common import entry_axes, flatten_paths
    dd, m = sizes.get("data", 1), sizes.get("model", 1)
    if cfg.family != "dense" or (cfg.tie_embeddings and m > 1
                                 and cfg.vocab_size % m):
        raise NotImplementedError(f"train_step_comm: {cfg.name} is not a "
                                  f"dense transformer whose head 'model' "
                                  f"cuts by vocab")
    f, e = 4, torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    d, n_layers = cfg.d_model, cfg.n_layers
    b = batch // (sizes.get("pod", 1) * dd)
    sp = pcfg.seq_shard_activations and m > 1 and seq % m == 0
    c = min(pcfg.logit_chunk, seq)
    chunks = seq // c if seq % c == 0 else 1
    log = {"ops": 0, "wire_bytes": 0, "staged_bytes": 0}

    def op(n, times, wire, staged):
        if n > 1:
            log["ops"] += times
            log["wire_bytes"] += times * round(wire)
            log["staged_bytes"] += times * staged

    def ag(block, n, times=1):          # all-gather of an n-way cut block
        op(n, times, (n - 1) * block, block)

    def rs(block, n, times=1):          # reduce-scatter to a block
        op(n, times, (n - 1) * block, n * block)

    def ar(nbytes, n, times=1):
        op(n, times, 2 * (n - 1) / n * nbytes, nbytes)

    # the embedding: the ids (no gradient); the feature blocks over
    # 'model', then 'data', and their adjoints
    ag(b * seq * 4, dd)
    for block, n in ((b * dd * seq * d // (dd * m) * e, m),
                     (b * dd * seq * d // dd * e, dd)):
        ag(block, n)
        rs(block, n)
    # each layer's FSDP gathers: forward, recompute; adjoint
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    for n_el in (d * hq * hd, d * hkv * hd, d * hkv * hd, hq * hd * d,
                 d * cfg.d_ff, d * cfg.d_ff, cfg.d_ff * d):
        ag(n_el // (dd * m) * f, dd, 2 * n_layers)
        rs(n_el // (dd * m) * f, dd, n_layers)
    # a sequence block's rows: entries and the final rows in cfg.dtype,
    # the exits' partial sums in float32
    rows = b * (seq // m if sp else seq) * d
    if sp and pcfg.sp_boundary == "layer":
        # a layer's entry: forward, recompute; adjoint
        ag(rows * e, m, 2 * n_layers)
        rs(rows * e, m, n_layers)
        # the attention's exit, an all-reduce of the whole rows: forward,
        # recompute, adjoint; the MLP's exit and its adjoint
        ar(rows * m * f, m, 3 * n_layers)
        rs(rows * f, m, n_layers)
        ag(rows * f, m, n_layers)
    elif sp:
        # a layer's two entries: forward, recompute; adjoints
        ag(rows * e, m, 2 * 2 * n_layers)
        rs(rows * e, m, 2 * n_layers)
        # its two exits: forward, the attention's recomputed; adjoints
        rs(rows * f, m, 3 * n_layers)
        ag(rows * f, m, 2 * n_layers)
    else:
        # a layer's two exits: forward, the attention's recomputed;
        # adjoints
        ar(rows * f, m, 5 * n_layers)
    if sp:      # the final rows gathered, and the adjoint
        ag(rows * e, m)
        rs(rows * e, m)
    # the loss: per chunk the head's gather and three all-reduces, all
    # recomputed; the adjoints of the gather and of two of them
    if cfg.tie_embeddings:
        table = cfg.vocab_size * d // dd * e
        for block, n in ((table // m, m), (table, dd)):
            ag(block, n, 2 * chunks)
            rs(block, n, chunks)
    else:
        head = d // dd * (cfg.vocab_size // m) * e
        ag(head, dd, 2 * chunks)
        rs(head, dd, chunks)
    ar(b * c * f, m, 8 * chunks)
    # the replicated leaves' gradients, one bucket per axis; the loss's
    # sum over 'data'; the clip's sum per axis of the cut leaves' squares
    mesh = MeshShape(tuple(sizes), tuple(sizes.values()))
    specs = flatten_paths(config_specs(cfg, mesh))
    axes = {k: {a for e in spec for a in entry_axes(e)}
            for k, spec in specs.items()}
    shapes = _param_shapes(cfg)
    for axis, n in (("data", dd), ("model", m)):
        ar(sum(math.prod(shapes[k]) for k in specs
               if axis not in axes[k]) * f, n)
    ar(4, dd)
    for cut in {tuple(sorted(a)) for a in axes.values() if a}:
        for a in cut:
            ar(4, sizes[a])
    return log


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
