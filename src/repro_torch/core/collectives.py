"""SMLA-adapted collective schedules (port of ``repro/core/collectives.py``).

The paper coordinates multiple DRAM layers behind one shared IO channel:

* **Dedicated-IO** — statically partition the channel; every layer owns a
  dedicated 1/L slice for the whole transfer.  Here: the one fused
  collective of the process group's backend (all-gather, all-reduce),
  where every shard's traffic occupies its own share of every link.
* **Cascaded-IO** — time-multiplex the full channel through neighbours;
  each node first emits its own block, then forwards upstream blocks.
  Here: a ring of point-to-point hops, each one
  ``dist.batch_isend_irecv`` that sends to group rank i+1 and receives
  from i-1 (the reference's ``_fwd_perm``), so hop h carries the blocks
  injected h hops upstream.

Every function takes the process group of the mesh axis it runs over (the
reference's axis name; ``core.comm.axis_group(mesh, "pod")``) and runs
the same on every backend: NCCL on cards, gloo on the CPU.  gloo's
point-to-point calls take host tensors only, so on a gloo group a CUDA
tensor travels through a host copy (``core.comm.stages_on_host``); that
holds for its fused collectives too, so every gloo transfer of a CUDA
tensor is staged here, in the open, and counted
(`CommLog.staged_bytes`).  That is how ranks that share one card (NCCL
refuses two ranks on one device) run.

The ring primitives add in the reference's order, so their float32
results equal the reference's bit for bit.  `tree_sync` reduces a
gradient tree across the 'pod' axis leaf by leaf; `pod_sync_wrap` wraps a
gradient function with it (the hierarchical cross-pod sync of
``train/step.py``).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core.comm import (CommLog, axis_group, axis_sizes, ring_hop,
                                   stages_on_host, to_host)
from repro_torch.models.common import map_tree
from repro_torch.train.compression import compressed_ring_all_reduce

#: `tree_sync`'s modes; `pod_sync_wrap` also takes "auto" (as "dedicated")
MODES = ("cascaded", "dedicated", "cascaded_int8")


def _n_rank(group) -> tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


# ----------------------------------------------------------------------------
# ring primitives (each hop a ``core.comm.ring_hop``)
# ----------------------------------------------------------------------------


def cascaded_all_gather(x, group, log: CommLog | None = None):
    """Ring all-gather: returns (n, *x.shape) ordered by source rank.

    Hop h forwards the block received at hop h-1 (Cascaded-IO: send own
    data first, then relay upper layers).  n-1 hops; hop h moves exactly
    one block per rank — the paper's time-sliced schedule."""
    n, i = _n_rank(group)
    blocks = [x]                                       # index h: src i-h
    for _ in range(n - 1):
        blocks.append(ring_hop((blocks[-1],), group, log)[0])
    return torch.stack([blocks[(i - j) % n] for j in range(n)])


def cascaded_reduce_scatter(x, group, log: CommLog | None = None):
    """Ring reduce-scatter over the leading dim (must equal the group
    size).

    x (n, ...) per rank; returns block i fully reduced on rank i.  The
    partial sum destined for block b starts at rank b+1 and accumulates as
    it cascades around the ring: hop s adds the rank's own block to the
    forwarded partial, ``p = q + x[(i-1-s) % n]``, the reference's
    order."""
    n, i = _n_rank(group)
    if x.shape[0] != n:
        raise ValueError(f"cascaded_reduce_scatter: leading dim "
                         f"{x.shape[0]} != group size {n}")
    p = x[(i - 1) % n]
    for s in range(1, n):
        q, = ring_hop((p,), group, log)
        p = q + x[(i - 1 - s) % n]
    return p


def cascaded_all_reduce(x, group, log: CommLog | None = None):
    """Ring all-reduce = ring reduce-scatter + ring all-gather (2(n-1)
    hops, each moving 1/n of the data — bandwidth-optimal); x is padded
    to a multiple of n elements and cut back."""
    n, _ = _n_rank(group)
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n
    flat = torch.nn.functional.pad(flat, (0, pad))
    mine = cascaded_reduce_scatter(flat.reshape(n, -1), group, log)
    full = cascaded_all_gather(mine, group, log).reshape(-1)
    full = full[:flat.shape[0] - pad] if pad else full
    return full.reshape(x.shape)


def _fused(x, group, log, share: float):
    """`x` as the fused collective sees it (a host copy where it is
    staged), counted with `share` x its bytes on the wire."""
    staged = stages_on_host(x, group)
    buf = (to_host(x.detach()) if staged else x.detach().clone()).contiguous()
    if log is not None:
        n_bytes = buf.numel() * buf.element_size()
        log.ops += 1
        log.wire_bytes += round(share * n_bytes)
        log.staged_bytes += n_bytes if staged else 0
    return buf, staged


def dedicated_all_gather(x, group, log: CommLog | None = None):
    """The backend's fused all-gather (statically partitioned channel):
    (n, *x.shape) ordered by source rank."""
    n, _ = _n_rank(group)
    buf, staged = _fused(x, group, log, n - 1)   # (n-1)/n of n blocks
    # the blocks land in place, in page-locked memory where staged
    out = torch.empty((n,) + tuple(buf.shape), dtype=buf.dtype,
                      device=buf.device, pin_memory=staged)
    dist.all_gather(list(out.unbind(0)), buf, group=group)
    return out.to(x.device) if staged else out


def dedicated_all_reduce(x, group, log: CommLog | None = None):
    """The backend's fused all-reduce (sum), out of place."""
    n, _ = _n_rank(group)
    buf, staged = _fused(x, group, log, 2 * (n - 1) / n)
    dist.all_reduce(buf, group=group)
    return buf.to(x.device) if staged else buf


# ----------------------------------------------------------------------------
# pytree sync across an axis
# ----------------------------------------------------------------------------


def tree_sync(tree, group, mode: str = "cascaded", mean: bool = True,
              log: CommLog | None = None):
    """Sum (or mean) a tree of tensors across `group`, leaf by leaf.

    Per leaf, not bucketed, as the reference (where a bucket would
    unshard leaves that stay sharded over 'data'/'model').  The ring
    chunks a leaf on its leading dim (the stacked-layer dim) when that
    divides by n; scalars and indivisible leaves take the fused sum.
    Every rank must pass a tree of the same structure: the leaves go in
    the sorted-key order of ``models.common.leaves``.

    mode: cascaded (ring) | dedicated (fused all-reduce) | cascaded_int8
    (the compressed ring of ``train/compression.py`` on the flattened
    leaf)."""
    if mode not in MODES:
        raise ValueError(f"tree_sync: mode {mode!r} not in {MODES}")
    n, _ = _n_rank(group)

    def one(leaf):
        ring_ok = leaf.dim() >= 1 and leaf.shape[0] % n == 0 and n > 1
        if mode == "dedicated" or not ring_ok:
            total = dedicated_all_reduce(leaf, group, log)
        elif mode == "cascaded":
            blocks = leaf.reshape(n, leaf.shape[0] // n, *leaf.shape[1:])
            mine = cascaded_reduce_scatter(blocks, group, log)
            total = cascaded_all_gather(mine, group, log).reshape(leaf.shape)
        else:
            flat = leaf.reshape(-1).to(torch.float32)
            total = compressed_ring_all_reduce(flat, group, log=log) \
                .reshape(leaf.shape).to(leaf.dtype)
        return (total / n).to(leaf.dtype) if mean else total

    return map_tree(one, tree)


# ----------------------------------------------------------------------------
# cross-pod hierarchical gradient sync
# ----------------------------------------------------------------------------


def local_batch(batch: dict, mesh) -> dict:
    """This rank's share of a global batch over the mesh's 'pod' axis, as
    the reference's in_specs cut it: positions (3, B, S) on dim 1, every
    other leaf on its leading (batch) dim, in equal consecutive slices in
    group-rank order.  The batch as it is without a 'pod' axis of size
    > 1."""
    n = axis_sizes(mesh).get("pod", 1) if mesh is not None else 1
    if n == 1:
        return batch
    r = dist.get_rank(axis_group(mesh, "pod"))

    def cut(name, leaf):
        d = 1 if name == "positions" else 0
        b = leaf.shape[d]
        if b % n:
            raise ValueError(f"local_batch: {name} has {b} rows on dim {d}, "
                             f"not divisible by the {n} pods")
        k = b // n
        return leaf[:, r * k:(r + 1) * k] if d else leaf[r * k:(r + 1) * k]

    return {name: cut(name, leaf) for name, leaf in batch.items()}


def pod_sync_wrap(grad_fn: Callable, mesh, mode: str = "cascaded") -> Callable:
    """Wrap grad_fn(params, batch) -> ((loss, metrics), grads) with the
    cross-pod reduction: each rank computes the gradients of its share of
    the batch (`local_batch`), then the gradients are averaged over the
    'pod' group by `tree_sync` in `mode` ("cascaded" ring, "dedicated"
    fused, "cascaded_int8" compressed ring; "auto", where the reference
    leaves the reduction to GSPMD, is the backend's fused all-reduce of
    each gradient, as "dedicated"); the loss and metrics are averaged with
    one fused all-reduce.  A mesh with no 'pod' axis, or one of size 1:
    grad_fn itself."""
    if mesh is None or axis_sizes(mesh).get("pod", 1) == 1:
        return grad_fn
    if mode != "auto" and mode not in MODES:
        raise ValueError(f"pod_sync_wrap: mode {mode!r} not in "
                         f"{MODES + ('auto',)}")
    mode = "dedicated" if mode == "auto" else mode
    group = axis_group(mesh, "pod")
    n = dist.get_world_size(group)

    def wrapped(params, batch) -> tuple[tuple[Any, dict], Any]:
        (loss, metrics), grads = grad_fn(params, batch)
        grads = tree_sync(grads, group, mode=mode, mean=True)
        names = sorted(metrics)
        vals = [loss] + [torch.as_tensor(metrics[k], device=loss.device)
                         for k in names]
        mean = dedicated_all_reduce(
            torch.stack([v.to(torch.float32) for v in vals]), group) / n
        metrics = {k: mean[j + 1].to(vals[j + 1].dtype)
                   for j, k in enumerate(names)}
        return (mean[0].to(loss.dtype), metrics), grads

    return wrapped
