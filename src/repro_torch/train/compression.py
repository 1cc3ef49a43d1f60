"""Int8 gradient compression with error feedback, for the cross-pod hop
(port of ``repro/train/compression.py``).

Wire format: per-block (block=1024) max-abs scales (float32) + int8
mantissas — a 3.9x wire reduction.  The cascaded ring decodes, accumulates
in float32 and re-encodes at every hop (the standard compressed-ring
trade-off: quantisation noise grows with the hops; with 2-8 pods it is
small, and the error-feedback residual of `encode_error` folds the local
encode error back into the next step's gradient).

``torch.round`` rounds half to even, as ``jnp.round`` does, so `quantize`
gives the reference's int8 values bit for bit.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.comm import ring_hop

BLOCK = 1024


def quantize(flat: torch.Tensor, block: int = BLOCK):
    """flat (T,) float32 -> (q (nb, block) int8, scale (nb,) float32, T)."""
    t = flat.shape[0]
    pad = (-t) % block
    x = F.pad(flat, (0, pad)).reshape(-1, block)
    scale = x.abs().amax(dim=1) / 127.0
    safe = scale.clamp_min(1e-12)
    q = torch.clamp(torch.round(x / safe[:, None]), -127, 127).to(torch.int8)
    return q, scale, t


def dequantize(q, scale, t):
    x = q.to(torch.float32) * scale[:, None]
    return x.reshape(-1)[:t]


def encode_error(flat):
    """Returns (wire_value, local_error) — error feedback residual."""
    q, s, t = quantize(flat)
    deq = dequantize(q, s, t)
    return deq, flat - deq


def compressed_ring_all_reduce(flat, group, block: int = BLOCK, log=None):
    """Sum of `flat` (T,) float32 over the ranks of `group` by a ring whose
    every hop moves int8 + scales instead of float32.

    Phase 1 (reduce-scatter): the partial destined for chunk b cascades
    around the ring; each rank dequantises, adds its own chunk,
    requantises.  Phase 2 (all-gather): the fully-reduced chunks cascade
    back compressed.  Each hop is one ``core.comm.ring_hop`` of the
    mantissas and the scales; `log` (a ``core.comm.CommLog``) counts
    them."""
    n = dist.get_world_size(group)
    i = dist.get_rank(group)
    t = flat.shape[0]
    pad = (-t) % (n * block)
    x = F.pad(flat, (0, pad)).reshape(n, -1)          # (n, chunk)
    chunk = x.shape[1]

    def q_(v):
        q, s, _ = quantize(v, block)
        return q, s

    def dq_(q, s):
        return dequantize(q, s, chunk)

    # --- reduce-scatter ------------------------------------------------
    q, s = q_(x[(i - 1) % n])
    for s_idx in range(1, n):
        q, s = ring_hop((q, s), group, log)
        q, s = q_(dq_(q, s) + x[(i - 1 - s_idx) % n])
    mine = dq_(q, s)                                  # chunk i, reduced

    # --- all-gather (compressed) ----------------------------------------
    got = [q_(mine)]                                  # index h: chunk i-h
    for _ in range(n - 1):
        got.append(ring_hop(got[-1], group, log))
    full = torch.empty_like(x)
    for h, (qh, sh) in enumerate(got):
        full[(i - h) % n] = dq_(qh, sh)
    full = full.reshape(-1)
    return full[:t] if pad else full
