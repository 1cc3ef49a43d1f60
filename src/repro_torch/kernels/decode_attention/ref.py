"""Plain PyTorch version of single-token decode attention over a KV cache
(port of ``repro/kernels/decode_attention/ref.py``).  It is what the
kernel's wrapper runs on CPU tensors and what the kernel is held against
on the card."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attend(q, k_cache, v_cache, lengths):
    """q (B, Hkv, G, hd); caches (B, Hkv, S, hd); lengths (B,) valid prefix.
    Returns (B, Hkv, G, hd) in q's dtype; everything in between is
    float32."""
    b, hkv, g, hd = q.shape
    s = k_cache.shape[2]
    scores = torch.einsum("bkgh,bksh->bkgs", q.float(),
                          k_cache.float()) / math.sqrt(hd)
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bksh->bkgh", probs, v_cache.float())
    return out.to(q.dtype)


def split_partials(q, k_cache, v_cache, lengths, rows: int):
    """The split kernel's arithmetic, plainly: the cache rows cut into
    splits of `rows` (the last one ends at S), each split's softmax state
    over its rows below the lane's length.  q (B, Hkv, G, hd); caches (B,
    Hkv, S, hd).  Returns m, l (B, Hkv, n_splits, G) and acc (B, Hkv,
    n_splits, G, hd), float32; a split with no row below the length gives
    m = -inf, l = 0, acc = 0."""
    b, hkv, g, hd = q.shape
    s = k_cache.shape[2]
    n_splits = -(-s // rows)
    scores = torch.einsum("bkgh,bksh->bkgs", q.float(),
                          k_cache.float()) / math.sqrt(hd)
    pos = torch.arange(s, device=q.device)
    valid = pos[None, :] < lengths.clamp(0, s)[:, None]          # (B, S)
    ms, ls, accs = [], [], []
    for i in range(n_splits):
        sl = slice(i * rows, min((i + 1) * rows, s))
        ok = valid[:, None, None, sl]
        sc = torch.where(ok, scores[..., sl], -math.inf)
        m = sc.amax(-1)
        p = torch.where(ok, torch.exp(sc - torch.where(
            torch.isinf(m), 0.0, m)[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgs,bksh->bkgh", p,
                                 v_cache[:, :, sl].float()))
    return torch.stack(ms, 2), torch.stack(ls, 2), torch.stack(accs, 2)


def combine_splits(m, l, acc, dtype):
    """Merge split partials (`split_partials`' layout) in split order, as
    the combine kernel does, step for step: M the largest m; each split
    weighted by exp(m - M) (0 for an empty split), the weighted l and acc
    summed split after split with every product and sum rounded to
    float32 on its own; o = acc / max(l, 1e-30), so a lane with no row
    gives zeros.  Returns (B, Hkv, G, hd) in `dtype`."""
    big = m.amax(2, keepdim=True)
    w = torch.where(m == -math.inf, 0.0, torch.exp(m - big))
    total_l = torch.zeros_like(m[:, :, 0])
    total = torch.zeros_like(acc[:, :, 0])
    for i in range(m.shape[2]):
        total_l = total_l + w[:, :, i] * l[:, :, i]
        total = total + w[:, :, i, :, None] * acc[:, :, i]
    return (total / total_l.clamp_min(1e-30)[..., None]).to(dtype)


def gather_partials(m, l, acc, gather):
    """Every rank's partials of a sequence-sharded cache, joined on the
    split dim in the ranks' position order: m, l and acc packed into one
    (B, Hkv, S, G, 2 + hd) float32 tensor, so that `gather` (a collective
    that joins its argument's dim 2 over the ranks holding the sequence's
    blocks) moves them in one call, and unpacked into views of one flat
    workspace (the layout the combine kernel reads: all of m, then l,
    then acc)."""
    packed = gather(torch.cat([m[..., None], l[..., None], acc], -1))
    shape = packed.shape[:-1]
    n = packed[..., 0].numel()
    ws = torch.empty(n * packed.shape[-1], dtype=torch.float32,
                     device=packed.device)
    m2, l2 = ws[:n].view(shape), ws[n:2 * n].view(shape)
    acc2 = ws[2 * n:].view(*shape, packed.shape[-1] - 2)
    m2.copy_(packed[..., 0])
    l2.copy_(packed[..., 1])
    acc2.copy_(packed[..., 2:])
    return m2, l2, acc2


def block_lengths(lengths, start: int, rows: int):
    """The valid rows of a block of `rows` cache positions that starts at
    position `start`, per lane: the global `lengths` (B,) moved to the
    block's origin and clamped to [0, rows], int32."""
    return (lengths - start).clamp(0, rows).to(torch.int32).contiguous()


def decode_attend_sharded(q, k_block, v_block, lengths, start: int, gather):
    """`decode_attend` over a sequence-sharded cache, plainly: this rank's
    block's softmax state as one split (`split_partials`), every rank's
    gathered (`gather_partials`) and merged (`combine_splits`).  q (B,
    Hkv, G, hd); blocks (B, Hkv, rows, hd) holding positions [start,
    start + rows); lengths (B,) the lanes' global valid lengths.  Returns
    (B, Hkv, G, hd) in q's dtype."""
    rows = k_block.shape[2]
    m, l, acc = split_partials(q, k_block, v_block,
                               block_lengths(lengths, start, rows),
                               max(rows, 1))
    return combine_splits(*gather_partials(m, l, acc, gather), q.dtype)
