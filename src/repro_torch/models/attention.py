"""Attention: RoPE / M-RoPE, GQA, three interchangeable implementations (port of
``repro/models/attention.py``).

Implementations (``ParallelConfig.attn_impl``):

* ``naive``    — full (Sq, Sk) score matrix; oracle for tests.
* ``chunked``  — blockwise online-softmax in plain PyTorch.  For causal
  masks the **diagonal-batched** schedule is used: q/kv are tiled into n
  blocks and the pairs (i, j<=i) are processed per diagonal offset, so
  only the lower triangle is ever materialised.
* ``pallas``   — the hand-written Hopper kernel of
  ``kernels/flash_attention`` (its plain version on CPU tensors).  The
  name is the reference's; here it selects the CUDA kernels.

Layouts: q (B, Sq, Hq, hd); k, v (B, Sk, Hkv, hd); GQA via head grouping.
All softmax statistics in float32.  Where the reference asks for float32
products of bf16 operands (``preferred_element_type``), the operands are
upcast to float32 (`common.matmul_f32`); where it casts probabilities to
``v.dtype`` before the product with V, so does this module.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


# ----------------------------------------------------------------------------
# Rotary embeddings
# ----------------------------------------------------------------------------


def _rope_angles(positions, head_dim: int, theta: float):
    """positions (..., S) -> angles (..., S, head_dim//2) float32."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    # correctly rounded, as XLA's float32 pow gives it (torch's float32
    # pow is off by an ulp for some bands)
    inv_freq = (theta ** exponent.double()).float()
    return positions.float()[..., None] * inv_freq


def _rotate(x, cos, sin):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x (B, S, H, hd); positions (B, S) int."""
    ang = _rope_angles(positions, x.shape[-1], theta)      # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)


def mrope_sections(head_dim: int) -> tuple[int, int, int]:
    """Qwen2-VL split of the hd/2 frequency bands into (t, h, w) sections —
    ratio (1/4, 3/8, 3/8): hd=128 -> (16, 24, 24)."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def apply_mrope(x, positions3, theta: float = 1_000_000.0):
    """Multimodal RoPE.  positions3 (3, B, S) = (temporal, height, width) ids.

    Frequency bands are partitioned into three sections; each section
    rotates by its own position stream (paper: Qwen2-VL §2.1)."""
    head_dim = x.shape[-1]
    ang_all = _rope_angles(positions3, head_dim, theta)    # (3, B, S, hd/2)
    ang = torch.cat([part[i] for i, part in enumerate(torch.split(
        ang_all, mrope_sections(head_dim), dim=-1))], dim=-1)  # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)


def position_embed(q, k, positions, rope_type: str, theta: float):
    if rope_type == "rope":
        return apply_rope(q, positions, theta), apply_rope(k, positions, theta)
    if rope_type == "mrope":
        return (apply_mrope(q, positions, theta),
                apply_mrope(k, positions, theta))
    if rope_type == "none":
        return q, k
    raise ValueError(rope_type)


# ----------------------------------------------------------------------------
# Core attention implementations
# ----------------------------------------------------------------------------


def _group(q, n_kv: int):
    """(B, S, Hq, hd) -> (B, S, Hkv, G, hd)."""
    b, s, hq, hd = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, hd)


def attend_naive(q, k, v, *, causal: bool, q_offset: int = 0,
                 kv_len=None):
    """Oracle. q (B,Sq,Hq,hd), k/v (B,Sk,Hkv,hd). q_offset: absolute position
    of q[0] (for cached decode). kv_len: optional (B,) valid kv lengths."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = _group(q, hkv)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    scores = scores / math.sqrt(hd)
    dev = q.device
    if causal:
        qpos = torch.arange(sq, device=dev) + q_offset
        mask = qpos[:, None] >= torch.arange(sk, device=dev)[None, :]
        scores = torch.where(mask[None, None, None], scores, NEG_INF)
    if kv_len is not None:
        valid = torch.arange(sk, device=dev)[None, :] < kv_len[:, None]
        scores = torch.where(valid[:, None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = _pv(probs.to(v.dtype), v, "bkgqs,bskh->bqkgh")
    return out.reshape(b, sq, hq, hd)


def _pv(probs, v, eq):
    """einsum of probabilities (already in v's dtype) with v, result in
    v's dtype, accumulated in float32."""
    return torch.einsum(eq, probs.float(), v.float()).to(v.dtype)


def _online_update(acc, m, l, scores, vblk):
    """One online-softmax accumulation step.

    acc (..., q, hd) f32; m, l (..., q); scores (..., q, s) f32;
    vblk (..., s, hd)."""
    m_new = torch.maximum(m, scores.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.matmul(p, vblk.float())
    return acc_new, m_new, l_new


def attend_chunked(q, k, v, *, causal: bool, chunk: int = 1024,
                   kv_len=None):
    """Blockwise attention.  Non-causal: loop over kv blocks.  Causal:
    diagonal-batched lower-triangular schedule (exact FLOPs)."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(hd)

    if causal and sq == sk and sq % chunk == 0 and sq > chunk:
        return _attend_causal_diag(q, k, v, chunk)

    c = min(chunk, sk)
    if sk % c != 0:  # fall back to oracle on ragged shapes
        return attend_naive(q, k, v, causal=causal, kv_len=kv_len)
    n = sk // c
    dev = q.device
    qg = _group(q, hkv).float()                            # (b,sq,hkv,g,hd)
    acc = torch.zeros((b, hkv, g, sq, hd), dtype=torch.float32, device=dev)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    for j in range(n):
        kj = k[:, j * c:(j + 1) * c]
        vj = v[:, j * c:(j + 1) * c]
        scores = torch.einsum("bqkgh,bskh->bkgqs", qg, kj.float()) * scale
        kpos = j * c + torch.arange(c, device=dev)
        if causal:
            mask = torch.arange(sq, device=dev)[:, None] >= kpos[None, :]
            scores = torch.where(mask[None, None, None], scores, NEG_INF)
        if kv_len is not None:
            valid = kpos[None, :] < kv_len[:, None]        # (b, c)
            scores = torch.where(valid[:, None, None, None, :], scores,
                                 NEG_INF)
        acc, m, l = _online_update(acc, m, l, scores,
                                   vj.permute(0, 2, 1, 3)[:, :, None])
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd)
    return out.to(q.dtype)


def _attend_causal_diag(q, k, v, chunk: int):
    """Diagonal-batched causal attention: process block pairs (i, i-off) for
    off = 0..n-1; each offset is one batched matmul over n-off block rows.
    Only the lower triangle of the block grid is computed."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    c = chunk
    n = s // c
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    qb = _group(q, hkv).reshape(b, n, c, hkv, g, hd).float()
    kb = k.reshape(b, n, c, hkv, hd)
    vb = v.reshape(b, n, c, hkv, hd)

    acc = torch.zeros((b, n, hkv, g, c, hd), dtype=torch.float32, device=dev)
    m = torch.full((b, n, hkv, g, c), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, n, hkv, g, c), dtype=torch.float32, device=dev)

    ar = torch.arange(c, device=dev)
    tri = ar[:, None] >= ar[None, :]                       # within-block

    for off in range(n):
        rows = n - off                       # q blocks off..n-1 pair kv 0..
        qi = qb[:, off:]                     # (b, rows, c, hkv, g, hd)
        kj = kb[:, :rows]
        vj = vb[:, :rows]
        scores = torch.einsum("bnqkgh,bnskh->bnkgqs", qi,
                              kj.float()) * scale
        if off == 0:
            scores = torch.where(tri[None, None, None, None], scores,
                                 NEG_INF)
        a_new, m_new, l_new = _online_update(
            acc[:, off:], m[:, off:], l[:, off:], scores,
            vj.permute(0, 1, 3, 2, 4)[:, :, :, None])
        acc = torch.cat([acc[:, :off], a_new], dim=1)
        m = torch.cat([m[:, :off], m_new], dim=1)
        l = torch.cat([l[:, :off], l_new], dim=1)

    out = acc / torch.clamp_min(l, 1e-30)[..., None]   # (b,n,hkv,g,c,hd)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, s, hq, hd)
    return out.to(q.dtype)


# ----------------------------------------------------------------------------
# Public entry points
# ----------------------------------------------------------------------------


def attend(q, k, v, *, causal: bool, impl: str = "chunked",
           chunk: int = 1024, kv_len=None):
    if impl == "naive":
        return attend_naive(q, k, v, causal=causal, kv_len=kv_len)
    if impl == "chunked":
        return attend_chunked(q, k, v, causal=causal, chunk=chunk,
                              kv_len=kv_len)
    if impl == "pallas":
        from repro_torch.kernels.flash_attention import ops as fa_ops
        if kv_len is None and causal and q.shape[1] == k.shape[1]:
            return fa_ops.flash_attention(q, k, v, causal=True)
        return attend_chunked(q, k, v, causal=causal, chunk=chunk,
                              kv_len=kv_len)
    raise ValueError(f"unknown attn impl {impl!r}")


def decode_attend(q, k_cache, v_cache, cache_len):
    """Single-token decode attention over a KV cache.

    q (B, 1, Hq, hd); caches (B, Smax, Hkv, hd); cache_len (B,) valid length
    (the new token's kv must already be written at cache_len-1).  The
    result is in the cache's dtype, as in the reference.
    """
    b, _, hq, hd = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = _group(q, hkv)[:, 0]                              # (B, Hkv, G, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float())
    scores = scores / math.sqrt(hd)
    valid = (torch.arange(smax, device=q.device)[None, :]
             < cache_len[:, None])
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = _pv(probs.to(v_cache.dtype), v_cache, "bkgs,bskh->bkgh")
    return out.reshape(b, 1, hq, hd)


def decode_attend_sharded(q, k_block, v_block, cache_len, start: int,
                          gather):
    """`decode_attend` over a sequence-sharded KV cache (the reference's
    fallback layout, whose softmax reductions over Smax lower to psums),
    in plain PyTorch on any device: this rank's blocks (B, rows, Hkv, hd)
    hold positions [start, start + rows); the rank's partial softmax
    state over its valid rows (m, l, acc, float32) is gathered from every
    rank by `gather` (dim 2, position order) and merged in that order,
    the plain version of the flash-decode kernels' split and combine
    (``kernels/decode_attention/ref.py``).  q (B, 1, Hq, hd); cache_len
    (B,) the lanes' global valid lengths.  The result is in q's dtype."""
    from repro_torch.kernels.decode_attention import ref as dec_ref
    b, _, hq, hd = q.shape
    hkv = k_block.shape[2]
    out = dec_ref.decode_attend_sharded(
        _group(q, hkv)[:, 0], k_block.transpose(1, 2),
        v_block.transpose(1, 2), cache_len, start, gather)
    return out.reshape(b, 1, hq, hd)
