"""Plain PyTorch version of flash attention (port of
``repro/kernels/flash_attention/ref.py``): GQA, causal or full, and its
backward written out as formulas.  It is what the kernels' wrappers run
on CPU tensors and what the kernels are held against on the card."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _scores(qg, k, causal: bool):
    """Scaled, masked float32 scores (B, Hkv, G, S, S) of grouped q
    (B, Hkv, G, S, hd) float32 against k (B, Hkv, S, hd)."""
    s = qg.shape[3]
    scores = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float())
    scores = scores * (1.0 / math.sqrt(qg.shape[-1]))
    if causal:
        ar = torch.arange(s, device=qg.device)
        mask = ar[:, None] >= ar[None, :]
        scores = torch.where(mask[None, None, None], scores, NEG_INF)
    return scores


def attention(q, k, v, *, causal: bool = True):
    """q (B, Hq, S, hd); k/v (B, Hkv, S, hd) -> (out, lse).

    out (B, Hq, S, hd) in q's dtype; lse (B, Hq, S) float32 = logsumexp
    of the scaled scores.  Everything in between is float32."""
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, s, hd).float()
    scores = _scores(qg, k, causal)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum("bkgqs,bksh->bkgqh", probs, v.float())
    return (out.reshape(b, hq, s, hd).to(q.dtype),
            lse.reshape(b, hq, s))


def attention_bwd(q, k, v, o, lse, do, *, causal: bool = True):
    """The backward of `attention`, the reference's Pallas backward's
    formulas in float32: q, o, do (B, Hq, S, hd); k/v (B, Hkv, S, hd);
    lse (B, Hq, S) from the forward -> (dq, dk, dv) in q's, k's and v's
    dtypes, dk and dv summed over the G q heads of each kv head.

    delta = rowsum(do * o); p = exp(s - lse); dv = p^T do;
    dp = do v^T; ds = p (dp - delta) / sqrt(hd); dk = ds^T q; dq = ds k."""
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, s, hd).float()
    dog = do.reshape(b, hkv, g, s, hd).float()
    delta = (dog * o.reshape(b, hkv, g, s, hd).float()).sum(-1)
    p = torch.exp(_scores(qg, k, causal)
                  - lse.reshape(b, hkv, g, s).float()[..., None])
    dv = torch.einsum("bkgqs,bkgqh->bksh", p, dog)
    dp = torch.einsum("bkgqh,bksh->bkgqs", dog, v.float())
    ds = p * (dp - delta[..., None]) * (1.0 / math.sqrt(hd))
    dk = torch.einsum("bkgqs,bkgqh->bksh", ds, qg)
    dq = torch.einsum("bkgqs,bksh->bkgqh", ds, k.float())
    return (dq.reshape(b, hq, s, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
