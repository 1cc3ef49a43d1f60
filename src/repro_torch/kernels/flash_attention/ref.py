"""Plain PyTorch version of flash attention (port of
``repro/kernels/flash_attention/ref.py``): GQA, causal or full.  It is
what the kernel's wrapper runs on CPU tensors and what the kernel is held
against on the card."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention(q, k, v, *, causal: bool = True):
    """q (B, Hq, S, hd); k/v (B, Hkv, S, hd) -> (out, lse).

    out (B, Hq, S, hd) in q's dtype; lse (B, Hq, S) float32 = logsumexp
    of the scaled scores.  Everything in between is float32."""
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, s, hd).float()
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float())
    scores = scores * scale
    if causal:
        ar = torch.arange(s, device=q.device)
        mask = ar[:, None] >= ar[None, :]
        scores = torch.where(mask[None, None, None], scores, NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum("bkgqs,bksh->bkgqh", probs, v.float())
    return (out.reshape(b, hq, s, hd).to(q.dtype),
            lse.reshape(b, hq, s))
