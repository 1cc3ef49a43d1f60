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
