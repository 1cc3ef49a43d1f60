"""Public entry of flash-decode, model layout (port of
``repro/kernels/decode_attention/ops.py``; no grads on the decode path).

Dispatch is by device: a CUDA tensor launches the kernel
(`kernel.decode_attention`, which reads the cache in place) or raises; a
CPU tensor runs the plain version (`ref.decode_attend`).  Neither falls
back to the other.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import kernel as K
from repro_torch.kernels.decode_attention import ref as R


def decode_attention(q, k_cache, v_cache, lengths):
    """Model layout: q (B, 1, Hq, hd); caches (B, S, Hkv, hd); lengths (B,)
    int32.  Returns (B, 1, Hq, hd) in q's dtype."""
    if q.device.type == "cuda":
        return K.decode_attention(q, k_cache, v_cache, lengths)
    if q.device.type != "cpu":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    b, _, hq, hd = q.shape
    hkv = k_cache.shape[2]
    qk = q[:, 0].reshape(b, hkv, hq // hkv, hd)
    out = R.decode_attend(qk, k_cache.transpose(1, 2),
                          v_cache.transpose(1, 2), lengths)
    return out.reshape(b, 1, hq, hd)
