"""Public entry of flash attention, model layout (B, S, H, hd) (port of
``repro/kernels/flash_attention/ops.py``, forward only).

Dispatch is by device: a CUDA tensor launches the kernel
(`kernel.flash_attention_fwd`) or raises; a CPU tensor runs the plain
version (`ref.attention`).  Neither falls back to the other.  The
backward kernel and its ``torch.autograd.Function`` come with training
(ROADMAP Slice E); until then a tensor that requires grad raises.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref as R


def flash_attention(q, k, v, *, causal: bool = True):
    """q (B,S,Hq,hd), k/v (B,S,Hkv,hd) -> o (B,S,Hq,hd) in q's dtype."""
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention: the backward kernel is not ported yet "
            "(ROADMAP Slice E); call it under torch.inference_mode()")
    if q.device.type == "cuda":
        return K.flash_attention_fwd(q, k, v, causal=causal)[0]
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    o, _ = R.attention(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), causal=causal)
    return o.transpose(1, 2)
