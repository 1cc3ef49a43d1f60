"""Public entry of flash attention, model layout (B, S, H, hd) (port of
``repro/kernels/flash_attention/ops.py``).

The reference's ``jax.custom_vjp`` becomes a ``torch.autograd.Function``:
its forward saves (q, k, v, o, lse) and its backward computes (dq, dk,
dv) from them.  Dispatch is by device, in both directions: a CUDA tensor
launches the kernels (`kernel.flash_attention_fwd`,
`kernel.flash_attention_bwd`) or raises; a CPU tensor runs the plain
versions (`ref.attention`, `ref.attention_bwd`).  Neither falls back to
the other, and any other device raises, so the CPU tests run the same
Function as the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref as R


def _check_device(q) -> None:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")


def _t(x):
    """(B, S, H, hd) <-> (B, H, S, hd), a view."""
    return x.transpose(1, 2)


def _forward(q, k, v, causal: bool):
    """(o (B,S,Hq,hd), lse (B,Hq,S) float32)."""
    _check_device(q)
    if q.device.type == "cuda":
        return K.flash_attention_fwd(q, k, v, causal=causal)
    o, lse = R.attention(_t(q), _t(k), _t(v), causal=causal)
    return _t(o), lse


def _backward(q, k, v, o, lse, do, causal: bool):
    """(dq, dk, dv) in the model layout."""
    _check_device(q)
    if q.device.type == "cuda":
        return K.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    return tuple(_t(x) for x in R.attention_bwd(
        _t(q), _t(k), _t(v), _t(o), lse, _t(do), causal=causal))


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v), its gradient by the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*_backward(q, k, v, o, lse, do, ctx.causal), None)


def flash_attention(q, k, v, *, causal: bool = True):
    """q (B,S,Hq,hd), k/v (B,S,Hkv,hd) -> o (B,S,Hq,hd) in q's dtype;
    differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v, causal)
