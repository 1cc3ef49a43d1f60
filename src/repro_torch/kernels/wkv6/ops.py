"""Public entry of the WKV6 recurrence, layout (B, H, S, hd) (port of
``repro/kernels/wkv6/ops.py``).

The forward runs the kernel; the gradient recomputes through the
differentiable chunked path (`models.rwkv6.wkv_chunked`, at the same
chunk) under autograd, as the reference's ``custom_vjp`` does with
``jax.vjp`` of it: the reference has no backward kernel, so neither has
the port.  The recompute checkpoints each chunk (`remat_chunks`), so its
graph holds one chunk's (B, c, c, H, hd) decay tensors at a time instead
of every chunk's; the values are the same.

Dispatch is by device, in both directions: a CUDA tensor launches the
kernel (`kernel.wkv6`) or raises; a CPU tensor runs the plain version
(`plain`, the chunked path).  Neither falls back to the other, and any
other device raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.wkv6 import kernel as K


def _f32(x):
    """`x` as contiguous float32, copied at most once."""
    if x.dtype == torch.float32:
        return x.contiguous()
    return x.to(torch.float32, memory_format=torch.contiguous_format)


def plain(r, k, v, logw, u, chunk: int = 64, *, remat_chunks: bool = False):
    """The kernel's plain version: (y (B,H,S,hd) in r's dtype, final state
    (B,H,hd,hd) float32) from a zero state, by the chunked path of
    `models.rwkv6` (layout (B,S,H,hd), hence the transposed views)."""
    from repro_torch.models.rwkv6 import wkv_chunked
    b, h, s, hd = r.shape
    state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    tr = lambda a: a.transpose(1, 2)  # noqa: E731
    state, y = wkv_chunked(tr(r), tr(k), tr(v), tr(logw), u, state,
                           chunk=chunk, remat_chunks=remat_chunks)
    return tr(y), state


def wkv6_with_state(r, k, v, logw, u, chunk: int = 64):
    """Forward returning (y in r's dtype, final state float32), in float32
    arithmetic, as the reference's.  On the card the kernel reads the
    tensors as they are (`kernel.check_layout`: bf16 or float32 r, k, v,
    float32 logw and u, any strides with a unit hd axis) and is the one
    launch; on the CPU they are cast to float32 for the plain version."""
    if r.device.type not in ("cuda", "cpu"):
        raise ValueError(f"wkv6: unsupported device {r.device}")
    chunk = min(chunk, r.shape[2])
    if r.device.type == "cuda":
        return K.wkv6(r, k, v, logw, u, chunk=chunk)
    y, state = plain(*(_f32(a) for a in (r, k, v, logw, u)), chunk)
    return y.to(r.dtype), state


class WKV6(torch.autograd.Function):
    """y = wkv6(r, k, v, logw, u) by the kernel; its gradient through the
    chunked path."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, chunk):
        ctx.save_for_backward(r, k, v, logw, u)
        ctx.chunk = chunk
        return wkv6_with_state(r, k, v, logw, u, chunk)[0]

    @staticmethod
    def backward(ctx, dy):
        inputs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            y, _ = plain(*inputs, ctx.chunk, remat_chunks=True)
        return (*torch.autograd.grad(y, inputs, dy), None)


def wkv6(r, k, v, logw, u, chunk: int = 64):
    """r, k, v, logw (B, H, S, hd), u (H, hd) -> y (B, H, S, hd) in r's
    dtype, from a zero state; differentiable in every input."""
    return WKV6.apply(r, k, v, logw, u, chunk)
