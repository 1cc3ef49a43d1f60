"""Public entry of the SMLA cascaded-pipeline matmul (port of
``repro/kernels/smla_pipe/ops.py``).

Dispatch is by device, in both directions: a CUDA tensor launches the
kernel (`kernel.matmul_cascaded`, `kernel.matmul_dedicated`) or raises;
a CPU tensor runs the plain version (`ref.cascaded`, `ref.dedicated`).
Neither falls back to the other, and any other device raises.  The
reference's block sizes (bm, bn, bk) are the TPU's tiling and have no
counterpart: the kernel's tiles are fixed, and the plain versions walk
the reference's default 128-row stripe chunks.
"""
from __future__ import annotations

from repro_torch.kernels.smla_pipe import kernel as K
from repro_torch.kernels.smla_pipe import ref as R


def _on_card(x) -> bool:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"smla_pipe: unsupported device {x.device}")
    return x.device.type == "cuda"


def matmul_cascaded(x, w):
    """x (M, K); w (L, K//L, N) -> (M, N) float32: Cascaded-IO, one
    accumulator fed layer by layer, stripe chunk by stripe chunk."""
    return K.matmul_cascaded(x, w) if _on_card(x) else R.cascaded(x, w)


def matmul_dedicated(x, w):
    """x (M, K); w (L, K//L, N) -> (M, N) float32: Dedicated-IO, one
    product per layer slab, the L partials summed."""
    return K.matmul_dedicated(x, w) if _on_card(x) else R.dedicated(x, w)
