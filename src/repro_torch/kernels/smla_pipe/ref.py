"""Plain PyTorch versions of the SMLA cascaded-pipeline matmul (port of
``repro/kernels/smla_pipe/ref.py``, plus the plain versions of the two
kernels).  `matmul_striped` is the oracle; `cascaded` and `dedicated`
repeat the kernels' order of work with float32 products, and are what
the wrappers run on CPU tensors and what the kernel is held against on
the card."""
from __future__ import annotations

import torch

#: stripe rows per chunk of the plain versions (the reference's bk)
BK = 128


def matmul_striped(x, w):
    """x (M, K); w (L, K//L, N) — weights striped across L 'layers'.
    out = x @ concat(w) : (M, N) float32."""
    l, kpl, n = w.shape
    return torch.matmul(x.float(), w.reshape(l * kpl, n).float())


def cascaded(x, w, bk: int = BK):
    """Cascaded-IO: one accumulator fed layer 0's stripe chunks of `bk`
    rows, then layer 1's, ...; float32 products.  Any M, N and K/L (the
    last chunk of a stripe may be short)."""
    m, k = x.shape
    l, kpl, n = w.shape
    if l * kpl != k:
        raise ValueError(f"x {tuple(x.shape)} vs w {tuple(w.shape)}: K != "
                         f"L * K/L")
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for layer in range(l):
        xl = x[:, layer * kpl:(layer + 1) * kpl]
        for k0 in range(0, kpl, bk):
            acc += torch.matmul(xl[:, k0:k0 + bk].float(),
                                w[layer, k0:k0 + bk].float())
    return acc


def dedicated(x, w, bk: int = BK):
    """Dedicated-IO: each layer slab into its own partial (M, N), the L
    partials summed after, ((p0 + p1) + p2) + ..., as the reference."""
    kpl = w.shape[1]
    out = None
    for layer in range(w.shape[0]):
        part = cascaded(x[:, layer * kpl:(layer + 1) * kpl],
                        w[layer:layer + 1], bk)
        out = part if out is None else out + part
    return out
