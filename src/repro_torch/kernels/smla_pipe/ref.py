"""Plain PyTorch versions of the SMLA cascaded-pipeline matmul (port of
``repro/kernels/smla_pipe/ref.py``, plus the plain versions of the
kernels).  `matmul_striped` is the oracle; `cascaded` and `dedicated`
repeat the kernels' order of work with float32 products, and are what
the wrappers run on CPU tensors and what the kernel is held against on
the card.  `split_tf32` and `stage_tf32` are the staging kernel's plain
version, bit for bit; `sum_partials` is Dedicated-IO's sum."""
from __future__ import annotations

import torch

#: stripe rows per chunk of the plain versions (the reference's bk)
BK = 128
#: the staging kernel's tiles (csrc/smla_pipe.cu): rows (x rows, w
#: columns) per tile, and stripe rows per chunk (one 128-byte row)
TILE_ROWS, CHUNK = 128, 32


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
    return sum_partials([cascaded(x[:, layer * kpl:(layer + 1) * kpl],
                                  w[layer:layer + 1], bk)
                         for layer in range(w.shape[0])])


def sum_partials(parts):
    """((parts[0] + parts[1]) + parts[2]) + ..., in float32."""
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def split_tf32(a):
    """float32 `a` -> (hi, lo), a ~ hi + lo: hi is `a` rounded to TF32
    (10 mantissa bits; to nearest, ties away from zero, as the card's
    ``cvt.rna.tf32.f32``) and lo is a - hi rounded the same way.  Both
    are float32 with their 13 low mantissa bits 0; for finite `a`, hi +
    lo is within 2^-22 of |a| (a bf16 `a` gives lo = 0).  By bit masks on
    the float32 pattern."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(a)
    return hi, rna(a - hi)


def planes_numel(x, w) -> int:
    """Floats of `stage_tf32`'s planes for x (M, K), w (L, K/L, N)."""
    m, (l, kpl, n) = x.shape[0], w.shape
    chunks = l * -(-kpl // CHUNK)
    tiles = (-(-m // TILE_ROWS) + -(-n // TILE_ROWS)) * chunks
    return (2 if x.dtype == torch.float32 else 1) * tiles * TILE_ROWS * CHUNK


def _tiles(a):
    """a (R, L, K/L) float32 -> its staged tiles, flat: rows padded with
    zeros to whole tiles, each stripe to whole chunks; tile (row block i,
    chunk t) at (i T + t), T = L x chunks per stripe, chunk t being chunk
    t % n_k of layer t // n_k; each tile's rows of CHUNK floats with
    16-byte piece c of row r stored at c ^ (r % 8) (wgmma's 128-byte
    swizzle)."""
    r, l, kpl = a.shape
    n_k, rt = -(-kpl // CHUNK), -(-r // TILE_ROWS)
    a = torch.nn.functional.pad(a, (0, n_k * CHUNK - kpl, 0, 0,
                                    0, rt * TILE_ROWS - r))
    a = a.reshape(rt, TILE_ROWS, l * n_k, 8, 4).permute(0, 2, 1, 3, 4)
    rows = torch.arange(TILE_ROWS, device=a.device)[:, None]
    pieces = torch.arange(8, device=a.device)[None, :] ^ (rows % 8)
    return a[:, :, rows, pieces].reshape(-1)


def stage_tf32(x, w):
    """The staging kernel's output for x (M, K), w (L, K/L, N) (float32
    or bf16): x's hi tiles, then w^T's (w's columns as rows), then, for
    float32, the lo tiles in the same order (`split_tf32`, `_tiles`)."""
    m, (l, kpl, n) = x.shape[0], w.shape
    xs, ws = split_tf32(x.float().reshape(m, l, kpl)), split_tf32(
        w.float().permute(2, 0, 1))
    planes = [_tiles(xs[0]), _tiles(ws[0])]
    if x.dtype == torch.float32:
        planes += [_tiles(xs[1]), _tiles(ws[1])]
    return torch.cat(planes)
