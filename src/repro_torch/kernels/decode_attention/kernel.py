"""Flash-decode on Hopper: the wrapper of the hand-written CUDA kernels
``csrc/decode_attention.cu``, which replace the reference's Pallas kernel
``repro/kernels/decode_attention/kernel.py::decode_attention``.

The cache rows of each (lane, kv head) are split over blocks (split-KV):
a split kernel gives each block one contiguous range of rows and all G =
Hq/Hkv query heads of its kv head, and writes a partial softmax state
(m, l, acc, float32) to a workspace; a combine kernel merges the
partials in split order and writes o in q's dtype.  The cache is read in
place in the model's (B, Smax, Hkv, hd) layout with 16-byte loads, and no
position at or past a lane's length is read.  Any Smax is right.  The
kernels' source says what bounds them and what their design does about
that.

Build: route (b) (`repro_torch._build`), at first use.  The wrapper
checks device, dtypes (float32, bfloat16 for q; float32, bfloat16 for
the caches), head dim (16, 32, 64, 112, 128: 112 is zamba2-7b's shared
attention), strides, 16-byte alignment of
the caches and the block's shared memory once per input layout (the
serving path calls it with one layout over and over, and at its shape
the host's time per call is what a decode step waits for), allocates the
output and the workspace with ``torch.empty``, launches both kernels on
PyTorch's current stream in one C call and raises if a launch fails.
The split count comes from the shapes and the card's SM count
(`split_plan`), never from ``lengths``, which stay on the card.
``decode_attention.launches`` counts the split kernel's launches,
``decode_attention.combine_launches`` the combine kernel's.

A sequence-sharded cache (each rank holds a block of the positions) runs
the split kernel alone on each rank's block (`split`), gathers every
rank's partials and merges them with the same combine kernel (`combine`):
the partials of R ranks of S splits each are R x S splits in position
order (``ops.decode_attention_sharded``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch._build import (NVCC_FLAGS, bind, compile_library, nvcc,
                                on_device, stream_ptr)

KERNEL_SOURCES = ("attention_common.cuh", "decode_attention.cu")
HEAD_DIMS = (16, 32, 64, 112, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: shared memory one block may use on Hopper (bytes)
MAX_SMEM = 232448
#: the split kernel's grid puts Hkv on y and the batch on z
MAX_GRID_YZ = 65535
#: cache rows per chunk of the split kernel (its BK); a split holds whole
#: chunks
CHUNK = 64
#: blocks per SM the split count aims at
BLOCKS_PER_SM = 2
#: bytes the kernel loads at once: cache bases and strides are multiples
ALIGN_BYTES = 16


@functools.cache
def build() -> ctypes.CDLL:
    """Build (first use only) and load the kernels' library."""
    lib = ctypes.CDLL(str(compile_library(nvcc(), NVCC_FLAGS, KERNEL_SOURCES,
                                          "decode_attention")))
    bind(lib, "decode_attention_launch", 7,
         [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    bind(lib, "decode_attention_combine_launch", 3,
         [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.decode_attention_smem.argtypes = [ctypes.c_int] * 3
    lib.decode_attention_smem.restype = ctypes.c_size_t
    return lib


def split_plan(smax: int, b: int, hkv: int, n_sm: int) -> tuple[int, int]:
    """(splits, rows per split) for a (B, Smax, Hkv, hd) cache on a card
    of `n_sm` SMs: at least BLOCKS_PER_SM blocks per SM over the B x Hkv
    (lane, kv head) pairs where the cache has the chunks for it, each
    split whole CHUNK-row chunks, at least one; the last split ends at
    Smax.  Shapes only: the lengths are never read on the host."""
    chunks = -(-smax // CHUNK)
    want = -(-BLOCKS_PER_SM * n_sm // (b * hkv))
    rows = max(1, chunks // want) * CHUNK
    return max(1, -(-smax // rows)), rows     # a cache of no rows: 1 split


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_head_dim(hd: int) -> None:
    """Raise unless the kernels are built for head dim `hd`."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")


def check_inputs(q, k_cache, v_cache, lengths) -> None:
    """Raise unless q (B,1,Hq,hd), caches (B,Smax,Hkv,hd) and lengths (B,)
    int32 are CUDA tensors of one device the kernel takes."""
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"decode_attention: {name} on {x.device}, want "
                             f"q's CUDA device")
    if q.dtype not in DTYPE_CODES or k_cache.dtype not in DTYPE_CODES \
            or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"decode_attention: q {q.dtype}, caches "
                         f"{k_cache.dtype}/{v_cache.dtype}; want each in "
                         f"{tuple(DTYPE_CODES)} and equal caches")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.dim() != 4 or x.stride(-1) != 1:
            raise ValueError(f"decode_attention: {name} must be 4-d with a "
                             f"contiguous last dim, got shape "
                             f"{tuple(x.shape)} strides {x.stride()}")
    b, one, hq, hd = q.shape
    if one != 1 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != b or k_cache.shape[3] != hd:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    hkv = k_cache.shape[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"decode_attention: Hq={hq} not a multiple of "
                         f"Hkv={hkv}")
    check_head_dim(hd)
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if any(st * x.element_size() % ALIGN_BYTES for st in x.stride()[:3]):
            raise ValueError(f"decode_attention: {name} strides "
                             f"{x.stride()} are not multiples of "
                             f"{ALIGN_BYTES} bytes (the kernel's loads)")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,) \
            or not lengths.is_contiguous():
        raise ValueError(f"decode_attention: lengths must be contiguous "
                         f"int32 ({b},), got {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
    if b < 1 or b > MAX_GRID_YZ or hkv > MAX_GRID_YZ:
        raise ValueError(f"decode_attention: B={b}, Hkv={hkv} outside the "
                         f"kernel's grid")


class Layout(NamedTuple):
    """What one input layout fixes: the kernels' strides and integer
    arguments, the split plan, and the output's and workspace's sizes."""
    strides: np.ndarray      # dims 0-2 of q, k, v, o (element strides)
    ints: tuple              # B, Smax, Hkv, G, hd, dtype, cache dtype,
    #                          splits, rows
    o_shape: tuple
    parts: tuple             # shapes of m, l and acc in the workspace
    ws_numel: int
    scale: float


#: checked input layouts, each (shape, strides, dtype, device) of q, the
#: caches and lengths
_LAYOUTS: dict = {}
_MAX_LAYOUTS = 256


def layout(q, k_cache, v_cache, lengths) -> Layout:
    """`check_inputs`, the shared-memory check and the split plan, once
    per input layout."""
    key = tuple((x.shape, x.stride(), x.dtype, x.device)
                for x in (q, k_cache, v_cache, lengths))
    lay = _LAYOUTS.get(key)
    if lay is not None:
        return lay
    check_inputs(q, k_cache, v_cache, lengths)
    b, _, hq, hd = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    smem = build().decode_attention_smem(hd, g, DTYPE_CODES[k_cache.dtype])
    if smem > MAX_SMEM:
        raise ValueError(f"decode_attention: group {g} x hd {hd} needs "
                         f"{smem} B of shared memory (> {MAX_SMEM})")
    splits, rows = split_plan(smax, b, hkv, sm_count(q.device.index))
    o_strides = (hq * hd, hq * hd, hd)       # a new contiguous (B,1,Hq,hd)
    strides = np.array([st for x in (q, k_cache, v_cache)
                        for st in x.stride()[:3]] + list(o_strides),
                       np.int64)
    part = (b, hkv, splits, g)
    lay = Layout(strides=strides,
                 ints=(b, smax, hkv, g, hd, DTYPE_CODES[q.dtype],
                       DTYPE_CODES[k_cache.dtype], splits, rows),
                 o_shape=(b, 1, hq, hd), parts=(part, part, part + (hd,)),
                 ws_numel=(2 + hd) * math.prod(part),
                 scale=1.0 / math.sqrt(hd))
    if len(_LAYOUTS) >= _MAX_LAYOUTS:
        _LAYOUTS.clear()
    _LAYOUTS[key] = lay
    return lay


def _run(q, k_cache, v_cache, lengths, combine: bool = True):
    """Both kernels' launch, or the split kernel's alone where `combine`
    is False (o is then None): (o, workspace, layout)."""
    lay = layout(q, k_cache, v_cache, lengths)
    if (k_cache.data_ptr() | v_cache.data_ptr()) % ALIGN_BYTES:
        raise ValueError(f"decode_attention: cache bases at byte addresses "
                         f"{k_cache.data_ptr()}, {v_cache.data_ptr()}, want "
                         f"{ALIGN_BYTES}-byte aligned")
    o = (torch.empty(lay.o_shape, dtype=q.dtype, device=q.device)
         if combine else None)
    ws = torch.empty(lay.ws_numel, dtype=torch.float32, device=q.device)
    with on_device(q.device):
        err = build().decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), 0 if o is None else o.data_ptr(),
            ws.data_ptr(), lay.strides.ctypes.data, *lay.ints, lay.scale,
            stream_ptr(q.device))
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    decode_attention.launches += 1
    decode_attention.combine_launches += combine
    return o, ws, lay


def decode_attention(q, k_cache, v_cache, lengths):
    """q (B,1,Hq,hd); caches (B,Smax,Hkv,hd); lengths (B,) int32, on the
    card -> (B,1,Hq,hd) in q's dtype, by the CUDA kernels."""
    return _run(q, k_cache, v_cache, lengths)[0]


def _parts(ws, lay: Layout):
    n = math.prod(lay.parts[0])
    return (ws[:n].view(lay.parts[0]), ws[n:2 * n].view(lay.parts[1]),
            ws[2 * n:].view(lay.parts[2]))


def decode_attention_partials(q, k_cache, v_cache, lengths):
    """`decode_attention` that also returns the split kernel's partials,
    views of its workspace: (o, (m, l, acc)) with m and l (B, Hkv, S, G)
    and acc (B, Hkv, S, G, hd), float32 (an empty split: m = -inf, l = 0,
    acc = 0).  For holding the combine against `ref.combine_splits`; the
    model never calls it."""
    o, ws, lay = _run(q, k_cache, v_cache, lengths)
    return o, _parts(ws, lay)


def split(q, k_cache, v_cache, lengths):
    """The split kernel alone: the partials (m, l, acc) of
    `decode_attention_partials`, views of its workspace, and no output.
    A rank of a sequence-sharded cache runs it over its block; the
    partials of every rank are then merged by `combine`."""
    return _parts(*_run(q, k_cache, v_cache, lengths, combine=False)[1:])


def combine(m, l, acc, dtype):
    """The combine kernel alone, over partials that
    `decode_attention_partials` returned (views of one workspace) ->
    (B, 1, Hq, hd) in `dtype`."""
    b, hkv, splits, g, hd = acc.shape
    n = m.numel()
    if not (m.is_contiguous() and l.data_ptr() == m.data_ptr() + 4 * n
            and acc.data_ptr() == l.data_ptr() + 4 * n
            and m.dtype == l.dtype == acc.dtype == torch.float32):
        raise ValueError("combine: m, l and acc must be the float32 views "
                         "of one workspace that decode_attention_partials "
                         "returns")
    o = torch.empty((b, 1, hkv * g, hd), dtype=dtype, device=m.device)
    o_strides = np.array(o.stride()[:3], np.int64)
    with on_device(m.device):
        err = build().decode_attention_combine_launch(
            m.data_ptr(), o.data_ptr(), o_strides.ctypes.data, b, hkv, g,
            hd, splits, DTYPE_CODES[dtype], stream_ptr(m.device))
    if err != 0:
        raise RuntimeError(f"decode_attention combine launch failed: CUDA "
                           f"error {err}")
    decode_attention.combine_launches += 1
    return o


#: split-kernel and combine-kernel launches since the counts were last
#: set to 0
decode_attention.launches = 0
decode_attention.combine_launches = 0
