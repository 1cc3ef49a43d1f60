"""Flash-decode on Hopper: the wrapper of the hand-written CUDA kernel
``csrc/decode_attention.cu``, which replaces the reference's Pallas kernel
``repro/kernels/decode_attention/kernel.py::decode_attention``.

The kernel reads the KV cache in place in the model's (B, Smax, Hkv, hd)
layout (no transposed copy), gives one block to each (lane, kv head) so
that all G = Hq/Hkv query heads of the group share every K/V chunk the
block loads, and reads no position at or past the lane's length.  Any
Smax is right.  The kernel's source says what bounds it and what its
design does about that.

Build: route (b) (`repro_torch._build`), at first use.  The wrapper
checks device, dtypes (float32, bfloat16 for q; float32, bfloat16 for
the caches), head dim (16, 32, 64, 128), strides and the block's shared
memory, allocates the output with ``torch.empty``, launches on PyTorch's
current stream and raises if the launch fails.
``decode_attention.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch._build import (NVCC_FLAGS, bind, compile_library, nvcc,
                                stream_ptr)

KERNEL_SOURCES = ("attention_common.cuh", "decode_attention.cu")
HEAD_DIMS = (16, 32, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: shared memory one block may use on Hopper (bytes)
MAX_SMEM = 232448
#: the kernel's grid puts the batch on y
MAX_GRID_Y = 65535


@functools.cache
def build() -> ctypes.CDLL:
    """Build (first use only) and load the kernel's library."""
    lib = ctypes.CDLL(str(compile_library(nvcc(), NVCC_FLAGS, KERNEL_SOURCES,
                                          "decode_attention")))
    bind(lib, "decode_attention_launch", 6,
         [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    lib.decode_attention_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.decode_attention_smem.restype = ctypes.c_size_t
    return lib


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
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,) \
            or not lengths.is_contiguous():
        raise ValueError(f"decode_attention: lengths must be contiguous "
                         f"int32 ({b},), got {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
    if b < 1 or b > MAX_GRID_Y:
        raise ValueError(f"decode_attention: B={b} outside the kernel's "
                         f"grid")


def decode_attention(q, k_cache, v_cache, lengths):
    """q (B,1,Hq,hd); caches (B,Smax,Hkv,hd); lengths (B,) int32, on the
    card -> (B,1,Hq,hd) in q's dtype, by the CUDA kernel."""
    check_inputs(q, k_cache, v_cache, lengths)
    b, _, hq, hd = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    lib = build()
    smem = lib.decode_attention_smem(hd, hq // hkv)
    if smem > MAX_SMEM:
        raise ValueError(f"decode_attention: group {hq // hkv} x hd {hd} "
                         f"needs {smem} B of shared memory (> {MAX_SMEM})")
    o = torch.empty((b, 1, hq, hd), dtype=q.dtype, device=q.device)
    strides = np.array([st for x in (q, k_cache, v_cache, o)
                        for st in x.stride()[:3]], np.int64)
    with torch.cuda.device(q.device):
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), o.data_ptr(), strides.ctypes.data, b, smax,
            hkv, hq // hkv, hd, DTYPE_CODES[q.dtype],
            DTYPE_CODES[k_cache.dtype], 1.0 / math.sqrt(hd),
            stream_ptr(q.device))
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    decode_attention.launches += 1
    return o


#: kernel launches since the count was last set to 0
decode_attention.launches = 0
