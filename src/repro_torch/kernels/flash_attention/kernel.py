"""Flash attention on Hopper: the wrappers of the hand-written CUDA kernels
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``, which
replace the reference's Pallas kernels ``repro/kernels/flash_attention/
kernel.py::flash_attention_fwd`` and ``::flash_attention_bwd``.

The forward reads q, k and v in the model's (B, S, H, hd) layout through
their strides (no transposed copies), gives one block to each (batch,
q head, 64-row q tile), stages each 64-row k/v tile once in shared
memory, keeps m, l and the accumulator in float32, and when causal stops
at the diagonal tile.  The backward is two kernels launched by one call:
dk/dv with one block per (batch, kv head, 64-row kv tile), which walks
the group's q heads and q tiles and so sums GQA into the kv heads
itself, and dq with one block per (batch, q head, q tile).  Both are
deterministic (no atomics).  Any S is right: ragged last tiles are
masked.  The kernels' sources say what bounds them and what their design
does about that.

Build: route (b) (`repro_torch._build`), at first use, one library for
each direction.  The wrappers check device, dtype (float32, bfloat16),
head dim (16, 32, 64, 128) and strides, allocate the outputs with
``torch.empty``, launch on PyTorch's current stream and raise if a launch
fails.  ``flash_attention_fwd.launches`` and
``flash_attention_bwd.launches`` count their calls (a backward call
launches its two kernels and counts one).
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch._build import (NVCC_FLAGS, bind, compile_library, nvcc,
                                stream_ptr)

KERNEL_SOURCES = ("attention_common.cuh", "flash_attention_fwd.cu")
BWD_SOURCES = ("attention_common.cuh", "flash_attention_bwd.cu")
HEAD_DIMS = (16, 32, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernels' grids put heads on y and the batch on z
MAX_GRID_YZ = 65535


@functools.cache
def build() -> ctypes.CDLL:
    """Build (first use only) and load the forward kernel's library."""
    lib = ctypes.CDLL(str(compile_library(nvcc(), NVCC_FLAGS, KERNEL_SOURCES,
                                          "flash_attention_fwd")))
    bind(lib, "flash_attention_fwd_launch", 6,
         [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    return lib


@functools.cache
def build_bwd() -> ctypes.CDLL:
    """Build (first use only) and load the backward kernels' library."""
    lib = ctypes.CDLL(str(compile_library(nvcc(), NVCC_FLAGS, BWD_SOURCES,
                                          "flash_attention_bwd")))
    bind(lib, "flash_attention_bwd_launch", 10,
         [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    return lib


def check_inputs(q, k, v, who: str = "flash_attention_fwd", **more) -> None:
    """Raise unless q (B,S,Hq,hd) and k, v (B,S,Hkv,hd) are CUDA tensors
    of one device and one dtype the kernel takes, with contiguous last
    dims, Hq a multiple of Hkv and a head dim it is built for.  `more`
    names further tensors of q's shape, device and dtype (the backward's
    o and do)."""
    for name, x in (("q", q), ("k", k), ("v", v), *more.items()):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{who}: {name} on {x.device}, want q's CUDA "
                             f"device")
        if x.dtype != q.dtype or x.dtype not in DTYPE_CODES:
            raise ValueError(f"{who}: {name} is {x.dtype}; want one of "
                             f"{tuple(DTYPE_CODES)}, equal for all inputs")
        if x.dim() != 4 or x.stride(-1) != 1:
            raise ValueError(f"{who}: {name} must be 4-d with a contiguous "
                             f"last dim, got shape {tuple(x.shape)} strides "
                             f"{x.stride()}")
    b, s, hq, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != hd:
        raise ValueError(f"{who}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    for name, x in more.items():
        if x.shape != q.shape:
            raise ValueError(f"{who}: {name} {tuple(x.shape)}, want q's "
                             f"{tuple(q.shape)}")
    hkv = k.shape[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{who}: Hq={hq} not a multiple of Hkv={hkv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{who}: head dim {hd} not in {HEAD_DIMS}")
    if min(b, s) < 1 or max(b, hq) > MAX_GRID_YZ:
        raise ValueError(f"{who}: B={b}, S={s}, Hq={hq} outside the "
                         f"kernel's grid")


def _strides(*xs) -> np.ndarray:
    """Element strides of dims 0-2 of each tensor, as the kernels take
    them (the last dim is contiguous)."""
    return np.array([st for x in xs for st in x.stride()[:3]], np.int64)


def flash_attention_fwd(q, k, v, *, causal: bool = True):
    """q (B,S,Hq,hd); k/v (B,S,Hkv,hd), on the card -> (o (B,S,Hq,hd) in
    q's dtype, lse (B,Hq,S) float32), by the CUDA kernel."""
    check_inputs(q, k, v)
    b, s, hq, hd = q.shape
    o = torch.empty((b, s, hq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, o)
    lib = build()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), strides.ctypes.data, b, s, hq, k.shape[2], hd,
            DTYPE_CODES[q.dtype], int(causal), 1.0 / math.sqrt(hd),
            stream_ptr(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True):
    """Gradients of flash attention, on the card, by the CUDA kernels.

    q, o, do (B,S,Hq,hd); k/v (B,S,Hkv,hd); lse (B,Hq,S) float32 from the
    forward -> (dq, dk, dv) in the model layout and the inputs' dtype.
    ``delta = rowsum(do * o)`` is one torch reduction here, as the
    reference computes it outside its Pallas calls.  A `do` whose last dim
    is not contiguous (autograd may hand one over) is copied first."""
    if do.stride(-1) != 1:
        do = do.contiguous()
    who = "flash_attention_bwd"
    check_inputs(q, k, v, who, o=o, do=do)
    b, s, hq, hd = q.shape
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (b, hq, s) or not lse.is_contiguous()):
        raise ValueError(f"{who}: lse {lse.dtype}{tuple(lse.shape)} on "
                         f"{lse.device}, want contiguous float32 "
                         f"{(b, hq, s)} on {q.device}")
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    strides = _strides(q, k, v, do, dq, dk, dv)
    lib = build_bwd()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), strides.ctypes.data, b, s, hq, k.shape[2], hd,
            DTYPE_CODES[q.dtype], int(causal), 1.0 / math.sqrt(hd),
            stream_ptr(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


#: kernel launches since the count was last set to 0
flash_attention_fwd.launches = 0
#: backward calls (each launches the dk/dv and the dq kernel) since the
#: count was last set to 0
flash_attention_bwd.launches = 0
