"""Flash-attention forward on Hopper: the wrapper of the hand-written CUDA
kernel ``csrc/flash_attention_fwd.cu``, which replaces the reference's
Pallas kernel ``repro/kernels/flash_attention/kernel.py::
flash_attention_fwd``.

The kernel reads q, k and v in the model's (B, S, H, hd) layout through
their strides (no transposed copies), gives one block to each (batch,
q head, 64-row q tile), stages each 64-row k/v tile once in shared
memory, keeps m, l and the accumulator in float32, and when causal stops
at the diagonal tile.  Any S is right: the ragged last tile is masked.
The kernel's source says what bounds it and what its design does about
that.

Build: route (b) (`repro_torch._build`), at first use.  The wrapper
checks device, dtype (float32, bfloat16), head dim (16, 32, 64, 128) and
strides, allocates the outputs with ``torch.empty``, launches on
PyTorch's current stream and raises if the launch fails.
``flash_attention_fwd.launches`` counts its launches.  The backward
kernel comes with training (ROADMAP Slice E).
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
HEAD_DIMS = (16, 32, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's grid puts q heads on y and the batch on z
MAX_GRID_YZ = 65535


@functools.cache
def build() -> ctypes.CDLL:
    """Build (first use only) and load the kernel's library."""
    lib = ctypes.CDLL(str(compile_library(nvcc(), NVCC_FLAGS, KERNEL_SOURCES,
                                          "flash_attention_fwd")))
    bind(lib, "flash_attention_fwd_launch", 6,
         [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    return lib


def check_inputs(q, k, v) -> None:
    """Raise unless q (B,S,Hq,hd) and k, v (B,S,Hkv,hd) are CUDA tensors
    of one device and one dtype the kernel takes, with contiguous last
    dims, Hq a multiple of Hkv and a head dim it is built for."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} on {x.device}, "
                             f"want q's CUDA device")
        if x.dtype != q.dtype or x.dtype not in DTYPE_CODES:
            raise ValueError(f"flash_attention_fwd: {name} is {x.dtype}; "
                             f"want one of {tuple(DTYPE_CODES)}, equal for "
                             f"q, k, v")
        if x.dim() != 4 or x.stride(-1) != 1:
            raise ValueError(f"flash_attention_fwd: {name} must be 4-d with "
                             f"a contiguous last dim, got shape "
                             f"{tuple(x.shape)} strides {x.stride()}")
    b, s, hq, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != hd:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    hkv = k.shape[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention_fwd: Hq={hq} not a multiple of "
                         f"Hkv={hkv}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if min(b, s) < 1 or max(b, hq) > MAX_GRID_YZ:
        raise ValueError(f"flash_attention_fwd: B={b}, S={s}, Hq={hq} "
                         f"outside the kernel's grid")


def flash_attention_fwd(q, k, v, *, causal: bool = True):
    """q (B,S,Hq,hd); k/v (B,S,Hkv,hd), on the card -> (o (B,S,Hq,hd) in
    q's dtype, lse (B,Hq,S) float32), by the CUDA kernel."""
    check_inputs(q, k, v)
    b, s, hq, hd = q.shape
    o = torch.empty((b, s, hq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    strides = np.array([st for x in (q, k, v, o) for st in x.stride()[:3]],
                       np.int64)
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


#: kernel launches since the count was last set to 0
flash_attention_fwd.launches = 0
