"""The SMLA cascaded-pipeline matmul on Hopper: the wrappers of the
hand-written CUDA kernel ``csrc/smla_pipe.cu``, which replaces the
reference's Pallas kernel ``repro/kernels/smla_pipe/kernel.py::
matmul_cascaded`` and, launched once per layer slab, ``::matmul_dedicated``.

One block per 64 x 64 output tile walks layer 0's stripe chunks, then
layer 1's, ... through one shared-memory buffer (the shared TSV bus of
Cascaded-IO) into one float32 accumulator, both operands upcast to
float32.  Any M, N and K/L are right (ragged tiles and stripe tails are
masked).  The kernel's source says what bounds it and what its design
does about that.

Build: route (b) (`repro_torch._build`), at first use.  The wrappers
check device, dtype (float32 or bfloat16, equal for x and w), shapes and
strides, allocate the outputs with ``torch.empty``, launch on PyTorch's
current stream and raise if a launch fails.  ``matmul_cascaded.launches``
counts its launches; ``matmul_dedicated.launches`` counts the L launches
of each of its calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch._build import (NVCC_FLAGS, bind, compile_library, nvcc,
                                stream_ptr)

KERNEL_SOURCES = ("smla_pipe.cu",)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: output rows per block; the grid puts row tiles on y
BM = 64
MAX_GRID_Y = 65535


@functools.cache
def build() -> ctypes.CDLL:
    """Build (first use only) and load the kernel's library."""
    lib = ctypes.CDLL(str(compile_library(nvcc(), NVCC_FLAGS, KERNEL_SOURCES,
                                          "smla_pipe")))
    bind(lib, "smla_pipe_cascaded_launch", 3,
         [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    return lib


def check_inputs(x, w, who: str) -> None:
    """Raise unless x (M, K) with contiguous rows and w (L, K/L, N)
    contiguous are CUDA tensors of one device and one dtype the kernel
    takes."""
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{who}: {name} on {t.device}, want x's CUDA "
                             f"device")
        if t.dtype != x.dtype or t.dtype not in DTYPE_CODES:
            raise ValueError(f"{who}: {name} is {t.dtype}; want one of "
                             f"{tuple(DTYPE_CODES)}, equal for x and w")
    if x.dim() != 2 or w.dim() != 3 or x.stride(1) != 1 \
            or not w.is_contiguous():
        raise ValueError(f"{who}: want x (M, K) with contiguous rows and "
                         f"contiguous w (L, K/L, N), got x "
                         f"{tuple(x.shape)} strides {x.stride()}, w "
                         f"{tuple(w.shape)}")
    m, k = x.shape
    l, kpl, n = w.shape
    if l * kpl != k or min(m, n, kpl, l) < 1:
        raise ValueError(f"{who}: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if (m + BM - 1) // BM > MAX_GRID_Y:
        raise ValueError(f"{who}: M={m} outside the kernel's grid")


def _launch(x, w, out) -> None:
    """One launch: out (M, N) float32 = x @ concat(w)."""
    lib = build()
    with torch.cuda.device(x.device):
        err = lib.smla_pipe_cascaded_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), x.stride(0),
            x.shape[0], w.shape[2], w.shape[1], w.shape[0],
            DTYPE_CODES[x.dtype], stream_ptr(x.device))
    if err != 0:
        raise RuntimeError(f"smla_pipe launch failed: CUDA error {err}")


def matmul_cascaded(x, w):
    """x (M, K); w (L, K/L, N), on the card -> (M, N) float32, by one
    launch of the CUDA kernel."""
    check_inputs(x, w, "matmul_cascaded")
    out = torch.empty((x.shape[0], w.shape[2]), dtype=torch.float32,
                      device=x.device)
    _launch(x, w, out)
    matmul_cascaded.launches += 1
    return out


def matmul_dedicated(x, w):
    """Dedicated-IO: one launch per layer slab, x's columns of that slab
    against w[l], each into a private partial (M, N); the partials summed
    after, ((p0 + p1) + p2) + ..., as the reference sums outside its
    kernel."""
    check_inputs(x, w, "matmul_dedicated")
    l, kpl, n = w.shape
    parts = torch.empty((l, x.shape[0], n), dtype=torch.float32,
                        device=x.device)
    for layer in range(l):
        _launch(x[:, layer * kpl:(layer + 1) * kpl], w[layer:layer + 1],
                parts[layer])
    matmul_dedicated.launches += l
    out = parts[0]
    for layer in range(1, l):
        out = out + parts[layer]
    return out


#: kernel launches since the count was last set to 0
matmul_cascaded.launches = 0
#: kernel launches (L per call) since the count was last set to 0
matmul_dedicated.launches = 0
