"""The WKV6 chunked recurrence on Hopper: the wrapper of the hand-written
CUDA kernel ``csrc/wkv6.cu``, which replaces the reference's Pallas kernel
``repro/kernels/wkv6/kernel.py::wkv6``.

One block per (batch, head) walks the chunks in order with the (hd, hd)
state in shared memory, and computes the intra-chunk scores pair by pair
without materialising the reference's (cs, cs, hd) decay tensor (every
exponent is <= 0, so the numbers are the same and overflow-free).  The
kernel's source says what bounds it and what its design does about that.

Build: route (b) (`repro_torch._build`), at first use.  The wrapper
checks device, dtype (float32), shapes, contiguity, the chunk and the
head dim, allocates y and the final state with ``torch.empty``, launches
on PyTorch's current stream and raises if the launch fails.
``wkv6.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch._build import (NVCC_FLAGS, bind, compile_library, nvcc,
                                stream_ptr)

KERNEL_SOURCES = ("wkv6.cu",)
CHUNKS = (16, 32, 64)
HEAD_DIMS = (16, 32, 64)


@functools.cache
def build() -> ctypes.CDLL:
    """Build (first use only) and load the kernel's library."""
    lib = ctypes.CDLL(str(compile_library(nvcc(), NVCC_FLAGS, KERNEL_SOURCES,
                                          "wkv6")))
    bind(lib, "wkv6_launch", 7, [ctypes.c_int] * 5 + [ctypes.c_void_p])
    return lib


def check_inputs(r, k, v, logw, u, chunk: int) -> None:
    """Raise unless r, k, v, logw (B, H, S, hd) and u (H, hd) are
    contiguous float32 CUDA tensors of one device, with a chunk and head
    dim the kernel is built for and S a multiple of the chunk."""
    for name, x in (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u)):
        if x.device.type != "cuda" or x.device != r.device:
            raise ValueError(f"wkv6: {name} on {x.device}, want r's CUDA "
                             f"device")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"wkv6: {name} is {x.dtype} with strides "
                             f"{x.stride()}; want contiguous float32")
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, logw)):
        raise ValueError(f"wkv6: r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, logw {tuple(logw.shape)}")
    b, h, s, hd = r.shape
    if u.shape != (h, hd):
        raise ValueError(f"wkv6: u {tuple(u.shape)}, want {(h, hd)}")
    if chunk not in CHUNKS or hd not in HEAD_DIMS:
        raise ValueError(f"wkv6: chunk {chunk} (want one of {CHUNKS}), "
                         f"head dim {hd} (want one of {HEAD_DIMS})")
    if s < 1 or s % chunk or b * h < 1:
        raise ValueError(f"wkv6: S={s} is not a positive multiple of the "
                         f"chunk {chunk}")


def wkv6(r, k, v, logw, u, *, chunk: int = 64):
    """r, k, v, logw (B, H, S, hd) float32, u (H, hd) float32, on the card
    -> (y (B, H, S, hd) float32, final state (B, H, hd, hd) float32) from a
    zero initial state, by the CUDA kernel."""
    check_inputs(r, k, v, logw, u, chunk)
    b, h, s, hd = r.shape
    y = torch.empty_like(r)
    state = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    lib = build()
    with torch.cuda.device(r.device):
        err = lib.wkv6_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                              logw.data_ptr(), u.data_ptr(), y.data_ptr(),
                              state.data_ptr(), b, h, s, hd, chunk,
                              stream_ptr(r.device))
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed: CUDA error {err}")
    wkv6.launches += 1
    return y, state


#: kernel launches since the count was last set to 0
wkv6.launches = 0
