"""The WKV6 chunked recurrence on Hopper: the wrapper of the hand-written
CUDA kernel ``csrc/wkv6.cu``, which replaces the reference's Pallas kernel
``repro/kernels/wkv6/kernel.py::wkv6``.

One launch, a block per chunk of each (batch, head) (`plan`): every block
computes its chunk's scores, y's intra-chunk part and the chunk's state
increment at once, and only the state step itself runs in chunk order,
each block handing the state on to the next through a workspace of its
own (`workspace`).  Each chunk is cut into 16-row sub-blocks: the
off-diagonal blocks of the intra-chunk scores are products of
decay-scaled r and k tiles (every factor <= 1, so nothing overflows), the
diagonal blocks keep an exp per pair only on their 4 x 4 micro-diagonal,
and every product runs on the tensor cores as 3xTF32 (float32-accurate).
The kernel's source says what bounds it and what its design does about
that.

The kernel reads the model's tensors as they are: r, k, v bf16 or
float32 (one dtype), logw and u float32, through their strides, the hd
axis of unit stride, r, k and v 16-byte aligned (`check_layout`).  It
writes y in r's dtype into a (B, S, H, hd) buffer and returns its
(B, H, S, hd) view, so the model's transpose back costs nothing.

Build: route (b) (`repro_torch._build`), at first use.  The wrapper
checks device, dtypes, shapes, strides, alignment, the chunk and the
head dim, allocates y and the final state with ``torch.empty``, launches
on PyTorch's current stream and raises if the launch fails.
``wkv6.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch._build import (NVCC_FLAGS, bind, compile_library, nvcc,
                                on_device, stream_ptr)

KERNEL_SOURCES = ("wkv6.cu",)
CHUNKS = (16, 32, 64)
HEAD_DIMS = (16, 32, 64)
#: dtypes of r, k and v (one for all three); logw and u are float32
DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def build() -> ctypes.CDLL:
    """Build (first use only) and load the kernel's library."""
    lib = ctypes.CDLL(str(compile_library(nvcc(), NVCC_FLAGS, KERNEL_SOURCES,
                                          "wkv6")))
    bind(lib, "wkv6_launch", 9,
         [ctypes.c_longlong] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return lib


def plan(b: int, h: int, s: int, hd: int, chunk: int) -> dict:
    """The launch at these shapes: a block per chunk of each (batch,
    head), and the workspace it hands the states on through (`sync`: a
    ticket, a count of finished blocks and a flag per (batch, head),
    int32; `ring`: two (hd, hd) float32 states per (batch, head))."""
    return {"blocks": b * h * (s // chunk), "blocks_per_head": s // chunk,
            "sync_ints": 2 + b * h, "ring_floats": b * h * 2 * hd * hd}


#: the workspaces, per (device index, stream): launches on one stream run
#: in order, so they can share one; the kernel leaves `sync` at zero
_WORKSPACES: dict = {}


def workspace(device, stream: int, need: dict):
    """(sync, ring) for a launch of `plan` `need` on `stream`: kept per
    (device, stream), grown when too small; `sync` zeroed when made."""
    key = (device.index, stream)
    sync, ring = _WORKSPACES.get(key, (None, None))
    if sync is None or sync.numel() < need["sync_ints"]:
        sync = torch.zeros(need["sync_ints"], dtype=torch.int32,
                           device=device)
    if ring is None or ring.numel() < need["ring_floats"]:
        ring = torch.empty(need["ring_floats"], dtype=torch.float32,
                           device=device)
    _WORKSPACES[key] = sync, ring
    return sync, ring


def check_layout(r, k, v, logw, u, chunk: int) -> None:
    """Raise unless r, k, v, logw (B, H, S, hd) and u (H, hd) are what the
    kernel reads, wherever they lie: r, k, v of one dtype in `DTYPES`,
    logw and u float32; every hd axis of unit stride; r, k and v 16-byte
    aligned with every stride of a non-unit axis a multiple of 16 bytes
    (the kernel's 16-byte loads); a chunk and head dim the kernel is built
    for and S a multiple of the chunk."""
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, logw)):
        raise ValueError(f"wkv6: r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, logw {tuple(logw.shape)}")
    b, h, s, hd = r.shape
    if u.shape != (h, hd):
        raise ValueError(f"wkv6: u {tuple(u.shape)}, want {(h, hd)}")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"wkv6: r, k, v are {r.dtype}, {k.dtype}, "
                         f"{v.dtype}; want one of {DTYPES}")
    if logw.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"wkv6: logw {logw.dtype}, u {u.dtype}; want "
                         f"float32")
    for name, x in (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u)):
        if x.stride(-1) != 1 and x.shape[-1] > 1:
            raise ValueError(f"wkv6: {name} has strides {x.stride()}; want "
                             f"the hd axis of unit stride")
    for name, x in (("r", r), ("k", k), ("v", v)):
        size = x.element_size()
        if x.data_ptr() % 16 or any(
                st * size % 16 for st, n in zip(x.stride()[:3], x.shape[:3])
                if n > 1):
            raise ValueError(f"wkv6: {name} at {x.data_ptr():#x} with "
                             f"strides {x.stride()} ({x.dtype}); want 16-byte "
                             f"aligned rows")
    if chunk not in CHUNKS or hd not in HEAD_DIMS:
        raise ValueError(f"wkv6: chunk {chunk} (want one of {CHUNKS}), "
                         f"head dim {hd} (want one of {HEAD_DIMS})")
    if s < 1 or s % chunk or b * h < 1:
        raise ValueError(f"wkv6: S={s} is not a positive multiple of the "
                         f"chunk {chunk}")


def check_inputs(r, k, v, logw, u, chunk: int) -> None:
    """`check_layout`, on CUDA tensors of one device."""
    for name, x in (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u)):
        if x.device.type != "cuda" or x.device != r.device:
            raise ValueError(f"wkv6: {name} on {x.device}, want r's CUDA "
                             f"device")
    check_layout(r, k, v, logw, u, chunk)


def wkv6(r, k, v, logw, u, *, chunk: int = 64):
    """r, k, v (B, H, S, hd) bf16 or float32, logw (B, H, S, hd) and u
    (H, hd) float32, on the card -> (y (B, H, S, hd) in r's dtype, a view
    of a (B, S, H, hd) buffer; final state (B, H, hd, hd) float32) from a
    zero initial state, by the CUDA kernel."""
    check_inputs(r, k, v, logw, u, chunk)
    b, h, s, hd = r.shape
    dev = r.device
    stream = stream_ptr(dev)
    sync, ring = workspace(dev, stream, plan(b, h, s, hd, chunk))
    y = torch.empty((b, s, h, hd), dtype=r.dtype, device=dev)
    state = torch.empty((b, h, hd, hd), dtype=torch.float32, device=dev)
    lib = build()
    with on_device(dev):
        err = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), y.data_ptr(), state.data_ptr(), sync.data_ptr(),
            ring.data_ptr(), *r.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *logw.stride()[:3], u.stride(0), b, h, s, hd,
            chunk, int(r.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed: CUDA error {err}")
    wkv6.launches += 1
    return y.transpose(1, 2), state


#: kernel launches since the count was last set to 0
wkv6.launches = 0
