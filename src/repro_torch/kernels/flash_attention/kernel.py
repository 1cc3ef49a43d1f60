"""Flash attention on Hopper: the wrappers of the hand-written CUDA kernels
that replace the reference's Pallas kernels ``repro/kernels/
flash_attention/kernel.py::flash_attention_fwd`` and
``::flash_attention_bwd``.

Each dtype has one kernel of each direction (`route`): bfloat16, the
dtype of the serving and training paths, runs on the tensor cores
(``csrc/flash_attention_fwd_tc.cu``, ``csrc/flash_attention_bwd_tc.cu``:
wgmma products, P and dS rounded to bf16, float32 softmax and
accumulators); float32, which the float32 replays hold to 1e-5, runs on
the CUDA cores (``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu``).  The route is chosen by dtype, not as
a fallback: a failed launch raises.

Both read q, k and v in the model's (B, S, H, hd) layout through their
strides (no transposed copies).  The forward gives one block to each
(batch, q head, q tile), keeps m, l and the accumulator in float32, and
when causal stops at the diagonal tile.  The backward is two kernels
launched by one call: dk/dv with one block per (batch, kv head, kv tile),
which walks the group's q heads and q tiles and so sums GQA into the kv
heads itself, and dq with one block per (batch, q head, q tile).  Both
are deterministic (no atomics).  Any S is right: ragged last tiles are
masked.  The kernels' sources say what bounds them and what their design
does about that.

Head dims: both directions take 16, 32, 64, 112 and 128.  At 112
(zamba2-7b's shared attention) the bf16 kernels keep their tiles 128
columns wide in shared memory, the last 16 zero-filled on every load, and
store 112 columns; the float32 kernels take it as any multiple of 16.

Build: route (b) (`repro_torch._build`), at first use, one library for
each direction and dtype.  The wrappers check device, dtype, head dim
and strides (bf16: 16-byte-aligned bases, strides a
multiple of 8, as the kernels' 16-byte loads need), allocate the outputs
with ``torch.empty``, launch on PyTorch's current stream and raise if a
launch fails.  ``flash_attention_fwd.launches`` and
``flash_attention_bwd.launches`` count their calls (a backward call
launches its two kernels and counts one), and ``.route_launches`` the
same calls by route.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch._build import (NVCC_FLAGS, bind, compile_library, nvcc,
                                on_device, stream_ptr)

KERNEL_SOURCES = ("attention_common.cuh", "flash_attention_fwd.cu")
BWD_SOURCES = ("attention_common.cuh", "flash_attention_bwd.cu")
TC_SOURCES = ("attention_common.cuh", "attention_tc.cuh",
              "flash_attention_fwd_tc.cu")
TC_BWD_SOURCES = ("attention_common.cuh", "attention_tc.cuh",
                  "flash_attention_bwd_tc.cu")
#: head dims each direction's kernels are built for
FWD_HEAD_DIMS = (16, 32, 64, 112, 128)
BWD_HEAD_DIMS = FWD_HEAD_DIMS
#: the kernels of each dtype: bf16 on the tensor cores, float32 on the
#: CUDA cores
ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}
#: the kernels' grids put (batch, head) pairs and q tiles on x, at most
#: 2^31 - 1 blocks (the tensor-core kernels), or heads on y and the batch
#: on z, at most 65535 each (the CUDA-core kernels)
MAX_GRID_YZ = 65535
#: bf16: the tensor-core kernels load 16 bytes at a time
ALIGN_BYTES = 16


def route(dtype) -> str:
    """Which kernels run inputs of `dtype`: "tensor_core" or "cuda_core"."""
    if dtype not in ROUTES:
        raise ValueError(f"flash attention: dtype {dtype}; want one of "
                         f"{tuple(ROUTES)}")
    return ROUTES[dtype]


_ARGS = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]


@functools.cache
def build() -> ctypes.CDLL:
    """Build (first use only) and load the float32 forward's library."""
    lib = ctypes.CDLL(str(compile_library(nvcc(), NVCC_FLAGS, KERNEL_SOURCES,
                                          "flash_attention_fwd")))
    bind(lib, "flash_attention_fwd_launch", 6, _ARGS)
    return lib


@functools.cache
def build_bwd() -> ctypes.CDLL:
    """Build (first use only) and load the float32 backward's library."""
    lib = ctypes.CDLL(str(compile_library(nvcc(), NVCC_FLAGS, BWD_SOURCES,
                                          "flash_attention_bwd")))
    bind(lib, "flash_attention_bwd_launch", 10, _ARGS)
    return lib


@functools.cache
def build_tc() -> ctypes.CDLL:
    """Build (first use only) and load the bf16 forward's library."""
    lib = ctypes.CDLL(str(compile_library(nvcc(), NVCC_FLAGS, TC_SOURCES,
                                          "flash_attention_fwd_tc")))
    bind(lib, "flash_attention_fwd_tc_launch", 6, _ARGS)
    return lib


@functools.cache
def build_bwd_tc() -> ctypes.CDLL:
    """Build (first use only) and load the bf16 backward's library."""
    lib = ctypes.CDLL(str(compile_library(nvcc(), NVCC_FLAGS, TC_BWD_SOURCES,
                                          "flash_attention_bwd_tc")))
    bind(lib, "flash_attention_bwd_tc_launch", 10, _ARGS)
    return lib


def check_head_dim(hd: int, who: str, head_dims) -> None:
    """Raise unless the kernels of `head_dims` are built for `hd`."""
    if hd not in head_dims:
        raise ValueError(f"{who}: head dim {hd} not in {head_dims}")


def check_inputs(q, k, v, who: str = "flash_attention_fwd",
                 head_dims=FWD_HEAD_DIMS, **more) -> None:
    """Raise unless q (B,S,Hq,hd) and k, v (B,S,Hkv,hd) are CUDA tensors
    of one device and one dtype the kernel takes, with contiguous last
    dims, Hq a multiple of Hkv and a head dim in `head_dims`.  `more`
    names further tensors of q's shape, device and dtype (the backward's
    o and do).  The bf16 kernels' alignment is checked with the strides
    (`_strides`)."""
    for name, x in (("q", q), ("k", k), ("v", v), *more.items()):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{who}: {name} on {x.device}, want q's CUDA "
                             f"device")
        if x.dtype != q.dtype or x.dtype not in ROUTES:
            raise ValueError(f"{who}: {name} is {x.dtype}; want one of "
                             f"{tuple(ROUTES)}, equal for all inputs")
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
    check_head_dim(hd, who, head_dims)
    if min(b, s) < 1 or max(b, hq) > MAX_GRID_YZ:
        raise ValueError(f"{who}: B={b}, S={s}, Hq={hq} outside the "
                         f"kernel's grid")


def aligned(x) -> bool:
    """Whether every row of `x` (its last dim contiguous) starts on an
    ALIGN_BYTES boundary: the base and the strides of dims 0-2."""
    return (x.data_ptr() % ALIGN_BYTES == 0
            and all(st * x.element_size() % ALIGN_BYTES == 0
                    for st in x.stride()[:3]))


def _strides(who: str, path: str, *xs) -> np.ndarray:
    """Element strides of dims 0-2 of each tensor, as the kernels take
    them (the last dim is contiguous); for the bf16 kernels (`path`
    "tensor_core"), raise unless every tensor is `aligned`."""
    st = [n for x in xs for n in x.stride()[:3]]
    if path == "tensor_core" and (
            any(n * 2 % ALIGN_BYTES for n in st)
            or any(x.data_ptr() % ALIGN_BYTES for x in xs)):
        bad = next(x for x in xs if not aligned(x))
        raise ValueError(f"{who}: a tensor at byte address "
                         f"{bad.data_ptr()} with strides {bad.stride()}: "
                         f"the bf16 kernels want {ALIGN_BYTES}-byte-aligned "
                         f"bases and strides that keep them aligned")
    return np.array(st, np.int64)


#: the forward's checked input layouts, each (shape, strides, dtype,
#: device) of q, k and v, and the kernel strides of q, k, v and o for
#: them: the serving path calls the forward with a few layouts over and
#: over, and at 8 x 256 tokens the checks cost more host time than the
#: kernel takes on the card (PERF.md)
_FWD_LAYOUTS: dict = {}
_MAX_LAYOUTS = 256


def _fwd_strides(q, k, v, o, path: str) -> np.ndarray:
    """`check_inputs` and `_strides` for the forward, once per input
    layout; the bases' alignment (bf16) is checked on every call."""
    key = tuple((x.shape, x.stride(), x.dtype, x.device) for x in (q, k, v))
    strides = _FWD_LAYOUTS.get(key)
    if strides is None:
        check_inputs(q, k, v)
        strides = _strides("flash_attention_fwd", path, q, k, v, o)
        if len(_FWD_LAYOUTS) >= _MAX_LAYOUTS:
            _FWD_LAYOUTS.clear()
        _FWD_LAYOUTS[key] = strides
    elif path == "tensor_core" and any(
            x.data_ptr() % ALIGN_BYTES for x in (q, k, v)):
        _strides("flash_attention_fwd", path, q, k, v, o)  # raises
    return strides


def flash_attention_fwd(q, k, v, *, causal: bool = True):
    """q (B,S,Hq,hd); k/v (B,S,Hkv,hd), on the card -> (o (B,S,Hq,hd) in
    q's dtype, lse (B,Hq,S) float32), by the CUDA kernel."""
    path = route(q.dtype)
    b, s, hq, hd = q.shape
    o = torch.empty((b, s, hq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    strides = _fwd_strides(q, k, v, o, path)
    launch = (build_tc().flash_attention_fwd_tc_launch
              if path == "tensor_core"
              else build().flash_attention_fwd_launch)
    with on_device(q.device):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), strides.ctypes.data, b, s, hq,
                     k.shape[2], hd, int(causal), 1.0 / math.sqrt(hd),
                     stream_ptr(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd ({path}) launch failed: "
                           f"CUDA error {err}")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.route_launches[path] += 1
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
    check_inputs(q, k, v, who, BWD_HEAD_DIMS, o=o, do=do)
    b, s, hq, hd = q.shape
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (b, hq, s) or not lse.is_contiguous()):
        raise ValueError(f"{who}: lse {lse.dtype}{tuple(lse.shape)} on "
                         f"{lse.device}, want contiguous float32 "
                         f"{(b, hq, s)} on {q.device}")
    # one float32 copy of do, multiplied by o in place (float32 math)
    delta = do.to(torch.float32, copy=True).mul_(o).sum(-1)
    delta = delta.transpose(1, 2).contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    path = route(q.dtype)
    strides = _strides(who, path, q, k, v, do, dq, dk, dv)
    launch = (build_bwd_tc().flash_attention_bwd_tc_launch
              if path == "tensor_core"
              else build_bwd().flash_attention_bwd_launch)
    with on_device(q.device):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                     dk.data_ptr(), dv.data_ptr(), strides.ctypes.data, b, s,
                     hq, k.shape[2], hd, int(causal), 1.0 / math.sqrt(hd),
                     stream_ptr(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd ({path}) launch failed: "
                           f"CUDA error {err}")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.route_launches[path] += 1
    return dq, dk, dv


#: kernel launches since the count was last set to 0, and by route
flash_attention_fwd.launches = 0
flash_attention_fwd.route_launches = dict.fromkeys(ROUTES.values(), 0)
#: backward calls (each launches the dk/dv and the dq kernel) since the
#: count was last set to 0, and by route
flash_attention_bwd.launches = 0
flash_attention_bwd.route_launches = dict.fromkeys(ROUTES.values(), 0)
