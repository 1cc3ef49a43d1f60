"""The SMLA cascaded-pipeline matmul on Hopper: the wrappers of the
hand-written CUDA kernels of ``csrc/smla_pipe.cu``, which replace the
reference's Pallas kernel ``repro/kernels/smla_pipe/kernel.py::
matmul_cascaded`` and, launched once per layer slab, ``::matmul_dedicated``.

Three kernels, each launched on PyTorch's current stream:

- staging (`stage_tf32`): x and w, float32 or bf16, to TF32 hi (and, for
  float32, lo) planes, w transposed to K-major, stacked as the product
  kernel's 128-row x 32-float tiles in the Cascaded-IO order;
- product: persistent blocks, one per SM, take 128 x 128 output tiles
  in turn and stream their chunks through a ring of shared-memory stages
  (bulk copies under mbarriers, one producer warp) into two consumer
  warpgroups' wgmma products: three per chunk for float32 (x_hi w_hi +
  x_hi w_lo + x_lo w_hi, "3xTF32"), one for bf16, whose values are exact
  in TF32; each chunk's products are added into a float32 register
  accumulator;
- sum (`sum_partials`): Dedicated-IO's L partials, ((p0 + p1) + p2) + ...

What bounds it is operations: three TF32 products at 495 TFLOP/s, 1.146
ms at the realistic shape (x (8192, 2048) @ w (4, 512, 5632)), against
0.089 ms of bytes; the source says how the design meets that.  Any M, N
and K/L are right (the staging pads with zeros, the output store masks).

Build: route (b) (`repro_torch._build`), at first use.  The wrappers
check device, dtype (float32 or bfloat16, equal for x and w), shapes and
strides, once per input layout, allocate the planes and outputs with
``torch.empty`` and raise if a launch fails.  Counts: ``matmul_cascaded.
launches`` its product launches (one per call); ``matmul_dedicated.
launches`` the L product launches of each of its calls;
``stage_tf32.launches`` and ``sum_partials.launches`` every launch of
those two kernels, the matmuls' own included.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch._build import (NVCC_FLAGS, bind, compile_library, nvcc,
                                on_device, stream_ptr)
from repro_torch.kernels.smla_pipe import ref

KERNEL_SOURCES = ("smla_pipe.cu",)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def build() -> ctypes.CDLL:
    """Build (first use only) and load the kernels' library."""
    lib = ctypes.CDLL(str(compile_library(nvcc(), NVCC_FLAGS, KERNEL_SOURCES,
                                          "smla_pipe")))
    bind(lib, "smla_pipe_stage_launch", 3,
         [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    bind(lib, "smla_pipe_product_launch", 2,
         [ctypes.c_int] * 7 + [ctypes.c_void_p])
    bind(lib, "smla_pipe_sum_launch", 2,
         [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    return lib


def check_inputs(x, w, who: str) -> None:
    """Raise unless x (M, K) with contiguous rows and w (L, K/L, N)
    contiguous are CUDA tensors of one device and one dtype the kernels
    take."""
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


#: the input layouts already checked, each (shape, strides, dtype, device)
#: of x and w: at the bench's default shape a call is short enough for the
#: checks' host time to show
_LAYOUTS: set = set()
_MAX_LAYOUTS = 256


def _check_once(x, w, who: str) -> None:
    key = tuple((t.shape, t.stride(), t.dtype, t.device) for t in (x, w))
    if key not in _LAYOUTS:
        check_inputs(x, w, who)
        if len(_LAYOUTS) >= _MAX_LAYOUTS:
            _LAYOUTS.clear()
        _LAYOUTS.add(key)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"smla_pipe {what} launch failed: CUDA error "
                           f"{err}")


def _stage(x, w):
    planes = torch.empty(ref.planes_numel(x, w), dtype=torch.float32,
                         device=x.device)
    l, kpl, n = w.shape
    with on_device(x.device):
        err = build().smla_pipe_stage_launch(
            x.data_ptr(), w.data_ptr(), planes.data_ptr(), x.stride(0),
            x.shape[0], n, kpl, l, DTYPE_CODES[x.dtype],
            stream_ptr(x.device))
    _raise_on(err, "staging")
    stage_tf32.launches += 1
    return planes


def _product(planes, out, x, w, t0: int, t1: int) -> None:
    """out (M, N) float32 = the products of chunks [t0, t1) of `planes`,
    staged for (x, w)."""
    l, kpl, n = w.shape
    with on_device(x.device):
        err = build().smla_pipe_product_launch(
            planes.data_ptr(), out.data_ptr(), x.shape[0], n, kpl, l, t0, t1,
            int(x.dtype == torch.float32), stream_ptr(x.device))
    _raise_on(err, "product")


def _sum(parts):
    out = torch.empty(parts.shape[1:], dtype=torch.float32,
                      device=parts.device)
    with on_device(parts.device):
        err = build().smla_pipe_sum_launch(
            parts.data_ptr(), out.data_ptr(), out.numel(), parts.shape[0],
            stream_ptr(parts.device))
    _raise_on(err, "sum")
    sum_partials.launches += 1
    return out


def stage_tf32(x, w):
    """x (M, K), w (L, K/L, N) on the card -> the product kernel's planes,
    flat float32, as ``ref.stage_tf32`` lays them out, by one launch of
    the staging kernel."""
    _check_once(x, w, "stage_tf32")
    return _stage(x, w)


def sum_partials(parts):
    """parts (L, M, N) float32, contiguous, on the card -> ((parts[0] +
    parts[1]) + parts[2]) + ..., by one launch of the sum kernel."""
    if (parts.device.type != "cuda" or parts.dtype != torch.float32
            or parts.dim() != 3 or not parts.is_contiguous()
            or parts.numel() == 0):
        raise ValueError(f"sum_partials: want contiguous float32 (L, M, N) "
                         f"on a CUDA device, got {parts.dtype}"
                         f"{tuple(parts.shape)} on {parts.device}")
    return _sum(parts)


def matmul_cascaded(x, w):
    """x (M, K); w (L, K/L, N), on the card -> (M, N) float32: the
    staging, then one product launch over every layer's chunks."""
    _check_once(x, w, "matmul_cascaded")
    planes = _stage(x, w)
    out = torch.empty((x.shape[0], w.shape[2]), dtype=torch.float32,
                      device=x.device)
    _product(planes, out, x, w, 0, w.shape[0] * -(-w.shape[1] // ref.CHUNK))
    matmul_cascaded.launches += 1
    return out


def matmul_dedicated(x, w):
    """Dedicated-IO: the staging, then one product launch per layer slab,
    each over that layer's chunks into a private partial (M, N), and the
    partials summed by the sum kernel, ((p0 + p1) + p2) + ..., as the
    reference sums outside its kernel."""
    _check_once(x, w, "matmul_dedicated")
    l, kpl, n = w.shape
    n_k = -(-kpl // ref.CHUNK)
    planes = _stage(x, w)
    parts = torch.empty((l, x.shape[0], n), dtype=torch.float32,
                        device=x.device)
    for layer in range(l):
        _product(planes, parts[layer], x, w, layer * n_k, (layer + 1) * n_k)
    matmul_dedicated.launches += l
    return _sum(parts)


#: product launches since the count was last set to 0
matmul_cascaded.launches = 0
#: product launches (L per call) since the count was last set to 0
matmul_dedicated.launches = 0
#: staging launches (one per matmul call, and per call of its own)
stage_tf32.launches = 0
#: sum launches (one per matmul_dedicated call, and per call of its own)
sum_partials.launches = 0
