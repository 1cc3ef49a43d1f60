"""CUDA backend of the SMLA cycle engine: the Hopper counterpart of the
reference's Pallas kernel (``repro/core/smla/pallas_engine.py::
sim_cell_blocks``).

The reference fuses the whole chunked per-cycle pipeline of a block of
cells into one Pallas kernel and writes back only the metrics.  Here one
CUDA thread runs one cell's whole chunked simulation
(``csrc/smla_cycle.cuh``, launched by ``csrc/smla_engine.cu``): a cell's
cycles form a serial chain, cells are independent.  The kernel writes the
final counters, ``served``, ``c_finish``, ``c_inst`` and ``chunks_run``;
`engine._metrics` — the same function the plain version ends in — turns
them into the metrics dict in torch on the card.

Build: route (b), by `repro_torch._build` — ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes``, at first use.

Dispatch: `sim_cell_blocks` runs the kernel for CUDA tensors and the plain
PyTorch version (`engine._sim_core`) for CPU tensors; it never falls back
from one to the other.  A failed build or launch raises.
``sim_cell_blocks.launches`` counts kernel launches (not plain runs).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch._build import bind, compile_library, nvcc, stream_ptr
from repro_torch.core.smla import engine

KERNEL_SOURCES = ("smla_cycle.cuh", "smla_engine.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

#: per-cell int32 context columns, in the order of ``enum Ctx`` in
#: ``csrc/smla_cycle.cuh``
CTX_COLUMNS = ("n_req", "t_rcd", "t_rp", "t_cl", "t_wr", "t_wtr", "t_pd",
               "t_sr", "t_xsr", "refresh_en", "t_rfc_eff", "L", "slotted",
               "ecc_every", "n_ranks", "fcfs", "closed_page", "per_bank",
               "drain_full", "drain_opp", "sr", "postpone", "ooo_row",
               "ooo_dir")
#: per-rank int32 rows (``enum RankRow``)
RANK_ROWS = ("t_refi_eff", "dur", "group_of_rank", "ref_next0")
#: int32 trace fields (``enum Trace``); inst travels as float32
TRACE_FIELDS = ("rank", "bank", "row", "wr")
#: launch dimensions (``enum Dim``)
DIM_FIELDS = ("N", "C", "M", "R", "B", "Wd", "horizon", "chunk", "k_max",
              "mshr_window", "q_size", "wq_hi", "wq_lo")


def load_library(path) -> ctypes.CDLL:
    """Load a built engine library and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    lib.smla_scratch_words.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.smla_scratch_words.restype = None
    if hasattr(lib, "smla_sim_launch"):
        bind(lib, "smla_sim_launch", 11, (ctypes.c_int, ctypes.c_void_p))
    if hasattr(lib, "smla_sim_host"):
        bind(lib, "smla_sim_host", 11)
    return lib


@functools.cache
def build() -> ctypes.CDLL:
    """Build (first use only) and load the CUDA kernel library."""
    return load_library(compile_library(nvcc(), NVCC_FLAGS, KERNEL_SOURCES,
                                        "smla_engine"))


# ----------------------------------------------------------------------------
# packing: engine._prepare's context -> the kernel's flat buffers
# ----------------------------------------------------------------------------

def pack(ctx: dict, horizon: int, chunk: int | None) -> dict:
    """The kernel's inputs from `engine._prepare`'s context: contiguous
    int32 / float32 tensors on the context's device, plus the host-side
    dims arrays."""
    N, pol = ctx["N"], ctx["pol"]
    cols = []
    for name in CTX_COLUMNS:
        v = pol[name] if name in pol else ctx[name]
        cols.append(v.reshape(N).to(torch.int32))
    core = ctx["core"]
    dims = {"N": N, "C": ctx["C"], "M": ctx["M"], "R": ctx["R"],
            "B": ctx["B"], "Wd": ctx["Wd"], "horizon": int(horizon),
            "chunk": engine.effective_chunk(horizon, chunk),
            "k_max": engine.n_chunks(horizon, chunk),
            "mshr_window": core.mshr * core.window, "q_size": core.q_size,
            "wq_hi": ctx["wq_hi"], "wq_lo": ctx["wq_lo"]}
    tr = ctx["traces"]
    return {
        "dims": np.array([dims[k] for k in DIM_FIELDS], np.int32),
        "fdims": np.array([core.inst_window, core.inst_per_fast_cycle],
                          np.float32),
        "ctx": torch.stack(cols, 1).contiguous(),
        "rank": torch.stack([ctx[k].to(torch.int32) for k in RANK_ROWS],
                            1).contiguous(),
        "inst": tr["inst"].contiguous(),
        "tr": torch.stack([tr[k].to(torch.int32) for k in TRACE_FIELDS],
                          1).contiguous(),
    }


def check_packed(p: dict, device: torch.device) -> None:
    """Raise unless every buffer is a contiguous tensor of the kernel's
    dtype and shape on `device`, and the integers that reach C's
    truncating '/' and '%' are non-negative (so they agree with JAX's
    floor semantics)."""
    d = dict(zip(DIM_FIELDS, (int(v) for v in p["dims"])))
    N, C, M, R = d["N"], d["C"], d["M"], d["R"]
    want = {"ctx": ((N, len(CTX_COLUMNS)), torch.int32),
            "rank": ((N, len(RANK_ROWS), R), torch.int32),
            "inst": ((N, C, M), torch.float32),
            "tr": ((N, len(TRACE_FIELDS), C, M), torch.int32)}
    for k, (shape, dtype) in want.items():
        x = p[k]
        if (tuple(x.shape) != shape or x.dtype != dtype
                or x.device != device or not x.is_contiguous()):
            raise ValueError(f"kernel input {k}: got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device} (contiguous="
                             f"{x.is_contiguous()}), want {shape} {dtype} "
                             f"contiguous on {device}")
    if min(d[k] for k in ("N", "C", "M", "R", "B", "Wd", "horizon", "chunk",
                          "k_max")) < 1:
        raise ValueError(f"kernel dims must be positive: {d}")
    ctx = p["ctx"]
    bad = bool((ctx < 0).any()) or bool((p["rank"] < 0).any())
    bad = bad or bool((p["tr"][:, :2] < 0).any())
    if bad:
        raise ValueError("kernel inputs hold negative timings, ranks or "
                         "banks: C's truncating '/' and '%' would disagree "
                         "with the reference's floor semantics")
    if bool((ctx[:, CTX_COLUMNS.index("n_req")] < 1).any()) or bool(
            (ctx[:, CTX_COLUMNS.index("ecc_every")] < 1).any()) or bool(
            (ctx[:, CTX_COLUMNS.index("L")] < 1).any()):
        raise ValueError("kernel inputs need n_req, ecc_every and layers "
                         ">= 1")


def scratch_words(lib: ctypes.CDLL, dims: np.ndarray) -> tuple[int, int]:
    """(int32, float32) scratch words per cell, from the library itself."""
    out = np.zeros(2, np.int64)
    lib.smla_scratch_words(dims.ctypes.data, out.ctypes.data)
    return int(out[0]), int(out[1])


def alloc_buffers(lib, p: dict, device) -> dict:
    """Scratch and output buffers (``torch.empty``; the kernel initialises
    every word it reads)."""
    N, C = int(p["dims"][0]), int(p["dims"][1])
    wi, wf = scratch_words(lib, p["dims"])
    e = torch.empty
    return {"scratch_i": e(N * wi, dtype=torch.int32, device=device),
            "scratch_f": e(N * wf, dtype=torch.float32, device=device),
            "out_i": e((N, len(engine.SUMMARY_INT)), dtype=torch.int32,
                       device=device),
            "out_core": e((N, 2, C), dtype=torch.int32, device=device),
            "out_f": e((N, C), dtype=torch.float32, device=device)}


def pointer_args(p: dict, bufs: dict) -> list:
    """The 11 pointer arguments shared by the CUDA launcher and the host
    build, in their C order."""
    return [p["dims"].ctypes.data, p["fdims"].ctypes.data,
            p["ctx"].data_ptr(), p["rank"].data_ptr(), p["inst"].data_ptr(),
            p["tr"].data_ptr(), bufs["scratch_i"].data_ptr(),
            bufs["scratch_f"].data_ptr(), bufs["out_i"].data_ptr(),
            bufs["out_core"].data_ptr(), bufs["out_f"].data_ptr()]


def unpack(bufs: dict) -> dict:
    """The kernel's outputs as `engine._summary`'s dict."""
    out = {k: bufs["out_i"][:, j] for j, k in enumerate(engine.SUMMARY_INT)}
    out.update(served=bufs["out_core"][:, 0], c_finish=bufs["out_core"][:, 1],
               c_inst=bufs["out_f"])
    return out


def threads_per_block(n_cells: int, device: torch.device) -> int:
    """Small blocks: spread the cells over every SM (at most a warp)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(32, -(-n_cells // sms)))


def sim_cell_blocks(params: dict, traces: dict, *, horizon: int,
                    core: engine.CoreParams, banks: int,
                    chunk: int | None) -> dict:
    """Batched simulation (leading cell axis on every leaf), same contract
    as the reference's ``sim_cell_blocks``.  CPU tensors run the plain
    PyTorch version; CUDA tensors run the kernel, and anything the kernel
    cannot take raises."""
    dev = traces["inst"].device
    if dev.type == "cpu":
        return engine._sim_core(params, traces, horizon, core, banks, chunk)
    if dev.type != "cuda":
        raise ValueError(f"sim_cell_blocks: unsupported device {dev}")
    lib = build()
    ctx = engine._prepare(params, traces, core, banks)
    p = pack(ctx, horizon, chunk)
    check_packed(p, dev)
    bufs = alloc_buffers(lib, p, dev)
    with torch.cuda.device(dev):
        err = lib.smla_sim_launch(*pointer_args(p, bufs),
                                  threads_per_block(ctx["N"], dev),
                                  stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"smla_sim_kernel launch failed: CUDA error "
                           f"{err}")
    sim_cell_blocks.launches += 1
    return engine._metrics(params, ctx, unpack(bufs), horizon)


#: kernel launches since the count was last set to 0
sim_cell_blocks.launches = 0
