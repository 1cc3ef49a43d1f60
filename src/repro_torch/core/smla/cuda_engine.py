"""CUDA backend of the SMLA cycle engine: the Hopper counterpart of the
reference's Pallas kernel (``repro/core/smla/pallas_engine.py::
sim_cell_blocks``).

The reference fuses the whole chunked per-cycle pipeline of a block of
cells into one Pallas kernel and writes back only the metrics.  Here one
warp runs one cell's whole chunked simulation (``csrc/smla_cycle.cuh``,
launched by ``csrc/smla_engine.cu``): a cell's cycles form a serial
chain, which the warp shortens by taking each cycle's scans over window
slots and ranks as warp collectives, with the cell's state in shared
memory; cells are independent, a few warps to a block.  Each cell
carries its own chunk width, so cells of different makespan buckets
share one launch.  The kernel writes the final counters, ``served``,
``c_finish``, ``c_inst`` and ``chunks_run``; `engine._metrics` — the
same function the plain version ends in — turns them into the metrics
dict in torch on the card.

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

from repro_torch._build import (BUILD_DIR, bind, compile_library, nvcc,
                                on_device, stream_ptr)
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
               "ooo_dir", "chunk", "k_max")
#: per-rank int32 rows (``enum RankRow``)
RANK_ROWS = ("t_refi_eff", "dur", "group_of_rank", "ref_next0")
#: int32 trace fields (``enum Trace``); inst travels as float32
TRACE_FIELDS = ("rank", "bank", "row", "wr")
#: launch dimensions (``enum Dim``)
DIM_FIELDS = ("N", "C", "M", "R", "B", "Wd", "horizon", "mshr_window",
              "q_size", "wq_hi", "wq_lo")
#: ranks per cell at most: the kernel gives each a lane and a mask bit
MAX_RANKS = 32
#: shared memory one block may use on Hopper (bytes)
MAX_SMEM = 232448
#: cells (warps) per block at most
MAX_WARPS = 4
#: horizons the kernel takes are below this (``BIG`` of the header)
MAX_HORIZON = 2**30


def load_library(path) -> ctypes.CDLL:
    """Load a built engine library and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    lib.smla_cell_words.argtypes = [ctypes.c_void_p]
    lib.smla_cell_words.restype = ctypes.c_longlong
    if hasattr(lib, "smla_sim_launch"):
        bind(lib, "smla_sim_launch", 9, (ctypes.c_int, ctypes.c_void_p))
    if hasattr(lib, "smla_sim_host"):
        bind(lib, "smla_sim_host", 9)
    return lib


def build(build_dir=None) -> ctypes.CDLL:
    """Build (first use in `build_dir` only; default
    ``_build.BUILD_DIR``) and load the CUDA kernel library, once per
    directory and process."""
    return _build_in(str(BUILD_DIR if build_dir is None else build_dir))


@functools.cache
def _build_in(build_dir: str) -> ctypes.CDLL:
    return load_library(compile_library(nvcc(), NVCC_FLAGS, KERNEL_SOURCES,
                                        "smla_engine", build_dir))


# ----------------------------------------------------------------------------
# packing: engine._prepare's context -> the kernel's flat buffers
# ----------------------------------------------------------------------------

def cell_chunks(horizon: int, chunk, n: int) -> tuple[list, list]:
    """Each of `n` cells' (chunk width, chunk count) for `horizon`:
    `chunk` is one width (int or None) for every cell, or a sequence of
    one width per cell."""
    widths = ([chunk] * n if chunk is None or isinstance(chunk, (int,
                                                               np.integer))
              else list(chunk))
    if len(widths) != n:
        raise ValueError(f"{len(widths)} chunk widths for {n} cells")
    return ([engine.effective_chunk(horizon, w) for w in widths],
            [engine.n_chunks(horizon, w) for w in widths])


def pack(ctx: dict, horizon: int, chunk) -> dict:
    """The kernel's inputs from `engine._prepare`'s context: contiguous
    int32 / float32 tensors on the context's device, plus the host-side
    dims arrays.  `chunk` is one width for every cell or one per cell
    (`cell_chunks`); it fills the context's last two columns."""
    N, pol = ctx["N"], ctx["pol"]
    dev = ctx["n_req"].device
    widths, counts = cell_chunks(horizon, chunk, N)
    per_cell = {"chunk": widths, "k_max": counts}
    cols = []
    for name in CTX_COLUMNS:
        if name in per_cell:
            cols.append(torch.tensor(per_cell[name], dtype=torch.int32,
                                     device=dev))
            continue
        v = pol[name] if name in pol else ctx[name]
        cols.append(v.reshape(N).to(torch.int32))
    core = ctx["core"]
    dims = {"N": N, "C": ctx["C"], "M": ctx["M"], "R": ctx["R"],
            "B": ctx["B"], "Wd": ctx["Wd"], "horizon": int(horizon),
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
    dtype and shape on `device`, the rank axis fits a warp's lanes, and
    the integers that reach C's truncating '/' and '%' are non-negative
    (so they agree with JAX's floor semantics)."""
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
    if min(d[k] for k in ("N", "C", "M", "R", "B", "Wd", "horizon")) < 1:
        raise ValueError(f"kernel dims must be positive: {d}")
    if R > MAX_RANKS:
        raise ValueError(f"kernel rank axis {R} > {MAX_RANKS}: a warp "
                         f"takes one rank per lane")
    if d["horizon"] >= MAX_HORIZON:
        raise ValueError(f"horizon {d['horizon']} >= {MAX_HORIZON}: the "
                         f"kernel tells a scheduling candidate by its score "
                         f"above -2**30, which needs arrivals below it")
    ctx = p["ctx"]
    bad = bool((ctx < 0).any()) or bool((p["rank"] < 0).any())
    bad = bad or bool((p["tr"][:, :2] < 0).any())
    if bad:
        raise ValueError("kernel inputs hold negative timings, ranks or "
                         "banks: C's truncating '/' and '%' would disagree "
                         "with the reference's floor semantics")
    for name in ("n_req", "ecc_every", "L", "chunk", "k_max"):
        if bool((ctx[:, CTX_COLUMNS.index(name)] < 1).any()):
            raise ValueError("kernel inputs need n_req, ecc_every, layers, "
                             "chunk and k_max >= 1")


def cell_words(lib: ctypes.CDLL, dims: np.ndarray) -> int:
    """32-bit words of one cell's state (a warp's shared memory), from the
    library itself."""
    return int(lib.smla_cell_words(dims.ctypes.data))


def alloc_buffers(p: dict, device) -> dict:
    """Output buffers (``torch.empty``; the kernel writes every word)."""
    N, C = int(p["dims"][0]), int(p["dims"][1])
    e = torch.empty
    return {"out_i": e((N, len(engine.SUMMARY_INT)), dtype=torch.int32,
                       device=device),
            "out_core": e((N, 2, C), dtype=torch.int32, device=device),
            "out_f": e((N, C), dtype=torch.float32, device=device)}


def pointer_args(p: dict, bufs: dict) -> list:
    """The 9 pointer arguments shared by the CUDA launcher and the host
    build, in their C order."""
    return [p["dims"].ctypes.data, p["fdims"].ctypes.data,
            p["ctx"].data_ptr(), p["rank"].data_ptr(), p["inst"].data_ptr(),
            p["tr"].data_ptr(), bufs["out_i"].data_ptr(),
            bufs["out_core"].data_ptr(), bufs["out_f"].data_ptr()]


def unpack(bufs: dict) -> dict:
    """The kernel's outputs as `engine._summary`'s dict."""
    out = {k: bufs["out_i"][:, j] for j, k in enumerate(engine.SUMMARY_INT)}
    out.update(served=bufs["out_core"][:, 0], c_finish=bufs["out_core"][:, 1],
               c_inst=bufs["out_f"])
    return out


def warps_per_block(n_cells: int, words: int, device: torch.device) -> int:
    """Cells (warps) per block: few enough that the cells spread over
    every SM (at most MAX_WARPS), and their state fits the block's shared
    memory; raises if one cell's does not."""
    if 4 * words > MAX_SMEM:
        raise ValueError(f"one cell's state is {4 * words} B of shared "
                         f"memory (> {MAX_SMEM})")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(MAX_WARPS, -(-n_cells // sms),
                      MAX_SMEM // (4 * words)))


def sim_cell_blocks(params: dict, traces: dict, *, horizon: int,
                    core: engine.CoreParams, banks: int, chunk,
                    build_dir=None) -> dict:
    """Batched simulation (leading cell axis on every leaf), same contract
    as the reference's ``sim_cell_blocks``; `chunk` may also be a sequence
    of one width per cell (the sweep's one launch per shape group).  CPU
    tensors run the plain PyTorch version (one width only); CUDA tensors
    run the kernel, built in `build_dir` (`build`), and anything the
    kernel cannot take raises.  The launch is counted once the kernel is
    enqueued without error: a call that fails before (a failed build, an
    allocation out of memory, a launch error) counts nothing."""
    dev = traces["inst"].device
    if dev.type == "cpu":
        if not (chunk is None or isinstance(chunk, (int, np.integer))):
            raise ValueError("sim_cell_blocks: the plain version takes one "
                             "chunk width per batch")
        return engine._sim_core(params, traces, horizon, core, banks, chunk)
    if dev.type != "cuda":
        raise ValueError(f"sim_cell_blocks: unsupported device {dev}")
    lib = build(build_dir)
    ctx = engine._prepare(params, traces, core, banks)
    p = pack(ctx, horizon, chunk)
    check_packed(p, dev)
    bufs = alloc_buffers(p, dev)
    warps = warps_per_block(ctx["N"], cell_words(lib, p["dims"]), dev)
    with on_device(dev):
        err = lib.smla_sim_launch(*pointer_args(p, bufs), warps,
                                  stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"smla_sim_kernel launch failed: CUDA error "
                           f"{err}")
    sim_cell_blocks.launches += 1
    return engine._metrics(params, ctx, unpack(bufs), horizon)


#: kernel launches since the count was last set to 0
sim_cell_blocks.launches = 0
