"""Building the port's hand-written CUDA kernels (route (b)): ``nvcc``
compiles one translation unit of ``csrc/`` into a shared library with a
plain C interface, at first use, into ``build/repro_torch_kernels/`` at
the root of the checkout, keyed by a hash of the compiler, the flags and
every source.  No PyTorch headers are compiled, so a build takes seconds.
The libraries are loaded with ``ctypes``; every pointer and the stream
travel as ``ctypes.c_void_p``."""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"

#: where built libraries go: ``build/repro_torch_kernels`` at the root of
#: the checkout
BUILD_DIR = CSRC.parents[2] / "build" / "repro_torch_kernels"

#: nvcc flags of the attention kernels: Hopper's ``sm_90a`` target
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def compile_library(compiler: str, flags, sources, name: str) -> pathlib.Path:
    """Compile `sources` (names under ``csrc/``; the first non-header is
    the translation unit) into ``BUILD_DIR/<name>-<hash>.so`` unless it
    is already there.  The hash covers every source and the flags, so an
    edited source rebuilds.  Raises ``RuntimeError`` with the compiler's
    output on failure."""
    h = hashlib.sha256(" ".join((compiler,) + tuple(flags)).encode())
    for s in sources:
        h.update((CSRC / s).read_bytes())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    unit = next(s for s in sources if not s.endswith(".cuh"))
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            [compiler, *flags, "-I", str(CSRC), "-o", tmp, str(CSRC / unit)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler} failed ({proc.returncode}) "
                               f"building {unit}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)      # atomic: concurrent builders both land
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def nvcc() -> str:
    """Path of ``nvcc``: PATH, then ``$CUDA_HOME/bin``, then
    ``/usr/local/cuda/bin``."""
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def bind(lib: ctypes.CDLL, fn_name: str, n_ptrs: int, extra=()):
    """Declare a C entry of `lib`: `n_ptrs` pointer arguments, then the
    ctypes types in `extra`; it returns an ``int`` (a ``cudaError_t``)."""
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + list(extra)
    fn.restype = ctypes.c_int
    return fn


def stream_ptr(device) -> int:
    """PyTorch's current stream on `device`, as the launchers take it (the
    raw handle, without building a ``torch.cuda.Stream``: launchers call
    this once per launch)."""
    import torch
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def on_device(device):
    """The context that makes `device` current, if it is not already (a
    launcher's host cost: entering ``torch.cuda.device`` on every call
    shows at short kernels)."""
    import torch
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
