"""Helpers shared by the ``test_torch_*`` parity tests: build the same
inputs for the JAX reference (``repro``) and the PyTorch port
(``repro_torch``), run both, and diff their metrics (integers and bools
exact, floats to the golden grid's rtol=1e-6 — `tests/test_golden.py`;
floats may reassociate across the two frameworks)."""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from repro.core.smla import engine as ref_engine
from repro_torch import _build
from repro_torch.convert import from_reference
from repro_torch.core.smla import config as port_config
from repro_torch.core.smla import cuda_engine
from repro_torch.core.smla import engine as port_engine
from repro_torch.core.smla import faults as port_faults
from repro_torch.core.smla import sweep as port_sweep

RTOL = 1e-6

#: the cycle kernel's host build: its header around a plain host loop
#: whose warp is 32 lanes taken in turn (``csrc/smla_host.cpp``)
HOST_SOURCES = ("smla_cycle.cuh", "smla_host.cpp")
HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


def host_library():
    """The g++ build of the cycle kernel's logic (skips without g++)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    return cuda_engine.load_library(_build.compile_library(
        "g++", HOST_FLAGS, HOST_SOURCES, "smla_host"))


def host_launch(lib):
    """A launcher with `cuda_engine.sim_cell_blocks`'s signature that runs
    the wrapper's steps on CPU tensors, the host loop in place of the
    launch; `chunk` may be one width per cell, as on the card (nothing is
    built, so `build_dir` is not used)."""
    def launch(params, traces, *, horizon, core, banks, chunk,
               build_dir=None):
        ctx = port_engine._prepare(params, traces, core, banks)
        p = cuda_engine.pack(ctx, horizon, chunk)
        cuda_engine.check_packed(p, torch.device("cpu"))
        bufs = cuda_engine.alloc_buffers(p, "cpu")
        assert lib.smla_sim_host(*cuda_engine.pointer_args(p, bufs)) == 0
        return port_engine._metrics(params, ctx, cuda_engine.unpack(bufs),
                                    horizon)
    return launch


def port_policy(pol):
    """The port's ControllerPolicy equal to a reference one."""
    return port_config.ControllerPolicy(
        **{f.name: int(getattr(pol, f.name))
           for f in dataclasses.fields(pol)})


def port_fault(fc):
    return port_faults.FaultConfig(
        dead_layers=fc.dead_layers, stuck_groups=fc.stuck_groups,
        weak_ranks=fc.weak_ranks, retention_derate=fc.retention_derate,
        ecc_rate=fc.ecc_rate, degrade=int(fc.degrade))


def port_stack(sc):
    """The port's StackConfig equal to a reference one."""
    kw = {f.name: getattr(sc, f.name) for f in dataclasses.fields(sc)}
    kw["io_model"] = int(kw["io_model"])
    kw["rank_org"] = int(kw["rank_org"])
    kw["policy"] = port_policy(kw["policy"])
    kw["faults"] = port_fault(kw["faults"])
    return port_config.StackConfig(**kw)


def port_cell(cell):
    return port_sweep.SweepCell(cell.name, port_stack(cell.stack),
                                cell.traces)


def stacked_inputs(cells):
    """(params, traces) numpy dicts for a batch of reference cells, padded
    as the sweep pads one shape group (the reference's own `to_params`
    lowers each stack)."""
    return port_sweep.stack_cells(cells)


def run_ref(cells, horizon, chunk, core=None):
    """Reference batched engine (scan backend) on reference cells."""
    params, traces = stacked_inputs(cells)
    out = ref_engine.batched_simulate(
        params, traces, ref_engine.SimOptions(horizon=horizon, chunk=chunk),
        core or ref_engine.CoreParams(), cells[0].stack.banks_per_rank)
    return {k: np.asarray(v) for k, v in out.items()}


def run_port(cells, horizon, chunk, core=None):
    """Port's batched engine on the CPU (the plain version), fed the same
    numpy inputs through `convert.from_reference`."""
    params, traces = from_reference(*stacked_inputs(cells))
    out = port_engine.batched_simulate(
        params, traces,
        port_engine.SimOptions(horizon=horizon, chunk=chunk, device="cpu"),
        port_core(core), cells[0].stack.banks_per_rank)
    return {k: v.numpy() for k, v in out.items()}


def port_core(core):
    if core is None:
        return port_engine.CoreParams()
    return port_engine.CoreParams(**dataclasses.asdict(core))


def diff_metrics(name, got, want, skip=()):
    """Per-metric differences of two metric dicts (ints/bools exact with
    equal dtypes, floats to RTOL)."""
    errors = []
    for k in sorted(want):
        if k in skip:
            continue
        if k not in got:
            errors.append(f"{name}:{k} missing")
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if g.dtype != w.dtype or g.shape != w.shape:
            errors.append(f"{name}:{k} dtype/shape {g.dtype}{g.shape} want "
                          f"{w.dtype}{w.shape}")
        elif np.issubdtype(w.dtype, np.floating):
            if not np.allclose(g, w, rtol=RTOL, atol=0.0):
                errors.append(f"{name}:{k} got {g.tolist()} want "
                              f"{w.tolist()}")
        elif not np.array_equal(g, w):
            errors.append(f"{name}:{k} got {g.tolist()} want {w.tolist()}")
    return errors


def diff_batches(cells, got, want, skip=()):
    """diff_metrics row by row over a batch."""
    errors = []
    for i, c in enumerate(cells):
        errors += diff_metrics(c.name, {k: v[i] for k, v in got.items()},
                               {k: v[i] for k, v in want.items()}, skip)
    return errors


#: the grid of the reference's sweep-engine tests
#: (tests/test_sweep_resilience.py, tests/test_sweep_streaming.py)
SWEEP_HORIZON = 3_000
SWEEP_N_REQ = 30


def stream_cells(n_layers=(2, 4), n_cores=2, name="s"):
    """Reference cells of those tests' grid: `n_cores` STREAM cores x 5 IO
    models x `n_layers` (10 cells, one shape group, by default), named
    ``L{layers}/{config}/{name}``."""
    from repro.core.smla import sweep as ref_sweep
    from repro.core.smla.traces import WorkloadSpec
    w = WorkloadSpec("stream.t", 50.0, 0.85, write_frac=1 / 3)
    return tuple(ref_sweep.paper_grid([(name, [w] * n_cores, 3)],
                                      layers=n_layers, n_req=SWEEP_N_REQ))


def port_spec(cells, horizon=SWEEP_HORIZON, **kw):
    """The port's SweepSpec of reference `cells` on the CPU."""
    opts = kw.pop("options", None) or port_engine.SimOptions(
        horizon=horizon, device="cpu")
    if kw.get("policies") is not None:
        kw["policies"] = tuple(port_policy(p) for p in kw["policies"])
    return port_sweep.SweepSpec(tuple(port_cell(c) for c in cells), opts,
                                **kw)


def assert_same_cells(got, want, skip=()):
    """Two SweepResults (either package) hold the same cells in the same
    order, every metric equal: same dtype, same values, bit for bit."""
    assert got.names == want.names
    for name, g, w in zip(got.names, got.cells, want.cells):
        assert set(g) == set(w), name
        for k in w:
            if k in skip:
                continue
            a, b = np.asarray(g[k]), np.asarray(w[k])
            assert a.dtype == b.dtype and np.array_equal(a, b), \
                f"{name}:{k} {a.tolist()} != {b.tolist()}"


def assert_same_buckets(got, want):
    """The bucket metadata of two SweepResults agree entry for entry."""
    keys = ("cells", "chunk", "est_cycles", "measured_cycles", "n_rows",
            "chunks_run", "est_max", "measured_max")
    assert [[b[k] for k in keys] for b in got.buckets] == \
        [[b[k] for k in keys] for b in want.buckets]
