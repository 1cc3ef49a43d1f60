"""Helpers shared by the ``test_torch_*`` parity tests: build the same
inputs for the JAX reference (``repro``) and the PyTorch port
(``repro_torch``), run both, and diff their metrics (integers and bools
exact, floats to the golden grid's rtol=1e-6 — `tests/test_golden.py`;
floats may reassociate across the two frameworks)."""
import dataclasses

import numpy as np

from repro.core.smla import engine as ref_engine
from repro_torch.convert import from_reference
from repro_torch.core.smla import config as port_config
from repro_torch.core.smla import engine as port_engine
from repro_torch.core.smla import faults as port_faults
from repro_torch.core.smla import sweep as port_sweep

RTOL = 1e-6


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
