"""The port's cycle engine (``repro_torch.core.smla.engine``, its plain
PyTorch version on the CPU) against the JAX reference engine.

* the checked-in golden grid (`tests/golden/smla_small_grid.json`),
  through the port, must match the file — integers exactly, floats to
  rtol=1e-6;
* live against the reference engine on the same numpy inputs: the 5 IO
  models x `POLICY_PRESETS`, window {1, 2, 4} x the four `OooSelect`
  values, a fault preset, and chunk {None, 128} — every metric agrees,
  and across chunk widths only `chunks_run` may differ;
* one small case against the reference's Pallas kernel, interpreted;
* ``SimOptions(device="cuda")`` with no card raises.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.smla import engine as ref_engine  # noqa: E402
from repro.core.smla import policies as ref_policies  # noqa: E402
from repro.core.smla import sweep as ref_sweep  # noqa: E402
from repro.core.smla.config import (ControllerPolicy, OooSelect,  # noqa: E402
                                    paper_configs)
from repro.core.smla.faults import DegradeMode, FaultConfig  # noqa: E402
from repro.core.smla.traces import WorkloadSpec  # noqa: E402
from repro_torch.core.smla import engine as port_engine  # noqa: E402
from test_golden import (FLOAT_METRICS, GOLDEN_PATH,  # noqa: E402
                         HORIZON as GOLDEN_HORIZON, INT_METRICS, _grid_cells)
from torch_parity import (diff_batches, diff_metrics, port_cell,  # noqa: E402
                          port_stack, run_port, run_ref, stacked_inputs)

HORIZON = 3_000
N_REQ = 60
SEED = 7
MIX = WorkloadSpec("mix.1", 18.0, 0.6, write_frac=0.2)


def _io_cells(n_req=N_REQ, spec=MIX, **over):
    cells = []
    for cname, sc in paper_configs(4).items():
        if over:
            sc = dataclasses.replace(sc, **over)
        cells.append(ref_sweep.make_cell(cname, sc, [spec, spec], n_req,
                                         seed=SEED))
    return cells


def test_golden_grid_plain_version():
    """The golden numbers through the port's engine, all 20 cells in one
    batch (the metrics do not depend on batching or chunking)."""
    golden = json.loads(GOLDEN_PATH.read_text())["cells"]
    cells = _grid_cells()
    got = run_port(cells, GOLDEN_HORIZON, chunk=1024)
    errors = []
    for i, c in enumerate(cells):
        g = golden[c.name]
        for k in INT_METRICS:
            if int(got[k][i]) != g[k]:
                errors.append(f"{c.name}:{k} got {int(got[k][i])} "
                              f"want {g[k]}")
        if got["served"][i].astype(int).tolist() != g["served"]:
            errors.append(f"{c.name}:served")
        for k in FLOAT_METRICS:
            if not np.isclose(float(got[k][i]), g[k], rtol=1e-6, atol=0.0):
                errors.append(f"{c.name}:{k} got {float(got[k][i])!r} "
                              f"want {g[k]!r}")
        if not np.allclose(got["ipc"][i], g["ipc"], rtol=1e-6, atol=0.0):
            errors.append(f"{c.name}:ipc")
    assert not errors, "port drifted from golden:\n" + "\n".join(errors)


def test_policy_presets_and_fault_match_reference():
    """5 IO models x every POLICY_PRESET, plus a fault preset on the
    degradable configs, in one mixed batch against the reference's
    batched engine with the same chunk width (chunks_run included)."""
    base = _io_cells()
    cells = ref_sweep.policy_cells(
        base, tuple(ref_policies.POLICY_PRESETS.values()))
    faulty = [c for c in _io_cells(t_refi_ns=1200.0)
              if c.name in ("cascaded_slr", "cascaded_mlr", "dedicated_slr")]
    cells += ref_sweep.fault_cells(
        faulty, (FaultConfig(dead_layers=(3,), degrade=DegradeMode.REMAP,
                             weak_ranks=(0,), retention_derate=4,
                             ecc_rate=0.2),))
    # a shallow queue (q_size=8) so drain-when-full bursts arm
    core = ref_engine.CoreParams(q_size=8)
    got = run_port(cells, HORIZON, chunk=512, core=core)
    want = run_ref(cells, HORIZON, chunk=512, core=core)
    errors = diff_batches(cells, got, want)
    assert not errors, "\n".join(errors)
    # the batch exercised what it claims to
    assert want["n_ecc_reread"].sum() > 0 and want["sr_cycles"].sum() > 0
    assert want["ref_postponed"].sum() > 0 and want["n_drain_bursts"].sum() > 0


@pytest.mark.parametrize("window", [1, 2, 4])
def test_window_and_ooo_select_match_reference(window):
    """Each tagged-window depth x the four OooSelect values x 5 IO models
    (a write-heavy mix so direction batching has turnarounds)."""
    spec = WorkloadSpec("ooo", 25.0, 0.6, write_frac=0.4)
    cells = []
    for ooo in OooSelect:
        pol = ControllerPolicy(ooo=ooo)
        for c in _io_cells(n_req=40, spec=spec):
            cells.append(dataclasses.replace(
                c, name=f"{c.name}|{pol.tag}",
                stack=dataclasses.replace(c.stack, policy=pol)))
    core = ref_engine.CoreParams(window=window)
    got = run_port(cells, 2_000, chunk=256, core=core)
    want = run_ref(cells, 2_000, chunk=256, core=core)
    errors = diff_batches(cells, got, want)
    assert not errors, "\n".join(errors)


def test_chunk_widths_move_only_chunks_run():
    """chunk=None (one full-horizon chunk) and chunk=128 agree on every
    metric but chunks_run; chunk=128 matches the reference, and so does
    the port's single-cell `simulate` entry point."""
    cells = _io_cells(n_req=24)
    h = 1_200
    full = run_port(cells, h, chunk=None)
    fine = run_port(cells, h, chunk=128)
    want = run_ref(cells, h, chunk=128)
    errors = diff_batches(cells, fine, full, skip=("chunks_run",))
    errors += diff_batches(cells, fine, want)
    assert not errors, "\n".join(errors)
    assert (full["chunks_run"] == 1).all()
    assert (fine["chunks_run"] < -(-h // 128)).any()   # early exit
    c = cells[-1]
    got = port_engine.simulate(
        port_stack(c.stack), c.traces,
        port_engine.SimOptions(horizon=h, chunk=128, device="cpu"))
    errors = diff_metrics(c.name, {k: v.numpy() for k, v in got.items()},
                          {k: v[-1] for k, v in want.items()})
    assert not errors, "\n".join(errors)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel path is legitimate")
    c = port_cell(_io_cells(n_req=8)[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_engine.simulate(c.stack, c.traces,
                             port_engine.SimOptions(horizon=100))


def test_options_validation_and_guards():
    with pytest.raises(ValueError):
        port_engine.SimOptions(horizon=0, device="cpu")
    with pytest.raises(ValueError):
        port_engine.SimOptions(horizon=10, chunk=0, device="cpu")
    with pytest.raises(ValueError):
        port_engine.SimOptions(horizon=10, device="tpu")
    with pytest.raises(TypeError):
        port_engine.simulate(None, {}, 100)
    c = port_cell(_io_cells(n_req=8)[0])
    out = port_engine.simulate(c.stack, c.traces, port_engine.SimOptions(
        horizon=500, device="cpu", validate=True))
    assert bool(out["complete"].all())
    with pytest.raises(ValueError, match="non-finite bandwidth_gbps"):
        bad = dict(out, bandwidth_gbps=torch.tensor(float("nan")))
        port_engine._validate_metrics(bad)
    assert port_engine.n_chunks(1000, 128) == 8
    assert port_engine.effective_chunk(100, None) == 100
    assert port_engine.effective_chunk(100, 1000) == 100


def test_matches_reference_pallas_kernel_interpreted():
    """One small case against the reference's Pallas kernel itself
    (interpreted on the CPU, as tests/test_backend_parity.py runs it)."""
    cells = _io_cells(n_req=12)[3:]
    params, traces = stacked_inputs(cells)
    want = ref_engine.batched_simulate(
        params, traces, ref_engine.SimOptions(horizon=600, chunk=128,
                                              backend="pallas",
                                              interpret=True),
        ref_engine.CoreParams(), 2)
    got = run_port(cells, 600, chunk=128)
    errors = diff_batches(cells, got, {k: np.asarray(v)
                                       for k, v in want.items()})
    assert not errors, "\n".join(errors)
