"""The port's `analytic.py` and `energy.py` against the reference:
service-time estimates, the derived horizon, Tables 1-2, the energy model
on real metrics, and `run_config` / `compare_configs` end to end (the
plain version on the CPU)."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.smla import analytic as ref_an  # noqa: E402
from repro.core.smla import energy as ref_en  # noqa: E402
from repro.core.smla import engine as ref_engine  # noqa: E402
from repro.core.smla import policies as ref_policies  # noqa: E402
from repro.core.smla import sweep as ref_sweep  # noqa: E402
from repro.core.smla.config import paper_configs  # noqa: E402
from repro.core.smla.faults import FaultConfig  # noqa: E402
from repro.core.smla.traces import WORKLOADS, WorkloadSpec  # noqa: E402
from repro_torch.core.smla import analytic as port_an  # noqa: E402
from repro_torch.core.smla import energy as port_en  # noqa: E402
from repro_torch.core.smla import engine as port_engine  # noqa: E402
from repro_torch.core.smla import traces as port_traces  # noqa: E402
from torch_parity import (port_cell, port_core, port_stack,  # noqa: E402
                          run_ref)


def _cells():
    cells = ref_sweep.paper_grid([(w.name, [w, w], 3) for w in WORKLOADS[::6]],
                                 layers=(2, 4, 8), n_req=32)
    cells = ref_sweep.policy_cells(
        cells, tuple(ref_policies.POLICY_PRESETS.values())[::3])
    return cells + ref_sweep.fault_cells(
        [c for c in cells if c.name.startswith("L4/cascaded")],
        (FaultConfig(dead_layers=(3,), ecc_rate=0.1),
         FaultConfig(weak_ranks=(1,), retention_derate=4)))


def test_estimates_and_default_horizon():
    cells = _cells()
    ported = [port_cell(c) for c in cells]
    for core in (ref_engine.CoreParams(),
                 ref_engine.CoreParams(q_size=4, window=2)):
        want = ref_an.estimates_for_cells(cells, core)
        got = port_an.estimates_for_cells(ported, port_core(core))
        np.testing.assert_array_equal(got, want)
        for c, p in zip(cells[:8], ported[:8]):
            assert port_an.estimate_service_cycles(
                p.stack, p.traces, port_core(core)) == \
                ref_an.estimate_service_cycles(c.stack, c.traces, core)
        assert port_an.default_horizon(ported, port_core(core)) == \
            ref_an.default_horizon(cells, core)


def test_tables():
    assert port_en.table1() == ref_en.table1()
    for layers in (2, 4, 8):
        assert port_an.table2(layers) == ref_an.table2(layers)


def test_energy_from_metrics_on_simulated_cells():
    cells = [c for c in _cells() if c.name.startswith("L4/")][:12]
    m = run_ref(cells, 6_000, chunk=1024)
    for i, c in enumerate(cells):
        row = {k: v[i] for k, v in m.items()}
        for kw in ({}, {"price_refresh": True}, {"n_wr": 3, "pd_frac": 0.1}):
            got = port_en.energy_from_metrics(port_stack(c.stack), row, **kw)
            want = ref_en.energy_from_metrics(c.stack, row, **kw)
            assert got.standby_nj == want.standby_nj
            assert got.ops_nj == want.ops_nj


def test_run_config_and_weighted_speedup():
    w = WorkloadSpec("mix.1", 18.0, 0.6, write_frac=0.2)
    sc = dataclasses.replace(paper_configs(4)["cascaded_slr"],
                             t_refi_ns=1200.0)
    kw = dict(n_req=40, seed=4)
    want = ref_an.run_config(sc, [w, w], options=ref_engine.SimOptions(
        horizon=2_000), **kw)
    got = port_an.run_config(port_stack(sc), [port_traces.WorkloadSpec(
        **w.__dict__)] * 2, options=port_engine.SimOptions(
            horizon=2_000, device="cpu"), **kw)
    np.testing.assert_allclose(got.ipc, want.ipc, rtol=1e-6, atol=0)
    for k in ("bandwidth", "energy_nj", "standby_nj", "ops_nj", "bus_util",
              "pd_frac"):
        assert np.isclose(getattr(got, k), getattr(want, k), rtol=1e-6,
                          atol=0), k
    assert (got.n_wr, got.refresh_cycles) == (want.n_wr, want.refresh_cycles)
    with pytest.raises(ValueError):
        port_an.run_config(port_stack(sc), [w], horizon=10,
                           options=port_engine.SimOptions(10, device="cpu"))
    base = port_an.RunResult("b", np.array([1.0, 2.0]), 1, 1, 1, 1, 0.5)
    fast = port_an.RunResult("f", np.array([2.0, 2.0]), 1, 1, 1, 1, 0.5)
    assert port_an.weighted_speedup(fast, base) == 1.5


def test_compare_configs():
    """All five paper configurations as one sweep, against the
    reference's."""
    w = WorkloadSpec("mix.1", 30.0, 0.6, write_frac=0.2)
    want = ref_an.compare_configs([w], layers=2, n_req=16, seed=2,
                                  options=ref_engine.SimOptions(horizon=800))
    got = port_an.compare_configs(
        [port_traces.WorkloadSpec(**w.__dict__)], layers=2, n_req=16,
        seed=2, options=port_engine.SimOptions(horizon=800, device="cpu"))
    assert list(got) == list(want)
    for name, r in want.items():
        g = got[name]
        assert g.name == r.name
        np.testing.assert_allclose(g.ipc, r.ipc, rtol=1e-6, atol=0)
        for k in ("bandwidth", "energy_nj", "bus_util", "pd_frac"):
            assert np.isclose(getattr(g, k), getattr(r, k), rtol=1e-6,
                              atol=0), (name, k)
        assert (g.n_wr, g.refresh_cycles) == (r.n_wr, r.refresh_cycles)
