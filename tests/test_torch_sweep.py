"""The port's `run_sweep` (plain version on the CPU) against the reference
`run_sweep`: the same bucket plan, so `names`, `chunks` and every metric
of every cell must match — on the golden grid and on a small policy
grid.  The dispatch the card takes — one kernel launch per shape group,
each cell with its bucket's chunk width — is driven here with the cycle
kernel's host build as its launcher and held to the same."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.smla import engine as ref_engine  # noqa: E402
from repro.core.smla import policies as ref_policies  # noqa: E402
from repro.core.smla import sweep as ref_sweep  # noqa: E402
from repro.core.smla.config import paper_configs  # noqa: E402
from repro.core.smla.traces import WorkloadSpec  # noqa: E402
from repro_torch.core.smla import engine as port_engine  # noqa: E402
from repro_torch.core.smla import sweep as port_sweep  # noqa: E402
from test_golden import HORIZON as GOLDEN_HORIZON, _grid_cells  # noqa: E402
from torch_parity import (diff_metrics, host_launch,  # noqa: E402
                          host_library, port_cell, port_policy)


def _fused_sweep(spec, launch):
    """`run_sweep` as it runs on the card — one launch per shape group —
    with `launch` in place of the kernel."""
    cells = port_sweep._sweep_cells(spec)
    plan = port_sweep._plan(spec, cells)
    return port_sweep._assemble(spec, cells, plan,
                                port_sweep._run_groups(spec, plan, launch))


def _compare(ref_cells, horizon, max_buckets, policies=None, launch=None):
    ref = ref_sweep.run_sweep(ref_sweep.SweepSpec(
        tuple(ref_cells), options=ref_engine.SimOptions(horizon=horizon),
        max_buckets=max_buckets, policies=policies))
    spec = port_sweep.SweepSpec(
        tuple(port_cell(c) for c in ref_cells),
        port_engine.SimOptions(horizon=horizon, device="cpu"),
        max_buckets=max_buckets,
        policies=(None if policies is None
                  else tuple(port_policy(p) for p in policies)))
    got = (port_sweep.run_sweep(spec) if launch is None
           else _fused_sweep(spec, launch))
    assert got.names == ref.names
    assert got.chunks == ref.chunks
    assert got.device == "cpu"
    assert [b["cells"] for b in got.buckets] == \
        [b["cells"] for b in ref.buckets]
    for g, r in zip(got.buckets, ref.buckets):
        assert (g["chunk"], g["n_rows"], g["chunks_run"]) == \
            (r["chunk"], r["n_rows"], r["chunks_run"])
        np.testing.assert_allclose(g["measured_cycles"],
                                   r["measured_cycles"], rtol=1e-6)
    errors = []
    for name in ref.names:
        errors += diff_metrics(name, got[name],
                               {k: np.asarray(v) for k, v in ref[name].items()})
    assert not errors, "\n".join(errors)
    sg, sr = got.scalars(), ref.scalars()
    for k in port_sweep.SCALAR_METRICS:
        np.testing.assert_allclose(sg[k], sr[k], rtol=1e-6, atol=0)
    return got


def test_sweep_matches_reference_golden_grid():
    """Two makespan buckets (fast cells apart from the horizon-bound
    ones), auto chunk widths per bucket."""
    got = _compare(_grid_cells(), GOLDEN_HORIZON, max_buckets=2)
    assert len(got.buckets) == 2 and len(set(got.chunks)) >= 1
    with pytest.raises(ValueError, match="per-core"):
        got.scalars(keys=("ipc",))


def test_sweep_matches_reference_policy_grid():
    """A small policy axis through `SweepSpec.policies` (names gain the
    policy tag), padded buckets included."""
    pols = tuple(ref_policies.POLICY_PRESETS[k] for k in
                 ("default", "per_bank_refresh", "postpone_8x"))
    got = _compare(_policy_grid(), 2_000, max_buckets=4, policies=pols)
    assert len(got.names) == 15
    assert any(b["n_rows"] * len(got.buckets) > 15 for b in got.buckets), \
        "the plan must pad a short bucket"


def _policy_grid():
    w = WorkloadSpec("mix.1", 18.0, 0.6, write_frac=0.2)
    return [ref_sweep.make_cell(n, dataclasses.replace(sc, t_refi_ns=1500.0),
                                [w, w], 24, seed=7)
            for n, sc in paper_configs(4).items()]


@pytest.mark.parametrize("grid", ["golden", "policy"])
def test_fused_group_dispatch_matches_reference(grid):
    """One launch per shape group (the card's dispatch), through the host
    build of the kernel: `names`, `chunks`, the buckets' cells, chunk
    widths, rows and `chunks_run`, and every metric equal to the
    reference's bucketed run; and each shape group launched once."""
    launch = host_launch(host_library())
    calls = []

    def counted(*a, **kw):
        calls.append(kw["chunk"])
        return launch(*a, **kw)
    if grid == "golden":
        got = _compare(_grid_cells(), GOLDEN_HORIZON, max_buckets=2,
                       launch=counted)
    else:
        pols = tuple(ref_policies.POLICY_PRESETS[k] for k in
                     ("default", "per_bank_refresh", "postpone_8x"))
        got = _compare(_policy_grid(), 2_000, max_buckets=4, policies=pols,
                       launch=counted)
    assert len(calls) == 1 and len(got.buckets) > 1
    assert sorted(calls[0]) == sorted(got.chunks)   # pads left out


def test_grid_builders_and_spec_validation():
    from repro.core.smla.traces import WORKLOADS
    wl = [(w.name, [w], 0) for w in WORKLOADS[:2]]
    ref = ref_sweep.paper_grid(wl, layers=(2, 8), n_req=16)
    got = port_sweep.paper_grid(wl, layers=(2, 8), n_req=16)
    assert [c.name for c in got] == [c.name for c in ref]
    for g, r in zip(got, ref):
        for k in r.traces:
            np.testing.assert_array_equal(g.traces[k], r.traces[k])
    with pytest.raises(ValueError):
        port_sweep.SweepSpec((), port_engine.SimOptions(10, device="cpu"))
    with pytest.raises(ValueError):
        port_sweep.SweepSpec(tuple(got), port_engine.SimOptions(
            10, device="cpu"), max_buckets=0)
    assert port_sweep._auto_chunk(100.0) == 128
    assert port_sweep._auto_chunk(1e9) == 1024
