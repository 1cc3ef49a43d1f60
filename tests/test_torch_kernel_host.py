"""The CUDA kernel's logic, run on the CPU: the same
``csrc/smla_cycle.cuh`` the kernel compiles, built with g++ around a
plain host loop (``csrc/smla_host.cpp``) whose warp is 32 lanes taken one
after another, and held against the plain PyTorch version — integers
exact, floats to rtol=1e-6 — on the golden grid, a policy-preset grid, a
two-core window-4 batch (two window slots per lane), the fault cells of
``benchmarks/paper_fig_fault.py`` and a batch whose cells carry different
chunk widths.  This build serves the tests alone; the package's entry
points never load it.  Skips where g++ is missing."""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks.paper_fig_fault import (CONFIG_NAMES, T_REFI_NS,  # noqa: E402
                                        _fault_grid)
from repro.core.smla import engine as ref_engine  # noqa: E402
from repro.core.smla import policies as ref_policies  # noqa: E402
from repro.core.smla import sweep as ref_sweep  # noqa: E402
from repro.core.smla.config import (ControllerPolicy, OooSelect,  # noqa: E402
                                    paper_configs)
from repro.core.smla.traces import WORKLOADS, WorkloadSpec  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch.core.smla import cuda_engine, engine  # noqa: E402
from test_golden import HORIZON as GOLDEN_HORIZON, _grid_cells  # noqa: E402
from torch_parity import (diff_batches, host_launch, host_library,  # noqa: E402
                          port_core, stacked_inputs)


@pytest.fixture(scope="module")
def host_lib():
    return host_library()


def _host_run(lib, params, traces, horizon, core, banks, chunk):
    """The kernel wrapper's steps, with the host loop in place of the
    launch."""
    return host_launch(lib)(params, traces, horizon=horizon, core=core,
                            banks=banks, chunk=chunk)


def _compare(lib, cells, horizon, chunk, core=None):
    params, traces = from_reference(*stacked_inputs(cells))
    args = (params, traces, horizon, port_core(core),
            cells[0].stack.banks_per_rank, chunk)
    got = _host_run(lib, *args)
    want = engine._sim_core(*args)
    errors = diff_batches(cells, {k: v.numpy() for k, v in got.items()},
                          {k: v.numpy() for k, v in want.items()})
    assert not errors, "\n".join(errors)


def test_host_build_matches_plain_golden_grid(host_lib):
    _compare(host_lib, _grid_cells(), GOLDEN_HORIZON, chunk=512)


def test_host_build_matches_plain_policy_grid(host_lib):
    w = WorkloadSpec("mix.1", 18.0, 0.6, write_frac=0.2)
    base = [ref_sweep.make_cell(n, sc, [w, w], 60, seed=7)
            for n, sc in paper_configs(4).items()]
    cells = ref_sweep.policy_cells(
        base, tuple(ref_policies.POLICY_PRESETS.values()))
    _compare(host_lib, cells, 3_000, chunk=256,
             core=ref_engine.CoreParams(q_size=8))


def test_host_build_matches_plain_window4_two_cores(host_lib):
    """Two cores x a window of 4 x 8 MSHRs: QT = 64 slots, two per lane,
    under each OooSelect (the out-of-order retire and bonus paths)."""
    w = WorkloadSpec("ooo", 25.0, 0.6, write_frac=0.4)
    base = [ref_sweep.make_cell(n, sc, [w, w], 60, seed=7)
            for n, sc in paper_configs(4).items()]
    cells = ref_sweep.policy_cells(
        base, tuple(ControllerPolicy(ooo=o) for o in OooSelect))
    core = ref_engine.CoreParams(window=4)
    assert cells[0].traces["inst"].shape[0] * engine.window_depth(
        port_core(core)) == 64
    _compare(host_lib, cells, 3_000, chunk=256, core=core)


def test_host_build_matches_plain_fault_cells(host_lib):
    """The fault axis of benchmarks/paper_fig_fault.py on its three IO
    models: dead layers under each degrade mode, weak retention, ECC."""
    w = WORKLOADS[26]
    base = [ref_sweep.make_cell(
        f"L4/{n}/{w.name}", dataclasses.replace(sc, t_refi_ns=T_REFI_NS),
        [w, w], 60, seed=3)
        for n, sc in paper_configs(4).items() if n in CONFIG_NAMES]
    cells = ref_sweep.fault_cells(base, _fault_grid())
    _compare(host_lib, cells, 3_000, chunk=256)


def test_host_build_mixed_chunk_widths(host_lib):
    """Cells of one batch with their own chunk widths (128/256/512, as
    the sweep's one launch per shape group gives them): every metric of
    every cell, `chunks_run` included, equals a launch at its own width
    and the plain version at that width."""
    cells = _grid_cells()[:6]
    widths = [128, 256, 512, 512, 256, 128]
    params, traces = from_reference(*stacked_inputs(cells))
    core, banks = engine.CoreParams(), cells[0].stack.banks_per_rank
    got = _host_run(host_lib, params, traces, GOLDEN_HORIZON, core, banks,
                    widths)
    runs = set()
    for width in sorted(set(widths)):
        rows = [i for i, x in enumerate(widths) if x == width]
        for want in (_host_run(host_lib, params, traces, GOLDEN_HORIZON,
                               core, banks, width),
                     engine._sim_core(params, traces, GOLDEN_HORIZON, core,
                                      banks, width)):
            errors = diff_batches([cells[i] for i in rows],
                                  {k: v[rows].numpy() for k, v in got.items()},
                                  {k: v[rows].numpy()
                                   for k, v in want.items()})
            assert not errors, "\n".join(errors)
        runs.add(tuple(got["chunks_run"][rows].tolist()))
    assert len(runs) > 1, "the widths must give different chunk counts"
    with pytest.raises(ValueError, match="chunk widths"):
        _host_run(host_lib, params, traces, GOLDEN_HORIZON, core, banks,
                  widths[:-1])


def test_header_enums_match_wrapper():
    """The C enums and the wrapper's column tuples name the same fields in
    the same order."""
    src = (_build.CSRC / "smla_cycle.cuh").read_text()

    def enum(name, prefix):
        body = re.search(r"enum " + name + r" : int \{(.*?)\};", src,
                         re.S).group(1)
        names = [n.strip() for n in body.split(",") if n.strip()]
        assert names[-1] == prefix + "COUNT"
        return [n[len(prefix):].lower() for n in names[:-1]]

    assert enum("Ctx", "CX_") == [c.lower() for c in
                                  cuda_engine.CTX_COLUMNS]
    # each cell's chunk width and count travel as its last two columns
    assert cuda_engine.CTX_COLUMNS[-2:] == ("chunk", "k_max")
    assert enum("RankRow", "RK_") == ["t_refi_eff", "dur", "group",
                                      "ref_next0"]
    assert len(cuda_engine.RANK_ROWS) == 4
    assert enum("Trace", "TR_") == list(cuda_engine.TRACE_FIELDS)
    assert enum("Out", "OUT_") == list(engine.SUMMARY_INT)
    assert enum("Dim", "D_") == [d.lower() for d in cuda_engine.DIM_FIELDS]


def test_wrapper_rejects_bad_inputs(host_lib):
    cells = _grid_cells()[:2]
    params, traces = from_reference(*stacked_inputs(cells))
    ctx = engine._prepare(params, traces, engine.CoreParams(), 2)
    p = cuda_engine.pack(ctx, 100, 32)
    with pytest.raises(ValueError, match="want"):
        cuda_engine.check_packed(dict(p, inst=p["inst"].double()),
                                 torch.device("cpu"))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_engine.check_packed(dict(p, tr=p["tr"].transpose(2, 3)),
                                 torch.device("cpu"))
    bad = p["ctx"].clone()
    bad[0, cuda_engine.CTX_COLUMNS.index("t_rcd")] = -1
    with pytest.raises(ValueError, match="negative"):
        cuda_engine.check_packed(dict(p, ctx=bad), torch.device("cpu"))
    bad = p["ctx"].clone()
    bad[1, cuda_engine.CTX_COLUMNS.index("chunk")] = 0
    with pytest.raises(ValueError, match="chunk"):
        cuda_engine.check_packed(dict(p, ctx=bad), torch.device("cpu"))
    dims = p["dims"].copy()
    dims[cuda_engine.DIM_FIELDS.index("horizon")] = cuda_engine.MAX_HORIZON
    with pytest.raises(ValueError, match="horizon"):
        cuda_engine.check_packed(dict(p, dims=dims), torch.device("cpu"))
    assert cuda_engine.cell_words(host_lib, p["dims"]) == \
        cuda_engine.cell_words(host_lib, p["dims"].copy()) > 0
