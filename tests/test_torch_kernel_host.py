"""The CUDA kernel's logic, run on the CPU: the same
``csrc/smla_cycle.cuh`` the kernel compiles, built with g++ around a
plain host loop (``csrc/smla_host.cpp``) and held against the plain
PyTorch version — integers exact, floats to rtol=1e-6 — on the golden
grid and on a policy-preset grid.  This build serves this test alone;
the package's entry points never load it.  Skips where g++ is missing."""
import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.smla import engine as ref_engine  # noqa: E402
from repro.core.smla import policies as ref_policies  # noqa: E402
from repro.core.smla import sweep as ref_sweep  # noqa: E402
from repro.core.smla.config import paper_configs  # noqa: E402
from repro.core.smla.traces import WorkloadSpec  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core.smla import cuda_engine, engine  # noqa: E402
from test_golden import HORIZON as GOLDEN_HORIZON, _grid_cells  # noqa: E402
from torch_parity import diff_batches, port_core, stacked_inputs  # noqa: E402

HOST_SOURCES = ("smla_cycle.cuh", "smla_host.cpp")
HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    path = cuda_engine.compile_library("g++", HOST_FLAGS, HOST_SOURCES,
                                       "smla_host")
    return cuda_engine.load_library(path)


def _host_run(lib, params, traces, horizon, core, banks, chunk):
    """The kernel wrapper's steps, with the host loop in place of the
    launch."""
    ctx = engine._prepare(params, traces, core, banks)
    p = cuda_engine.pack(ctx, horizon, chunk)
    cuda_engine.check_packed(p, torch.device("cpu"))
    bufs = cuda_engine.alloc_buffers(lib, p, "cpu")
    assert lib.smla_sim_host(*cuda_engine.pointer_args(p, bufs)) == 0
    return engine._metrics(params, ctx, cuda_engine.unpack(bufs), horizon)


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


def test_header_enums_match_wrapper():
    """The C enums and the wrapper's column tuples name the same fields in
    the same order."""
    src = (cuda_engine.CSRC / "smla_cycle.cuh").read_text()

    def enum(name, prefix):
        body = re.search(r"enum " + name + r" : int \{(.*?)\};", src,
                         re.S).group(1)
        names = [n.strip() for n in body.split(",") if n.strip()]
        assert names[-1] == prefix + "COUNT"
        return [n[len(prefix):].lower() for n in names[:-1]]

    assert enum("Ctx", "CX_") == [c.lower() for c in
                                  cuda_engine.CTX_COLUMNS]
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
    assert np.array_equal(
        cuda_engine.scratch_words(host_lib, p["dims"]),
        cuda_engine.scratch_words(host_lib, p["dims"].copy()))
