"""The port's streaming sweep pipeline against the reference's
(counterparts of tests/test_sweep_streaming.py, on the same cells, but
for its multi-device and ``cond_sharding`` cases, which have nothing to
map to on one card): streaming vs synchronous, the lazy journal-backed
`_CellStore`, the kernel's build directory (`SimOptions.
compile_cache_dir`, the port's compile cache), successive-halving
pruning with `pruned` and `prune_work` equal to the reference's, the
journal key's torch version, and the `on_bucket` progress hook.  The
card's dispatch (a launch per shape group) runs through the cycle
kernel's host build (`torch_parity.host_launch`)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.smla import analytic as ref_analytic  # noqa: E402
from repro.core.smla import engine as ref_engine  # noqa: E402
from repro.core.smla import sweep as ref_sweep  # noqa: E402
from repro.core.smla.config import ControllerPolicy  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch.core.smla import config as port_config  # noqa: E402
from repro_torch.core.smla import cuda_engine  # noqa: E402
from repro_torch.core.smla import engine as port_engine  # noqa: E402
from repro_torch.core.smla import sweep as port_sweep  # noqa: E402
from torch_parity import (HOST_FLAGS, HOST_SOURCES,  # noqa: E402
                          SWEEP_HORIZON, assert_same_buckets,
                          assert_same_cells, host_launch, host_library,
                          port_spec, stream_cells)


def _ref_spec(cells, horizon=SWEEP_HORIZON, **kw):
    return ref_sweep.SweepSpec(
        tuple(cells), options=ref_engine.SimOptions(horizon=horizon), **kw)


@pytest.fixture(scope="module")
def ref10():
    """The reference's sweep of the 10-cell grid."""
    return ref_sweep.run_sweep(_ref_spec(stream_cells()))


def _run(spec, path):
    """`run_sweep` on the CPU path, or the card's dispatch (a launch per
    shape group) with the host build standing in for the kernel."""
    if path == "cpu":
        return port_sweep.run_sweep(spec)
    return port_sweep._run(spec, host_launch(host_library()))


# ----------------------------------------------------------------------------
# streaming vs synchronous
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["cpu", "card"])
def test_streaming_bit_identical_to_sync(path, ref10):
    """The pipeline (producer thread, overlapped dispatch/harvest) equals
    the strict synchronous runner and the reference bit for bit —
    chunks_run and the per-bucket calibration metadata included."""
    cells = stream_cells()
    res_s = _run(port_spec(cells, streaming=True), path)
    res_y = _run(port_spec(cells, streaming=False), path)
    for res in (res_s, res_y):
        assert_same_cells(res, ref10)
        assert res.chunks == ref10.chunks
        assert_same_buckets(res, ref10)


@pytest.mark.parametrize("streaming", [True, False])
def test_streaming_launch_count_unchanged(streaming):
    """Pipelining adds no launch: on the card's dispatch one launch per
    shape group, each cell once with its bucket's width; the CPU path
    launches nothing and makes one plain call per bucket."""
    cells = stream_cells(n_cores=1, name="u") + stream_cells()
    launch = host_launch(host_library())
    calls = []

    def counted(*a, **kw):
        calls.append(list(kw["chunk"]))
        return launch(*a, **kw)
    spec = port_spec(cells, streaming=streaming)
    card = port_sweep._run(spec, counted)
    assert len(calls) == port_sweep.shape_groups(spec) == 2
    assert card.dispatches == 2 and card.failed_dispatches == 0
    assert sorted(w for c in calls for w in c) == sorted(card.chunks)
    before = cuda_engine.sim_cell_blocks.launches
    cpu = port_sweep.run_sweep(port_spec(cells[:4], streaming=streaming,
                                         max_buckets=2))
    assert cuda_engine.sim_cell_blocks.launches == before
    assert cpu.dispatches == len(cpu.buckets) == 2
    for name in cpu.names:
        for k, v in card[name].items():
            assert np.array_equal(cpu[name][k], v), (name, k)


def test_streaming_journal_matches_memory_and_resume(tmp_path, monkeypatch,
                                                     ref10):
    """Journal-backed streaming results (lazily rehydrated from the
    per-bucket .npz files) match the in-memory path bit for bit, and a
    resume off the journal re-executes nothing."""
    cells = stream_cells()
    jd = str(tmp_path / "journal")
    res1 = port_sweep.run_sweep(port_spec(cells, journal=jd))
    assert_same_cells(res1, ref10)

    def forbidden(*a, **kw):
        raise AssertionError("engine must not run on a full journal")
    monkeypatch.setattr(port_engine, "batched_simulate", forbidden)
    res2 = port_sweep.run_sweep(port_spec(cells, journal=jd))
    assert_same_cells(res2, res1)


@pytest.mark.parametrize("path", ["cpu", "card"])
def test_on_bucket_progress_callback(tmp_path, path):
    """on_bucket(done, total, wall_s, cells_per_s) fires once per
    finalized bucket — executed AND journal-loaded, on either path — with
    done counting 1..total in plan order and positive throughput (the
    card's dispatch over two shape groups)."""
    cells = stream_cells() if path == "cpu" else \
        stream_cells(n_cores=1, name="u") + stream_cells()
    calls = []

    def hook(done, total, wall_s, cells_per_s):
        calls.append((done, total, wall_s, cells_per_s))

    jd = str(tmp_path / "journal")
    res = _run(port_spec(cells, journal=jd, on_bucket=hook), path)
    total = len(res.buckets)
    assert [c[0] for c in calls] == list(range(1, total + 1))
    assert all(c[1] == total for c in calls)
    assert all(c[2] >= 0 and c[3] > 0 for c in calls)
    calls.clear()
    again = _run(port_spec(cells, journal=jd, on_bucket=hook), path)
    assert [c[0] for c in calls] == list(range(1, total + 1))
    assert again.dispatches == 0                 # cached buckets report too
    assert [b["cells"] for b in again.buckets] == \
        [b["cells"] for b in res.buckets]


# ----------------------------------------------------------------------------
# lazy _CellStore
# ----------------------------------------------------------------------------

def test_cellstore_lazy_journal_backed(tmp_path):
    """Journal-backed cells rehydrate from the per-bucket files: a full
    scalars() pass never holds more than the npz LRU's worth of buckets,
    and explicit indexing memoizes a stable, mutable dict."""
    cells = stream_cells()
    jd = str(tmp_path / "journal")
    res = _run(port_spec(cells, journal=jd), "card")
    store = res.cells
    assert isinstance(store, port_sweep._CellStore)
    tab = res.scalars()                          # peek path: no memoizing
    assert not store._cache
    assert len(store._npz) <= port_sweep._NPZ_LRU_BUCKETS
    assert tab["bandwidth_gbps"].shape == (len(cells),)
    d = store[0]
    assert store[0] is d
    d["wrapped"] = np.array([1.5])
    assert store.peek(0, "wrapped") == 1.5       # cache-first read-through
    assert store[-1] is store[len(cells) - 1]
    assert [id(x) for x in store[:2]] == [id(store[0]), id(store[1])]


def test_cellstore_survives_bucket_file_round_trip(tmp_path):
    """Values read back through the journal equal the reference's run
    exactly (npz round-trips the arrays bit for bit)."""
    cells = stream_cells()[:4]
    want = ref_sweep.run_sweep(_ref_spec(cells))
    jd = str(tmp_path / "journal")
    got = port_sweep.run_sweep(port_spec(cells, journal=jd))
    assert_same_cells(got, want)


# ----------------------------------------------------------------------------
# journal keying across torch builds and devices
# ----------------------------------------------------------------------------

def test_bucket_key_includes_torch_build(monkeypatch):
    opts = port_engine.SimOptions(horizon=SWEEP_HORIZON, device="cpu")
    base = port_sweep._bucket_key(0, ["a", "b"], 256, opts, 8, "cpu")
    assert base == port_sweep._bucket_key(0, ["a", "b"], 256, opts, 8,
                                          "cpu")
    assert base != port_sweep._bucket_key(0, ["a", "b"], 256, opts, 8,
                                          "cuda")
    monkeypatch.setattr(torch, "__version__", "999.99.9")
    assert port_sweep._bucket_key(0, ["a", "b"], 256, opts, 8,
                                  "cpu") != base


# ----------------------------------------------------------------------------
# the kernel's build directory (the port's persistent compile cache)
# ----------------------------------------------------------------------------

def test_compile_cache_dir_validation():
    with pytest.raises(ValueError, match="compile_cache_dir"):
        port_engine.SimOptions(horizon=SWEEP_HORIZON, compile_cache_dir=123)


def test_compile_library_builds_into_its_directory(tmp_path, monkeypatch):
    """`compile_library(..., build_dir=d)` writes the library into d and
    a second call finds it there without running the compiler."""
    host_library()                               # skips without g++
    out = _build.compile_library("g++", HOST_FLAGS, HOST_SOURCES,
                                 "smla_host", build_dir=str(tmp_path))
    assert out.parent == tmp_path and out.exists()
    assert cuda_engine.load_library(out).smla_cell_words

    def no_compiler(*a, **kw):
        raise AssertionError("the library is built: no compiler run")
    monkeypatch.setattr(_build.subprocess, "run", no_compiler)
    assert _build.compile_library("g++", HOST_FLAGS, HOST_SOURCES,
                                  "smla_host", build_dir=str(tmp_path)) == out


def test_build_once_per_directory(tmp_path, monkeypatch):
    """`cuda_engine.build` builds once per directory and process: the
    same directory twice is one build, a second directory another."""
    built = []

    def fake_compile(compiler, flags, sources, name, build_dir=None):
        built.append(build_dir)
        return build_dir
    monkeypatch.setattr(cuda_engine, "compile_library", fake_compile)
    monkeypatch.setattr(cuda_engine, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_engine, "load_library", lambda path: path)
    cuda_engine._build_in.cache_clear()
    try:
        a, b = str(tmp_path / "a"), str(tmp_path / "b")
        assert cuda_engine.build(a) == cuda_engine.build(a) == a
        assert cuda_engine.build(b) == b
        assert cuda_engine.build() == str(_build.BUILD_DIR)
        assert built == [a, b, str(_build.BUILD_DIR)]
    finally:
        cuda_engine._build_in.cache_clear()


def test_compile_cache_dir_reaches_the_launch(tmp_path):
    """`SimOptions.compile_cache_dir` is the directory the sweep's launch
    is told to build in; results do not depend on it."""
    launch = host_launch(host_library())
    dirs = []

    def recording(*a, **kw):
        dirs.append(kw["build_dir"])
        return launch(*a, **kw)
    cells = stream_cells()[:4]
    cache = str(tmp_path / "kernels")
    got = port_sweep._run(port_spec(cells, options=port_engine.SimOptions(
        horizon=SWEEP_HORIZON, device="cpu", compile_cache_dir=cache)),
        recording)
    assert dirs == [cache]
    assert_same_cells(got, port_sweep._run(port_spec(cells), launch))


# ----------------------------------------------------------------------------
# successive-halving pruning
# ----------------------------------------------------------------------------

def _assert_same_pruned(got, want):
    """`pruned`, `prune_work` and the survivors of two pruned sweeps."""
    assert got.pruned == want.pruned
    assert got.prune_work == want.prune_work
    assert_same_cells(got, want)


def test_prune_spec_validation():
    for bad in (dict(horizon_frac=0.0), dict(horizon_frac=1.0),
                dict(keep_frac=0.0), dict(keep_frac=1.0),
                dict(rounds=-1), dict(metric="ipc"),
                dict(metric="nonsense")):
        with pytest.raises(ValueError):
            port_sweep.PruneSpec(**bad)
    port_sweep.PruneSpec()                       # defaults are valid


@pytest.mark.parametrize("path", ["cpu", "card"])
def test_prune_promotes_true_top_cells(path, ref10):
    """The promoted survivors contain the exhaustive sweep's best cell,
    equal it bit for bit, and every cut cell is accounted in `pruned` —
    `pruned` and `prune_work` equal to the reference's."""
    cells = stream_cells()
    rtab = ref10.scalars(keys=("bandwidth_gbps",))
    true_best = rtab["name"][np.argsort(-rtab["bandwidth_gbps"],
                                        kind="stable")[0]]
    kw = dict(horizon_frac=0.25, keep_frac=0.5, rounds=1)
    want = ref_sweep.run_sweep(_ref_spec(cells,
                                         prune=ref_sweep.PruneSpec(**kw)))
    got = _run(port_spec(cells, prune=port_sweep.PruneSpec(**kw)), path)
    _assert_same_pruned(got, want)
    assert len(got.names) == 3 and true_best in got.names
    assert {p["name"] for p in got.pruned} \
        == set(rtab["name"]) - set(got.names)
    assert {p["round"] for p in got.pruned} == {0, 1}
    for name in got.names:                       # survivors = exhaustive
        for k, v in ref10[name].items():
            assert np.array_equal(got[name][k], np.asarray(v)), (name, k)
    w = got.prune_work
    assert w["n_cells"] == len(cells) and w["n_survivors"] == 3
    assert 0.0 < w["executed_cell_cycles"] < w["full_horizon_cell_cycles"]
    # the card's dispatch: one launch per sub-sweep (one shape group)
    if path == "card":
        assert got.dispatches == 2


def test_prune_minimize_metric(ref10):
    """maximize=False promotes the smallest values instead."""
    cells = stream_cells()
    kw = dict(horizon_frac=0.25, keep_frac=0.5, rounds=1,
              metric="makespan_ns", maximize=False)
    want = ref_sweep.run_sweep(_ref_spec(cells,
                                         prune=ref_sweep.PruneSpec(**kw)))
    got = port_sweep.run_sweep(port_spec(cells,
                                         prune=port_sweep.PruneSpec(**kw)))
    _assert_same_pruned(got, want)
    ref = ref10.scalars(keys=("makespan_ns",))
    best = ref["name"][np.argsort(ref["makespan_ns"], kind="stable")[0]]
    assert best in got.names


def test_prune_zero_rounds_is_seed_cut_only():
    cells = stream_cells()
    want = ref_sweep.run_sweep(_ref_spec(
        cells, prune=ref_sweep.PruneSpec(keep_frac=0.5, rounds=0)))
    got = port_sweep.run_sweep(port_spec(
        cells, prune=port_sweep.PruneSpec(keep_frac=0.5, rounds=0)))
    _assert_same_pruned(got, want)
    assert len(got.names) == 5                   # ceil(0.5 * 10)
    assert all(p["round"] == 0 for p in got.pruned)
    est = ref_analytic.estimates_for_cells(list(cells)) \
        * np.array([c.stack.unit_ns for c in cells])
    keep = sorted(np.argsort(est, kind="stable")[:5])
    assert got.names == [cells[i].name for i in keep]


def test_prune_halves_work_on_large_grid():
    """On a 1e4-cell grid successive halving executes less than half the
    full-horizon device work, with `pruned` and `prune_work` equal to
    the reference's.  The grid replicates a few base cells (shared trace
    arrays)."""
    base = stream_cells((2,))[:4]
    horizon = 512
    reps = 2_500                                 # 4 * 2500 = 10_000 cells
    cells = tuple(ref_sweep.SweepCell(f"{c.name}#r{i}", c.stack, c.traces)
                  for i in range(reps) for c in base)
    assert len(cells) >= 10_000
    kw = dict(horizon_frac=0.125, keep_frac=0.5, rounds=1)
    want = ref_sweep.run_sweep(_ref_spec(cells, horizon,
                                         prune=ref_sweep.PruneSpec(**kw)))
    got = port_sweep.run_sweep(port_spec(cells, horizon,
                                         prune=port_sweep.PruneSpec(**kw)))
    assert got.pruned == want.pruned and got.prune_work == want.prune_work
    assert got.names == want.names
    w = got.prune_work
    assert w["full_horizon_cell_cycles"] == len(cells) * horizon
    assert w["saved_frac"] >= 0.5, w
    assert len(got.names) == int(np.ceil(0.5 * np.ceil(0.5 * len(cells))))
    tab, ref_tab = got.scalars(), want.scalars()
    for k in port_sweep.SCALAR_METRICS:
        assert np.array_equal(tab[k], ref_tab[k]), k


def test_prune_with_policy_axis():
    """The policy axis expands before pruning, so cuts apply to the
    expanded cross-product."""
    cells = stream_cells()[:2]
    pols = tuple(ControllerPolicy.grid(
        scheduler=ControllerPolicy().scheduler, row=ControllerPolicy().row,
        refresh_gran=ControllerPolicy().refresh_gran)[:4])
    kw = dict(horizon_frac=0.25, keep_frac=0.5, rounds=1)
    want = ref_sweep.run_sweep(_ref_spec(cells, policies=pols,
                                         prune=ref_sweep.PruneSpec(**kw)))
    got = port_sweep.run_sweep(port_spec(cells, policies=pols,
                                         prune=port_sweep.PruneSpec(**kw)))
    _assert_same_pruned(got, want)
    n = len(cells) * len(pols)
    assert got.prune_work["n_cells"] == n
    assert len(got.names) + len(got.pruned) == n
    assert all("|" in name for name in got.names)


def test_policy_grid_enumeration():
    full = port_config.ControllerPolicy.grid()
    assert len(full) == 768 and len(set(full)) == 768
    assert port_config.ControllerPolicy() in full
    assert [p.tag for p in full] == [p.tag for p in ControllerPolicy.grid()]
    pinned = port_config.ControllerPolicy.grid(
        row=port_config.ControllerPolicy().row)
    assert len(pinned) == 384
    with pytest.raises(ValueError, match="unknown policy axes"):
        port_config.ControllerPolicy.grid(
            rows=port_config.ControllerPolicy().row)


def test_producer_stops_when_the_consumer_is_killed():
    """A KeyboardInterrupt in the launcher stops the producer thread (no
    thread left behind to block the interpreter)."""
    import threading
    launch = host_launch(host_library())
    calls = []

    def killed(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt("killed")
        return launch(*a, **kw)
    cells = stream_cells(n_cores=1, name="u") + stream_cells() + \
        stream_cells(n_cores=4, name="v")
    with pytest.raises(KeyboardInterrupt):
        port_sweep._run(port_spec(cells, prefetch=1), killed)
    assert not [t for t in threading.enumerate()
                if t.name == "smla-sweep-producer" and t.is_alive()]
