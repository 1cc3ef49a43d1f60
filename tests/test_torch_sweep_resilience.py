"""The port's crash-resilient sweep runner against the reference's
(counterparts of tests/test_sweep_resilience.py, on the same cells):
bucket isolation, transient retry, journal checkpoint/resume and spec
validation.  Wherever the reference yields a result, both packages run
and are held equal: names, every metric bit for bit, `failed_buckets`.

Failures are injected by monkeypatching each package's
`engine.batched_simulate` (the CPU path).  The card's dispatch — one
launch per shape group — is driven through the cycle kernel's host build
(`torch_parity.host_launch`) standing in for the kernel: a poisoned
group, a journal killed after the first group and resumed, a device
fault that surfaces at the harvest, and its journal against the CPU
path's.
"""
import os
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.smla import engine as ref_engine  # noqa: E402
from repro.core.smla import sweep as ref_sweep  # noqa: E402
from repro_torch.core.smla import engine as port_engine  # noqa: E402
from repro_torch.core.smla import sweep as port_sweep  # noqa: E402
from torch_parity import (SWEEP_HORIZON, assert_same_buckets,  # noqa: E402
                          assert_same_cells, host_launch, host_library,
                          port_spec, stream_cells)


def _ref_spec(cells, **kw):
    return ref_sweep.SweepSpec(
        tuple(cells), options=ref_engine.SimOptions(horizon=SWEEP_HORIZON),
        **kw)


@pytest.fixture(scope="module")
def ref10():
    """The reference's uninterrupted sweep of the 10-cell grid."""
    return ref_sweep.run_sweep(_ref_spec(stream_cells()))


def _two_groups():
    """20 cells in two shape groups (one core, then two)."""
    return _first_group() + stream_cells()


def _first_group():
    return stream_cells(n_cores=1, name="u")


@pytest.fixture(scope="module")
def ref20():
    return ref_sweep.run_sweep(_ref_spec(_two_groups()))


def _fail_on_call(real, n_fail, exc):
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == n_fail:
            raise exc
        return real(*a, **kw)
    return flaky, calls


def test_failing_bucket_is_isolated(monkeypatch, ref10):
    """One poisoned bucket lands in failed_buckets in both packages; the
    siblings equal the uninterrupted sweep, and scalars() stays
    well-formed."""
    cells = stream_cells()
    boom = ValueError("injected deterministic failure")
    flaky, _ = _fail_on_call(ref_engine.batched_simulate, 2, boom)
    monkeypatch.setattr(ref_engine, "batched_simulate", flaky)
    want = ref_sweep.run_sweep(_ref_spec(cells, on_error="record",
                                         retry_base_s=0.0))
    flaky, _ = _fail_on_call(port_engine.batched_simulate, 2, boom)
    monkeypatch.setattr(port_engine, "batched_simulate", flaky)
    got = port_sweep.run_sweep(port_spec(cells, on_error="record",
                                         retry_base_s=0.0))
    assert got.failed_buckets == want.failed_buckets
    fb = got.failed_buckets[0]
    assert len(got.failed_buckets) == 1 and fb["attempts"] == 1
    assert set(fb["cells"]) | set(got.names) == {c.name for c in cells}
    assert set(fb["cells"]).isdisjoint(got.names)
    assert_same_cells(got, want)
    for name, m in zip(got.names, got.cells):      # = uninterrupted run
        for k, v in ref10[name].items():
            assert np.array_equal(m[k], np.asarray(v)), f"{name}:{k}"
    assert len(got.scalars()["bandwidth_gbps"]) == len(got.names)
    assert (got.dispatches, got.failed_dispatches) == (len(got.buckets), 1)


def test_default_on_error_raises(monkeypatch):
    def boom(*a, **kw):
        raise ValueError("injected deterministic failure")
    monkeypatch.setattr(port_engine, "batched_simulate", boom)
    with pytest.raises(ValueError, match="injected"):
        port_sweep.run_sweep(port_spec(stream_cells()))


def test_transient_error_retried_until_success(monkeypatch):
    cells = stream_cells()[:2]
    want = ref_sweep.run_sweep(_ref_spec(cells))
    real = port_engine.batched_simulate
    calls = {"n": 0}

    def transient_twice(*a, **kw):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError(
                "RESOURCE_EXHAUSTED: out of memory allocating 1KiB")
        return real(*a, **kw)
    monkeypatch.setattr(port_engine, "batched_simulate", transient_twice)
    got = port_sweep.run_sweep(port_spec(cells, retry_base_s=0.0))
    assert not got.failed_buckets
    assert_same_cells(got, want)
    assert got.failed_dispatches == 2


def test_transient_retries_are_bounded(monkeypatch):
    calls = {"n": 0}

    def always_transient(*a, **kw):
        calls["n"] += 1
        raise RuntimeError("UNAVAILABLE: device lost")
    monkeypatch.setattr(port_engine, "batched_simulate", always_transient)
    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        port_sweep.run_sweep(port_spec(stream_cells()[:2], max_retries=2,
                                       retry_base_s=0.0, max_buckets=1))
    assert calls["n"] == 3                        # 1 try + 2 retries


@pytest.mark.parametrize("text", [
    "ValueError: shape mismatch",
    # CUDA's sticky errors: the context is unusable, a retry only fails
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure",
    "smla_sim_kernel launch failed: CUDA error 700",
])
def test_non_transient_error_not_retried(monkeypatch, text):
    calls = {"n": 0}

    def always_broken(*a, **kw):
        calls["n"] += 1
        raise RuntimeError(text)
    monkeypatch.setattr(port_engine, "batched_simulate", always_broken)
    with pytest.raises(RuntimeError):
        port_sweep.run_sweep(port_spec(stream_cells()[:2], max_retries=5,
                                       retry_base_s=0.0, max_buckets=1))
    assert calls["n"] == 1
    assert port_sweep._is_transient(RuntimeError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))


def test_journal_kill_and_resume_bit_identical(tmp_path, monkeypatch,
                                               ref10):
    """A sweep killed mid-run resumes from its journal: finished buckets
    load from disk (no engine calls), the rest execute, and the final
    result equals an uninterrupted sweep — the reference's."""
    cells = stream_cells()
    jd = str(tmp_path / "journal")
    real = port_engine.batched_simulate
    calls = {"n": 0}

    def die_after_two(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 2:
            raise KeyboardInterrupt("killed")
        return real(*a, **kw)
    monkeypatch.setattr(port_engine, "batched_simulate", die_after_two)
    with pytest.raises(KeyboardInterrupt):
        port_sweep.run_sweep(port_spec(cells, journal=jd))
    n_journaled = len(os.listdir(jd))
    assert n_journaled == 2

    calls2 = {"n": 0}

    def counting(*a, **kw):
        calls2["n"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(port_engine, "batched_simulate", counting)
    got = port_sweep.run_sweep(port_spec(cells, journal=jd))
    assert calls2["n"] == len(got.buckets) - n_journaled
    assert_same_cells(got, ref10)
    assert_same_buckets(got, ref10)


def test_fully_journaled_rerun_runs_nothing(tmp_path, monkeypatch, ref10):
    cells = stream_cells()
    jd = str(tmp_path / "journal")
    res1 = port_sweep.run_sweep(port_spec(cells, journal=jd))
    assert_same_cells(res1, ref10)

    def forbidden(*a, **kw):
        raise AssertionError("engine must not run on a full journal")
    monkeypatch.setattr(port_engine, "batched_simulate", forbidden)
    res2 = port_sweep.run_sweep(port_spec(cells, journal=jd))
    assert_same_cells(res2, res1)
    assert res2.buckets[0]["measured_max"] == res1.buckets[0]["measured_max"]
    assert res2.dispatches == 0


def test_journal_keys_invalidate_on_spec_change(tmp_path):
    """A different horizon must not reuse journal entries."""
    cells = stream_cells()[:2]
    jd = str(tmp_path / "journal")
    port_sweep.run_sweep(port_spec(cells, journal=jd))
    before = set(os.listdir(jd))
    port_sweep.run_sweep(port_spec(cells, SWEEP_HORIZON + 64, journal=jd))
    assert set(os.listdir(jd)) > before           # new keys, old kept


def test_validate_mode_sweep_bit_identical():
    cells = stream_cells()[:4]
    want = ref_sweep.run_sweep(_ref_spec(cells))
    got = port_sweep.run_sweep(port_spec(cells, options=port_engine.SimOptions(
        horizon=SWEEP_HORIZON, validate=True, device="cpu")))
    assert_same_cells(got, want)


def test_journal_save_atomic_under_concurrent_writers(tmp_path):
    """Racing writers on one journal key (two resumed sweeps sharing a
    journal) must each land a complete file: every interleaved load sees
    a full, valid npz (os.replace is atomic), and no tmp files leak."""
    jd = str(tmp_path / "journal")
    key = "deadbeef" * 5
    arrays = {f"m{i}": np.arange(1_000, dtype=np.int64) + i
              for i in range(4)}
    errors = []

    def writer():
        try:
            for _ in range(25):
                port_sweep._journal_save(jd, key, arrays)
                got = port_sweep._journal_load(jd, key)
                assert got is not None and set(got) == set(arrays)
                for k in arrays:
                    assert np.array_equal(got[k], arrays[k]), k
        except Exception as exc:     # surface in the main thread
            errors.append(exc)

    threads = [threading.Thread(target=writer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors, errors
    assert os.listdir(jd) == [key + ".npz"]       # no tmp leftovers


def test_sync_mode_journal_resume(tmp_path, monkeypatch, ref10):
    """The strict synchronous path (streaming=False) journals and
    resumes exactly like the pipeline."""
    cells = stream_cells()
    jd = str(tmp_path / "journal")
    res1 = port_sweep.run_sweep(port_spec(cells, streaming=False,
                                          journal=jd))
    assert_same_cells(res1, ref10)

    def forbidden(*a, **kw):
        raise AssertionError("engine must not run on a full journal")
    monkeypatch.setattr(port_engine, "batched_simulate", forbidden)
    res2 = port_sweep.run_sweep(port_spec(cells, streaming=False,
                                          journal=jd))
    assert_same_cells(res2, res1)


def test_spec_validation():
    cells = stream_cells()[:1]
    with pytest.raises(ValueError, match="cells"):
        port_sweep.SweepSpec((), port_engine.SimOptions(
            horizon=SWEEP_HORIZON, device="cpu"))
    with pytest.raises(ValueError, match="max_buckets"):
        port_spec(cells, max_buckets=0)
    with pytest.raises(ValueError, match="on_error"):
        port_spec(cells, on_error="ignore")
    with pytest.raises(ValueError, match="max_retries"):
        port_spec(cells, max_retries=-1)
    with pytest.raises(ValueError, match="retry_base_s"):
        port_spec(cells, retry_base_s=-0.5)
    with pytest.raises(ValueError, match="prefetch"):
        port_spec(cells, prefetch=0)
    with pytest.raises(TypeError, match="cond_sharding"):
        port_spec(cells, cond_sharding="sideways")   # multi-device: absent
    with pytest.raises(ValueError, match="prune"):
        port_spec(cells, prune="aggressive")
    with pytest.raises(ValueError, match="on_bucket"):
        port_spec(cells, on_bucket=42)


# ----------------------------------------------------------------------------
# the card's dispatch (a launch per shape group), through the host build
# ----------------------------------------------------------------------------

def _counted(launch, fail_on=None, exc=None):
    """`launch` counting its calls; call `fail_on` raises `exc` instead."""
    calls = []

    def run(*a, **kw):
        calls.append(kw["chunk"])
        if len(calls) == fail_on:
            raise exc
        return launch(*a, **kw)
    return run, calls


def _group_of(res, names):
    return [b["cells"] for b in res.buckets if b["cells"][0] in names]


def test_card_poisoned_group_is_recorded_whole(ref20):
    """A launch that fails takes its whole shape group: each of its
    buckets lands in failed_buckets (the reference's buckets of that
    group, cells and order), the other group equals the reference, and
    the plain version never answers for the failed launch."""
    launch, calls = _counted(host_launch(host_library()), fail_on=2,
                             exc=ValueError("injected launch failure"))
    got = port_sweep._run(port_spec(_two_groups(), on_error="record",
                                    retry_base_s=0.0), launch)
    assert len(calls) == 2
    second = {c.name for c in stream_cells()}
    assert [fb["cells"] for fb in got.failed_buckets] == \
        _group_of(ref20, second)
    assert all(fb["attempts"] == 1 and "injected launch failure"
               in fb["error"] for fb in got.failed_buckets)
    assert set(got.names) == {c.name for c in _first_group()}
    for name, m in zip(got.names, got.cells):
        for k, v in ref20[name].items():
            assert np.array_equal(m[k], np.asarray(v)), f"{name}:{k}"
    assert (got.dispatches, got.failed_dispatches) == (1, 1)


def test_card_journal_killed_after_first_group_resumes(tmp_path, ref20):
    """Killed at the second group's launch, the journal keeps the first
    group's buckets; the resumed run launches only the missing group and
    equals the uninterrupted reference bit for bit."""
    lib = host_library()
    jd = str(tmp_path / "journal")
    launch, _ = _counted(host_launch(lib), fail_on=2,
                         exc=KeyboardInterrupt("killed"))
    with pytest.raises(KeyboardInterrupt):
        port_sweep._run(port_spec(_two_groups(), journal=jd), launch)
    first = len(_group_of(ref20, {c.name for c in _first_group()}))
    assert len(os.listdir(jd)) == first
    launch, calls = _counted(host_launch(lib))
    got = port_sweep._run(port_spec(_two_groups(), journal=jd), launch)
    assert len(calls) == 1 and got.dispatches == 1
    assert_same_cells(got, ref20)
    assert_same_buckets(got, ref20)
    assert len(os.listdir(jd)) == len(ref20.buckets)


def test_card_fault_at_harvest_is_redispatched(ref20):
    """A transient device error that surfaces at the harvest (the
    device->host copy of an asynchronous launch) re-dispatches the unit
    under the retry budget left; the result equals the reference."""
    launch = host_launch(host_library())
    calls = []

    class Faulty:
        def cpu(self):
            raise RuntimeError("CUDA out of memory. Tried to allocate 1KiB")

    def faulty_once(*a, **kw):
        calls.append(1)
        out = launch(*a, **kw)
        return {k: Faulty() for k in out} if len(calls) == 1 else out
    got = port_sweep._run(port_spec(_two_groups(), retry_base_s=0.0),
                          faulty_once)
    assert len(calls) == 3                        # 2 groups + 1 redo
    assert (got.dispatches, got.failed_dispatches) == (2, 1)
    assert_same_cells(got, ref20)


def test_card_journal_misses_on_the_cpu_path(tmp_path, monkeypatch):
    """The device is in the journal key: a journal the card's dispatch
    wrote is not read back by the CPU path, which runs every bucket."""
    cells = stream_cells()
    jd = str(tmp_path / "journal")
    card = port_sweep._run(port_spec(cells, journal=jd),
                           host_launch(host_library()))
    written = set(os.listdir(jd))
    assert len(written) == len(card.buckets)
    real = port_engine.batched_simulate
    calls = {"n": 0}

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(port_engine, "batched_simulate", counting)
    cpu = port_sweep.run_sweep(port_spec(cells, journal=jd))
    assert calls["n"] == len(cpu.buckets)
    assert set(os.listdir(jd)) > written and \
        len(os.listdir(jd)) == 2 * len(written)
    assert_same_cells(cpu, card)
