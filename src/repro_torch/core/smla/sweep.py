"""Batched SMLA sweep engine (port of ``repro.core.smla.sweep``): the
paper's evaluation grid — workloads x 5 IO models x layer counts, and
beyond it the controller-policy and fault axes — as a handful of batched
runs of the cycle engine, executed as a streaming pipeline.

Heterogeneous configs are padded to a common shape:
* rank axis   -> max rank count in the group (`StackConfig.to_params`);
  padded ranks/groups are provably never referenced,
* request axis-> max trace length (`traces.pad_traces`); the engine stops
  consuming at the cell's own `n_req`.
Cells are grouped by the remaining static quantities (core count,
banks-per-rank).  Policies and faults are data (per-cell selectors and
lowered layouts), so they never split a group.

Within a group, execution is makespan-aware: cells are ordered by the
analytic service-time estimate (`analytic.estimate_service_cycles`) and
split into equal-size buckets of similar expected makespan, short buckets
padded with duplicates of their own fastest cell.  With the default
``chunk="auto"`` each bucket derives its chunk width from its estimated
makespan (`CHUNK_LADDER`).  Chunk width never changes any metric except
the `chunks_run` diagnostic.  The plan — buckets, their order, their
chunk widths, their journal keys — is the reference's, so ``names``,
``chunks``, the bucket metadata and every metric match it cell for cell.

One executor (`_run_grid`) runs the plan, in one of two units.  On the
CPU the unit is a bucket: one `engine.batched_simulate` call of the plain
version each.  On a CUDA device the unit is a shape group: one kernel
launch for the group's buckets that are not yet journaled, every cell
once (pad duplicates stay out) with its own bucket's chunk width; the
outputs are split back per bucket.  Cells are independent, so a cell's
metrics, ``chunks_run`` included, do not depend on which cells share its
launch, and each bucket is journaled, finalized and reported in plan
order whatever its unit.

Execution is a **streaming pipeline** (``SweepSpec.streaming``, default
on): a producer thread probes the journal and pads/stacks the next units'
arrays (numpy only) while the device runs the current one, the dispatch
of unit k+1 is issued before unit k's device->host copy (the harvest),
and results accumulate incrementally — `SweepResult.cells` is a lazy view
over per-bucket storage (the journal's per-bucket ``.npz`` files when
journaling, in-memory arrays otherwise), so host memory for a
journal-backed sweep is O(bucket), not O(grid).  ``streaming=False`` runs
the identical plan strictly synchronously; both modes give the same
metrics.  A kernel launch and `engine._metrics` are asynchronous until the
harvest copies them, so a device fault surfaces there, where the unit is
re-dispatched under the retry budget left.  ``SimOptions.
compile_cache_dir`` is the directory the kernel library is built into, so
a process that finds it built skips ``nvcc``.

Grids too large to run exhaustively can be **pruned** with successive
halving (``SweepSpec.prune`` / `PruneSpec`): a free seed round ranks
every cell by the analytic estimate, measurement rounds run the
survivors at geometrically growing short horizons promoting the top
``keep_frac`` by the target metric, and only the final survivors pay the
full horizon.  A pruned sweep is NOT bit-identical to an exhaustive one
— cut cells are never fully simulated (they are listed with their cut
round and score in `SweepResult.pruned`, and the work saved is accounted
in `SweepResult.prune_work`).

Long grids run crash-resiliently: transient device errors are retried
with bounded exponential backoff, a unit that still fails can be
isolated into `SweepResult.failed_buckets` instead of aborting its
siblings (``on_error="record"``), and ``journal=`` checkpoints each
completed bucket to disk so a killed sweep resumes bit-identically
(see `SweepSpec`).  A failed launch is never answered by the plain
version, and a run on the card never moves to the CPU.

Not ported: the reference's multi-device paths (NamedSharding over the
cell axis, the reduce-tree cond, ``SweepSpec.cond_sharding``), which have
nothing to map to on one card.
"""
from __future__ import annotations

import collections
import collections.abc
import dataclasses
import functools
import hashlib
import json
import os
import queue
import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.smla import cuda_engine, engine
from repro_torch.core.smla.config import (ControllerPolicy, StackConfig,
                                          paper_configs)
from repro_torch.core.smla.engine import CoreParams, SimOptions
from repro_torch.core.smla.faults import FaultConfig
from repro_torch.core.smla.traces import (WorkloadSpec, core_traces,
                                          pad_traces, stack_traces)

#: metrics that are scalars per cell (the rest are per-core arrays)
SCALAR_METRICS = ("bandwidth_gbps", "n_act", "n_row_conflicts", "bus_util",
                  "horizon_ns", "makespan_ns", "n_wr", "bus_cycles",
                  "wr_bus_cycles", "refresh_cycles", "ref_rank_blocked_cycles",
                  "ref_postponed", "ref_pulled_in", "ref_debt_max",
                  "ref_debt_end", "pd_cycles", "pd_frac", "sr_cycles",
                  "sr_frac", "n_sr_exit", "n_drain_bursts", "n_grants",
                  "n_slot_grants", "n_enqueued", "n_outstanding",
                  "chunks_run", "n_ecc_reread", "degrade_sel",
                  "n_row_hit", "wtr_stall_cycles", "n_ooo_retire")

#: substrings (matched against ``f"{type(e).__name__}: {e}"``) that mark a
#: device/runtime error as *transient* — worth a bounded exponential-backoff
#: retry before the unit is declared failed; the reference's markers,
#: whose "out of memory" also matches PyTorch's ``CUDA out of memory``.
#: CUDA's sticky errors (an illegal address, an unspecified launch
#: failure, the kernel wrapper's numeric ``CUDA error {err}``) match none
#: of them on purpose: they leave the process's CUDA context unusable, so
#: a retry in the same process could only fail again.
_TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory", "OOM",
                      "UNAVAILABLE", "DEADLINE_EXCEEDED", "INTERNAL",
                      "DATA_LOSS", "ABORTED")


def _is_transient(exc: BaseException) -> bool:
    text = f"{type(exc).__name__}: {exc}"
    return any(m in text for m in _TRANSIENT_MARKERS)

#: chunk widths ``chunk="auto"`` picks from, per bucket: the smallest
#: width >= est/AUTO_CHUNK_TARGET, so a bucket runs ~AUTO_CHUNK_TARGET
#: chunks to its estimated makespan (the estimate is a conservative upper
#: bound, measured makespans run ~0.6-0.7x of it).
CHUNK_LADDER = (128, 256, 512, 1024)
AUTO_CHUNK_TARGET = 32

#: chunk sentinel (the same value is valid in `SimOptions.chunk`)
AUTO = engine.AUTO

#: journal .npz files a `_CellStore` keeps decompressed at once: bounds
#: rehydration memory at O(bucket) while keeping bucket-sequential access
#: (scalars(), zip over cells) at one file read per bucket.
_NPZ_LRU_BUCKETS = 2


@dataclasses.dataclass(frozen=True)
class SweepCell:
    """One grid point: a stack configuration driving a set of core traces."""
    name: str
    stack: StackConfig
    traces: dict                       # {inst,rank,bank,row,wr}: (C, n_req)


@dataclasses.dataclass(frozen=True)
class PruneSpec:
    """Successive-halving early pruning for grids too large to run
    exhaustively.

    Round 0 (``seed_from_estimate``, free): every cell is ranked by the
    analytic service-time estimate (`analytic.estimate_service_cycles`
    scaled to wall time by the cell's fast-clock period, so mixed layer
    counts compare fairly; a tested upper bound on the makespan — *lower
    is better* for throughput metrics) and only the top ``keep_frac``
    survive, without simulating anything.  Rounds 1..``rounds`` then run
    the survivors at geometrically growing short horizons (round r uses
    ``horizon * horizon_frac ** (rounds - r + 1)`` fast cycles), rank
    them by the *measured* ``metric`` and again promote the top
    ``keep_frac``.  The final survivors run at the full horizon and form
    the returned `SweepResult`; every cut cell is listed in
    `SweepResult.pruned` with its cut round and score.

    A pruned sweep is NOT bit-identical to an exhaustive one: cut cells
    are never fully simulated, and survivors' short-horizon rounds are
    extra (bit-identical-at-their-horizon) runs.  The *final* metrics of
    the surviving cells ARE bit-identical to the same cells in an
    exhaustive sweep — pruning decides *what* runs, never changes what a
    run computes.

    The analytic seed round ranks by estimated service time, which is a
    proxy for throughput-style metrics (shorter makespan = higher
    bandwidth over fixed work); disable ``seed_from_estimate`` when
    optimising a metric the estimate does not track (e.g. energy).
    """
    horizon_frac: float = 0.125
    keep_frac: float = 0.5
    rounds: int = 1
    metric: str = "bandwidth_gbps"
    maximize: bool = True
    seed_from_estimate: bool = True

    def __post_init__(self):
        if not 0.0 < self.horizon_frac < 1.0:
            raise ValueError(f"PruneSpec.horizon_frac must be in (0, 1), "
                             f"got {self.horizon_frac}")
        if not 0.0 < self.keep_frac < 1.0:
            raise ValueError(f"PruneSpec.keep_frac must be in (0, 1), "
                             f"got {self.keep_frac}")
        if self.rounds < 0:
            raise ValueError(f"PruneSpec.rounds must be >= 0, got "
                             f"{self.rounds}")
        if self.metric not in SCALAR_METRICS:
            raise ValueError(f"PruneSpec.metric {self.metric!r} is not a "
                             f"scalar metric (see SCALAR_METRICS)")


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A batch of grid cells sharing one execution surface and core model.

    `options` (`engine.SimOptions`) is the execution surface: horizon,
    chunk policy, validation, device and the kernel's build directory.
    With ``chunk=AUTO`` (the default) each makespan bucket derives its
    own width from the analytic estimate (`CHUNK_LADDER`); an int pins
    one width, None disables early exit (one full-horizon chunk).
    `makespan_batching` orders compatible cells by their analytic
    service-time estimate and buckets them so fast cells are not
    barriered behind slow ones; `max_buckets` caps how many buckets one
    shape group may use.  `policies` is the controller-policy grid axis:
    when set, every cell is swept once per policy (cell names gain a
    ``|tag`` suffix); the selectors are data, so the axis multiplies the
    grid without multiplying launches.

    Streaming execution:

    * `streaming` (default True) — run the pipeline: a producer thread
      prepares (journal-probes, pads, stacks) upcoming units while the
      device executes the current one, and unit k's device->host metric
      copies overlap unit k+1's execution.  Bit-identical to
      `streaming=False` (strict prepare/execute/harvest per unit) — the
      pipeline moves wall-clock, not numerics.
    * `prefetch` — how many prepared units the producer may hold ahead
      of the device (bounds host memory at O(prefetch * unit)).
    * `on_bucket` — progress callback ``on_bucket(done, total, wall_s,
      cells_per_s)`` invoked after every finalized bucket (including
      journal-loaded and failed ones), so long grids are observable.
    * `prune` — successive-halving early pruning (`PruneSpec`); the
      returned result covers only the promoted survivors.

    Resilience (for long overnight grids):

    * `max_retries` / `retry_base_s` — a unit whose execution dies with
      a *transient* device error (`_TRANSIENT_MARKERS`: out of memory,
      UNAVAILABLE, DEADLINE_EXCEEDED, ...) is retried up to
      `max_retries` times with exponential backoff (`retry_base_s *
      2**attempt` seconds).  Non-transient errors, CUDA's sticky ones
      among them, are never retried.
    * `on_error="record"` — a unit that still fails is *isolated*: each
      of its buckets lands in `SweepResult.failed_buckets` (tags + error
      text) and the sweep continues with the remaining units instead of
      aborting hours of siblings.  The default `"raise"` keeps the
      fail-fast behaviour.
    * `journal` — a directory path enabling checkpoint/resume: each
      completed bucket's metrics are written atomically to
      ``{journal}/{sha1(key)}.npz`` keyed by the bucket's full execution
      signature (cells, chunk, horizon, banks, validate, torch version,
      device type).  A re-run with the same spec and journal loads
      finished buckets from disk (bit-identical — npz round-trips the
      exact arrays) and only executes the missing ones, so a killed
      sweep resumes where it died.  Journal-backed results stay on disk:
      `SweepResult.cells` rehydrates lazily from the per-bucket files.

    The reference's legacy ``horizon``/``chunk`` fields (the port never
    had them) and its multi-device ``cond_sharding`` are not ported."""
    cells: tuple[SweepCell, ...]
    options: SimOptions
    core: CoreParams = CoreParams()
    makespan_batching: bool = True
    max_buckets: int = 8
    policies: tuple[ControllerPolicy, ...] | None = None
    journal: str | None = None
    max_retries: int = 2
    retry_base_s: float = 0.05
    on_error: str = "raise"
    streaming: bool = True
    prefetch: int = 2
    prune: PruneSpec | None = None
    on_bucket: Callable[[int, int, float, float], None] | None = None

    def __post_init__(self):
        if not self.cells:
            raise ValueError("SweepSpec.cells is empty — a sweep needs at "
                             "least one grid cell")
        if self.max_buckets < 1:
            raise ValueError(f"SweepSpec.max_buckets must be >= 1, got "
                             f"{self.max_buckets}")
        if not isinstance(self.options, SimOptions):
            raise ValueError(f"SweepSpec.options must be a SimOptions, got "
                             f"{type(self.options).__name__}")
        if self.on_error not in ("raise", "record"):
            raise ValueError(f"SweepSpec.on_error must be 'raise' or "
                             f"'record', got {self.on_error!r}")
        if self.max_retries < 0:
            raise ValueError(f"SweepSpec.max_retries must be >= 0, got "
                             f"{self.max_retries}")
        if self.retry_base_s < 0:
            raise ValueError(f"SweepSpec.retry_base_s must be >= 0, got "
                             f"{self.retry_base_s}")
        if self.prefetch < 1:
            raise ValueError(f"SweepSpec.prefetch must be >= 1, got "
                             f"{self.prefetch}")
        if self.prune is not None and not isinstance(self.prune, PruneSpec):
            raise ValueError(f"SweepSpec.prune must be a PruneSpec, got "
                             f"{type(self.prune).__name__}")
        if self.on_bucket is not None and not callable(self.on_bucket):
            raise ValueError("SweepSpec.on_bucket must be callable")


class _BucketData:
    """One finalized bucket's stacked metric arrays: held in memory for
    journal-less sweeps, re-read lazily from the journal's per-bucket
    ``.npz`` for journal-backed ones — the file is the unit of truth and
    host memory stays O(bucket), not O(grid)."""
    __slots__ = ("arrays", "path")

    def __init__(self, arrays: dict | None = None, path: str | None = None):
        self.arrays = arrays
        self.path = path

    def load(self, store: "_CellStore") -> dict:
        if self.arrays is not None:
            return self.arrays
        return store._load_npz(self.path)


class _CellStore(collections.abc.Sequence):
    """Lazy per-cell metric dicts over per-bucket storage.

    ``store[i]`` materializes (and memoizes) cell i's dict, so explicit
    access returns a stable, mutable dict exactly like an eager list of
    dicts.  `peek` reads a single metric through the bucket arrays
    *without* memoizing the cell — `SweepResult.scalars` uses it, so a
    full-grid scalar table over a journal-backed sweep never holds more
    than `_NPZ_LRU_BUCKETS` buckets in memory."""

    def __init__(self):
        self._refs: list[tuple[_BucketData, int]] = []
        self._cache: dict[int, dict] = {}
        self._npz: collections.OrderedDict[str, dict] = \
            collections.OrderedDict()

    def _append(self, ref: tuple[_BucketData, int]) -> None:
        self._refs.append(ref)

    def _load_npz(self, path: str) -> dict:
        got = self._npz.get(path)
        if got is None:
            with np.load(path) as z:
                got = {k: z[k] for k in z.files}
            self._npz[path] = got
            while len(self._npz) > _NPZ_LRU_BUCKETS:
                self._npz.popitem(last=False)
        else:
            self._npz.move_to_end(path)
        return got

    def __len__(self) -> int:
        return len(self._refs)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self._refs)
        got = self._cache.get(i)
        if got is None:
            data, row = self._refs[i]
            arrays = data.load(self)
            got = {k: np.asarray(v)[row] for k, v in arrays.items()}
            self._cache[i] = got
        return got

    def peek(self, i: int, key: str):
        """Cell i's metric `key` without materializing the cell dict."""
        got = self._cache.get(i)
        if got is not None:
            return got[key]
        data, row = self._refs[i]
        return np.asarray(data.load(self)[key])[row]


@dataclasses.dataclass
class SweepResult:
    names: list[str]
    #: per-cell metric dicts — a lazy `_CellStore` view over per-bucket
    #: storage (indexing/iterating materializes plain numpy dicts; the
    #: journal's .npz files back it when journaling is on)
    cells: Sequence
    #: per-cell effective chunk width actually used
    chunks: list[int] = dataclasses.field(default_factory=list)
    #: per-bucket calibration metadata: {"cells", "chunk", "est_cycles",
    #: "measured_cycles", "est_max", "measured_max", "n_rows",
    #: "chunks_run"} — analytic estimate vs measured makespan
    buckets: list[dict] = dataclasses.field(default_factory=list)
    #: the device that produced these metrics ("cuda" | "cpu")
    device: str = "cuda"
    #: buckets that failed after retries under ``on_error="record"``:
    #: {"cells": [tags], "error": "Type: text", "attempts": n}.  Failed
    #: cells are excluded from `names`/`cells`, so `scalars()` stays
    #: well-formed over the survivors.
    failed_buckets: list[dict] = dataclasses.field(default_factory=list)
    #: cells cut by successive halving (`SweepSpec.prune`): {"name",
    #: "round", "score", "metric"} — round 0 is the free analytic seed
    #: cut, rounds >= 1 are measured short-horizon cuts.
    pruned: list[dict] = dataclasses.field(default_factory=list)
    #: work accounting for a pruned sweep: executed cell-cycles (bucket
    #: rows x fast cycles actually issued, short rounds included) vs the
    #: full-horizon bound `n_cells * horizon`, and the saved fraction.
    prune_work: dict = dataclasses.field(default_factory=dict)
    #: engine calls whose outputs this sweep kept: one per unit with a
    #: bucket not yet journaled — a bucket on the CPU, a shape group (one
    #: kernel launch) on a card — summed over a pruned run's sub-sweeps
    dispatches: int = 0
    #: engine calls that raised or whose harvest raised (retried, or
    #: recorded in `failed_buckets`); on a card each may or may not have
    #: launched the kernel, as it failed after or before the launch
    failed_dispatches: int = 0

    def __getitem__(self, name: str) -> dict:
        return self.cells[self.names.index(name)]

    def scalars(self, keys: Sequence[str] = SCALAR_METRICS) -> dict:
        """Stacked (n_cells,) arrays of the scalar metrics + cell names;
        a per-core metric (e.g. ``ipc``) raises a ValueError."""
        out = {"name": np.array(self.names)}
        peek = getattr(self.cells, "peek", None)
        for k in keys:
            vals = []
            for i, name in enumerate(self.names):
                v = peek(i, k) if peek is not None else self.cells[i][k]
                a = np.asarray(v).ravel()
                if a.size != 1:
                    raise ValueError(
                        f"scalars(): metric {k!r} is per-core (shape "
                        f"{np.asarray(v).shape} in cell {name!r}); use "
                        f"result[name][{k!r}] for per-core arrays")
                vals.append(float(a[0]))
            out[k] = np.array(vals)
        return out


def make_cell(name: str, stack: StackConfig, specs: Sequence[WorkloadSpec],
              n_req: int, seed: int = 0) -> SweepCell:
    """Synthesise this cell's traces exactly as `analytic.run_config` does."""
    traces = core_traces(seed, list(specs), n_req, stack.n_ranks,
                         stack.banks_per_rank)
    return SweepCell(name, stack, traces)


def policy_cells(cells: Sequence[SweepCell],
                 policies: Sequence[ControllerPolicy]) -> list[SweepCell]:
    """Cross `cells` with controller policies: each cell is replicated
    once per policy (same traces) and renamed ``{name}|{policy.tag}``."""
    return [SweepCell(f"{c.name}|{pol.tag}",
                      dataclasses.replace(c.stack, policy=pol), c.traces)
            for pol in policies for c in cells]


def fault_cells(cells: Sequence[SweepCell],
                faults: Sequence[FaultConfig]) -> list[SweepCell]:
    """Cross `cells` with fault scenarios: each cell is replicated once
    per FaultConfig (same traces) and renamed ``{name}%{fault.tag}``."""
    return [SweepCell(f"{c.name}%{fc.tag}",
                      dataclasses.replace(c.stack, faults=fc), c.traces)
            for fc in faults for c in cells]


def paper_grid(workloads: Sequence[tuple[str, Sequence[WorkloadSpec], int]],
               layers: Sequence[int] = (4,), n_req: int = 500,
               config_names: Sequence[str] | None = None) -> list[SweepCell]:
    """The paper's evaluation grid: workloads x 5 IO models x layer counts.
    workloads: (name, specs, seed) triples.  Cell names are
    'L{layers}/{config}/{workload}'."""
    cells = []
    for L in layers:
        for cname, sc in paper_configs(L).items():
            if config_names is not None and cname not in config_names:
                continue
            for wname, specs, seed in workloads:
                cells.append(make_cell(f"L{L}/{cname}/{wname}", sc,
                                       specs, n_req, seed))
    return cells


def _auto_chunk(est_max: float) -> int:
    """The ladder width for a bucket whose slowest member is estimated at
    `est_max` fast cycles, clamped to engine.DEFAULT_CHUNK."""
    target = est_max / AUTO_CHUNK_TARGET
    for w in CHUNK_LADDER:
        if w >= target:
            return min(w, engine.DEFAULT_CHUNK)
    return min(CHUNK_LADDER[-1], engine.DEFAULT_CHUNK)


def _plan_buckets(spec: SweepSpec, opts: SimOptions, group: list[SweepCell]
                  ) -> tuple[list[list[int]], list[float]]:
    """Split one static-shape group into equal-size makespan buckets.

    Returns (buckets, est): each bucket is a list of positions into
    `group`, padded to a common size by repeating the bucket's own fastest
    member; `est` is the per-position analytic estimate."""
    from repro_torch.core.smla import analytic   # lazy: analytic imports us
    n = len(group)
    est = [float(e) for e in analytic.estimates_for_cells(group, spec.core)]
    single = not spec.makespan_batching or opts.chunk is None or n <= 1
    k = 1 if single else min(spec.max_buckets, n)
    size = -(-n // k)
    k = -(-n // size)
    order = sorted(range(n), key=lambda j: (est[j], j)) if k > 1 \
        else list(range(n))
    buckets = []
    for b in range(k):
        sl = order[b * size:(b + 1) * size]
        buckets.append(sl + [sl[0]] * (size - len(sl)))
    return buckets, est


def _bucket_key(ordinal: int, names: Sequence[str], chunk_b,
                opts: SimOptions, banks: int, device: str) -> str:
    """Stable journal key for one bucket: sha1 of its full execution
    signature.  Two runs of the same spec enumerate buckets identically,
    so the key round-trips; any change to the grid, chunking, horizon,
    validation mode, torch version or device type ("cuda": the kernel,
    "cpu": the plain version) changes the key and invalidates the journal
    entry rather than silently reusing stale metrics (npz arrays are
    exact, but another build or device may legitimately move float
    metrics — a journal written under one must not masquerade as the
    other's output)."""
    payload = json.dumps({"ordinal": ordinal, "cells": list(names),
                          "chunk": chunk_b, "horizon": opts.horizon,
                          "banks": banks, "validate": opts.validate,
                          "torch": torch.__version__,
                          "device": device}, sort_keys=True)
    return hashlib.sha1(payload.encode()).hexdigest()


def _journal_load(journal: str, key: str) -> dict | None:
    path = os.path.join(journal, key + ".npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _journal_save(journal: str, key: str, out: dict) -> None:
    """Atomic per-bucket checkpoint: write to a unique tmp file with an
    explicit ``.npz`` suffix (so np.savez never renames it underneath
    us), then ``os.replace`` into place — a sweep killed mid-write never
    leaves a truncated entry behind, and concurrent writers of the same
    key (two resumed sweeps racing on one journal) each land a complete
    file, last one wins."""
    os.makedirs(journal, exist_ok=True)
    path = os.path.join(journal, key + ".npz")
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}.npz"
    try:
        np.savez(tmp, **{k: np.asarray(v) for k, v in out.items()})
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _run_with_retry(fn, max_retries: int, base_s: float) -> tuple[dict, int]:
    """Call `fn` with bounded exponential-backoff retries on *transient*
    errors only.  Returns (result, attempts); re-raises the last error
    once retries are exhausted or immediately for non-transient ones."""
    attempt = 0
    while True:
        try:
            return fn(), attempt + 1
        except Exception as exc:
            attempt += 1
            if attempt > max_retries or not _is_transient(exc):
                raise
            time.sleep(base_s * (2 ** (attempt - 1)))


@dataclasses.dataclass
class _Bucket:
    """One planned bucket: a padded slice of a shape group."""
    ordinal: int                 # global plan order (journal keying)
    banks: int
    r_max: int
    n_req_max: int
    group: list                  # the shape group's SweepCells (shared)
    idxs: list                   # original cell index per group position
    positions: list              # group positions resident here (padded)
    est: list                    # per-group-position analytic estimate
    chunk: int | None
    jkey: str | None


def _group_key(cell: SweepCell) -> tuple[int, int]:
    """The static shape a cell's group shares: (cores, banks per rank)."""
    return cell.traces["inst"].shape[0], cell.stack.banks_per_rank


def _plan(spec: SweepSpec, opts: SimOptions, cells: list[SweepCell],
          device: str) -> list[_Bucket]:
    """The full bucket schedule, computed up front: shape groups ->
    makespan buckets -> chunk widths -> journal keys (for `device`).
    Enumeration order is deterministic, so journal keys round-trip."""
    order: dict[tuple, list[int]] = {}
    for i, cell in enumerate(cells):
        order.setdefault(_group_key(cell), []).append(i)
    plan = []
    for (_, banks), idxs in order.items():
        group = [cells[i] for i in idxs]
        r_max = max(c.stack.n_ranks for c in group)
        n_req_max = max(c.traces["inst"].shape[1] for c in group)
        buckets, est = _plan_buckets(spec, opts, group)
        for bucket in buckets:
            chunk = (_auto_chunk(max(est[j] for j in bucket))
                     if opts.chunk == AUTO else opts.chunk)
            ordinal = len(plan)
            jkey = (_bucket_key(ordinal, [group[j].name for j in bucket],
                                chunk, opts, banks, device)
                    if spec.journal is not None else None)
            plan.append(_Bucket(ordinal=ordinal, banks=banks, r_max=r_max,
                                n_req_max=n_req_max, group=group, idxs=idxs,
                                positions=list(bucket), est=est, chunk=chunk,
                                jkey=jkey))
    return plan


def stack_cells(cells: Sequence[SweepCell], r_max: int | None = None,
                n_req_max: int | None = None) -> tuple[dict, dict]:
    """Pad and stack cells' params/traces (numpy, host-side) as one batch:
    the rank axis to `r_max`, the request axis to `n_req_max` (default:
    the widest cell of the batch)."""
    r_max = r_max or max(c.stack.n_ranks for c in cells)
    n_req_max = n_req_max or max(c.traces["inst"].shape[1] for c in cells)
    plist = []
    for c in cells:
        p = c.stack.to_params(r_max)
        p["n_req"] = np.int32(c.traces["inst"].shape[1])
        plist.append(p)
    params = {k: np.stack([p[k] for p in plist]) for k in plist[0]}
    traces = stack_traces([pad_traces(c.traces, n_req_max) for c in cells])
    return params, traces


def _units(plan: list[_Bucket], per_group: bool) -> list[list[_Bucket]]:
    """The plan cut into units of execution, in plan order: a bucket
    each, or (`per_group`) the buckets of one shape group."""
    if not per_group:
        return [[bkt] for bkt in plan]
    units: dict[int, list[_Bucket]] = {}
    for bkt in plan:
        units.setdefault(id(bkt.group), []).append(bkt)
    return list(units.values())


@dataclasses.dataclass
class _Item:
    """One prepared unit: its buckets in plan order, each one's
    journal-loaded arrays (or None), and, when any bucket is not
    journaled, the stacked arrays of those buckets' cells (each once)."""
    buckets: list
    cached: list
    params: dict | None = None
    traces: dict | None = None
    chunk: object = None         # one width (a bucket) or one per row
    rows: list = dataclasses.field(default_factory=list)  # per bucket to run


def _prepare(unit: list[_Bucket], journal: str | None,
             per_cell: bool) -> _Item:
    """Probe the journal for each of the unit's buckets and pad/stack the
    cells of those it lacks (pure numpy, host-side — the work the
    producer thread overlaps with device compute).  The chunk is one
    width per row (`per_cell`, the kernel) or the one bucket's width."""
    cached = [_journal_load(journal, b.jkey) if b.jkey is not None else None
              for b in unit]
    todo = [b for b, c in zip(unit, cached) if c is None]
    if not todo:
        return _Item(unit, cached)
    row_of: dict[int, int] = {}
    widths = []
    for bkt in todo:
        for j in bkt.positions:
            if j not in row_of:
                row_of[j] = len(row_of)
                widths.append(bkt.chunk)
    first = todo[0]
    params, traces = stack_cells([first.group[j] for j in row_of],
                                 first.r_max, first.n_req_max)
    return _Item(unit, cached, params, traces,
                 widths if per_cell else first.chunk,
                 [[row_of[j] for j in b.positions] for b in todo])


def _inline_items(units: list, journal: str | None, per_cell: bool):
    """Synchronous prepare: each unit is padded on the main thread right
    before dispatch (the `streaming=False` path)."""
    for unit in units:
        yield _prepare(unit, journal, per_cell)


class _Producer:
    """Background prepare thread for the streaming pipeline: journal
    probes and array padding for upcoming units run while the device
    executes the current one.  It touches numpy only; tensors reach the
    device on the main thread.  Errors cross back to the consumer; `stop`
    unblocks and joins the thread (used on normal exit and on kill)."""

    def __init__(self, units: list, spec: SweepSpec, per_cell: bool):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, spec.prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._work, args=(list(units), spec.journal, per_cell),
            name="smla-sweep-producer", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _work(self, units: list, journal: str | None,
              per_cell: bool) -> None:
        try:
            for unit in units:
                if self._stop.is_set():
                    return
                if not self._put(("item", _prepare(unit, journal,
                                                   per_cell))):
                    return
            self._put(("done", None))
        except BaseException as exc:      # surface in the consumer thread
            self._put(("error", exc))

    def __iter__(self):
        while True:
            try:
                tag, payload = self._q.get(timeout=0.5)
            except queue.Empty:
                if not self._thread.is_alive():
                    raise RuntimeError(
                        "sweep producer thread died without reporting")
                continue
            if tag == "done":
                return
            if tag == "error":
                raise payload
            yield payload

    def stop(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


def _host(out: dict) -> dict:
    """The harvest: a unit's outputs copied to host numpy (where a device
    fault of an asynchronous launch surfaces)."""
    return {k: v.cpu().numpy() for k, v in out.items()}


def _run_grid(spec: SweepSpec, opts: SimOptions, cells: list[SweepCell],
              launch=None) -> SweepResult:
    """Execute an (already policy-expanded) cell list as the streaming
    pipeline.  `launch` is None on the CPU (a unit per bucket, through
    `engine.batched_simulate`, looked up at call time so tests can inject
    failures) or the card's kernel, `cuda_engine.sim_cell_blocks`, or a
    stand-in with its signature (a unit per shape group through
    `engine.run_batch`; its journal entries are keyed as the card's).
    See `run_sweep` for semantics."""
    per_group = launch is not None
    plan = _plan(spec, opts, cells, "cuda" if per_group else "cpu")
    units = _units(plan, per_group)
    n = len(cells)
    refs: list = [None] * n
    chunks: list[int] = [0] * n
    store = _CellStore()
    bucket_meta: list[dict] = []
    failed_buckets: list[dict] = []
    failed_pos: set[int] = set()
    t0 = time.time()
    progress = [0, 0]                       # buckets done, unique cells done
    calls = {"kept": 0, "failed": 0}
    #: FIFO of finalization work: ("dev", item, device outputs, attempts)
    #: awaiting the device->host copy, or ("cached", item) journal loads
    #: queued behind in-flight device work so bucket metadata keeps plan
    #: order.
    pending: collections.deque = collections.deque()

    def _mark_done(n_new_cells: int) -> None:
        progress[0] += 1
        progress[1] += n_new_cells
        if spec.on_bucket is not None:
            wall = max(time.time() - t0, 1e-9)
            spec.on_bucket(progress[0], len(plan), wall, progress[1] / wall)

    def _dispatch(item: _Item) -> dict:
        banks = item.buckets[0].banks
        try:
            if launch is None:
                # resolved at call time through the module so tests can
                # inject failures by monkeypatching engine.batched_simulate
                return engine.batched_simulate(
                    item.params, item.traces, opts.with_chunk(item.chunk),
                    spec.core, banks)
            return engine.run_batch(launch, item.params, item.traces, opts,
                                    spec.core, banks, item.chunk)
        except Exception:
            calls["failed"] += 1
            raise

    def _record_failure(bkt: _Bucket, exc: Exception) -> None:
        tags = list(dict.fromkeys(bkt.group[j].name for j in bkt.positions))
        failed_buckets.append({
            "cells": tags,
            "error": f"{type(exc).__name__}: {exc}",
            "attempts": (spec.max_retries + 1
                         if _is_transient(exc) else 1)})
        failed_pos.update(bkt.idxs[j] for j in bkt.positions)
        _mark_done(0)

    def _finalize(bkt: _Bucket, out_np: dict, save: bool) -> None:
        if save and bkt.jkey is not None:
            _journal_save(spec.journal, bkt.jkey, out_np)
        if bkt.jkey is not None:
            data = _BucketData(path=os.path.join(spec.journal,
                                                 bkt.jkey + ".npz"))
        else:
            data = _BucketData(arrays=out_np)
        eff = engine.effective_chunk(opts.horizon, bkt.chunk)
        # duplicate pad entries land on the same original index with
        # identical values — assigning them again is harmless.
        meta = {"cells": [], "chunk": eff, "est_cycles": [],
                "measured_cycles": [], "n_rows": len(bkt.positions),
                "chunks_run": int(np.max(np.asarray(out_np["chunks_run"])))}
        mk = np.asarray(out_np["makespan_ns"])
        seen: set[int] = set()
        for j_pos, j in enumerate(bkt.positions):
            refs[bkt.idxs[j]] = (data, j_pos)
            chunks[bkt.idxs[j]] = eff
            if j in seen:
                continue                     # pad duplicate
            seen.add(j)
            meta["cells"].append(bkt.group[j].name)
            meta["est_cycles"].append(float(bkt.est[j]))
            meta["measured_cycles"].append(
                float(mk[j_pos]) / float(bkt.group[j].stack.unit_ns))
        meta["est_max"] = max(meta["est_cycles"])
        meta["measured_max"] = max(meta["measured_cycles"])
        bucket_meta.append(meta)
        _mark_done(len(seen))

    def _settle(item: _Item, out_np: dict | None = None,
                exc: Exception | None = None) -> None:
        """Finalize the unit's buckets in plan order: journal-loaded ones
        from the journal, the others from `out_np` (their rows) or, with
        `exc`, as failed."""
        if out_np is not None:
            calls["kept"] += 1
        rows = iter(item.rows)
        for bkt, cached in zip(item.buckets, item.cached):
            if cached is not None:
                _finalize(bkt, cached, save=False)
            elif exc is not None:
                _record_failure(bkt, exc)
            else:
                sel = next(rows)
                _finalize(bkt, {k: v[sel] for k, v in out_np.items()},
                          save=True)

    def _harvest_head() -> None:
        entry = pending.popleft()
        if entry[0] == "cached":
            _settle(entry[1])
            return
        _, item, out, attempts = entry
        try:
            out_np = _host(out)
        except Exception as exc:
            # an asynchronously-dispatched device error surfaces at copy
            # time: re-run the unit synchronously under whatever retry
            # budget the dispatch left unused
            calls["failed"] += 1
            left = spec.max_retries - (attempts - 1)
            if not _is_transient(exc) or left <= 0:
                if spec.on_error != "record":
                    raise
                _settle(item, exc=exc)
                return

            def redo():
                out = _dispatch(item)
                try:
                    return _host(out)
                except Exception:
                    calls["failed"] += 1
                    raise
            try:
                out_np, _ = _run_with_retry(redo, left - 1,
                                            spec.retry_base_s)
            except Exception as exc2:
                if spec.on_error != "record":
                    raise
                _settle(item, exc=exc2)
                return
        _settle(item, out_np)

    def _n_dev_pending() -> int:
        return sum(1 for e in pending if e[0] == "dev")

    # streaming keeps one unit executing while the previous one's metrics
    # copy back (depth 2); sync mode harvests before dispatching the next
    # unit (depth 1).
    max_inflight = 2 if spec.streaming else 1
    src = (_Producer(units, spec, per_group) if spec.streaming
           else _inline_items(units, spec.journal, per_group))
    try:
        for item in src:
            if item.params is None:
                if pending:
                    pending.append(("cached", item))
                else:
                    _settle(item)
                continue
            while _n_dev_pending() >= max_inflight:
                _harvest_head()
            try:
                out, attempts = _run_with_retry(
                    functools.partial(_dispatch, item),
                    spec.max_retries, spec.retry_base_s)
            except Exception as exc:
                if spec.on_error != "record":
                    raise
                _settle(item, exc=exc)
                continue
            pending.append(("dev", item, out, attempts))
        while pending:
            _harvest_head()
    except BaseException:
        if isinstance(src, _Producer):
            src.stop()
        # drain already-dispatched units so a killed sweep's journal keeps
        # every finished bucket (best effort — the original error is what
        # propagates)
        try:
            while pending:
                _harvest_head()
        except BaseException:
            pass
        raise
    finally:
        if isinstance(src, _Producer):
            src.stop()

    keep = [i for i in range(n) if i not in failed_pos]
    for i in keep:
        store._append(refs[i])
    return SweepResult(names=[cells[i].name for i in keep],
                       cells=store, chunks=[chunks[i] for i in keep],
                       buckets=bucket_meta,
                       device=opts.torch_device().type,
                       failed_buckets=failed_buckets,
                       dispatches=calls["kept"],
                       failed_dispatches=calls["failed"])


def _measured_work(res: SweepResult) -> float:
    """Device work one sweep actually issued, in cell-cycles: padded
    bucket rows x chunks executed x chunk width, summed over buckets (the
    reference's accounting; the kernel runs each cell once, pads left
    out, so on a card this counts the rows of the plan, not of the
    launch)."""
    return float(sum(b["n_rows"] * b["chunks_run"] * b["chunk"]
                     for b in res.buckets))


def _run_pruned(spec: SweepSpec, opts: SimOptions, launch) -> SweepResult:
    """Successive halving (see `PruneSpec`): free analytic seed cut,
    short-horizon measurement rounds, full horizon only for the final
    survivors."""
    from repro_torch.core.smla import analytic   # lazy: analytic imports us
    pr = spec.prune
    cells = _sweep_cells(spec)
    n = len(cells)
    survivors = list(range(n))
    pruned: list[dict] = []
    executed = 0.0
    calls = [0, 0]

    def _keep_n(n_alive: int) -> int:
        return max(1, int(np.ceil(pr.keep_frac * n_alive)))

    if pr.seed_from_estimate and len(survivors) > 1:
        # rank by estimated service *time*, not raw fast cycles: cells
        # with different layer counts run different fast-clock periods,
        # so cross-config cycle counts are incomparable while ns are
        est = analytic.estimates_for_cells(cells, spec.core) \
            * np.array([c.stack.unit_ns for c in cells])
        ranked = sorted(survivors, key=lambda i: (est[i], i))
        kn = _keep_n(len(survivors))
        for i in ranked[kn:]:
            pruned.append({"name": cells[i].name, "round": 0,
                           "score": float(est[i]),
                           "metric": "estimate_service_ns"})
        survivors = sorted(ranked[:kn])

    def _subrun(idx_list: list[int], sub_opts: SimOptions) -> SweepResult:
        sub = dataclasses.replace(
            spec, cells=tuple(cells[i] for i in idx_list), options=sub_opts,
            policies=None, prune=None)
        res = _run_grid(sub, sub_opts, [cells[i] for i in idx_list], launch)
        calls[0] += res.dispatches
        calls[1] += res.failed_dispatches
        return res

    for r in range(1, pr.rounds + 1):
        if len(survivors) <= 1:
            break
        frac = pr.horizon_frac ** (pr.rounds - r + 1)
        h_r = max(1, int(round(opts.horizon * frac)))
        res_r = _subrun(survivors, dataclasses.replace(opts, horizon=h_r))
        executed += _measured_work(res_r)
        rows = res_r.scalars(keys=(pr.metric,))[pr.metric]
        # res_r preserves input order minus failed buckets: align by a
        # single forward walk (names may repeat; order disambiguates)
        scores: dict[int, float] = {}
        p = 0
        for i in survivors:
            if p < len(res_r.names) and res_r.names[p] == cells[i].name:
                scores[i] = float(rows[p])
                p += 1
        alive = [i for i in survivors if i in scores]
        for i in survivors:
            if i not in scores:   # failed bucket under on_error="record"
                pruned.append({"name": cells[i].name, "round": r,
                               "score": float("nan"), "metric": pr.metric})
        sgn = -1.0 if pr.maximize else 1.0
        ranked = sorted(alive, key=lambda i: (sgn * scores[i], i))
        kn = _keep_n(len(alive))
        for i in ranked[kn:]:
            pruned.append({"name": cells[i].name, "round": r,
                           "score": scores[i], "metric": pr.metric})
        survivors = sorted(ranked[:kn])

    res = _subrun(survivors, opts)
    executed += _measured_work(res)
    full = float(n) * float(opts.horizon)
    res.pruned = pruned
    res.prune_work = {
        "executed_cell_cycles": executed,
        "full_horizon_cell_cycles": full,
        "saved_frac": 1.0 - executed / full if full > 0 else 0.0,
        "n_cells": n, "n_survivors": len(survivors),
        "rounds_run": pr.rounds, "keep_frac": pr.keep_frac,
        "horizon_frac": pr.horizon_frac}
    res.dispatches, res.failed_dispatches = calls
    return res


def _sweep_cells(spec: SweepSpec) -> list[SweepCell]:
    return (list(spec.cells) if spec.policies is None
            else policy_cells(spec.cells, spec.policies))


def shape_groups(spec: SweepSpec) -> int:
    """The shape groups of `spec`'s cells (times its policies): the kernel
    launches an unjournaled, unpruned `run_sweep` makes on a CUDA
    device."""
    return len({_group_key(c) for c in _sweep_cells(spec)})


def _run(spec: SweepSpec, launch) -> SweepResult:
    """`run_sweep` with the launch given: None runs a unit per bucket
    through the plain version; the kernel (or a stand-in with its
    signature) a unit per shape group."""
    if spec.prune is not None:
        return _run_pruned(spec, spec.options, launch)
    return _run_grid(spec, spec.options, _sweep_cells(spec), launch)


def run_sweep(spec: SweepSpec) -> SweepResult:
    """Execute every cell (times every policy, when `spec.policies` is
    set) in makespan buckets — on the CPU one batched plain-version call
    per bucket, on a CUDA device one kernel launch per shape group — as a
    streaming pipeline (producer-thread prepare, overlapped
    dispatch/harvest) unless ``spec.streaming=False``.  Metrics are those
    of per-cell `engine.simulate` with the same chunk width; chunk width
    and streaming only move wall-clock and the `chunks_run` diagnostic.

    Resilience: transient device errors are retried with exponential
    backoff; under ``spec.on_error="record"`` a unit that still fails is
    recorded bucket by bucket in `SweepResult.failed_buckets` and its
    siblings keep running; with ``spec.journal`` set, each completed
    bucket checkpoints to disk and a re-run resumes bit-identically from
    the journal, launching only the units it lacks.

    With ``spec.prune`` set, successive halving runs instead (`PruneSpec`
    — the result covers the promoted survivors only and is NOT
    bit-identical to an exhaustive sweep)."""
    on_card = spec.options.torch_device().type == "cuda"
    return _run(spec, cuda_engine.sim_cell_blocks if on_card else None)
