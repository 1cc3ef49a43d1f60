"""Batched SMLA sweep engine (port of ``repro.core.smla.sweep``): the
paper's evaluation grid — workloads x 5 IO models x layer counts, and
beyond it the controller-policy and fault axes — as a handful of batched
runs of the cycle engine.

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
chunk widths — is the reference's, so ``names``, ``chunks`` and every
metric match it cell for cell.  On the CPU each bucket is one
`engine.batched_simulate` call of the plain version.  On a CUDA device
each shape group is one kernel launch, whatever its buckets: every cell
carries its bucket's chunk width into the kernel, the pad duplicates
stay out, and the outputs are split back per bucket in plan order (the
cells are independent, so each cell's metrics, ``chunks_run`` included,
are those of its bucket's own launch).

Not ported in this slice (the reference's ``sweep.py`` keeps them): the
journal and resume, retry and ``on_error``, the streaming producer thread,
the journal-backed lazy cell store, and successive-halving pruning.  The
multi-device paths (NamedSharding over the cell axis, the reduce-tree
cond) have nothing to map to on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

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

#: chunk widths ``chunk="auto"`` picks from, per bucket: the smallest
#: width >= est/AUTO_CHUNK_TARGET, so a bucket runs ~AUTO_CHUNK_TARGET
#: chunks to its estimated makespan (the estimate is a conservative upper
#: bound, measured makespans run ~0.6-0.7x of it).
CHUNK_LADDER = (128, 256, 512, 1024)
AUTO_CHUNK_TARGET = 32

#: chunk sentinel (the same value is valid in `SimOptions.chunk`)
AUTO = engine.AUTO


@dataclasses.dataclass(frozen=True)
class SweepCell:
    """One grid point: a stack configuration driving a set of core traces."""
    name: str
    stack: StackConfig
    traces: dict                       # {inst,rank,bank,row,wr}: (C, n_req)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A batch of grid cells sharing one execution surface and core model.

    `options` (`engine.SimOptions`) is the execution surface: horizon,
    chunk policy (``AUTO`` derives a width per bucket), validation and
    device.  `makespan_batching` orders compatible cells by their analytic
    service-time estimate and buckets them so fast cells are not barriered
    behind slow ones; `max_buckets` caps the buckets per shape group.
    `policies` is the controller-policy grid axis: when set, every cell is
    swept once per policy (cell names gain a ``|tag`` suffix)."""
    cells: tuple[SweepCell, ...]
    options: SimOptions
    core: CoreParams = CoreParams()
    makespan_batching: bool = True
    max_buckets: int = 8
    policies: tuple[ControllerPolicy, ...] | None = None

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


@dataclasses.dataclass
class SweepResult:
    names: list[str]
    #: per-cell metric dicts of numpy arrays
    cells: list[dict]
    #: per-cell effective chunk width actually used
    chunks: list[int] = dataclasses.field(default_factory=list)
    #: per-bucket calibration metadata: {"cells", "chunk", "est_cycles",
    #: "measured_cycles", "est_max", "measured_max", "n_rows",
    #: "chunks_run"} — analytic estimate vs measured makespan
    buckets: list[dict] = dataclasses.field(default_factory=list)
    #: the device that produced these metrics ("cuda" | "cpu")
    device: str = "cuda"

    def __getitem__(self, name: str) -> dict:
        return self.cells[self.names.index(name)]

    def scalars(self, keys: Sequence[str] = SCALAR_METRICS) -> dict:
        """Stacked (n_cells,) arrays of the scalar metrics + cell names;
        a per-core metric (e.g. ``ipc``) raises a ValueError."""
        out = {"name": np.array(self.names)}
        for k in keys:
            vals = []
            for name, cell in zip(self.names, self.cells):
                a = np.asarray(cell[k]).ravel()
                if a.size != 1:
                    raise ValueError(
                        f"scalars(): metric {k!r} is per-core (shape "
                        f"{np.asarray(cell[k]).shape} in cell {name!r}); "
                        f"use result[name][{k!r}] for per-core arrays")
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


def _plan_buckets(spec: SweepSpec, group: list[SweepCell]
                  ) -> tuple[list[list[int]], list[float]]:
    """Split one static-shape group into equal-size makespan buckets.

    Returns (buckets, est): each bucket is a list of positions into
    `group`, padded to a common size by repeating the bucket's own fastest
    member; `est` is the per-position analytic estimate."""
    from repro_torch.core.smla import analytic   # lazy: analytic imports us
    n = len(group)
    est = [float(e) for e in analytic.estimates_for_cells(group, spec.core)]
    single = (not spec.makespan_batching or spec.options.chunk is None
              or n <= 1)
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


@dataclasses.dataclass
class _Bucket:
    """One planned unit of execution: a padded slice of a shape group."""
    banks: int
    r_max: int
    n_req_max: int
    group: list                  # the shape group's SweepCells (shared)
    idxs: list                   # original cell index per group position
    positions: list              # group positions resident here (padded)
    est: list                    # per-group-position analytic estimate
    chunk: int | None


def _group_key(cell: SweepCell) -> tuple[int, int]:
    """The static shape a cell's group shares: (cores, banks per rank)."""
    return cell.traces["inst"].shape[0], cell.stack.banks_per_rank


def _plan(spec: SweepSpec, cells: list[SweepCell]) -> list[_Bucket]:
    """The bucket schedule: shape groups -> makespan buckets -> chunk
    widths, in the reference's deterministic order."""
    order: dict[tuple, list[int]] = {}
    for i, cell in enumerate(cells):
        order.setdefault(_group_key(cell), []).append(i)
    opts = spec.options
    plan = []
    for (_, banks), idxs in order.items():
        group = [cells[i] for i in idxs]
        r_max = max(c.stack.n_ranks for c in group)
        n_req_max = max(c.traces["inst"].shape[1] for c in group)
        buckets, est = _plan_buckets(spec, group)
        for bucket in buckets:
            chunk = (_auto_chunk(max(est[j] for j in bucket))
                     if opts.chunk == AUTO else opts.chunk)
            plan.append(_Bucket(banks=banks, r_max=r_max,
                                n_req_max=n_req_max, group=group, idxs=idxs,
                                positions=list(bucket), est=est,
                                chunk=chunk))
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


def _build_arrays(bkt: _Bucket) -> tuple[dict, dict]:
    """Pad and stack one bucket's params/traces to its shape group's."""
    return stack_cells([bkt.group[j] for j in bkt.positions], bkt.r_max,
                       bkt.n_req_max)


def _numpy(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


def _run_buckets(spec: SweepSpec, plan: list[_Bucket]) -> list[dict]:
    """One batched engine call per bucket: each bucket's outputs, a row
    per position of the bucket (pad duplicates included)."""
    opts = spec.options
    return [_numpy(engine.batched_simulate(*_build_arrays(bkt),
                                           opts.with_chunk(bkt.chunk),
                                           spec.core, bkt.banks))
            for bkt in plan]


def _run_groups(spec: SweepSpec, plan: list[_Bucket], launch) -> list[dict]:
    """One `launch` (`cuda_engine.sim_cell_blocks`'s signature) per shape
    group: the group's cells, each once, each with its bucket's chunk
    width; returns each bucket's outputs as `_run_buckets` does."""
    outs: list = [None] * len(plan)
    groups: dict[int, list[int]] = {}
    for b, bkt in enumerate(plan):
        groups.setdefault(id(bkt.group), []).append(b)
    for members in groups.values():
        first = plan[members[0]]
        row_of: dict[int, int] = {}
        widths = []
        for b in members:
            for j in plan[b].positions:
                if j not in row_of:
                    row_of[j] = len(row_of)
                    widths.append(plan[b].chunk)
        params, traces = stack_cells([first.group[j] for j in row_of],
                                     first.r_max, first.n_req_max)
        out = _numpy(engine.run_batch(launch, params, traces, spec.options,
                                      spec.core, first.banks, widths))
        for b in members:
            rows = [row_of[j] for j in plan[b].positions]
            outs[b] = {k: v[rows] for k, v in out.items()}
    return outs


def _sweep_cells(spec: SweepSpec) -> list[SweepCell]:
    return (list(spec.cells) if spec.policies is None
            else policy_cells(spec.cells, spec.policies))


def _assemble(spec: SweepSpec, cells: list[SweepCell], plan: list[_Bucket],
              outs: list[dict]) -> SweepResult:
    """The result from each bucket's outputs (rows in bucket order)."""
    opts = spec.options
    n = len(cells)
    per_cell: list = [None] * n
    chunks = [0] * n
    meta_all = []
    for bkt, out in zip(plan, outs):
        eff = engine.effective_chunk(opts.horizon, bkt.chunk)
        meta = {"cells": [], "chunk": eff, "est_cycles": [],
                "measured_cycles": [], "n_rows": len(bkt.positions),
                "chunks_run": int(np.max(out["chunks_run"]))}
        seen: set[int] = set()
        for row, j in enumerate(bkt.positions):
            if j in seen:
                continue                     # pad duplicate
            seen.add(j)
            i = bkt.idxs[j]
            per_cell[i] = {k: v[row] for k, v in out.items()}
            chunks[i] = eff
            meta["cells"].append(bkt.group[j].name)
            meta["est_cycles"].append(float(bkt.est[j]))
            meta["measured_cycles"].append(
                float(out["makespan_ns"][row])
                / float(bkt.group[j].stack.unit_ns))
        meta["est_max"] = max(meta["est_cycles"])
        meta["measured_max"] = max(meta["measured_cycles"])
        meta_all.append(meta)
    return SweepResult(names=[c.name for c in cells], cells=per_cell,
                       chunks=chunks, buckets=meta_all,
                       device=opts.torch_device().type)


def shape_groups(spec: SweepSpec) -> int:
    """The shape groups of `spec`'s cells (times its policies): the kernel
    launches `run_sweep` makes on a CUDA device."""
    return len({_group_key(c) for c in _sweep_cells(spec)})


def run_sweep(spec: SweepSpec) -> SweepResult:
    """Execute every cell (times every policy, when `spec.policies` is
    set) in makespan buckets: on the CPU one batched engine call per
    bucket, on a CUDA device one kernel launch per shape group.  Metrics
    are those of per-cell `engine.simulate` with the same chunk width;
    the chunk width moves only `chunks_run`."""
    cells = _sweep_cells(spec)
    plan = _plan(spec, cells)
    if spec.options.torch_device().type == "cuda":
        outs = _run_groups(spec, plan, cuda_engine.sim_cell_blocks)
    else:
        outs = _run_buckets(spec, plan)
    return _assemble(spec, cells, plan, outs)
