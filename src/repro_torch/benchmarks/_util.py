"""Shared helpers of the port's paper-output modules (port of
``benchmarks/_util.py``): smoke-mode scaling, per-bucket progress lines,
the timed sweep with its launch count, and machine-readable output.

Smoke mode (`SMLA_SMOKE=1`, set by ``run.py --smoke``) shrinks
horizons/trace lengths so every module runs in minutes on the plain
version; numbers are then structural, not paper-comparable.

Every paper figure merges its grid metrics into one JSON file, keyed by
figure name: ``BENCH_smla_sweep_torch.json`` by default (override with
`BENCH_JSON`), never the reference's ``BENCH_smla_sweep.json``, so a run
of the port cannot overwrite the reference's record.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

import numpy as np

from repro_torch.core.smla import cuda_engine, engine, sweep

BENCH_JSON_ENV = "BENCH_JSON"
BENCH_JSON_DEFAULT = "BENCH_smla_sweep_torch.json"


def smoke_mode() -> bool:
    return os.environ.get("SMLA_SMOKE", "") not in ("", "0")


def scaled(full: int, smoke: int) -> int:
    """`full` normally, `smoke` under SMLA_SMOKE=1."""
    return smoke if smoke_mode() else full


PROGRESS_ENV = "SMLA_PROGRESS"


def progress_printer(label: str, every: int = 1, force: bool = False):
    """An `on_bucket` callback for `SweepSpec` that prints per-bucket
    progress (`[label] bucket done/total wall cells/s`), so long sweeps
    launched through ``run.py`` are observable instead of silent for
    hours.  Enabled by ``run.py --progress`` (sets SMLA_PROGRESS=1) or
    `force=True`; returns None when disabled — `SweepSpec(on_bucket=None)`
    is the no-op default, so callers can pass the result through
    unconditionally."""
    if not force and os.environ.get(PROGRESS_ENV, "") in ("", "0"):
        return None

    def on_bucket(done: int, total: int, wall_s: float,
                  cells_per_s: float) -> None:
        if done % every and done != total:
            return
        print(f"[{label}] bucket {done}/{total}  {wall_s:7.1f}s  "
              f"{cells_per_s:8.1f} cells/s", flush=True)
    return on_bucket


def launches() -> int:
    """The cycle kernel's launches so far (`cuda_engine.sim_cell_blocks`;
    plain runs on the CPU are not counted)."""
    return cuda_engine.sim_cell_blocks.launches


def timed_sweep(label: str, spec: sweep.SweepSpec
                ) -> tuple[sweep.SweepResult, float, int]:
    """`run_sweep(spec)` with its host wall time and the kernel launches
    it made: (result, wall_s, launches).

    Which launches count: on a card, one per unit the sweep dispatched
    and kept (`SweepResult.dispatches`: a shape group with a bucket not
    yet journaled, per executed sub-sweep of a pruned run), and at most
    one more per failed dispatch (`failed_dispatches`: an attempt that
    was retried or recorded launched the kernel only if it failed after
    the launch).  Raises unless a card run's launches lie in that range
    and its units are no more than its shape groups per sub-sweep, or a
    CPU run launched the kernel at all."""
    l0, t0 = launches(), time.perf_counter()
    res = sweep.run_sweep(spec)
    wall = time.perf_counter() - t0
    n = launches() - l0
    lo = hi = 0
    if res.device == "cuda":
        lo, hi = res.dispatches, res.dispatches + res.failed_dispatches
        rounds = 1 + (spec.prune.rounds if spec.prune is not None else 0)
        if res.dispatches > sweep.shape_groups(spec) * rounds:
            raise RuntimeError(f"{label}: {res.dispatches} units for "
                               f"{sweep.shape_groups(spec)} shape groups "
                               f"x {rounds} sub-sweeps")
    if not lo <= n <= hi:
        raise RuntimeError(f"{label}: {n} kernel launches on {res.device} "
                           f"(want {lo}..{hi}: one per shape group with "
                           f"an unjournaled bucket on a card, plus the "
                           f"failed dispatches; none on the CPU)")
    return res, wall, n


def _jsonable(x: Any) -> Any:
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if hasattr(x, "tolist"):                      # numpy scalar / array
        return x.tolist()
    return x


def perf_block(wall_s: float, res, horizon: int) -> dict:
    """Machine-readable perf summary for one figure's sweep.

    res: a `SweepResult`.  Reports wall time, throughput (cells/s and
    simulated fast-cycles/s, where a cell's simulated cycles are the
    chunks it actually ran times its bucket's chunk width), how much of
    the horizon the early exit saved (`chunks_run_total` vs
    `chunks_possible`, both respecting per-bucket widths —
    `cell_n_chunks_max` is per cell), and the estimate calibration: per
    bucket, the analytic `estimate_service_cycles` upper bound next to
    the measured makespan."""
    chunks = np.array([int(np.asarray(c["chunks_run"])) for c in res.cells])
    widths = np.array([int(w) for w in res.chunks] if res.chunks
                      else [engine.effective_chunk(horizon, None)]
                      * len(chunks))
    n_max = np.array([engine.n_chunks(horizon, int(w)) for w in widths])
    sim_cycles = int(np.minimum(chunks * widths, horizon).sum())
    possible = int(n_max.sum())
    wall = max(wall_s, 1e-9)
    calibration = [
        {"chunk": m["chunk"], "n_cells": len(m["cells"]),
         "est_max": round(m["est_max"], 1),
         "measured_max": round(m["measured_max"], 1),
         "measured_over_est": round(
             m["measured_max"] / max(m["est_max"], 1e-9), 4)}
        for m in res.buckets]
    return {
        "wall_s": round(wall_s, 3),
        "cells_per_s": round(len(chunks) / wall, 3),
        "n_buckets": len(res.buckets),
        "buckets_per_s": round(len(res.buckets) / wall, 3),
        "sim_fast_cycles": sim_cycles,
        "sim_fast_cycles_per_s": round(sim_cycles / wall, 1),
        "horizon": horizon,
        "chunk_widths": sorted({int(w) for w in widths}),
        "cell_n_chunks_max": [int(x) for x in n_max],
        "chunks_run_total": int(chunks.sum()),
        "chunks_possible": possible,
        "early_exit_frac": round(1.0 - chunks.sum() / max(possible, 1), 4),
        "calibration": calibration,
    }


@dataclasses.dataclass
class FigureRecord:
    """One figure's benchmark emission as a typed record, carrying its
    provenance: `backend` is the device that produced the metrics
    (``SweepResult.device``: "cuda" runs the kernel, "cpu" the plain
    version), and `launches` the cycle kernel's launches the figure's
    sweep made (`cuda_engine.sim_cell_blocks.launches`, read around each
    `run_sweep`; 0 on the CPU) where the reference records its jit
    compiles.  `from_sweep` builds it from a live `SweepResult`;
    `from_json` rehydrates an emitted section so ``assert_early_exit``
    gates through the same accessors the emitters used."""
    figure: str
    backend: str
    horizon: int
    n_cells: int
    launches: int
    wall_s: float
    perf: dict
    chunk_widths: list
    cell_names: list | None = None
    scalars: dict | None = None
    #: figure-specific payload (rows, geomeans, workload mixes, ...)
    extra: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_sweep(cls, figure: str, res, wall_s: float, *, horizon: int,
                   launches: int, extra: dict | None = None,
                   include_scalars: bool = True) -> "FigureRecord":
        """res: a `sweep.SweepResult` (its `device` is recorded)."""
        perf = perf_block(wall_s, res, horizon)
        scal = None
        if include_scalars:
            scal = {k: v for k, v in res.scalars().items() if k != "name"}
        return cls(figure=figure, backend=res.device, horizon=horizon,
                   n_cells=len(res.names), launches=launches,
                   wall_s=round(wall_s, 3), perf=perf,
                   chunk_widths=perf["chunk_widths"],
                   cell_names=list(res.names), scalars=scal,
                   extra=dict(extra or {}))

    @classmethod
    def from_json(cls, figure: str, fig: dict | None) -> "FigureRecord":
        """Rehydrate an emitted section (raises ValueError when the
        section is missing its perf block — the gate's failure mode)."""
        if not fig or "perf" not in fig:
            raise ValueError(f"no {figure} perf section")
        return cls(figure=figure, backend=fig.get("backend", "cuda"),
                   horizon=int(fig.get("horizon", 0)),
                   n_cells=int(fig.get("n_cells", 0)),
                   launches=int(fig.get("launches", 0)),
                   wall_s=float(fig.get("wall_s", 0.0)), perf=fig["perf"],
                   chunk_widths=fig.get("chunk_widths",
                                        fig["perf"].get("chunk_widths", [])),
                   cell_names=fig.get("cell_names"),
                   scalars=fig.get("scalars"))

    def payload(self) -> dict:
        out = dict(self.extra)
        out.update(backend=self.backend, horizon=self.horizon,
                   n_cells=self.n_cells, launches=self.launches,
                   wall_s=self.wall_s, perf=self.perf,
                   chunk_widths=self.chunk_widths)
        if self.cell_names is not None:
            out["cell_names"] = self.cell_names
        if self.scalars is not None:
            out["scalars"] = self.scalars
        return out

    def emit(self, path: str | None = None,
             section: str | None = None) -> str:
        return emit_json(section or self.figure, self.payload(), path)

    def early_exit_cells(self) -> list[tuple[str, int, int]]:
        """Non-baseline cells that exited before the horizon:
        (name, chunks_run, chunks_max) triples.  Raises ValueError when
        the record lacks the needed fields (scalars/cell_names)."""
        if self.scalars is None or self.cell_names is None:
            raise ValueError(f"{self.figure}: record carries no "
                             f"scalars/cell_names")
        chunks = self.scalars["chunks_run"]
        n_max = self.perf["cell_n_chunks_max"]
        return [(n, int(c), int(m)) for n, c, m
                in zip(self.cell_names, chunks, n_max)
                if "/baseline/" not in n and int(c) < int(m)]


def emit_json(section: str, payload: dict, path: str | None = None) -> str:
    """Merge `payload` under `section` into the benchmark JSON file."""
    path = path or os.environ.get(BENCH_JSON_ENV, BENCH_JSON_DEFAULT)
    data = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
    data[section] = _jsonable(dict(payload, smoke=smoke_mode()))
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path


def main_args(doc: str, argv=None):
    """The figures' common command line: ``--smoke`` (same as
    SMLA_SMOKE=1) and ``--device`` (``cuda``, the default, runs the
    kernel; ``cpu`` the plain version)."""
    import argparse
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized grid (same as SMLA_SMOKE=1)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.smoke:
        os.environ["SMLA_SMOKE"] = "1"
    return args
