"""Record the reference's own full-size run of the paper's outputs as the
golden file the port is held against (``paper_figs.json`` beside this
script).

    PYTHONPATH=.:src JAX_PLATFORMS=cpu \
        python tests/torch_golden/make_paper_figs.py [SECTION ...]

Each section is one module of ``benchmarks/``: Tables 1-2, Figs. 11-14,
fig_policy, fig_ooo, fig_refresh, fig_fault and fig_serve.  The script
calls the
module's own ``run()`` at its default (full) size, ``SMLA_SMOKE`` unset and
``BENCH_JSON`` pointed at a temporary file, and records every
``SweepResult`` by wrapping ``repro.core.smla.sweep.run_sweep`` for the
duration of the call, so no grid is written twice.  Per sweep it keeps
the horizon, n_req, the window depth, the cell names, their chunk
widths and per cell the scalar metrics of ``sweep.SCALAR_METRICS`` (ints
as ints), ``served`` and ``ipc`` per core; per module the printed rows
and the ``extra`` payload of its JSON record (rows, geomeans, mixes).
Floats are stored unrounded (JSON's ``repr``-exact numbers).

fig_serve's capture serves a reduced model whose params and prompt
batch the reference draws from JAX keys, the batch's folded with a
string hash that Python randomises per process, so no other process can
draw them again.  ``repro.serve.bridge.capture_generate`` is wrapped for
the call, and the arrays it was given and the tokens it generated go to
`CAPTURE` beside the golden file (`capture_arrays` reads them back):
``params/<dotted path>`` float32, ``tokens`` and ``generated`` int32.

Fig. 11's second pass asks for ``backend="pallas"`` in interpret mode,
which off-TPU is far too slow at full size: the wrapper answers that
spec with the scan backend on the same cells (the reference asserts the
two agree) and does not record it, so the golden holds the scan pass
only.

fig_scale is a timing figure whose sweeps run in child processes, so its
section is built here instead (`make_fig_scale`): for each of the
module's full sizes the reference's per-cell ``bandwidth_gbps`` and its
checksum from one ``streaming=False`` sweep of the child's grid, and for
its prune child the promoted cells and ``prune_work``.  No timings.

Regenerate only when the reference changes (it is frozen while the port
is built); naming sections rewrites only those.  Not collected by
pytest: ``tests/test_torch_paper_golden.py`` calls `make_section` to show
the file is fresh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
GOLDEN = pathlib.Path(__file__).resolve().parent / "paper_figs.json"
#: fig_serve's capture inputs and output, as the reference's run drew them
CAPTURE = GOLDEN.with_name("fig_serve_capture.npz")

#: section -> the reference module that produces it
SECTIONS = {
    "table1": "benchmarks.paper_table1",
    "table2": "benchmarks.paper_table2",
    "fig11": "benchmarks.paper_fig11",
    "fig12": "benchmarks.paper_fig12",
    "fig13": "benchmarks.paper_fig13",
    "fig14": "benchmarks.paper_fig14",
    "fig_policy": "benchmarks.paper_fig_policy",
    "fig_ooo": "benchmarks.paper_fig_ooo",
    "fig_refresh": "benchmarks.paper_fig_refresh",
    "fig_fault": "benchmarks.paper_fig_fault",
    "fig_serve": "benchmarks.paper_fig_serve",
    "fig_scale": "benchmarks.paper_fig_scale",
}

#: fig_scale's grids, as the reference's child processes build them
#: (``benchmarks/paper_fig_scale.py``'s ``_CHILD`` and ``_PRUNE_CHILD``)
#: at its full size
SCALE = {"n_req": 120, "horizon": 6_000, "layers": [2, 4],
         "workload": ["stream.t", 50.0, 0.85, 1 / 3],
         "prune": {"n_cells": 20_000, "n_req": 10, "horizon": 1_024,
                   "horizon_frac": 0.125, "keep_frac": 0.5, "rounds": 1}}

#: keys of an emitted BENCH section that are not the figure's ``extra``
RECORD_KEYS = ("backend", "horizon", "n_cells", "compiles", "launches",
               "wall_s", "perf", "chunk_widths", "cell_names", "scalars",
               "smoke")


def _value(a):
    """A metric as JSON: ints as ints, floats as floats, arrays as lists."""
    a = np.asarray(a)
    if a.ndim:
        return [_value(x) for x in a]
    if a.dtype.kind in "biu":
        return int(a)
    return float(a)


def sweep_record(spec, res, scalar_metrics) -> dict:
    """One SweepResult as the golden stores it."""
    return {
        "horizon": int(spec.options.horizon),
        "n_req": max(int(c.traces["inst"].shape[1]) for c in spec.cells),
        "window": int(spec.core.window),
        "names": list(res.names),
        "chunks": [int(c) for c in res.chunks],
        "cells": {name: {**{k: _value(res[name][k]) for k in scalar_metrics},
                         "served": _value(res[name]["served"]),
                         "ipc": _value(res[name]["ipc"])}
                  for name in res.names},
    }


@contextlib.contextmanager
def recording(sweep_mod, sweeps: list, substitute_pallas: bool = False):
    """Wrap ``sweep_mod.run_sweep`` so every call's (spec, result) is
    appended to `sweeps`; with `substitute_pallas`, a ``backend="pallas"``
    spec runs on the scan backend and is not recorded."""
    orig = sweep_mod.run_sweep

    def run_sweep(spec):
        if substitute_pallas and spec.options.backend == "pallas":
            opts = dataclasses.replace(spec.options, backend="scan",
                                       interpret=False)
            res = orig(dataclasses.replace(spec, options=opts))
            return dataclasses.replace(res, backend="pallas")
        res = orig(spec)
        sweeps.append(sweep_record(spec, res, sweep_mod.SCALAR_METRICS))
        return res

    sweep_mod.run_sweep = run_sweep
    try:
        yield
    finally:
        sweep_mod.run_sweep = orig


@contextlib.contextmanager
def capture_recording(arrays: dict):
    """Wrap the reference's ``bridge.capture_generate`` so that its
    engine's params, its batch's tokens and the generated tokens land in
    `arrays` as numpy."""
    from repro.models import common as ref_common
    from repro.serve import bridge
    orig = bridge.capture_generate

    def capture_generate(eng, batch, max_new_tokens):
        out, cap = orig(eng, batch, max_new_tokens)
        arrays.update({f"params/{k}": np.asarray(v, np.float32) for k, v in
                       ref_common.flatten_paths(eng.params).items()})
        arrays["tokens"] = np.asarray(batch["tokens"], np.int32)
        arrays["generated"] = np.asarray(out, np.int32)
        return out, cap

    bridge.capture_generate = capture_generate
    try:
        yield
    finally:
        bridge.capture_generate = orig


def capture_arrays() -> tuple[dict, dict, np.ndarray]:
    """fig_serve's recorded capture: (flat params {dotted path: float32},
    batch {"tokens": int32}, generated int32)."""
    with np.load(CAPTURE) as z:
        params = {k[len("params/"):]: z[k] for k in z.files
                  if k.startswith("params/")}
        return params, {"tokens": z["tokens"]}, z["generated"]


def extra_of(section: dict) -> dict:
    return {k: v for k, v in section.items() if k not in RECORD_KEYS}


def make_fig_scale() -> dict:
    """fig_scale's section: per full size the reference's sweep of the
    child's grid with ``streaming=False`` (names, per-cell bandwidth,
    checksum, buckets), and its prune child's promoted cells and
    ``prune_work``."""
    import repro.launch.compat  # noqa: F401  (jax API shims)
    from benchmarks import paper_fig_scale
    from repro.core.smla import sweep
    from repro.core.smla.engine import SimOptions
    from repro.core.smla.traces import WorkloadSpec
    name, mpki, row_hit, wr = SCALE["workload"]
    stream = WorkloadSpec(name, mpki, row_hit, write_frac=wr)
    sizes = {}
    for k in paper_fig_scale.SIZES_FULL:
        cells = sweep.paper_grid(
            [(f"w{s}", [stream, stream], s) for s in range(k)],
            layers=tuple(SCALE["layers"]), n_req=SCALE["n_req"])
        res = sweep.run_sweep(sweep.SweepSpec(
            tuple(cells), options=SimOptions(horizon=SCALE["horizon"]),
            streaming=False))
        bw = res.scalars(keys=("bandwidth_gbps",))["bandwidth_gbps"]
        sizes[str(k)] = {"n_cells": len(res.names),
                         "n_buckets": len(res.buckets),
                         "names": list(res.names),
                         "bandwidth_gbps": [float(x) for x in bw],
                         "checksum_bandwidth": float(bw.sum())}
    pc = SCALE["prune"]
    base = sweep.paper_grid([("s", [stream, stream], 3)], layers=(2,),
                            n_req=pc["n_req"])[:4]
    reps = -(-pc["n_cells"] // len(base))
    cells = tuple(sweep.SweepCell(f"{c.name}#r{i}", c.stack, c.traces)
                  for i in range(reps) for c in base)
    res = sweep.run_sweep(sweep.SweepSpec(
        cells, options=SimOptions(horizon=pc["horizon"]),
        prune=sweep.PruneSpec(horizon_frac=pc["horizon_frac"],
                              keep_frac=pc["keep_frac"],
                              rounds=pc["rounds"])))
    prune = {"n_cells": len(cells), "n_promoted": len(res.names),
             "n_pruned": len(res.pruned), "promoted": list(res.names),
             "prune_work": dict(res.prune_work)}
    return {"module": SECTIONS["fig_scale"],
            "config": {**SCALE, "sizes": list(paper_fig_scale.SIZES_FULL)},
            "sizes": sizes, "prune": prune}


def make_section(name: str) -> dict:
    """Run the reference's module for `name` at its default size and
    return its golden section."""
    import repro.launch.compat  # noqa: F401  (jax API shims)
    if name == "fig_scale":
        return make_fig_scale()
    from repro.core.smla import sweep as sweep_mod
    mod = importlib.import_module(SECTIONS[name])
    sweeps: list = []
    arrays: dict = {}
    saved = {k: os.environ.pop(k, None) for k in ("SMLA_SMOKE",
                                                  "BENCH_JSON")}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            bench = os.path.join(tmp, "bench.json")
            os.environ["BENCH_JSON"] = bench
            with recording(sweep_mod, sweeps, substitute_pallas=True), \
                    capture_recording(arrays):
                rows = mod.run()
            emitted = {}
            if os.path.exists(bench):
                with open(bench) as f:
                    emitted = json.load(f)
    finally:
        os.environ.pop("BENCH_JSON", None)
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
    out = {"module": SECTIONS[name], "rows": list(rows), "sweeps": sweeps}
    if name in emitted:
        out["extra"] = extra_of(emitted[name])
    if arrays:
        out["capture_arrays"] = arrays
    return out


def provenance() -> dict:
    import jax
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    return {"jax": jax.__version__, "commit": commit or None,
            "backend": jax.default_backend(),
            "fig11_pallas_pass": "answered by the scan backend, not stored"}


def write(data: dict) -> None:
    """The golden file: compact JSON (under 1 MB), sorted keys."""
    GOLDEN.write_text(json.dumps(data, sort_keys=True,
                                 separators=(",", ":")) + "\n")


def main(argv=None) -> int:
    names = list(argv if argv is not None else sys.argv[1:]) or \
        list(SECTIONS)
    unknown = sorted(set(names) - set(SECTIONS))
    if unknown:
        print(f"unknown sections {unknown}; have {list(SECTIONS)}",
              file=sys.stderr)
        return 2
    data = json.loads(GOLDEN.read_text()) if GOLDEN.exists() else {}
    data["provenance"] = provenance()
    for name in names:
        data[name] = make_section(name)
        arrays = data[name].pop("capture_arrays", None)
        if arrays is not None:
            np.savez_compressed(CAPTURE, **arrays)
        write(data)
        sweeps = data[name].get("sweeps", [])
        print(f"{name}: {len(sweeps)} sweep(s), "
              f"{sum(len(s['names']) for s in sweeps)} cells", flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    raise SystemExit(main())
