"""Record the reference's own full-size run of the paper's outputs as the
golden file the port is held against (``paper_figs.json`` beside this
script).

    PYTHONPATH=.:src JAX_PLATFORMS=cpu \
        python tests/torch_golden/make_paper_figs.py [SECTION ...]

Each section is one module of ``benchmarks/``: Tables 1-2, Figs. 11-14,
fig_policy, fig_ooo and fig_refresh.  The script calls the module's own
``run()`` at its default (full) size, ``SMLA_SMOKE`` unset and
``BENCH_JSON`` pointed at a temporary file, and records every
``SweepResult`` by wrapping ``repro.core.smla.sweep.run_sweep`` for the
duration of the call, so no grid is written twice.  Per sweep it keeps
the horizon, n_req, the window depth, the cell names, their chunk
widths and per cell the scalar metrics of ``sweep.SCALAR_METRICS`` (ints
as ints), ``served`` and ``ipc`` per core; per module the printed rows
and the ``extra`` payload of its JSON record (rows, geomeans, mixes).
Floats are stored unrounded (JSON's ``repr``-exact numbers).

Fig. 11's second pass asks for ``backend="pallas"`` in interpret mode,
which off-TPU is far too slow at full size: the wrapper answers that
spec with the scan backend on the same cells (the reference asserts the
two agree) and does not record it, so the golden holds the scan pass
only.

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
}

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


def extra_of(section: dict) -> dict:
    return {k: v for k, v in section.items() if k not in RECORD_KEYS}


def make_section(name: str) -> dict:
    """Run the reference's module for `name` at its default size and
    return its golden section."""
    import repro.launch.compat  # noqa: F401  (jax API shims)
    from repro.core.smla import sweep as sweep_mod
    mod = importlib.import_module(SECTIONS[name])
    sweeps: list = []
    saved = {k: os.environ.pop(k, None) for k in ("SMLA_SMOKE",
                                                  "BENCH_JSON")}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            bench = os.path.join(tmp, "bench.json")
            os.environ["BENCH_JSON"] = bench
            with recording(sweep_mod, sweeps, substitute_pallas=True):
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
        write(data)
        print(f"{name}: {len(data[name]['sweeps'])} sweep(s), "
              f"{sum(len(s['names']) for s in data[name]['sweeps'])} cells",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    raise SystemExit(main())
