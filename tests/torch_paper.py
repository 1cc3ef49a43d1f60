"""Helpers shared by the ``test_torch_paper_*`` tests: run a reference
module of ``benchmarks/`` and its port in ``repro_torch.benchmarks`` on
the same grid, each with ``BENCH_JSON`` in a temporary directory and its
sweeps recorded (``tests/torch_golden/make_paper_figs.py``'s wrapper of
``run_sweep``), and hold the two records against each other: integers
exact, floats to rtol=1e-6, the printed data rows equal."""
import json
import pathlib
import sys

import numpy as np

TESTS = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(TESTS.parent), str(TESTS / "torch_golden")]
import make_paper_figs  # noqa: E402

from repro.core.smla import sweep as ref_sweep  # noqa: E402
from repro_torch.core.smla import sweep as port_sweep  # noqa: E402

RTOL = 1e-6
#: printed rows that carry times or launch counts, not results
TIMING_ROWS = ("# sweep:", "# pallas", "# plain")
#: `extra` keys that count compiles/launches or carry timings
SKIP_EXTRA = ("compiles_per_window", "launches_per_window",
              "cells_per_s_scan", "cells_per_s_main", "interpret")


def run_recorded(mod, section: str, bench: pathlib.Path, **kw) -> dict:
    """`mod.run(**kw)` (a reference or a port module) with `BENCH_JSON`
    already pointed at `bench` by the caller: its rows, its recorded
    sweeps and its section's `extra`."""
    port = mod.__name__.startswith("repro_torch.")
    sweeps: list = []
    with make_paper_figs.recording(port_sweep if port else ref_sweep,
                                   sweeps, substitute_pallas=not port):
        rows = mod.run(**kw)
    out = {"rows": list(rows), "sweeps": sweeps}
    if bench.exists():
        out["extra"] = make_paper_figs.extra_of(
            json.loads(bench.read_text())[section])
    return out


def run_both(monkeypatch, tmp_path, ref_mod, port_mod, section: str,
             patches: dict, **kw) -> tuple[dict, dict]:
    """(port, reference) records of one figure: both modules with the
    same module constants patched (`patches`), SMLA_SMOKE unset and
    BENCH_JSON in `tmp_path`; the port on the CPU (its plain version)."""
    monkeypatch.delenv("SMLA_SMOKE", raising=False)
    for mod in (ref_mod, port_mod):
        for name, value in patches.items():
            monkeypatch.setattr(mod, name, value)
    out = []
    for mod, extra_kw in ((port_mod, {"device": "cpu"}), (ref_mod, {})):
        bench = tmp_path / f"{mod.__name__}.json"
        monkeypatch.setenv("BENCH_JSON", str(bench))
        out.append(run_recorded(mod, section, bench, **kw, **extra_kw))
    return out[0], out[1]


def data_rows(rows):
    return [r for r in rows if not r.startswith(TIMING_ROWS)]


def same_value(got, want, where: str) -> None:
    """Ints and bools exact, floats to RTOL, strings equal, containers
    element by element; raises AssertionError naming `where`."""
    if isinstance(want, dict):
        keys = set(want) - set(SKIP_EXTRA)
        assert keys == set(got) - set(SKIP_EXTRA), \
            f"{where}: keys {sorted(set(got) ^ set(want))}"
        for k in sorted(keys):
            same_value(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), f"{where}: {len(got)} != {len(want)}"
        for i, (g, w) in enumerate(zip(got, want)):
            same_value(g, w, f"{where}[{i}]")
    elif isinstance(want, (bool, int, str)) or want is None:
        assert got == want and type(got) is type(want), \
            f"{where}: {got!r} != {want!r}"
    else:
        assert isinstance(got, float), f"{where}: {got!r} is not a float"
        assert np.isclose(got, want, rtol=RTOL, atol=0.0), \
            f"{where}: {got!r} != {want!r}"


def assert_same(got: dict, want: dict, what: str) -> None:
    """Two records (`run_recorded` or a golden section) agree: data rows,
    every sweep's horizon, n_req, window, cell names, chunk widths and
    per-cell metrics, and the JSON record's `extra`."""
    assert data_rows(got["rows"]) == data_rows(want["rows"]), what
    assert len(got["sweeps"]) == len(want["sweeps"]), what
    for i, (g, w) in enumerate(zip(got["sweeps"], want["sweeps"])):
        same_value(g, w, f"{what}.sweeps[{i}]")
    assert ("extra" in got) == ("extra" in want), what
    if "extra" in want:
        same_value(got["extra"], want["extra"], f"{what}.extra")
