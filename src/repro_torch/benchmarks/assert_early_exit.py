"""CI gate: the chunked sweep engine's early exit must actually engage
(port of ``benchmarks/assert_early_exit.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.assert_early_exit

Reads the fig11, fig_policy, fig_ooo and fig_refresh sections of
``BENCH_smla_sweep_torch.json`` (or `BENCH_JSON`; written by
``repro_torch.benchmarks.run --smoke`` just before this runs),
rehydrates each through `FigureRecord.from_json` — the SAME typed record
the emitters write — and fails unless, in each, at least one non-baseline
cell ran strictly fewer chunks than its bucket's horizon allows, i.e. the
loop ended on measured completion, not on the horizon.  Chunk widths are
per bucket, so the bound is per cell (`perf.cell_n_chunks_max`).  The
reference also gates fig_fault, fig_serve and fig_scale, which the port
has not reached yet.
"""
from __future__ import annotations

import json
import os
import sys

from repro_torch.benchmarks._util import (BENCH_JSON_DEFAULT,
                                          BENCH_JSON_ENV, FigureRecord)

GATED_FIGURES = ("fig11", "fig_policy", "fig_ooo", "fig_refresh")


def check_figure(name: str, data: dict) -> str | None:
    """None on success, else the failure message."""
    try:
        rec = FigureRecord.from_json(name, data.get(name))
        early = rec.early_exit_cells()
    except ValueError as e:
        return str(e)
    if not early:
        return (f"{name}: no non-baseline cell exited before the horizon "
                f"— early exit is not engaging")
    frac = rec.perf["early_exit_frac"]
    print(f"assert_early_exit: {name} OK [{rec.backend}] — {len(early)} "
          f"non-baseline cells exited early (e.g. {early[0][0]} after "
          f"{early[0][1]}/{early[0][2]} chunks); sweep-wide {frac:.0%} "
          f"of chunks saved")
    return None


def main() -> int:
    path = os.environ.get(BENCH_JSON_ENV, BENCH_JSON_DEFAULT)
    with open(path) as f:
        data = json.load(f)
    failures = [msg for msg in (check_figure(name, data)
                                for name in GATED_FIGURES) if msg]
    for msg in failures:
        print(f"assert_early_exit: {msg} ({path})", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
