"""CI gate: the chunked sweep engine's early exit must actually engage,
and the sweep engine's scaling record must hold (port of
``benchmarks/assert_early_exit.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.assert_early_exit

Reads the fig11, fig_policy, fig_ooo, fig_refresh, fig_fault and
fig_serve sections of ``BENCH_smla_sweep_torch.json`` (or `BENCH_JSON`; written by
``repro_torch.benchmarks.run --smoke`` just before this runs),
rehydrates each through `FigureRecord.from_json` — the SAME typed record
the emitters write — and fails unless, in each, at least one non-baseline
cell ran strictly fewer chunks than its bucket's horizon allows, i.e. the
loop ended on measured completion, not on the horizon.  Chunk widths are
per bucket, so the bound is per cell (`perf.cell_n_chunks_max`).

`check_fig_scale` gates the fig_scale section: the three modes of every
size agree on the bandwidth checksum, successive halving saved at least
`PRUNE_SAVED_FLOOR` of the full-horizon work, and — on a record made on
the card, where the sync child pays the kernel's ``nvcc`` build that the
warm child finds done — the best stream_warm/sync ratio reaches
`STREAM_RATIO_FLOOR`.  A CPU record builds nothing, so its ratio is
printed, not gated.
"""
from __future__ import annotations

import json
import os
import sys

from repro_torch.benchmarks._util import (BENCH_JSON_DEFAULT,
                                          BENCH_JSON_ENV, FigureRecord)

GATED_FIGURES = ("fig11", "fig_policy", "fig_ooo", "fig_refresh",
                 "fig_fault", "fig_serve")

#: minimum stream_warm/sync cells_per_s ratio the fig_scale record must
#: reach on its best row (the pipeline with a built kernel library vs the
#: synchronous runner paying the build — see ``paper_fig_scale``)
STREAM_RATIO_FLOOR = 1.3
#: minimum fraction of full-horizon device work successive halving must
#: avoid on the fig_scale prune grid
PRUNE_SAVED_FLOOR = 0.5


def check_fig_scale(data: dict) -> str | None:
    """None on success, else the failure message.  Gates the streaming
    engine's committed throughput trajectory: the modes must agree, the
    pipeline with its built library must beat the synchronous runner
    that builds (card records only) and pruning must actually save
    work."""
    fig = data.get("fig_scale")
    if not fig or not fig.get("rows"):
        return "fig_scale: no rows emitted"
    for r in fig["rows"]:
        sums = {r[m]["checksum_bandwidth"]
                for m in ("sync", "stream_cold", "stream_warm")}
        if len(sums) != 1:
            return (f"fig_scale: {r.get('n_cells')} cells: the modes "
                    f"disagree on the bandwidth checksum {sums}")
    best = max(float(r.get("ratio", 0.0)) for r in fig["rows"])
    on_card = fig.get("device") == "cuda"
    if on_card and best < STREAM_RATIO_FLOOR:
        return (f"fig_scale: best streaming/sync cells_per_s ratio {best}"
                f" < {STREAM_RATIO_FLOOR} — the streaming pipeline is not "
                f"beating the synchronous runner")
    saved = float(fig.get("prune", {}).get("saved_frac", 0.0))
    if saved < PRUNE_SAVED_FLOOR:
        return (f"fig_scale: successive halving saved {saved:.0%} "
                f"< {PRUNE_SAVED_FLOOR:.0%} of full-horizon work")
    ratio = (f"streaming {best:.2f}x sync (floor {STREAM_RATIO_FLOOR}x)"
             if on_card else f"streaming {best:.2f}x sync, not gated on "
             f"{fig.get('device')} (nothing built)")
    print(f"assert_early_exit: fig_scale OK — {ratio}, pruning saved "
          f"{saved:.0%} of full-horizon work on "
          f"{fig['prune'].get('n_cells', '?')} cells")
    return None


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
    msg = check_fig_scale(data)
    if msg:
        failures.append(msg)
    for msg in failures:
        print(f"assert_early_exit: {msg} ({path})", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
