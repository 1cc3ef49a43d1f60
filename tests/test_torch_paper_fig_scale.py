"""fig_scale through the port (`repro_torch.benchmarks.paper_fig_scale`)
on the CPU (the plain version; nothing is built): one size's three
fresh-process modes agree on every bandwidth and equal the reference's
sweep of the same grid; the prune child's promoted cells and
`prune_work` equal the reference's; and the early-exit gate's fig_scale
section passes a record and fails doctored ones (the stream/sync ratio
gated only on a card's record)."""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.smla import engine as ref_engine  # noqa: E402
from repro.core.smla import sweep as ref_sweep  # noqa: E402
from repro.core.smla.traces import WorkloadSpec  # noqa: E402
from repro_torch.benchmarks import assert_early_exit  # noqa: E402
from repro_torch.benchmarks import paper_fig_scale as port_fig  # noqa: E402

STREAM = WorkloadSpec("stream.t", 50.0, 0.85, write_frac=1 / 3)


def _ref_size(k, n_req, horizon):
    cells = ref_sweep.paper_grid(
        [(f"w{s}", [STREAM, STREAM], s) for s in range(k)], layers=(2, 4),
        n_req=n_req)
    res = ref_sweep.run_sweep(ref_sweep.SweepSpec(
        tuple(cells), options=ref_engine.SimOptions(horizon=horizon),
        streaming=False))
    return res, res.scalars(keys=("bandwidth_gbps",))["bandwidth_gbps"]


@pytest.fixture(scope="module")
def size_row(tmp_path_factory):
    """One size (k=1: 10 cells) in its three child processes."""
    return port_fig.run_size(1, 24, 600, str(tmp_path_factory.mktemp("c")),
                             device="cpu")


def test_run_size_modes_agree_with_reference(size_row):
    res, bw = _ref_size(1, 24, 600)
    assert size_row["device"] == "cpu"
    assert size_row["names"] == res.names
    assert size_row["bandwidth_gbps"] == [float(x) for x in bw]
    assert size_row["checksum_bandwidth"] == float(bw.sum())
    for mode in ("sync", "stream_cold", "stream_warm"):
        m = size_row[mode]
        assert m["checksum_bandwidth"] == float(bw.sum()), mode
        assert (m["launches"], m["build_s"]) == (0, 0.0), mode
        assert m["n_cells"] == 10 and m["n_buckets"] == len(res.buckets)
    assert size_row["ratio"] > 0
    assert port_fig._build_note(size_row).startswith("nothing built")


def test_prune_child_matches_reference(capsys):
    cfg = {"kind": "prune", "n_cells": 40, "n_req": 6, "horizon": 256,
           "device": "cpu", "label": "fig_scale:prune"}
    port_fig.child(json.dumps(cfg))
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("RESULT ")][-1]
    got = json.loads(line[len("RESULT "):])
    base = ref_sweep.paper_grid([("s", [STREAM, STREAM], 3)], layers=(2,),
                                n_req=6)[:4]
    cells = tuple(ref_sweep.SweepCell(f"{c.name}#r{i}", c.stack, c.traces)
                  for i in range(10) for c in base)
    want = ref_sweep.run_sweep(ref_sweep.SweepSpec(
        cells, options=ref_engine.SimOptions(horizon=256),
        prune=ref_sweep.PruneSpec(horizon_frac=0.125, keep_frac=0.5,
                                  rounds=1)))
    assert got["promoted"] == want.names
    assert (got["n_promoted"], got["n_pruned"]) == (10, 30)
    assert {k: got[k] for k in want.prune_work} == want.prune_work
    assert got["launches"] == 0 and got["device"] == "cpu"


def _record(size_row, device, ratio=None, saved=0.9):
    row = json.loads(json.dumps(size_row))
    if ratio is not None:
        row["ratio"] = ratio
    return {"fig_scale": {"rows": [row], "device": device,
                          "prune": {"saved_frac": saved,
                                    "n_cells": 20_000}}}


def test_gate_fig_scale(size_row, capsys):
    check = assert_early_exit.check_fig_scale
    assert check(_record(size_row, "cpu", ratio=1.0)) is None
    assert "not gated" in capsys.readouterr().out
    assert check(_record(size_row, "cuda", ratio=2.0)) is None
    assert "ratio" in check(_record(size_row, "cuda", ratio=1.0))
    assert "saved" in check(_record(size_row, "cpu", saved=0.4))
    bad = _record(size_row, "cpu")
    bad["fig_scale"]["rows"][0]["stream_warm"]["checksum_bandwidth"] += 1.0
    assert "disagree" in check(bad)
    assert "no rows" in check({})
    assert assert_early_exit.STREAM_RATIO_FLOOR == 1.3
    assert assert_early_exit.PRUNE_SAVED_FLOOR == 0.5
    assert np.isclose(size_row["ratio"], size_row["stream_warm"][
        "cells_per_s"] / size_row["sync"]["cells_per_s"], rtol=1e-2)
