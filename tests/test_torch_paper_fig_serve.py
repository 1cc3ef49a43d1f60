"""fig_serve through the port (`repro_torch.benchmarks.paper_fig_serve`)
against the reference.

The reference's capture draws its params and prompts from JAX keys (the
prompts' folded with a per-process string hash), so the golden records
the arrays its full-size run used (`make_paper_figs.capture_arrays`):
the port's capture on them, on the CPU, generates the reference's greedy
tokens and the golden's capture stats and profile, exactly.  `run()` on a
reduced grid (one traffic class, one organisation, three presets),
both captures fed the recorded arrays: every cell's metrics (ints exact,
floats rtol=1e-6), the printed rows and the JSON record's `extra`, and
the early-exit gate's fig_serve section.  The golden's full-size sweep
through the card's dispatch (one launch per shape group), with the
cycle kernel's g++ host build as the launcher: every cell equal."""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_paper import (assert_same, make_paper_figs, run_both,  # noqa: E402
                         same_value)
from torch_parity import host_launch, host_library  # noqa: E402

from benchmarks import paper_fig_serve as ref_fig  # noqa: E402
from repro.core.smla import policies as ref_policies  # noqa: E402
from repro.serve import bridge as ref_bridge  # noqa: E402
from repro_torch.benchmarks import assert_early_exit  # noqa: E402
from repro_torch.benchmarks import paper_fig_serve as port_fig  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core.smla import policies as port_policies  # noqa: E402
from repro_torch.core.smla import sweep  # noqa: E402
from repro_torch.serve import bridge  # noqa: E402

GOLDEN = json.loads(make_paper_figs.GOLDEN.read_text())["fig_serve"]
PRESETS = ("default", "fcfs", "layer_gated")


@pytest.fixture(scope="module")
def recorded():
    flat, batch, generated = make_paper_figs.capture_arrays()
    return (params_from_reference(flat, port_fig.capture_config()), batch,
            generated)


def test_capture_matches_the_reference_run(recorded):
    params, batch, generated = recorded
    prof, stats, out = port_fig._capture_profile(16, device="cpu",
                                                 params=params, batch=batch)
    # the reduced model is bf16, as the reference's; the greedy tokens of
    # its recorded run come out unchanged
    np.testing.assert_array_equal(out.numpy(), generated)
    same_value(stats, GOLDEN["extra"]["capture"], "capture")
    assert stats["profile"] == GOLDEN["extra"]["capture"]["profile"]
    assert isinstance(prof, bridge.StreamProfile)


def test_capture_draws_its_own_by_default():
    a = port_fig._capture_profile(4, device="cpu")
    b = port_fig._capture_profile(4, device="cpu")
    assert a[1] == b[1] and np.array_equal(a[2].numpy(), b[2].numpy())
    assert a[2].shape == (port_fig.CAPTURE_BATCH, 4)


def test_fig_serve_matches_reference(monkeypatch, tmp_path, recorded):
    params, batch, _ = recorded
    for pol in (ref_policies, port_policies):
        monkeypatch.setattr(pol, "POLICY_PRESETS", {
            k: pol.POLICY_PRESETS[k] for k in PRESETS})
    # both captures from the recorded run: the reference's is the
    # golden's (its stats and profile), the port's runs on the arrays
    cap = GOLDEN["extra"]["capture"]
    monkeypatch.setattr(ref_fig, "_capture_profile", lambda n: (
        ref_bridge.StreamProfile(**cap["profile"]), cap))
    orig = port_fig._capture_profile
    monkeypatch.setattr(port_fig, "_capture_profile", lambda n, device, **_:
                        orig(n, device=device, params=params, batch=batch))
    got, want = run_both(monkeypatch, tmp_path, ref_fig, port_fig,
                         "fig_serve", {
                             "TRAFFIC_CLASSES": ref_fig.TRAFFIC_CLASSES[2:],
                             "ORGS": ("cascaded_slr",)}, n_req=24)
    assert [len(s["names"]) for s in got["sweeps"]] == [3]
    assert len(got["extra"]["rows"]) == 3
    assert got["extra"]["capture"] == cap
    assert_same(got, want, "fig_serve")
    bench = json.loads((tmp_path / f"{port_fig.__name__}.json").read_text())
    assert bench["fig_serve"]["launches"] == 0          # the CPU: no kernel
    assert "fig_serve" in assert_early_exit.GATED_FIGURES
    assert assert_early_exit.check_figure("fig_serve", bench) is None


def test_golden_cells_on_the_host_build():
    """The golden's 66 cells, built by the port's `grid` from the golden's
    profile, through one launch of the kernel's host build: the golden's
    horizon, cell names, chunk widths and every metric."""
    want = GOLDEN["sweeps"][0]
    prof = bridge.StreamProfile(**GOLDEN["extra"]["capture"]["profile"])
    spec = port_fig.grid(prof, want["n_req"], device="cpu")
    assert spec.options.horizon == want["horizon"]
    assert sweep.shape_groups(spec) == 1
    launch = host_launch(host_library())
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return launch(*a, **kw)
    res = sweep._run(spec, counted)
    assert len(calls) == 1
    same_value(make_paper_figs.sweep_record(spec, res,
                                            sweep.SCALAR_METRICS),
               want, "fig_serve golden")


def test_fig_serve_asks_for_the_card_by_default(monkeypatch, tmp_path):
    """With no device named, the capture and the sweep go to the card and
    raise where there is none; nothing falls back to the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("BENCH_JSON", str(tmp_path / "bench.json"))
    prof = bridge.StreamProfile(**GOLDEN["extra"]["capture"]["profile"])
    assert port_fig.grid(prof, 8).options.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_fig.run(n_req=8)
    assert not (tmp_path / "bench.json").exists()
