"""The port's serving engine against the reference on the float32 reduced
tinyllama-1.1b (the reference's params carried over): greedy tokens equal
exactly, with eos_id -1 and with an eos that fires mid-run (the post-EOS
lane freeze), and the observer sees the same (kind, done, lengths)
sequence; the launcher runs on the CPU; CUDA without a card raises; the
data pipeline's batches equal the reference's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import (ParallelConfig as RefPCfg,  # noqa: E402
                           get_config as ref_get_config,
                           reduce_config as ref_reduce)
from repro.data.pipeline import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serve.engine import Engine as RefEngine  # noqa: E402
from repro.serve.engine import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch.configs import (ParallelConfig, get_config,  # noqa: E402
                                 reduce_config)
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core.comm import MeshShape  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serve.engine import (Engine, ServeConfig,  # noqa: E402
                                      make_serve_fns)

B, PROMPT, NEW, MAX_SEQ = 4, 8, 16, 32


@pytest.fixture(scope="module")
def setup():
    rcfg = dataclasses.replace(ref_reduce(ref_get_config("tinyllama-1.1b")),
                               dtype="float32")
    cfg = dataclasses.replace(reduce_config(get_config("tinyllama-1.1b")),
                              dtype="float32")
    rparams = RT.init(jax.random.PRNGKey(0), rcfg)
    flat = {k: np.asarray(v)
            for k, v in ref_common.flatten_paths(rparams).items()}
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                               (B, PROMPT), dtype=np.int32)
    return rcfg, cfg, rparams, params_from_reference(flat, cfg), prompt


def _recorder(events):
    def observer(kind, *, done, lengths):
        events.append((kind, np.asarray(done).tolist(),
                       np.asarray(lengths).tolist()))
    return observer


def _run_both(setup, impl, eos):
    rcfg, cfg, rparams, params, prompt = setup
    ref = RefEngine(rcfg, RefPCfg(attn_impl=impl, moe_impl="dense",
                                  remat="none"),
                    RefServeConfig(max_seq=MAX_SEQ, eos_id=eos), rparams)
    port = Engine(cfg, ParallelConfig(attn_impl=impl, moe_impl="dense",
                                      remat="none"),
                  ServeConfig(max_seq=MAX_SEQ, eos_id=eos), params,
                  device="cpu")
    ref_events, port_events = [], []
    want = np.asarray(ref.generate({"tokens": jnp.asarray(prompt)}, NEW,
                                   observer=_recorder(ref_events)))
    got = port.generate({"tokens": prompt}, NEW,
                        observer=_recorder(port_events))
    return got, want, port_events, ref_events


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_greedy_tokens_and_observer_equal(setup, impl):
    got, want, port_events, ref_events = _run_both(setup, impl, -1)
    assert got.dtype == torch.int32 and got.shape == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    assert port_events == ref_events
    # max_new_tokens tokens take max_new_tokens - 1 decode calls
    assert [k for k, _, _ in port_events] == ["prefill"] + ["decode"] * (
        NEW - 1)


def test_eos_lane_freeze_equal(setup):
    """An eos id that one lane emits mid-run: that lane freezes to eos,
    the others run on; tokens and observer events equal the reference's."""
    free, _, _, _ = _run_both(setup, "chunked", -1)
    free = free.numpy()
    eos = int(free[0, 5])
    first = [int(np.argmax(row == eos)) if (row == eos).any() else NEW
             for row in free]
    assert min(first) < NEW - 2 and max(first) > min(first), (eos, first)
    got, want, port_events, ref_events = _run_both(setup, "chunked", eos)
    np.testing.assert_array_equal(got.numpy(), want)
    assert port_events == ref_events
    lane = int(np.argmin(first))
    assert (got[lane, first[lane]:] == eos).all()


def test_temperature_sampling_runs(setup):
    _, cfg, _, params, prompt = setup
    eng = Engine(cfg, ParallelConfig(moe_impl="dense", remat="none"),
                 ServeConfig(max_seq=MAX_SEQ, temperature=0.8), params,
                 device="cpu")
    out = eng.generate({"tokens": prompt}, 4)
    assert out.shape == (B, 4)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size


def test_launcher_runs_on_cpu(capsys):
    rc = launch_serve.main(["--arch", "tinyllama-1.1b", "--smoke",
                            "--device", "cpu", "--requests", "2",
                            "--prompt-len", "8", "--new-tokens", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "generated 8 tokens" in out and "device=cpu" in out
    # a directory with no checkpoint serves the initialised params, as the
    # reference does (serving a saved state: test_torch_checkpoint.py)
    rc = launch_serve.main(["--arch", "tinyllama-1.1b", "--smoke",
                            "--device", "cpu", "--requests", "2",
                            "--prompt-len", "8", "--new-tokens", "4",
                            "--ckpt-dir", "/nonexistent"])
    assert rc == 0
    out2 = capsys.readouterr().out
    assert "loaded checkpoint" not in out2
    assert out2.splitlines()[-1] == out.splitlines()[-1]


def test_cuda_without_card_raises(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, cfg, _, params, _ = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, ParallelConfig(), ServeConfig(), params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "tinyllama-1.1b", "--smoke"])


def test_mesh_raises(setup):
    """Serving on a mesh needs a process group: a mesh of axis names and
    sizes alone gets the policy's specs from `make_serve_fns`, but the
    engine raises; an unknown policy raises.  (Sharded serving itself:
    tests/test_torch_serve_mesh.py.)"""
    _, cfg, _, params, _ = setup
    mesh = MeshShape(("data", "model"), (2, 2))
    _, _, specs = make_serve_fns(cfg, ParallelConfig(), ServeConfig(),
                                 mesh=mesh)
    assert specs["params"]["layers"]["attn"]["wq"] == (None, "data", "model")
    with pytest.raises(ValueError, match="no process group"):
        Engine(cfg, ParallelConfig(), ServeConfig(), params, mesh=mesh,
               device="cpu")
    with pytest.raises(ValueError, match="policy"):
        make_serve_fns(cfg, ParallelConfig(), ServeConfig(policy="rank"))


@pytest.mark.parametrize("step", [0, 3])
def test_synthetic_lm_equal(step):
    want = RefSyntheticLM(256, 16, 4, seed=7).batch(step)
    got = SyntheticLM(256, 16, 4, seed=7).batch(step)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
