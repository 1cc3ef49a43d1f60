"""The port's checkpoints: the reference's tests of its own
(tests/test_checkpoint.py: round-trip, latest and prune, a .tmp save
ignored, the async saver, resume-exact) on the port, and the format
across packages — the reference's ``save`` read by the port's
``restore`` and the port's ``save`` read by the reference's, bit-exact,
with the same file names and manifest.  The serving launcher serves a
saved training state.  Every comparison here is exact: a checkpoint
stores the values themselves."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduce_config as ref_reduce  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train.step import init_state as ref_init_state  # noqa: E402
from repro_torch.configs import (ParallelConfig, get_config,  # noqa: E402
                                 reduce_config)
from repro_torch.convert import state_from_reference  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.step import init_state, make_train_step  # noqa: E402

ARCH = "tinyllama-1.1b"


def _cfg():
    return reduce_config(get_config(ARCH))


def _state():
    return init_state(0, _cfg(), device="cpu")


def _equal(a, b) -> bool:
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    return fa.keys() == fb.keys() and all(
        np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])) for k in fa)


def test_roundtrip_exact(tmp_path):
    state = _state()
    ckpt.save(state, 7, str(tmp_path))
    restored = ckpt.restore(state, str(tmp_path))
    assert type(restored) is type(state)
    assert restored.step.dtype == torch.int32
    assert _equal(restored, state)


def test_latest_and_prune(tmp_path):
    state = _state()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(state, s, str(tmp_path), keep_last=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]
    assert ckpt.latest_step(str(tmp_path / "missing")) is None


def test_tmp_dir_ignored(tmp_path):
    ckpt.save(_state(), 1, str(tmp_path))
    os.makedirs(tmp_path / "step_00000099.tmp")
    assert ckpt.latest_step(str(tmp_path)) == 1   # incomplete save invisible


def test_async_saver(tmp_path):
    state = _state()
    saver = ckpt.AsyncSaver()
    saver.save(state, 3, str(tmp_path))
    saver.wait()
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert _equal(ckpt.restore(state, str(tmp_path)), state)


def test_restore_shape_mismatch_raises(tmp_path):
    ckpt.save(_state(), 1, str(tmp_path))
    other = init_state(0, dataclasses.replace(_cfg(), d_ff=64),
                       device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(other, str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(other, str(tmp_path / "missing"))


def test_resume_training_bitexact(tmp_path):
    """Save at step k, keep training; restore and retrain: same loss."""
    cfg = _cfg()
    state = _state()
    step = make_train_step(cfg, ParallelConfig(attn_impl="chunked",
                                               moe_impl="dense",
                                               remat="none"), lr=1e-3)
    tok = np.random.default_rng(1).integers(0, 64, (4, 32), dtype=np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
    for _ in range(3):
        state, _ = step(state, batch)
    ckpt.save(state, 3, str(tmp_path))
    cont, m1 = step(state, batch)
    restored = ckpt.restore(state, str(tmp_path))
    cont2, m2 = step(restored, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), abs=1e-6)
    assert _equal(cont, cont2)


def test_reference_checkpoint_read_by_port(tmp_path):
    rcfg = ref_reduce(ref_get_config(ARCH))
    rstate = ref_init_state(jax.random.PRNGKey(3), rcfg)
    ref_ckpt.save(rstate, 11, str(tmp_path))
    restored = ckpt.restore(_state(), str(tmp_path))
    want = {k: np.asarray(v) for k, v in ref_ckpt._flatten(rstate).items()}
    assert _equal(restored, state_from_reference(want, _cfg()))


def test_port_checkpoint_read_by_reference(tmp_path):
    state = _state()
    ckpt.save(state, 12, str(tmp_path))
    d = tmp_path / "step_00000012"
    rcfg = ref_reduce(ref_get_config(ARCH))
    template = jax.eval_shape(
        lambda: ref_init_state(jax.random.PRNGKey(0), rcfg))
    restored = ref_ckpt.restore(template, str(tmp_path))
    got = {k: np.asarray(v) for k, v in ref_ckpt._flatten(restored).items()}
    want = {k: v.numpy() for k, v in ckpt._flatten(state).items()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    # the same files and manifest as the reference writes
    ref_dir = tmp_path / "ref"
    ref_ckpt.save(restored, 12, str(ref_dir))
    assert sorted(os.listdir(d)) == sorted(
        os.listdir(ref_dir / "step_00000012"))
    mine = json.loads((d / "manifest.json").read_text())
    theirs = json.loads(
        (ref_dir / "step_00000012" / "manifest.json").read_text())
    assert mine == theirs


def test_serve_from_checkpoint(tmp_path, capsys, monkeypatch):
    """The serving launcher serves the params of a saved training state
    (not its own initialisation)."""
    saved = init_state(5, _cfg(), device="cpu")._replace(
        step=torch.tensor(4, dtype=torch.int32))
    ckpt.save(saved, 4, str(tmp_path))
    served = []

    class Recording(launch_serve.Engine):
        def __init__(self, cfg, pcfg, scfg, params, **kw):
            served.append(params)
            super().__init__(cfg, pcfg, scfg, params, **kw)

    monkeypatch.setattr(launch_serve, "Engine", Recording)
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "2",
            "--prompt-len", "8", "--new-tokens", "4"]
    assert launch_serve.main(args + ["--ckpt-dir", str(tmp_path)]) == 0
    assert "loaded checkpoint step 4" in capsys.readouterr().out
    assert _equal(served[0], saved.params)
    assert launch_serve.main(args) == 0
    assert not _equal(served[1], saved.params)
