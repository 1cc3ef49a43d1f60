"""Training the hybrid (zamba2-7b: Mamba2 + a shared attention block) and
encoder-decoder (whisper-base) families in the port against the
reference, same numpy inputs: two `make_train_step` steps from the
reference's own initial state (carried over by
`convert.state_from_reference`), attn_impl "pallas" and remat "full" on
both sides (the reference's interpret-mode Pallas kernels against the
port's plain versions of its CUDA kernels): reduced zamba2-7b at 5 layers
(two groups, so two shared-block sites, and a one-layer tail), reduced
whisper-base, and a reduced zamba2-7b whose shared attention keeps the
published head dim 112 (2 heads, d_model 224, S 128).  Remat "full"
against "none" bit for bit, the hybrid state's checkpoint round trip, and
the training launcher.

Tolerances are test_torch_train.py's (float32; sums run in another order
in the two frameworks): loss and grad norm rtol 1e-5, lr 1e-7; after two
steps m and v within 5e-5 of each leaf's max |value|, params within
0.05 x lr absolute (Adam's first steps divide each gradient element by
its own magnitude, so an element whose gradient is near 0 moves by up to
lr on a rounding difference).  A param element whose reference gradient
is float32 noise in either step (at most NOISE of its leaf's max |g|,
below the 1e-5 to which float32 gradients agree) has no determined sign
and is left out of the param bound; its m and v stay held, and every
such element that moved more than 0.05 x lr is printed with both sides'
gradients."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ParallelConfig as RefPCfg  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduce_config as ref_reduce  # noqa: E402
from repro.launch import train as ref_launch_train  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train.step import init_state as ref_init_state  # noqa: E402
from repro.train.step import make_train_step as ref_make_step  # noqa: E402
from repro_torch.configs import (ParallelConfig, get_config,  # noqa: E402
                                 reduce_config)
from repro_torch.convert import state_from_reference  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import make_batch  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.step import init_state, make_train_step  # noqa: E402

PCFG = ParallelConfig(attn_impl="pallas", moe_impl="dense", remat="full")
REF_PCFG = RefPCfg(attn_impl="pallas", moe_impl="dense", remat="full")
LR = 1e-3
#: the reduced configs' overrides, by case: zamba2-7b at 5 layers
#: (attn_every 2: two groups and a tail), whisper-base as reduced, and
#: zamba2-7b with its shared attention at head dim 112 (3 layers: a group
#: and a tail)
CASES = {
    "zamba2-7b": ("zamba2-7b", {"n_layers": 5}),
    "whisper-base": ("whisper-base", {}),
    "zamba2-7b-hd112": ("zamba2-7b", {"n_layers": 3, "d_model": 224,
                                      "n_heads": 2, "n_kv_heads": 2,
                                      "head_dim": 112}),
}
#: (batch, sequence) of each case's train batches
SHAPES = {"zamba2-7b": (4, 32), "whisper-base": (4, 32),
          "zamba2-7b-hd112": (4, 128)}
#: a reference gradient element at most this fraction of its leaf's max
#: |g| is float32 noise (see the module docstring)
NOISE = 1e-5


def _cfgs(case, dtype="float32"):
    arch, over = CASES[case]
    ref = dataclasses.replace(ref_reduce(ref_get_config(arch)), dtype=dtype,
                              **over)
    port = dataclasses.replace(reduce_config(get_config(arch)), dtype=dtype,
                               **over)
    return ref, port


def _flat(state):
    return {k: np.asarray(v) for k, v in ref_ckpt._flatten(state).items()}


def _batch(seed, cfg, case):
    """The port's `make_batch` (numpy draws: tokens, labels and, for
    whisper, the frame embeddings), as numpy arrays."""
    b, s = SHAPES[case]
    return {k: v.numpy() for k, v in make_batch(seed, cfg, b, s).items()}


def _rel(got, want):
    got, want = float(got), float(want)
    return abs(got - want) / max(abs(want), 1e-30)


def _step_grads(moments):
    """Each step's clipped gradient, by leaf, from AdamW's first moment
    after each step (m' = b1 m + (1 - b1) g, m 0 before the first)."""
    b1 = AdamWConfig().b1
    prev, out = None, []
    for m in moments:
        out.append({k: (v if prev is None else v - b1 * prev[k]) / (1 - b1)
                    for k, v in m.items()})
        prev = m
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_reference(case):
    """Two steps from the reference's own initial state: loss, grad norm
    and lr each step; params, m and v after both (the shared block's
    tied weights and the float32 SSM leaves among them)."""
    rcfg, cfg = _cfgs(case)
    rstate = ref_init_state(jax.random.PRNGKey(0), rcfg)
    state = state_from_reference(_flat(rstate), cfg)
    rstep = jax.jit(ref_make_step(rcfg, REF_PCFG, lr=LR, warmup=2,
                                  total=10))
    step = make_train_step(cfg, PCFG, lr=LR, warmup=2, total=10)
    moments = ([], [])
    for i in range(2):
        batch = _batch(i, cfg, case)
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, batch)
        assert np.isfinite(float(m["loss"]))
        assert _rel(m["loss"], rm["loss"]) < 1e-5
        assert _rel(m["grad_norm"], rm["grad_norm"]) < 1e-5
        assert _rel(m["lr"], rm["lr"]) < 1e-7
        for side, flat in zip(moments, (
                _flat(rstate), {k: v.numpy() for k, v in
                                ckpt._flatten(state).items()})):
            side.append({k: v for k, v in flat.items()
                         if k.startswith(".opt/.m/")})
    assert int(state.step) == int(rstate.step) == 2
    ref_g, port_g = map(_step_grads, moments)
    got, want = ckpt._flatten(state), _flat(rstate)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name.startswith(".params/"):
            mk = ".opt/.m/" + name[len(".params/"):]
            noise = np.zeros(w.shape, bool)
            for step_g in ref_g:
                gr = np.abs(step_g[mk])
                noise |= gr <= NOISE * gr.max()
            diff = np.abs(g - w)
            assert diff[~noise].max(initial=0.0) <= 0.05 * LR, name
            for j in zip(*np.nonzero(noise & (diff > 0.05 * LR))):
                print(f"{name}{list(map(int, j))}: param diff "
                      f"{diff[j] / LR:.4f} x lr; gradients by step, "
                      f"reference " + ", ".join(
                          f"{r[mk][j]:.4e} (leaf max "
                          f"{np.abs(r[mk]).max():.4e})" for r in ref_g)
                      + "; port " + ", ".join(
                          f"{p[mk][j]:.4e}" for p in port_g))
        elif name != ".step":
            assert np.abs(g - w).max() <= 5e-5 * np.abs(w).max(), name


@pytest.mark.parametrize("case", ["zamba2-7b", "whisper-base"])
def test_remat_full_equals_none(case):
    """Recomputing each unit (a zamba mamba layer or shared-block site; a
    whisper encoder or decoder layer) in the backward gives the same loss
    and gradients, bit for bit."""
    _, cfg = _cfgs(case)
    state = init_state(0, cfg, device="cpu")
    batch = _batch(4, cfg, case)
    outs = [make_train_step(cfg, dataclasses.replace(PCFG, remat=r),
                            lr=LR)(state, batch) for r in ("full", "none")]
    (s1, m1), (s2, m2) = outs
    assert float(m1["loss"]) == float(m2["loss"])
    assert float(m1["grad_norm"]) == float(m2["grad_norm"])
    for a, b in zip(cm.leaves(s1.params), cm.leaves(s2.params)):
        assert torch.equal(a, b)


def test_bf16_step_keeps_ssm_leaves_float32():
    """A bf16 config trains float32 master weights: every param, gradient
    moment and update stays float32, the SSM leaves (A_log, D, dt_bias,
    norm) included, and the step's loss is finite."""
    _, cfg = _cfgs("zamba2-7b", "bfloat16")
    state = init_state(0, cfg, device="cpu")
    state, m = make_train_step(cfg, PCFG, lr=LR)(
        state, _batch(5, cfg, "zamba2-7b"))
    assert np.isfinite(float(m["loss"]))
    for part in (state.params, state.opt.m, state.opt.v):
        flat = cm.flatten_paths(part)
        assert all(v.dtype == torch.float32 for v in flat.values())
        for leaf in ("A_log", "D", "dt_bias", "norm"):
            assert f"layers.mamba.{leaf}" in flat
    assert float(state.opt.v["layers"]["mamba"]["A_log"].abs().max()) > 0


def test_hybrid_checkpoint_roundtrip_exact(tmp_path):
    """A trained hybrid state (the shared block's leaves, the float32 SSM
    leaves, m and v) saved and restored bit for bit; the restored state's
    next step equals the uninterrupted one's."""
    _, cfg = _cfgs("zamba2-7b")
    step = make_train_step(cfg, PCFG, lr=LR)
    state, _ = step(init_state(0, cfg, device="cpu"),
                    _batch(6, cfg, "zamba2-7b"))
    ckpt.save(state, 1, str(tmp_path))
    restored = ckpt.restore(init_state(1, cfg, device="cpu"), str(tmp_path))
    got, want = ckpt._flatten(restored), ckpt._flatten(state)
    assert got.keys() == want.keys()
    assert any(k.startswith(".params/shared/") for k in want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k
    batch = _batch(7, cfg, "zamba2-7b")
    (a, ma), (b, mb) = step(state, batch), step(restored, batch)
    assert float(ma["loss"]) == float(mb["loss"])
    for x, y in zip(cm.leaves(a.params), cm.leaves(b.params)):
        assert torch.equal(x, y)


def test_launcher_trains_hybrid_on_cpu(capsys):
    rc = launch_train.main(["--arch", "zamba2-7b", "--smoke", "--steps",
                            "2", "--batch", "2", "--seq", "16", "--device",
                            "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "arch=zamba2-7b-smoke" in out and "final loss" in out


def test_launcher_encdec_needs_frames(monkeypatch):
    """The launcher's `SyntheticLM` draws tokens only, as the reference's
    does: whisper-base stops at the missing frame embeddings in both
    packages (training it goes through `make_batch`)."""
    args = ["--arch", "whisper-base", "--smoke", "--steps", "1", "--batch",
            "2", "--seq", "8"]
    with pytest.raises(KeyError, match="enc_embed"):
        launch_train.main(args + ["--device", "cpu"])
    monkeypatch.setattr("sys.argv", ["train"] + args)
    with pytest.raises(KeyError, match="enc_embed"):
        ref_launch_train.main()
