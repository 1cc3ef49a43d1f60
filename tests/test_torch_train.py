"""The port's training path against the reference, same numpy inputs:
losses, clip, AdamW and the schedule; `make_train_step` on the reduced
tinyllama-1.1b and qwen3-0.6b (qk_norm, tied embeddings) in float32 with
attn_impl "pallas" (the reference's interpret-mode kernels against the
port's plain versions of its CUDA kernels), the reference's state carried
over by `convert.state_from_reference`; microbatch accumulation and
remat; the loop's watchdog and NaN guard; `Prefetcher`; the launcher.

Tolerances (float32; sums and reductions run in another order in the two
frameworks): losses, norms and the schedule rtol 1e-6; one AdamW update
rtol 1e-6 (the reference's operation order); after two train steps, loss
and grad norm rtol 1e-5, m and v within 5e-5 of each leaf's max |value|,
params within 0.05 x lr absolute — Adam's first steps divide each
gradient element by its own magnitude, so an element whose gradient is
near 0 moves by up to lr on a rounding difference."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ParallelConfig as RefPCfg  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduce_config as ref_reduce  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train import losses as RL  # noqa: E402
from repro.train import optimizer as ROpt  # noqa: E402
from repro.train.step import init_state as ref_init_state  # noqa: E402
from repro.train.step import make_train_step as ref_make_step  # noqa: E402
from repro_torch.configs import (ParallelConfig, get_config,  # noqa: E402
                                 reduce_config)
from repro_torch.convert import (params_from_reference,  # noqa: E402
                                 state_from_reference)
from repro_torch.data.pipeline import Prefetcher, SyntheticLM  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import losses as L  # noqa: E402
from repro_torch.train import optimizer as Opt  # noqa: E402
from repro_torch.train.loop import (LoopConfig, StragglerWatchdog,  # noqa: E402
                                    train)
from repro_torch.train.step import init_state, make_train_step  # noqa: E402

PCFG = ParallelConfig(attn_impl="pallas", moe_impl="dense", remat="full")
LR = 1e-3


def _cfgs(arch, dtype="float32"):
    ref = dataclasses.replace(ref_reduce(ref_get_config(arch)), dtype=dtype)
    port = dataclasses.replace(reduce_config(get_config(arch)), dtype=dtype)
    return ref, port


def _ref_state(rcfg, seed=0):
    return ref_init_state(jax.random.PRNGKey(seed), rcfg)


def _flat(state):
    return {k: np.asarray(v) for k, v in ref_ckpt._flatten(state).items()}


def _batch(seed, cfg, b=4, s=32):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                               dtype=np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, 1)}


def _rel(got, want):
    got, want = float(got), float(want)
    return abs(got - want) / max(abs(want), 1e-30)


# ----------------------------------------------------------------------------
# losses, clip, optimizer, schedule
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_softmax_xent_matches_reference(z_loss):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 7, 13), dtype=np.float32) * 3
    labels = rng.integers(0, 13, (4, 7), dtype=np.int32)
    want = np.asarray(RL.softmax_xent(jnp.asarray(logits),
                                      jnp.asarray(labels), z_loss))
    got = L.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                         z_loss).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("chunk", [8, 16, 32, 12])
def test_chunked_lm_loss_matches_reference(chunk):
    """Chunked (and, at chunk 12, the s % c != 0 full-logits fallback)
    loss of the same params and hidden states, values and grads."""
    rcfg, cfg = _cfgs("qwen3-0.6b")
    rparams = RT.init(jax.random.PRNGKey(0), rcfg)
    params = params_from_reference(
        {k: np.asarray(v)
         for k, v in ref_common.flatten_paths(rparams).items()}, cfg)
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((2, 32, cfg.d_model), dtype=np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 32), dtype=np.int32)
    want, want_g = jax.value_and_grad(
        lambda h: RL.chunked_lm_loss(rparams, h, jnp.asarray(labels), rcfg,
                                     chunk=chunk))(jnp.asarray(hidden))
    h = torch.from_numpy(hidden).requires_grad_()
    got = L.chunked_lm_loss(params, h, torch.from_numpy(labels), cfg,
                            chunk=chunk)
    got_g, = torch.autograd.grad(got, h)
    assert _rel(got.detach(), want) < 1e-6
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-6 * float(np.abs(want_g).max()))


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(2)
    tree = {"b": {"x": rng.standard_normal((5, 3), dtype=np.float32)},
            "a": rng.standard_normal((10,), dtype=np.float32) * 3}
    ttree = cm.map_tree(torch.from_numpy, tree)
    jtree = jax.tree.map(jnp.asarray, tree)
    assert _rel(L.global_norm(ttree), RL.global_norm(jtree)) < 1e-6
    for max_norm in (1.0, 1e9):
        got, gn = L.clip_by_global_norm(ttree, max_norm)
        want, wn = RL.clip_by_global_norm(jtree, max_norm)
        assert _rel(gn, wn) < 1e-6
        for g, w in zip(cm.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    same, _ = L.clip_by_global_norm(ttree, 1e9)
    assert torch.equal(same["a"], ttree["a"])


@pytest.mark.parametrize("step,wd", [(0, 0.1), (5, 0.1), (3, 0.0)])
def test_adamw_update_matches_reference(step, wd):
    rng = np.random.default_rng(step)
    shapes = {"w": (4, 6), "n": {"s": (6,)}}
    mk = lambda scale=1.0: jax.tree.map(  # noqa: E731
        lambda sh: rng.standard_normal(sh, dtype=np.float32) * scale,
        shapes, is_leaf=lambda x: isinstance(x, tuple))
    params, grads, m = mk(), mk(), mk(0.1)
    v = jax.tree.map(np.abs, mk(0.01))
    acfg = ROpt.AdamWConfig(weight_decay=wd)
    jt = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    tt = lambda t: cm.map_tree(torch.from_numpy, t)  # noqa: E731
    wp, ws = ROpt.adamw_update(jt(grads), ROpt.AdamWState(jt(m), jt(v)),
                               jt(params), jnp.float32(3e-4),
                               jnp.int32(step), acfg)
    gp, gs = Opt.adamw_update(tt(grads), Opt.AdamWState(tt(m), tt(v)),
                              tt(params), torch.tensor(3e-4),
                              torch.tensor(step, dtype=torch.int32),
                              Opt.AdamWConfig(weight_decay=wd))
    for got, want in ((gp, wp), (gs.m, ws.m), (gs.v, ws.v)):
        for g, w in zip(cm.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-12)


def test_adamw_init_zeros():
    params = {"w": torch.ones((3, 2)), "b": {"c": torch.ones((2,))}}
    st = Opt.adamw_init(params)
    for t in cm.leaves(st.m) + cm.leaves(st.v):
        assert t.dtype == torch.float32 and not t.any()


def test_warmup_cosine_matches_reference():
    want = ROpt.warmup_cosine(1e-3, warmup=10, total=100, floor=0.1)
    got = Opt.warmup_cosine(1e-3, warmup=10, total=100, floor=0.1)
    for s in (0, 1, 9, 10, 11, 50, 99, 100, 150):
        w = float(want(jnp.int32(s)))
        assert _rel(got(torch.tensor(s, dtype=torch.int32)), w) < 1e-6
        assert _rel(got(s), w) < 1e-6


# ----------------------------------------------------------------------------
# the train step against the reference
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-0.6b"])
def test_train_step_matches_reference(arch):
    """Two steps from the reference's own initial state: loss, grad norm
    and lr each step; params, m and v after both."""
    rcfg, cfg = _cfgs(arch)
    rstate = _ref_state(rcfg)
    state = state_from_reference(_flat(rstate), cfg)
    rstep = jax.jit(ref_make_step(
        rcfg, RefPCfg(attn_impl="pallas", moe_impl="dense", remat="full"),
        lr=LR, warmup=2, total=10))
    step = make_train_step(cfg, PCFG, lr=LR, warmup=2, total=10)
    for i in range(2):
        batch = _batch(i, cfg)
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, batch)
        assert _rel(m["loss"], rm["loss"]) < 1e-5
        assert _rel(m["grad_norm"], rm["grad_norm"]) < 1e-5
        assert _rel(m["lr"], rm["lr"]) < 1e-7
    assert int(state.step) == int(rstate.step) == 2
    got, want = ckpt._flatten(state), _flat(rstate)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name.startswith(".params/"):
            assert np.abs(g - w).max() <= 0.05 * LR, name
        elif name != ".step":
            assert np.abs(g - w).max() <= 5e-5 * np.abs(w).max(), name


def test_microbatch_accumulation_equals_full_batch():
    _, cfg = _cfgs("tinyllama-1.1b")
    state = init_state(0, cfg, device="cpu")
    batch = _batch(3, cfg, b=8, s=16)
    s1, m1 = make_train_step(cfg, PCFG, lr=LR)(state, batch)
    s2, m2 = make_train_step(cfg, PCFG, lr=LR, microbatch=2)(state, batch)
    assert _rel(m2["loss"], m1["loss"]) < 1e-6
    assert _rel(m2["grad_norm"], m1["grad_norm"]) < 1e-5
    for a, b in zip(cm.leaves(s1.params), cm.leaves(s2.params)):
        assert float((a - b).abs().max()) <= 0.05 * LR
    with pytest.raises(ValueError, match="does not divide"):
        make_train_step(cfg, PCFG, microbatch=3)(state, batch)


def test_remat_full_equals_none():
    """Recomputing each layer (and each loss chunk) in the backward gives
    the same loss and gradients, bit for bit."""
    _, cfg = _cfgs("qwen3-0.6b")
    state = init_state(0, cfg, device="cpu")
    batch = _batch(4, cfg)
    outs = [make_train_step(cfg, dataclasses.replace(PCFG, remat=r),
                            lr=LR)(state, batch) for r in ("full", "none")]
    (s1, m1), (s2, m2) = outs
    assert float(m1["loss"]) == float(m2["loss"])
    assert float(m1["grad_norm"]) == float(m2["grad_norm"])
    for a, b in zip(cm.leaves(s1.params), cm.leaves(s2.params)):
        assert torch.equal(a, b)


def test_mesh_raises():
    """A mesh with 'data' or 'model' > 1 builds the sharded step (FSDP,
    TP; trained in tests/test_torch_train_mesh*.py): its ``MeshContext``
    holds the params' specs and cuts the batch over ('pod', 'data').
    Without a process group (a `MeshShape`: no ranks) it raises."""
    import torch_dist
    from repro_torch.launch.mesh import make_test_mesh
    _, cfg = _cfgs("tinyllama-1.1b")
    with pytest.raises(ValueError, match="no process group"):
        make_train_step(cfg, PCFG, mesh=make_test_mesh((2, 2)))
    with torch_dist.fake_mesh((2, 2), 0) as mesh:
        step = make_train_step(cfg, PCFG, mesh=mesh)
        assert step.ctx.sizes == {"data": 2, "model": 2}
        assert step.ctx.batch_axes == ("data",)
        assert step.ctx.spec("layers.attn.wq") == (None, "data", "model")


def test_forward_remat_keeps_serving_path():
    """Under inference_mode (serving) remat does nothing: the same hidden
    states as remat="none"."""
    _, cfg = _cfgs("tinyllama-1.1b")
    params = PT.init(0, cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(_batch(0, cfg)["tokens"])}
    with torch.inference_mode():
        a, _ = PT.forward(params, batch, cfg, PCFG)
        b, _ = PT.forward(params, batch, cfg,
                          dataclasses.replace(PCFG, remat="none"))
    assert torch.equal(a, b)


# ----------------------------------------------------------------------------
# loop, data, launcher
# ----------------------------------------------------------------------------


def test_straggler_watchdog_with_fake_clock():
    ticks = iter([0.0, 1.0, 1.0, 2.1, 2.1, 7.1])
    wd = StragglerWatchdog(factor=2.0, alpha=0.5, clock=lambda: next(ticks))
    slow = []
    for step in range(3):
        t0 = wd.clock()
        slow.append(wd.observe(step, wd.clock() - t0))
    assert slow == [False, False, True]        # 5.0 s > 2 x EWMA 1.05
    assert wd.events == [(2, pytest.approx(5.0), pytest.approx(1.05))]


def test_nan_guard_in_loop():
    class Data:
        def batch(self, step):
            return {"x": np.zeros(1)}

    class State:
        step = torch.tensor(0)

    def bad_step(state, batch):
        return state, {"loss": torch.tensor(float("nan"))}

    with pytest.raises(FloatingPointError, match="step 0"):
        train(State(), bad_step, Data(), LoopConfig(total_steps=3),
              log=lambda _: None)


def test_loop_trains_and_checkpoints(tmp_path):
    _, cfg = _cfgs("tinyllama-1.1b")
    state = init_state(0, cfg, device="cpu")
    data = SyntheticLM(cfg.vocab_size, 16, 4)
    lines = []
    state, hist = train(state, make_train_step(cfg, PCFG, lr=LR), data,
                        LoopConfig(total_steps=4, ckpt_dir=str(tmp_path),
                                   ckpt_every=2, log_every=1),
                        log=lines.append)
    assert int(state.step) == 4 and len(hist["losses"]) == 4
    assert len(hist["step_s"]) == 4 and all(np.isfinite(hist["losses"]))
    assert len(lines) == 4 and ckpt.latest_step(str(tmp_path)) == 4


def test_prefetcher_order_transform_and_close():
    src = SyntheticLM(64, 8, 2, seed=3)
    pf = Prefetcher(src, start_step=5, depth=2,
                    transform=lambda b: {k: torch.from_numpy(v)
                                         for k, v in b.items()})
    try:
        for want_step in range(5, 9):
            step, item = pf.next()
            assert step == want_step
            np.testing.assert_array_equal(item["tokens"].numpy(),
                                          src.batch(step)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_launcher_smoke_on_cpu(capsys):
    rc = launch_train.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps",
                            "3", "--batch", "4", "--seq", "16", "--device",
                            "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and "final loss" in out
    assert launch_train.PCFG.attn_impl == "pallas"
    assert launch_train.PCFG.remat == "full"


def test_launcher_distributed_raises(monkeypatch):
    """--distributed outside torchrun (no RANK, WORLD_SIZE, ...) raises;
    under torchrun it trains (tests/test_torch_train_pod.py)."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        launch_train.main(["--arch", "tinyllama-1.1b", "--smoke",
                           "--distributed", "--device", "cpu"])


def test_launcher_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "tinyllama-1.1b", "--smoke",
                           "--steps", "1"])
