"""The port's RWKV6 (the ssm family, `models/rwkv6.py`) against the
reference on the reduced rwkv6-3b (d 64, 2 heads of 32, 2 layers, chunk
16), the reference's params carried over by
`convert.params_from_reference`: init; `wkv_sequential` and
`wkv_chunked` with a nonzero initial state; `forward` under attn_impl
"chunked" and "pallas" (the reference's interpret-mode WKV6 kernel
against the port's plain version of its CUDA kernel); `prefill` and two
`decode` steps (caches, last hidden state, logits); greedy
`Engine.generate` tokens; two train steps from the reference's state
(`convert.state_from_reference`); the train and serve launchers.

Tolerances: the WKV cores 1e-5 x max |ref| (float32; only the order of
sums differs).  Float32 configs: logits, hidden states and caches to
1e-4 absolute (these comparisons come to at most 8.7e-6, max |logit|
4.4).  bf16 configs: bf16 rounds at other places in the two frameworks
(dot accumulation, tanh/silu/sigmoid), so each quantity is held to the
larger of 1.5 x the reference's own gap between its chunked (or
Pallas) and its sequential WKV path on the same input, and two bf16
ulps (2^-7 of max |ref|) per layer.  Readings on the CPU: `forward`'s
logits 0.160 from the reference (max |logit| 4.44; the reference's own
gap 0.129, so 0.193 allowed), its hidden states 0.109 (gap 0.127);
prefill and decode, where both paths are one (the 20-token prompt, gap
0), at most 1.3 ulps per layer (the last hidden state 0.051 of max
2.48).  Greedy tokens: exact (float32).  Train steps: as
`test_torch_train.py` (loss and grad norm rtol 1e-5; m and v within
5e-5 of each leaf's max |value|; params within 0.05 x lr)."""
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
from repro.models import rwkv6 as RW  # noqa: E402
from repro.models.transformer import logits_fn as ref_logits  # noqa: E402
from repro.serve.engine import Engine as RefEngine  # noqa: E402
from repro.serve.engine import ServeConfig as RefServeConfig  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train.step import init_state as ref_init_state  # noqa: E402
from repro.train.step import make_train_step as ref_make_step  # noqa: E402
from repro_torch import models as port_models  # noqa: E402
from repro_torch.configs import (ParallelConfig, get_config,  # noqa: E402
                                 reduce_config)
from repro_torch.configs.base import _param_shapes  # noqa: E402
from repro_torch.convert import (params_from_reference,  # noqa: E402
                                 state_from_reference)
from repro_torch.kernels.wkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import rwkv6 as PW  # noqa: E402
from repro_torch.models.transformer import logits_fn  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

ARCH = "rwkv6-3b"
B, S = 2, 32
LR = 1e-3


def _cfgs(dtype):
    ref = dataclasses.replace(ref_reduce(ref_get_config(ARCH)), dtype=dtype)
    port = dataclasses.replace(reduce_config(get_config(ARCH)), dtype=dtype)
    return ref, port


def _tol(cfg, want, seq):
    """Float32: 1e-4.  bf16: 1.5 x the gap between the reference's output
    `want` and `seq`, the same from its sequential WKV path, at least two
    bf16 ulps of max |want| per layer."""
    if cfg.dtype == "float32":
        return 1e-4
    return max(1.5 * float(np.abs(want - seq).max()),
               2 * cfg.n_layers * 2.0 ** -7 * float(np.abs(want).max()))


def _ref_sequential(mp):
    """Patch (`mp`, a monkeypatch context) the reference's chunked WKV to
    its sequential one: the reference's own second path."""
    mp.setattr(RW, "wkv_chunked", lambda r, k, v, logw, u, state, chunk=0:
               RW.wkv_sequential(r, k, v, logw, u, state))


def _pcfgs(impl, remat="none"):
    return (RefPCfg(attn_impl=impl, moe_impl="dense", remat=remat),
            ParallelConfig(attn_impl=impl, moe_impl="dense", remat=remat))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    """(reference cfg, port cfg, reference params, port params)."""
    rcfg, cfg = _cfgs(request.param)
    rparams = RW.init(jax.random.PRNGKey(0), rcfg)
    flat = {k: np.asarray(v)
            for k, v in ref_common.flatten_paths(rparams).items()}
    return rcfg, cfg, rparams, params_from_reference(flat, cfg)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max abs {err} > {tol}"


def _tokens(cfg, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


# ----------------------------------------------------------------------------
# init and the WKV cores
# ----------------------------------------------------------------------------


def test_init_shapes_and_constants():
    rcfg, cfg = _cfgs("float32")
    params = PW.init(0, cfg, device="cpu")
    flat = cm.flatten_paths(params)
    shapes = _param_shapes(cfg)
    assert {k: tuple(v.shape) for k, v in flat.items()} == shapes
    want = ref_common.flatten_paths(RW.init(jax.random.PRNGKey(0), rcfg))
    for name in ("layers.tmix.mu", "layers.tmix.bonus", "layers.cmix.mu",
                 "layers.tmix.ln_x", "layers.norm1", "final_norm.scale"):
        np.testing.assert_array_equal(flat[name].numpy(),
                                      np.asarray(want[name]))
    assert port_models.get_model(cfg) is PW
    # the serving cast keeps the bonus and the norms float32
    cast = cm.flatten_paths(cm.cast_weights(params, _cfgs("bfloat16")[1]))
    assert cast["layers.tmix.bonus"].dtype == torch.float32
    assert cast["layers.tmix.ln_x"].dtype == torch.float32
    assert cast["layers.tmix.mu"].dtype == torch.bfloat16


def _wkv_inputs(seed, b=2, s=32, h=2, hd=16):
    rng = np.random.default_rng(seed)
    r, k, v, n = (rng.standard_normal((b, s, h, hd), dtype=np.float32)
                  for _ in range(4))
    u = rng.standard_normal((h, hd), dtype=np.float32) * 0.5
    st = rng.standard_normal((b, h, hd, hd), dtype=np.float32)
    return r, k, v, -np.exp(n - 2.0), u, st


@pytest.mark.parametrize("chunk", [8, 16, 32, 12])
def test_wkv_cores_match_reference(chunk):
    """Both cores from a nonzero initial state; at chunk 12 (32 % 12 != 0)
    the chunked core falls back to the sequential one, as the reference."""
    arrays = _wkv_inputs(chunk)
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    for name, want, got in (
            ("sequential", RW.wkv_sequential(*j), PW.wkv_sequential(*t)),
            ("chunked", RW.wkv_chunked(*j, chunk=chunk),
             PW.wkv_chunked(*t, chunk=chunk))):
        for what, g, w in zip(("state", "y"), got, want):
            w = np.asarray(w)
            _close(g, w, 1e-5 * float(np.abs(w).max()), f"{name} {what}")


def test_sequential_promotes_bf16_as_jax():
    """The chunked core's fall-back hands bf16 r, k, v to the sequential
    one: y and the state come back float32, as JAX promotes them."""
    r, k, v, logw, u, st = _wkv_inputs(1, s=12)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    want = RW.wkv_sequential(bf(r), bf(k), bf(v), jnp.asarray(logw),
                             jnp.asarray(u), jnp.asarray(st))
    tb = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    got = PW.wkv_sequential(tb(r), tb(k), tb(v), torch.from_numpy(logw),
                            torch.from_numpy(u), torch.from_numpy(st))
    for what, g, w in zip(("state", "y"), got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        _close(g, np.asarray(w), 1e-5 * float(np.abs(w).max()), what)


# ----------------------------------------------------------------------------
# forward, prefill, decode
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_forward_matches_reference(model, impl, monkeypatch):
    rcfg, cfg, rparams, params = model
    rpcfg, pcfg = _pcfgs(impl, remat="full")
    calls = []
    real = wkv_ops.wkv6
    monkeypatch.setattr(wkv_ops, "wkv6",
                        lambda *a: calls.append(1) or real(*a))
    tokens = _tokens(cfg, 1)
    rh, raux = RW.forward(rparams, {"tokens": jnp.asarray(tokens)}, rcfg,
                          rpcfg)
    with monkeypatch.context() as mp:
        _ref_sequential(mp)
        sh, _ = RW.forward(rparams, {"tokens": jnp.asarray(tokens)}, rcfg,
                           _pcfgs("chunked", remat="full")[0])
    with torch.no_grad():
        h, aux = PW.forward(params, {"tokens": torch.from_numpy(tokens)},
                            cfg, pcfg)
    assert h.dtype == cm.compute_dtype(cfg) and float(aux["aux_loss"]) == 0
    _close(h, _np(rh), _tol(cfg, _np(rh), _np(sh)), "hidden")
    rlg = _np(ref_logits(rparams, rh, rcfg))
    _close(logits_fn(params, h, cfg), rlg,
           _tol(cfg, rlg, _np(ref_logits(rparams, sh, rcfg))), "logits")
    # "pallas" runs the WKV6 Function once per layer (S % 16 == 0)
    assert len(calls) == (cfg.n_layers if impl == "pallas" else 0)


def _ref_prefill_decode(rcfg, rparams, tokens, prompt):
    """The reference's prefill of `prompt` tokens and two decode steps:
    {"prefill last hidden", "decode t logits", "cache key"} and its final
    cache."""
    rpcfg = _pcfgs("chunked")[0]
    rcache = RW.init_cache(rcfg, B, 64, rpcfg)
    rcache, rlast = RW.prefill(rparams,
                               {"tokens": jnp.asarray(tokens[:, :prompt])},
                               rcache, rcfg, rpcfg)
    out = {"prefill last hidden": _np(rlast)}
    for t in range(2):
        step = tokens[:, prompt + t:prompt + t + 1]
        rcache, rlg = RW.decode(rparams, jnp.asarray(step), rcache, rcfg,
                                rpcfg)
        out[f"decode {t} logits"] = _np(rlg)
    for key in ("wkv", "tmix_x", "cmix_x"):
        out[f"cache {key}"] = _np(rcache[key])
    return out, rcache


@pytest.mark.parametrize("prompt", [8, 20])
def test_prefill_decode_match_reference(model, prompt, monkeypatch):
    """Prefill (chunked; at 20 tokens the sequential fall-back) from a zero
    cache, then two decode steps (sequential)."""
    rcfg, cfg, rparams, params = model
    pcfg = _pcfgs("chunked")[1]
    tokens = _tokens(cfg, 2, (B, prompt + 2))
    want, rcache = _ref_prefill_decode(rcfg, rparams, tokens, prompt)
    with monkeypatch.context() as mp:
        _ref_sequential(mp)
        seq, _ = _ref_prefill_decode(rcfg, rparams, tokens, prompt)
    got = {}
    cache = PW.init_cache(cfg, B, 64, pcfg, device="cpu")
    with torch.inference_mode():
        cache, got["prefill last hidden"] = PW.prefill(
            params, {"tokens": torch.from_numpy(tokens[:, :prompt])}, cache,
            cfg, pcfg)
        for t in range(2):
            step = tokens[:, prompt + t:prompt + t + 1]
            cache, lg = PW.decode(params, torch.from_numpy(step), cache, cfg,
                                  pcfg)
            assert lg.dtype == torch.float32
            got[f"decode {t} logits"] = lg
    assert cache["pos"] == int(rcache["pos"]) == prompt + 2
    np.testing.assert_array_equal(cache["lengths"].numpy(),
                                  np.asarray(rcache["lengths"]))
    for key in ("wkv", "tmix_x", "cmix_x"):
        assert cache[key].dtype == torch.float32
        got[f"cache {key}"] = cache[key]
    for what, w in want.items():
        _close(got[what], w, _tol(cfg, w, seq[what]), what)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_engine_greedy_tokens_equal(impl):
    """Greedy generation through both engines (float32): the same tokens,
    exactly.  ("pallas" serves through the chunked and sequential paths,
    as the reference's prefill and decode never reach the kernel.)"""
    rcfg, cfg = _cfgs("float32")
    rparams = RW.init(jax.random.PRNGKey(3), rcfg)
    params = params_from_reference(
        {k: np.asarray(v)
         for k, v in ref_common.flatten_paths(rparams).items()}, cfg)
    rpcfg, pcfg = _pcfgs(impl)
    prompt = _tokens(cfg, 4, (4, 16))
    want = RefEngine(rcfg, rpcfg, RefServeConfig(max_seq=64), rparams
                     ).generate({"tokens": jnp.asarray(prompt)}, 12)
    got = Engine(cfg, pcfg, ServeConfig(max_seq=64), params, device="cpu"
                 ).generate({"tokens": prompt}, 12)
    assert got.dtype == torch.int32 and got.shape == (4, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------------
# training
# ----------------------------------------------------------------------------


def _rel(got, want):
    got, want = float(got), float(want)
    return abs(got - want) / max(abs(want), 1e-30)


def test_train_steps_match_reference():
    """Two steps from the reference's own initial state (float32, attn_impl
    "pallas", remat "full": the WKV6 Function forward, its gradient
    through the chunked path)."""
    rcfg, cfg = _cfgs("float32")
    rstate = ref_init_state(jax.random.PRNGKey(0), rcfg)
    flat = {k: np.asarray(v) for k, v in ref_ckpt._flatten(rstate).items()}
    state = state_from_reference(flat, cfg)
    rpcfg, pcfg = _pcfgs("pallas", remat="full")
    rstep = jax.jit(ref_make_step(rcfg, rpcfg, lr=LR, warmup=2, total=10))
    step = make_train_step(cfg, pcfg, lr=LR, warmup=2, total=10)
    for i in range(2):
        tok = _tokens(cfg, 10 + i, (4, S))
        batch = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, batch)
        assert _rel(m["loss"], rm["loss"]) < 1e-5
        assert _rel(m["grad_norm"], rm["grad_norm"]) < 1e-5
    got, want = ckpt._flatten(state), {
        k: np.asarray(v) for k, v in ref_ckpt._flatten(rstate).items()}
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name.startswith(".params/"):
            assert np.abs(g - w).max() <= 0.05 * LR, name
        elif name != ".step":
            assert np.abs(g - w).max() <= 5e-5 * np.abs(w).max(), name


def test_remat_full_equals_none():
    """Recomputing each layer in the backward (and the WKV6 Function's
    forward with it) gives the same loss and gradients, bit for bit."""
    _, cfg = _cfgs("float32")
    params = PW.init(0, cfg, device="cpu")
    tok = torch.from_numpy(_tokens(cfg, 5))
    grads = []
    for remat in ("full", "none"):
        _, pcfg = _pcfgs("pallas", remat)
        flat = {k: v.detach().requires_grad_()
                for k, v in cm.flatten_paths(params).items()}
        h, _ = PW.forward(cm.unflatten_paths(flat), {"tokens": tok}, cfg,
                          pcfg)
        grads.append(torch.autograd.grad(
            h.square().sum(), list(flat.values()), allow_unused=True,
            materialize_grads=True))      # the head is not used here
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_launchers_run_on_cpu(capsys):
    assert launch_train.main(["--arch", ARCH, "--smoke", "--steps", "2",
                              "--batch", "2", "--seq", "32", "--device",
                              "cpu"]) == 0
    out = capsys.readouterr().out
    assert "arch=rwkv6-3b-smoke" in out and "final loss" in out
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--requests", "2",
                              "--prompt-len", "8", "--new-tokens", "4",
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "generated 8 tokens" in out
