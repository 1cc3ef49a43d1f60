"""The port's MoE family (`models/moe.py` and the transformer's MoE layer)
against the reference, with the reference's params carried over by
`convert.params_from_reference`: `route` on the same activations (top-k
ids equal, weights and aux loss within 1e-6), `_moe_dense`/`moe_ffn` on
the same routing (float32, within 1e-5 of max |out|), `capacity` on a
grid; the reduced granite-moe-3b-a800m and qwen3-moe-30b-a3b (qk-norm,
head dim 128 at full size) in float32: `forward` with its summed
`aux_loss`, prefill and decode logits with attn_impl chunked and pallas
on both sides (1e-3, the float32 logits tolerance of
test_torch_transformer.py: the bf16 KV cache can round one element
differently, more often where the two sides' attention differs), greedy
tokens through both `Engine`s, and two train steps
from the reference's state at test_torch_train.py's tolerances; the
launchers serve and train both archs on the CPU."""
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
from repro.models import moe as RM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
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
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"]
B, S, MAX_SEQ = 2, 8, 32
TOL = 1e-3
LR = 1e-3


def _cfgs(arch, dtype="float32"):
    ref = dataclasses.replace(ref_reduce(ref_get_config(arch)), dtype=dtype)
    port = dataclasses.replace(reduce_config(get_config(arch)), dtype=dtype)
    return ref, port


def _ref_params(rcfg, seed=0):
    rparams = RT.init(jax.random.PRNGKey(seed), rcfg)
    flat = {k: np.asarray(v)
            for k, v in ref_common.flatten_paths(rparams).items()}
    return rparams, flat


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what):
    got = got.float().numpy() if torch.is_tensor(got) else got
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max abs {err} > {tol}"


def _acts(seed, cfg, b=3, s=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
    w = rng.standard_normal((cfg.d_model, cfg.moe.n_experts),
                            dtype=np.float32) / np.sqrt(cfg.d_model)
    return x, w


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    rcfg, cfg = _cfgs(arch)
    x, w = _acts(0, cfg)
    rw, rids, raux = RM.route(jnp.asarray(x), jnp.asarray(w), rcfg)
    tw, tids, taux = PM.route(torch.from_numpy(x), torch.from_numpy(w), cfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(rids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(rw), rtol=0,
                               atol=1e-6)
    assert tw.dtype == torch.float32
    assert abs(float(taux) - float(raux)) <= 1e-6
    # renormalised: each token's k weights sum to one
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_and_ffn_match_reference(arch):
    rcfg, cfg = _cfgs(arch)
    rparams, flat = _ref_params(rcfg)
    params = params_from_reference(flat, cfg)
    x, _ = _acts(1, cfg)
    rp = jax.tree.map(lambda a: a[0], rparams["layers"]["moe"])
    pp = PT._layer(params, 0)["moe"]
    rw, rids, _ = RM.route(jnp.asarray(x), rp["router"], rcfg)
    want = np.asarray(RM._moe_dense(jnp.asarray(x), rw, rids, rp["experts"],
                                    rcfg))
    got = PM._moe_dense(torch.from_numpy(x),
                        torch.from_numpy(np.array(rw)),
                        torch.from_numpy(np.array(rids)).long(),
                        pp["experts"], cfg)
    tol = 1e-5 * float(np.abs(want).max())
    _close(got, want, tol, "_moe_dense")
    rpc = RefPCfg(moe_impl="dense")
    want_out, want_aux = RM.moe_ffn(jnp.asarray(x), rp, rcfg, rpc)
    out, aux = PM.moe_ffn(torch.from_numpy(x), pp, cfg,
                          ParallelConfig(moe_impl="shard_map"))
    _close(out, _np(want_out), tol, "moe_ffn")
    assert abs(float(aux) - float(want_aux)) <= 1e-6


@pytest.mark.parametrize("t", [1, 7, 64, 1000])
@pytest.mark.parametrize("k,e", [(2, 8), (8, 40), (8, 128)])
@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0])
def test_capacity_matches_reference(t, k, e, cf):
    assert PM.capacity(t, k, e, cf) == RM.capacity(t, k, e, cf)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_has_the_moe_leaves(arch):
    rcfg, cfg = _cfgs(arch)
    _, flat = _ref_params(rcfg)
    assert {k: v.shape for k, v in flat.items()} == _param_shapes(cfg)
    params = params_from_reference(flat, cfg)
    got = cm.flatten_paths(params)
    for k in ("layers.moe.router", "layers.moe.experts.w_gate",
              "layers.moe.experts.w_up", "layers.moe.experts.w_down"):
        np.testing.assert_array_equal(got[k].numpy(), flat[k])
    # the router stays float32 when the weights are cast for serving
    cast = cm.flatten_paths(cm.cast_weights(params, _cfgs(arch, "bfloat16")[1]))
    assert cast["layers.moe.router"].dtype == torch.float32
    assert cast["layers.moe.experts.w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch, impl):
    rcfg, cfg = _cfgs(arch)
    rpcfg = RefPCfg(attn_impl=impl, attn_chunk=4, moe_impl="dense",
                    remat="none")
    pcfg = ParallelConfig(attn_impl=impl, attn_chunk=4, moe_impl="dense",
                          remat="none")
    rparams, flat = _ref_params(rcfg)
    params = params_from_reference(flat, cfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    steps = rng.integers(0, cfg.vocab_size, (2, B, 1), dtype=np.int32)
    with torch.inference_mode():
        rh, raux = RT.forward(rparams, {"tokens": jnp.asarray(tokens)}, rcfg,
                              rpcfg)
        ph, aux = PT.forward(params, {"tokens": torch.from_numpy(tokens)},
                             cfg, pcfg)
        _close(PT.logits_fn(params, ph, cfg),
               _np(RT.logits_fn(rparams, rh, rcfg)), TOL, "forward logits")
        # the layers' load-balance losses, summed
        assert float(aux["aux_loss"]) > 0
        assert abs(float(aux["aux_loss"]) - float(raux["aux_loss"])) <= 1e-6

        rcache = RT.init_cache(rcfg, B, MAX_SEQ, rpcfg)
        rcache, rlast = RT.prefill(rparams, {"tokens": jnp.asarray(tokens)},
                                   rcache, rcfg, rpcfg)
        cache = PT.init_cache(cfg, B, MAX_SEQ, pcfg, device="cpu")
        cache, last = PT.prefill(params, {"tokens": torch.from_numpy(tokens)},
                                 cache, cfg, pcfg)
        _close(last, _np(rlast), TOL, "prefill last hidden")
        for t in range(2):
            rcache, rlogits = RT.decode(rparams, jnp.asarray(steps[t]),
                                        rcache, rcfg, rpcfg)
            cache, logits = PT.decode(params, torch.from_numpy(steps[t]),
                                      cache, cfg, pcfg)
            _close(logits, _np(rlogits), TOL, f"decode {t} logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference(arch):
    rcfg, cfg = _cfgs(arch)
    rparams, flat = _ref_params(rcfg, seed=2)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 6),
                                               dtype=np.int32)
    ref = RefEngine(rcfg, RefPCfg(attn_impl="pallas", moe_impl="dense",
                                  remat="none"),
                    RefServeConfig(max_seq=32), rparams)
    eng = Engine(cfg, ParallelConfig(attn_impl="pallas", moe_impl="dense",
                                     remat="none"),
                 ServeConfig(max_seq=32), params_from_reference(flat, cfg),
                 device="cpu")
    want = np.asarray(ref.generate({"tokens": jnp.asarray(prompt)}, 8))
    got = eng.generate({"tokens": prompt}, 8).numpy()
    np.testing.assert_array_equal(got, want)


def _flat(state):
    return {k: np.asarray(v) for k, v in ref_ckpt._flatten(state).items()}


def _rel(got, want):
    got, want = float(got), float(want)
    return abs(got - want) / max(abs(want), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """Two steps from the reference's initial state (remat "full"): loss
    (the aux loss included), grad norm and lr each step; params, m and v
    after both, at test_torch_train.py's tolerances."""
    rcfg, cfg = _cfgs(arch)
    rstate = ref_init_state(jax.random.PRNGKey(0), rcfg)
    state = state_from_reference(_flat(rstate), cfg)
    rstep = jax.jit(ref_make_step(
        rcfg, RefPCfg(attn_impl="pallas", moe_impl="dense", remat="full"),
        lr=LR, warmup=2, total=10))
    step = make_train_step(cfg, launch_train.PCFG, lr=LR, warmup=2,
                           total=10)
    for i in range(2):
        tok = np.random.default_rng(i).integers(0, cfg.vocab_size, (4, 32),
                                                dtype=np.int32)
        batch = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, batch)
        assert _rel(m["loss"], rm["loss"]) < 1e-5
        assert _rel(m["grad_norm"], rm["grad_norm"]) < 1e-5
        assert _rel(m["lr"], rm["lr"]) < 1e-7
    got, want = ckpt._flatten(state), _flat(rstate)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name.startswith(".params/"):
            assert np.abs(g - w).max() <= 0.05 * LR, name
        elif name != ".step":
            assert np.abs(g - w).max() <= 5e-5 * np.abs(w).max(), name


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_on_cpu(arch, capsys):
    assert port_models.get_model(get_config(arch)) is PT
    assert launch_serve.main(["--arch", arch, "--smoke", "--requests", "2",
                              "--prompt-len", "8", "--new-tokens", "4",
                              "--device", "cpu"]) == 0
    assert launch_train.main(["--arch", arch, "--smoke", "--steps", "2",
                              "--batch", "2", "--seq", "16", "--device",
                              "cpu"]) == 0
    out = capsys.readouterr().out
    assert "generated 8 tokens" in out and "final loss" in out
