"""The port's hybrid family (`models/zamba.py`: Mamba2 layers and one
shared attention block) against the reference, with the reference's
params carried over by `convert.params_from_reference`: the reduced
zamba2-7b at 2 layers (one group) and 3 (a group and a one-layer tail),
float32, attn_impl chunked and pallas (the reference's interpret-mode
kernels against the port's plain versions of its CUDA kernels): forward
hidden states, prefill's last hidden state and cache (conv and SSM
states, the shared block's K/V), two decode steps' logits, each within
1e-4 of max |ref| (the reference's own decode test bounds the same gap at
1e-4 absolute; the bf16 K/V within one bf16 ulp, 2^-7 of max |ref|, as
in test_torch_transformer.py); bf16 weights keep A_log, D and dt_bias in
float32; greedy tokens through both `Engine`s; the launcher on the
CPU."""
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
from repro.models import zamba as RZ  # noqa: E402
from repro.serve.engine import Engine as RefEngine  # noqa: E402
from repro.serve.engine import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch import models as port_models  # noqa: E402
from repro_torch.configs import (ParallelConfig, get_config,  # noqa: E402
                                 reduce_config)
from repro_torch.configs.base import _param_shapes  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import zamba as PZ  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

ARCH = "zamba2-7b"
B, S, MAX_SEQ = 2, 8, 16
RTOL = 1e-4
#: one bf16 ulp at max |ref|: the bf16 caches' bound
BF16_ULP = 2 ** -7


def _cfgs(n_layers=2, dtype="float32"):
    ref = dataclasses.replace(ref_reduce(ref_get_config(ARCH)), dtype=dtype,
                              n_layers=n_layers)
    port = dataclasses.replace(reduce_config(get_config(ARCH)), dtype=dtype,
                               n_layers=n_layers)
    return ref, port


def _params(rcfg, cfg):
    rparams = RZ.init(jax.random.PRNGKey(0), rcfg)
    flat = {k: np.asarray(v)
            for k, v in ref_common.flatten_paths(rparams).items()}
    return rparams, flat, params_from_reference(flat, cfg)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, what, rtol=RTOL):
    got = got.float().numpy() if torch.is_tensor(got) else got
    bound = rtol * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max abs {err} > {bound}"


def test_registered_and_params_carry_over():
    assert port_models.get_model(get_config(ARCH)) is PZ
    for n_layers in (2, 3):
        rcfg, cfg = _cfgs(n_layers)
        _, flat, params = _params(rcfg, cfg)
        assert {k: v.shape for k, v in flat.items()} == _param_shapes(cfg)
        for k, v in cm.flatten_paths(params).items():
            assert tuple(v.shape) == _param_shapes(cfg)[k], k


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("n_layers", [2, 3])
def test_forward_prefill_decode(n_layers, impl):
    rcfg, cfg = _cfgs(n_layers)
    rparams, _, params = _params(rcfg, cfg)
    rpcfg = RefPCfg(attn_impl=impl, remat="none")
    pcfg = ParallelConfig(attn_impl=impl, remat="none")
    batch = port_models.make_batch(0, cfg, B, S, "prefill")
    rbatch = {"tokens": jnp.asarray(batch["tokens"].numpy())}

    want, _ = RZ.forward(rparams, rbatch, rcfg, rpcfg)
    with torch.inference_mode():
        got, aux = PZ.forward(params, batch, cfg, pcfg)
    _close(got, _np(want), "forward")
    assert float(aux["aux_loss"]) == 0.0

    rcache = RZ.init_cache(rcfg, B, MAX_SEQ, rpcfg)
    rcache, rlast = RZ.prefill(rparams, rbatch, rcache, rcfg, rpcfg)
    with torch.inference_mode():
        cache = PZ.init_cache(cfg, B, MAX_SEQ, pcfg, device="cpu")
        cache, last = PZ.prefill(params, batch, cache, cfg, pcfg)
    _close(last, _np(rlast), "prefill last hidden")
    assert cache["pos"] == S and cache["lengths"].tolist() == [S] * B
    for key in ("conv", "ssm"):
        _close(cache[key], _np(rcache[key]), f"prefill cache {key}")
    for key in ("k", "v"):
        _close(cache[key], _np(rcache[key]), f"prefill cache {key}",
               rtol=BF16_ULP)
    assert cache["k"].dtype == torch.bfloat16
    assert cache["conv"].dtype == cache["ssm"].dtype == torch.float32

    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, B, 1),
                                             dtype=np.int32)
    for t in range(2):
        rcache, rlogits = RZ.decode(rparams, jnp.asarray(toks[t]), rcache,
                                    rcfg, rpcfg)
        with torch.inference_mode():
            cache, logits = PZ.decode(params, torch.from_numpy(toks[t]),
                                      cache, cfg, pcfg)
        _close(logits, _np(rlogits), f"decode step {t} logits")
    for key in ("conv", "ssm"):
        _close(cache[key], _np(rcache[key]), f"decode cache {key}")


def test_bf16_keeps_the_ssm_leaves_float32():
    """`cast_weights` rounds the projections and the conv to bf16 and
    keeps A_log, D and dt_bias float32, as the reference reads them; the
    bf16 forward then stays within 5e-2 of max |ref| of the reference's
    (the transformer tests' bf16 bound)."""
    rcfg, cfg = _cfgs(3, "bfloat16")
    rparams, _, params = _params(rcfg, cfg)
    cast = cm.cast_weights(params, cfg)
    mamba = cast["layers"]["mamba"]
    for leaf in ("A_log", "D", "dt_bias", "norm"):
        assert mamba[leaf].dtype == torch.float32, leaf
        assert torch.equal(mamba[leaf], params["layers"]["mamba"][leaf])
    for leaf in ("w_in", "conv", "w_out"):
        assert mamba[leaf].dtype == torch.bfloat16, leaf
    batch = port_models.make_batch(0, cfg, B, S, "prefill")
    want, _ = RZ.forward(rparams, {"tokens": jnp.asarray(
        batch["tokens"].numpy())}, rcfg, RefPCfg(remat="none"))
    with torch.inference_mode():
        got, _ = PZ.forward(cast, batch, cfg, ParallelConfig(remat="none"))
    assert got.dtype == torch.bfloat16
    _close(got, _np(want), "bf16 forward", rtol=5e-2)


def test_engine_greedy_tokens_match_reference():
    rcfg, cfg = _cfgs(3)
    rparams, _, params = _params(rcfg, cfg)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S),
                                               dtype=np.int32)
    ref = RefEngine(rcfg, RefPCfg(attn_impl="pallas", remat="none"),
                    RefServeConfig(max_seq=32), rparams)
    eng = Engine(cfg, ParallelConfig(attn_impl="pallas", remat="none"),
                 ServeConfig(max_seq=32), params, device="cpu")
    want = np.asarray(ref.generate({"tokens": jnp.asarray(prompt)}, 8))
    got = eng.generate({"tokens": prompt}, 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_launcher_on_cpu(capsys):
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--requests", "2",
                              "--prompt-len", "8", "--new-tokens", "4",
                              "--device", "cpu"]) == 0
    assert "generated 8 tokens" in capsys.readouterr().out
