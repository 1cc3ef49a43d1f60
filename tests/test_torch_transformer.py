"""The port's dense transformer against the reference, with the
reference's params carried over by `convert.params_from_reference`:
`forward` (logits of its hidden states), `prefill` (the bf16 KV cache and
the last hidden state) and two `decode` steps' logits, for the reduced
tinyllama-1.1b and qwen3-0.6b (qk_norm, tied embeddings), each with
attn_impl naive, chunked (chunk 4, so the 8-token prompt takes the
diagonal-batched path) and pallas (the reference's interpret-mode kernels
against the port's plain versions of its CUDA kernels).

Tolerances: float32 configs, max abs 1e-3 on logits and hidden states
(the bf16 KV cache can round one element differently, which then moves
the decode logits); the configs' own bf16, 5e-2.  Cache entries: one
bf16 ulp (rtol 2^-7) in float32 configs, 5e-2 in bf16 ones."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import (ParallelConfig as RefPCfg,  # noqa: E402
                           get_config as ref_get_config,
                           reduce_config as ref_reduce)
from repro.models import common as ref_common  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch import models as port_models  # noqa: E402
from repro_torch.configs import (ParallelConfig, get_config,  # noqa: E402
                                 reduce_config)
from repro_torch.configs.base import _param_shapes  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

B, S, MAX_SEQ = 2, 8, 32


def _cfgs(arch, dtype):
    ref, port = ref_reduce(ref_get_config(arch)), reduce_config(
        get_config(arch))
    if dtype == "float32":
        ref = dataclasses.replace(ref, dtype="float32")
        port = dataclasses.replace(port, dtype="float32")
    return ref, port


def _tol(cfg):
    return 1e-3 if cfg.dtype == "float32" else 5e-2


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what):
    got = got.float().numpy() if torch.is_tensor(got) else got
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max abs {err} > {tol}"


@pytest.fixture(scope="module", params=["tinyllama-1.1b", "qwen3-0.6b"])
def arch(request):
    return request.param


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_forward_prefill_decode(arch, dtype, impl):
    rcfg, cfg = _cfgs(arch, dtype)
    rpcfg = RefPCfg(attn_impl=impl, attn_chunk=4, moe_impl="dense",
                    remat="none")
    pcfg = ParallelConfig(attn_impl=impl, attn_chunk=4, moe_impl="dense",
                          remat="none")
    rparams = RT.init(jax.random.PRNGKey(0), rcfg)
    flat = {k: np.asarray(v)
            for k, v in ref_common.flatten_paths(rparams).items()}
    params = params_from_reference(flat, cfg)
    tol = _tol(cfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    steps = rng.integers(0, cfg.vocab_size, (2, B, 1), dtype=np.int32)

    with torch.inference_mode():
        # forward
        rh, _ = RT.forward(rparams, {"tokens": jnp.asarray(tokens)}, rcfg,
                           rpcfg)
        ph, _ = PT.forward(params, {"tokens": torch.from_numpy(tokens)}, cfg,
                           pcfg)
        _close(PT.logits_fn(params, ph, cfg),
               _np(RT.logits_fn(rparams, rh, rcfg)), tol, "forward logits")

        # prefill
        rcache = RT.init_cache(rcfg, B, MAX_SEQ, rpcfg)
        rcache, rlast = RT.prefill(rparams, {"tokens": jnp.asarray(tokens)},
                                   rcache, rcfg, rpcfg)
        cache = PT.init_cache(cfg, B, MAX_SEQ, pcfg, device="cpu")
        cache, last = PT.prefill(params, {"tokens": torch.from_numpy(tokens)},
                                 cache, cfg, pcfg)
        _close(last, _np(rlast), tol, "prefill last hidden")
        assert cache["pos"] == int(rcache["pos"]) == S
        np.testing.assert_array_equal(cache["lengths"].numpy(),
                                      np.asarray(rcache["lengths"]))
        for key in ("k", "v"):
            assert cache[key].dtype == torch.bfloat16
            got, want = cache[key].float().numpy(), _np(rcache[key])
            if cfg.dtype == "float32":
                np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                           atol=1e-6)
            else:
                _close(got, want, tol, f"prefill cache {key}")

        # two decode steps
        for t in range(2):
            rcache, rlogits = RT.decode(rparams, jnp.asarray(steps[t]),
                                        rcache, rcfg, rpcfg)
            cache, logits = PT.decode(params, torch.from_numpy(steps[t]),
                                      cache, cfg, pcfg)
            assert logits.dtype == torch.float32
            assert logits.shape == (B, 1, cfg.vocab_size)
            _close(logits, _np(rlogits), tol, f"decode {t} logits")


def test_init_shapes_and_distributions():
    cfg = reduce_config(get_config("tinyllama-1.1b"))
    params = port_models.get_model(cfg).init(0, cfg, device="cpu")
    flat = cm.flatten_paths(params)
    assert {k: tuple(v.shape) for k, v in flat.items()} == _param_shapes(cfg)
    assert all(v.dtype == torch.float32 for v in flat.values())
    assert torch.equal(flat["layers.norm_attn"],
                       torch.ones_like(flat["layers.norm_attn"]))
    wq = flat["layers.attn.wq"]
    bound = 3.0 / np.sqrt(cfg.d_model)
    assert float(wq.abs().max()) <= bound + 1e-6
    # N(0, 1) cut at +-3 sigma has std 0.9866
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 0.9866) < 0.03
    emb = flat["embed.tokens"]
    assert float(emb.abs().max()) <= 0.06 + 1e-6
    again = port_models.get_model(cfg).init(0, cfg, device="cpu")
    assert torch.equal(again["layers"]["attn"]["wq"], wq)


def test_cast_weights_keeps_norms_float32():
    cfg = reduce_config(get_config("qwen3-0.6b"))
    flat = cm.flatten_paths(cm.cast_weights(
        PT.init(0, cfg, device="cpu"), cfg))
    for k, v in flat.items():
        want = torch.float32 if "norm" in k else torch.bfloat16
        assert v.dtype == want, k


def test_params_from_reference_checks_keys_and_shapes():
    cfg = reduce_config(get_config("tinyllama-1.1b"))
    flat = {k: np.zeros(s, np.float32)
            for k, s in _param_shapes(cfg).items()}
    params_from_reference(flat, cfg)
    with pytest.raises(ValueError, match="keys"):
        params_from_reference({**flat, "extra": np.zeros(1)}, cfg)
    bad = dict(flat, **{"head.w": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        params_from_reference(bad, cfg)


def test_unported_families_raise():
    """Every family of the reference is registered; the transformer module
    refuses the families it does not implement, and `get_model` a family
    that does not exist."""
    for arch in ("zamba2-7b", "whisper-base", "rwkv6-3b"):
        with pytest.raises(NotImplementedError, match="not a transformer"):
            PT.init(0, reduce_config(get_config(arch)), device="cpu")
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), family="nope")
    with pytest.raises(ValueError, match="unknown model family"):
        port_models.get_model(cfg)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = reduce_config(get_config("tinyllama-1.1b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.init(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.init_cache(cfg, 1, 8, ParallelConfig())


def test_make_batch_deterministic():
    cfg = reduce_config(get_config("tinyllama-1.1b"))
    a = port_models.make_batch(3, cfg, 2, 8)
    b = port_models.make_batch(3, cfg, 2, 8)
    assert set(a) == {"tokens", "labels"}
    for k in a:
        assert a[k].dtype == torch.int32 and a[k].shape == (2, 8)
        assert torch.equal(a[k], b[k])
        assert int(a[k].max()) < cfg.vocab_size
    assert not torch.equal(a["tokens"],
                           port_models.make_batch(4, cfg, 2, 8)["tokens"])
