"""The port's encoder-decoder family (`models/whisper.py`) against the
reference, with the reference's params carried over by
`convert.params_from_reference`: `common.layer_norm` and
`common.sinusoidal_positions`; the reduced whisper-base (2 encoder
layers, 24 frames) at 2 and 3 decoder layers, float32, attn_impl chunked
and pallas: `encode`, forward hidden states, prefill's last hidden state
and cache (the self-attention K/V and the cross-attention K/V, stored in
bf16 as the reference stores them), two decode steps' logits (decode
reads the rounded cross K/V back, prefill attended over the unrounded
ones, on both sides), each within 1e-4 of max |ref| (the bf16 cache
entries within one bf16 ulp, 2^-7 of max |ref|, as in
test_torch_transformer.py: float32 sums in another order can round an
element to the neighbouring bf16); `make_batch`'s frame embeddings;
greedy tokens through both `Engine`s; the launcher on the CPU."""
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
from repro.models import whisper as RW  # noqa: E402
from repro.serve.engine import Engine as RefEngine  # noqa: E402
from repro.serve.engine import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch import models as port_models  # noqa: E402
from repro_torch.configs import (ParallelConfig, get_config,  # noqa: E402
                                 reduce_config)
from repro_torch.configs.base import _param_shapes  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import whisper as PW  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

ARCH = "whisper-base"
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
    rparams = RW.init(jax.random.PRNGKey(0), rcfg)
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


def _batch(cfg):
    batch = port_models.make_batch(0, cfg, B, S, "prefill")
    return batch, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_layer_norm_matches_reference(eps):
    rng = np.random.default_rng(0)
    x = (3.0 + 2.0 * rng.standard_normal((2, 5, 48))).astype(np.float32)
    scale = rng.standard_normal(48, dtype=np.float32)
    want = ref_common.layer_norm(jnp.asarray(x), jnp.asarray(scale), eps)
    got = cm.layer_norm(torch.from_numpy(x), torch.from_numpy(scale), eps)
    _close(got, _np(want), "layer_norm", rtol=1e-6)
    # in x's dtype, computed in float32
    got16 = cm.layer_norm(torch.from_numpy(x).bfloat16(),
                          torch.from_numpy(scale), eps)
    assert got16.dtype == torch.bfloat16


@pytest.mark.parametrize("seq,dim,offset", [(24, 64, 0), (1500, 512, 0),
                                            (1, 512, 37), (5, 6, 3)])
def test_sinusoidal_positions_match_reference(seq, dim, offset):
    """Each value within 1e-6 plus two float32 ulps of its angle pos x
    freq: XLA's and torch's float32 exp differ by an ulp on some bands
    (25 of whisper-base's 256), which moves the angle by an ulp of itself
    (1.2e-4 at frame 1500)."""
    want = np.asarray(ref_common.sinusoidal_positions(seq, dim,
                                                      offset=offset))
    got = cm.sinusoidal_positions(seq, dim, offset=offset)
    assert got.dtype == torch.float32 and got.shape == want.shape
    half = dim // 2
    ang = (np.arange(seq)[:, None] + offset) * np.exp(
        -np.log(1e4) * np.arange(half) / max(half - 1, 1))[None]
    tol = 1e-6 + 2 * np.spacing(np.tile(ang, 2).astype(np.float32))
    assert (np.abs(got.numpy() - want) <= tol).all()


def test_registered_and_params_carry_over():
    assert port_models.get_model(get_config(ARCH)) is PW
    for n_layers in (2, 3):
        rcfg, cfg = _cfgs(n_layers)
        _, flat, params = _params(rcfg, cfg)
        assert {k: v.shape for k, v in flat.items()} == _param_shapes(cfg)
        for k, v in cm.flatten_paths(params).items():
            assert tuple(v.shape) == _param_shapes(cfg)[k], k


def test_make_batch_frame_embeddings():
    """enc_embed (B, enc_seq_len, d) in the compute dtype, 0.1 x standard
    normal from (seed, 2), the same in every call; decode batches carry
    tokens only."""
    for dtype, want in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        _, cfg = _cfgs(dtype=dtype)
        a = port_models.make_batch(3, cfg, B, S, "prefill")
        b = port_models.make_batch(3, cfg, B, S, "prefill")
        assert set(a) == {"tokens", "enc_embed"}
        assert a["enc_embed"].shape == (B, cfg.enc_seq_len, cfg.d_model)
        assert a["enc_embed"].dtype == want
        assert torch.equal(a["enc_embed"], b["enc_embed"])
        assert 0.05 < float(a["enc_embed"].float().std()) < 0.15
    assert set(port_models.make_batch(3, cfg, B, S, "decode")) == {"tokens"}


def test_encode_matches_reference():
    rcfg, cfg = _cfgs()
    rparams, _, params = _params(rcfg, cfg)
    batch, rbatch = _batch(cfg)
    want = RW.encode(rparams, rbatch["enc_embed"], rcfg,
                     RefPCfg(remat="none"))
    with torch.inference_mode():
        got = PW.encode(params, batch["enc_embed"], cfg,
                        ParallelConfig(remat="none"))
    _close(got, _np(want), "encode")


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("n_layers", [2, 3])
def test_forward_prefill_decode(n_layers, impl):
    rcfg, cfg = _cfgs(n_layers)
    rparams, _, params = _params(rcfg, cfg)
    rpcfg = RefPCfg(attn_impl=impl, remat="none")
    pcfg = ParallelConfig(attn_impl=impl, remat="none")
    batch, rbatch = _batch(cfg)

    want, _ = RW.forward(rparams, rbatch, rcfg, rpcfg)
    with torch.inference_mode():
        got, aux = PW.forward(params, batch, cfg, pcfg)
    _close(got, _np(want), "forward")
    assert float(aux["aux_loss"]) == 0.0

    rcache = RW.init_cache(rcfg, B, MAX_SEQ, rpcfg)
    rcache, rlast = RW.prefill(rparams, rbatch, rcache, rcfg, rpcfg)
    with torch.inference_mode():
        cache = PW.init_cache(cfg, B, MAX_SEQ, pcfg, device="cpu")
        cache, last = PW.prefill(params, batch, cache, cfg, pcfg)
    _close(last, _np(rlast), "prefill last hidden")
    assert cache["pos"] == S and cache["lengths"].tolist() == [S] * B
    for key in ("k", "v", "cross_k", "cross_v"):
        assert cache[key].dtype == torch.bfloat16, key
        _close(cache[key], _np(rcache[key]), f"prefill cache {key}",
               rtol=BF16_ULP)

    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, B, 1),
                                             dtype=np.int32)
    for t in range(2):
        rcache, rlogits = RW.decode(rparams, jnp.asarray(toks[t]), rcache,
                                    rcfg, rpcfg)
        with torch.inference_mode():
            cache, logits = PW.decode(params, torch.from_numpy(toks[t]),
                                      cache, cfg, pcfg)
        _close(logits, _np(rlogits), f"decode step {t} logits")


def test_engine_greedy_tokens_match_reference():
    rcfg, cfg = _cfgs(3)
    rparams, _, params = _params(rcfg, cfg)
    batch, rbatch = _batch(cfg)
    ref = RefEngine(rcfg, RefPCfg(attn_impl="pallas", remat="none"),
                    RefServeConfig(max_seq=32), rparams)
    eng = Engine(cfg, ParallelConfig(attn_impl="pallas", remat="none"),
                 ServeConfig(max_seq=32), params, device="cpu")
    want = np.asarray(ref.generate(rbatch, 8))
    got = eng.generate(batch, 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_launcher_on_cpu(capsys):
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--requests", "2",
                              "--prompt-len", "8", "--new-tokens", "4",
                              "--device", "cpu"]) == 0
    assert "generated 8 tokens" in capsys.readouterr().out
