"""The port's VLM family (M-RoPE, `models/attention.py` and the
transformer's position plumbing) against the reference, float32, same
numpy inputs: `mrope_sections` for head dims 16, 64 and 128;
`apply_mrope` on three distinct (temporal, height, width) position
streams (1e-6); the reduced qwen2-vl-72b, its params carried over by
`convert.params_from_reference`, with prompts laid out as Qwen2-VL lays
out an image (arXiv:2409.12191 §2.1: a block of image tokens with one
temporal id and a (h, w) grid, then text continuing from the block's
end): `forward`, prefill and two decode steps' logits (1e-3, the float32
logits tolerance of test_torch_transformer.py), greedy tokens through
both `Engine`s and the serve<->sim capture; `make_batch`'s positions; the
serving launcher on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ParallelConfig as RefPCfg  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduce_config as ref_reduce  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serve.engine import Engine as RefEngine  # noqa: E402
from repro.serve.engine import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch import models as port_models  # noqa: E402
from repro_torch.configs import (ParallelConfig, get_config,  # noqa: E402
                                 reduce_config)
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.serve import bridge  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

ARCH = "qwen2-vl-72b"
B, S, MAX_SEQ = 2, 16, 32
TOL = 1e-3


def image_positions(b: int, s: int, grid=(2, 4)) -> np.ndarray:
    """(3, b, s) M-RoPE ids of prompts holding one image each: lane i has
    1 + i text tokens, then a grid[0] x grid[1] block of image tokens
    (temporal id fixed at the block's start, height and width ids from it
    along the grid), then text whose three ids continue from the block's
    largest id + 1."""
    gh, gw = grid
    out = np.zeros((3, b, s), np.int32)
    for i in range(b):
        pre = 1 + i
        out[:, i, :pre] = np.arange(pre)
        r, c = np.divmod(np.arange(gh * gw), gw)
        blk = slice(pre, pre + gh * gw)
        out[0, i, blk] = pre
        out[1, i, blk] = pre + r
        out[2, i, blk] = pre + c
        rest = s - pre - gh * gw
        out[:, i, pre + gh * gw:] = pre + max(gh, gw) + np.arange(rest)
    return out


def _cfgs():
    return (dataclasses.replace(ref_reduce(ref_get_config(ARCH)),
                                dtype="float32"),
            dataclasses.replace(reduce_config(get_config(ARCH)),
                                dtype="float32"))


def _close(got, want, tol, what):
    got = got.float().numpy() if torch.is_tensor(got) else got
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max abs {err} > {tol}"


@pytest.mark.parametrize("hd", [16, 64, 128])
def test_mrope_sections_match_reference(hd):
    got = PA.mrope_sections(hd)
    assert got == RA.mrope_sections(hd)
    assert sum(got) == hd // 2


@pytest.mark.parametrize("hd,theta", [(16, 1e4), (64, 1e6), (128, 1e6)])
def test_apply_mrope_matches_reference(hd, theta):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 24, 3, hd), dtype=np.float32)
    pos3 = image_positions(2, 24, grid=(3, 5)) * 7
    assert len({pos3[j].tobytes() for j in range(3)}) == 3   # distinct
    got = PA.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                         theta).numpy()
    want = np.asarray(RA.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                     theta))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # three equal streams are RoPE: a wrong section split would still pass
    # there, which is why the case above takes distinct ones
    same = np.broadcast_to(pos3[1], pos3.shape).copy()
    np.testing.assert_allclose(
        PA.apply_mrope(torch.from_numpy(x), torch.from_numpy(same),
                       theta).numpy(),
        PA.apply_rope(torch.from_numpy(x), torch.from_numpy(pos3[1]),
                      theta).numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_forward_prefill_decode_match_reference(impl):
    rcfg, cfg = _cfgs()
    rpcfg = RefPCfg(attn_impl=impl, attn_chunk=4, moe_impl="dense",
                    remat="none")
    pcfg = ParallelConfig(attn_impl=impl, attn_chunk=4, moe_impl="dense",
                          remat="none")
    rparams = RT.init(jax.random.PRNGKey(0), rcfg)
    params = params_from_reference(
        {k: np.asarray(v)
         for k, v in ref_common.flatten_paths(rparams).items()}, cfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    steps = rng.integers(0, cfg.vocab_size, (2, B, 1), dtype=np.int32)
    pos3 = image_positions(B, S)
    batch = {"tokens": tokens, "positions": pos3}
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        rh, _ = RT.forward(rparams, rbatch, rcfg, rpcfg)
        ph, _ = PT.forward(params, tbatch, cfg, pcfg)
        _close(PT.logits_fn(params, ph, cfg),
               np.asarray(RT.logits_fn(rparams, rh, rcfg)), TOL,
               "forward logits")
        rcache = RT.init_cache(rcfg, B, MAX_SEQ, rpcfg)
        rcache, rlast = RT.prefill(rparams, rbatch, rcache, rcfg, rpcfg)
        cache = PT.init_cache(cfg, B, MAX_SEQ, pcfg, device="cpu")
        cache, last = PT.prefill(params, tbatch, cache, cfg, pcfg)
        _close(last, np.asarray(rlast, np.float32), TOL,
               "prefill last hidden")
        for t in range(2):
            rcache, rlogits = RT.decode(rparams, jnp.asarray(steps[t]),
                                        rcache, rcfg, rpcfg)
            cache, logits = PT.decode(params, torch.from_numpy(steps[t]),
                                      cache, cfg, pcfg)
            _close(logits, np.asarray(rlogits), TOL, f"decode {t} logits")
        # the layout matters: the same tokens at plain positions differ
        plain, _ = PT.forward(params, {"tokens": tbatch["tokens"]}, cfg,
                              pcfg)
        assert float((plain - ph).abs().max()) > 1e-3


def test_greedy_tokens_match_reference():
    rcfg, cfg = _cfgs()
    rparams = RT.init(jax.random.PRNGKey(2), rcfg)
    flat = {k: np.asarray(v)
            for k, v in ref_common.flatten_paths(rparams).items()}
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S),
                                               dtype=np.int32)
    batch = {"tokens": tokens, "positions": image_positions(B, S)}
    ref = RefEngine(rcfg, RefPCfg(attn_impl="pallas", moe_impl="dense",
                                  remat="none"),
                    RefServeConfig(max_seq=MAX_SEQ), rparams)
    eng = Engine(cfg, ParallelConfig(attn_impl="pallas", moe_impl="dense",
                                     remat="none"),
                 ServeConfig(max_seq=MAX_SEQ),
                 params_from_reference(flat, cfg), device="cpu")
    want = np.asarray(ref.generate({k: jnp.asarray(v)
                                    for k, v in batch.items()}, 8))
    got = eng.generate(batch, 8).numpy()
    np.testing.assert_array_equal(got, want)
    # the serve<->sim capture passes the positions on to prefill
    out, cap = bridge.capture_generate(eng, batch, 8)
    np.testing.assert_array_equal(out.numpy(), want)
    assert cap.n_lanes == B


def test_make_batch_positions():
    _, cfg = _cfgs()
    batch = port_models.make_batch(0, cfg, 2, 6, kind="prefill")
    assert set(batch) == {"tokens", "positions"}
    pos = batch["positions"]
    assert pos.dtype == torch.int32 and pos.shape == (3, 2, 6)
    assert torch.equal(pos, torch.arange(6, dtype=torch.int32).expand(
        3, 2, 6))
    assert set(port_models.make_batch(0, cfg, 2, 6, kind="decode")) == {
        "tokens"}
    assert port_models.get_model(cfg) is PT


def test_launcher_on_cpu(capsys):
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--requests", "2",
                              "--prompt-len", "8", "--new-tokens", "4",
                              "--device", "cpu"]) == 0
    assert "generated 8 tokens" in capsys.readouterr().out
