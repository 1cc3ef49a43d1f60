"""The port's `models/attention.py` against the reference, float32, same
numpy inputs: RoPE, `attend_naive` (causal, full, q_offset, kv_len),
`attend_chunked` (the kv-block loop, the diagonal-batched causal path and
the ragged fallback), `attend` and `decode_attend` — rtol/atol 1e-5 (the
two frameworks sum in different orders)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as RA  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(seed, b, sq, sk, hq, hkv, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, hd), dtype=np.float32)
    k = rng.standard_normal((b, sk, hkv, hd), dtype=np.float32)
    v = rng.standard_normal((b, sk, hkv, hd), dtype=np.float32)
    return q, k, v


def _both(fn_ref, fn_port, *arrays, **kw):
    want = np.asarray(fn_ref(*map(jnp.asarray, arrays), **kw))
    got = fn_port(*map(torch.from_numpy, arrays), **kw).numpy()
    return got, want


@pytest.mark.parametrize("hd,theta,offset", [(16, 1e4, 0), (64, 1e4, 300),
                                             (128, 1e6, 450)])
def test_apply_rope(hd, theta, offset):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 24, 3, hd), dtype=np.float32)
    pos = (np.arange(24)[None] + np.array([[0], [offset]])).astype(np.int32)
    got, want = _both(RA.apply_rope, PA.apply_rope, x, pos, theta=theta)
    np.testing.assert_allclose(got, want, **TOL)


def test_position_embed_none_and_mrope():
    q, k, _ = _qkv(0, 1, 4, 4, 2, 2, 16)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    pos = torch.zeros((1, 4), dtype=torch.int32)
    oq, ok = PA.position_embed(tq, tk, pos, "none", 1e4)
    assert oq is tq and ok is tk
    # three distinct (temporal, height, width) streams
    pos3 = np.stack([np.full((1, 4), 2), np.arange(4)[None] + 2,
                     np.arange(4)[None] * 3]).astype(np.int32)
    got = PA.position_embed(tq, tk, torch.from_numpy(pos3), "mrope", 1e4)
    want = RA.position_embed(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(pos3), "mrope", 1e4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (4, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_attend_naive(hq, hkv, causal):
    q, k, v = _qkv(1, 2, 24, 24, hq, hkv, 16)
    got, want = _both(RA.attend_naive, PA.attend_naive, q, k, v,
                      causal=causal)
    np.testing.assert_allclose(got, want, **TOL)


def test_attend_naive_offset_and_kv_len():
    q, k, v = _qkv(2, 2, 4, 32, 8, 2, 16)
    lens = np.array([20, 32], np.int32)
    want = np.asarray(RA.attend_naive(*map(jnp.asarray, (q, k, v)),
                                      causal=True, q_offset=28,
                                      kv_len=jnp.asarray(lens)))
    got = PA.attend_naive(*map(torch.from_numpy, (q, k, v)), causal=True,
                          q_offset=28, kv_len=torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# (s, chunk): kv-block loop (one block, several), the diagonal-batched
# causal path (s % chunk == 0 and s > chunk), and the ragged fallback
@pytest.mark.parametrize("s,chunk", [(64, 64), (64, 16), (96, 32), (40, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_attend_chunked(s, chunk, causal):
    q, k, v = _qkv(3, 2, s, s, 8, 2, 16)
    got, want = _both(RA.attend_chunked, PA.attend_chunked, q, k, v,
                      causal=causal, chunk=chunk)
    np.testing.assert_allclose(got, want, **TOL)


def test_attend_chunked_kv_len():
    q, k, v = _qkv(4, 2, 32, 32, 4, 2, 16)
    lens = np.array([9, 32], np.int32)
    want = np.asarray(RA.attend_chunked(*map(jnp.asarray, (q, k, v)),
                                        causal=False, chunk=8,
                                        kv_len=jnp.asarray(lens)))
    got = PA.attend_chunked(*map(torch.from_numpy, (q, k, v)), causal=False,
                            chunk=8, kv_len=torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_attend_impls(impl):
    """`attend` per implementation (pallas: the reference's interpret-mode
    kernel against the port's plain version of its CUDA kernel)."""
    q, k, v = _qkv(5, 2, 64, 64, 4, 2, 16)
    got, want = _both(RA.attend, PA.attend, q, k, v, causal=True, impl=impl,
                      chunk=32)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 1)])
def test_decode_attend(hq, hkv):
    q, k, v = _qkv(6, 3, 1, 64, hq, hkv, 32)
    lens = np.array([40, 64, 1], np.int32)
    got, want = _both(RA.decode_attend, PA.decode_attend, q, k, v, lens)
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_attend_bf16_cache_returns_cache_dtype():
    """Like the reference, the product with V is in the cache's dtype."""
    q, k, v = _qkv(7, 2, 1, 16, 4, 2, 16)
    lens = np.array([5, 16], np.int32)
    want = RA.decode_attend(jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
                            jnp.asarray(v, jnp.bfloat16), jnp.asarray(lens))
    got = PA.decode_attend(torch.from_numpy(q),
                           torch.from_numpy(k).bfloat16(),
                           torch.from_numpy(v).bfloat16(),
                           torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-5)
