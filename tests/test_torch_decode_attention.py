"""The port's flash-decode (plain version `ref.decode_attend`, and `ops`
in the model layout on the CPU) against the reference's plain version and
its Pallas kernel in interpret mode, float32, same numpy inputs, with
lengths that skip whole chunks: atol 1e-5 (sums in a different order).
On the CPU the port's wrapper runs the plain version; its CUDA kernel
runs only in ``chip_smoke.py``, which holds it against this plain
version."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import kernel as RK  # noqa: E402
from repro.kernels.decode_attention import ops as RO  # noqa: E402
from repro.kernels.decode_attention import ref as RR  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as PK  # noqa: E402
from repro_torch.kernels.decode_attention import ops as PO  # noqa: E402
from repro_torch.kernels.decode_attention import ref as PR  # noqa: E402

ATOL = 1e-5


def _inputs(seed, b, hkv, g, s, hd, lengths):
    """(B, Hkv, G, hd) q and (B, Hkv, S, hd) caches, as the kernels take
    them."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hkv, g, hd), dtype=np.float32),
            rng.standard_normal((b, hkv, s, hd), dtype=np.float32),
            rng.standard_normal((b, hkv, s, hd), dtype=np.float32),
            np.asarray(lengths, np.int32))


def _port(q, k, v, lens):
    return PR.decode_attend(*map(torch.from_numpy, (q, k, v, lens))).numpy()


# lengths 1 and 200 skip the second (and first) 256-row chunk entirely
@pytest.mark.parametrize("hkv,g,hd", [(2, 2, 16), (1, 4, 32), (2, 1, 64)])
def test_ref_matches_reference(hkv, g, hd):
    args = _inputs(hd + g, 3, hkv, g, 512, hd, [512, 1, 200])
    want_ref = np.asarray(RR.decode_attend(*map(jnp.asarray, args)))
    want_kernel = np.asarray(RK.decode_attention(*map(jnp.asarray, args),
                                                 bk=256, interpret=True))
    got = _port(*args)
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=ATOL)


def test_smax_not_a_chunk_multiple_against_reference_ref():
    """Smax = 300.  Held against the reference's ref.py only: its Pallas
    kernel reads n_kv = 300 // 256 = 1 chunk (kernel.py:73-74) and drops
    positions 256-299 of a lane whose length is 300."""
    args = _inputs(11, 2, 2, 2, 300, 32, [300, 257])
    got = _port(*args)
    np.testing.assert_allclose(
        got, np.asarray(RR.decode_attend(*map(jnp.asarray, args))),
        rtol=0, atol=ATOL)


def test_ops_model_layout_matches_reference_ops():
    """`ops.decode_attention` in the model layout: q (B,1,Hq,hd), caches
    (B,S,Hkv,hd), against the reference's ops (its interpret-mode
    kernel)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 1, 4, 16), dtype=np.float32)
    k = rng.standard_normal((2, 512, 2, 16), dtype=np.float32)
    v = rng.standard_normal((2, 512, 2, 16), dtype=np.float32)
    lens = np.array([300, 17], np.int32)
    want = np.asarray(RO.decode_attention(*map(jnp.asarray, (q, k, v, lens))))
    got = PO.decode_attention(*map(torch.from_numpy, (q, k, v, lens)))
    assert got.shape == (2, 1, 4, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_garbage_past_lengths_changes_nothing():
    q, k, v, lens = _inputs(3, 2, 2, 2, 96, 16, [40, 65])
    base = _port(q, k, v, lens)
    k2, v2 = k.copy(), v.copy()
    for b, n in enumerate(lens):
        k2[b, :, n:] = 1e4
        v2[b, :, n:] = -1e4
    np.testing.assert_array_equal(_port(q, k2, v2, lens), base)


def test_kernel_wrapper_raises_on_cpu_tensors():
    """The CUDA wrapper takes CUDA tensors only: no silent CPU path."""
    q = torch.zeros((1, 1, 2, 16))
    c = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        PK.decode_attention(q, c, c, torch.ones(1, dtype=torch.int32))
    assert PK.decode_attention.launches == 0
