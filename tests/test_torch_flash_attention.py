"""The port's flash attention (plain version `ref.attention`, and `ops`
in the model layout on the CPU) against the reference's plain version and
against its Pallas kernel in interpret mode, float32, same numpy inputs:
`o` and `lse` to atol 1e-5 (sums in a different order).  On the CPU the
port's wrapper runs the plain version; its CUDA kernel runs only in
``chip_smoke.py``, which holds it against this plain version."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import kernel as RK  # noqa: E402
from repro.kernels.flash_attention import ref as RR  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as PK  # noqa: E402
from repro_torch.kernels.flash_attention import ops as PO  # noqa: E402
from repro_torch.kernels.flash_attention import ref as PR  # noqa: E402

ATOL = 1e-5


def _qkv(seed, b, hq, hkv, s, hd):
    """(B, H, S, hd) layout, as the kernels take it."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, hd), dtype=np.float32),
            rng.standard_normal((b, hkv, s, hd), dtype=np.float32),
            rng.standard_normal((b, hkv, s, hd), dtype=np.float32))


def _port(q, k, v, causal):
    o, lse = PR.attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    return o.numpy(), lse.numpy()


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=ATOL)


@pytest.mark.parametrize("s", [64, 256])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_ref_matches_reference_ref(s, hq, hkv, causal):
    q, k, v = _qkv(s + hq, 2, hq, hkv, s, 32)
    _close(_port(q, k, v, causal),
           RR.attention(*map(jnp.asarray, (q, k, v)), causal=causal))


@pytest.mark.parametrize("s,bq,bk", [(64, 64, 64), (256, 64, 128),
                                     (256, 128, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_ref_matches_reference_pallas_kernel(s, bq, bk, causal):
    q, k, v = _qkv(s + bq, 2, 4, 2, s, 16)
    _close(_port(q, k, v, causal),
           RK.flash_attention_fwd(*map(jnp.asarray, (q, k, v)),
                                  causal=causal, bq=bq, bk=bk,
                                  interpret=True))


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_length_against_reference_ref(causal):
    """S = 192 with 128-row tiles.  Held against the reference's ref.py
    only: its Pallas kernel never writes rows past floor(S/bq)*bq
    (kernel.py:88-90, n_q = s // bq), so rows 128-191 come back unset."""
    q, k, v = _qkv(192, 2, 8, 2, 192, 32)
    _close(_port(q, k, v, causal),
           RR.attention(*map(jnp.asarray, (q, k, v)), causal=causal))


def test_ops_model_layout_on_cpu():
    """`ops.flash_attention` takes (B, S, H, hd) and gives the plain
    version's output in that layout."""
    q, k, v = _qkv(9, 2, 8, 2, 48, 16)
    t = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)]
    got = PO.flash_attention(*t, causal=True)
    assert got.shape == (2, 48, 8, 16)
    want, _ = _port(q, k, v, True)
    np.testing.assert_array_equal(got.transpose(1, 2).numpy(), want)


def test_ops_raises_on_grad():
    """A tensor that requires grad goes through the autograd Function,
    which dispatches by device in both directions: neither CPU nor CUDA
    raises, forward and backward alike.  (The backward's values are
    tested in test_torch_flash_attention_bwd.py.)"""
    q = torch.zeros((1, 8, 2, 16), device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="unsupported device"):
        PO.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        PO._backward(q, q, q, q, q, q, True)


def test_kernel_wrapper_raises_on_cpu_tensors():
    """The CUDA wrapper takes CUDA tensors only: no silent CPU path."""
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        PK.flash_attention_fwd(q, q, q)
    assert PK.flash_attention_fwd.launches == 0
