"""The port's flash attention (plain version `ref.attention`, and `ops`
in the model layout on the CPU) against the reference's plain version and
against its Pallas kernel in interpret mode, float32, same numpy inputs,
head dim 112 (zamba2-7b's) among them: `o` and `lse` to atol 1e-5 (sums
in a different order).  On the CPU the
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


@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_112_against_reference(causal):
    """zamba2-7b's head dim: the plain version against the reference's
    Pallas kernel in interpret mode (S a multiple of its tiles) and its
    ref.py (S 192, ragged at 128-row tiles)."""
    q, k, v = _qkv(112, 2, 4, 2, 128, 112)
    _close(_port(q, k, v, causal),
           RK.flash_attention_fwd(*map(jnp.asarray, (q, k, v)),
                                  causal=causal, bq=64, bk=64,
                                  interpret=True))
    q, k, v = _qkv(113, 1, 4, 4, 192, 112)
    _close(_port(q, k, v, causal),
           RR.attention(*map(jnp.asarray, (q, k, v)), causal=causal))


def test_head_dims_of_each_direction():
    """Both directions' kernels take head dim 112 (zamba2-7b's shared
    attention, trained since the hybrid family's training slice), and
    neither takes a dim it is not built for."""
    assert PK.FWD_HEAD_DIMS == (16, 32, 64, 112, 128)
    assert PK.BWD_HEAD_DIMS == (16, 32, 64, 112, 128)
    for hd in PK.FWD_HEAD_DIMS:
        PK.check_head_dim(hd, "flash_attention_fwd", PK.FWD_HEAD_DIMS)
        PK.check_head_dim(hd, "flash_attention_bwd", PK.BWD_HEAD_DIMS)
    for head_dims in (PK.FWD_HEAD_DIMS, PK.BWD_HEAD_DIMS):
        with pytest.raises(ValueError, match="head dim 96"):
            PK.check_head_dim(96, "flash_attention", head_dims)


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


# --- the bf16 tensor-core kernel's numerics, emulated on the CPU --------
#
# csrc/flash_attention_fwd_tc.cu multiplies bf16 q, k and v exactly into
# float32 sums and keeps the online softmax in float32, but rounds each
# kv tile's unnormalised probabilities exp(s - m) to bf16 before P V.
# `_tc_forward` repeats that, tile by tile, in float64 sums.  The card
# holds the kernel's o to 2^-7 of max |o| and lse to 1e-4 against the
# plain version (chip_smoke.py, attn_parity); these cases show that the
# rounding stays inside those bounds at reduced shapes.

TC_BK = 64          # kv rows per tile of the tensor-core forward
BF16_TOL = 2 ** -7  # the card's bf16 bound, a fraction of max |o|


def _bf16(x):
    """float32 numpy rounded to the nearest bf16, back in float32."""
    return torch.from_numpy(np.array(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _tc_forward(q, k, v, causal):
    """(o, lse) as the tensor-core forward computes them: q (B,Hq,S,hd),
    k/v (B,Hkv,S,hd), bf16-representable float32; o rounded to bf16."""
    b, hq, s, hd = q.shape
    g = hq // k.shape[1]
    kk = np.repeat(k, g, axis=1).astype(np.float64)
    vv = np.repeat(v, g, axis=1).astype(np.float64)
    scores = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kk)
    scores /= np.sqrt(hd)
    if causal:
        scores = np.where(np.tril(np.ones((s, s), bool)), scores, -np.inf)
    m = np.full((b, hq, s, 1), -np.inf)
    l = np.zeros((b, hq, s, 1))
    acc = np.zeros((b, hq, s, hd))
    for k0 in range(0, s, TC_BK):
        tile = scores[..., k0:k0 + TC_BK]
        m_new = np.maximum(m, tile.max(-1, keepdims=True))
        alpha = np.exp(m - m_new)
        p = np.exp(tile - m_new)
        l = l * alpha + p.sum(-1, keepdims=True)
        acc = acc * alpha + _bf16(p) @ vv[:, :, k0:k0 + TC_BK]
        m = m_new
    return _bf16(acc / l), (m + np.log(l))[..., 0].astype(np.float32)


@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128])
@pytest.mark.parametrize("s,hq,hkv", [(1, 4, 2), (64, 4, 4), (130, 8, 2),
                                      (200, 4, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_tc_forward_rounding_within_card_tolerance(hd, s, hq, hkv, causal):
    """The emulated tensor-core forward against the reference's plain
    version on the same bf16 inputs: o within 2^-7 of max |o|, lse within
    1e-4 (ragged S, GQA, every head dim the kernel is built for)."""
    q, k, v = (_bf16(x) for x in _qkv(s + hd + hq, 2, hq, hkv, s, hd))
    want_o, want_lse = RR.attention(*map(jnp.asarray, (q, k, v)),
                                    causal=causal)
    want_o = np.asarray(want_o)
    o, lse = _tc_forward(q, k, v, causal)
    assert np.abs(o - want_o).max() <= BF16_TOL * np.abs(want_o).max()
    np.testing.assert_allclose(lse, np.asarray(want_lse), rtol=0, atol=1e-4)


def test_route_is_by_dtype():
    """bf16 runs on the tensor-core kernels, float32 on the CUDA-core
    ones; any other dtype is refused, not sent to either."""
    assert PK.route(torch.bfloat16) == "tensor_core"
    assert PK.route(torch.float32) == "cuda_core"
    with pytest.raises(ValueError, match="dtype"):
        PK.route(torch.float16)
    assert set(PK.flash_attention_fwd.route_launches) == {"tensor_core",
                                                          "cuda_core"}


@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128])
def test_fused_projection_views_are_aligned(hd):
    """The model's q/k/v views of one fused projection meet the bf16
    kernels' 16-byte alignment; a view one element off does not."""
    b, s, hq, hkv = 2, 24, 8, 2
    x = torch.zeros((b, s, (hq + 2 * hkv) * hd + 8), dtype=torch.bfloat16)
    fused = x[..., 8:]
    q, k, v = torch.split(fused, [hq * hd, hkv * hd, hkv * hd], -1)
    for t in (q, k, v):
        assert PK.aligned(t.view(b, s, -1, hd))
    off = x[..., 1:1 + hq * hd].view(b, s, hq, hd)
    assert not PK.aligned(off)
