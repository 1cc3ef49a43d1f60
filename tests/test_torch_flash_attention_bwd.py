"""The port's flash-attention backward against the reference, same numpy
inputs: the plain version `ref.attention_bwd` against ``jax.vjp`` of the
reference's ``ref.attention``, and `ops.flash_attention` under
``torch.autograd.grad`` (the autograd Function, on the CPU its plain
versions) against ``jax.grad`` of the reference's ``ops.flash_attention``
(its Pallas forward and backward kernels in interpret mode).

Tolerances: float32, max abs error over max abs value < 1e-4, the
reference's own bound for its kernel's gradients
(tests/test_kernels.py::test_flash_grads_match_ref); bfloat16, 2^-7 of
the max (one bf16 ulp: both compute in float32 and round the result).
The reference's Pallas kernels never write rows past floor(S/128)*128
(ROADMAP queue 3), so ragged S is held against ``jax.vjp`` of its
``ref.attention`` only.  The CUDA kernels run only in
``chip_smoke.py``, which holds them against this plain version."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as RO  # noqa: E402
from repro.kernels.flash_attention import ref as RR  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as PK  # noqa: E402
from repro_torch.kernels.flash_attention import ops as PO  # noqa: E402
from repro_torch.kernels.flash_attention import ref as PR  # noqa: E402

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32, 1e-4),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16, 2 ** -7)}


def _inputs(seed, b, s, hq, hkv, hd, layout="bhsd"):
    """q, k, v, do as float32 numpy, (B, H, S, hd) or (B, S, H, hd)."""
    rng = np.random.default_rng(seed)
    shapes = [(b, hq, s, hd), (b, hkv, s, hd), (b, hkv, s, hd),
              (b, hq, s, hd)]
    xs = [rng.standard_normal(sh, dtype=np.float32) for sh in shapes]
    if layout == "bshd":
        xs = [np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in xs]
    return xs


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,hq,hkv", [(64, 4, 4), (128, 4, 2), (200, 8, 2),
                                      (192, 2, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_ref_bwd_matches_reference_vjp(dtype, s, hq, hkv, causal):
    """`ref.attention_bwd` (the o and lse of `ref.attention`) against the
    vjp of the reference's ``ref.attention``: any S, ragged included."""
    _, jdt, tdt, tol = DTYPES[dtype]
    q, k, v, do = _inputs(s + hq, 2, s, hq, hkv, 16)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jdt) for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b_, c: RR.attention(a, b_, c,
                                                   causal=causal)[0],
                     jq, jk, jv)
    want = vjp(jdo)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    o, lse = PR.attention(tq, tk, tv, causal=causal)
    got = PR.attention_bwd(tq, tk, tv, o, lse, tdo, causal=causal)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert _rel(g.float().numpy(), jnp.asarray(w, jnp.float32)) < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,hq,hkv", [(128, 2, 2), (200, 4, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_ref_bwd_hd112_matches_reference_vjp(dtype, s, hq, hkv, causal):
    """Head dim 112 (zamba2-7b's shared attention): `ref.attention_bwd`
    against the vjp of the reference's ``ref.attention``, S 128 and a
    ragged S 200, G 1 and G 2."""
    _, jdt, tdt, tol = DTYPES[dtype]
    q, k, v, do = _inputs(s + 112, 1, s, hq, hkv, 112)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jdt) for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b_, c: RR.attention(a, b_, c,
                                                   causal=causal)[0],
                     jq, jk, jv)
    want = vjp(jdo)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    o, lse = PR.attention(tq, tk, tv, causal=causal)
    got = PR.attention_bwd(tq, tk, tv, o, lse, tdo, causal=causal)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert _rel(g.float().numpy(), jnp.asarray(w, jnp.float32)) < tol


# (s, hq, hkv, causal, dtype): cases of tests/test_kernels.py's sweeps,
# at S divisible by the reference's 64/128-row tiles
OPS_CASES = [(128, 4, 2, True, "float32"), (64, 4, 4, False, "float32"),
             (256, 4, 2, True, "float32"), (128, 2, 1, False, "float32"),
             (128, 4, 2, True, "bfloat16"), (64, 2, 1, False, "bfloat16")]


@pytest.mark.parametrize("s,hq,hkv,causal,dtype", OPS_CASES)
def test_ops_grad_matches_reference_pallas(s, hq, hkv, causal, dtype):
    """d/d(q, k, v) of sum(o^2) through `ops.flash_attention` (the
    autograd Function) against jax.grad through the reference's custom_vjp
    (Pallas forward and backward, interpret mode), model layout."""
    _, jdt, tdt, tol = DTYPES[dtype]
    q, k, v, _ = _inputs(s * hq, 1, s, hq, hkv, 32, layout="bshd")

    def loss_ref(a, b_, c):
        o = RO.flash_attention(a, b_, c, causal=causal, bq=64, bk=64)
        return jnp.sum(o.astype(jnp.float32) ** 2)

    want = jax.grad(loss_ref, argnums=(0, 1, 2))(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)))
    ts = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    o = PO.flash_attention(*ts, causal=causal)
    got = torch.autograd.grad((o.float() ** 2).sum(), ts)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        assert _rel(g.float().numpy(), jnp.asarray(w, jnp.float32)) < tol


@pytest.mark.parametrize("causal,dtype", [(True, "float32"),
                                          (False, "float32"),
                                          (True, "bfloat16")])
def test_ops_grad_hd112_matches_reference_pallas(causal, dtype):
    """Head dim 112 through `ops.flash_attention` (the autograd Function)
    against jax.grad through the reference's custom_vjp, its Pallas
    backward in interpret mode, at S 128 (a whole tile: the reference's
    kernels skip ragged rows, ROADMAP queue 3), G 1 as in zamba2-7b."""
    _, jdt, tdt, tol = DTYPES[dtype]
    q, k, v, _ = _inputs(7, 1, 128, 2, 2, 112, layout="bshd")

    def loss_ref(a, b_, c):
        o = RO.flash_attention(a, b_, c, causal=causal)
        return jnp.sum(o.astype(jnp.float32) ** 2)

    want = jax.grad(loss_ref, argnums=(0, 1, 2))(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)))
    ts = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    o = PO.flash_attention(*ts, causal=causal)
    got = torch.autograd.grad((o.float() ** 2).sum(), ts)
    for g, w in zip(got, want):
        assert g.dtype == tdt and g.shape == (1, 128, 2, 112)
        assert _rel(g.float().numpy(), jnp.asarray(w, jnp.float32)) < tol


def test_bwd_head_dims_hold_112():
    """The backward's kernels are built for head dim 112, as the
    forward's are; a dim neither is built for is refused."""
    assert 112 in PK.BWD_HEAD_DIMS
    assert PK.BWD_HEAD_DIMS == PK.FWD_HEAD_DIMS
    PK.check_head_dim(112, "flash_attention_bwd", PK.BWD_HEAD_DIMS)
    with pytest.raises(ValueError, match="head dim 96"):
        PK.check_head_dim(96, "flash_attention_bwd", PK.BWD_HEAD_DIMS)


@pytest.mark.parametrize("causal", [True, False])
def test_ops_grad_ragged_against_reference_ref(causal):
    """S = 200 (ragged for 64- and 128-row tiles), GQA 8/2, strided q/k/v
    views of one fused projection, as the model makes them: the Function's
    gradients against jax.grad through the reference's ``ref.attention``."""
    b, s, hq, hkv, hd = 2, 200, 8, 2, 16
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, s, (hq + 2 * hkv) * hd), dtype=np.float32)
    cut = (hq * hd, (hq + hkv) * hd)

    def loss_ref(xx):
        q, k, v = jnp.split(xx, cut, axis=-1)
        q, k, v = (t.reshape(b, s, -1, hd).transpose(0, 2, 1, 3)
                   for t in (q, k, v))
        return jnp.sum(RR.attention(q, k, v, causal=causal)[0] ** 2)

    want = jax.grad(loss_ref)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    q, k, v = torch.split(tx, [hq * hd, hkv * hd, hkv * hd], -1)
    o = PO.flash_attention(q.view(b, s, hq, hd), k.view(b, s, hkv, hd),
                           v.view(b, s, hkv, hd), causal=causal)
    got, = torch.autograd.grad((o ** 2).sum(), tx)
    assert _rel(got.numpy(), want) < 1e-4


def test_function_saves_forward_and_runs_plain_backward():
    """The Function's backward gives exactly `ref.attention_bwd` of the
    forward's own o and lse (the CPU wiring the card shares)."""
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(3, 1, 96, 4, 2, 16, layout="bshd"))
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    o = PO.flash_attention(*ts, causal=True)
    got = torch.autograd.grad(o, ts, do)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    o2, lse = PR.attention(t(q), t(k), t(v), causal=True)
    want = PR.attention_bwd(t(q), t(k), t(v), o2, lse, t(do), causal=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, t(w), rtol=0, atol=0)


def test_bwd_wrapper_raises_on_cpu_tensors():
    """The backward's CUDA wrapper takes CUDA tensors only."""
    q = torch.zeros((1, 8, 2, 16))
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        PK.flash_attention_bwd(q, q, q, q, lse, q)
    assert PK.flash_attention_bwd.launches == 0


# --- the bf16 tensor-core backward's numerics, emulated on the CPU ------
#
# csrc/flash_attention_bwd_tc.cu computes s, dp, p = exp(s - lse) and
# ds = p (dp - delta) / sqrt(hd) in float32 from bf16 q, k, v, do, and
# rounds p and ds to bf16 before the products dv = p^T do, dk = ds^T q
# and dq = ds k, which sum in float32.  `_tc_backward` repeats that.  The
# card holds each gradient to 2^-7 of its max |g| against the plain
# version (chip_smoke.py, attn_bwd_parity); these cases show that the
# rounding stays inside that bound at reduced shapes.

def _bf16(x):
    """float32 numpy rounded to the nearest bf16, back in float32."""
    return torch.from_numpy(np.array(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _tc_backward(q, k, v, o, lse, do, causal):
    """(dq, dk, dv) as the tensor-core backward computes them, each
    rounded to bf16: q, o, do (B,Hq,S,hd), k/v (B,Hkv,S,hd) and lse
    (B,Hq,S), float32 numpy; dk and dv summed over each group."""
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    kk, vv = np.repeat(k, g, axis=1), np.repeat(v, g, axis=1)
    scale = 1.0 / np.sqrt(hd)
    sc = np.einsum("bhqd,bhkd->bhqk", q, kk) * scale
    p = np.exp(sc - lse[..., None])
    if causal:
        p = np.where(np.tril(np.ones((s, s), bool)), p, 0.0)
    dp = np.einsum("bhqd,bhkd->bhqk", do, vv)
    delta = (do * o).sum(-1, keepdims=True)
    ds = p * (dp - delta) * scale
    p16, ds16 = _bf16(p), _bf16(ds)
    dv = np.einsum("bhqk,bhqd->bhkd", p16, do)
    dk = np.einsum("bhqk,bhqd->bhkd", ds16, q)
    dq = np.einsum("bhqk,bhkd->bhqd", ds16, kk)
    dk = dk.reshape(b, hkv, g, s, hd).sum(2)
    dv = dv.reshape(b, hkv, g, s, hd).sum(2)
    return tuple(_bf16(x) for x in (dq, dk, dv))


@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128])
@pytest.mark.parametrize("s,hq,hkv", [(1, 4, 2), (64, 4, 4), (130, 8, 2),
                                      (200, 4, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_tc_backward_rounding_within_card_tolerance(hd, s, hq, hkv, causal):
    """The emulated tensor-core backward against the vjp of the
    reference's ``ref.attention`` on the same bf16 q, k, v, do (o and lse
    the reference's, rounded as the kernel's forward hands them over):
    every gradient within 2^-7 of its max |g| (ragged S, GQA, every head
    dim the kernel is built for).  At S = 1, dq and dk are zero in exact
    arithmetic and both sides hold only rounding noise: there they are
    held to 2^-7 of max |dv| instead."""
    q, k, v, do = (_bf16(x) for x in _inputs(s + hd + hq, 2, s, hq, hkv,
                                            hd))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    (o, lse), vjp = jax.vjp(lambda a, b_, c: RR.attention(a, b_, c,
                                                          causal=causal),
                            jq, jk, jv)
    want = vjp((jnp.asarray(do), jnp.zeros_like(lse)))
    got = _tc_backward(q, k, v, _bf16(o), np.asarray(lse), do, causal)
    tol = DTYPES["bfloat16"][3]
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        scale = np.abs(want[2] if s == 1 else w).max()
        assert np.abs(g - w).max() <= tol * scale
