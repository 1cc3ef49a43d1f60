"""The port's WKV6 recurrence (`kernels/wkv6`) against the reference, same
numpy inputs: the kernel's plain version (`ops.wkv6_with_state` on the
CPU) against the reference's Pallas kernel in interpret mode and its
sequential oracle at the reference test's grid, `y` and the final state;
the port's sequential oracle against the reference's; the autograd
Function's gradients against ``jax.grad`` of the reference's
``custom_vjp``; per-chunk remat in the recompute; the wrapper's checks.

Tolerances: 1e-5 x max |ref| for `y` and the state — the inputs are
float32 (bf16 cases draw bf16-representable values, as the reference
test), and only the order of float32 sums differs; gradients 1e-5 of
each one's max |g|."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.wkv6 import kernel as WK  # noqa: E402
from repro.kernels.wkv6 import ops as WO  # noqa: E402
from repro.kernels.wkv6 import ref as WR  # noqa: E402
from repro_torch.kernels.wkv6 import kernel as K  # noqa: E402
from repro_torch.kernels.wkv6 import ops, ref  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402


def _inputs(b, h, s, hd, dtype="float32", seed=0):
    """r, k, v, logw (B,H,S,hd) and u (H,hd), float32 numpy; r, k, v
    rounded to bf16 when `dtype` is bfloat16; logw = -exp(n - 2)."""
    rng = np.random.default_rng(seed)
    r, k, v, n = (rng.standard_normal((b, h, s, hd), dtype=np.float32)
                  for _ in range(4))
    if dtype == "bfloat16":
        r, k, v = (np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                              .astype(jnp.float32)) for a in (r, k, v))
    logw = -np.exp(n - 2.0)
    u = (0.4 + 0.2 * rng.standard_normal((h, hd))).astype(np.float32)
    return r, k, v, logw, u


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want, what, tol=1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, what
    bound = tol * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max abs {err} > {bound}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32), (128, 64)])
@pytest.mark.parametrize("h,hd", [(2, 16), (3, 32)])
def test_matches_reference_kernel_and_oracle(dtype, s, chunk, h, hd):
    b = 2
    r, k, v, logw, u = _inputs(b, h, s, hd, dtype)
    j = [jnp.asarray(a) for a in (r, k, v, logw, u)]
    y_k, st_k = WK.wkv6(*j, chunk=chunk, interpret=True)
    st_o, y_o = WR.wkv(*j, jnp.zeros((b, h, hd, hd), jnp.float32))
    y, st = ops.wkv6_with_state(*_t(r, k, v, logw, u), chunk)
    assert y.dtype == st.dtype == torch.float32
    _close(y, y_k, "y vs the reference's kernel")
    _close(st, st_k, "state vs the reference's kernel")
    _close(y, y_o, "y vs the reference's oracle")
    _close(st, st_o, "state vs the reference's oracle")


def test_sequential_oracle_matches_reference():
    b, h, s, hd = 2, 2, 24, 16
    r, k, v, logw, u = _inputs(b, h, s, hd, seed=3)
    st0 = np.random.default_rng(4).standard_normal(
        (b, h, hd, hd), dtype=np.float32)
    st_w, y_w = WR.wkv(*(jnp.asarray(a) for a in (r, k, v, logw, u, st0)))
    st_g, y_g = ref.wkv(*_t(r, k, v, logw, u, st0))
    _close(y_g, y_w, "y")
    _close(st_g, st_w, "state")


@pytest.mark.parametrize("b,h,s,hd,chunk", [(1, 2, 64, 16, 16),
                                            (2, 3, 128, 32, 32)])
def test_function_grads_match_custom_vjp(b, h, s, hd, chunk):
    """Gradients of sum(y^2) in r, k, v, logw and u: the Function
    (forward by the kernel's plain version, backward through the chunked
    path) against jax.grad of the reference's custom_vjp."""
    r, k, v, logw, u = _inputs(b, h, s, hd, seed=5)
    want = jax.grad(lambda *a: jnp.sum(WO.wkv6(*a, chunk) ** 2),
                    argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (r, k, v, logw, u)))
    xs = [t.requires_grad_() for t in _t(r, k, v, logw, u)]
    got = torch.autograd.grad((ops.wkv6(*xs, chunk) ** 2).sum(), xs)
    for name, g, w in zip("r k v logw u".split(), got, want):
        _close(g, w, f"d{name}")


def test_remat_chunks_changes_nothing():
    """Checkpointing each chunk of the recompute gives the same values and
    gradients, bit for bit (bf16 inputs, as the model passes them)."""
    r, k, v, logw, u = _inputs(2, 2, 64, 16, "bfloat16", seed=6)
    outs = []
    for remat in (False, True):
        xs = [t.requires_grad_() for t in _t(r, k, v, logw, u)]
        xs[:3] = [x.detach().bfloat16().requires_grad_() for x in xs[:3]]
        y, st = ops.plain(*xs, 16, remat_chunks=remat)
        grads = torch.autograd.grad((y.float() ** 2).sum() + st.sum(), xs)
        outs.append((y, st, grads))
    (y1, s1, g1), (y2, s2, g2) = outs
    assert y1.dtype == torch.bfloat16
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_bf16_inputs_keep_their_dtype():
    """The model passes bf16 r, k, v (transposed views) and float32 logw
    and u: y comes back in r's dtype, every gradient in its input's."""
    r, k, v, logw, u = _inputs(1, 2, 32, 16, "bfloat16", seed=7)
    tr = lambda a: a.transpose(1, 2).contiguous().transpose(1, 2)  # noqa
    xs = [tr(t.bfloat16()).requires_grad_() for t in _t(r, k, v)]
    xs += [t.requires_grad_() for t in _t(logw, u)]
    y = ops.wkv6(*xs, 16)
    assert y.dtype == torch.bfloat16 and y.shape == xs[0].shape
    y32 = ops.wkv6_with_state(*(x.detach().float() for x in xs), 16)[0]
    _close(y.float(), y32, "bf16 y", tol=2 ** -8)
    grads = torch.autograd.grad(y.float().sum(), xs)
    assert [g.dtype for g in grads] == [x.dtype for x in xs]


def test_wrapper_checks():
    r, k, v, logw, u = _t(*_inputs(1, 2, 32, 16))
    before = K.wkv6.launches
    ops.wkv6_with_state(r, k, v, logw, u, 16)
    assert K.wkv6.launches == before          # CPU: the plain version
    with pytest.raises(ValueError, match="CUDA device"):
        K.wkv6(r, k, v, logw, u, chunk=16)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.wkv6_with_state(*(a.to("meta") for a in (r, k, v, logw, u)))
    # the plain version is the model's chunked path, zero initial state
    y, st = ops.plain(r, k, v, logw, u, 16)
    st2, y2 = rwkv6.wkv_chunked(*(a.transpose(1, 2) for a in (r, k, v, logw)),
                                u, torch.zeros(1, 2, 16, 16), chunk=16)
    assert torch.equal(y, y2.transpose(1, 2)) and torch.equal(st, st2)
