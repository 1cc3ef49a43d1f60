"""The port's WKV6 recurrence (`kernels/wkv6`) against the reference, same
numpy inputs: the kernel's plain version (`ops.wkv6_with_state` on the
CPU) against the reference's Pallas kernel in interpret mode and its
sequential oracle at the reference test's grid, `y` and the final state;
the port's sequential oracle against the reference's; the autograd
Function's gradients against ``jax.grad`` of the reference's
``custom_vjp``; per-chunk remat in the recompute; the wrapper's checks.
The CUDA kernel's own arithmetic (`ref.subchunk_factorised`: 16-row
sub-blocks, pairwise exps on the diagonal blocks, factorised products
elsewhere, optionally as 3xTF32) against the same references, at strong
decays too, where it must stay finite; the layout checks, the launch
plan and the workspace of the kernel's wrapper.

Tolerances: 1e-5 x max |ref| for `y` and the state — the inputs are
float32 (bf16 cases draw bf16-representable values, as the reference
test), and only the order of float32 sums differs; gradients 1e-5 of
each one's max |g|.  At strong decays (logw = -exp(n + 2), sums of
hundreds within a chunk) the reference's chunked kernel is itself
~1e-5-4e-5 of max |y| from a float64 evaluation (its exponents are
differences of those sums), so there the factorised arithmetic is held
to 1e-5 against the sequential oracle and the float64 evaluation, and
must be closer to the latter than the reference's kernel is."""
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


#: logw = -exp(n + shift): the reference test's decays, and strong ones
DECAYS = {"normal": -2.0, "strong": 2.0}


def _inputs(b, h, s, hd, dtype="float32", seed=0, decay="normal"):
    """r, k, v, logw (B,H,S,hd) and u (H,hd), float32 numpy; r, k, v
    rounded to bf16 when `dtype` is bfloat16; logw = -exp(n + DECAYS[
    decay])."""
    rng = np.random.default_rng(seed)
    r, k, v, n = (rng.standard_normal((b, h, s, hd), dtype=np.float32)
                  for _ in range(4))
    if dtype == "bfloat16":
        r, k, v = (np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                              .astype(jnp.float32)) for a in (r, k, v))
    logw = -np.exp(n + DECAYS[decay])
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


def _err(got, want) -> float:
    """max |got - want| over max |want|, in float64."""
    got, want = (a.detach().double() if torch.is_tensor(a)
                 else torch.from_numpy(np.array(a, np.float64))
                 for a in (got, want))
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("decay", ["normal", "strong"])
@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32), (128, 64)])
@pytest.mark.parametrize("h,hd", [(2, 16), (3, 32), (1, 64)])
def test_subchunk_factorised_matches_reference(decay, s, chunk, h, hd):
    """The kernel's arithmetic, exact float32 products and 3xTF32 ones,
    against the reference's oracle and a float64 evaluation, and at the
    reference test's decays against its interpret-mode kernel; at strong
    decays finite and closer to float64 than the reference's kernel."""
    b = 2
    x = _inputs(b, h, s, hd, seed=11, decay=decay)
    j = [jnp.asarray(a) for a in x]
    y_k, st_k = WK.wkv6(*j, chunk=chunk, interpret=True)
    st_o, y_o = WR.wkv(*j, jnp.zeros((b, h, hd, hd), jnp.float32))
    st64, y64 = ref.wkv(*(t.double() for t in _t(*x)),
                        torch.zeros((b, h, hd, hd), dtype=torch.float64))
    for tf32 in (False, True):
        y, st = ref.subchunk_factorised(*_t(*x), chunk, tf32=tf32)
        assert torch.isfinite(y).all() and torch.isfinite(st).all()
        what = f"factorised (tf32={tf32})"
        _close(y, y_o, f"{what} y vs the reference's oracle")
        _close(st, st_o, f"{what} state vs the reference's oracle")
        _close(y, y64.float(), f"{what} y vs float64")
        _close(st, st64.float(), f"{what} state vs float64")
        if decay == "normal":
            _close(y, y_k, f"{what} y vs the reference's kernel")
            _close(st, st_k, f"{what} state vs the reference's kernel")
        else:
            assert _err(y, y64) < _err(y_k, y64), what


def test_subchunk_factorised_bf16_inputs():
    """bf16 r, k, v (as the model passes them; the kernel upcasts them
    exactly) give the float32 inputs' results, bit for bit."""
    r, k, v, logw, u = _t(*_inputs(2, 2, 64, 32, "bfloat16", seed=12))
    y32, st32 = ref.subchunk_factorised(r, k, v, logw, u, 32, tf32=True)
    y16, st16 = ref.subchunk_factorised(r.bfloat16(), k.bfloat16(),
                                        v.bfloat16(), logw, u, 32, tf32=True)
    assert torch.equal(y16, y32) and torch.equal(st16, st32)


def _model_layout(b, h, s, hd, dtype=torch.bfloat16):
    """r, k, v in `dtype` and logw float32 as (B,H,S,hd) views of (B,S,H,hd)
    tensors, u (H,hd) float32: the model's call."""
    gen = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(b, s, h, hd, generator=gen).to(dtype)
               .transpose(1, 2) for _ in range(3))
    logw = -torch.exp(torch.randn(b, s, h, hd, generator=gen)).transpose(1, 2)
    return r, k, v, logw, torch.randn(h, hd, generator=gen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layout_accepts_the_models_call(dtype):
    """bf16 or float32 r, k, v, float32 logw and u, as transposed views
    or contiguous: the kernel reads them as they are."""
    args = _model_layout(2, 3, 64, 32, dtype)
    K.check_layout(*args, 32)
    K.check_layout(*(a.contiguous() for a in args), 32)


def test_layout_rejects_what_the_kernel_cannot_read():
    r, k, v, logw, u = _model_layout(2, 3, 64, 32)
    bad = {
        "float16 r, k, v": ([a.half() for a in (r, k, v)] + [logw, u],
                            "want one of"),
        "mixed dtypes": ([r, k.float(), v, logw, u], "want one of"),
        "bf16 logw": ([r, k, v, logw.bfloat16(), u], "float32"),
        "bf16 u": ([r, k, v, logw, u.bfloat16()], "float32"),
        "strided hd": ([r, k, v.transpose(-1, -2).contiguous()
                        .transpose(-1, -2), logw, u], "unit stride"),
        "unaligned base": ([torch.empty(r.numel() + 1, dtype=r.dtype)[1:]
                            .view(r.shape), k, v, logw, u], "16-byte"),
        "unaligned stride": ([torch.empty(2, 3, 64, 36, dtype=r.dtype)
                              [..., :32], k, v, logw, u], "16-byte"),
        "wrong u": ([r, k, v, logw, u[:, :16]], "want"),
        "wrong shape": ([r, k[:, :2], v, logw, u], "wkv6"),
    }
    for what, (args, match) in bad.items():
        with pytest.raises(ValueError, match=match):
            K.check_layout(*args, 32)
            pytest.fail(what)
    with pytest.raises(ValueError, match="chunk"):
        K.check_layout(r, k, v, logw, u, 8)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        K.check_layout(*(a[:, :, :48] for a in (r, k, v, logw)), u, 32)
    with pytest.raises(ValueError, match="CUDA device"):
        K.wkv6(r, k, v, logw, u, chunk=32)


@pytest.mark.parametrize("b,h,s,hd,chunk", [
    (4, 40, 2048, 64, 64),   # rwkv6-3b training: 4 x 40 heads of 64
    (2, 3, 128, 32, 16),
    (1, 2, 64, 16, 64),      # one chunk: no state handed on
    (2, 2, 96, 16, 32)])
def test_launch_plan(b, h, s, hd, chunk):
    """A block per chunk of each (batch, head); the workspace holds a
    ticket, a done count and a flag per (batch, head), and two states per
    (batch, head)."""
    got = K.plan(b, h, s, hd, chunk)
    assert got == {"blocks": b * h * (s // chunk),
                   "blocks_per_head": s // chunk, "sync_ints": 2 + b * h,
                   "ring_floats": b * h * 2 * hd * hd}


def test_workspace_kept_per_stream_and_grown():
    """One workspace per (device, stream), `sync` zeroed when made, both
    grown when a launch needs more (CPU tensors stand in for the card's)."""
    dev = torch.device("cpu")
    small, big = K.plan(1, 2, 64, 16, 16), K.plan(2, 3, 64, 32, 16)
    sync, ring = K.workspace(dev, 1, small)
    assert sync.dtype == torch.int32 and not sync.any()
    assert (sync.numel(), ring.numel()) == (4, 2 * 2 * 16 * 16)
    again = K.workspace(dev, 1, small)
    assert again[0] is sync and again[1] is ring
    other = K.workspace(dev, 2, small)
    assert other[0] is not sync and other[1] is not ring
    grown = K.workspace(dev, 1, big)
    assert grown[0].numel() == 8 and grown[1].numel() == 6 * 2 * 32 * 32
    assert K.workspace(dev, 1, small)[0] is grown[0]
    for key in [(None, 1), (None, 2)]:
        K._WORKSPACES.pop(key)
