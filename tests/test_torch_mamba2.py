"""The port's Mamba2 ops (`models/mamba2.py`) against the reference's, on
the same numpy inputs, float32: `causal_conv` (with and without a
carried state, and streamed step by step equal to one batched call),
`ssd_sequential`, `ssd_chunked` (and its fallback to the sequential scan
when the length is not a multiple of the chunk) and `mamba_block` (the
reduced zamba2-7b's first layer, the reference's params carried over by
`convert.params_from_reference`), each within 1e-5 of max |ref|; the
port's chunked SSD against its own sequential scan, and both scans'
gradients at decays strong enough to overflow the reference's chunked
scan (NaN there) against ``jax.grad`` through the reference's sequential
scan."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduce_config as ref_reduce  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import mamba2 as RM  # noqa: E402
from repro.models import zamba as RZ  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import mamba2 as PM  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

RTOL = 1e-5


def _close(got, want, what, rtol=RTOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape, what
    bound = rtol * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max abs {err} > {bound}"


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _ssd_inputs(seed, b=2, s=16, h=4, p=8, n=6):
    """x (B,S,H,P), dt (B,S,H) > 0, la = dt * A (A < 0), Bm/Cm (B,S,H,N),
    a nonzero initial state (B,H,P,N)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, s, h))).astype(
        np.float32) * 10
    a = -rng.uniform(1.0, 16.0, h).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, h, n), dtype=np.float32)
              for _ in range(2))
    st = 0.5 * rng.standard_normal((b, h, p, n), dtype=np.float32)
    return x, dt, (dt * a).astype(np.float32), bm, cm, st


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 6), dtype=np.float32)
    w = rng.standard_normal((4, 6), dtype=np.float32)
    st = rng.standard_normal((2, 3, 6), dtype=np.float32) if with_state \
        else None
    y_r, s_r = RM.causal_conv(jnp.asarray(x), jnp.asarray(w),
                              None if st is None else jnp.asarray(st))
    y, s = PM.causal_conv(*_t(x, w), None if st is None else _t(st)[0])
    _close(y, y_r, "y")
    _close(s, s_r, "state")
    assert s.dtype == torch.float32


def test_causal_conv_streamed_equals_batched():
    """One step at a time, carrying the state, gives the batched call's
    outputs and final state."""
    rng = np.random.default_rng(1)
    x, w = _t(rng.standard_normal((2, 7, 5), dtype=np.float32),
              rng.standard_normal((4, 5), dtype=np.float32))
    y_all, st_all = PM.causal_conv(x, w)
    st, ys = None, []
    for t in range(x.shape[1]):
        y, st = PM.causal_conv(x[:, t:t + 1], w, st)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), y_all, rtol=0, atol=1e-6)
    torch.testing.assert_close(st, st_all, rtol=0, atol=0)


def test_ssd_sequential_matches_reference():
    args = _ssd_inputs(2)
    st_r, y_r = RM.ssd_sequential(*map(jnp.asarray, args))
    st, y = PM.ssd_sequential(*_t(*args))
    _close(y, y_r, "y")
    _close(st, st_r, "state")


@pytest.mark.parametrize("s,chunk", [(16, 4), (16, 16), (12, 128),
                                     (10, 4)])
def test_ssd_chunked_matches_reference(s, chunk):
    """Whole chunks, one chunk, a chunk wider than the sequence, and S 10
    with chunk 4: the fallback to the sequential scan."""
    args = _ssd_inputs(3, s=s)
    st_r, y_r = RM.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    st, y = PM.ssd_chunked(*_t(*args), chunk=chunk)
    _close(y, y_r, "y")
    _close(st, st_r, "state")
    assert y.dtype == st.dtype == torch.float32


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_equals_sequential(chunk):
    args = _t(*_ssd_inputs(4, s=32))
    st_c, y_c = PM.ssd_chunked(*args, chunk=chunk)
    st_s, y_s = PM.ssd_sequential(*args)
    _close(y_c, y_s.numpy(), "y")
    _close(st_c, st_s.numpy(), "state")


@pytest.mark.parametrize("chunk", [16, 32])
def test_ssd_chunked_strong_decay_gradients_finite(chunk):
    """Decays summing to ~-500 within a chunk (exp of the masked-out
    exponents above the diagonal overflows float32): the chunked scan's
    values equal the reference's, and its gradients and the sequential
    scan's are finite and equal to ``jax.grad`` of the same loss through
    the reference's sequential scan (the reference's chunked gradients
    are NaN there: it masks after its exp)."""
    x, dt, la, bm, cm_, st = _ssd_inputs(5, s=32)
    la = (la * 8).astype(np.float32)
    ins = (x, dt, la, bm, cm_, st)
    st_r, y_r = RM.ssd_chunked(*map(jnp.asarray, ins), chunk=chunk)
    assert float(np.asarray(la).sum(1).min()) < -400

    def ref_loss(*a):
        state, y = RM.ssd_sequential(*a)
        return (y ** 2).sum() + (state ** 2).sum()
    want = jax.grad(ref_loss, argnums=tuple(range(6)))(
        *map(jnp.asarray, ins))
    for fn in (lambda *a: PM.ssd_chunked(*a, chunk=chunk),
               PM.ssd_sequential):
        ts = [t.requires_grad_() for t in _t(*ins)]
        state, y = fn(*ts)
        _close(y, y_r, "y")
        _close(state, st_r, "state")
        loss = (y ** 2).sum() + (state ** 2).sum()
        got = torch.autograd.grad(loss, ts)
        for name, g, w in zip(("x", "dt", "la", "B", "C", "state"), got,
                              want):
            assert torch.isfinite(g).all(), name
            _close(g, w, f"grad {name}")


@pytest.mark.parametrize("chunked", [True, False])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_block_matches_reference(chunked, with_state):
    """The reduced zamba2-7b's first mamba layer, float32, from zero
    states or from carried ones."""
    rcfg = dataclasses.replace(ref_reduce(ref_get_config("zamba2-7b")),
                               dtype="float32")
    cfg = dataclasses.replace(reduce_config(get_config("zamba2-7b")),
                              dtype="float32")
    rparams = RZ.init(jax.random.PRNGKey(0), rcfg)
    flat = {k: np.asarray(v)
            for k, v in ref_common.flatten_paths(rparams).items()}
    pl = PT._layer(params_from_reference(flat, cfg), 0)["mamba"]
    rpl = jax.tree.map(lambda a: a[0], rparams["layers"]["mamba"])
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, cfg.d_model), dtype=np.float32)
    d_in, ssm = 2 * cfg.d_model, cfg.ssm
    ch = d_in + 2 * ssm.n_groups * ssm.state_dim
    conv = rng.standard_normal((2, ssm.conv_width - 1, ch),
                               dtype=np.float32) if with_state else None
    st = rng.standard_normal((2, ssm.n_ssm_heads, d_in // ssm.n_ssm_heads,
                              ssm.state_dim), dtype=np.float32) \
        if with_state else None
    want = RM.mamba_block(rpl, jnp.asarray(x), rcfg,
                          conv_state=None if conv is None
                          else jnp.asarray(conv),
                          ssm_state=None if st is None else jnp.asarray(st),
                          chunked=chunked)
    got = PM.mamba_block(pl, torch.from_numpy(x), cfg,
                         conv_state=None if conv is None
                         else torch.from_numpy(conv),
                         ssm_state=None if st is None
                         else torch.from_numpy(st), chunked=chunked)
    for g, w, what in zip(got, want, ("out", "conv state", "ssm state")):
        _close(g, w, what)
