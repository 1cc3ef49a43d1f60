"""The plain recurrences on a rank's share of an SSM state, in one process:
the reference's layouts where the heads do not divide 'model' cut
RWKV-6's WKV state (B, H, hd_k, hd_v) over its k dim and Mamba2's SSM
state (B, H, P, N) over P.  Each share's WKV (sequential, chunked, and
the chunked path's sequential fall-back) summed over the shares, and each
share's SSD scan (sequential, chunked) joined over P, equal the
whole-head call, y and state, within 1e-6 of max |whole|; the
`combine` hook of ``wkv_chunked`` sees the float32 y before its rounding
to r's dtype.  ``Engine(..., local=True)`` takes a rank's blocks as they
are (a fake process group: nothing moves)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist  # noqa: E402
from repro_torch.models import mamba2, rwkv6  # noqa: E402

TOL = 1e-6


def _held(got, want):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TOL * scale


def _wkv_inputs(b, s, h, hd, dtype=torch.float32):
    rng = np.random.default_rng(7)
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    r, k, v = (t(b, s, h, hd).to(dtype) for _ in range(3))
    logw = -torch.exp(t(b, s, h, hd) - 1.0)
    return r, k, v, logw, 0.5 * t(h, hd), t(b, h, hd, hd)


@pytest.mark.parametrize("shares", [2, 4])
@pytest.mark.parametrize("path,s", [("sequential", 8), ("chunked", 32),
                                    ("fallback", 20)])
def test_wkv_k_shares_sum_to_the_whole(path, s, shares):
    """k rows [i*hd/M, (i+1)*hd/M) of every head of r, k, logw, u and the
    state, v whole: the shares' y summed is the whole y, their states
    joined on k the whole state."""
    r, k, v, logw, u, st = _wkv_inputs(2, s, 3, 16)
    if path == "sequential":
        fn = rwkv6.wkv_sequential
    else:
        fn = lambda *a: rwkv6.wkv_chunked(*a, chunk=8)  # noqa: E731
    st_w, y_w = fn(r, k, v, logw, u, st)
    kw = 16 // shares
    parts = [fn(*(a[..., i * kw:(i + 1) * kw] for a in (r, k)), v,
                logw[..., i * kw:(i + 1) * kw], u[:, i * kw:(i + 1) * kw],
                st[:, :, i * kw:(i + 1) * kw])
             for i in range(shares)]
    _held(sum(y for _, y in parts), y_w)
    _held(torch.cat([x for x, _ in parts], dim=2), st_w)


@pytest.mark.parametrize("s", [32, 20])
def test_wkv_chunked_combine_sees_float32(s):
    """bf16 r, k, v: `combine` gets the float32 y (the chunks' or the
    fall-back's) and the result is rounded as without it, so a share's
    partial is summed before the one rounding of the whole call."""
    r, k, v, logw, u, st = _wkv_inputs(2, s, 2, 8, torch.bfloat16)
    seen = []

    def combine(y):
        seen.append(y.dtype)
        return y

    st_a, y_a = rwkv6.wkv_chunked(r, k, v, logw, u, st, chunk=8)
    st_b, y_b = rwkv6.wkv_chunked(r, k, v, logw, u, st, chunk=8,
                                  combine=combine)
    assert seen == [torch.float32]
    assert y_a.dtype == y_b.dtype and torch.equal(y_a, y_b)
    assert torch.equal(st_a, st_b)


@pytest.mark.parametrize("shares", [2, 4])
@pytest.mark.parametrize("chunked", [False, True])
def test_ssd_p_shares_join_to_the_whole(chunked, shares):
    """P channels [i*P/M, (i+1)*P/M) of every head of x and the state, dt,
    the log decay, B and C whole: the shares' y and states joined on P
    are the whole call's."""
    rng = np.random.default_rng(11)
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    b, s, h, p, n = 2, 32, 3, 16, 8
    x, bm, cm_, st = t(b, s, h, p), t(b, s, h, n), t(b, s, h, n), \
        t(b, h, p, n)
    dt = torch.nn.functional.softplus(t(b, s, h))
    la = -dt * torch.exp(t(h))
    fn = (lambda *a: mamba2.ssd_chunked(*a, chunk=8)) if chunked \
        else mamba2.ssd_sequential  # noqa: E731
    st_w, y_w = fn(x, dt, la, bm, cm_, st)
    pw = p // shares
    parts = [fn(x[..., i * pw:(i + 1) * pw], dt, la, bm, cm_,
                st[:, :, i * pw:(i + 1) * pw]) for i in range(shares)]
    _held(torch.cat([y for _, y in parts], dim=-1), y_w)
    _held(torch.cat([x_ for x_, _ in parts], dim=2), st_w)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_engine_takes_local_blocks(arch):
    """A rank given its own blocks (``local=True``, as a rank that draws
    its params a leaf at a time and keeps its block) holds the same
    params as one given the whole tree, on a (1, 4) mesh of a fake
    process group, k- or P-cut (the reduced 2 SSM heads); a whole tree
    passed as blocks raises, naming a leaf."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.core import partitioning as part
    from repro_torch.models import common as cm
    from repro_torch.models import get_model
    from repro_torch.serve.engine import Engine, ServeConfig, param_specs
    cfg = dataclasses.replace(torch_dist.serve_cfg(arch), dtype="bfloat16")
    params = get_model(cfg).init(0, cfg, device="cpu")
    with torch_dist.fake_mesh((1, 4), rank=3) as mesh:
        whole = Engine(cfg, ParallelConfig(), ServeConfig(), params,
                       mesh=mesh, device="cpu")
        blocks = part.shard_tree(params, param_specs(cfg, "mlr", mesh), mesh)
        local = Engine(cfg, ParallelConfig(), ServeConfig(), blocks,
                       mesh=mesh, device="cpu", local=True)
        with pytest.raises(ValueError, match="embed.tokens is"):
            Engine(cfg, ParallelConfig(), ServeConfig(), params, mesh=mesh,
                   device="cpu", local=True)          # the whole tree
    got, want = (cm.flatten_paths(e.params) for e in (local, whole))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    if arch == "rwkv6-3b":          # stacked (L, d, d): columns cut
        assert want["layers.tmix.w_r"].shape[2] * 4 == cfg.d_model
    else:                           # stacked (L, d_in, d): rows cut
        assert want["layers.mamba.w_out"].shape[1] * 4 == 2 * cfg.d_model
