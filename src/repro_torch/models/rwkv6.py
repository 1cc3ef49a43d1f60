"""RWKV6 ("Finch") — attention-free LM with data-dependent per-channel
decay, the ``ssm`` family (port of ``repro/models/rwkv6.py``).

Time-mix recurrence per head (k/v dims = head_dim):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (w_t = exp(-exp(lora(x_t))))
    y_t = r_t · (S_{t-1} + diag(u ⊙ k_t) 1 v_t^T)  ==  r·S + (r·(u⊙k)) v

Two implementations in plain PyTorch:
* sequential — a loop over time; the oracle and the decode path (O(1)
  state);
* chunked — cumulative-log-decay blocks; the intra-chunk term builds the
  per-channel decay tensor exp(t_i - s_j) (all exponents <= 0, so no
  overflow).  It is also the plain version of the WKV6 kernel
  (`kernels/wkv6`) and the path its gradient recomputes through.

`time_mix` keeps the reference's three-way dispatch: sequential when
asked (decode); the WKV6 kernel when ``attn_impl == "pallas"`` on a
fresh sequence (zero initial state: training's `forward`) whose length
is a multiple of min(chunk, 64); the chunked path otherwise (prefill).
The reference's serving path therefore never reaches the kernel.

Mixed precision as the reference: bf16 token-shift mixes and
projections, the log-decay ``-exp(dec - 2)`` in float32, the per-head
``ln_x`` RMS norm in float32, ``square(relu)`` in the channel mix, and
float32 carried states.  Layer weights are stacked on a leading L dim;
the reference's scan over them is a Python loop.  ``forward`` honours
``pcfg.remat == "full"`` with ``torch.utils.checkpoint`` per layer, the
counterpart of ``jax.checkpoint(..., nothing_saveable)``.  Serving
(prefill, decode) has no backward and no remat.  The cache is a dict of
fresh tensors (the caller's is not changed); ``cache["pos"]`` is a
Python int.  The reference's sharding (``cm.shard``, ``cache_specs``)
has no counterpart on one card.

Simplifications vs. the published model (as in the reference): static
token-shift interpolation weights (RWKV5-style mu) instead of the dynamic
data-dependent mix lora; decay lora has no w0 bias; ln_x is per-head RMS
with scale.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig, ParallelConfig, _param_shapes
from repro_torch.models import common as cm
from repro_torch.models.transformer import _layer as _layer_params
from repro_torch.models.transformer import embed_tokens, logits_fn

XLA_CHUNK = 32  # intra-chunk tensor is (B, c, c, H, hd) — keep c modest


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not "
                                  f"RWKV6 (the ssm family)")


def init(gen, cfg: ModelConfig, device="cuda"):
    """Float32 params of `cfg` drawn with `gen` (a ``torch.Generator`` on
    `device`, or an int seed for one)."""
    _check_family(cfg)
    dev = cm.check_device(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    return cm.init_from_shapes(gen, _param_shapes(cfg), dev)


# ----------------------------------------------------------------------------
# WKV6 core
# ----------------------------------------------------------------------------


def _einsum(eq, *operands):
    """``torch.einsum`` in the operands' promoted dtype, as ``jnp.einsum``
    (bf16 with float32 -> float32)."""
    dt = operands[0].dtype
    for x in operands[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return torch.einsum(eq, *(x.to(dt) for x in operands))


def wkv_sequential(r, k, v, logw, u, state):
    """r/k/v/logw (B,S,H,hd); u (H,hd); state (B,H,hd,hd) [k-dim, v-dim].
    Returns (state', y (B,S,H,hd)), in JAX's promoted dtypes (the
    chunked path's fall-back passes bf16 r, k, v)."""
    ys = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = (a[:, t] for a in (r, k, v, logw))  # (B,H,hd)
        kv = _einsum("bhk,bhv->bhkv", k_t, v_t)
        y = (_einsum("bhk,bhkv->bhv", r_t, state)
             + _einsum("bhk,bhk->bh", r_t, u[None] * k_t)[..., None] * v_t)
        state = state * torch.exp(w_t)[..., None] + kv
        ys.append(y)
    return state, torch.stack(ys, dim=1)


def _chunk_body(st, rc, kc, vc, wc, u):
    """One chunk: (state', y (B,c,H,hd) float32) from the state before
    it; inputs (B,c,H,hd)."""
    rc, kc, vc, wc = (a.float() for a in (rc, kc, vc, wc))
    c = rc.shape[1]
    scum = torch.cumsum(wc, dim=1)                 # inclusive (B,c,H,hd)
    texc = scum - wc                               # exclusive
    # intra-chunk: D[i,j] = t_i - s_j  (<= 0 for j < i)
    diff = texc[:, :, None] - scum[:, None, :]     # (B,ci,cj,H,hd)
    ar = torch.arange(c, device=rc.device)
    mask = ar[:, None] > ar[None, :]
    dec = torch.where(mask[None, :, :, None, None], torch.exp(diff), 0.0)
    scores = torch.einsum("bihd,bijhd,bjhd->bhij", rc, dec, kc)
    y = torch.einsum("bhij,bjhd->bihd", scores, vc)
    # diagonal bonus term
    dsc = torch.einsum("bihd,hd,bihd->bhi", rc, u.float(), kc)
    y = y + dsc.transpose(1, 2)[..., None] * vc
    # inter-chunk: r_i decayed from chunk start times prior state
    rt = rc * torch.exp(texc)
    y = y + torch.einsum("bihk,bhkv->bihv", rt, st)
    # state update
    s_last = scum[:, -1]                           # (B,H,hd)
    kd = kc * torch.exp(s_last[:, None] - scum)
    st_new = (st * torch.exp(s_last)[..., None]
              + torch.einsum("bjhk,bjhv->bhkv", kd, vc))
    return st_new, y


def wkv_chunked(r, k, v, logw, u, state, chunk: int = XLA_CHUNK, *,
                remat_chunks: bool = False):
    """Chunked evaluation; exact (up to fp) match with wkv_sequential,
    to which it falls back when S is not a multiple of the chunk.  Returns
    (state' float32, y (B,S,H,hd) in r's dtype).  `remat_chunks`
    recomputes each chunk in the backward (``torch.utils.checkpoint``)
    instead of keeping its decay tensors: the same values, the memory of
    one chunk."""
    b, s, h, hd = r.shape
    c = min(chunk, s)
    if s % c != 0:
        return wkv_sequential(r, k, v, logw, u, state)
    st = state.float()
    ys = []
    for i in range(s // c):
        sl = slice(i * c, (i + 1) * c)
        args = (st, r[:, sl], k[:, sl], v[:, sl], logw[:, sl], u)
        if remat_chunks:
            st, y = torch.utils.checkpoint.checkpoint(_chunk_body, *args,
                                                      use_reentrant=False)
        else:
            st, y = _chunk_body(*args)
        ys.append(y)
    return st, torch.cat(ys, dim=1).to(r.dtype)


# ----------------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------------


def _shift(x, x_prev):
    """xs[t] = x[t-1]; x_prev (B,d) fills t=0."""
    return torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def time_mix(p, x, x_prev, cfg: ModelConfig, pcfg: ParallelConfig,
             state, *, sequential: bool, fresh: bool = False):
    b, s, d = x.shape
    h = cfg.ssm.n_ssm_heads
    hd = d // h
    xs = _shift(x, x_prev)
    mu = cm.cast(p["mu"], cfg)                     # (5, d)
    xr, xk, xv, xw, xg = (x + mu[i] * (xs - x) for i in range(5))
    r = cm.matmul(xr, cm.cast(p["w_r"], cfg))
    k = cm.matmul(xk, cm.cast(p["w_k"], cfg))
    v = cm.matmul(xv, cm.cast(p["w_v"], cfg))
    g = F.silu(cm.matmul(xg, cm.cast(p["w_g"], cfg)))
    lora = torch.tanh(cm.matmul(xw, cm.cast(p["w_decay"], cfg)))
    dec = cm.matmul(lora, cm.cast(p["w_decay2"], cfg))
    logw = -torch.exp(dec.float() - 2.0)           # w in (0,1); slow init

    r4, k4, v4, w4 = (a.reshape(b, s, h, hd) for a in (r, k, v, logw))
    u = p["bonus"]                                 # (H, hd)
    chunk = min(cfg.ssm.chunk, 64)
    if sequential:
        state, y = wkv_sequential(r4.float(), k4.float(), v4.float(), w4, u,
                                  state)
    elif pcfg.attn_impl == "pallas" and fresh and s % chunk == 0:
        # the WKV6 kernel (zero initial state = fresh sequence)
        from repro_torch.kernels.wkv6 import ops as wkv_ops
        tr = lambda a: a.transpose(1, 2)  # noqa: E731  (B,S,H,hd)<->(B,H,S,hd)
        y = tr(wkv_ops.wkv6(tr(r4), tr(k4), tr(v4), tr(w4), u, chunk))
        # the state is not needed on the train path
    else:
        state, y = wkv_chunked(r4, k4, v4, w4, u, state,
                               chunk=min(cfg.ssm.chunk, XLA_CHUNK))
    # per-head norm (ln_x), flatten, gate, project out
    yn = cm.rms_norm(y.float(), p["ln_x"].reshape(h, hd), cfg.norm_eps)
    out = yn.reshape(b, s, d).to(x.dtype) * g
    out = cm.matmul(out, cm.cast(p["w_o"], cfg))
    return out, x[:, -1].float(), state


def channel_mix(p, x, x_prev, cfg: ModelConfig):
    xs = _shift(x, x_prev)
    mu = cm.cast(p["mu"], cfg)                     # (2, d)
    xk = x + mu[0] * (xs - x)
    xr = x + mu[1] * (xs - x)
    k = torch.square(F.relu(cm.matmul(xk, cm.cast(p["w_k"], cfg))))
    kv = cm.matmul(k, cm.cast(p["w_v"], cfg))
    r = cm.matmul(xr, cm.cast(p["w_r"], cfg))
    return torch.sigmoid(r) * kv, x[:, -1].float()


def _layer(pl, x, cfg, pcfg, st, *, sequential: bool, fresh: bool = False):
    """st = (wkv_state, tmix_x, cmix_x) -> (x', st')."""
    wkv_state, tx, cx = st
    h = cm.rms_norm(x, pl["norm1"], cfg.norm_eps)
    a, tx_new, wkv_state = time_mix(pl["tmix"], h, tx, cfg, pcfg, wkv_state,
                                    sequential=sequential, fresh=fresh)
    x = x + a
    h = cm.rms_norm(x, pl["norm2"], cfg.norm_eps)
    m, cx_new = channel_mix(pl["cmix"], h, cx, cfg)
    return x + m, (wkv_state, tx_new, cx_new)


# ----------------------------------------------------------------------------
# model API
# ----------------------------------------------------------------------------


def _zero_state(cfg, b, device):
    """One layer's (wkv, tmix_x, cmix_x) zero state, float32."""
    h = cfg.ssm.n_ssm_heads
    hd = cfg.d_model // h
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                   device=device)
    return z(b, h, hd, hd), z(b, cfg.d_model), z(b, cfg.d_model)


def _fresh_layer(pl, x, cfg, pcfg):
    st = _zero_state(cfg, x.shape[0], x.device)
    return _layer(pl, x, cfg, pcfg, st, sequential=False, fresh=True)[0]


def forward(params, batch, cfg: ModelConfig, pcfg: ParallelConfig):
    _check_family(cfg)
    x = embed_tokens(params, batch["tokens"], cfg)
    for i in range(cfg.n_layers):
        pl = _layer_params(params, i)
        if pcfg.remat == "full":
            x = torch.utils.checkpoint.checkpoint(
                _fresh_layer, pl, x, cfg, pcfg, use_reentrant=False)
        else:
            x = _fresh_layer(pl, x, cfg, pcfg)
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return x, {"aux_loss": torch.zeros((), dtype=torch.float32,
                                       device=x.device)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               pcfg: ParallelConfig, device="cuda"):
    """Zero float32 states (L, ...) for every layer, position 0.  The
    state is O(1) in the sequence: `max_seq` is not used."""
    _check_family(cfg)
    dev = cm.check_device(device)
    wkv, tx, cx = _zero_state(cfg, batch, dev)
    stack = lambda a: a.expand(cfg.n_layers, *a.shape).clone()  # noqa: E731
    return {"wkv": stack(wkv), "tmix_x": stack(tx), "cmix_x": stack(cx),
            "pos": 0,
            "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def _run_cached(params, x, cfg, pcfg, cache, *, sequential):
    states = []
    for i in range(cfg.n_layers):
        st = (cache["wkv"][i], cache["tmix_x"][i], cache["cmix_x"][i])
        x, st = _layer(_layer_params(params, i), x, cfg, pcfg, st,
                       sequential=sequential)
        states.append(st)
    wkv, tx, cx = (torch.stack(a) for a in zip(*states))
    return x, wkv, tx, cx


def prefill(params, batch, cache, cfg: ModelConfig, pcfg: ParallelConfig):
    """Runs the prompt from the cache's states; returns (cache,
    last_hidden (B,1,d))."""
    _check_family(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = embed_tokens(params, tokens, cfg)
    x, wkv, tx, cx = _run_cached(params, x, cfg, pcfg, cache,
                                 sequential=False)
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    new_cache = {"wkv": wkv, "tmix_x": tx, "cmix_x": cx,
                 "pos": cache["pos"] + s, "lengths": cache["lengths"] + s}
    return new_cache, x[:, -1:]


def decode(params, tokens, cache, cfg: ModelConfig, pcfg: ParallelConfig):
    """One token step.  tokens (B, 1) -> (cache', logits (B, 1, V))."""
    _check_family(cfg)
    x = embed_tokens(params, tokens, cfg)
    x, wkv, tx, cx = _run_cached(params, x, cfg, pcfg, cache,
                                 sequential=True)
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = logits_fn(params, x, cfg)
    new_cache = {"wkv": wkv, "tmix_x": tx, "cmix_x": cx,
                 "pos": cache["pos"] + 1, "lengths": cache["lengths"] + 1}
    return new_cache, logits


def cache_specs(cfg, pcfg, long_ctx: bool, model_size: int = 16):
    """The cache's specs on a mesh: this family does not run sharded
    yet (``models.check_mesh``)."""
    from repro_torch.models.transformer import MESH_TODO
    raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family's "
                              f"sharded cache waits for {MESH_TODO}")
