"""RWKV6 ("Finch") — attention-free LM with data-dependent per-channel
decay, the ``ssm`` family (port of ``repro/models/rwkv6.py``).

Time-mix recurrence per head (k/v dims = head_dim; the plain paths also
take k rows narrower than v, a rank's share of the k-cut state):

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
Python int.

On a mesh (``mesh=``, a ``common.MeshContext``) serving takes the
reference's two layouts of the WKV state (`cache_specs`).  Where the
heads divide 'model', each rank runs its heads: the time mix's
projections column-parallel and ``w_o`` row-parallel.  Where they do
not, the state is cut over its k dim: a rank's column blocks of r, k, v
and g straddle heads, so it gathers r, k and v whole over 'model' (one
fused gather), runs the WKV on its k rows of every head (each row of a
head's state evolves alone, and y is a sum over k), sums its partial y
over 'model' in float32, norms every head, and gates its column block
into the row-parallel ``w_o``.  Either way the channel mix's FFN block
is column- then row-parallel and its receptance gathered over 'model',
each row-parallel product summed over 'model' in float32.

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
from repro_torch.models.transformer import _index
from repro_torch.models.transformer import _layer as _layer_params
from repro_torch.models.transformer import (cache_block, embed_tokens,
                                            gather_layer, logits_fn,
                                            remat_call)

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
    """r/k/logw (B,S,H,dk); v (B,S,H,dv); u (H,dk); state (B,H,dk,dv)
    [k-dim, v-dim] (dk = dv = hd for whole heads; dk a share of hd for a
    rank's k rows, whose y is then that share's term of the sum over k).
    Returns (state', y (B,S,H,dv)), in JAX's promoted dtypes (the
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
    """One chunk: (state', y (B,c,H,dv) float32) from the state before
    it (B,H,dk,dv); rc, kc, wc (B,c,H,dk), vc (B,c,H,dv), u (H,dk).  In
    the einsums ``k`` names the k dim and ``v`` the v dim; ``d`` names
    the k dim, but the v dim in y's product with vc."""
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
                remat_chunks: bool = False, combine=None):
    """Chunked evaluation; exact (up to fp) match with wkv_sequential,
    to which it falls back when S is not a multiple of the chunk.  Shapes
    as `wkv_sequential`'s.  Returns (state' float32, y (B,S,H,dv) in r's
    dtype; the fall-back's promoted dtype).  `remat_chunks` recomputes
    each chunk in the backward (``torch.utils.checkpoint``) instead of
    keeping its decay tensors: the same values, the memory of one chunk.
    `combine`, where given, maps the float32 y before that rounding (a
    rank's share of the sum over k: its sum over 'model')."""
    s = r.shape[1]
    c = min(chunk, s)
    if s % c != 0:
        state, y = wkv_sequential(r, k, v, logw, u, state)
        return state, y if combine is None else combine(y)
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
    y = torch.cat(ys, dim=1)
    return st, (y if combine is None else combine(y)).to(r.dtype)


# ----------------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------------


def _shift(x, x_prev):
    """xs[t] = x[t-1]; x_prev (B,d) fills t=0."""
    return torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def time_mix(p, x, x_prev, cfg: ModelConfig, pcfg: ParallelConfig,
             state, *, sequential: bool, fresh: bool = False, mesh=None):
    """On a mesh, `p` holds this rank's blocks: ``w_{r,k,v,g}`` a column
    block, ``w_o`` its rows; the decay lora's product is whole
    (``w_decay``, ``w_decay2`` gathered over 'data').  Where the block
    is whole heads the rank takes their columns of the decay, ``bonus``
    and ``ln_x``, and `state` holds those heads.  Where it straddles
    heads (the heads do not divide 'model'), `state` holds the rank's k
    rows of every head (all of them where hd does not divide 'model'):
    r, k and v are gathered over 'model', the WKV runs on those rows,
    and its partial y is summed over 'model' (`_k_rows`).  `state` None:
    a fresh sequence (training), a zero state of this rank's layout."""
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
    u, ln_x = p["bonus"], p["ln_x"].reshape(h, hd)  # (H, hd)
    cw = r.shape[-1]                               # this rank's columns
    if cw != d and cw % hd == 0:                   # this rank's heads
        h = cw // hd
        i, _ = mesh.block(("model",))
        dec = dec[..., i * h * hd:(i + 1) * h * hd]
        u, ln_x = u[i * h:(i + 1) * h], ln_x[i * h:(i + 1) * h]
    logw = -torch.exp(dec.float() - 2.0)           # w in (0,1); slow init
    if state is None:
        m = mesh.size(("model",)) if cw != d and cw % hd else 1
        state = torch.zeros((b, h, hd // m if hd % m == 0 else hd, hd),
                            dtype=torch.float32, device=x.device)
    if cw != d and cw % hd:                        # columns straddle heads
        r4, k4, v4, w4, u, combine = _k_rows(r, k, v, logw, u,
                                             state.shape[-2], h, hd, mesh)
    else:
        r4, k4, v4, w4 = (a.reshape(b, s, h, hd) for a in (r, k, v, logw))
        combine = None
    chunk = min(cfg.ssm.chunk, 64)
    if sequential:
        state, y = wkv_sequential(r4.float(), k4.float(), v4.float(), w4, u,
                                  state)
        if combine is not None:
            y = combine(y)
    elif (pcfg.attn_impl == "pallas" and fresh and s % chunk == 0
          and combine is None):
        # the WKV6 kernel (zero initial state = fresh sequence)
        from repro_torch.kernels.wkv6 import ops as wkv_ops
        tr = lambda a: a.transpose(1, 2)  # noqa: E731  (B,S,H,hd)<->(B,H,S,hd)
        y = tr(wkv_ops.wkv6(tr(r4), tr(k4), tr(v4), tr(w4), u, chunk))
        # the state is not needed on the train path
    else:
        state, y = wkv_chunked(r4, k4, v4, w4, u, state,
                               chunk=min(cfg.ssm.chunk, XLA_CHUNK),
                               combine=combine)
    # per-head norm (ln_x), flatten, gate, project out
    yn = cm.rms_norm(y.float(), ln_x, cfg.norm_eps).reshape(b, s, h * hd)
    if h * hd != cw:                               # this rank's columns
        i, _ = mesh.block(("model",))
        yn = yn[..., i * cw:(i + 1) * cw]
    out = yn.to(x.dtype) * g
    return _out_proj(out, p["w_o"], d, cfg, mesh), x[:, -1].float(), state


def _k_rows(r, k, v, logw, u, kw: int, h: int, hd: int, mesh):
    """The k-cut WKV state's inputs on one rank (serving): r, k, v
    (B,S,cw) column blocks that straddle heads, gathered whole over
    'model' in one fused gather; the rank's `kw` k rows of every head of
    r, k, the whole log-decay `logw` (B,S,d) and `u` (H,hd) (the rows
    its state holds; all of them where `kw` is hd); v whole.  Returns
    (r, k, v, logw, u, combine): the first four (B,S,H,.), and the sum
    over 'model' of the rank's float32 partial y (each row of a head's
    state evolves alone and y is a sum over k, so the sum is y, rounded
    after it as the whole call rounds it)."""
    b, s, cw = r.shape
    model = ("model",)
    m = mesh.size(model)
    rkv = mesh.gather(torch.cat([r, k, v], dim=-1), -1, model)
    r, k, v = rkv.reshape(b, s, m, 3, cw).unbind(3)
    i = mesh.block(model)[0] if kw < hd else 0
    rows = slice(i * kw, (i + 1) * kw)
    r4, k4, w4 = (a.reshape(b, s, h, hd)[..., rows] for a in (r, k, logw))

    def combine(y):
        return mesh.sum(y, model) if kw < hd else y

    return r4, k4, v.reshape(b, s, h, hd), w4, u[:, rows], combine


def _out_proj(x, w, rows: int, cfg, mesh):
    """``x @ w``; where `w`'s rows are cut over 'model' (fewer than
    `rows`), the row-parallel product summed over 'model'."""
    w = cm.cast(w, cfg)
    if w.shape[0] != rows:
        return cm.row_parallel(x, w, mesh)
    return cm.matmul(x, w)


def channel_mix(p, x, x_prev, cfg: ModelConfig, mesh=None):
    """On a mesh, `p` holds this rank's blocks: ``w_k`` its FFN columns
    and ``w_v`` their rows (a row-parallel product), ``w_r`` its columns
    of the receptance, gathered over 'model'."""
    d = x.shape[-1]
    xs = _shift(x, x_prev)
    mu = cm.cast(p["mu"], cfg)                     # (2, d)
    xk = x + mu[0] * (xs - x)
    xr = x + mu[1] * (xs - x)
    k = torch.square(F.relu(cm.matmul(xk, cm.cast(p["w_k"], cfg))))
    kv = _out_proj(k, p["w_v"], cfg.d_ff, cfg, mesh)
    r = cm.matmul(xr, cm.cast(p["w_r"], cfg))
    if r.shape[-1] != d:
        r = mesh.gather(r, -1, ("model",))
    if kv.shape[1] != r.shape[1]:    # w_v's exit kept this rank's rows
        r = cm.seq_rows(r, mesh)
    return torch.sigmoid(r) * kv, x[:, -1].float()


def _layer(pl, x, cfg, pcfg, st, *, sequential: bool, fresh: bool = False,
           mesh=None):
    """st = (wkv_state, tmix_x, cmix_x) -> (x', st').  Where the residual
    is cut over the sequence (training), each mix norms this rank's rows,
    gathers them over 'model' and keeps its rows of the output (the
    reference's SP residual spec, ``_residual_spec``)."""
    wkv_state, tx, cx = st
    h = cm.seq_join(cm.rms_norm(x, pl["norm1"], cfg.norm_eps), mesh)
    a, tx_new, wkv_state = time_mix(pl["tmix"], h, tx, cfg, pcfg, wkv_state,
                                    sequential=sequential, fresh=fresh,
                                    mesh=mesh)
    x = x + cm.seq_leave(a, x, mesh)
    h = cm.seq_join(cm.rms_norm(x, pl["norm2"], cfg.norm_eps), mesh)
    m, cx_new = channel_mix(pl["cmix"], h, cx, cfg, mesh)
    return x + cm.seq_leave(m, x, mesh), (wkv_state, tx_new, cx_new)


# ----------------------------------------------------------------------------
# model API
# ----------------------------------------------------------------------------


def _fresh_layer(pl, x, cfg, pcfg, mesh=None):
    """One layer from zero states (the WKV state's of this rank's
    layout, `time_mix`), its weights gathered over 'data' here."""
    z = torch.zeros((x.shape[0], cfg.d_model), dtype=torch.float32,
                    device=x.device)
    return _layer(gather_layer(pl, mesh), x, cfg, pcfg, (None, z, z),
                  sequential=False, fresh=True, mesh=mesh)[0]


def forward(params, batch, cfg: ModelConfig, pcfg: ParallelConfig,
            mesh=None):
    """tokens -> (hidden (B, S, d), {aux_loss: 0}).  On a mesh (training)
    as ``transformer.forward``: the heads' or the k-cut layout of
    `time_mix`, the residual cut over the sequence where
    ``mesh.seq_parallel``, the hidden states whole on every rank."""
    _check_family(cfg)
    x = embed_tokens(params, batch["tokens"], cfg, mesh)
    sp = cm.seq_view(mesh, x.shape[1])
    x = cm.seq_rows(x, sp)
    for i in range(cfg.n_layers):
        x = remat_call(pcfg, _fresh_layer, _index(params["layers"], i), x,
                       cfg, pcfg, sp)
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return cm.seq_join(x, sp), {"aux_loss": torch.zeros(
        (), dtype=torch.float32, device=x.device)}


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """The global shapes of the cache's leaves (`max_seq` is not used: the
    state is O(1) in the sequence)."""
    h = cfg.ssm.n_ssm_heads
    hd, d, n = cfg.d_model // h, cfg.d_model, cfg.n_layers
    return {"wkv": (n, batch, h, hd, hd), "tmix_x": (n, batch, d),
            "cmix_x": (n, batch, d), "pos": (), "lengths": (batch,)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               pcfg: ParallelConfig, device="cuda", mesh=None):
    """Zero float32 states (L, ...) for every layer, position 0; on a
    mesh, this rank's block under ``mesh.cache_specs`` (its requests, and
    its heads, or k rows, of the WKV state)."""
    _check_family(cfg)
    dev = cm.check_device(device)
    shapes = cache_shapes(cfg, batch, max_seq)
    out = {k: torch.zeros(cache_block(shapes[k], k, mesh),
                          dtype=torch.float32, device=dev)
           for k in ("wkv", "tmix_x", "cmix_x")}
    out["pos"] = 0
    out["lengths"] = torch.zeros(cache_block((batch,), "lengths", mesh),
                                 dtype=torch.int32, device=dev)
    return out


def _run_cached(params, x, cfg, pcfg, cache, *, sequential, mesh=None):
    states = []
    for i in range(cfg.n_layers):
        st = (cache["wkv"][i], cache["tmix_x"][i], cache["cmix_x"][i])
        x, st = _layer(_layer_params(params, i, mesh), x, cfg, pcfg, st,
                       sequential=sequential, mesh=mesh)
        states.append(st)
    wkv, tx, cx = (torch.stack(a) for a in zip(*states))
    return x, wkv, tx, cx


def prefill(params, batch, cache, cfg: ModelConfig, pcfg: ParallelConfig,
            mesh=None):
    """Runs the prompt from the cache's states; returns (cache,
    last_hidden (B,1,d)).  On a mesh, `params`, `batch` and `cache` are
    this rank's blocks."""
    _check_family(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = embed_tokens(params, tokens, cfg, mesh)
    x, wkv, tx, cx = _run_cached(params, x, cfg, pcfg, cache,
                                 sequential=False, mesh=mesh)
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    new_cache = {"wkv": wkv, "tmix_x": tx, "cmix_x": cx,
                 "pos": cache["pos"] + s, "lengths": cache["lengths"] + s}
    return new_cache, x[:, -1:]


def decode(params, tokens, cache, cfg: ModelConfig, pcfg: ParallelConfig,
           mesh=None):
    """One token step.  tokens (B, 1) -> (cache', logits (B, 1, V))."""
    _check_family(cfg)
    x = embed_tokens(params, tokens, cfg, mesh)
    x, wkv, tx, cx = _run_cached(params, x, cfg, pcfg, cache,
                                 sequential=True, mesh=mesh)
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = logits_fn(params, x, cfg, mesh)
    new_cache = {"wkv": wkv, "tmix_x": tx, "cmix_x": cx,
                 "pos": cache["pos"] + 1, "lengths": cache["lengths"] + 1}
    return new_cache, logits


def cache_specs(cfg, pcfg, long_ctx: bool, model_size: int = 16):
    """The reference's specs of the cache's leaves: the WKV state's heads
    over 'model', or its k dim where the heads do not divide 'model'
    (`time_mix`); the token-shift states whole over it, the batch over
    ('pod', 'data')."""
    dp = cm.dp_axes()
    wkv = ((None, dp, "model", None, None)
           if cfg.ssm.n_ssm_heads % model_size == 0
           else (None, dp, None, "model", None))
    return {"wkv": wkv, "tmix_x": (None, dp, None), "cmix_x": (None, dp, None),
            "pos": (), "lengths": (dp,)}
