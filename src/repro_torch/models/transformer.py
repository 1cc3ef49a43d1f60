"""Decoder-only transformer: dense, VLM (M-RoPE) and MoE families (port of
``repro/models/transformer.py``).

One implementation serves forward, prefill and single-token decode; layer
weights are stacked on a leading L dim, and the reference's ``scan`` over
them is a Python loop over that dim.  A MoE layer's FFN is
`moe.moe_ffn` and ``forward`` sums its load-balance losses into
``aux_loss``; the VLM family takes (3, B, S) M-RoPE positions
(`attention.apply_mrope`).  ``forward`` honours ``pcfg.remat == "full"``:
each layer runs under ``torch.utils.checkpoint`` and is recomputed in the
backward, the counterpart of the reference's ``jax.checkpoint(...,
nothing_saveable)`` (under ``torch.inference_mode()`` nothing is
recomputed).  Serving (prefill, decode) has no backward and no remat.

The KV cache is bf16 whatever ``cfg.dtype`` is, as in the reference.  The
reference is functional and returns a new cache; here prefill and decode
write the new K/V into the cache's tensors in place and return the cache
dict with its position and lengths advanced (the caller's dict is not
changed).  ``cache["pos"]`` is a Python int.

On a mesh (``mesh=``, a ``common.MeshContext``; ``None``: one device)
every rank runs the same code on its local shards, with the reference's
Megatron layout: ``wq/wk/wv`` and ``w_gate/w_up`` column-parallel (this
rank's heads and columns, whole q heads over their own KV heads, as
``attention._group`` lays them out), ``wo`` and ``w_down``
row-parallel, each followed by one float32 sum over 'model'; serving
keeps the residual stream whole over 'model'.  Each layer's weights are
gathered over 'data' at use (FSDP).  Training (``forward(...,
mesh=)``) runs the same blocks under autograd, the layer's gathers
inside its checkpoint, with the reference's sequence-parallel residuals
where ``mesh.seq_parallel`` (`_dense_layer`) and the vocab-parallel
loss's head (`vocab_logits`).  The KV
cache holds this rank's requests and KV heads (`cache_specs`).  Where
the KV heads (so also where the q heads) do not divide 'model', the
cache holds every head and this rank's block of positions instead (the
reference's fallback; the long-context layout cuts them over ('data',
'model')): the rank gathers every head's q, k and v columns, writes the
new K/V that fall in its block, and a decode step merges every rank's
partial softmax state over its block (`attention_block`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig, ParallelConfig, _param_shapes
from repro_torch.models import attention as att
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_mod


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "vlm", "moe"):
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not "
                                  f"a transformer of this package")


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------


def init(gen, cfg: ModelConfig, device="cuda"):
    """Float32 params of `cfg` drawn with `gen` (a ``torch.Generator`` on
    `device`, or an int seed for one)."""
    _check_family(cfg)
    dev = cm.check_device(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    return cm.init_from_shapes(gen, _param_shapes(cfg), dev)


# ----------------------------------------------------------------------------
# building blocks
# ----------------------------------------------------------------------------


def attention_block(p, x, positions, cfg: ModelConfig, pcfg: ParallelConfig,
                    *, causal: bool = True, cache: Optional[tuple] = None,
                    kv_override: Optional[tuple] = None, mesh=None,
                    seq_axes: tuple = ()):
    """Pre-norm attention with optional KV cache (shared with whisper and
    zamba).

    p: dict with wq, wk, wv, wo (+ q_norm/k_norm) — no leading layer dim.
    cache: (k_cache, v_cache, pos, lengths) of one layer; the new K/V are
    written into k_cache/v_cache at [pos, pos+S) in place.
    kv_override: (k, v) already projected (whisper's cross-attention): used
    as given, no k_norm, no position embedding.
    mesh: a ``common.MeshContext`` whose rank holds `p`'s tensor-parallel
    blocks; the output is summed over 'model'.  Where the KV heads divide
    'model' and the cache (if any) is cut by heads, the rank holds whole
    heads (its q heads over its own KV heads) and attends over them
    alone.  Otherwise (`_whole_heads`) the rank gathers its q, k and v
    column blocks over 'model' into every head, attends over all of
    them, and multiplies the output columns of its ``wo`` rows.
    seq_axes: the axes the cache's sequence is cut over (the reference's
    fallback layout, or long-context decode): the cache tensors are this
    rank's block of positions; the rank writes the new K/V that fall in
    it, and a decode step merges every rank's partial softmax state
    (`attention.decode_attend_sharded`, or the flash-decode kernels'
    split and cross-rank combine with attn_impl "pallas").  With
    `kv_override` and no `cache`, `seq_axes` says the given (k, v) are
    this rank's block of a cut sequence, all of it valid (whisper's
    cross cache at decode).
    Returns attn_out.
    """
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    whole = mesh is not None and _whole_heads(p, cfg, mesh, seq_axes)
    if mesh is not None and not whole:          # this rank's heads
        hq = p["wq"].shape[-1] // hd
        hkv = (p["wk"].shape[-1] // hd if kv_override is None
               else kv_override[0].shape[2])

    def project(w, heads):
        y = cm.matmul(x, cm.cast(w, cfg))
        if whole and w.shape[-1] != heads * hd:  # columns cut over 'model'
            y = mesh.gather(y, -1, ("model",))
        return y.reshape(b, s, heads, hd)

    q = project(p["wq"], hq)
    if kv_override is None:
        k, v = project(p["wk"], hkv), project(p["wv"], hkv)
    else:
        k, v = kv_override

    if cfg.qk_norm:
        q = cm.rms_norm(q, p["q_norm"], cfg.norm_eps)
        if kv_override is None:
            k = cm.rms_norm(k, p["k_norm"], cfg.norm_eps)

    if kv_override is None:
        qr, kr = att.position_embed(q, k, positions, cfg.rope_type,
                                    cfg.rope_theta)
    else:
        qr, kr = q, k

    if cache is not None and seq_axes:
        out = _attend_seq_sharded(qr, kr, v, cache, pcfg, mesh, seq_axes,
                                  causal)
    elif cache is not None:
        k_cache, v_cache, pos, lengths = cache
        if pos + s > k_cache.shape[1]:
            raise ValueError(f"KV cache overflow: position {pos} + {s} new "
                             f"tokens > max_seq {k_cache.shape[1]}")
        k_cache[:, pos:pos + s] = kr.to(k_cache.dtype)
        v_cache[:, pos:pos + s] = v.to(v_cache.dtype)
        if s == 1:  # decode
            if pcfg.attn_impl == "pallas":
                from repro_torch.kernels.decode_attention import ops as dec
                out = dec.decode_attention(qr, k_cache, v_cache, lengths)
            else:
                out = att.decode_attend(qr, k_cache, v_cache, lengths)
        else:       # prefill: attend within the freshly written prefix
            out = att.attend(qr, kr, v, causal=causal, impl=pcfg.attn_impl,
                             chunk=pcfg.attn_chunk)
    elif seq_axes:  # this rank's block of a cut, wholly valid sequence
        i, n = mesh.block(seq_axes)
        rows = kr.shape[1]
        full = torch.full((b,), rows * n, dtype=torch.int32, device=x.device)
        out = att.decode_attend_sharded(
            qr, kr, v, full, i * rows, lambda t: mesh.gather(t, 2, seq_axes))
    else:
        out = att.attend(qr, kr, v, causal=causal, impl=pcfg.attn_impl,
                         chunk=pcfg.attn_chunk)

    out = out.reshape(b, s, hq * hd)
    wo = cm.cast(p["wo"], cfg)
    if mesh is not None and wo.shape[0] != cfg.n_heads * hd:
        if whole:                     # the output columns of this rank's rows
            i, _ = mesh.block(("model",))
            out = out[..., i * wo.shape[0]:(i + 1) * wo.shape[0]]
        return cm.row_parallel(out, wo, mesh)
    return cm.matmul(out, wo)


def _whole_heads(p, cfg: ModelConfig, mesh, seq_axes) -> bool:
    """True where a rank attends over every head: the cache's sequence is
    cut (`seq_axes`), or the projections are cut over 'model' but not
    into whole KV heads (KV heads that do not divide 'model'; q = G x kv,
    so q heads that do not divide fall here too)."""
    if seq_axes:
        return True
    cut = p["wq"].shape[-1] != cfg.n_heads * cfg.resolved_head_dim
    return cut and cfg.n_kv_heads % mesh.size(("model",)) != 0


def _attend_seq_sharded(qr, kr, v, cache, pcfg, mesh, seq_axes, causal):
    """Attention with a KV cache whose sequence is cut over `seq_axes`
    (every head in each block): the new K/V written where they fall in
    this rank's block (a prompt may span ranks); prefill attends within
    the fresh prompt (every rank all of it, as one device does), a decode
    step merges every rank's partial softmax state over its block."""
    k_cache, v_cache, pos, lengths = cache
    s = qr.shape[1]
    i, n = mesh.block(seq_axes)
    rows = k_cache.shape[1]
    start = i * rows
    if pos + s > rows * n:
        raise ValueError(f"KV cache overflow: position {pos} + {s} new "
                         f"tokens > max_seq {rows * n}")
    lo, hi = max(pos, start), min(pos + s, start + rows)
    if lo < hi:
        k_cache[:, lo - start:hi - start] = kr[:, lo - pos:hi - pos].to(
            k_cache.dtype)
        v_cache[:, lo - start:hi - start] = v[:, lo - pos:hi - pos].to(
            v_cache.dtype)
    if s > 1:
        return att.attend(qr, kr, v, causal=causal, impl=pcfg.attn_impl,
                          chunk=pcfg.attn_chunk)
    gather = lambda t: mesh.gather(t, 2, seq_axes)  # noqa: E731
    if pcfg.attn_impl == "pallas":
        from repro_torch.kernels.decode_attention import ops as dec
        return dec.decode_attention_sharded(qr, k_cache, v_cache, lengths,
                                            start, gather)
    return att.decode_attend_sharded(qr, k_cache, v_cache, lengths, start,
                                     gather).to(v_cache.dtype)


def mlp_block(p, x, cfg: ModelConfig, pcfg: ParallelConfig, mesh=None):
    h = F.silu(cm.matmul(x, cm.cast(p["w_gate"], cfg)))
    u = cm.matmul(x, cm.cast(p["w_up"], cfg))
    if mesh is not None and p["w_down"].shape[0] != cfg.d_ff:
        return cm.row_parallel(h * u, cm.cast(p["w_down"], cfg), mesh)
    return cm.matmul(h * u, cm.cast(p["w_down"], cfg))


def _layer(params, i: int, mesh=None, key: str = "layers") -> dict:
    """Layer i of the stack ``params[key]`` (the leading L dim indexed
    away); on a mesh, gathered over 'data' at use (`MeshContext.fsdp`:
    what is left is this rank's tensor-parallel block)."""
    return gather_layer(_index(params[key], i), mesh, key)


def gather_layer(pl, mesh, key: str = "layers") -> dict:
    """One layer's local shards `pl` of the stack ``key`` gathered over
    'data' (`MeshContext.fsdp`); `pl` itself without a mesh.  Training
    calls it inside the layer's checkpoint, so the backward re-issues the
    gathers (the reference's remat of its FSDP all-gathers)."""
    if mesh is None:
        return pl
    return cm.map_tree(mesh.fsdp, pl, cm.map_tree(
        lambda spec: spec[1:], {k: mesh.specs[key][k] for k in pl}))


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _dense_layer(pl, x, positions, cfg, pcfg, cache=None, mesh=None):
    """One layer: (x', aux_loss) — the MoE router's load-balance loss, or
    0.0 for a dense FFN.  Where the residual is cut over the sequence
    (``mesh.seq_cut``, training): under ``sp_boundary`` "op" each block
    norms this rank's rows, gathers them over 'model' and reduce-scatters
    its exit; under "layer" (the reference's explicit schedule) the
    residual is gathered once at the layer's entry, the attention's exit
    is an all-reduce and the FFN's a reduce-scatter."""
    if mesh is not None and mesh.seq_cut and mesh.sp_boundary == "layer":
        full = cm.seq_join(x, mesh)
        h = cm.rms_norm(full, pl["norm_attn"], cfg.norm_eps)
        full = full + attention_block(pl["attn"], h, positions, cfg, pcfg,
                                      mesh=mesh.view(False))
        h = cm.rms_norm(full, pl["norm_mlp"], cfg.norm_eps)
        m, aux = _ffn(pl, h, cfg, pcfg, mesh)
        return cm.seq_rows(full, mesh) + cm.seq_leave(m, x, mesh), aux
    h = cm.seq_join(cm.rms_norm(x, pl["norm_attn"], cfg.norm_eps), mesh)
    x = x + cm.seq_leave(attention_block(
        pl["attn"], h, positions, cfg, pcfg, cache=cache, mesh=mesh,
        seq_axes=seq_axes(mesh) if cache is not None else ()), x, mesh)
    h = cm.seq_join(cm.rms_norm(x, pl["norm_mlp"], cfg.norm_eps), mesh)
    m, aux = _ffn(pl, h, cfg, pcfg, mesh)
    return x + cm.seq_leave(m, x, mesh), aux


def _ffn(pl, h, cfg, pcfg, mesh):
    if cfg.family == "moe":
        return moe_mod.moe_ffn(h, pl["moe"], cfg, pcfg, mesh=mesh)
    return mlp_block(pl["mlp"], h, cfg, pcfg, mesh=mesh), 0.0


# ----------------------------------------------------------------------------
# embedding / head
# ----------------------------------------------------------------------------


def embed_tokens(params, tokens, cfg, mesh=None):
    """The token table's rows, by ``F.embedding``: its backward on the CPU
    adds each row's gradients in token order whatever the thread count,
    where an indexing's (``index_put_`` with accumulate) adds them in the
    threads' order and so varies from run to run.  On a mesh, from the
    feature-sharded table (`common.embed_lookup`)."""
    if mesh is not None:
        return cm.embed_lookup(params["embed"]["tokens"], tokens, cfg, mesh)
    return F.embedding(tokens, cm.cast(params["embed"]["tokens"], cfg))


def logits_fn(params, hidden, cfg, mesh=None):
    """hidden (B, C, d) -> logits (B, C, V) float32: the product of the
    compute-dtype hidden and head in float32, as the reference's
    ``preferred_element_type=float32``.  On a mesh: the vocab-sharded
    ``head.w`` gathered over 'data' (the reference gathers it to (None,
    'model') too), this rank's vocab columns computed and gathered over
    'model'; a tied head from the feature-sharded table
    (`common.tied_logits`)."""
    if mesh is not None:
        if cfg.tie_embeddings:
            return cm.tied_logits(params["embed"]["tokens"], hidden, cfg,
                                  mesh)
        spec = mesh.spec("head.w")
        w = mesh.fsdp(cm.cast(params["head"]["w"], cfg), spec)
        logits = cm.matmul_f32(hidden, w)
        return (mesh.gather(logits, -1, ("model",))
                if "model" in cm.entry_axes(spec[1]) else logits)
    if cfg.tie_embeddings:
        w = cm.cast(params["embed"]["tokens"], cfg).T
    else:
        w = cm.cast(params["head"]["w"], cfg)
    return cm.matmul_f32(hidden, w)


def vocab_logits(params, hidden, cfg, mesh):
    """The training loss's logits on a rank of a mesh: (logits (B, C, Vr)
    float32, the vocabulary id of their first column).  A head cut over
    'model' gives this rank's vocab columns alone (the vocab-parallel
    loss reduces over 'model' what it needs, ``train/losses.py``); so
    does a tied head where 'model' divides the vocabulary: the
    feature-sharded table is gathered whole over its feature axes (its
    backward the reduce-scatter of the gradient onto each rank's feature
    block) and this rank's block of vocab rows taken.  Any other head
    gives every column (`logits_fn`)."""
    m = mesh.size(("model",))
    if cfg.tie_embeddings and m > 1 and cfg.vocab_size % m == 0:
        feat = cm.entry_axes(mesh.spec("embed.tokens")[1])
        table = mesh.gather(cm.cast(params["embed"]["tokens"], cfg), 1,
                            feat)
        i, _ = mesh.block(("model",))
        k = cfg.vocab_size // m
        return cm.matmul_f32(hidden, table[i * k:(i + 1) * k].T), i * k
    if cfg.tie_embeddings or "model" not in cm.entry_axes(
            mesh.spec("head.w")[1]):
        return logits_fn(params, hidden, cfg, mesh), 0
    w = mesh.fsdp(cm.cast(params["head"]["w"], cfg), mesh.spec("head.w"))
    i, _ = mesh.block(("model",))
    return cm.matmul_f32(hidden, w), i * w.shape[-1]


# ----------------------------------------------------------------------------
# forward (train / eval): tokens -> hidden states
# ----------------------------------------------------------------------------


def _positions_from_batch(batch, cfg):
    tokens = batch["tokens"]
    b, s = tokens.shape[:2]
    if "positions" in batch:
        return batch["positions"]                 # (B, S); M-RoPE (3, B, S)
    p = torch.arange(s, device=tokens.device)[None].expand(b, s)
    return torch.stack([p, p, p]) if cfg.rope_type == "mrope" else p


def remat_call(pcfg: ParallelConfig, fn, *args, **kwargs):
    """fn(*args, **kwargs), recomputed in the backward (collectives and
    all) when ``pcfg.remat == "full"``."""
    if pcfg.remat == "full":
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False,
                                                 **kwargs)
    return fn(*args, **kwargs)


def _train_layer(pl, x, positions, cfg, pcfg, mesh):
    return _dense_layer(gather_layer(pl, mesh), x, positions, cfg, pcfg,
                        mesh=mesh)


def forward(params, batch, cfg: ModelConfig, pcfg: ParallelConfig,
            mesh=None):
    """tokens -> (hidden (B, S, d), {aux_loss}).  On a mesh (training:
    `params` this rank's shards, `batch` its share over ('pod', 'data')),
    each layer gathers its weights over 'data' inside its checkpoint; the
    residual is cut over the sequence where ``mesh.seq_parallel``
    (`common.seq_view`), and the hidden states come out whole on every
    rank of 'model'."""
    _check_family(cfg)
    tokens = batch["tokens"]
    positions = _positions_from_batch(batch, cfg)
    x = embed_tokens(params, tokens, cfg, mesh)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    sp = cm.seq_view(mesh, x.shape[1])
    x = cm.seq_rows(x, sp)
    for i in range(cfg.n_layers):
        x, aux_l = remat_call(pcfg, _train_layer, _index(params["layers"], i),
                              x, positions, cfg, pcfg, sp)
        aux = aux + aux_l
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return cm.seq_join(x, sp), {"aux_loss": aux}


# ----------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ----------------------------------------------------------------------------


def kv_cache_spec(cfg: ModelConfig, long_ctx: bool, model_size: int) -> tuple:
    """The reference's spec of a (L, B, S, Hkv, hd) KV cache: KV heads over
    'model' where they divide; else the sequence over 'model' (the
    flash-decode fallback: each rank's partial softmax state over its
    block, merged across ranks); for long-context decode (batch 1) the
    sequence over ('data', 'model')."""
    dp = cm.dp_axes()
    if long_ctx:
        return (None, dp, ("data", "model"), None, None)
    if cfg.n_kv_heads % model_size == 0:
        return (None, dp, None, "model", None)
    return (None, dp, "model", None, None)


def cache_specs(cfg: ModelConfig, pcfg: ParallelConfig, long_ctx: bool,
                model_size: int = 16) -> dict:
    """Specs of the KV cache's leaves (the reference's ``cache_specs``):
    `kv_cache_spec` for K and V, the batch over ('pod', 'data')."""
    kv = kv_cache_spec(cfg, long_ctx, model_size)
    return {"k": kv, "v": kv, "pos": (), "lengths": (cm.dp_axes(),)}


def cache_block(shape, key: str, mesh) -> tuple:
    """The shape of this rank's block of a cache leaf of global `shape`
    under ``mesh.cache_specs[key]`` (`shape` itself without a mesh)."""
    if mesh is None:
        return tuple(shape)
    from repro_torch.core.partitioning import local_shape
    return local_shape(tuple(shape), mesh.cache_specs[key], mesh.mesh)


def seq_axes(mesh, key: str = "k") -> tuple:
    """The axes the sequence (dim 2) of cache leaf `key` is cut over on
    `mesh` (``()`` without a mesh, or where it is whole)."""
    if mesh is None:
        return ()
    return cm.entry_axes(mesh.cache_specs[key][2])


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """The global shapes of the cache's leaves."""
    kv = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
          cfg.resolved_head_dim)
    return {"k": kv, "v": kv, "pos": (), "lengths": (batch,)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               pcfg: ParallelConfig, device="cuda", mesh=None):
    """Zeroed bf16 K/V caches (L, B, max_seq, Hkv, hd), position 0; on a
    mesh, this rank's block under ``mesh.cache_specs`` (its requests, and
    its KV heads or its block of positions)."""
    dev = cm.check_device(device)
    shapes = cache_shapes(cfg, batch, max_seq)
    kv = cache_block(shapes["k"], "k", mesh)
    return {
        "k": torch.zeros(kv, dtype=torch.bfloat16, device=dev),
        "v": torch.zeros(kv, dtype=torch.bfloat16, device=dev),
        "pos": 0,
        "lengths": torch.zeros(cache_block(shapes["lengths"], "lengths",
                                           mesh),
                               dtype=torch.int32, device=dev),
    }


def _run_layers_cached(params, x, positions, cfg, pcfg, cache, lengths, pos,
                       mesh=None):
    for i in range(cfg.n_layers):
        x, _ = _dense_layer(_layer(params, i, mesh), x, positions, cfg, pcfg,
                            cache=(cache["k"][i], cache["v"][i], pos,
                                   lengths), mesh=mesh)
    return x


def prefill(params, batch, cache, cfg: ModelConfig, pcfg: ParallelConfig,
            mesh=None):
    """Writes the prompt KV into the cache; returns (cache, last_hidden).
    On a mesh, `params`, `batch` and `cache` are this rank's blocks."""
    _check_family(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = _positions_from_batch(batch, cfg)
    x = embed_tokens(params, tokens, cfg, mesh)
    lengths = cache["lengths"] + s
    x = _run_layers_cached(params, x, positions, cfg, pcfg, cache, lengths,
                           cache["pos"], mesh)
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    new_cache = dict(cache, pos=cache["pos"] + s, lengths=lengths)
    return new_cache, x[:, -1:]


def decode(params, tokens, cache, cfg: ModelConfig, pcfg: ParallelConfig,
           mesh=None):
    """One token step.  tokens (B, 1) -> (cache', logits (B, 1, V)).  On
    a mesh, this rank's requests, and their logits over the whole
    vocabulary."""
    _check_family(cfg)
    b = tokens.shape[0]
    pos = cache["pos"]
    positions = torch.full((b, 1), pos, dtype=torch.int32,
                           device=tokens.device)
    if cfg.rope_type == "mrope":
        positions = positions.expand(3, b, 1)
    x = embed_tokens(params, tokens, cfg, mesh)
    lengths = cache["lengths"] + 1
    x = _run_layers_cached(params, x, positions, cfg, pcfg, cache, lengths,
                           pos, mesh)
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = logits_fn(params, x, cfg, mesh)
    new_cache = dict(cache, pos=pos + 1, lengths=lengths)
    return new_cache, logits
