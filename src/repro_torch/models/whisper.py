"""Whisper-style encoder-decoder backbone, conv frontend stubbed (port of
``repro/models/whisper.py``).

As in the reference, the audio conv frontend is a stub: the batch
carries precomputed frame embeddings ``enc_embed (B, enc_seq_len, d)``.
Positions are sinusoidal (non-learned); LayerNorm is scale-only.

Attention: the decoder's causal self-attention goes through the
flash-attention kernel at prefill and the flash-decode kernel at every
decode step with ``attn_impl="pallas"``; the encoder's (non-causal) and
the cross-attention (another kv length) take the chunked plain path, as
in the reference.

Decode path: a self-attention KV cache, and the cross-attention K/V
projected once at prefill.  Prefill attends over the unrounded cross K/V
and stores them in the cache, rounded to its dtype (bf16); decode reads
them back cast to x's dtype, so in a float32 config prefill and decode
see different cross K/V, as in the reference.  The reference returns a
new cache; here prefill and decode write into the cache's tensors in
place and return the cache dict with its position and lengths advanced
(the caller's dict is not changed).  ``cache["pos"]`` is a Python int.

Remat: with ``pcfg.remat == "full"`` each encoder layer and each decoder
layer runs under ``torch.utils.checkpoint`` and is recomputed in the
backward, the counterpart of the reference's ``jax.checkpoint(...,
nothing_saveable)`` around its layer scans (under
``torch.inference_mode()`` nothing is recomputed).  Every decoder layer
projects the cross K/V from the encoder's output, so the encoder's
gradient gathers from all of them.

On a mesh (``mesh=``, a ``common.MeshContext``) the
encoder's and decoder's self-attention and the cross-attention go
through `attention_block` with the mesh, the cross K/V projected on the
rank's KV heads (every head where they do not divide 'model'); the
cache is cut by `cache_specs`, the cross cache along the frames where
its heads do not divide, and a decode step then merges every rank's
partial softmax state over its frames.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, _param_shapes
from repro_torch.models import common as cm
from repro_torch.models.transformer import (_index, _layer, _whole_heads,
                                            attention_block, cache_block,
                                            embed_tokens, gather_layer,
                                            kv_cache_spec, logits_fn,
                                            mlp_block, remat_call, seq_axes)


def init(gen, cfg: ModelConfig, device="cuda"):
    """Float32 params of `cfg` drawn with `gen` (a ``torch.Generator`` on
    `device`, or an int seed for one)."""
    dev = cm.check_device(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    return cm.init_from_shapes(gen, _param_shapes(cfg), dev)


# ----------------------------------------------------------------------------
# encoder
# ----------------------------------------------------------------------------


def _enc_layer(pl, x, positions, cfg, pcfg, mesh=None):
    """One encoder layer (`pl`: its shards, gathered over 'data' here);
    where the residual is cut over the frames (training), each block
    gathers its normed input over 'model' and keeps its rows."""
    pl = gather_layer(pl, mesh, "enc")
    h = cm.seq_join(cm.layer_norm(x, pl["norm_attn"], cfg.norm_eps), mesh)
    x = x + cm.seq_leave(attention_block(pl["attn"], h, positions, cfg,
                                         pcfg, causal=False, mesh=mesh),
                         x, mesh)
    h = cm.seq_join(cm.layer_norm(x, pl["norm_mlp"], cfg.norm_eps), mesh)
    return x + cm.seq_leave(mlp_block(pl["mlp"], h, cfg, pcfg, mesh=mesh),
                            x, mesh)


def encode(params, enc_embed, cfg: ModelConfig, pcfg: ParallelConfig,
           mesh=None):
    """The encoder's output (B, F, d), whole over the frames (on a mesh
    whose ``seq_parallel`` cuts them, gathered after the final norm)."""
    b, f, d = enc_embed.shape
    x = enc_embed + cm.sinusoidal_positions(
        f, d, device=enc_embed.device)[None].to(enc_embed.dtype)
    dummy_pos = torch.zeros((b, f), dtype=torch.int32,
                            device=enc_embed.device)
    layers = {k: v for k, v in params["enc"].items() if k != "final_norm"}
    sp = cm.seq_view(mesh, f)
    x = cm.seq_rows(x, sp)
    for i in range(cfg.n_enc_layers):
        x = remat_call(pcfg, _enc_layer, _index(layers, i), x, dummy_pos,
                        cfg, pcfg, sp)
    return cm.seq_join(cm.layer_norm(x, params["enc"]["final_norm"],
                                     cfg.norm_eps), sp)


# ----------------------------------------------------------------------------
# decoder
# ----------------------------------------------------------------------------


def _project_cross_kv(pl_cross, enc_out, cfg, mesh=None):
    """The cross-attention's K and V of the frames: on a mesh, this rank's
    KV heads where they divide 'model', else every head (its column
    blocks gathered over 'model'), as `attention_block` attends."""
    b, f, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    whole = mesh is not None and _whole_heads(pl_cross, cfg, mesh, ())

    def project(w):
        y = cm.matmul(enc_out, cm.cast(w, cfg))
        if whole and w.shape[-1] != cfg.n_kv_heads * hd:
            y = mesh.gather(y, -1, ("model",))
        return y.reshape(b, f, -1, hd)

    return project(pl_cross["wk"]), project(pl_cross["wv"])


def _dec_layer(pl, x, positions, cfg, pcfg, enc_out=None, cross_kv=None,
               cache=None, mesh=None, cross_axes=()):
    """cache: None | (k_self, v_self, pos, lengths); `cross_axes`: the
    axes `cross_kv` (this rank's block of the cross cache) is cut over
    along the frames.  Where the residual is cut over the sequence
    (training), each block gathers its normed input over 'model' and
    keeps its rows; `enc_out` is whole."""
    h = cm.seq_join(cm.layer_norm(x, pl["norm_self"], cfg.norm_eps), mesh)
    x = x + cm.seq_leave(attention_block(
        pl["self_attn"], h, positions, cfg, pcfg, causal=True, cache=cache,
        mesh=mesh, seq_axes=seq_axes(mesh) if cache is not None else ()),
        x, mesh)
    h = cm.seq_join(cm.layer_norm(x, pl["norm_cross"], cfg.norm_eps), mesh)
    if cross_kv is None:
        cross_kv = _project_cross_kv(pl["cross_attn"], enc_out, cfg, mesh)
    x = x + cm.seq_leave(attention_block(
        pl["cross_attn"], h, positions, cfg, pcfg, causal=False,
        kv_override=cross_kv, mesh=mesh, seq_axes=cross_axes), x, mesh)
    h = cm.seq_join(cm.layer_norm(x, pl["norm_mlp"], cfg.norm_eps), mesh)
    return x + cm.seq_leave(mlp_block(pl["mlp"], h, cfg, pcfg, mesh=mesh),
                            x, mesh)


def _train_dec_layer(pl, x, positions, cfg, pcfg, enc_out, mesh):
    return _dec_layer(gather_layer(pl, mesh, "dec"), x, positions, cfg, pcfg,
                      enc_out=enc_out, mesh=mesh)


def _embed_dec(params, tokens, cfg, offset=0, mesh=None):
    x = embed_tokens(params, tokens, cfg, mesh)
    pos = cm.sinusoidal_positions(tokens.shape[1], cfg.d_model,
                                  offset=offset, device=tokens.device)
    return x + pos[None].to(x.dtype)


def forward(params, batch, cfg: ModelConfig, pcfg: ParallelConfig,
            mesh=None):
    """(frames, tokens) -> (hidden (B, S, d), {aux_loss: 0}).  On a mesh
    (training) as ``transformer.forward``, the encoder's and the
    decoder's residuals each cut over their sequence where
    ``mesh.seq_parallel``."""
    enc_out = encode(params, batch["enc_embed"], cfg, pcfg, mesh)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = _embed_dec(params, tokens, cfg, mesh=mesh)
    sp = cm.seq_view(mesh, s)
    x = cm.seq_rows(x, sp)
    for i in range(cfg.n_layers):
        x = remat_call(pcfg, _train_dec_layer, _index(params["dec"], i), x,
                        positions, cfg, pcfg, enc_out, sp)
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return cm.seq_join(x, sp), {"aux_loss": torch.zeros(
        (), dtype=torch.float32, device=x.device)}


# ----------------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------------


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """The global shapes of the cache's leaves."""
    hd = cfg.resolved_head_dim
    kv = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, hd)
    cross = (cfg.n_layers, batch, cfg.enc_seq_len, cfg.n_kv_heads, hd)
    return {"k": kv, "v": kv, "cross_k": cross, "cross_v": cross,
            "pos": (), "lengths": (batch,)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               pcfg: ParallelConfig, device="cuda", mesh=None):
    """Zeroed bf16 self-attention K/V (L, B, max_seq, Hkv, hd) and
    cross-attention K/V (L, B, enc_seq_len, Hkv, hd), position 0; on a
    mesh, this rank's block of each under ``mesh.cache_specs``."""
    dev = cm.check_device(device)
    shapes = cache_shapes(cfg, batch, max_seq)
    zeros = lambda k, dt=torch.bfloat16: torch.zeros(  # noqa: E731
        cache_block(shapes[k], k, mesh), dtype=dt, device=dev)
    return {"k": zeros("k"), "v": zeros("v"),
            "cross_k": zeros("cross_k"), "cross_v": zeros("cross_v"),
            "pos": 0, "lengths": zeros("lengths", torch.int32)}


def prefill(params, batch, cache, cfg: ModelConfig, pcfg: ParallelConfig,
            mesh=None):
    """Encodes the frames, projects and stores the cross K/V, prefills the
    decoder prompt; returns (cache, last_hidden (B, 1, d)).  On a mesh,
    `params`, `batch` and `cache` are this rank's blocks; where the cross
    cache is cut along the frames the rank stores its block of them."""
    enc_out = encode(params, batch["enc_embed"], cfg, pcfg, mesh)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = _embed_dec(params, tokens, cfg, mesh=mesh)
    lengths = cache["lengths"] + s
    frames = cache["cross_k"].shape[2]
    i, _ = mesh.block(seq_axes(mesh, "cross_k")) if mesh else (0, 1)
    for j in range(cfg.n_layers):
        pl = _layer(params, j, mesh, "dec")
        ck, cv = _project_cross_kv(pl["cross_attn"], enc_out, cfg, mesh)
        x = _dec_layer(pl, x, positions, cfg, pcfg, cross_kv=(ck, cv),
                       cache=(cache["k"][j], cache["v"][j], cache["pos"],
                              lengths), mesh=mesh)
        cache["cross_k"][j] = ck[:, i * frames:(i + 1) * frames]
        cache["cross_v"][j] = cv[:, i * frames:(i + 1) * frames]
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return dict(cache, pos=cache["pos"] + s, lengths=lengths), x[:, -1:]


def decode(params, tokens, cache, cfg: ModelConfig, pcfg: ParallelConfig,
           mesh=None):
    """One token step.  tokens (B, 1) -> (cache', logits (B, 1, V))."""
    b = tokens.shape[0]
    pos = cache["pos"]
    positions = torch.full((b, 1), pos, dtype=torch.int32,
                           device=tokens.device)
    x = _embed_dec(params, tokens, cfg, offset=pos, mesh=mesh)
    lengths = cache["lengths"] + 1
    cross_axes = seq_axes(mesh, "cross_k")
    # the cross K/V come from the cache: their projections are not read
    # (nor gathered over 'data' on a mesh)
    cross = {k: w for k, w in params["dec"]["cross_attn"].items()
             if k not in ("wk", "wv")}
    dec = {"dec": dict(params["dec"], cross_attn=cross)}
    for i in range(cfg.n_layers):
        x = _dec_layer(_layer(dec, i, mesh, "dec"), x, positions, cfg,
                       pcfg, cross_kv=(cache["cross_k"][i].to(x.dtype),
                                       cache["cross_v"][i].to(x.dtype)),
                       cache=(cache["k"][i], cache["v"][i], pos, lengths),
                       mesh=mesh, cross_axes=cross_axes)
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = logits_fn(params, x, cfg, mesh)
    return dict(cache, pos=pos + 1, lengths=lengths), logits


def cache_specs(cfg, pcfg, long_ctx: bool, model_size: int = 16):
    """The reference's specs of the cache's leaves: the self- and
    cross-attention K/V alike, KV heads over 'model' where they divide,
    else the sequence (the frames) over 'model'; the batch over ('pod',
    'data').  The reference has no long-context layout for this family
    (`long_ctx` is not read)."""
    kv = kv_cache_spec(cfg, False, model_size)
    return {"k": kv, "v": kv, "cross_k": kv, "cross_v": kv,
            "pos": (), "lengths": (cm.dp_axes(),)}
