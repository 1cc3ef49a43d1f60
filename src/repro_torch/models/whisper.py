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
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig, ParallelConfig, _param_shapes
from repro_torch.models import common as cm
from repro_torch.models.transformer import (_index, attention_block,
                                            embed_tokens, logits_fn,
                                            mlp_block)


def init(gen, cfg: ModelConfig, device="cuda"):
    """Float32 params of `cfg` drawn with `gen` (a ``torch.Generator`` on
    `device`, or an int seed for one)."""
    dev = cm.check_device(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    return cm.init_from_shapes(gen, _param_shapes(cfg), dev)


def _layer_call(pcfg: ParallelConfig, fn, *args, **kwargs):
    """fn(*args, **kwargs), recomputed in the backward when
    ``pcfg.remat == "full"``."""
    if pcfg.remat == "full":
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False,
                                                 **kwargs)
    return fn(*args, **kwargs)


# ----------------------------------------------------------------------------
# encoder
# ----------------------------------------------------------------------------


def _enc_layer(pl, x, positions, cfg, pcfg):
    h = cm.layer_norm(x, pl["norm_attn"], cfg.norm_eps)
    x = x + attention_block(pl["attn"], h, positions, cfg, pcfg,
                            causal=False)
    h = cm.layer_norm(x, pl["norm_mlp"], cfg.norm_eps)
    return x + mlp_block(pl["mlp"], h, cfg, pcfg)


def encode(params, enc_embed, cfg: ModelConfig, pcfg: ParallelConfig):
    b, f, d = enc_embed.shape
    x = enc_embed + cm.sinusoidal_positions(
        f, d, device=enc_embed.device)[None].to(enc_embed.dtype)
    dummy_pos = torch.zeros((b, f), dtype=torch.int32,
                            device=enc_embed.device)
    layers = {k: v for k, v in params["enc"].items() if k != "final_norm"}
    for i in range(cfg.n_enc_layers):
        x = _layer_call(pcfg, _enc_layer, _index(layers, i), x, dummy_pos,
                        cfg, pcfg)
    return cm.layer_norm(x, params["enc"]["final_norm"], cfg.norm_eps)


# ----------------------------------------------------------------------------
# decoder
# ----------------------------------------------------------------------------


def _project_cross_kv(pl_cross, enc_out, cfg):
    b, f, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = cm.matmul(enc_out, cm.cast(pl_cross["wk"], cfg))
    v = cm.matmul(enc_out, cm.cast(pl_cross["wv"], cfg))
    return (k.reshape(b, f, cfg.n_kv_heads, hd),
            v.reshape(b, f, cfg.n_kv_heads, hd))


def _dec_layer(pl, x, positions, cfg, pcfg, enc_out=None, cross_kv=None,
               cache=None):
    """cache: None | (k_self, v_self, pos, lengths)."""
    h = cm.layer_norm(x, pl["norm_self"], cfg.norm_eps)
    x = x + attention_block(pl["self_attn"], h, positions, cfg, pcfg,
                            causal=True, cache=cache)
    h = cm.layer_norm(x, pl["norm_cross"], cfg.norm_eps)
    if cross_kv is None:
        cross_kv = _project_cross_kv(pl["cross_attn"], enc_out, cfg)
    x = x + attention_block(pl["cross_attn"], h, positions, cfg, pcfg,
                            causal=False, kv_override=cross_kv)
    h = cm.layer_norm(x, pl["norm_mlp"], cfg.norm_eps)
    return x + mlp_block(pl["mlp"], h, cfg, pcfg)


def _embed_dec(params, tokens, cfg, offset=0):
    x = embed_tokens(params, tokens, cfg)
    pos = cm.sinusoidal_positions(tokens.shape[1], cfg.d_model,
                                  offset=offset, device=tokens.device)
    return x + pos[None].to(x.dtype)


def forward(params, batch, cfg: ModelConfig, pcfg: ParallelConfig):
    enc_out = encode(params, batch["enc_embed"], cfg, pcfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = _embed_dec(params, tokens, cfg)
    for i in range(cfg.n_layers):
        x = _layer_call(pcfg, _dec_layer, _index(params["dec"], i), x,
                        positions, cfg, pcfg, enc_out=enc_out)
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return x, {"aux_loss": torch.zeros((), dtype=torch.float32,
                                       device=x.device)}


# ----------------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               pcfg: ParallelConfig, device="cuda"):
    """Zeroed bf16 self-attention K/V (L, B, max_seq, Hkv, hd) and
    cross-attention K/V (L, B, enc_seq_len, Hkv, hd), position 0."""
    dev = cm.check_device(device)
    hd = cfg.resolved_head_dim
    self_shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, hd)
    cross_shape = (cfg.n_layers, batch, cfg.enc_seq_len, cfg.n_kv_heads, hd)
    zeros = lambda shape: torch.zeros(  # noqa: E731
        shape, dtype=torch.bfloat16, device=dev)
    return {"k": zeros(self_shape), "v": zeros(self_shape),
            "cross_k": zeros(cross_shape), "cross_v": zeros(cross_shape),
            "pos": 0,
            "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def prefill(params, batch, cache, cfg: ModelConfig, pcfg: ParallelConfig):
    """Encodes the frames, projects and stores the cross K/V, prefills the
    decoder prompt; returns (cache, last_hidden (B, 1, d))."""
    enc_out = encode(params, batch["enc_embed"], cfg, pcfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = _embed_dec(params, tokens, cfg)
    lengths = cache["lengths"] + s
    for i in range(cfg.n_layers):
        pl = _index(params["dec"], i)
        ck, cv = _project_cross_kv(pl["cross_attn"], enc_out, cfg)
        x = _dec_layer(pl, x, positions, cfg, pcfg, cross_kv=(ck, cv),
                       cache=(cache["k"][i], cache["v"][i], cache["pos"],
                              lengths))
        cache["cross_k"][i] = ck
        cache["cross_v"][i] = cv
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return dict(cache, pos=cache["pos"] + s, lengths=lengths), x[:, -1:]


def decode(params, tokens, cache, cfg: ModelConfig, pcfg: ParallelConfig):
    """One token step.  tokens (B, 1) -> (cache', logits (B, 1, V))."""
    b = tokens.shape[0]
    pos = cache["pos"]
    positions = torch.full((b, 1), pos, dtype=torch.int32,
                           device=tokens.device)
    x = _embed_dec(params, tokens, cfg, offset=pos)
    lengths = cache["lengths"] + 1
    for i in range(cfg.n_layers):
        x = _dec_layer(_index(params["dec"], i), x, positions, cfg, pcfg,
                       cross_kv=(cache["cross_k"][i].to(x.dtype),
                                 cache["cross_v"][i].to(x.dtype)),
                       cache=(cache["k"][i], cache["v"][i], pos, lengths))
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = logits_fn(params, x, cfg)
    return dict(cache, pos=pos + 1, lengths=lengths), logits
