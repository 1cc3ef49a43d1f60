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
                    kv_override: Optional[tuple] = None):
    """Pre-norm attention with optional KV cache (shared with whisper and
    zamba).

    p: dict with wq, wk, wv, wo (+ q_norm/k_norm) — no leading layer dim.
    cache: (k_cache, v_cache, pos, lengths) of one layer; the new K/V are
    written into k_cache/v_cache at [pos, pos+S) in place.
    kv_override: (k, v) already projected (whisper's cross-attention): used
    as given, no k_norm, no position embedding.
    Returns attn_out.
    """
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    q = cm.matmul(x, cm.cast(p["wq"], cfg)).reshape(b, s, cfg.n_heads, hd)
    if kv_override is None:
        k = cm.matmul(x, cm.cast(p["wk"], cfg)).reshape(b, s, cfg.n_kv_heads,
                                                        hd)
        v = cm.matmul(x, cm.cast(p["wv"], cfg)).reshape(b, s, cfg.n_kv_heads,
                                                        hd)
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

    if cache is not None:
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
    else:
        out = att.attend(qr, kr, v, causal=causal, impl=pcfg.attn_impl,
                         chunk=pcfg.attn_chunk)

    out = out.reshape(b, s, cfg.n_heads * hd)
    return cm.matmul(out, cm.cast(p["wo"], cfg))


def mlp_block(p, x, cfg: ModelConfig, pcfg: ParallelConfig):
    h = F.silu(cm.matmul(x, cm.cast(p["w_gate"], cfg)))
    u = cm.matmul(x, cm.cast(p["w_up"], cfg))
    return cm.matmul(h * u, cm.cast(p["w_down"], cfg))


def _layer(params, i: int) -> dict:
    """Layer i's weights (the leading L dim indexed away)."""
    return _index(params["layers"], i)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _dense_layer(pl, x, positions, cfg, pcfg, cache=None):
    """One layer: (x', aux_loss) — the MoE router's load-balance loss, or
    0.0 for a dense FFN."""
    h = cm.rms_norm(x, pl["norm_attn"], cfg.norm_eps)
    x = x + attention_block(pl["attn"], h, positions, cfg, pcfg, cache=cache)
    h = cm.rms_norm(x, pl["norm_mlp"], cfg.norm_eps)
    if cfg.family == "moe":
        m, aux = moe_mod.moe_ffn(h, pl["moe"], cfg, pcfg)
    else:
        m, aux = mlp_block(pl["mlp"], h, cfg, pcfg), 0.0
    return x + m, aux


# ----------------------------------------------------------------------------
# embedding / head
# ----------------------------------------------------------------------------


def embed_tokens(params, tokens, cfg):
    return cm.cast(params["embed"]["tokens"], cfg)[tokens]


def logits_fn(params, hidden, cfg):
    """hidden (B, C, d) -> logits (B, C, V) float32: the product of the
    compute-dtype hidden and head in float32, as the reference's
    ``preferred_element_type=float32``."""
    if cfg.tie_embeddings:
        w = cm.cast(params["embed"]["tokens"], cfg).T
    else:
        w = cm.cast(params["head"]["w"], cfg)
    return cm.matmul_f32(hidden, w)


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


def forward(params, batch, cfg: ModelConfig, pcfg: ParallelConfig):
    _check_family(cfg)
    tokens = batch["tokens"]
    positions = _positions_from_batch(batch, cfg)
    x = embed_tokens(params, tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        pl = _layer(params, i)
        if pcfg.remat == "full":
            x, aux_l = torch.utils.checkpoint.checkpoint(
                _dense_layer, pl, x, positions, cfg, pcfg,
                use_reentrant=False)
        else:
            x, aux_l = _dense_layer(pl, x, positions, cfg, pcfg)
        aux = aux + aux_l
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return x, {"aux_loss": aux}


# ----------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ----------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               pcfg: ParallelConfig, device="cuda"):
    """Zeroed bf16 K/V caches (L, B, max_seq, Hkv, hd), position 0."""
    dev = cm.check_device(device)
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
        "pos": 0,
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def _run_layers_cached(params, x, positions, cfg, pcfg, cache, lengths, pos):
    for i in range(cfg.n_layers):
        x, _ = _dense_layer(_layer(params, i), x, positions, cfg, pcfg,
                            cache=(cache["k"][i], cache["v"][i], pos,
                                   lengths))
    return x


def prefill(params, batch, cache, cfg: ModelConfig, pcfg: ParallelConfig):
    """Writes the prompt KV into the cache; returns (cache, last_hidden)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = _positions_from_batch(batch, cfg)
    x = embed_tokens(params, tokens, cfg)
    lengths = cache["lengths"] + s
    x = _run_layers_cached(params, x, positions, cfg, pcfg, cache, lengths,
                           cache["pos"])
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    new_cache = dict(cache, pos=cache["pos"] + s, lengths=lengths)
    return new_cache, x[:, -1:]


def decode(params, tokens, cache, cfg: ModelConfig, pcfg: ParallelConfig):
    """One token step.  tokens (B, 1) -> (cache', logits (B, 1, V))."""
    _check_family(cfg)
    b = tokens.shape[0]
    pos = cache["pos"]
    positions = torch.full((b, 1), pos, dtype=torch.int32,
                           device=tokens.device)
    if cfg.rope_type == "mrope":
        positions = positions.expand(3, b, 1)
    x = embed_tokens(params, tokens, cfg)
    lengths = cache["lengths"] + 1
    x = _run_layers_cached(params, x, positions, cfg, pcfg, cache, lengths,
                           pos)
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = logits_fn(params, x, cfg)
    new_cache = dict(cache, pos=pos + 1, lengths=lengths)
    return new_cache, logits
