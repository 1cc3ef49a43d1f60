"""Zamba2-style hybrid: Mamba2 backbone + one SHARED attention+MLP block
(port of ``repro/models/zamba.py``).

The shared (weight-tied) transformer block is applied after every
``attn_every`` mamba layers: nb = L // attn_every groups of (attn_every
mamba layers + the shared block), then a tail of L % attn_every mamba
layers.  The reference scans over the groups and, within each, over its
layers; here one Python loop walks the stacked L dimension and runs the
shared block after the last layer of each group.

Serving: the cache holds every layer's conv state (L, B, width-1, ch) and
SSM state (L, B, H, P, N), both float32, and one bf16 KV slab (B, Smax,
Hkv, hd) per shared-block site, (nb, ...) in all.  The reference returns a
new cache; here prefill and decode write the new states and K/V into the
cache's tensors in place and return the cache dict with its position and
lengths advanced (the caller's dict is not changed).  A conv state comes
out of `mamba2.causal_conv` in x's dtype (bf16 in a bf16 config); the
float32 cache holds those values exactly (the reference's cache takes
x's dtype instead), and the next step reads them back in x's dtype.
``cache["pos"]`` is a Python int.  Prefill runs the chunked SSD, decode
the sequential scan, as in the reference; the shared block's attention
goes through the flash-attention and flash-decode kernels with
``attn_impl="pallas"`` (head dim 112 at zamba2-7b's width).

``forward`` honours ``pcfg.remat == "full"``: each mamba layer and each
site of the shared block runs under ``torch.utils.checkpoint`` and is
recomputed in the backward, the counterpart of the reference's
``jax.checkpoint(..., nothing_saveable)`` around its group and tail scan
bodies, at a finer grain (`_run`).  The shared block's weights are read
at every site, so autograd sums their gradients over the sites.  Serving
(prefill, decode) has no backward and no remat.

Not here: the reference's sharding annotations (``cm.shard``,
``cache_specs``), which are multi-device concerns (ROADMAP Slice F3).

Simplification vs. the published model (as in the reference): the shared
block consumes the hidden state directly rather than concat(hidden,
embedding).
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig, ParallelConfig, _param_shapes
from repro_torch.models import common as cm
from repro_torch.models import mamba2
from repro_torch.models.transformer import (_index, _layer, attention_block,
                                            embed_tokens, logits_fn,
                                            mlp_block)


def init(gen, cfg: ModelConfig, device="cuda"):
    """Float32 params of `cfg` drawn with `gen` (a ``torch.Generator`` on
    `device`, or an int seed for one)."""
    dev = cm.check_device(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    return cm.init_from_shapes(gen, _param_shapes(cfg), dev)


def _split_groups(cfg: ModelConfig):
    ae = cfg.attn_every
    nb = cfg.n_layers // ae
    tail = cfg.n_layers - nb * ae
    return ae, nb, tail


def _mamba_layer(pl, x, cfg, pcfg, st, *, chunked):
    conv_st, ssm_st = st
    h = cm.rms_norm(x, pl["norm"], cfg.norm_eps)
    out, conv_new, ssm_new = mamba2.mamba_block(
        pl["mamba"], h, cfg, conv_state=conv_st, ssm_state=ssm_st,
        chunked=chunked)
    return x + out, (conv_new, ssm_new)


def _shared_block(ps, x, positions, cfg, pcfg, cache=None):
    """Weight-tied attention + MLP block (leading dim-1 indexed away)."""
    sq = _index(ps, 0)
    h = cm.rms_norm(x, sq["norm_attn"], cfg.norm_eps)
    x = x + attention_block(sq["attn"], h, positions, cfg, pcfg,
                            causal=True, cache=cache)
    h = cm.rms_norm(x, sq["norm_mlp"], cfg.norm_eps)
    return x + mlp_block(sq["mlp"], h, cfg, pcfg)


def _zero_states(cfg, b, device):
    ssm = cfg.ssm
    d_in = 2 * cfg.d_model
    ch = d_in + 2 * ssm.n_groups * ssm.state_dim
    p_head = d_in // ssm.n_ssm_heads
    conv = torch.zeros((cfg.n_layers, b, ssm.conv_width - 1, ch),
                       dtype=torch.float32, device=device)
    state = torch.zeros((cfg.n_layers, b, ssm.n_ssm_heads, p_head,
                         ssm.state_dim), dtype=torch.float32, device=device)
    return conv, state


def _run(params, x, positions, cfg, pcfg, cache=None, lengths=None, *,
         chunked):
    """The layer loop of forward / prefill / decode: the mamba layers in
    order, the shared block after each group's last.  Without `cache`
    every layer starts from zero states; with it, layer i from its conv
    and SSM state there, which it overwrites, and the shared block of
    group g reads and writes KV slab g at ``cache["pos"]``.  Without
    `cache` and with ``pcfg.remat == "full"`` each mamba layer and each
    shared-block site is recomputed in the backward: finer than the
    reference's group checkpoints, the same values, and one layer's SSD
    tensors held at a time (a group's six did not fit on an 80 GB card
    at zamba2-7b's width and 4 x 2048 tokens)."""
    ae = cfg.attn_every
    if cache is None and pcfg.remat == "full":
        call = functools.partial(torch.utils.checkpoint.checkpoint,
                                 use_reentrant=False)
    else:
        call = lambda fn, *args, **kw: fn(*args, **kw)  # noqa: E731
    for i in range(cfg.n_layers):
        st = ((None, None) if cache is None
              else (cache["conv"][i], cache["ssm"][i]))
        x, (conv, ssm) = call(_mamba_layer, _layer(params, i), x, cfg, pcfg,
                              st, chunked=chunked)
        if cache is not None:
            cache["conv"][i] = conv
            cache["ssm"][i] = ssm
        if (i + 1) % ae == 0:             # the end of group (i + 1) // ae
            g = i // ae
            kv = (None if cache is None else
                  (cache["k"][g], cache["v"][g], cache["pos"], lengths))
            x = call(_shared_block, params["shared"], x, positions, cfg,
                     pcfg, kv)
    return x


def forward(params, batch, cfg: ModelConfig, pcfg: ParallelConfig):
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = embed_tokens(params, tokens, cfg)
    x = _run(params, x, positions, cfg, pcfg, chunked=True)
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return x, {"aux_loss": torch.zeros((), dtype=torch.float32,
                                       device=x.device)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               pcfg: ParallelConfig, device="cuda"):
    """Zero float32 conv and SSM states (L, ...), zeroed bf16 K/V slabs
    (nb, B, max_seq, Hkv, hd), position 0."""
    dev = cm.check_device(device)
    _, nb, _ = _split_groups(cfg)
    conv, ssm = _zero_states(cfg, batch, dev)
    kv_shape = (nb, batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"conv": conv, "ssm": ssm,
            "k": torch.zeros(kv_shape, dtype=torch.bfloat16, device=dev),
            "v": torch.zeros(kv_shape, dtype=torch.bfloat16, device=dev),
            "pos": 0,
            "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def prefill(params, batch, cache, cfg: ModelConfig, pcfg: ParallelConfig):
    """Runs the prompt from the cache's states (chunked SSD) and writes its
    KV; returns (cache, last_hidden (B, 1, d))."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = (torch.arange(s, device=tokens.device)[None].expand(b, s)
                 + cache["pos"]).to(torch.int32)
    x = embed_tokens(params, tokens, cfg)
    lengths = cache["lengths"] + s
    x = _run(params, x, positions, cfg, pcfg, cache, lengths, chunked=True)
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return dict(cache, pos=cache["pos"] + s, lengths=lengths), x[:, -1:]


def decode(params, tokens, cache, cfg: ModelConfig, pcfg: ParallelConfig):
    """One token step (sequential scan).  tokens (B, 1) -> (cache',
    logits (B, 1, V))."""
    b = tokens.shape[0]
    pos = cache["pos"]
    positions = torch.full((b, 1), pos, dtype=torch.int32,
                           device=tokens.device)
    x = embed_tokens(params, tokens, cfg)
    lengths = cache["lengths"] + 1
    x = _run(params, x, positions, cfg, pcfg, cache, lengths, chunked=False)
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = logits_fn(params, x, cfg)
    return dict(cache, pos=pos + 1, lengths=lengths), logits


def cache_specs(cfg, pcfg, long_ctx: bool, model_size: int = 16):
    """The cache's specs on a mesh: this family does not run sharded
    yet (``models.check_mesh``)."""
    from repro_torch.models.transformer import MESH_TODO
    raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family's "
                              f"sharded cache waits for {MESH_TODO}")
