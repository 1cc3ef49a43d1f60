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

On a mesh (``mesh=``, a ``common.MeshContext``) every
rank runs `mamba2.mamba_block`'s sharded path, on its SSM heads where
they divide 'model' and on P/M channels of every head where they do
not (the reference's two layouts of the SSM state), and the shared
block through `attention_block` and `mlp_block` with the mesh; the
cache is cut by `cache_specs`.

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
                                            cache_block, embed_tokens,
                                            gather_layer, kv_cache_spec,
                                            logits_fn, mlp_block, seq_axes)


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


def _mamba_layer(pl, x, cfg, pcfg, st, *, chunked, mesh=None):
    """One mamba layer (`pl`: its shards, gathered over 'data' here).
    Where the residual is cut over the sequence (training), the mixer
    takes this rank's normed rows gathered over 'model', and the rank
    keeps its rows of the output."""
    pl = gather_layer(pl, mesh)
    conv_st, ssm_st = st
    h = cm.seq_join(cm.rms_norm(x, pl["norm"], cfg.norm_eps), mesh)
    out, conv_new, ssm_new = mamba2.mamba_block(
        pl["mamba"], h, cfg, conv_state=conv_st, ssm_state=ssm_st,
        chunked=chunked, mesh=mesh)
    return x + cm.seq_leave(out, x, mesh), (conv_new, ssm_new)


def _shared_block(sq, x, positions, cfg, pcfg, cache=None, mesh=None):
    """Weight-tied attention + MLP block (`sq`: its weights, the leading
    dim-1 indexed away), the sequence gathered and kept per block as
    `_mamba_layer`'s where the residual is cut."""
    h = cm.seq_join(cm.rms_norm(x, sq["norm_attn"], cfg.norm_eps), mesh)
    x = x + cm.seq_leave(attention_block(
        sq["attn"], h, positions, cfg, pcfg, causal=True, cache=cache,
        mesh=mesh, seq_axes=seq_axes(mesh) if cache is not None else ()),
        x, mesh)
    h = cm.seq_join(cm.rms_norm(x, sq["norm_mlp"], cfg.norm_eps), mesh)
    return x + cm.seq_leave(mlp_block(sq["mlp"], h, cfg, pcfg, mesh=mesh),
                            x, mesh)


def _run(params, x, positions, cfg, pcfg, cache=None, lengths=None, *,
         chunked, mesh=None):
    """The layer loop of forward / prefill / decode: the mamba layers in
    order, the shared block after each group's last.  Without `cache`
    every layer starts from zero states; with it, layer i from its conv
    and SSM state there, which it overwrites, and the shared block of
    group g reads and writes KV slab g at ``cache["pos"]``.  Without
    `cache` and with ``pcfg.remat == "full"`` each mamba layer and each
    shared-block site is recomputed in the backward: finer than the
    reference's group checkpoints, the same values, and one layer's SSD
    tensors held at a time (a group's six did not fit on an 80 GB card
    at zamba2-7b's width and 4 x 2048 tokens).  On a mesh each mamba
    layer's weights are gathered over 'data' at use (inside its
    checkpoint in training), the shared block's once per call."""
    ae = cfg.attn_every
    if cache is None and pcfg.remat == "full":
        call = functools.partial(torch.utils.checkpoint.checkpoint,
                                 use_reentrant=False)
    else:
        call = lambda fn, *args, **kw: fn(*args, **kw)  # noqa: E731
    shared = _layer(params, 0, mesh, "shared")
    for i in range(cfg.n_layers):
        st = ((None, None) if cache is None
              else (cache["conv"][i], cache["ssm"][i]))
        x, (conv, ssm) = call(_mamba_layer, _index(params["layers"], i), x,
                              cfg, pcfg, st, chunked=chunked, mesh=mesh)
        if cache is not None:
            cache["conv"][i] = conv
            cache["ssm"][i] = ssm
        if (i + 1) % ae == 0:             # the end of group (i + 1) // ae
            g = i // ae
            kv = (None if cache is None else
                  (cache["k"][g], cache["v"][g], cache["pos"], lengths))
            x = call(_shared_block, shared, x, positions, cfg, pcfg, kv,
                     mesh)
    return x


def forward(params, batch, cfg: ModelConfig, pcfg: ParallelConfig,
            mesh=None):
    """tokens -> (hidden (B, S, d), {aux_loss: 0}).  On a mesh (training)
    as ``transformer.forward``: `mamba2.mamba_block`'s heads or P-cut
    layout, the residual cut over the sequence where
    ``mesh.seq_parallel``, the hidden states whole on every rank."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = embed_tokens(params, tokens, cfg, mesh)
    sp = cm.seq_view(mesh, s)
    x = _run(params, cm.seq_rows(x, sp), positions, cfg, pcfg, chunked=True,
             mesh=sp)
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return cm.seq_join(x, sp), {"aux_loss": torch.zeros(
        (), dtype=torch.float32, device=x.device)}


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """The global shapes of the cache's leaves."""
    ssm = cfg.ssm
    d_in = 2 * cfg.d_model
    ch = d_in + 2 * ssm.n_groups * ssm.state_dim
    _, nb, _ = _split_groups(cfg)
    kv = (nb, batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"conv": (cfg.n_layers, batch, ssm.conv_width - 1, ch),
            "ssm": (cfg.n_layers, batch, ssm.n_ssm_heads,
                    d_in // ssm.n_ssm_heads, ssm.state_dim),
            "k": kv, "v": kv, "pos": (), "lengths": (batch,)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               pcfg: ParallelConfig, device="cuda", mesh=None):
    """Zero float32 conv and SSM states (L, ...), zeroed bf16 K/V slabs
    (nb, B, max_seq, Hkv, hd), position 0; on a mesh, this rank's block
    of each under ``mesh.cache_specs`` (its requests, conv channels, SSM
    heads, and KV heads or block of positions)."""
    dev = cm.check_device(device)
    shapes = cache_shapes(cfg, batch, max_seq)
    zeros = lambda k, dt: torch.zeros(  # noqa: E731
        cache_block(shapes[k], k, mesh), dtype=dt, device=dev)
    return {"conv": zeros("conv", torch.float32),
            "ssm": zeros("ssm", torch.float32),
            "k": zeros("k", torch.bfloat16), "v": zeros("v", torch.bfloat16),
            "pos": 0, "lengths": zeros("lengths", torch.int32)}


def prefill(params, batch, cache, cfg: ModelConfig, pcfg: ParallelConfig,
            mesh=None):
    """Runs the prompt from the cache's states (chunked SSD) and writes its
    KV; returns (cache, last_hidden (B, 1, d)).  On a mesh, `params`,
    `batch` and `cache` are this rank's blocks."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = (torch.arange(s, device=tokens.device)[None].expand(b, s)
                 + cache["pos"]).to(torch.int32)
    x = embed_tokens(params, tokens, cfg, mesh)
    lengths = cache["lengths"] + s
    x = _run(params, x, positions, cfg, pcfg, cache, lengths, chunked=True,
             mesh=mesh)
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return dict(cache, pos=cache["pos"] + s, lengths=lengths), x[:, -1:]


def decode(params, tokens, cache, cfg: ModelConfig, pcfg: ParallelConfig,
           mesh=None):
    """One token step (sequential scan).  tokens (B, 1) -> (cache',
    logits (B, 1, V))."""
    b = tokens.shape[0]
    pos = cache["pos"]
    positions = torch.full((b, 1), pos, dtype=torch.int32,
                           device=tokens.device)
    x = embed_tokens(params, tokens, cfg, mesh)
    lengths = cache["lengths"] + 1
    x = _run(params, x, positions, cfg, pcfg, cache, lengths, chunked=False,
             mesh=mesh)
    x = cm.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = logits_fn(params, x, cfg, mesh)
    return dict(cache, pos=pos + 1, lengths=lengths), logits


def cache_specs(cfg, pcfg, long_ctx: bool, model_size: int = 16):
    """The reference's specs of the cache's leaves: the conv state's
    channels over 'model'; the SSM state's heads over it, or its P dim
    where the heads do not divide 'model' (`mamba2.mamba_block`); the KV
    slabs as the transformer's (`transformer.kv_cache_spec`: KV heads,
    else the sequence, over 'model'; the sequence over ('data', 'model')
    for long-context decode), the batch over ('pod', 'data')."""
    dp = cm.dp_axes()
    kv = kv_cache_spec(cfg, long_ctx, model_size)
    ssm = ((None, dp, "model", None, None)
           if cfg.ssm.n_ssm_heads % model_size == 0
           else (None, dp, None, "model", None))
    return {"conv": (None, dp, None, "model"), "ssm": ssm,
            "k": kv, "v": kv, "pos": (), "lengths": (dp,)}
