"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``).

Router: a float32 softmax over the experts -> top-k -> renormalise (the
qwen3/granite convention), and the Switch-style load-balance loss.

On one card the FFN takes the reference's dense path, ``_moe_dense``:
every expert runs on every token and a float32 gate combines them, the
reference's oracle and its path whenever there is no mesh, whatever
``ParallelConfig.moe_impl`` says.  The expert products are plain
einsums, as in the reference (no Pallas kernel there, none here).  The
reference's ``shard_map`` expert parallelism (``_moe_shard_map``: experts
sharded over the 'model' axis, a capacity buffer per rank, one psum of
the output) has nothing to map to on one card and waits for the
distribution slice (ROADMAP, Slice F); `capacity`, its buffer size, is
kept.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.models import common as cm


def route(x, w_router, cfg: ModelConfig):
    """x (B,S,d) -> (top_w (B,S,k) f32, top_ids (B,S,k) int64, aux_loss)."""
    k = cfg.moe.experts_per_token
    e = cfg.moe.n_experts
    logits = torch.matmul(x.float(), w_router.float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = torch.topk(probs, k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * P_e
    t = probs.shape[0] * probs.shape[1]
    counts = torch.bincount(top_ids.reshape(-1), minlength=e).float()
    f = counts / (t * k)
    p_mean = probs.mean(dim=(0, 1))
    aux = cfg.moe.aux_loss_weight * e * torch.sum(f * p_mean)
    return top_w, top_ids, aux


def moe_ffn(x, p, cfg: ModelConfig, pcfg: ParallelConfig):
    """p: {'router': (d, E), 'experts': {w_gate/w_up/w_down: (E, ...)}}.
    Returns (out in x's dtype, aux_loss)."""
    top_w, top_ids, aux = route(x, p["router"], cfg)
    out = _moe_dense(x, top_w, top_ids, p["experts"], cfg)
    return out.to(x.dtype), aux


def _moe_dense(x, top_w, top_ids, experts, cfg: ModelConfig):
    """Every expert on every token, then the gated combine in float32."""
    e = cfg.moe.n_experts
    wg = cm.cast(experts["w_gate"], cfg)
    wu = cm.cast(experts["w_up"], cfg)
    wd = cm.cast(experts["w_down"], cfg)
    dt = torch.promote_types(x.dtype, wg.dtype)
    x = x.to(dt)
    g = torch.einsum("bsd,edf->bsef", x, wg.to(dt))
    u = torch.einsum("bsd,edf->bsef", x, wu.to(dt))
    y = torch.einsum("bsef,efd->bsed", F.silu(g) * u, wd.to(dt))
    gate = torch.zeros(top_ids.shape[:-1] + (e,), dtype=torch.float32,
                       device=x.device).scatter_add_(-1, top_ids,
                                                     top_w.float())
    return torch.einsum("bse,bsed->bsd", gate, y.float())


def capacity(t_local: int, k: int, e: int, cf: float) -> int:
    """Tokens each expert takes per expert-parallel rank (the reference's
    shard_map capacity buffer)."""
    c = int(math.ceil(cf * t_local * k / e))
    return int(min(t_local * k, max(c, min(32, t_local * k))))
