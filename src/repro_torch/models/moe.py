"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``).

Router: a float32 softmax over the experts -> top-k -> renormalise (the
qwen3/granite convention), and the Switch-style load-balance loss.

Two dispatch implementations, as in the reference:

* ``_moe_dense``: every expert runs on every token and a float32 gate
  combines them; the reference's oracle, and its path (and this one)
  whenever there is no mesh with a 'model' axis > 1 or
  ``ParallelConfig.moe_impl`` is "dense".
* `_moe_expert_parallel`, the counterpart of the reference's
  ``_moe_shard_map``: experts zero-padded to a multiple of the 'model'
  size (padded experts are unroutable) and cut over 'model'; each rank
  takes the reference's token block (the batch cut over its ('pod',
  'data') axes), sorts the block's assignments to its own experts with
  the same stable sort, keeps the first `capacity` of each expert's
  queue, runs its experts as one grouped product on the (E_local, C, d)
  buffer, combines in float32, and one sum over 'model' adds the ranks'
  parts.  The rank's batch cut is mapped onto the reference's block
  first (a gather over 'model' under SLR, whose batch is cut over
  'model' as well) and back after.

The expert products are plain einsums, as in the reference (no Pallas
kernel there, none here).
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


def moe_ffn(x, p, cfg: ModelConfig, pcfg: ParallelConfig, mesh=None):
    """p: {'router': (d, E), 'experts': {w_gate/w_up/w_down: (E, ...)}}.
    Returns (out in x's dtype, aux_loss).  Expert-parallel
    (`_moe_expert_parallel`) on a mesh with a 'model' axis > 1 under
    ``moe_impl == "shard_map"``, as the reference dispatches."""
    if (mesh is not None and pcfg.moe_impl == "shard_map"
            and mesh.sizes.get("model", 1) > 1):
        return _moe_expert_parallel(x, p, cfg, mesh)
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


# ----------------------------------------------------------------------------
# expert parallelism over 'model'
# ----------------------------------------------------------------------------


def _reference_block_axes(mesh, batch: int) -> tuple[str, ...]:
    """The axes the reference's ``_moe_shard_map`` cuts a global batch of
    `batch` requests over: ('pod', 'data') where the mesh has them, none
    where `batch` does not divide by their product."""
    dp = tuple(a for a in cm.dp_axes() if mesh.sizes.get(a, 1) > 1)
    return dp if batch % mesh.size(dp) == 0 else ()


def _to_block(x, mesh, block: tuple):
    """This rank's rows of `x` (its batch cut, ``mesh.batch_axes``) ->
    the rows of the reference's token block (cut over `block`)."""
    have = mesh.batch_axes
    if have == block:
        return x
    if have[:len(block)] == block:                  # SLR: also over 'model'
        return mesh.gather(x, 0, have[len(block):])
    if not have:                                    # the batch whole
        return mesh.rows(x, block)
    raise NotImplementedError(f"moe: batch cut over {have}, the reference's "
                              f"expert blocks over {block}")


def _from_block(out, mesh, block: tuple):
    """The inverse of `_to_block`."""
    have = mesh.batch_axes
    if have == block:
        return out
    if have[:len(block)] == block:
        return mesh.rows(out, have[len(block):])
    return mesh.gather(out, 0, block)


def ep_plan(top_ids, rank: int, e_local: int, cap: int):
    """The reference's dispatch of one token block on EP rank `rank`:
    top_ids (t, k) -> (st, sk, sw_index, keep, slot) over the t*k
    assignments in the stable sort of their local expert (others last):
    the token `st`, local expert `sk`, the flat assignment index (into
    top_w.reshape(-1)), whether it is kept (its expert is this rank's and
    it is within the first `cap` of that expert's queue) and its buffer
    slot (``e_local * cap`` for the dropped)."""
    t, k = top_ids.shape
    ids = top_ids.reshape(-1)
    tok = torch.arange(t, device=ids.device).repeat_interleave(k)
    local = ids - rank * e_local
    mine = (local >= 0) & (local < e_local)
    key = torch.where(mine, local, torch.full_like(local, e_local))
    _, order = torch.sort(key, stable=True)
    sk, st = key[order], tok[order]
    pos = torch.arange(t * k, device=ids.device) - torch.searchsorted(sk, sk)
    keep = (sk < e_local) & (pos < cap)
    slot = torch.where(keep, sk * cap + pos,
                       torch.full_like(sk, e_local * cap))
    return st, sk, order, keep, slot


def _moe_ep_block(x, top_w, top_ids, experts, cfg: ModelConfig, mesh):
    """The reference's ``_moe_shard_map`` body on one token block (x (b,
    s, d), the whole block on every rank of 'model'): this rank's experts
    (its block of the padded experts) on their kept assignments, the
    float32 combine, summed over 'model'.  Returns (b, s, d) float32."""
    b, s, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.experts_per_token
    ep = mesh.sizes["model"]
    e_pad = -(-e // ep) * ep
    e_local = e_pad // ep
    rank = mesh.coords["model"]
    t = b * s
    cap = capacity(t, k, e, cfg.moe.capacity_factor)

    def mine(w):
        w = cm.cast(w, cfg)
        if w.shape[0] != e:                           # cut over 'model'
            return w
        w = F.pad(w, (0, 0, 0, 0, 0, e_pad - e))
        return w[rank * e_local:(rank + 1) * e_local]

    wg, wu, wd = (mine(experts[n]) for n in ("w_gate", "w_up", "w_down"))
    x2 = x.reshape(t, d)
    st, sk, order, keep, slot = ep_plan(top_ids.reshape(t, k), rank,
                                        e_local, cap)
    sw = top_w.reshape(-1)[order]
    dt = torch.promote_types(x.dtype, wg.dtype)
    vals = torch.where(keep[:, None], x2[st].to(dt), 0)
    xbuf = torch.zeros((e_local * cap + 1, d), dtype=dt, device=x.device)
    xbuf[slot] = vals
    xe = xbuf[:-1].reshape(e_local, cap, d)
    g = torch.einsum("ecd,edf->ecf", xe, wg.to(dt))
    u = torch.einsum("ecd,edf->ecf", xe, wu.to(dt))
    y = torch.einsum("ecf,efd->ecd", F.silu(g) * u, wd.to(dt))
    yf = torch.cat([y.reshape(e_local * cap, d),
                    torch.zeros((1, d), dtype=y.dtype, device=y.device)])
    contrib = yf[slot].float() * (sw * keep)[:, None]
    out = torch.zeros((t, d), dtype=torch.float32,
                      device=x.device).index_add_(0, st, contrib)
    return mesh.sum(out, ("model",)).reshape(b, s, d)


def _moe_expert_parallel(x, p, cfg: ModelConfig, mesh):
    """Expert parallelism over 'model' (the reference's ``_moe_shard_map``
    path of ``moe_ffn``): this rank's rows mapped onto the reference's
    token block, routed, dispatched to this rank's experts
    (`_moe_ep_block`) and mapped back.  The aux loss is the block's (the
    reference's is the whole batch's; serving drops it)."""
    batch = x.shape[0] * mesh.size(mesh.batch_axes)
    block = _reference_block_axes(mesh, batch)
    xb = _to_block(x, mesh, block)
    top_w, top_ids, aux = route(xb, p["router"], cfg)
    out = _moe_ep_block(xb, top_w, top_ids, p["experts"], cfg, mesh)
    return _from_block(out, mesh, block).to(x.dtype), aux
