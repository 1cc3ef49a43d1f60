"""Losses (port of ``repro/train/losses.py``).  The LM head is applied
CHUNKED over the sequence (blockwise cross-entropy): logits for a
(B, chunk, V) block are materialised, reduced to per-token nll, and
discarded inside ``torch.utils.checkpoint`` — peak memory is
O(B·chunk·V) instead of O(B·S·V), and the backward recomputes each
chunk's logits, as the reference's rematerialised scan does.

On a mesh (``mesh=``, a ``models.common.MeshContext``) the loss is
vocab-parallel where the head is cut over 'model', or is tied and
'model' divides the vocabulary: each rank computes
its vocab columns' logits (``transformer.vocab_logits``), their max and
sum of exponentials are reduced over 'model', and the label's logit
comes from the rank that holds it (a sum over 'model' of the ranks'
masked picks); the full (B, C, V) logits are never gathered.  The
global norm of a sharded gradient tree sums each leaf's squares over the
axes that cut it, a replicated leaf once."""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.models.common import entry_axes, leaves, map_tree
from repro_torch.models.transformer import logits_fn, vocab_logits


def softmax_xent(logits, labels, z_loss: float = 0.0):
    """logits (..., V); labels (...) int -> nll per token, float32.

    The gold logit is gathered: the reference's masked sum (a partitioner
    workaround) adds zeros to it, so both are the same number."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    return nll


def vocab_parallel_xent(logits, labels, first: int, mesh,
                        z_loss: float = 0.0):
    """`softmax_xent` of logits cut over 'model' by vocab: `logits`
    (..., Vr) this rank's columns, the first of them vocabulary id
    `first`.  The max (no gradient) and the sum of exponentials are
    reduced over 'model', the gold logit summed over it from the one rank
    whose columns hold the label; every rank of 'model' gets the same
    nll per token, float32."""
    model = ("model",)
    logits = logits.float()
    m = mesh.max(logits.detach().amax(-1), model)
    lse = m + torch.log(mesh.sum(torch.exp(logits - m[..., None]).sum(-1),
                                 model))
    local = labels.long() - first
    hit = (local >= 0) & (local < logits.shape[-1])
    pick = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)[..., None])
    gold = mesh.sum(torch.where(hit, pick[..., 0], 0.0), model)
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    return nll


def _nll(params, h, y, cfg, z_loss, mesh):
    if mesh is None:
        return softmax_xent(logits_fn(params, h, cfg), y, z_loss)
    logits, first = vocab_logits(params, h, cfg, mesh)
    if logits.shape[-1] == cfg.vocab_size:
        return softmax_xent(logits, y, z_loss)
    return vocab_parallel_xent(logits, y, first, mesh, z_loss)


def _chunk_nll_sum(params, h_c, y_c, cfg, z_loss, mesh=None):
    return _nll(params, h_c, y_c, cfg, z_loss, mesh).sum()


def chunked_lm_loss(params, hidden, labels, cfg, chunk: int = 2048,
                    z_loss: float = 1e-4, mesh=None):
    """hidden (B,S,d), labels (B,S) -> mean nll (scalar float32).  On a
    mesh, `params` are this rank's shards, `hidden` and `labels` its
    rows, whole over the sequence."""
    b, s, d = hidden.shape
    c = min(chunk, s)
    if s % c != 0:
        return _nll(params, hidden, labels, cfg, z_loss, mesh).mean()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // c):
        h_c, y_c = hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        total = total + torch.utils.checkpoint.checkpoint(
            _chunk_nll_sum, params, h_c, y_c, cfg, z_loss, mesh,
            use_reentrant=False)
    return total / (b * s)


def global_norm(tree, mesh=None, specs=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, float32, the leaves
    summed in the reference's order.  On a mesh (`tree` this rank's
    blocks under `specs`): the local sums of the leaves cut over the same
    axes added, each such sum summed over its axes (one all-reduce per
    axis), so every block counts once."""
    if mesh is None:
        return torch.sqrt(sum(l.float().square().sum()
                              for l in leaves(tree)))
    parts: dict = {}
    for leaf, spec in zip(leaves(tree), leaves(specs)):
        axes = tuple(sorted(a for e in spec for a in entry_axes(e)
                            if mesh.sizes.get(a, 1) > 1))
        sq = leaf.float().square().sum()
        parts[axes] = parts[axes] + sq if axes in parts else sq
    return torch.sqrt(sum(mesh.sum(v, axes) for axes, v in parts.items()))


def clip_by_global_norm(tree, max_norm: float, mesh=None, specs=None):
    """(tree scaled so its global norm is at most `max_norm`, the norm
    before scaling); on a mesh, of the sharded tree (`global_norm`)."""
    norm = global_norm(tree, mesh, specs)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return map_tree(lambda l: (l * scale).to(l.dtype), tree), norm

