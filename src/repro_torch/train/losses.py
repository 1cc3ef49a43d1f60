"""Losses (port of ``repro/train/losses.py``).  The LM head is applied
CHUNKED over the sequence (blockwise cross-entropy): logits for a
(B, chunk, V) block are materialised, reduced to per-token nll, and
discarded inside ``torch.utils.checkpoint`` — peak memory is
O(B·chunk·V) instead of O(B·S·V), and the backward recomputes each
chunk's logits, as the reference's rematerialised scan does."""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.models.common import leaves, map_tree
from repro_torch.models.transformer import logits_fn


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


def _chunk_nll_sum(params, h_c, y_c, cfg, z_loss):
    return softmax_xent(logits_fn(params, h_c, cfg), y_c, z_loss).sum()


def chunked_lm_loss(params, hidden, labels, cfg, chunk: int = 2048,
                    z_loss: float = 1e-4):
    """hidden (B,S,d), labels (B,S) -> mean nll (scalar float32)."""
    b, s, d = hidden.shape
    c = min(chunk, s)
    if s % c != 0:
        logits = logits_fn(params, hidden, cfg)
        return softmax_xent(logits, labels, z_loss).mean()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // c):
        h_c, y_c = hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        total = total + torch.utils.checkpoint.checkpoint(
            _chunk_nll_sum, params, h_c, y_c, cfg, z_loss,
            use_reentrant=False)
    return total / (b * s)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, float32, the leaves
    summed in the reference's order."""
    return torch.sqrt(sum(l.float().square().sum() for l in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled so its global norm is at most `max_norm`, the norm
    before scaling)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return map_tree(lambda l: (l * scale).to(l.dtype), tree), norm

