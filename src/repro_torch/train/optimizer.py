"""AdamW and the learning-rate schedule (port of
``repro/train/optimizer.py``): plain functions on nested dicts of
float32 tensors, with the reference's formulas in its order (bias
correction with ``step + 1``; decoupled decay added to the update before
the learning rate scales it).  ``torch.optim.AdamW`` orders the
operations differently and is not used.  Every operation is elementwise,
so AdamW runs unchanged on a rank's shards: with the sharded step
(``train/step.py``) m and v are cut as the params are (ZeRO-3 over
'data', the tensor-parallel blocks over 'model'), each rank updating
its own blocks; on one card, and on every rank of a 'pod' mesh, they
are the whole tensors beside the params.  Updates are functional: new
tensors, the inputs unchanged."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.common import map_tree


class AdamWState(NamedTuple):
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(m=map_tree(zeros, params), v=map_tree(zeros, params))


def adamw_update(grads, state: AdamWState, params, lr, step,
                 cfg: AdamWConfig = AdamWConfig()):
    """Returns (new_params, new_state).  `step` (a 0-d int tensor) is the
    *completed* step count (bias correction uses step+1); `lr` a float or
    a 0-d float32 tensor."""
    t = (step + 1).float()
    b1, b2 = cfg.b1, cfg.b2
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t

    def upd(g, m, v, p):
        # the reference's operations in its order, the temporaries this
        # function owns updated in place (the same bits): a leaf's update
        # holds fewer leaf-sized tensors at once (a stacked leaf of
        # zamba2-7b at full width is 3.2 GB)
        g = g.float()
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g.square()
        delta = (m_new / c1).div_((v_new / c2).sqrt_().add_(cfg.eps))
        if cfg.weight_decay:
            delta.add_(cfg.weight_decay * p.float())
        p_new = (p.float() - delta.mul_(lr)).to(p.dtype)
        return p_new, m_new, v_new

    flat = map_tree(lambda *x: upd(*x), grads, state.m, state.v, params)
    pick = lambda i: map_tree(lambda x: x[i], flat)  # noqa: E731
    return pick(0), AdamWState(m=pick(1), v=pick(2))


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  floor: float = 0.1):
    """step -> learning rate: linear warmup over `warmup` steps, then a
    cosine from `base_lr` down to ``floor * base_lr`` at `total`, as a 0-d
    float32 tensor on the step's device, computed in float32 as the
    reference does."""
    def schedule(step):
        if not torch.is_tensor(step):
            step = torch.tensor(float(step), dtype=torch.float32)
        step = step.float()
        warm = torch.clamp((step + 1) / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * warm * cos
    return schedule
