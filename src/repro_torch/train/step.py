"""Train state + train step factory (port of ``repro/train/step.py``).

The step composes, in order:
  microbatch gradient accumulation (a loop)      [optional]
  -> value and gradient of the chunked-xent loss, by autograd
  -> global-norm clip -> AdamW update.

On one card there is no cross-pod hop: ``pcfg.cross_pod_sync`` and
``pcfg.grad_compression`` are inert, as on the reference's single-device
path.  A mesh, and with it the sharded state (``state_specs``), waits for
Slice F (ROADMAP) and raises.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.models import get_model
from repro_torch.models.common import flatten_paths, map_tree, unflatten_paths
from repro_torch.train.losses import chunked_lm_loss, clip_by_global_norm
from repro_torch.train.optimizer import (AdamWConfig, AdamWState, adamw_init,
                                         adamw_update, warmup_cosine)


class TrainState(NamedTuple):
    step: torch.Tensor        # () int32, on the params' device
    params: Any
    opt: AdamWState


def init_state(seed, cfg: ModelConfig, device="cuda") -> TrainState:
    """Float32 params drawn from `seed` (an int or a ``torch.Generator``
    on `device`), zero AdamW moments, step 0."""
    params = get_model(cfg).init(seed, cfg, device=device)
    dev = flatten_paths(params)["embed.tokens"].device
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      params=params, opt=adamw_init(params))


def make_grad_fn(cfg: ModelConfig, pcfg: ParallelConfig):
    """(params, batch) -> ((loss, metrics), grads): the counterpart of
    ``jax.value_and_grad(loss_fn, has_aux=True)``.  The loss is the
    chunked LM loss plus the model's aux loss; grads mirror params (float32,
    as the params are)."""
    model = get_model(cfg)

    def grad_fn(params, batch):
        flat = {k: v.detach().requires_grad_()
                for k, v in flatten_paths(params).items()}
        p = unflatten_paths(flat)
        with torch.enable_grad():
            hidden, aux = model.forward(p, batch, cfg, pcfg)
            lm = chunked_lm_loss(p, hidden, batch["labels"], cfg,
                                 chunk=pcfg.logit_chunk)
            loss = lm + aux["aux_loss"]
        gs = torch.autograd.grad(loss, list(flat.values()),
                                 allow_unused=True, materialize_grads=True)
        grads = unflatten_paths(dict(zip(flat, gs)))
        metrics = {"lm_loss": lm.detach(), "aux_loss": aux["aux_loss"]}
        return (loss.detach(), metrics), grads

    return grad_fn


def _microbatches(batch: dict, microbatch: int):
    """The batch cut into consecutive slices of `microbatch` rows, as the
    reference's reshape to (n, microbatch, ...) does: leaves with the
    batch on dim 0 or (M-RoPE positions) dim 1 are cut, others repeat."""
    b = batch["tokens"].shape[0]
    if microbatch < 1 or b % microbatch:
        raise ValueError(f"microbatch {microbatch} does not divide the "
                         f"batch {b}")

    def cut(leaf, i):
        sl = slice(i * microbatch, (i + 1) * microbatch)
        if leaf.dim() >= 2 and leaf.shape[0] == b:
            return leaf[sl]
        if leaf.dim() >= 2 and leaf.shape[1] == b:
            return leaf[:, sl]
        return leaf
    return [{k: cut(v, i) for k, v in batch.items()}
            for i in range(b // microbatch)]


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig, mesh=None, *,
                    lr: float = 3e-4, warmup: int = 100, total: int = 10_000,
                    adamw: AdamWConfig = AdamWConfig(), clip: float = 1.0,
                    microbatch: int = 0):
    """(state, batch) -> (state', metrics).  The batch's leaves may be
    numpy arrays or tensors; they go to the state's device."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step: a mesh (sharded state, cross-pod sync, "
            "gradient compression) waits for Slice F (ROADMAP); pass "
            "mesh=None for one card")
    grad_fn = make_grad_fn(cfg, pcfg)
    schedule = warmup_cosine(lr, warmup, total)

    def grad_accum_fn(params, batch):
        """Loop over microbatches, averaging losses and gradients."""
        parts = _microbatches(batch, microbatch)
        n = len(parts)
        loss = metrics = grads = None
        for one in parts:
            (l, m), g = grad_fn(params, one)
            if loss is None:
                loss = torch.zeros_like(l)
                metrics = map_tree(torch.zeros_like, m)
                grads = map_tree(torch.zeros_like, g)
            loss = loss + l / n
            metrics = map_tree(lambda a, x: a + x / n, metrics, m)
            grads = map_tree(lambda a, x: a + x / n, grads, g)
        return (loss, metrics), grads

    base = grad_accum_fn if microbatch else grad_fn

    def train_step(state: TrainState, batch):
        dev = state.step.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        (loss, metrics), grads = base(state.params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip)
        lr_t = schedule(state.step)
        params, opt = adamw_update(grads, state.opt, state.params, lr_t,
                                   state.step, adamw)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr_t)
        return TrainState(step=state.step + 1, params=params, opt=opt), metrics

    return train_step
