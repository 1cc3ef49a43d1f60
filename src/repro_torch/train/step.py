"""Train state + train step factory (port of ``repro/train/step.py``).

The step composes, in order:
  microbatch gradient accumulation (a loop)      [optional]
  -> value and gradient of the chunked-xent loss, by autograd
  -> hierarchical cross-pod sync (cascaded ring / dedicated fused / int8
     ring)  [a 'pod' mesh]
  -> global-norm clip -> AdamW update.

Without a mesh the step runs on one device.  With a mesh whose only axis
of size > 1 is 'pod' (``launch.mesh``: a ``DeviceMesh`` over a process
group, one rank per pod), params and optimizer state stay replicated on
every rank, each rank takes its share of the global batch
(``collectives.local_batch``), and the gradients go through
``collectives.pod_sync_wrap`` before clip and AdamW, so every rank makes
the same update.  The mode is ``pcfg.cross_pod_sync``; with it,
``pcfg.grad_compression == "int8"`` selects the compressed ring.  "auto"
is the backend's fused all-reduce of each gradient (as "dedicated"): its
own schedule, as GSPMD's is in the reference.  Sharded 'data' and 'model' execution (FSDP,
TP) waits for Slice F3 (ROADMAP); `state_specs` already computes its
specs.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import collectives
from repro_torch.core import partitioning as part
from repro_torch.core.comm import axis_sizes
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


def state_specs(state: TrainState, mesh) -> TrainState:
    """Specs for a TrainState (params and AdamW moments mirror the param
    rules)."""
    pspecs = part.param_specs(state.params, mesh)
    return TrainState(step=(), params=pspecs,
                      opt=AdamWState(m=pspecs, v=pspecs))


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
    numpy arrays or tensors; they go to the state's device.  With a 'pod'
    mesh, `batch` is this rank's share of the global batch and the loss
    and metrics are the mean over the ranks."""
    if mesh is not None:
        wide = sorted(a for a, n in axis_sizes(mesh).items()
                      if n > 1 and a != "pod")
        if wide:
            raise NotImplementedError(
                f"make_train_step: mesh axes {wide} of size > 1: sharded "
                f"'data' and 'model' execution (FSDP, TP) waits for Slice "
                f"F3 (ROADMAP); meshes whose only axis of size > 1 is "
                f"'pod' train here")
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
    mode = pcfg.cross_pod_sync
    if mode != "auto" and pcfg.grad_compression == "int8":
        mode = "cascaded_int8"
    synced = collectives.pod_sync_wrap(base, mesh, mode=mode)

    def train_step(state: TrainState, batch):
        dev = state.step.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        (loss, metrics), grads = synced(state.params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip)
        lr_t = schedule(state.step)
        params, opt = adamw_update(grads, state.opt, state.params, lr_t,
                                   state.step, adamw)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr_t)
        return TrainState(step=state.step + 1, params=params, opt=opt), metrics

    return train_step
