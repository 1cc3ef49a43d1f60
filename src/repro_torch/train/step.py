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
own schedule, as GSPMD's is in the reference.

With 'data' or 'model' > 1 (any ('pod', 'data', 'model') mesh) the step
is sharded, the reference's GSPMD step made explicit:

* the state is this rank's shards of params, m and v under `state_specs`
  (`shard_state` cuts a whole state; FSDP over 'data', Megatron TP over
  'model', replicated over 'pod'): the reference's ZeRO-3;
* `batch` is this rank's share over ('pod', 'data')
  (``collectives.local_batch``), whole over 'model';
* the model runs on a ``models.common.MeshContext``: each layer gathers
  its weights over 'data' at use (inside its checkpoint under
  ``pcfg.remat == "full"``, so the backward gathers them again), the
  column- and row-parallel products over 'model', the residual stream cut
  over the sequence on 'model' where ``pcfg.seq_shard_activations``
  (``pcfg.sp_boundary``), the vocab-parallel loss;
* autograd runs through the collectives (each backward its adjoint: the
  FSDP gather's is the reduce-scatter of the weight's gradient onto the
  shard), with the local loss scaled by 1 / ('data' x 'model') so that
  the sum over those ranks is the pod's mean; a leaf not cut over 'data'
  or 'model' has its gradient summed over that axis once per step (one
  fused all-reduce of the bucket of such leaves per axis);
* the shards are then synced over 'pod' in the chosen mode
  (``pod_sync_wrap``), clipped by the global norm of the sharded tree
  (``losses.clip_by_global_norm``), and updated by AdamW, shard by shard.

Every collective of the sharded step is counted in ``train_step.ctx.log``
(a ``CommLog``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import collectives
from repro_torch.core import partitioning as part
from repro_torch.core.comm import axis_sizes
from repro_torch.models import get_model
from repro_torch.models import common as cm
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


def shard_state(state: TrainState, mesh) -> TrainState:
    """This rank's shards of a whole `state` (e.g. from
    ``convert.state_from_reference``) under `state_specs`: params, m and
    v cut alike (``partitioning.shard_tree``), the step whole; copies, so
    the whole state can be freed."""
    specs = state_specs(state, mesh)
    cut = lambda tree, sp: map_tree(  # noqa: E731
        lambda x: x.clone(), part.shard_tree(tree, sp, mesh))
    return TrainState(step=state.step.clone(),
                      params=cut(state.params, specs.params),
                      opt=AdamWState(m=cut(state.opt.m, specs.opt.m),
                                     v=cut(state.opt.v, specs.opt.v)))


def is_sharded(mesh) -> bool:
    """True where `mesh` has 'data' or 'model' (any axis but 'pod') of
    size > 1: the sharded step."""
    return mesh is not None and any(
        n > 1 for a, n in axis_sizes(mesh).items() if a != "pod")


def mesh_context(cfg: ModelConfig, pcfg: ParallelConfig, mesh):
    """The ``MeshContext`` the sharded step runs the model on: the
    params' specs, the batch cut over ('pod', 'data'), sequence
    parallelism as ``pcfg`` says."""
    return cm.MeshContext(mesh, part.config_specs(cfg, mesh),
                          batch_axes=cm.dp_axes(),
                          seq_parallel=pcfg.seq_shard_activations,
                          sp_boundary=pcfg.sp_boundary, train=True)


def _sum_unsharded(grads, ctx):
    """Each leaf's gradient summed over 'data' and 'model' where its spec
    does not cut it (replicated leaves: every rank holds a share of their
    gradient): per axis one fused all-reduce of the bucket of those
    leaves, flattened in `leaves` order."""
    flat = flatten_paths(grads)
    for axis in ("data", "model"):
        if ctx.sizes.get(axis, 1) == 1:
            continue
        names = [k for k in flat if axis not in
                 {a for e in ctx.spec(k) for a in cm.entry_axes(e)}]
        if not names:
            continue
        total = ctx.sum(torch.cat([flat[k].reshape(-1) for k in names]),
                        (axis,))
        for k, piece in zip(names, total.split([flat[k].numel()
                                                for k in names])):
            flat[k] = piece.reshape(flat[k].shape)
    return unflatten_paths(flat)


def make_grad_fn(cfg: ModelConfig, pcfg: ParallelConfig, ctx=None):
    """(params, batch) -> ((loss, metrics), grads): the counterpart of
    ``jax.value_and_grad(loss_fn, has_aux=True)``.  The loss is the
    chunked LM loss plus the model's aux loss; grads mirror params (float32,
    as the params are).  With `ctx` (a ``MeshContext``: the sharded
    step), `params` are this rank's shards and `batch` its share; the
    grads come back on the shards, summed over the ranks (the pod's
    gradients), and the loss and metrics are the pod's."""
    model = get_model(cfg)
    kw = {} if ctx is None else {"mesh": ctx}
    scale = 1.0 if ctx is None else 1.0 / ctx.size(("data", "model"))

    def grad_fn(params, batch):
        flat = {k: v.detach().requires_grad_()
                for k, v in flatten_paths(params).items()}
        p = unflatten_paths(flat)
        with torch.enable_grad():
            hidden, aux = model.forward(p, batch, cfg, pcfg, **kw)
            lm = chunked_lm_loss(p, hidden, batch["labels"], cfg,
                                 chunk=pcfg.logit_chunk, **kw)
            objective = (lm + aux["aux_loss"]) * scale
        gs = torch.autograd.grad(objective, list(flat.values()),
                                 allow_unused=True, materialize_grads=True)
        grads = unflatten_paths(dict(zip(flat, gs)))
        aux_l = aux["aux_loss"].detach()
        lm = lm.detach()
        if ctx is not None:
            grads = _sum_unsharded(grads, ctx)
            lm = ctx.sum(lm, ("data",)) / ctx.size(("data",))
        metrics = {"lm_loss": lm, "aux_loss": aux_l}
        return (lm + aux_l, metrics), grads

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
    numpy arrays or tensors; they go to the state's device.  With a mesh,
    `batch` is this rank's share of the global batch
    (``collectives.local_batch``) and the loss and metrics are the mean
    over the ranks; with 'data' or 'model' > 1, `state` is this rank's
    shards (`shard_state`) and so is the new one.  `microbatch` counts
    rows of a pod's batch, as in the reference (its cross-pod step runs
    the accumulation on each pod's share, GSPMD cuts it over 'data')."""
    ctx = mesh_context(cfg, pcfg, mesh) if is_sharded(mesh) else None
    grad_fn = make_grad_fn(cfg, pcfg, ctx)
    schedule = warmup_cosine(lr, warmup, total)
    dp = 1 if mesh is None else axis_sizes(mesh).get("data", 1)
    if microbatch % dp:
        raise ValueError(f"microbatch {microbatch} does not divide over the "
                         f"{dp} ranks of 'data'")
    local_micro = microbatch // dp

    def grad_accum_fn(params, batch):
        """Loop over microbatches, averaging losses and gradients."""
        parts = _microbatches(batch, local_micro)
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
        grads, gnorm = clip_by_global_norm(
            grads, clip, ctx, None if ctx is None else ctx.specs)
        lr_t = schedule(state.step)
        params, opt = adamw_update(grads, state.opt, state.params, lr_t,
                                   state.step, adamw)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr_t)
        return TrainState(step=state.step + 1, params=params, opt=opt), metrics

    train_step.ctx = ctx
    return train_step
