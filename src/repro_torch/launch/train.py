"""Training launcher (port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 1000 --batch 4 --seq 2048 [--ckpt-dir DIR --resume] \
      [--microbatch 2] [--smoke --device cpu]
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --distributed --arch tinyllama-1.1b --batch 8 ... \
      [--cross-pod-sync cascaded|dedicated|auto] [--grad-compression int8]
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --distributed --layout sharded [--model-size 2] --arch ...

Runs on ``cuda`` unless ``--device cpu`` is given, with
``attn_impl="pallas"`` (the hand-written Hopper kernels: flash attention
forward and backward for the transformer families and zamba2-7b's shared
attention (head dim 112), WKV6 for ``--arch rwkv6-3b``; on the CPU their
plain versions) and ``remat="full"`` (each layer, or each zamba group
with its shared block, recomputed in the backward).  The reference
launcher's default ``"chunked"`` is an XLA path with no kernel.

``--distributed`` runs under ``torchrun``: the process group comes from
its environment (NCCL for ``--device cuda``, one card per rank by
``LOCAL_RANK``; gloo for ``cpu``).  ``--layout pod`` (the default) runs
one process per pod: the mesh is ``('pod',)`` of the world size, each
rank draws its share of the global ``--batch`` from `SyntheticLM`
(``host_id=rank``), and the gradients are averaged across the ranks in
``--cross-pod-sync`` mode.  ``--layout sharded`` takes the reference's
rule: a ('data', 'model') mesh whose 'model' is the largest of 16, 8,
4, 2, 1 dividing both the world size and the config's heads (or
``--model-size``), 'data' the rest; the state is cut into each rank's
shards (``step.shard_state``), the experts are expert-parallel over
'model', every rank draws the global batch and keeps its share
(``collectives.local_batch`` as the loop's ``shard_batch``), and every
rank takes part in a checkpoint, which rank 0 writes
(``train/step.py``, ``train/checkpoint.py``).  Rank 0 alone logs.

The batches come from `SyntheticLM`, tokens only, as the reference's do:
``--arch whisper-base`` stops at the missing frame embeddings
(``KeyError: 'enc_embed'``) in both launchers; the encoder-decoder family
trains through `make_train_step` on ``models.make_batch(..., "train")``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics

from repro_torch.configs import ParallelConfig, get_config, reduce_config
from repro_torch.core.collectives import local_batch
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import mesh as mesh_mod
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.step import (init_state, is_sharded, make_train_step,
                                    shard_state)

#: the launcher's layout of the model on one card
PCFG = ParallelConfig(attn_impl="pallas", moe_impl="dense", remat="full")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (reduce_config)")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--cross-pod-sync", default="cascaded",
                    choices=("cascaded", "dedicated", "auto"))
    ap.add_argument("--grad-compression", default="none",
                    choices=("none", "int8"))
    ap.add_argument("--distributed", action="store_true",
                    help="ranks under torchrun (its RANK, WORLD_SIZE, "
                         "LOCAL_RANK, MASTER_ADDR/PORT)")
    ap.add_argument("--layout", default="pod", choices=("pod", "sharded"),
                    help="--distributed: one rank per pod, or a sharded "
                         "('data', 'model') mesh")
    ap.add_argument("--model-size", type=int, default=0,
                    help="--layout sharded: the 'model' axis (0: the "
                         "reference's rule)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if not args.distributed:
        return _run(args, rank=0, world=1, device=args.device, mesh=None)
    import torch
    import torch.distributed as dist
    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed: {missing} unset; run under "
                           f"torchrun (--nproc-per-node N)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = args.device
    if device == "cuda":
        local = int(os.environ["LOCAL_RANK"])
        torch.cuda.set_device(local)
        device = f"cuda:{local}"
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    try:
        if args.layout == "pod":
            shape, axes = (world,), ("pod",)
        else:
            model = args.model_size or model_size(world, _config(args))
            shape, axes = (world // model, model), ("data", "model")
        mesh = mesh_mod.make_test_mesh(shape, axes, device_type=args.device)
        return _run(args, rank, world, device, mesh)
    finally:
        dist.destroy_process_group()


def model_size(world: int, cfg) -> int:
    """The reference launcher's 'model' axis: the largest of 16, 8, 4, 2,
    1 that divides both the rank count and the config's heads."""
    return next(m for m in (16, 8, 4, 2, 1)
                if world % m == 0 and cfg.n_heads % m == 0)


def _config(args):
    cfg = get_config(args.arch)
    return reduce_config(cfg) if args.smoke else cfg


def _run(args, rank: int, world: int, device: str, mesh) -> int:
    lead = rank == 0
    say = print if lead else (lambda *_: None)
    cfg = _config(args)
    sharded = is_sharded(mesh)
    say(f"device={args.device} arch={cfg.name} "
        f"params={cfg.n_params()/1e6:.1f}M ranks={world}"
        + (f" mesh={mesh_mod.axis_sizes(mesh)}" if sharded else "")
        + (f" cross_pod_sync={args.cross_pod_sync} "
           f"grad_compression={args.grad_compression}"
           if mesh and not sharded else ""))

    pcfg = dataclasses.replace(PCFG, cross_pod_sync=args.cross_pod_sync,
                               grad_compression=args.grad_compression,
                               moe_impl="shard_map" if sharded else "dense")
    step = make_train_step(cfg, pcfg, mesh, lr=args.lr, total=args.steps,
                           microbatch=args.microbatch)
    state = init_state(0, cfg, device=device)
    if sharded:
        state = shard_state(state, mesh)
        data = SyntheticLM(cfg.vocab_size, args.seq, args.batch)
        shard_batch = lambda b: local_batch(b, mesh)  # noqa: E731
        saves = {"mesh": mesh, "specs": step.ctx.specs}
    else:
        data = SyntheticLM(cfg.vocab_size, args.seq, args.batch,
                           host_id=rank, num_hosts=world)
        shard_batch, saves = (lambda b: b), {}
    if args.resume and args.ckpt_dir and ckpt.latest_step(args.ckpt_dir):
        state = ckpt.restore(state, args.ckpt_dir,
                             mesh=mesh if sharded else None)
        say(f"resumed from step {int(state.step)}")

    lcfg = LoopConfig(total_steps=args.steps,
                      ckpt_dir=args.ckpt_dir if lead or sharded else None,
                      ckpt_every=200, log_every=10)
    state, hist = train(state, step, data, lcfg, shard_batch, log=say,
                        **saves)
    if hist["losses"]:
        say(f"final loss {hist['losses'][-1]:.4f}; step "
            f"{1e3 * statistics.median(hist['step_s']):.1f} ms (median of "
            f"{len(hist['step_s'])})")
    if sharded and hist["losses"]:
        n, log = len(hist["losses"]), step.ctx.log
        say(f"per rank per step: {log.wire_bytes / n:.0f} B on the wire, "
            f"{log.staged_bytes / n:.0f} B staged, {log.ops / n:g} calls")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
