"""Training launcher (port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 1000 --batch 4 --seq 2048 [--ckpt-dir DIR --resume] \
      [--microbatch 2] [--smoke --device cpu]
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --distributed --arch tinyllama-1.1b --batch 8 ... \
      [--cross-pod-sync cascaded|dedicated|auto] [--grad-compression int8]

Runs on ``cuda`` unless ``--device cpu`` is given, with
``attn_impl="pallas"`` (the hand-written Hopper kernels: flash attention
forward and backward for the transformer families and zamba2-7b's shared
attention (head dim 112), WKV6 for ``--arch rwkv6-3b``; on the CPU their
plain versions) and ``remat="full"`` (each layer, or each zamba group
with its shared block, recomputed in the backward).  The reference
launcher's default ``"chunked"`` is an XLA path with no kernel.

``--distributed`` runs one process per pod under ``torchrun``: the
process group comes from its environment (NCCL for ``--device cuda``, one
card per rank by ``LOCAL_RANK``; gloo for ``cpu``), the mesh is
``('pod',)`` of the world size, each rank draws its share of the global
``--batch`` from `SyntheticLM` (``host_id=rank``), and the gradients are
averaged across the ranks in ``--cross-pod-sync`` mode (``train/step.py``).
Rank 0 alone logs and writes checkpoints.

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
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import mesh as mesh_mod
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.step import init_state, make_train_step

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
                    help="one rank per pod under torchrun (its RANK, "
                         "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT)")
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
        mesh = mesh_mod.make_test_mesh((world,), ("pod",),
                                       device_type=args.device)
        return _run(args, rank, world, device, mesh)
    finally:
        dist.destroy_process_group()


def _run(args, rank: int, world: int, device: str, mesh) -> int:
    lead = rank == 0
    say = print if lead else (lambda *_: None)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_config(cfg)
    say(f"device={args.device} arch={cfg.name} "
        f"params={cfg.n_params()/1e6:.1f}M ranks={world}"
        + (f" cross_pod_sync={args.cross_pod_sync} "
           f"grad_compression={args.grad_compression}" if mesh else ""))

    state = init_state(0, cfg, device=device)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, host_id=rank,
                       num_hosts=world)
    if args.resume and args.ckpt_dir and ckpt.latest_step(args.ckpt_dir):
        state = ckpt.restore(state, args.ckpt_dir)
        say(f"resumed from step {int(state.step)}")

    pcfg = dataclasses.replace(PCFG, cross_pod_sync=args.cross_pod_sync,
                               grad_compression=args.grad_compression)
    step = make_train_step(cfg, pcfg, mesh, lr=args.lr, total=args.steps,
                           microbatch=args.microbatch)
    lcfg = LoopConfig(total_steps=args.steps,
                      ckpt_dir=args.ckpt_dir if lead else None,
                      ckpt_every=200, log_every=10)
    state, hist = train(state, step, data, lcfg, log=say)
    if hist["losses"]:
        say(f"final loss {hist['losses'][-1]:.4f}; step "
            f"{1e3 * statistics.median(hist['step_s']):.1f} ms (median of "
            f"{len(hist['step_s'])})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
