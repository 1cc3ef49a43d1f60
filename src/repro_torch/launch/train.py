"""Training launcher (port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 1000 --batch 4 --seq 2048 [--ckpt-dir DIR --resume] \
      [--microbatch 2] [--smoke --device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given, with
``attn_impl="pallas"`` (the hand-written Hopper kernels: flash attention
forward and backward for the transformer families and zamba2-7b's shared
attention (head dim 112), WKV6 for ``--arch rwkv6-3b``; on the CPU their
plain versions) and ``remat="full"`` (each layer, or each zamba group
with its shared block, recomputed in the backward).  The reference
launcher's default ``"chunked"`` is an XLA path with no kernel.
``--distributed`` (multi-host, a mesh) waits for Slice F (ROADMAP) and
raises.

The batches come from `SyntheticLM`, tokens only, as the reference's do:
``--arch whisper-base`` stops at the missing frame embeddings
(``KeyError: 'enc_embed'``) in both launchers; the encoder-decoder family
trains through `make_train_step` on ``models.make_batch(..., "train")``.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ParallelConfig, get_config, reduce_config
from repro_torch.data.pipeline import SyntheticLM
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
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host training (not ported yet)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.distributed:
        raise NotImplementedError("--distributed: multi-host training and "
                                  "the mesh wait for Slice F (ROADMAP)")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_config(cfg)
    print(f"device={args.device} arch={cfg.name} "
          f"params={cfg.n_params()/1e6:.1f}M")

    state = init_state(0, cfg, device=args.device)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch)
    if args.resume and args.ckpt_dir and ckpt.latest_step(args.ckpt_dir):
        state = ckpt.restore(state, args.ckpt_dir)
        print(f"resumed from step {int(state.step)}")

    step = make_train_step(cfg, PCFG, lr=args.lr, total=args.steps,
                           microbatch=args.microbatch)
    lcfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=200, log_every=10)
    state, hist = train(state, step, data, lcfg)
    if hist["losses"]:
        print(f"final loss {hist['losses'][-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
