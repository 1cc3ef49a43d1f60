"""Serving launcher: load a checkpoint (or init), serve batched synthetic
requests (port of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --requests 8 --prompt-len 32 --new-tokens 32

Runs on ``cuda`` unless ``--device cpu`` is given, with
``attn_impl="pallas"``: the hand-written Hopper kernels for prefill
(flash attention) and decode (flash-decode); on the CPU their plain
versions.  (The reference launcher's ``"chunked"`` is an XLA path with no
kernel.)  ``--arch rwkv6-3b`` serves RWKV-6, whose prefill and decode run
no kernel, as in the reference; ``--arch zamba2-7b`` the hybrid family
(Mamba2 + the shared attention block, on both kernels at head dim 112),
``--arch whisper-base`` the encoder-decoder (its decoder's self-attention
on both kernels).  The batch is `models.make_batch`'s with the
`SyntheticLM` prompts as its tokens, so whisper gets its frame embeddings
``enc_embed``; the reference's launcher passes the tokens alone, which
serves every family but encdec.  ``--ckpt-dir`` serves the params of the
latest checkpoint there (written by either package's
``train/checkpoint.py``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ParallelConfig, get_config, reduce_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import make_batch
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.step import init_state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--policy", default="mlr", choices=("mlr", "slr"))
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (reduce_config)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_config(cfg)
    pcfg = ParallelConfig(attn_impl="pallas", moe_impl="dense",
                          remat="none")
    state = init_state(0, cfg, device=args.device)
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir):
        state = ckpt.restore(state, args.ckpt_dir)
        print(f"loaded checkpoint step {int(state.step)}")
    params = state.params
    del state                         # the optimizer moments are not served
    eng = Engine(cfg, pcfg,
                 ServeConfig(max_seq=args.prompt_len + args.new_tokens + 8,
                             policy=args.policy,
                             temperature=args.temperature),
                 params, device=args.device)
    data = SyntheticLM(cfg.vocab_size, args.prompt_len, args.requests,
                       seed=7)
    batch = make_batch(0, cfg, args.requests, args.prompt_len, "prefill")
    batch["tokens"] = torch.from_numpy(data.batch(0)["tokens"])
    t0 = time.perf_counter()
    out = eng.generate(batch, args.new_tokens)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    n_tok = out.shape[0] * out.shape[1]
    print(f"policy={args.policy} device={eng.device} generated {n_tok} "
          f"tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s)")
    print("first request:", out[0].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
