"""The port's train step of one model on the card: its time and its peak
memory.

  PYTHONPATH=src python src/repro_torch/benchmarks/train_step_bench.py \
      --arch zamba2-7b --layers 15 --batch 4 --seq 2048 --steps 6

The model is the named config at full width, cut to ``--layers`` layers
(all of them if 0), random weights from seed 0, trained on
`SyntheticLM` batches (seed 0) through `launch/train.py`'s layout
(attn_impl "pallas", remat "full") and `train.loop.train`.  Prints one
JSON line: each step's ms on the loop's host clock, their median after
the first two, tokens/s at that median, the peak memory allocated and
reserved, the card's memory and its name and power limit.  It needs a
card and only the package's training entry points, so it also times an
older tree's package (``PYTHONPATH=<tree>/src python <this file>``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.train import PCFG
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.step import init_state, make_train_step


def run(arch: str, layers: int, batch: int, seq: int, steps: int) -> dict:
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    state = init_state(0, cfg, device="cuda")
    step = make_train_step(cfg, PCFG, total=steps)
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=0)
    _, hist = train(state, step, data, LoopConfig(total_steps=steps,
                                                  log_every=steps + 1))
    torch.cuda.synchronize()
    step_ms = [1e3 * s for s in hist["step_s"]]
    med = float(np.median(step_ms[2:]))
    total_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    reserved_gb = torch.cuda.max_memory_reserved(dev) / 1e9
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": batch,
            "seq": seq, "steps": steps, "losses": hist["losses"],
            "step_ms": step_ms, "step_ms_median_3_on": med,
            "tokens_per_s": batch * seq / med * 1e3,
            "peak_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "peak_reserved_gb": reserved_gb, "card_memory_gb": total_gb,
            "free_at_peak_gb": total_gb - reserved_gb,
            "card": subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60, check=True).stdout.strip().splitlines()[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_step_bench: no CUDA device")
    print(json.dumps({"train_step_bench": run(
        args.arch, args.layers, args.batch, args.seq, args.steps)}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
