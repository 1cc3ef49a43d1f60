"""Training loop with fault-tolerance plumbing (port of
``repro/train/loop.py``).

* resume-exact from the latest checkpoint (the step counter doubles as
  the deterministic data cursor),
* async checkpoint cadence + preemption-style save-on-signal (SIGUSR1),
* straggler watchdog: per-step wall-time EWMA; steps slower than
  `straggler_factor` x EWMA are logged (its clock is injectable, so
  tests fake it),
* NaN/inf loss guard: abort loudly rather than silently diverge.

A step's time is taken after ``float(loss)``, which waits for the card.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_last: int = 3
    log_every: int = 10
    straggler_factor: float = 2.0
    ewma_alpha: float = 0.1


class StragglerWatchdog:
    def __init__(self, factor: float, alpha: float, clock=time.monotonic):
        self.factor, self.alpha, self.clock = factor, alpha, clock
        self.ewma: Optional[float] = None
        self.events: list[tuple[int, float, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.factor * self.ewma
        if slow:
            self.events.append((step, dt, self.ewma))
        self.ewma = dt if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


def train(state, train_step: Callable, data, lcfg: LoopConfig,
          shard_batch: Callable = lambda b: b, log: Callable = print, *,
          mesh=None, specs=None):
    """Runs to lcfg.total_steps from state.step (resume-aware).  Returns
    (state, {"losses", "step_s", "straggler_events"}): one loss and one
    wall time (the watchdog's clock, seconds) per step taken.
    `shard_batch` maps each global batch to this rank's share (the
    reference's; ``collectives.local_batch`` on a mesh).  A sharded
    state's checkpoints take the mesh and the params' `specs`: every
    rank calls the save (it gathers each leaf), rank 0 writes
    (``checkpoint.save``)."""
    saver = ckpt.AsyncSaver()
    watchdog = StragglerWatchdog(lcfg.straggler_factor, lcfg.ewma_alpha)
    start = int(state.step)
    preempted = {"flag": False}

    def _on_signal(signum, frame):
        preempted["flag"] = True
    old = None
    try:
        old = signal.signal(signal.SIGUSR1, _on_signal)
    except ValueError:
        pass  # non-main thread (tests)

    history, times = [], []
    try:
        for step in range(start, lcfg.total_steps):
            batch = shard_batch(data.batch(step))
            t0 = watchdog.clock()
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            dt = watchdog.clock() - t0
            slow = watchdog.observe(step, dt)
            history.append(loss)
            times.append(dt)
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {step}")
            if step % lcfg.log_every == 0 or slow:
                log(f"step {step:6d} loss {loss:8.4f} "
                    f"gnorm {float(metrics.get('grad_norm', 0)):7.3f} "
                    f"dt {dt*1e3:7.1f}ms{'  [STRAGGLER]' if slow else ''}")
            if lcfg.ckpt_dir and (step + 1) % lcfg.ckpt_every == 0:
                saver.save(state, step + 1, lcfg.ckpt_dir, lcfg.keep_last,
                           mesh=mesh, specs=specs)
            if preempted["flag"]:
                log(f"preemption signal at step {step}: saving + exiting")
                saver.wait()
                ckpt.save(state, step + 1, lcfg.ckpt_dir or ".",
                          lcfg.keep_last, mesh=mesh, specs=specs)
                break
        saver.wait()
    finally:
        if old is not None:
            signal.signal(signal.SIGUSR1, old)
    return state, {"losses": history, "step_s": times,
                   "straggler_events": watchdog.events}
