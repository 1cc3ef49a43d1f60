"""Deterministic synthetic LM data pipeline, host-sharded, prefetched
(port of ``repro/data/pipeline.py``: numpy and a thread, copied as they
are; `Prefetcher`'s `transform` may move a batch to the card).

The stream is LEARNABLE (so integration tests can assert loss decreases):
a Zipf unigram backbone + Markov bigram structure + induction segments
(spans repeated later in the sequence) — the usual synthetic diet for
testing LM training systems end to end.

Determinism: batch for (seed, step, host) is a pure function — restart-safe
resume (the data cursor is just the step counter stored in TrainState), and
elastic: a host only materialises its batch slice.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 zipf_a: float = 1.2, induction_frac: float = 0.5):
        assert global_batch % num_hosts == 0
        self.vocab, self.seq = vocab_size, seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // num_hosts
        self.seed, self.host, self.num_hosts = seed, host_id, num_hosts
        self.zipf_a = zipf_a
        self.induction_frac = induction_frac
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        self._p = p / p.sum()

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host]))
        b, s = self.local_batch, self.seq
        toks = rng.choice(self.vocab, size=(b, s + 1), p=self._p)
        # bigram structure: token 2k+1 depends deterministically on 2k
        toks[:, 1::2] = (toks[:, 0::2][:, :toks[:, 1::2].shape[1]] * 31 + 7) \
            % self.vocab
        # induction: copy an earlier span later in the sequence
        n_ind = int(b * self.induction_frac)
        if n_ind and s >= 16:
            span = s // 4
            src = rng.integers(0, s // 2 - span, size=n_ind)
            dst = rng.integers(s // 2, s - span, size=n_ind)
            for i in range(n_ind):
                toks[i, dst[i]:dst[i] + span] = toks[i, src[i]:src[i] + span]
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread double buffering (overlap host data gen with step).
    `next()` gives ``(step, transform(source.batch(step)))`` in step order
    from `start_step`, at most `depth` ahead; `close()` stops the thread."""

    def __init__(self, source: SyntheticLM, start_step: int = 0, depth: int = 2,
                 transform=None):
        self.source = source
        self.transform = transform or (lambda x: x)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            item = self.transform(self.source.batch(step))
            while not self._stop.is_set():
                try:
                    self._q.put((step, item), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
