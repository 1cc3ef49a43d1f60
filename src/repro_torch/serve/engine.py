"""Serving engine: batched prefill + decode (port of
``repro/serve/engine.py``).

Rank-organisation mapping (paper §5 -> serving): the reference places
params by ``ServeConfig.policy`` on a device mesh — **MLR** TP-shards them
over the 'model' axis (one request striped over every chip), **SLR**
replicates them there and spreads requests instead.  On one card there is
no mesh: both policies reduce to replication and give the same numbers.
``ServeConfig.policy`` is kept so configurations carry over
unchanged; ``mesh`` must be ``None``.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``;
CUDA without a card raises.  With ``ParallelConfig(attn_impl="pallas")``
prefill goes through the flash-attention kernel and every decode step
through the flash-decode kernel (their plain versions on the CPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.models import common as cm
from repro_torch.models import get_model
from repro_torch.models.transformer import logits_fn


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int = 2048
    policy: str = "mlr"            # mlr | slr (both replicate on one card)
    temperature: float = 0.0       # 0 = greedy
    eos_id: int = -1               # -1 = never stop


def make_serve_fns(cfg: ModelConfig, pcfg: ParallelConfig, scfg: ServeConfig,
                   mesh=None):
    """Returns (prefill_fn, decode_fn, None): there are no shardings on
    one card, and a mesh raises."""
    if mesh is not None:
        raise ValueError("make_serve_fns: this package serves on one card; "
                         "mesh must be None")
    model = get_model(cfg)

    def prefill_fn(params, batch, cache):
        cache, last_hidden = model.prefill(params, batch, cache, cfg, pcfg)
        return cache, logits_fn(params, last_hidden, cfg)

    def decode_fn(params, tokens, cache):
        return model.decode(params, tokens, cache, cfg, pcfg)

    return prefill_fn, decode_fn, None


class Engine:
    """Minimal batched-request engine: aligned prefill + stepwise decode.

    Requests are grouped into aligned batches (per-lane cache lengths);
    the scheduler is deliberately simple and synchronous, as in the
    reference.  The params are cast to the compute dtype once, here
    (`common.cast_weights`: the same numbers the reference's cast at use
    gives), and moved to `device`.
    """

    def __init__(self, cfg: ModelConfig, pcfg: ParallelConfig,
                 scfg: ServeConfig, params, mesh=None, device="cuda"):
        self.cfg, self.pcfg, self.scfg = cfg, pcfg, scfg
        self.device = cm.check_device(device)
        self.model = get_model(cfg)
        self.prefill_fn, self.decode_fn, _ = make_serve_fns(cfg, pcfg, scfg,
                                                            mesh)
        self.params = cm.cast_weights(params, cfg, self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(0)

    def _sample(self, logits):
        if self.scfg.temperature == 0.0:
            # first index on ties, as jnp.argmax
            return torch.argmax(logits[:, -1], dim=-1)[:, None]
        probs = torch.softmax(logits[:, -1] / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)

    def _batch(self, batch) -> dict:
        return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                   else v).to(self.device)
                for k, v in batch.items()}

    @torch.inference_mode()
    def generate(self, batch, max_new_tokens: int, observer=None):
        """batch: model inputs incl. tokens (B, S_prompt) (tensors or numpy
        arrays).  Returns (B, <= max_new_tokens) generated ids, int32, on
        the engine's device.

        Lanes that have emitted `eos_id` are *frozen*: every subsequent
        position in that lane is `eos_id`, never a live sample.  The loop
        stops early once all lanes are done, and the last token is never
        fed back (its KV would never be read), so `max_new_tokens` tokens
        take `max_new_tokens - 1` decode calls.

        `observer`, when given, is called once after prefill and once
        after every decode step as ``observer(kind, done=<pre-step (B,)
        finished mask>, lengths=<post-step per-lane cache lengths>)``; the
        serve<->sim bridge (`repro_torch.serve.bridge`) uses it."""
        batch = self._batch(batch)
        b = batch["tokens"].shape[0]
        eos = self.scfg.eos_id
        cache = self.model.init_cache(self.cfg, b, self.scfg.max_seq,
                                      self.pcfg, device=self.device)
        cache, logits = self.prefill_fn(self.params, batch, cache)
        done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        if observer is not None:
            observer("prefill", done=done, lengths=cache["lengths"])
        tok = self._sample(logits).to(torch.int32)
        outs = []
        for _ in range(max_new_tokens):
            if eos >= 0:
                tok = torch.where(done[:, None], torch.full_like(tok, eos),
                                  tok)
            outs.append(tok)
            if eos >= 0:
                done = done | (tok[:, 0] == eos)
                if bool(done.all()):
                    break
            if len(outs) == max_new_tokens:
                break            # the last token's KV is never consumed
            cache, logits = self.decode_fn(self.params, tok, cache)
            if observer is not None:
                observer("decode", done=done, lengths=cache["lengths"])
            tok = self._sample(logits).to(torch.int32)
        return torch.cat(outs, dim=1)
