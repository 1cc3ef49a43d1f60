"""Model registry: family -> implementation module (port of
``repro/models/__init__.py``).

Every family module exposes the same functional API:
  init(gen, cfg, device) -> params
  forward(params, batch, cfg, pcfg) -> (hidden (B,S,d), {aux_loss})
  init_cache(cfg, batch, max_seq, pcfg, device=...) -> cache
  prefill(params, batch, cache, cfg, pcfg) -> (cache, last_hidden (B,1,d))
  decode(params, tokens (B,1), cache, cfg, pcfg) -> (cache, logits (B,1,V))
plus transformer.logits_fn for the LM head.  Ported so far: the
transformer's three families (dense, VLM with M-RoPE, MoE) and RWKV6 (the
ssm family); the hybrid (zamba) and encdec (whisper) families raise until
their slice (ROADMAP Slice D).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv6, transformer
from repro_torch.models.transformer import logits_fn  # noqa: F401

_FAMILY = {
    "dense": transformer,
    "vlm": transformer,
    "moe": transformer,
    "ssm": rwkv6,
}


def get_model(cfg: ModelConfig):
    if cfg.family not in _FAMILY:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            f"Slice D)")
    return _FAMILY[cfg.family]


# ----------------------------------------------------------------------------
# concrete batches (tests, smoke runs)
# ----------------------------------------------------------------------------


def make_batch(seed: int, cfg: ModelConfig, batch: int, seq: int,
               kind: str = "train", device="cpu") -> dict[str, torch.Tensor]:
    """Concrete random batch of int32 model inputs.

    kind: train | prefill -> full-length tokens (+labels for train);
          decode           -> one token per sequence.
    The VLM family's full-length batches also carry M-RoPE ``positions``
    (3, B, S): three equal streams 0..S-1, as the reference's.
    Tokens and labels are drawn with numpy from ``(seed, 0)`` and
    ``(seed, 1)``, so they are the same in every process (the reference
    folds ``hash(name)`` into its key, which Python randomises per
    process)."""
    shape = (batch, 1) if kind == "decode" else (batch, seq)
    names = ("tokens", "labels") if kind == "train" else ("tokens",)
    out = {name: np.random.default_rng([seed, i]).integers(
               0, cfg.vocab_size, shape, dtype=np.int32)
           for i, name in enumerate(names)}
    if cfg.family == "vlm" and kind != "decode":
        out["positions"] = np.broadcast_to(
            np.arange(seq, dtype=np.int32), (3, batch, seq)).copy()
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}
