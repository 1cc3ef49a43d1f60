"""Model registry: family -> implementation module (port of
``repro/models/__init__.py``).

Every family module exposes the same functional API:
  init(gen, cfg, device) -> params
  forward(params, batch, cfg, pcfg, mesh=None) -> (hidden (B,S,d), {aux_loss})
  init_cache(cfg, batch, max_seq, pcfg, device=...) -> cache
  prefill(params, batch, cache, cfg, pcfg) -> (cache, last_hidden (B,1,d))
  decode(params, tokens (B,1), cache, cfg, pcfg) -> (cache, logits (B,1,V))
  cache_specs(cfg, pcfg, long_ctx, model_size) -> {cache leaf: spec}
plus transformer.logits_fn for the LM head.  Every family also runs on
a mesh (``mesh=``, a ``common.MeshContext``): its forward (training,
``train/step.py``), prefill, decode, init_cache and logits_fn take it,
with every cache layout of the reference's ``cache_specs``
(`check_mesh`).  Every family of the
reference is ported: the transformer's three (dense, VLM with M-RoPE,
MoE), RWKV6 (ssm), Zamba2 (hybrid: Mamba2 + a shared attention block)
and Whisper (encdec).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv6, transformer, whisper, zamba
from repro_torch.models.common import compute_dtype
from repro_torch.models.transformer import logits_fn  # noqa: F401

_FAMILY = {
    "dense": transformer,
    "vlm": transformer,
    "moe": transformer,
    "ssm": rwkv6,
    "hybrid": zamba,
    "encdec": whisper,
}


def check_mesh(cfg: ModelConfig, mesh) -> bool:
    """True where `mesh` has an axis of size > 1 (a sharded run).  Every
    family runs sharded, in every layout of its ``cache_specs``: the KV
    heads or the sequence over 'model', and the SSM states' heads or
    their k (RWKV-6) or P (Mamba2) dim where the heads do not divide
    'model'."""
    from repro_torch.core.comm import axis_sizes
    if mesh is None:
        return False
    return any(n > 1 for n in axis_sizes(mesh).values())


def get_model(cfg: ModelConfig):
    if cfg.family not in _FAMILY:
        raise ValueError(f"{cfg.name}: unknown model family {cfg.family!r} "
                         f"(want one of {sorted(_FAMILY)})")
    return _FAMILY[cfg.family]


# ----------------------------------------------------------------------------
# concrete batches (tests, smoke runs)
# ----------------------------------------------------------------------------


def make_batch(seed: int, cfg: ModelConfig, batch: int, seq: int,
               kind: str = "train", device="cpu") -> dict[str, torch.Tensor]:
    """Concrete random batch of model inputs.

    kind: train | prefill -> full-length tokens (+labels for train);
          decode           -> one token per sequence.
    The VLM family's full-length batches also carry M-RoPE ``positions``
    (3, B, S) int32: three equal streams 0..S-1, as the reference's; the
    encdec family's carry the frame embeddings ``enc_embed`` (B,
    enc_seq_len, d_model), 0.1 x standard normal in the compute dtype.
    Tokens, labels and enc_embed are drawn with numpy from ``(seed, 0)``,
    ``(seed, 1)`` and ``(seed, 2)``, so they are the same in every process
    (the reference folds ``hash(name)`` into its key, which Python
    randomises per process)."""
    shape = (batch, 1) if kind == "decode" else (batch, seq)
    names = ("tokens", "labels") if kind == "train" else ("tokens",)
    out = {name: torch.from_numpy(np.random.default_rng([seed, i]).integers(
               0, cfg.vocab_size, shape, dtype=np.int32))
           for i, name in enumerate(names)}
    if kind != "decode":
        if cfg.family == "vlm":
            out["positions"] = torch.arange(seq, dtype=torch.int32).expand(
                3, batch, seq).clone()
        if cfg.family == "encdec":
            enc = np.random.default_rng([seed, 2]).standard_normal(
                (batch, cfg.enc_seq_len, cfg.d_model), dtype=np.float32)
            out["enc_embed"] = (0.1 * torch.from_numpy(enc)).to(
                compute_dtype(cfg))
    return {k: v.to(device) for k, v in out.items()}
