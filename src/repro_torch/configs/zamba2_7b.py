"""zamba2-7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

Hybrid: 81 mamba2 layers; one SHARED (weight-tied) attention+MLP block is
applied every `attn_every` layers (zamba2's shared transformer block).
Sub-quadratic backbone -> long_500k runs; the shared-attn KV cache is
sequence-sharded at 524k ctx (see serve/cache.py).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,            # 3584 / 32
    rope_theta=10_000.0,
    # mamba2: expand=2 -> d_inner 7168; head_dim 64 -> 112 ssm heads
    ssm=SSMConfig(state_dim=64, n_ssm_heads=112, n_groups=2, conv_width=4,
                  chunk=128),
    attn_every=6,            # shared block applied at layers 5, 11, ...
    source="arXiv:2411.15242 (unverified tier)",
))
