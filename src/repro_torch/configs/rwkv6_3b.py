"""rwkv6-3b — Finch, data-dependent decay [arXiv:2404.05892; hf].

Attention-free: time-mix (WKV6 linear recurrence, head size 64) + channel
mix.  O(1) decode state, so long_500k runs for this arch.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,              # = ssm heads; attention-free
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    head_dim=64,
    rope_type="none",
    ssm=SSMConfig(state_dim=64, n_ssm_heads=40, chunk=128),
    source="arXiv:2404.05892; hf:RWKV/rwkv-6-world-3b",
))
