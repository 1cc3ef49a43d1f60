"""qwen3-moe-30b-a3b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,                # = expert hidden width (all-MoE FFN layers)
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, experts_per_token=8, d_ff_expert=768),
    source="hf:Qwen/Qwen3-30B-A3B",
))
