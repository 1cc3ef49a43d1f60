"""granite-moe-3b-a800m — 40 experts top-8 [hf:ibm-granite; hf].

The assignment line reads "MoE 40e top-8"; we take the structured field
(40 experts).  40 is not divisible by the 16-way model axis, so the expert
dimension is zero-padded to 48 at dispatch (padded experts get -inf router
logits) — see models/moe.py.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    rope_theta=10_000.0,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=40, experts_per_token=8, d_ff_expert=512),
    source="hf:ibm-granite/granite-3.0-3b-a800m-base",
))
