"""Import all assigned architecture configs (registers them)."""
from repro_torch.configs import (  # noqa: F401
    tinyllama_1_1b,
    phi3_mini_3_8b,
    phi3_medium_14b,
    qwen3_0_6b,
    qwen2_vl_72b,
    rwkv6_3b,
    qwen3_moe_30b_a3b,
    granite_moe_3b_a800m,
    zamba2_7b,
    whisper_base,
)

ALL_ARCHS = [
    "tinyllama-1.1b",
    "phi3-mini-3.8b",
    "phi3-medium-14b",
    "qwen3-0.6b",
    "qwen2-vl-72b",
    "rwkv6-3b",
    "qwen3-moe-30b-a3b",
    "granite-moe-3b-a800m",
    "zamba2-7b",
    "whisper-base",
]
