"""qwen2-vl-72b — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

VLM entry: transformer BACKBONE only.  The vision frontend is a STUB per the
assignment — ``input_specs()`` supplies precomputed patch embeddings merged
into the token stream plus 3-axis (temporal/height/width) M-RoPE position
ids; see models/vlm.py.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    rope_type="mrope",
    rope_theta=1_000_000.0,
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-72B",
))
