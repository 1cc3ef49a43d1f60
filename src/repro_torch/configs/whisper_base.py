"""whisper-base — enc-dec, conv frontend stub [arXiv:2212.04356; unverified].

Audio entry: transformer BACKBONE only.  The conv frontend is a STUB per the
assignment — ``input_specs()`` supplies precomputed frame embeddings
(B, enc_seq_len, d_model); see models/whisper.py.  Positions are sinusoidal
(non-learned) rather than whisper's learned embeddings; noted in DESIGN.md.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,              # decoder layers
    n_enc_layers=6,
    enc_seq_len=1500,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    rope_type="none",        # sinusoidal absolute positions
    source="arXiv:2212.04356 (unverified tier)",
))
