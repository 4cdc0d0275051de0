"""Whisper-medium [arXiv:2212.04356; unverified] — enc-dec audio backbone.

24 encoder + 24 decoder layers, d_model=1024 16H (MHA kv=16) d_ff=4096
vocab=51865. The conv mel frontend is a STUB: input_specs() provides
precomputed frame embeddings (B, encoder_seq=1500, d_model) per the brief.
GELU MLPs + LayerNorm + sinusoidal positions (no RoPE), cross-attention in
every decoder layer.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    encoder_layers=24,
    encoder_seq=1500,
    rope_theta=0.0,      # sinusoidal absolute positions instead of RoPE
))
