"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family; hf] — dense GQA with qk_norm.

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936, head_dim=128
(q/k/v projections are wider than d_model, as in Qwen3), RMSNorm on q/k
heads, tied embeddings.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
))
