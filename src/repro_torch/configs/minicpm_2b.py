"""MiniCPM-2B [arXiv:2404.06395; hf] — dense llama-like, WSD schedule.

40L d_model=2304 36H (MHA: kv=36) d_ff=5760 vocab=122753, tied embeddings,
head_dim 64. Trained with the Warmup-Stable-Decay schedule the paper
introduced (optim/schedule.py implements it; selected via schedule="wsd").
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    head_dim=64,
    tie_embeddings=True,
    rope_theta=10000.0,
    schedule="wsd",
))
