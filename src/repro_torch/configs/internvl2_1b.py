"""InternVL2-1B [arXiv:2404.16821; hf] — InternViT + Qwen2-0.5B backbone.

LM backbone: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655,
QKV bias (Qwen2 signature). The InternViT vision frontend is a STUB:
input_specs() provides `vision_tokens`=256 precomputed patch embeddings
(B, 256, d_model) that are prepended to the token embeddings.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    head_dim=64,
    qkv_bias=True,
    vision_tokens=256,
    tie_embeddings=True,
    rope_theta=1000000.0,
))
