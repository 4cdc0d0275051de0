"""Qwen1.5-110B [hf:Qwen/Qwen1.5 family; hf] — dense GQA with QKV bias.

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064, attention biases
on q/k/v projections (the Qwen1.5 signature), head_dim 128.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1000000.0,
))
