"""Phi-3.5-MoE-42B-A6.6B [hf:microsoft/Phi-3.5-MoE-instruct; hf].

32L d_model=4096 32H (GQA kv=8) vocab=32064; MoE: 16 experts, top-2,
per-expert d_ff=6400.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=0,
    vocab_size=32064,
    head_dim=128,
    num_experts=16,
    top_k=2,
    moe_d_ff=6400,
    rope_theta=10000.0,
))
