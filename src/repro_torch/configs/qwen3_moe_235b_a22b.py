"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B family; hf].

94L d_model=4096 64H (GQA kv=4) vocab=151936; MoE every layer: 128 experts,
top-8, per-expert d_ff=1536, qk_norm as in Qwen3. ~235B total / ~22B active.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    num_experts=128,
    top_k=8,
    moe_d_ff=1536,
    rope_theta=1000000.0,
))
