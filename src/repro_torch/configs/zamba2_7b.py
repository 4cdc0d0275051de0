"""Zamba2-7B [arXiv:2411.15242; unverified] — Mamba2 + shared attn blocks.

81 Mamba-2 blocks d_model=3584, ssm_state=64, with one *shared* attention
block (32H kv=32, d_ff=14336 MLP) applied every 6 Mamba blocks (weights
reused at every application — the Zamba signature). At 500k decode the
shared attention uses a 4k sliding window; SSM state is O(1) per token ⇒
runs long_500k.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,
    window=4096,
))
