"""xLSTM-1.3B [arXiv:2405.04517; unverified] — sLSTM + mLSTM blocks (7:1).

48 blocks d_model=2048 4 heads, d_ff=0 (the mLSTM up/down projection plays
the FFN role), vocab=50304. Every 8th block is an sLSTM (strictly
sequential scalar memory); the rest are mLSTM (matrix memory, chunked
linear-attention form). Recurrent state is O(1) per token ⇒ runs long_500k.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,
    tie_embeddings=True,
))
