"""H2O-Danube3-4B [arXiv:2401.16818; unverified] — llama+mistral mix, SWA.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, sliding-window
attention (4096) — which bounds the KV cache and qualifies the arch for
the long_500k decode shape (see DESIGN.md §5).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="h2o-danube3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,
    window=4096,
    rope_theta=10000.0,
))
