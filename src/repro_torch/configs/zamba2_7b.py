"""zamba2-7b: a Zamba-like stand-in at Zamba2-7B's widths [arXiv:2411.15242]
-- Mamba-2 + one shared attention block, as the reference package has it.

81 Mamba-2 blocks d_model=3584, ssm_state=64, with one *shared* attention
block (32H kv=32, d_ff=14336 MLP) applied every 6 Mamba blocks (weights
reused at every application). At 500k decode the shared attention uses a
4k sliding window; SSM state is O(1) per token => runs long_500k.

Not the published layout (that is ``zamba2-7b-instruct``,
``configs/zamba2_7b_instruct.py``): one shared block where the model has
two, alternating; attention on the 3584-wide residual with head dim 112,
where the model attends over [residual ; embedding], 7168 wide, with head
dim 224; no RoPE, and a 4096 window; no per-application LoRA and no
per-application linear into the Mamba input; Mamba-2 with one group of B
and C and the norm before the gate (rmsnorm(y) * silu(z)).
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
