"""Zamba2-7B-Instruct as published (Zyphra,
https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json;
arXiv:2411.15242): 81 Mamba-2 layers of d_model 3584 (expand 2, 112 SSD
heads of 64, 2 groups of B and C, d_state 64, conv 4 with bias), and 2
shared attention + MLP blocks applied in turn before the Mamba layer at
each of 13 hybrid layers. Each application attends over [residual ;
embedding] (7168 wide, 32 heads of 224, RoPE theta 10000, scale
(224 / 2)^-1/2), runs a gated GELU MLP of 14336 with a rank-128 LoRA on
gate and up (``use_shared_mlp_adapter``; no attention adapters), and a
3584 x 3584 linear into its Mamba layer's input. Vocab 32000, RMSNorm eps
1e-5; the LM head is tied to the embedding (the catalog drops the key:
7.356 B parameters tied, against the model's "7B"). Not in ``ARCH_IDS``:
the reference package has no such model.
"""
from .base import Zamba2Config, register

CONFIG = register(Zamba2Config(
    name="zamba2-7b-instruct",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=224,
    rope_theta=10000.0,
    ssm_state=64,
    ssm_head_dim=64,
    tie_embeddings=True,
    norm_eps=1e-5,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    num_mem_blocks=2,
    adapter_rank=128,
    mamba_ngroups=2,
    attn_impl="flash",
    mixer_impl="pallas",
    remat=False,
))
