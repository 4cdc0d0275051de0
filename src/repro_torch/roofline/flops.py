"""Analytic FLOPs/bytes accounting per (arch × shape) cell (the port's own
copy of the reference's ``roofline/flops.py``: pure arithmetic on the
config, the same numbers in both packages).

First-principles accounting from the config: matmul FLOPs are exact
(2·m·n·k), attention includes the quadratic term with causal/window
correction, SSD/mLSTM use the chunked-form math, and the train-step factor
reflects the remat policy (fwd+bwd = 3×, +1 fwd when remat is on ⇒ 4×).
The dry run sets these beside the FLOPs ``FlopCounterMode`` counts in a
trace of the step (``launch/dryrun.py``).

Byte accounting (HBM traffic, per device):
  train   : 3 passes over the sharded params/grads/adam state (read
            p/m/v + write p/m/v ≈ 12 B/param f32) + activation traffic
            (ACT_RW rounds of B·T·d bf16 per layer) + logit traffic.
  prefill : 1 pass over sharded params + activation writes.
  decode  : 1 pass over sharded params + 1 pass over the sharded cache
            (the canonical decode bound) per token.
"""
from __future__ import annotations

from ..configs.base import ModelConfig, ShapeConfig

ACT_RW_TRAIN = 24      # activation tensor r/w rounds per layer (fwd+bwd+remat)
ACT_RW_FWD = 8


def _attn_ctx(cfg: ModelConfig, T: int, decode: bool) -> float:
    """Average attended context length per query token."""
    full = T if decode else T / 2.0          # causal average
    if cfg.window is not None:
        full = min(full, cfg.window)
    return full


def _dense_block_flops_token(cfg: ModelConfig) -> float:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qkv = 2.0 * d * hd * (cfg.num_heads + 2 * cfg.num_kv_heads)
    out = 2.0 * cfg.num_heads * hd * d
    if cfg.family == "moe":
        ffn = 6.0 * d * cfg.moe_d_ff * cfg.top_k + 2.0 * d * cfg.num_experts
    else:
        ffn = 6.0 * d * cfg.d_ff
    return qkv + out + ffn


def _attn_flops_token(cfg: ModelConfig, ctx: float) -> float:
    # QKᵀ + PV over the attended context
    return 4.0 * cfg.num_heads * cfg.resolved_head_dim * ctx


def _mamba_block_flops_token(cfg: ModelConfig, chunk: int = 128) -> float:
    d = cfg.d_model
    di = 2 * d
    s = cfg.ssm_state
    hd = cfg.ssm_head_dim
    H = di // hd
    proj = 2.0 * d * (2 * di + 2 * s + H) + 2.0 * di * d
    conv = 2.0 * 4 * (di + 2 * s)
    # chunked SSD per token per head: intra-chunk scores + AV rows over the
    # chunk, inter-chunk read + state update over (s × hd)
    ssd = H * (2.0 * chunk * (s + hd) + 4.0 * s * hd)
    return proj + conv + ssd


def _mlstm_block_flops_token(cfg: ModelConfig, chunk: int = 128) -> float:
    d = cfg.d_model
    di = 2 * d
    H = cfg.num_heads
    hd = di // H
    proj = 2.0 * d * di * 2 + 2.0 * di * d          # up, gate, down
    qkv = 3 * 2.0 * di * di + 2.0 * di * 2 * H
    la = H * (2.0 * chunk * (hd + hd) + 4.0 * hd * hd)
    return proj + qkv + la


def _slstm_block_flops_token(cfg: ModelConfig) -> float:
    d = cfg.d_model
    hd = d // cfg.num_heads
    return 4 * 2.0 * d * d + 4 * 2.0 * d * hd + 2.0 * d * d


def forward_flops_per_token(cfg: ModelConfig, T: int,
                            decode: bool = False) -> float:
    """Layer-stack + head FLOPs for one token of context length T."""
    ctx = _attn_ctx(cfg, T, decode)
    if cfg.family in ("dense", "moe", "vlm"):
        per_block = _dense_block_flops_token(cfg) + \
            _attn_flops_token(cfg, ctx)
        stack = cfg.num_layers * per_block
    elif cfg.family == "encdec":
        dec_block = _dense_block_flops_token(cfg) + \
            _attn_flops_token(cfg, ctx) + \
            2.0 * cfg.d_model * cfg.resolved_head_dim * cfg.num_heads + \
            _attn_flops_token(cfg, cfg.encoder_seq)      # cross-attn
        stack = cfg.num_layers * dec_block
    elif cfg.family == "ssm":
        per_super = cfg.slstm_every
        n_super = cfg.num_layers // per_super
        stack = n_super * ((per_super - 1) * _mlstm_block_flops_token(cfg)
                           + _slstm_block_flops_token(cfg))
    elif cfg.family == "hybrid":
        n_attn = cfg.num_layers // cfg.attn_every
        shared = _dense_block_flops_token(cfg) + _attn_flops_token(cfg, ctx)
        stack = cfg.num_layers * _mamba_block_flops_token(cfg) + \
            n_attn * shared
    else:
        raise ValueError(cfg.family)
    head = 2.0 * cfg.d_model * cfg.vocab_size
    return stack + head


def encoder_flops(cfg: ModelConfig, batch: int) -> float:
    """Whisper encoder forward (non-causal: every query sees all S keys)."""
    if cfg.family != "encdec":
        return 0.0
    S = cfg.encoder_seq
    per_block = _dense_block_flops_token(cfg) + _attn_flops_token(cfg, S)
    return batch * S * cfg.encoder_layers * per_block


def cell_flops(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Whole-step FLOPs (all chips) for one (arch × shape) cell."""
    B, T = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        fwd = B * T * forward_flops_per_token(cfg, T) + \
            encoder_flops(cfg, B)
        factor = 4.0 if cfg.remat else 3.0     # fwd + bwd (+ remat fwd)
        total = factor * fwd
    elif shape.kind == "prefill":
        total = B * T * forward_flops_per_token(cfg, T) + \
            encoder_flops(cfg, B)
    else:  # decode of 1 token against a T-deep context
        total = B * forward_flops_per_token(cfg, T, decode=True)
    return {"total_flops": total}


def cell_bytes(cfg: ModelConfig, shape: ShapeConfig, *,
               param_bytes_per_dev: float, cache_bytes_per_dev: float,
               chips: int, dp_shards: int) -> float:
    """Per-device HBM traffic per step (model; see module docstring)."""
    B, T = shape.global_batch, shape.seq_len
    d = cfg.d_model
    L = cfg.num_layers + cfg.encoder_layers
    if shape.kind == "train":
        B_loc = B / dp_shards
        acts = L * B_loc * T * d * 2 * ACT_RW_TRAIN
        logits = 3 * B_loc * T * cfg.vocab_size * 4 / max(
            chips / dp_shards, 1)
        opt = 12.0 * param_bytes_per_dev / 4.0   # p/m/v r+w (f32 counted 1x)
        return opt + acts + logits
    if shape.kind == "prefill":
        B_loc = B / dp_shards
        acts = L * B_loc * T * d * 2 * ACT_RW_FWD
        return param_bytes_per_dev + acts
    # decode: params + cache, once per token
    return param_bytes_per_dev + cache_bytes_per_dev
