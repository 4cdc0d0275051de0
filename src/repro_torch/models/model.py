"""Model builder: one interface over the assigned architectures.

    model = build_model(cfg)
    params = model.init(generator, device)
    logits, aux = model.forward(params, batch)        # full-sequence logits
    logits = model.prefill_logits(params, batch)      # last-pos logits
    cache = model.init_cache(batch, max_len)
    logits, cache = model.decode_step(params, tokens, cache)

Only the hybrid family (zamba2: Mamba-2 blocks and one shared attention
block) builds in the port so far; the others raise
``NotImplementedError`` naming the ROADMAP item that ports them. The
reference scans its layer stacks (``xscan``); here the stacks are Python
lists of per-layer parameter dicts and a plain loop walks them. Every
entry point runs on the parameters' device: ``cuda:0`` unless the caller
initialises on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..configs.base import ModelConfig
from . import attention as attn
from . import ssm as ssm_mod
from .layers import (embed, init_embedding, init_mlp, init_rmsnorm, mlp,
                     rmsnorm, unembed)

Params = Any


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Params]       # (generator, device, ...) -> params
    forward: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    init_cache: Callable[..., Params]
    decode_step: Callable[..., tuple[torch.Tensor, Params]]

    def prefill_logits(self, params: Params, batch: dict) -> torch.Tensor:
        """Serving prefill: logits at the final position only."""
        logits, _ = self.forward(params, batch)
        return logits[:, -1, :]


def _leaves(tree: Params):
    """The tensors of a tree of dicts and lists."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (dict, list)):
        for sub in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(sub)


def count_params(params: Params) -> int:
    """Number of parameter values in the tree."""
    return sum(t.numel() for t in _leaves(params))


def param_bytes(params: Params) -> int:
    """Bytes the tree's tensors hold."""
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def _pad_vocab(cfg: ModelConfig) -> Optional[int]:
    """The unembedding's vocab padded to a multiple of 2048, as the
    reference pads it (None when it already is one)."""
    V = cfg.vocab_size
    if V % 2048 == 0:
        return None
    return -(-V // 2048) * 2048


def _mask_pad_cols(logits: torch.Tensor, valid: int) -> torch.Tensor:
    if logits.shape[-1] == valid:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(col >= valid, float("-inf"))


# ===========================================================================
# zamba2 (hybrid: mamba2 + shared attention)
# ===========================================================================

def _build_zamba(cfg: ModelConfig) -> Model:
    per = cfg.attn_every                              # 6 mamba per attn
    n_super = cfg.num_layers // per                   # 13 for 81 layers
    n_tail = cfg.num_layers - n_super * per           # 3
    hd = cfg.resolved_head_dim

    def init(generator: torch.Generator,
             device: torch.device | str = "cuda:0", *,
             dense_dtype: torch.dtype = torch.float32) -> Params:
        """Random parameters with the reference's shapes and scales, drawn
        from ``generator`` (on its own device) and stored on ``device``.
        ``dense_dtype`` stores the dense kernels rounded to that type
        (bf16 for serving: the residual stream is bf16, so ``dense`` casts
        them to bf16 anyway)."""
        device = torch.device(device)

        def mamba_block():
            return {"ln": init_rmsnorm(cfg.d_model, device),
                    "mamba": ssm_mod.init_mamba2(
                        generator, cfg.d_model, cfg.ssm_state,
                        cfg.ssm_head_dim, device=device, dtype=dense_dtype)}

        embedding = init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                   device=device)
        superblocks = [[mamba_block() for _ in range(per)]
                       for _ in range(n_super)]
        tail = [mamba_block() for _ in range(n_tail)]
        shared = {
            "ln1": init_rmsnorm(cfg.d_model, device),
            "shared_attn": attn.init_attention(
                generator, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, hd,
                device=device, dtype=dense_dtype),
            "ln2": init_rmsnorm(cfg.d_model, device),
            "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, device=device,
                            dtype=dense_dtype),
        }
        return {"embed": embedding, "superblocks": superblocks,
                "tail_blocks": tail, "shared": shared,
                "final_norm": init_rmsnorm(cfg.d_model, device)}

    def mamba_blocks(x, blocks):
        for p in blocks:
            x = x + ssm_mod.mamba2_train(
                p["mamba"], rmsnorm(p["ln"], x, cfg.norm_eps),
                d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                impl=cfg.mixer_impl)
        return x

    def shared_attn_apply(shared, x):
        h = attn.attention_train(
            shared["shared_attn"], rmsnorm(shared["ln1"], x, cfg.norm_eps),
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=hd, rope_freqs=None, window=cfg.window,
            impl=cfg.attn_impl)
        x = x + h
        return x + mlp(shared["mlp"], rmsnorm(shared["ln2"], x,
                                               cfg.norm_eps))

    def forward(params, batch):
        """tokens (B, T) -> f32 logits (B, T, padded vocab), with the
        padded columns 0, and a zero auxiliary loss."""
        x = embed(params["embed"], batch["tokens"])
        for blocks in params["superblocks"]:
            x = mamba_blocks(x, blocks)
            x = shared_attn_apply(params["shared"], x)
        x = mamba_blocks(x, params["tail_blocks"])
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = unembed(params["embed"], x, pad_to=_pad_vocab(cfg))
        return logits, torch.zeros((), device=logits.device)

    def init_cache(batch: int, max_len: int, *,
                   device: torch.device | str = "cuda:0") -> Params:
        device = torch.device(device)
        eff = min(max_len, cfg.window) if cfg.window else max_len

        def mamba_c():
            return ssm_mod.init_mamba2_cache(
                batch, cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim,
                device=device)

        return {
            "super": [[mamba_c() for _ in range(per)]
                      for _ in range(n_super)],
            "tail": [mamba_c() for _ in range(n_tail)],
            "attn": [attn.init_kv_cache(batch, cfg.num_kv_heads, eff, hd,
                                        device=device)
                     for _ in range(n_super)],
        }

    def decode_step(params, tokens, cache):
        """tokens (B, 1) -> logits (B, padded vocab), the padded columns
        -inf, and the advanced cache."""
        x = embed(params["embed"], tokens)

        def mamba_steps(x, blocks, caches):
            new = []
            for p, c in zip(blocks, caches):
                h, c = ssm_mod.mamba2_decode(
                    p["mamba"], rmsnorm(p["ln"], x, cfg.norm_eps), c,
                    d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim)
                x = x + h
                new.append(c)
            return x, new

        shared = params["shared"]
        supers, attns = [], []
        for blocks, mc, ac in zip(params["superblocks"], cache["super"],
                                  cache["attn"]):
            x, mc = mamba_steps(x, blocks, mc)
            h, ac = attn.attention_decode(
                shared["shared_attn"],
                rmsnorm(shared["ln1"], x, cfg.norm_eps), ac,
                num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=hd, rope_freqs=None, window=cfg.window)
            x = x + h
            x = x + mlp(shared["mlp"], rmsnorm(shared["ln2"], x,
                                                cfg.norm_eps))
            supers.append(mc)
            attns.append(ac)
        x, tail = mamba_steps(x, params["tail_blocks"], cache["tail"])
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = _mask_pad_cols(
            unembed(params["embed"], x, pad_to=_pad_vocab(cfg)),
            cfg.vocab_size)
        return logits[:, 0, :], {"super": supers, "tail": tail,
                                 "attn": attns}

    return Model(cfg=cfg, init=init, forward=forward,
                 init_cache=init_cache, decode_step=decode_step)


# ===========================================================================
# factory
# ===========================================================================

_WAITING = {
    "dense": "the dense/MoE decoder builders (ROADMAP queue 1 item 8)",
    "moe": "the dense/MoE decoder builders (ROADMAP queue 1 item 8)",
    "vlm": "the dense/MoE decoder builders (ROADMAP queue 1 item 8)",
    "ssm": "xLSTM (ROADMAP queue 1 item 8)",
    "encdec": "the encoder-decoder builder (ROADMAP queue 1 item 8)",
}


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "hybrid":
        return _build_zamba(cfg)
    if cfg.family in _WAITING:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; it "
            f"waits for {_WAITING[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r}")
