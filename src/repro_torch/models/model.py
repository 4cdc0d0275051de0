"""Model builder: every assigned architecture behind one interface.

    model = build_model(cfg)
    params = model.init(generator, device)
    loss, aux = model.loss(params, batch)             # training forward
    logits, aux = model.forward(params, batch)        # full-sequence logits
    logits = model.prefill_logits(params, batch)      # last-pos logits
    cache = model.init_cache(batch, max_len)
    cache = model.prefill(params, batch, cache)       # enc-dec: the encoder
    logits, cache = model.prefill(params, batch, cache)   # published zamba2
    logits, cache = model.decode_step(params, tokens, cache)

Families: dense (minicpm/qwen3/qwen1.5/h2o), moe (qwen3-moe/phi3.5-moe),
vlm (internvl2), encdec (whisper), ssm (xlstm), hybrid (zamba2; a
:class:`Zamba2Config` builds the published layout, zamba2-7b-instruct,
whose ``prefill`` runs the prompt through the kernels into both caches and
returns the last position's logits). The
reference scans its layer stacks (``xscan``); here the stacks are Python
lists of per-layer parameter dicts and a plain loop walks them;
``cfg.remat`` recomputes the blocks the reference wraps in
``jax.checkpoint`` (``torch.utils.checkpoint``) when gradients are taken.
Every entry point runs on the parameters' device: ``cuda:0`` unless the
caller initialises on the CPU. ``init`` takes ``dense_dtype`` to store the
dense kernels rounded to bf16 for serving (the residual stream is bf16, so
``dense`` casts them to bf16 anyway); norms, biases, routers, the
recurrent sLSTM matrices and an untied ``lm_head`` stay f32.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig, Zamba2Config
from ..kernels import flash_attention_plain
from ..tree import leaves
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .layers import (cross_entropy, dense, embed, gelu_mlp, init_dense,
                     init_embedding, init_gelu_mlp, init_layernorm, init_mlp,
                     init_rmsnorm, layernorm, mlp, rmsnorm, rope_frequencies,
                     sinusoidal_positions, unembed)
from .sharding import arange_like, flatten, per_shard, shard, unflatten

Params = Any


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Params]       # (generator, device, ...) -> params
    forward: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    init_cache: Callable[..., Params]
    decode_step: Callable[..., tuple[torch.Tensor, Params]]
    prefill: Optional[Callable[..., Params]] = None

    def loss(self, params: Params, batch: dict
             ) -> tuple[torch.Tensor, dict]:
        """The training loss: token cross-entropy over the valid vocab
        plus 0.01 times the MoE aux loss, and its parts."""
        logits, aux = self.forward(params, batch)
        ce = cross_entropy(logits, batch["labels"], batch.get("mask"),
                           valid_vocab=self.cfg.vocab_size)
        total = ce + 0.01 * aux
        return total, {"loss": total, "ce": ce, "aux": aux}

    def prefill_logits(self, params: Params, batch: dict) -> torch.Tensor:
        """Serving prefill: logits at the final position only."""
        logits, _ = self.forward(params, batch)
        return logits[:, -1, :]


def count_params(params: Params) -> int:
    """Number of parameter values in the tree."""
    return sum(t.numel() for t in leaves(params))


def param_bytes(params: Params) -> int:
    """Bytes the tree's tensors hold."""
    return sum(t.numel() * t.element_size() for t in leaves(params))


def _maybe_remat(fn: Callable, enable: bool) -> Callable:
    """The reference's ``jax.checkpoint`` of a block: while gradients are
    taken, keep only the block's inputs and recompute its activations in
    the backward pass (the blocks draw no random numbers). A call that
    takes no gradient (serving) runs the block as it is."""
    if not enable:
        return fn

    def run(*args):
        if not (torch.is_grad_enabled() and any(
                isinstance(t, torch.Tensor) and t.requires_grad
                for t in leaves(args))):
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return run


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
    col = arange_like(logits)
    return logits.masked_fill(col >= valid, float("-inf"))


def _kv_len(cfg: ModelConfig, max_len: int) -> int:
    """Ring slots of a KV cache: the window bounds it."""
    return min(max_len, cfg.window) if cfg.window else max_len


# ===========================================================================
# dense / moe / vlm decoder-only LM
# ===========================================================================

def _build_decoder_lm(cfg: ModelConfig) -> Model:
    hd = cfg.resolved_head_dim
    heads = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                 head_dim=hd, window=cfg.window)
    moe = cfg.family == "moe"

    def rope(device):
        return (rope_frequencies(hd, cfg.rope_theta).to(device)
                if cfg.rope_theta else None)

    def init(generator: torch.Generator,
             device: torch.device | str = "cuda:0", *,
             dense_dtype: torch.dtype = torch.float32) -> Params:
        """Random parameters with the reference's shapes and scales."""
        device = torch.device(device)

        def block():
            p = {"ln1": init_rmsnorm(cfg.d_model, device),
                 "attn": attn.init_attention(
                     generator, cfg.d_model, cfg.num_heads,
                     cfg.num_kv_heads, hd, device=device,
                     qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias,
                     dtype=dense_dtype),
                 "ln2": init_rmsnorm(cfg.d_model, device)}
            if moe:
                p["moe"] = moe_mod.init_moe(
                    generator, cfg.d_model, cfg.moe_d_ff, cfg.num_experts,
                    device=device, dtype=dense_dtype)
            else:
                p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff,
                                    device=device, dtype=dense_dtype)
            return p

        p = {"embed": init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                     device=device),
             "layers": [block() for _ in range(cfg.num_layers)],
             "final_norm": init_rmsnorm(cfg.d_model, device)}
        if not cfg.tie_embeddings:
            p["lm_head"] = init_dense(generator, cfg.d_model, cfg.vocab_size,
                                      device=device)
        if cfg.family == "vlm":
            # stub projector for the (frozen, external) InternViT features
            p["vision_proj"] = init_dense(generator, cfg.d_model,
                                          cfg.d_model, device=device,
                                          dtype=dense_dtype)
        return p

    def logits_of(params, x):
        if cfg.tie_embeddings:
            return unembed(params["embed"], x, pad_to=_pad_vocab(cfg))
        return dense(params["lm_head"], x.float())

    def embed_inputs(params, batch):
        x = embed(params["embed"], batch["tokens"])
        if cfg.family == "vlm" and "vision_embeds" in batch:
            ve = dense(params["vision_proj"],
                       batch["vision_embeds"].to(x.dtype))
            x = torch.cat([ve, x[:, ve.shape[1]:, :]], dim=1)
        return shard(x, ("pod", "data"), "model", None)

    def block(p, x, freqs):
        x = x + attn.attention_train(
            p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
            rope_freqs=freqs, impl=cfg.attn_impl, **heads)
        x = shard(x, ("pod", "data"), "model", None)
        hn = rmsnorm(p["ln2"], x, cfg.norm_eps)
        a = None
        if moe:
            h, a = moe_mod.moe_layer(
                p["moe"], hn, num_experts=cfg.num_experts,
                top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
        else:
            h = mlp(p["mlp"], hn)
        return shard(x + h, ("pod", "data"), "model", None), a

    block = _maybe_remat(block, cfg.remat)

    def forward(params, batch):
        """tokens (B, T) (and ``vision_embeds`` (B, Nv, d) for vlm) ->
        f32 logits (B, T, vocab, padded when tied) and the mean MoE aux
        loss over the layers (0 for dense)."""
        x = embed_inputs(params, batch)
        freqs = rope(x.device)
        aux = torch.zeros((), device=x.device)
        for p in params["layers"]:
            x, a = block(p, x, freqs)
            if moe:
                aux = aux + a
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = shard(logits_of(params, x), ("pod", "data"), None, "model")
        return logits, aux / cfg.num_layers

    def init_cache(batch: int, max_len: int, *,
                   device: torch.device | str = "cuda:0") -> Params:
        return [attn.init_kv_cache(batch, cfg.num_kv_heads,
                                   _kv_len(cfg, max_len), hd,
                                   device=torch.device(device))
                for _ in range(cfg.num_layers)]

    def decode_step(params, tokens, cache):
        """tokens (B, 1) -> logits (B, vocab), the padded columns -inf,
        and the advanced cache (MoE at capacity factor 2.0)."""
        x = embed(params["embed"], tokens)
        freqs = rope(x.device)
        new = []
        for p, c in zip(params["layers"], cache):
            h, c = attn.attention_decode(
                p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), c,
                rope_freqs=freqs, **heads)
            x = x + h
            hn = rmsnorm(p["ln2"], x, cfg.norm_eps)
            if moe:
                h, _ = moe_mod.moe_layer(p["moe"], hn,
                                         num_experts=cfg.num_experts,
                                         top_k=cfg.top_k,
                                         capacity_factor=2.0)
            else:
                h = mlp(p["mlp"], hn)
            x = x + h
            new.append(c)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = _mask_pad_cols(logits_of(params, x), cfg.vocab_size)
        return logits[:, 0, :], new

    return Model(cfg=cfg, init=init, forward=forward,
                 init_cache=init_cache, decode_step=decode_step)


# ===========================================================================
# enc-dec (whisper)
# ===========================================================================

def _build_encdec(cfg: ModelConfig) -> Model:
    hd = cfg.resolved_head_dim
    heads = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                 head_dim=hd)

    def init(generator: torch.Generator,
             device: torch.device | str = "cuda:0", *,
             dense_dtype: torch.dtype = torch.float32) -> Params:
        """Random parameters with the reference's shapes and scales."""
        device = torch.device(device)

        def attention():
            return attn.init_attention(generator, cfg.d_model, cfg.num_heads,
                                       cfg.num_kv_heads, hd, device=device,
                                       dtype=dense_dtype)

        def gmlp():
            return init_gelu_mlp(generator, cfg.d_model, cfg.d_ff,
                                 device=device, dtype=dense_dtype)

        def ln():
            return init_layernorm(cfg.d_model, device)

        return {
            "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                    device=device),
            "encoder_layers": [{"ln1": ln(), "attn": attention(),
                                "ln2": ln(), "mlp": gmlp()}
                               for _ in range(cfg.encoder_layers)],
            "enc_norm": ln(),
            "layers": [{"ln1": ln(), "self_attn": attention(), "ln_x": ln(),
                        "cross_attn": attention(), "ln2": ln(),
                        "mlp": gmlp()} for _ in range(cfg.num_layers)],
            "final_norm": ln(),
        }

    def enc_block(p, x):
        x = x + attn.attention_train(
            p["attn"], layernorm(p["ln1"], x), rope_freqs=None,
            causal=False, impl=cfg.attn_impl, **heads)
        x = x + gelu_mlp(p["mlp"], layernorm(p["ln2"], x))
        return shard(x, ("pod", "data"), "model", None)

    enc_block = _maybe_remat(enc_block, cfg.remat)

    def encode(params, frames):
        """frames: (B, S_enc, d) stub embeddings from the conv frontend."""
        S = frames.shape[1]
        x = frames + sinusoidal_positions(S, cfg.d_model, frames.dtype,
                                          device=frames.device)[None]
        x = shard(x, ("pod", "data"), "model", None)
        for p in params["encoder_layers"]:
            x = enc_block(p, x)
        return layernorm(params["enc_norm"], x)

    def encoder_kv(p, enc):
        k = unflatten(dense(p["wk"], enc), -1, (cfg.num_kv_heads, hd))
        v = unflatten(dense(p["wv"], enc), -1, (cfg.num_kv_heads, hd))
        return k.transpose(1, 2), v.transpose(1, 2)

    def cross_attend(p, x, enc_k, enc_v):
        """Cross-attention against encoder K/V through the plain
        attention, as the reference's ``kref.attention``."""
        q = unflatten(dense(p["wq"], x), -1,
                      (cfg.num_heads, hd)).transpose(1, 2)
        out = per_shard(functools.partial(flash_attention_plain,
                                          causal=False), q, enc_k, enc_v)
        return dense(p["wo"], flatten(out.transpose(1, 2), 2))

    def dec_block(p, x, enc):
        x = x + attn.attention_train(
            p["self_attn"], layernorm(p["ln1"], x), rope_freqs=None,
            impl=cfg.attn_impl, **heads)
        ek, ev = encoder_kv(p["cross_attn"], enc)
        x = x + cross_attend(p["cross_attn"], layernorm(p["ln_x"], x),
                             ek, ev)
        x = x + gelu_mlp(p["mlp"], layernorm(p["ln2"], x))
        return shard(x, ("pod", "data"), "model", None)

    dec_block = _maybe_remat(dec_block, cfg.remat)

    def forward(params, batch):
        """tokens (B, T) and frames (B, S_enc, d) -> f32 logits (B, T,
        padded vocab) and a zero aux loss."""
        enc = encode(params, batch["frames"])
        tokens = batch["tokens"]
        x = embed(params["embed"], tokens)
        x = x + sinusoidal_positions(tokens.shape[1], cfg.d_model, x.dtype,
                                     device=x.device)[None]
        for p in params["layers"]:
            x = dec_block(p, x, enc)
        x = layernorm(params["final_norm"], x)
        logits = unembed(params["embed"], x, pad_to=_pad_vocab(cfg))
        logits = shard(logits, ("pod", "data"), None, "model")
        return logits, torch.zeros((), device=logits.device)

    def init_cache(batch: int, max_len: int, *,
                   device: torch.device | str = "cuda:0") -> Params:
        device = torch.device(device)
        shape = (batch, cfg.num_kv_heads, cfg.encoder_seq, hd)
        return {"self": [attn.init_kv_cache(batch, cfg.num_kv_heads,
                                            max_len, hd, device=device)
                         for _ in range(cfg.num_layers)],
                "cross": [{"k": torch.zeros(shape, dtype=torch.bfloat16,
                                            device=device),
                           "v": torch.zeros(shape, dtype=torch.bfloat16,
                                            device=device)}
                          for _ in range(cfg.num_layers)]}

    def prefill(params, batch, cache):
        """Run the encoder once and stash each layer's cross K/V (bf16)."""
        enc = encode(params, batch["frames"])
        cross = []
        for p in params["layers"]:
            k, v = encoder_kv(p["cross_attn"], enc)
            cross.append({"k": k.to(torch.bfloat16).contiguous(),
                          "v": v.to(torch.bfloat16).contiguous()})
        return {"self": cache["self"], "cross": cross}

    def decode_step(params, tokens, cache):
        """tokens (B, 1) -> logits (B, padded vocab), the padded columns
        -inf, and the advanced cache."""
        pos = cache["self"][0]["len"]
        x = embed(params["embed"], tokens)
        x = x + sinusoidal_positions(1, cfg.d_model, x.dtype,
                                     device=x.device, offset=pos)[None]
        new = []
        for p, c, kv in zip(params["layers"], cache["self"],
                            cache["cross"]):
            h, c = attn.attention_decode(
                p["self_attn"], layernorm(p["ln1"], x), c, rope_freqs=None,
                **heads)
            x = x + h
            x = x + cross_attend(p["cross_attn"], layernorm(p["ln_x"], x),
                                 kv["k"], kv["v"])
            x = x + gelu_mlp(p["mlp"], layernorm(p["ln2"], x))
            new.append(c)
        x = layernorm(params["final_norm"], x)
        logits = _mask_pad_cols(
            unembed(params["embed"], x, pad_to=_pad_vocab(cfg)),
            cfg.vocab_size)
        return logits[:, 0, :], {"self": new, "cross": cache["cross"]}

    return Model(cfg=cfg, init=init, forward=forward,
                 init_cache=init_cache, decode_step=decode_step,
                 prefill=prefill)


# ===========================================================================
# xLSTM (ssm family)
# ===========================================================================

def _build_xlstm(cfg: ModelConfig) -> Model:
    per_super = cfg.slstm_every                     # 8: 7 mLSTM + 1 sLSTM
    n_super = cfg.num_layers // per_super
    n_m = per_super - 1
    H = cfg.num_heads

    def init(generator: torch.Generator,
             device: torch.device | str = "cuda:0", *,
             dense_dtype: torch.dtype = torch.float32) -> Params:
        """Random parameters with the reference's shapes and scales."""
        device = torch.device(device)

        def superblock():
            return {
                "mlstm": [{"ln": init_rmsnorm(cfg.d_model, device),
                           "mlstm": xlstm_mod.init_mlstm(
                               generator, cfg.d_model, H, device=device,
                               dtype=dense_dtype)} for _ in range(n_m)],
                "slstm": {"ln": init_rmsnorm(cfg.d_model, device),
                          "slstm": xlstm_mod.init_slstm(
                              generator, cfg.d_model, H, device=device,
                              dtype=dense_dtype)},
            }

        return {"embed": init_embedding(generator, cfg.vocab_size,
                                        cfg.d_model, device=device),
                "superblocks": [superblock() for _ in range(n_super)],
                "final_norm": init_rmsnorm(cfg.d_model, device)}

    def superblock(sb, x):
        for p in sb["mlstm"]:
            x = x + xlstm_mod.mlstm_train(
                p["mlstm"], rmsnorm(p["ln"], x, cfg.norm_eps),
                num_heads=H, impl=cfg.mixer_impl)
        s = sb["slstm"]
        x = x + xlstm_mod.slstm_train(
            s["slstm"], rmsnorm(s["ln"], x, cfg.norm_eps), num_heads=H)
        return shard(x, ("pod", "data"), "model", None)

    # remat at the superblock level, as the reference's: the mLSTM states
    # are recomputed in the backward pass
    superblock = _maybe_remat(superblock, cfg.remat)

    def forward(params, batch):
        """tokens (B, T) -> f32 logits (B, T, padded vocab), zero aux."""
        x = shard(embed(params["embed"], batch["tokens"]),
                  ("pod", "data"), "model", None)
        for sb in params["superblocks"]:
            x = superblock(sb, x)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = unembed(params["embed"], x, pad_to=_pad_vocab(cfg))
        logits = shard(logits, ("pod", "data"), None, "model")
        return logits, torch.zeros((), device=logits.device)

    def init_cache(batch: int, max_len: int, *,
                   device: torch.device | str = "cuda:0") -> Params:
        del max_len   # recurrent state is O(1) in sequence length
        device = torch.device(device)
        return {
            "mlstm": [[xlstm_mod.init_mlstm_cache(batch, cfg.d_model, H,
                                                  device=device)
                       for _ in range(n_m)] for _ in range(n_super)],
            "slstm": [xlstm_mod.init_slstm_state(batch, cfg.d_model, H,
                                                 device=device)
                      for _ in range(n_super)],
            "len": 0,
        }

    def decode_step(params, tokens, cache):
        """tokens (B, 1) -> logits (B, padded vocab), the padded columns
        -inf, and the advanced cache. The residual stream's rows stay over
        the batch axes only and its features over model, where the mLSTM
        steps' kernels split their contraction dim."""
        x = shard(embed(params["embed"], tokens), ("pod", "data"), None,
                  "model")
        ms, ss = [], []
        for sb, mc, sc in zip(params["superblocks"], cache["mlstm"],
                              cache["slstm"]):
            new = []
            for p, c in zip(sb["mlstm"], mc):
                h, c = xlstm_mod.mlstm_decode(
                    p["mlstm"], rmsnorm(p["ln"], x, cfg.norm_eps), c,
                    num_heads=H)
                x = x + h
                new.append(c)
            s = sb["slstm"]
            h, sc = xlstm_mod.slstm_decode(
                s["slstm"], rmsnorm(s["ln"], x, cfg.norm_eps), sc,
                num_heads=H)
            x = shard(x + h, ("pod", "data"), None, "model")
            ms.append(new)
            ss.append(sc)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = _mask_pad_cols(
            unembed(params["embed"], x, pad_to=_pad_vocab(cfg)),
            cfg.vocab_size)
        return logits[:, 0, :], {"mlstm": ms, "slstm": ss,
                                 "len": cache["len"] + 1}

    return Model(cfg=cfg, init=init, forward=forward,
                 init_cache=init_cache, decode_step=decode_step)


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

    def mamba_block(p, x):
        return x + ssm_mod.mamba2_train(
            p["mamba"], rmsnorm(p["ln"], x, cfg.norm_eps),
            d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
            impl=cfg.mixer_impl)

    mamba_block = _maybe_remat(mamba_block, cfg.remat)

    def mamba_blocks(x, blocks):
        for p in blocks:
            x = mamba_block(p, x)
        return x

    def shared_attn_apply(shared, x):
        h = attn.attention_train(
            shared["shared_attn"], rmsnorm(shared["ln1"], x, cfg.norm_eps),
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=hd, rope_freqs=None, window=cfg.window,
            impl=cfg.attn_impl)
        x = x + h
        x = x + mlp(shared["mlp"], rmsnorm(shared["ln2"], x, cfg.norm_eps))
        return shard(x, ("pod", "data"), "model", None)

    def forward(params, batch):
        """tokens (B, T) -> f32 logits (B, T, padded vocab), with the
        padded columns 0, and a zero auxiliary loss."""
        x = shard(embed(params["embed"], batch["tokens"]),
                  ("pod", "data"), "model", None)
        for blocks in params["superblocks"]:
            x = mamba_blocks(x, blocks)
            x = shared_attn_apply(params["shared"], x)
        x = mamba_blocks(x, params["tail_blocks"])
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = unembed(params["embed"], x, pad_to=_pad_vocab(cfg))
        logits = shard(logits, ("pod", "data"), None, "model")
        return logits, torch.zeros((), device=logits.device)

    def init_cache(batch: int, max_len: int, *,
                   device: torch.device | str = "cuda:0") -> Params:
        device = torch.device(device)
        eff = _kv_len(cfg, max_len)

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
        -inf, and the advanced cache. The residual stream's rows stay over
        the batch axes only and its features over model, where the Mamba-2
        steps' kernels split their contraction dim."""
        x = shard(embed(params["embed"], tokens), ("pod", "data"), None,
                  "model")

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
            x = shard(x, ("pod", "data"), None, "model")
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
# zamba2, the published layout (Zamba2-7B-Instruct)
# ===========================================================================

def _build_zamba2(cfg: Zamba2Config) -> Model:
    """Mamba-2 layers; before the Mamba layer at each hybrid layer l_j one
    of the shared blocks (block j % num_mem_blocks) runs over [x ; e], the
    residual beside the token embedding:

        t = RMSNorm([x ; e]);  a = o(attn(RoPE(q t), RoPE(k t), v t))
        [g ; u] = gate_up(RMSNorm(a)) + B_j A_j RMSNorm(a)    (LoRA j)
        x = x + Mamba2(RMSNorm(x + linear_j(down(gelu(g) u))))

    and every other layer is x = x + Mamba2(RMSNorm(x)), its B and C in
    groups, its gate before its norm; then the final RMSNorm and the
    embedding's transpose. Attention scores are scaled by
    (head_dim / 2)^-1/2. The residual stream takes the embedding table's
    dtype (bf16 for serving, f32 in the CPU tests); norms, the SSD's
    scalars, its state and the logits are f32.
    """
    d, hd = cfg.d_model, cfg.resolved_head_dim
    apps = {layer: j for j, layer in enumerate(cfg.hybrid_layer_ids)}
    eps = cfg.norm_eps
    heads = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                 head_dim=hd, scale=(hd / 2) ** -0.5)
    ssd = dict(d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
               ngroups=cfg.mamba_ngroups, gate_before_norm=True, eps=eps)

    def init(generator: torch.Generator,
             device: torch.device | str = "cuda:0", *,
             dense_dtype: torch.dtype = torch.float32) -> Params:
        """Random parameters of the layout, the dense kernels and the
        embedding table in ``dense_dtype`` (the residual stream's)."""
        device = torch.device(device)

        def lin(d_in, d_out):
            return init_dense(generator, d_in, d_out, device=device,
                              dtype=dense_dtype)

        a = 2 * d                                   # [x ; e]
        table = init_embedding(generator, cfg.vocab_size, d, device=device)
        return {
            "embed": {"table": table["table"].to(dense_dtype)},
            "layers": [{"ln": init_rmsnorm(d, device),
                        "mamba": ssm_mod.init_mamba2(
                            generator, d, cfg.ssm_state, cfg.ssm_head_dim,
                            device=device, dtype=dense_dtype,
                            ngroups=cfg.mamba_ngroups)}
                       for _ in range(cfg.num_layers)],
            "blocks": [{"ln_attn": init_rmsnorm(a, device),
                        "attn": {"wq": lin(a, cfg.num_heads * hd),
                                 "wk": lin(a, cfg.num_kv_heads * hd),
                                 "wv": lin(a, cfg.num_kv_heads * hd),
                                 "wo": lin(cfg.num_heads * hd, d)},
                        "ln_mlp": init_rmsnorm(d, device),
                        "gate_up": lin(d, 2 * cfg.d_ff),
                        "down": lin(cfg.d_ff, d)}
                       for _ in range(cfg.num_mem_blocks)],
            "hybrid": [{"adapter_in": lin(d, cfg.adapter_rank),
                        "adapter_out": lin(cfg.adapter_rank, 2 * cfg.d_ff),
                        "linear": lin(d, d)}
                       for _ in cfg.hybrid_layer_ids],
            "final_norm": init_rmsnorm(d, device),
        }

    rope_on = {}

    def rope(device):
        """The RoPE frequencies on ``device``, copied there once: a decode
        step that a CUDA graph replays may not copy from the host."""
        if device not in rope_on:
            rope_on[device] = rope_frequencies(hd, cfg.rope_theta).to(device)
        return rope_on[device]

    def shared_input(params, j, x, e):
        """Block j % num_mem_blocks's attention input, RMSNorm([x ; e])."""
        blk = params["blocks"][j % cfg.num_mem_blocks]
        return blk, rmsnorm(blk["ln_attn"], torch.cat([x, e], dim=-1), eps)

    def shared_out(params, j, blk, a):
        """The MLP with application j's LoRA, then its linear: s."""
        an = rmsnorm(blk["ln_mlp"], a, eps)
        hy = params["hybrid"][j]
        gu = dense(blk["gate_up"], an) + dense(
            hy["adapter_out"], dense(hy["adapter_in"], an))
        g, u = torch.chunk(gu, 2, dim=-1)
        m = dense(blk["down"], torch.nn.functional.gelu(g) * u)
        return dense(hy["linear"], m)

    def logits_of(params, x):
        return unembed(params["embed"], rmsnorm(params["final_norm"], x,
                                                eps))

    def run(params, tokens, cache=None):
        """The prompt's hidden states (before the final norm) through the
        kernels' wrappers; with ``cache`` also fills it."""
        table = params["embed"]
        e = embed(table, tokens, dtype=table["table"].dtype)
        freqs = rope(e.device)
        x = e
        for layer, p in enumerate(params["layers"]):
            h = x
            j = apps.get(layer)
            if j is not None:
                blk, t = shared_input(params, j, x, e)
                if cache is None:
                    a = attn.attention_train(
                        blk["attn"], t, rope_freqs=freqs, impl=cfg.attn_impl,
                        **heads)
                else:
                    a, cache["attn"][j] = attn.attention_prefill(
                        blk["attn"], t, cache["attn"][j], rope_freqs=freqs,
                        impl=cfg.attn_impl, **heads)
                h = x + shared_out(params, j, blk, a)
            hn = rmsnorm(p["ln"], h, eps)
            if cache is None:
                x = x + ssm_mod.mamba2_train(p["mamba"], hn,
                                             impl=cfg.mixer_impl, **ssd)
            else:
                m, cache["mamba"][layer] = ssm_mod.mamba2_train(
                    p["mamba"], hn, impl=cfg.mixer_impl, return_cache=True,
                    **ssd)
                x = x + m
        return x

    def forward(params, batch):
        """tokens (B, T) -> f32 logits (B, T, vocab) and a zero aux."""
        logits = logits_of(params, run(params, batch["tokens"]))
        return logits, torch.zeros((), device=logits.device)

    def init_cache(batch: int, max_len: int, *,
                   device: torch.device | str = "cuda:0",
                   dtype: torch.dtype = torch.bfloat16) -> Params:
        """Empty caches: each hybrid application's K and V ring of
        ``max_len`` slots in ``dtype`` (the residual stream's) with its
        position ``len`` a 0-dim int64 tensor on ``device``, each Mamba
        layer's f32 SSD state and conv buffer."""
        device = torch.device(device)
        return {
            "mamba": [ssm_mod.init_mamba2_cache(
                batch, d, cfg.ssm_state, cfg.ssm_head_dim, device=device,
                ngroups=cfg.mamba_ngroups)
                for _ in range(cfg.num_layers)],
            "attn": [dict(attn.init_kv_cache(batch, cfg.num_kv_heads,
                                             max_len, hd, device=device,
                                             dtype=dtype),
                          len=torch.zeros((), dtype=torch.int64,
                                          device=device))
                     for _ in cfg.hybrid_layer_ids],
        }

    def prefill(params, batch, cache):
        """The prompt (``batch["tokens"]``, B x P) through the kernels'
        wrappers into a cache of :func:`init_cache`'s, whatever it held:
        every application's K and V in slots 0 .. P-1 of its ring and its
        position set to P, in place; every Mamba layer's conv buffer and
        final SSD state, new tensors. Returns the f32 logits at the last
        prompt position (B, vocab) and the filled cache."""
        cache = {"mamba": list(cache["mamba"]), "attn": list(cache["attn"])}
        x = run(params, batch["tokens"], cache)
        return logits_of(params, x[:, -1:])[:, 0], cache

    def decode_step(params, tokens, cache):
        """tokens (B, 1) at the position the caches have reached -> f32
        logits (B, vocab) and the advanced caches: the rings and their
        positions advanced in place, the Mamba leaves new tensors. With
        each ring's ``len`` a 0-dim tensor on the device, as
        :func:`init_cache` gives it (:func:`attn.attention_decode`), the
        step reads nothing back to the host and copies nothing from it, so
        a CUDA graph can replay it."""
        table = params["embed"]
        e = embed(table, tokens, dtype=table["table"].dtype)
        freqs = rope(e.device)
        x = e
        mc, ac = list(cache["mamba"]), list(cache["attn"])
        for layer, p in enumerate(params["layers"]):
            h = x
            j = apps.get(layer)
            if j is not None:
                blk, t = shared_input(params, j, x, e)
                a, ac[j] = attn.attention_decode(
                    blk["attn"], t, ac[j], rope_freqs=freqs, **heads)
                h = x + shared_out(params, j, blk, a)
            m, mc[layer] = ssm_mod.mamba2_decode(
                p["mamba"], rmsnorm(p["ln"], h, eps), mc[layer], **ssd)
            x = x + m
        return logits_of(params, x)[:, 0], {"mamba": mc, "attn": ac}

    return Model(cfg=cfg, init=init, forward=forward,
                 init_cache=init_cache, decode_step=decode_step,
                 prefill=prefill)


# ===========================================================================
# factory
# ===========================================================================

def build_model(cfg: ModelConfig) -> Model:
    if isinstance(cfg, Zamba2Config):
        return _build_zamba2(cfg)
    if cfg.family in ("dense", "moe", "vlm"):
        return _build_decoder_lm(cfg)
    if cfg.family == "encdec":
        return _build_encdec(cfg)
    if cfg.family == "ssm":
        return _build_xlstm(cfg)
    if cfg.family == "hybrid":
        return _build_zamba(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")
