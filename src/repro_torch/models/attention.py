"""Attention layer: GQA, qk-norm, QKV bias, sliding window, RoPE, and a
ring-buffer KV cache for decode.

Training/prefill (:func:`attention_train`) goes through the flash kernel's
wrapper (``impl="flash"``: the CUDA kernel on CUDA tensors, its plain
version on CPU tensors), the plain version itself (``impl="xla"``), or
:func:`chunked_attention` (``impl="chunked"``: query chunks of 512 against
the whole key sequence, differentiable, never the (T, T) logits at once;
what the dry run traces full configs with). Decode
(:func:`attention_decode`) attends over the cache's ring through
``kernels.decode_attention``: the CUDA kernel on CUDA tensors; elsewhere,
and on a ring whose slots are sharded, its plain version, the reference's
einsums.
:func:`attention_prefill` runs a prompt through the same path as training
and writes its keys and values into the decode cache. Scores are scaled by
``scale``, head_dim^-1/2 unless the model gives another (Zamba2-7B-
Instruct: (head_dim / 2)^-1/2).
"""
from __future__ import annotations

from typing import Optional

import functools

import torch
from torch.distributed.tensor import DTensor, Shard

from ..kernels import (decode_attention, decode_attention_plain,
                       flash_attention, flash_attention_plain)
from .layers import apply_rope, dense, init_dense, init_rmsnorm, rmsnorm
from .sharding import flatten, per_shard, shard, unflatten

Params = dict


def init_attention(generator: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, *,
                   device: torch.device, qk_norm: bool = False,
                   qkv_bias: bool = False,
                   dtype: torch.dtype = torch.float32) -> Params:
    def lin(d_in, d_out, **kw):
        return init_dense(generator, d_in, d_out, device=device, dtype=dtype,
                          **kw)

    p = {
        "wq": lin(d_model, num_heads * head_dim, bias=qkv_bias),
        "wk": lin(d_model, num_kv_heads * head_dim, bias=qkv_bias),
        "wv": lin(d_model, num_kv_heads * head_dim, bias=qkv_bias),
        "wo": lin(num_heads * head_dim, d_model,
                  scale=(num_heads * head_dim) ** -0.5),
    }
    if qk_norm:
        p["q_norm"] = init_rmsnorm(head_dim, device)
        p["k_norm"] = init_rmsnorm(head_dim, device)
    return p


def _project_qkv(p: Params, x: torch.Tensor, num_heads: int,
                 num_kv_heads: int, head_dim: int, positions: torch.Tensor,
                 rope_freqs: Optional[torch.Tensor]):
    """q (B, H, T, D), k and v (B, Hkv, T, D), contiguous."""
    q = unflatten(dense(p["wq"], x), -1, (num_heads, head_dim))
    k = unflatten(dense(p["wk"], x), -1, (num_kv_heads, head_dim))
    v = unflatten(dense(p["wv"], x), -1, (num_kv_heads, head_dim))
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    q = q.transpose(1, 2)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    if rope_freqs is not None:
        q = apply_rope(q, positions[:, None, :], rope_freqs)
        k = apply_rope(k, positions[:, None, :], rope_freqs)
    # heads over model (tensor parallelism), as the reference pins them
    q = shard(q, ("pod", "data"), "model", None, None)
    k = shard(k, ("pod", "data"), "model", None, None)
    v = shard(v, ("pod", "data"), "model", None, None)
    return q.contiguous(), k.contiguous(), v.contiguous()


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      chunk: int = 512,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Attention one chunk of queries at a time, in plain PyTorch (the
    reference's ``chunked_attention``): each chunk's (B, Hq, chunk, T) f32
    logits against the whole of K and V in f32, masked, softmaxed and
    applied, so memory is O(T * chunk). A T that ``chunk`` does not divide
    runs as one chunk. GQA repeats each kv head for its group of q heads
    (kv-major, as ``jnp.repeat``).

    Args:
        q: (B, Hq, T, D).
        k, v: (B, Hkv, T, D), Hkv dividing Hq.
        causal: mask keys after the query.
        window: mask keys ``window`` or more steps back.
        chunk: queries per chunk.
        scale: the scores' scale; D^-1/2 unless given.

    Returns:
        (B, Hq, T, D) in q's dtype. On DTensors each rank attends its own
        rows and heads (:func:`sharding.per_shard`).
    """
    Hq, Hkv = q.shape[1], k.shape[1]
    if Hkv != Hq:
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
    k = shard(k, ("pod", "data"), "model", None, None)
    v = shard(v, ("pod", "data"), "model", None, None)
    return per_shard(functools.partial(_chunked, causal=causal,
                                       window=window, chunk=chunk,
                                       scale=scale), q, k, v)


def _chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool, window: Optional[int], chunk: int,
             scale: Optional[float] = None) -> torch.Tensor:
    """:func:`chunked_attention` on plain tensors, kv heads repeated."""
    T, D = q.shape[2], q.shape[3]
    scale = D ** -0.5 if scale is None else scale
    if T % chunk:
        chunk = T
    kf, vf = k.float(), v.float()
    k_idx = torch.arange(T, device=q.device)
    outs = []
    for start in range(0, T, chunk):
        qf = q[:, :, start:start + chunk].float() * scale
        logits = torch.matmul(qf, kf.transpose(-1, -2))
        q_idx = start + torch.arange(chunk, device=q.device)
        age = q_idx[:, None] - k_idx[None, :]
        mask = None
        if causal:
            mask = age >= 0
        if window is not None:
            mask = age < window if mask is None else mask & (age < window)
        if mask is not None:
            logits = logits.masked_fill(~mask, float("-inf"))
        outs.append(torch.matmul(torch.softmax(logits, dim=-1), vf))
    return torch.cat(outs, dim=2).to(q.dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            impl: str, causal: bool, window: Optional[int],
            scale: Optional[float]) -> torch.Tensor:
    """Attention of projected q, k, v through ``impl``'s path."""
    kw = dict(causal=causal, window=window, scale=scale)
    if impl == "flash":
        return flash_attention(q, k, v, **kw)
    if impl == "xla":
        return flash_attention_plain(q, k, v, **kw)
    if impl == "chunked":
        return chunked_attention(q, k, v, **kw)
    raise ValueError(f"unknown attn_impl {impl!r}; the port has "
                     f"'flash', 'xla' and 'chunked'")


def attention_train(p: Params, x: torch.Tensor, *, num_heads: int,
                    num_kv_heads: int, head_dim: int,
                    rope_freqs: Optional[torch.Tensor],
                    window: Optional[int] = None, causal: bool = True,
                    impl: str = "xla",
                    scale: Optional[float] = None) -> torch.Tensor:
    """Full-sequence attention (training / prefill). x: (B, T, d)."""
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    q, k, v = _project_qkv(p, x, num_heads, num_kv_heads, head_dim,
                           positions, rope_freqs)
    out = _attend(q, k, v, impl=impl, causal=causal, window=window,
                  scale=scale)
    return dense(p["wo"], flatten(out.transpose(1, 2), 2))


def attention_prefill(p: Params, x: torch.Tensor, cache: Params, *,
                      num_heads: int, num_kv_heads: int, head_dim: int,
                      rope_freqs: Optional[torch.Tensor],
                      impl: str = "flash", scale: Optional[float] = None
                      ) -> tuple[torch.Tensor, Params]:
    """A causal prompt x (B, T, d) through :func:`attention_train`'s path,
    its keys and values written into the ring's slots 0 .. T-1 (no window:
    the ring must hold T), whatever the ring held. ``len`` is a 0-dim
    int64 tensor on the cache's device, set to T in place (nothing is read
    back to the host). Returns the output and the cache, the same tensors,
    ready for :func:`attention_decode` at position T."""
    B, T, _ = x.shape
    if cache["k"].shape[2] < T:
        raise ValueError(f"attention_prefill: needs a cache of at least "
                         f"{T} slots, got {cache['k'].shape[2]}")
    positions = torch.arange(T, device=x.device).expand(B, T)
    q, k, v = _project_qkv(p, x, num_heads, num_kv_heads, head_dim,
                           positions, rope_freqs)
    out = _attend(q, k, v, impl=impl, causal=True, window=None, scale=scale)
    cache["k"][:, :, :T] = k
    cache["v"][:, :, :T] = v
    cache["len"].fill_(T)
    return dense(p["wo"], flatten(out.transpose(1, 2), 2)), cache


def init_kv_cache(batch: int, num_kv_heads: int, max_len: int,
                  head_dim: int, *, device: torch.device,
                  dtype: torch.dtype = torch.bfloat16) -> Params:
    """Ring-buffer cache. For SWA models max_len can be the window size;
    ``len`` (a Python int) is the filled length, the next write slot until
    the ring wraps."""
    return {
        "k": torch.zeros(batch, num_kv_heads, max_len, head_dim, dtype=dtype,
                         device=device),
        "v": torch.zeros(batch, num_kv_heads, max_len, head_dim, dtype=dtype,
                         device=device),
        "len": 0,
    }


def _write_slot(cache: torch.Tensor, slot: int | torch.Tensor,
                new: torch.Tensor) -> None:
    """``cache[:, :, slot] = new`` in the cache's dtype. A ``slot`` held on
    the device (a 0-dim tensor) is written by ``index_copy_``: indexing
    with it would read it back to the host. On a DTensor whose slots are
    sharded (ring decode, sequence over model) the write is a select of
    every slot equal to ``slot``: indexing one slot of a sharded dim would
    gather the whole cache onto every rank."""
    new = new.to(cache.dtype)
    if not isinstance(cache, DTensor):
        if isinstance(slot, torch.Tensor):
            cache.index_copy_(2, slot.view(1), new[:, :, None])
        else:
            cache[:, :, slot] = new
        return
    hit = torch.arange(cache.shape[2], device=cache.device) == slot
    cache.copy_(torch.where(hit[:, None], new[:, :, None], cache))


def attention_decode(p: Params, x: torch.Tensor, cache: Params, *,
                     num_heads: int, num_kv_heads: int, head_dim: int,
                     rope_freqs: Optional[torch.Tensor],
                     window: Optional[int] = None,
                     scale: Optional[float] = None
                     ) -> tuple[torch.Tensor, Params]:
    """Single-token decode. x: (B, 1, d). Writes the new key and value
    into the cache's ring in place (saves a copy of the whole cache per
    step) and returns the output and the cache with ``len`` advanced.

    ``len``, the absolute position, is a Python int (the caches of
    :func:`init_kv_cache`), or a 0-dim int64 tensor on the cache's device
    (the published Zamba2 layout's own caches): then the positions, the
    ring slot, the write and the mask are formed on the device, nothing is
    read back to the host (a step that a CUDA graph can replay), and the
    tensor is advanced in place."""
    B = x.shape[0]
    ck, cv = cache["k"], cache["v"]
    max_len = ck.shape[2]
    pos = cache["len"]                       # absolute position
    on_device = isinstance(pos, torch.Tensor)
    positions = pos.expand(B, 1) if on_device else \
        torch.full((B, 1), pos, device=x.device)
    q, k, v = _project_qkv(p, x, num_heads, num_kv_heads, head_dim,
                           positions, rope_freqs)
    slot = pos % max_len                     # ring write (SWA wraps)
    _write_slot(ck, slot, k[:, :, 0])
    _write_slot(cv, slot, v[:, :, 0])

    G = num_heads // num_kv_heads
    qg = unflatten(q[:, :, 0], 1, (num_kv_heads, G))
    kw = dict(scale=head_dim ** -0.5 if scale is None else scale,
              window=window)

    def attend(qg, ck, cv):
        return decode_attention(qg.contiguous(), ck, cv, pos, **kw)

    # each rank attends its own rows and heads through the kernel, unless
    # the ring's slots are sharded (ring decode: then the heads are whole,
    # and DTensor runs the plain version's einsums across the slots)
    ring = isinstance(ck, DTensor) and any(
        isinstance(p, Shard) and p.dim == 2 for p in ck.placements)
    out = decode_attention_plain(qg, ck, cv, pos, **kw) if ring else \
        per_shard(attend, qg, ck, cv)
    out = flatten(out, 1)[:, None].to(x.dtype)
    return dense(p["wo"], out), {"k": ck, "v": cv,
                                 "len": pos.add_(1) if on_device else pos + 1}
