"""Mamba-2 (SSD) block, the sequence mixer of zamba2-7b.

Scalar-decay state space duality: per head h with state (d_state x d_head),
    decay_t = exp(-softplus(dt_t) * A_h)
    S_t     = decay_t * S_{t-1} + (softplus(dt_t) * B_t)^T x_t
    y_t     = C_t . S_t + D_h * x_t
Training/prefill (:func:`mamba2_train`) runs the recurrence through the
linear-attention kernel's wrapper (``impl="pallas"``: the CUDA kernel on
CUDA tensors, its plain version on CPU tensors), the plain version itself
(``impl="ref"``), or the differentiable chunk-parallel form
(``impl="chunked"``, the training and dry-run path). Decode
(:func:`mamba2_decode`) updates the (H, d_state, d_head) f32 state, O(1)
per token. The depthwise causal conv (width 4)
before the SSD follows Mamba-2. ``ngroups`` groups of B and C (1 by
default: B and C shared by all the heads; Zamba2-7B-Instruct has 2, head
h reading group h // (H / ngroups)). The output norm is the port's
zamba2-7b's, ``rmsnorm(y) * silu(z)``, unless ``gate_before_norm``: then
the published Mamba-2's, an RMSNorm of y * silu(z) over each group's
d_inner / ngroups channels (:func:`gated_rmsnorm`). With ``return_cache``
:func:`mamba2_train` is a prefill: it also returns the decode cache after
the prompt (the SSD's final f32 state from the kernel, and the conv's
last W - 1 input rows). A_log, dt_bias, D and the norm scale are used in
f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import (chunked_linear_attention, linear_attention,
                       linear_attention_plain)
from .layers import (_normal, dense, init_dense, init_rmsnorm, rmsnorm,
                     silu, softplus)
from .sharding import (cache_step, flatten, like, settled, shard,
                       unflatten, whole)

Params = dict

CONV_WIDTH = 4


def init_mamba2(generator: torch.Generator, d_model: int, d_state: int,
                head_dim: int = 64, expand: int = 2, *,
                device: torch.device, dtype: torch.dtype = torch.float32,
                ngroups: int = 1) -> Params:
    d_inner = expand * d_model
    heads = d_inner // head_dim
    conv_dim = d_inner + 2 * ngroups * d_state
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # fused input projection: [z (gate), x, B, C, dt], B and C
        # ngroups * d_state wide
        "in_proj": init_dense(generator, d_model,
                              2 * d_inner + 2 * ngroups * d_state + heads,
                              device=device, dtype=dtype),
        "conv_w": _normal(generator, (CONV_WIDTH, conv_dim),
                          0.5 / CONV_WIDTH, device),
        "conv_b": torch.zeros(conv_dim, **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, heads, **f32)),
        "D": torch.ones(heads, **f32),
        "dt_bias": torch.log(torch.expm1(torch.full((heads,), 0.01,
                                                    **f32))),
        "norm": init_rmsnorm(d_inner, device),
        "out_proj": init_dense(generator, d_inner, d_model, device=device,
                               scale=d_inner ** -0.5, dtype=dtype),
    }


def _split_proj(proj: torch.Tensor, d_inner: int, d_state: int,
                heads: int):
    """[z, x, B, C, dt] along the last dim."""
    return torch.split(proj, [d_inner, d_inner, d_state, d_state, heads],
                       dim=-1)


def _per_head(m: torch.Tensor, heads: int, ngroups: int) -> torch.Tensor:
    """(..., ngroups * s) -> (..., heads, s): head h reads group
    h // (heads // ngroups); a view of m for one group."""
    lead, s = m.shape[:-1], m.shape[-1] // ngroups
    return m.unflatten(-1, (ngroups, 1, s)).expand(
        *lead, ngroups, heads // ngroups, s).flatten(-3, -2)


def gated_rmsnorm(p: Params, y: torch.Tensor, z: torch.Tensor, groups: int,
                  eps: float) -> torch.Tensor:
    """The published Mamba-2 output norm: y * silu(z) in f32, RMS-normed
    over each of ``groups`` equal groups of its last dim, times the
    scale; in y's dtype. silu in f32 is ``F.silu`` (one kernel, where
    :func:`layers.silu` rounds as the reference package does in bf16)."""
    h = y.float() * F.silu(z.float())
    g = h.reshape(*h.shape[:-1], groups, h.shape[-1] // groups)
    g = g * torch.rsqrt(torch.mean(g * g, dim=-1, keepdim=True) + eps)
    return (g.reshape(h.shape) * p["scale"]).to(y.dtype)


def _conv_tail(xbc: torch.Tensor) -> torch.Tensor:
    """The conv buffer after a prompt: its last W - 1 input rows (zeros
    before the first), f32, (B, W - 1, C)."""
    tail = xbc[:, -(CONV_WIDTH - 1):].float()
    short = CONV_WIDTH - 1 - tail.shape[1]
    if short:
        tail = torch.cat([tail.new_zeros(tail.shape[0], short,
                                         tail.shape[2]), tail], dim=1)
    return tail.contiguous()


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time. x: (B, T, C); w: (W, C)."""
    W = w.shape[0]
    T = x.shape[1]
    # zeros concatenated, not F.pad: torch 2.11's DTensor mis-places a
    # padded tensor (the same values)
    pad = torch.cat([x.new_zeros(()).expand(x.shape[0], W - 1, x.shape[2]),
                     x], dim=1)
    out = pad[:, 0:T, :] * w[0].to(x.dtype)
    for i in range(1, W):
        out = out + pad[:, i:i + T, :] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def mamba2_train(p: Params, x: torch.Tensor, *, d_state: int,
                 head_dim: int = 64, expand: int = 2, impl: str = "ref",
                 ngroups: int = 1, gate_before_norm: bool = False,
                 eps: float = 1e-6, return_cache: bool = False):
    """Full-sequence SSD. x: (B, T, d_model).

    Returns:
        (B, T, d_model); with ``return_cache`` (``impl`` "pallas" or
        "ref") also the decode cache after the last step, as
        :func:`init_mamba2_cache` lays it out.
    """
    Bsz, T, d_model = x.shape
    d_inner = expand * d_model
    heads = d_inner // head_dim
    d_bc = ngroups * d_state

    proj = dense(p["in_proj"], x)
    z, xc, Bmat, Cmat, dt = _split_proj(proj, d_inner, d_bc, heads)
    # conv is applied over [x, B, C] jointly (Mamba-2); dt bypasses it
    xbc = torch.cat([xc, Bmat, Cmat], dim=-1)
    conv_tail = _conv_tail(xbc) if return_cache else None
    xbc = silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs, Bmat, Cmat = torch.split(xbc, [d_inner, d_bc, d_bc], dim=-1)

    dt = softplus(dt.float() + p["dt_bias"])                   # (B,T,H)
    A = torch.exp(p["A_log"])                                    # (H,)
    log_decay = -dt * A                                          # (B,T,H)

    # head-major layout for the kernel: (B*H, T, .)
    xh = unflatten(xs, -1, (heads, head_dim))
    q = _per_head(Cmat, heads, ngroups)
    k = _per_head(Bmat, heads, ngroups) * dt[..., None].to(Bmat.dtype)

    def hm(a):  # (B,T,H,D) -> (B*H,T,D), contiguous
        # batch-parallel SSD, as the reference pins it (see xlstm.py)
        a = shard(a, ("pod", "data"), None, None, None)
        return a.transpose(1, 2).reshape(Bsz * heads, T, a.shape[-1])

    ld = hm(log_decay[..., None])[..., 0]
    if return_cache and impl not in ("pallas", "ref"):
        raise ValueError(f"mamba2_train: return_cache takes mixer_impl "
                         f"'pallas' or 'ref', got {impl!r}")
    if impl == "pallas":
        y = linear_attention(hm(q), hm(k), hm(xh), ld,
                             return_final_state=return_cache)
    elif impl == "ref":
        y = linear_attention_plain(hm(q), hm(k), hm(xh), ld,
                                   return_final_state=return_cache)
    elif impl == "chunked":
        y = chunked_linear_attention(hm(q), hm(k), hm(xh), ld)
    else:
        raise ValueError(f"unknown mixer_impl {impl!r}; the port has "
                         f"'pallas', 'ref' and 'chunked'")
    if return_cache:
        y, state = y
    y = unflatten(y, 0, (Bsz, heads)).transpose(1, 2)           # (B,T,H,D)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
    y = flatten(y, 2)
    if gate_before_norm:
        y = gated_rmsnorm(p["norm"], y, z, ngroups, eps)
    else:
        y = rmsnorm(p["norm"], y) * silu(z)
    out = dense(p["out_proj"], y)
    if not return_cache:
        return out
    return out, {"state": state.view(Bsz, heads, d_state, head_dim),
                 "conv": conv_tail}


def init_mamba2_cache(batch: int, d_model: int, d_state: int,
                      head_dim: int = 64, expand: int = 2, *,
                      device: torch.device,
                      dtype: torch.dtype = torch.float32,
                      ngroups: int = 1) -> Params:
    d_inner = expand * d_model
    heads = d_inner // head_dim
    conv_dim = d_inner + 2 * ngroups * d_state
    return {
        "state": torch.zeros(batch, heads, d_state, head_dim, dtype=dtype,
                             device=device),
        "conv": torch.zeros(batch, CONV_WIDTH - 1, conv_dim, dtype=dtype,
                            device=device),
    }


def _conv_step(conv: torch.Tensor, xbc: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The depthwise conv over the rolling buffer ``conv`` (B, W-1, C) and
    the new column ``xbc`` (B, 1, C), in ``xbc``'s dtype: the conv's output
    (B, C) and the advanced buffer."""
    hist = torch.cat([conv.to(xbc.dtype), xbc], dim=1)
    out = hist[:, 0, :] * w[0].to(xbc.dtype)
    for i in range(1, CONV_WIDTH):
        out = out + hist[:, i, :] * w[i].to(xbc.dtype)
    return out + b.to(xbc.dtype), hist[:, 1:, :].to(conv.dtype)


def _ssm_step(S: torch.Tensor, dt: torch.Tensor, dt_bias: torch.Tensor,
              A_log: torch.Tensor, Bv: torch.Tensor, Cv: torch.Tensor,
              xh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """S <- decay S + (dt B)^T x, with dt = softplus(dt + dt_bias) and
    decay = exp(-dt exp(A_log)), and its read-out C . S: the state (B, H,
    s, d), y (B, H, d). B and C are (B, s), shared by every head, or
    (B, H, s), each head's own (its group's)."""
    dt = softplus(dt.float() + dt_bias)                         # (B,H)
    decay = torch.exp(-dt * torch.exp(A_log))
    S = S * decay[..., None, None]
    if Bv.dim() == 2:
        S = S + (dt[..., None] * Bv[:, None, :])[..., None] * \
            xh[:, :, None, :]
        return S, torch.einsum("bs,bhsd->bhd", Cv, S)
    S = S + (dt[..., None] * Bv)[..., None] * xh[:, :, None, :]
    return S, torch.einsum("bhs,bhsd->bhd", Cv, S)


def mamba2_decode(p: Params, x: torch.Tensor, cache: Params, *,
                  d_state: int, head_dim: int = 64, expand: int = 2,
                  ngroups: int = 1, gate_before_norm: bool = False,
                  eps: float = 1e-6) -> tuple[torch.Tensor, Params]:
    """One-token step. x: (B, 1, d_model). Partitioned, with x's rows
    over the batch axes and its features over model (as zamba2's decode
    places the residual stream), it runs where its weights and its cache
    lie: x's features meet the projections' model-split contraction dim,
    each partial product is reduce-scattered onto the placements of what
    reads it (the conv buffer's channels, the state's heads, the gate's
    features: :func:`sharding.like`), and the conv buffer and the state
    advance on their own placements (:func:`sharding.cache_step`), so
    neither a kernel nor a cache leaf moves; the output comes back placed
    as ``x`` is."""
    Bsz, _, d_model = x.shape
    d_inner = expand * d_model
    heads = d_inner // head_dim

    d_bc = ngroups * d_state
    proj = dense(p["in_proj"], x)
    z, xc, Bmat, Cmat, dt = _split_proj(proj, d_inner, d_bc, heads)
    xbc = torch.cat([xc, Bmat, Cmat], dim=-1)

    # rolling conv buffer, read back in the activations' dtype
    conv, new_conv = cache_step(
        _conv_step, cache["conv"], "bwc", cache["conv"], xbc, p["conv_w"],
        p["conv_b"], ins=("bwc", "b_c", "_c", "c"), outs=("bc", "bwc"))
    xc1 = silu(whole(conv))[:, None, :]

    xs, Bm, Cm = torch.split(xc1, [d_inner, d_bc, d_bc], dim=-1)
    xh = unflatten(xs[:, 0], -1, (heads, head_dim)).float()
    Bm, Cm, bc = Bm[:, 0, :].float(), Cm[:, 0, :].float(), "bs"
    if ngroups > 1:
        Bm, Cm, bc = (_per_head(Bm, heads, ngroups),
                      _per_head(Cm, heads, ngroups), "bhs")
    S, y = cache_step(
        _ssm_step, cache["state"], "bhsd", cache["state"], dt[:, 0, :],
        p["dt_bias"], p["A_log"], Bm, Cm, xh,
        ins=("bhsd", "bh", "h", "h", bc, bc, "bhd"), outs=("bhsd", "bhd"))
    y = settled(y) + p["D"][None, :, None] * xh
    y = flatten(y, 1)[:, None].to(x.dtype)
    if gate_before_norm:
        y = gated_rmsnorm(p["norm"], y, z, ngroups, eps)
    else:
        y = rmsnorm(p["norm"], y) * silu(like(z, y))
    return like(dense(p["out_proj"], y), x), \
        {"state": S, "conv": new_conv}
