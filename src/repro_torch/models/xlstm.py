"""xLSTM blocks (xlstm-1.3b): mLSTM (matrix memory, 7 of 8 blocks) and
sLSTM (scalar memory with recurrent mixing, 1 of 8).

mLSTM is a gated linear-attention recurrence:
    C_t = f_t C_{t-1} + i_t k_t^T v_t          (matrix memory)
    n_t = f_t n_{t-1} + i_t k_t                (normaliser)
    h_t = (q_t C_t) / max(|q_t n_t|, 1)
Training/prefill (:func:`mlstm_train`) runs it through the
linear-attention kernel's wrapper (``impl="pallas"``: the CUDA kernel on
CUDA tensors, its plain version on CPU tensors), the plain version itself
(``impl="ref"``) or the differentiable chunk-parallel form
(``impl="chunked"``, the training and dry-run path), each with the input
gate folded into k and a column of ones appended to v, so that one pass
gives the numerator and the normaliser: at xlstm-1.3b's widths the
recurrence sees Dk = 1024 and Dv = 1025. Gates use sigmoid, as the reference does. Decode
(:func:`mlstm_decode`) updates the (H, hd, hd) f32 memory, O(1) a token.

sLSTM keeps per-head scalar memories with block-diagonal recurrent mixing
(r_z, r_i, r_f, r_o), so it cannot run in parallel over time: a plain
loop over the steps, as the reference's ``lax.scan``.
"""
from __future__ import annotations

import torch

from ..kernels import (chunked_linear_attention, linear_attention,
                       linear_attention_plain)
from .layers import (_normal, dense, init_dense, init_rmsnorm, rmsnorm,
                     sigmoid, silu, softplus)
from .sharding import einsum, flatten, shard, unflatten

Params = dict


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """-softplus(-x), the reference's ``jax.nn.log_sigmoid``."""
    return -softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(generator: torch.Generator, d_model: int, num_heads: int,
               expand: int = 2, *, device: torch.device,
               dtype: torch.dtype = torch.float32) -> Params:
    d_inner = expand * d_model

    def lin(d_in, d_out, **kw):
        return init_dense(generator, d_in, d_out, device=device, dtype=dtype,
                          **kw)

    return {
        "up_gate": lin(d_model, d_inner),
        "up": lin(d_model, d_inner),
        "wq": lin(d_inner, d_inner),
        "wk": lin(d_inner, d_inner),
        "wv": lin(d_inner, d_inner),
        "w_if": lin(d_inner, 2 * num_heads),
        "norm": init_rmsnorm(d_inner, device),
        "down": lin(d_inner, d_model, scale=d_inner ** -0.5),
    }


def mlstm_train(p: Params, x: torch.Tensor, *, num_heads: int,
                expand: int = 2, impl: str = "ref") -> torch.Tensor:
    """Full-sequence mLSTM. x: (B, T, d_model)."""
    B, T, d_model = x.shape
    d_inner = expand * d_model
    hd = d_inner // num_heads

    u = dense(p["up"], x)
    gate = dense(p["up_gate"], x)
    q = unflatten(dense(p["wq"], u), -1, (num_heads, hd))
    k = unflatten(dense(p["wk"], u), -1, (num_heads, hd)) * hd ** -0.5
    v = unflatten(dense(p["wv"], u), -1, (num_heads, hd))
    gif = dense(p["w_if"], u).float()
    i_gate = sigmoid(gif[..., :num_heads])                      # (B,T,H)
    log_f = _log_sigmoid(gif[..., num_heads:])                  # (B,T,H)

    def hm(a):  # (B,T,H,D) -> (B*H,T,D), contiguous
        # the recurrence runs batch-parallel, as the reference pins it:
        # the merged (B*H) dim cannot carry the heads' model sharding
        a = shard(a, ("pod", "data"), None, None, None)
        return a.transpose(1, 2).reshape(B * num_heads, T, a.shape[-1])

    # fold the input gate into k; a ones-column in v gives the normaliser
    k_g = k * i_gate[..., None].to(k.dtype)
    v_aug = torch.cat([v, v.new_ones(B, T, num_heads, 1)], dim=-1)
    ld = hm(log_f[..., None])[..., 0]
    if impl == "pallas":
        out = linear_attention(hm(q), hm(k_g), hm(v_aug), ld)
    elif impl == "ref":
        out = linear_attention_plain(hm(q), hm(k_g), hm(v_aug), ld)
    elif impl == "chunked":
        out = chunked_linear_attention(hm(q), hm(k_g), hm(v_aug), ld)
    else:
        raise ValueError(f"unknown mixer_impl {impl!r}; the port has "
                         f"'pallas', 'ref' and 'chunked'")
    num, den = out[..., :hd], out[..., hd:]
    h = num / torch.clamp(torch.abs(den), min=1.0)
    h = flatten(unflatten(h, 0, (B, num_heads)).transpose(1, 2), 2)
    h = rmsnorm(p["norm"], h) * silu(gate)
    return dense(p["down"], h)


def init_mlstm_cache(batch: int, d_model: int, num_heads: int,
                     expand: int = 2, *,
                     device: torch.device) -> Params:
    d_inner = expand * d_model
    hd = d_inner // num_heads
    return {"C": torch.zeros(batch, num_heads, hd, hd, device=device),
            "n": torch.zeros(batch, num_heads, hd, device=device)}


def mlstm_decode(p: Params, x: torch.Tensor, cache: Params, *,
                 num_heads: int, expand: int = 2
                 ) -> tuple[torch.Tensor, Params]:
    """One-token step. x: (B, 1, d_model)."""
    B, _, d_model = x.shape
    d_inner = expand * d_model
    hd = d_inner // num_heads

    u = dense(p["up"], x)
    gate = dense(p["up_gate"], x)
    q = unflatten(dense(p["wq"], u)[:, 0], -1, (num_heads, hd)).float()
    k = unflatten((dense(p["wk"], u) * hd ** -0.5)[:, 0], -1,
                  (num_heads, hd)).float()
    v = unflatten(dense(p["wv"], u)[:, 0], -1, (num_heads, hd)).float()
    gif = dense(p["w_if"], u).float()[:, 0]
    i_g = sigmoid(gif[:, :num_heads])                           # (B,H)
    f_g = sigmoid(gif[:, num_heads:])

    C = cache["C"] * f_g[..., None, None] + \
        (i_g[..., None] * k)[..., :, None] * v[..., None, :]
    n = cache["n"] * f_g[..., None] + i_g[..., None] * k
    num = einsum("bhk,bhkv->bhv", q, C, batch=2)
    den = einsum("bhk,bhk->bh", q, n, batch=2)
    h = num / torch.clamp(torch.abs(den), min=1.0)[..., None]
    h = flatten(h, 1)[:, None].to(x.dtype)
    h = rmsnorm(p["norm"], h) * silu(gate)
    return dense(p["down"], h), {"C": C, "n": n}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(generator: torch.Generator, d_model: int, num_heads: int, *,
               device: torch.device,
               dtype: torch.dtype = torch.float32) -> Params:
    hd = d_model // num_heads
    p = {"w_" + g: init_dense(generator, d_model, d_model, device=device,
                              bias=True, dtype=dtype) for g in "zifo"}
    # block-diagonal recurrent mixing: per head (hd, hd), used in f32
    for g in "zifo":
        p["r_" + g] = _normal(generator, (num_heads, hd, hd), hd ** -0.5,
                              device)
    p["norm"] = init_rmsnorm(d_model, device)
    p["down"] = init_dense(generator, d_model, d_model, device=device,
                           scale=d_model ** -0.5, dtype=dtype)
    return p


def init_slstm_state(batch: int, d_model: int, num_heads: int, *,
                     device: torch.device) -> Params:
    hd = d_model // num_heads
    z = torch.zeros(batch, num_heads, hd, device=device)
    return {"c": z, "n": z, "h": z}


def _slstm_step(p: Params, st: Params, zx, ix, fx, ox) -> Params:
    """One timestep. zx/ix/fx/ox: (B, H, hd) f32 pre-activations."""
    h_prev = st["h"]

    def mix(name):
        return torch.einsum("bhk,hkj->bhj", h_prev, p["r_" + name])

    z = torch.tanh(zx + mix("z"))
    i = sigmoid(ix + mix("i"))
    f = sigmoid(fx + mix("f"))
    o = sigmoid(ox + mix("o"))
    c = f * st["c"] + i * z
    n = f * st["n"] + i
    return {"c": c, "n": n, "h": o * c / torch.clamp(n, min=1.0)}


def _slstm_pre(p: Params, x: torch.Tensor, num_heads: int):
    """The four f32 pre-activations of x (B, T, d): (B, T, H, hd) each,
    over the batch axes only, as the reference pins them before its time
    loop (a model-sharded hd would cost the recurrent mix a collective
    every step)."""
    hd = x.shape[-1] // num_heads
    return [shard(unflatten(dense(p["w_" + g], x), -1,
                            (num_heads, hd)).float(),
                  ("pod", "data"), None, None, None)
            for g in "zifo"]


def slstm_train(p: Params, x: torch.Tensor, *,
                num_heads: int) -> torch.Tensor:
    """Full-sequence sLSTM, one step at a time. x: (B, T, d_model)."""
    B, T, d_model = x.shape
    pre = _slstm_pre(p, x, num_heads)
    st = init_slstm_state(B, d_model, num_heads, device=x.device)
    hs = []
    for t in range(T):
        st = _slstm_step(p, st, *(a[:, t] for a in pre))
        hs.append(st["h"])
    h = flatten(torch.stack(hs, dim=1), 2).to(x.dtype)
    return dense(p["down"], rmsnorm(p["norm"], h))


def slstm_decode(p: Params, x: torch.Tensor, state: Params, *,
                 num_heads: int) -> tuple[torch.Tensor, Params]:
    """One-token step. x: (B, 1, d_model)."""
    st = _slstm_step(p, state, *(a[:, 0] for a in
                                 _slstm_pre(p, x, num_heads)))
    h = flatten(st["h"], 1)[:, None].to(x.dtype)
    return dense(p["down"], rmsnorm(p["norm"], h)), st
