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
loop over the steps, as the reference's ``lax.scan`` (:func:`_scan`, the
four mixes one product a step, in place, with its backward through time
written out; per shard under a mesh). Training and decode share it.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import (chunked_linear_attention, linear_attention,
                       linear_attention_plain)
from .layers import (_normal, dense, init_dense, init_rmsnorm, rmsnorm,
                     sigmoid, silu, softplus)
from .sharding import (SUM, cache_step, flatten, like, map_shards,
                       settled, shard, split_axes, unflatten, whole)

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


def _mlstm_step(C: torch.Tensor, n: torch.Tensor, q: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor, i_g: torch.Tensor,
                f_g: torch.Tensor) -> tuple:
    """C <- f C + i k^T v, n <- f n + i k, and their read-outs q C and
    q . n: the memory (B, H, k, v), the normaliser (B, H, k), the
    numerator (B, H, v) and the denominator (B, H)."""
    C = C * f_g[..., None, None] + \
        (i_g[..., None] * k)[..., :, None] * v[..., None, :]
    n = n * f_g[..., None] + i_g[..., None] * k
    return (C, n, torch.einsum("bhk,bhkv->bhv", q, C),
            torch.einsum("bhk,bhk->bh", q, n))


def mlstm_decode(p: Params, x: torch.Tensor, cache: Params, *,
                 num_heads: int, expand: int = 2
                 ) -> tuple[torch.Tensor, Params]:
    """One-token step. x: (B, 1, d_model). Partitioned, with x's rows
    over the batch axes and its features over model (as the xLSTM's
    decode places the residual stream), it runs where its weights and its
    cache lie: x's features meet the projections' model-split contraction
    dim, each partial product is reduced once or reduce-scattered onto the
    heads that read it (:func:`sharding.like`), and the memory and the
    normaliser advance on their own placements
    (:func:`sharding.cache_step`), so neither a kernel nor a cache leaf
    moves; the output comes back placed as ``x`` is."""
    B, _, d_model = x.shape
    d_inner = expand * d_model
    hd = d_inner // num_heads

    u = like(dense(p["up"], x), x)
    gate = dense(p["up_gate"], x)

    def heads(w):
        return unflatten(dense(w, u)[:, 0], -1,
                         (num_heads, hd))

    q = heads(p["wq"]).float()
    k = (heads(p["wk"]) * hd ** -0.5).float()
    v = heads(p["wv"]).float()
    gif = whole(dense(p["w_if"], u)).float()[:, 0]
    i_g = sigmoid(gif[:, :num_heads])                           # (B,H)
    f_g = sigmoid(gif[:, num_heads:])

    C, n, num, den = cache_step(
        _mlstm_step, cache["C"], "bhkv", cache["C"], cache["n"], q, k, v,
        i_g, f_g, ins=("bhkv", "bhk", "bhk", "bhk", "bhv", "bh", "bh"),
        outs=("bhkv", "bhk", "bhv", "bh"))
    h = settled(num) / torch.clamp(torch.abs(settled(den)),
                                   min=1.0)[..., None]
    h = flatten(h, 1)[:, None].to(x.dtype)
    h = rmsnorm(p["norm"], h) * silu(like(gate, h))
    return like(dense(p["down"], h), x), {"C": C, "n": n}


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


def _mixes(p: Params) -> torch.Tensor:
    """The four recurrent mixes side by side, (H, hd, 4 hd): [z, i, f, o]."""
    return torch.cat([p["r_" + g] for g in "zifo"], dim=-1).float()


def _scan(pre: torch.Tensor, mixes: torch.Tensor, c0: torch.Tensor,
          n0: torch.Tensor, h0: torch.Tensor, history: bool = True) -> tuple:
    """The sLSTM recurrence over the T steps of ``pre`` (T, H, B, 4 hd),
    f32 pre-activations [z, i, f, o], heads-major, from the state c0, n0,
    h0 (H, B, hd):

        a = pre_t + h_{t-1} mixes;  z = tanh(a_z);  i, f, o = sigmoid(...)
        c_t = f c_{t-1} + i z;  n_t = f n_{t-1} + i;  h_t = o c_t / max(n_t, 1)

    Every step writes into buffers made once, in place: on the meta device,
    which the dry run traces on, an op that allocates a result runs
    Python shape code several times as long as one that writes in place,
    and the loop runs 4096 to 32768 steps a block. Without ``history`` (no
    gradient to take) c and n live in two slots that the steps take in
    turn and the gates in one, so the scan holds the h of every step and
    no more.

    Returns:
        h at steps 0..T (T + 1, H, B, hd), the last c and n, and, with
        ``history``, what the backward pass reads (else None): the
        activated gates (T, H, B, 4 hd), c and n at steps 0..T (T + 1, H,
        B, hd) and where n_t < 1 (T, H, B, hd).
    """
    T, hd = pre.shape[0], mixes.shape[1]
    kept = T if history else 1
    acts = pre.new_empty(kept, *pre.shape[1:])
    g = pre.new_empty(pre.shape[1:])
    cs, ns = (pre.new_empty(T + 1 if history else 2, *c0.shape)
              for _ in range(2))
    hs = pre.new_empty(T + 1, *c0.shape)
    low = torch.empty(kept, *c0.shape, dtype=torch.bool, device=pre.device)
    m, iz = torch.empty_like(c0), torch.empty_like(c0)
    cs[0].copy_(c0)
    ns[0].copy_(n0)
    hs[0].copy_(h0)
    for t in range(T):
        s, was, now = (t, t, t + 1) if history else (0, t % 2, (t + 1) % 2)
        torch.baddbmm(pre[t], hs[t], mixes, out=g)
        a = acts[s]
        torch.tanh(g[..., :hd], out=a[..., :hd])
        torch.sigmoid(g[..., hd:], out=a[..., hd:])
        z, i, f, o = a.split(hd, dim=-1)
        c = cs[now].copy_(cs[was]).mul_(f).add_(iz.copy_(i).mul_(z))
        n = ns[now].copy_(ns[was]).mul_(f).add_(i)
        torch.lt(n, 1.0, out=low[s])
        hs[t + 1].copy_(o).mul_(c).div_(m.copy_(n).masked_fill_(low[s], 1.0))
    last = T if history else T % 2
    return hs, cs[last], ns[last], (acts, cs, ns, low) if history else None


def _scan_backward(dh_out: torch.Tensor, dc: torch.Tensor,
                   dn: torch.Tensor, mixes: torch.Tensor, acts: torch.Tensor,
                   cs: torch.Tensor, ns: torch.Tensor, hs: torch.Tensor,
                   low: torch.Tensor) -> tuple:
    """The gradients of :func:`_scan` (back through time, in place as the
    forward runs), given those of every h_t (``dh_out``, (T, H, B, hd))
    and of the last c and n (``dc``, ``dn``, taken over as the carries).

    Returns:
        The gradients of pre, of mixes and of c0, n0, h0.
    """
    T, hd = acts.shape[0], mixes.shape[1]
    dpre, dmix = torch.empty_like(acts), torch.zeros_like(mixes)
    dh = torch.zeros_like(dc)
    m, gh, tmp = (torch.empty_like(dc) for _ in range(3))
    one_minus = torch.empty_like(acts[0, ..., hd:])
    mixes_t = mixes.transpose(1, 2)
    for t in reversed(range(T)):
        a, da = acts[t], dpre[t]
        z, i, f, o = a.split(hd, dim=-1)
        dz, di, df, do = da.split(hd, dim=-1)
        c, n = cs[t + 1], ns[t + 1]
        m.copy_(n).masked_fill_(low[t], 1.0)
        gh.copy_(dh).add_(dh_out[t]).div_(m)        # dh_t / max(n_t, 1)
        do.copy_(gh).mul_(c)
        dc.add_(tmp.copy_(gh).mul_(o))              # dL/dc_t
        # dL/dn_t: h_t = o c_t / max(n_t, 1), whose gradient passes where
        # n_t >= 1 (as clamp's does)
        dn.sub_(tmp.mul_(c).div_(m).masked_fill_(low[t], 0.0))
        dz.copy_(dc).mul_(i)
        di.copy_(dc).mul_(z).add_(dn)
        df.copy_(dc).mul_(cs[t]).add_(tmp.copy_(dn).mul_(ns[t]))
        dc.mul_(f)
        dn.mul_(f)
        # through tanh (1 - z^2) and the sigmoids (s (1 - s))
        dz.mul_(tmp.copy_(z).mul_(z).mul_(-1.0).add_(1.0))
        sig = a[..., hd:]
        da[..., hd:].mul_(sig).mul_(one_minus.copy_(sig).mul_(-1.0)
                                    .add_(1.0))
        dmix.baddbmm_(hs[t].transpose(1, 2), da)
        torch.bmm(da, mixes_t, out=dh)
    return dpre, dmix, dc, dn, dh


def _initial(pre: torch.Tensor, mixes: torch.Tensor, *state) -> tuple:
    """``state`` (c0, n0, h0), each zeros (H, B, hd) where None."""
    zeros = pre.new_zeros(pre.shape[1], pre.shape[2], mixes.shape[1])
    return tuple(zeros if a is None else a for a in state)


class _Recurrence(torch.autograd.Function):
    """:func:`_scan` as a differentiable function of pre, mixes and the
    initial state (zeros where c0, n0, h0 are None): h_1..h_T and the last
    c and n."""

    @staticmethod
    def forward(ctx, pre, mixes, c0, n0, h0):
        hs, c, n, (acts, cs, ns, low) = _scan(
            pre, mixes, *_initial(pre, mixes, c0, n0, h0))
        ctx.save_for_backward(mixes, acts, cs, ns, hs, low)
        return hs[1:], c, n

    @staticmethod
    def backward(ctx, dh_out, dc, dn):
        mixes, acts, cs, ns, hs, low = ctx.saved_tensors
        grads = _scan_backward(
            torch.zeros_like(hs[1:]) if dh_out is None
            else dh_out.contiguous(),
            torch.zeros_like(cs[-1]) if dc is None else dc.clone(),
            torch.zeros_like(ns[-1]) if dn is None else dn.clone(),
            mixes, acts, cs, ns, hs, low)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def _steps(pre: torch.Tensor, mixes: torch.Tensor, *state) -> tuple:
    """h_1..h_T and the last c and n of the recurrence from ``state`` (c0,
    n0, h0; zeros where None): :class:`_Recurrence` where a gradient is to
    be taken, else :func:`_scan` without the history that only the
    backward pass reads (prefill, decode)."""
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad for a in (pre, mixes, *state)):
        return _Recurrence.apply(pre, mixes, *state)
    hs, c, n, _ = _scan(pre, mixes, *_initial(pre, mixes, *state),
                        history=False)
    return hs[1:], c, n


def _recurrence(pre: torch.Tensor, mixes: torch.Tensor,
                state: Optional[Params] = None) -> tuple:
    """:func:`_steps` on pre (T, H, B, 4 hd) from ``state`` (c, n, h: (H,
    B, hd); zeros if None). On DTensors each rank runs it on its own batch
    rows, the rest gathered first, and the mixes' gradient is a partial
    sum over the mesh dims that split the batch, as GSPMD partitions the
    reference's time scan over its batch-sharded carry."""
    init = (None,) * 3 if state is None else (state["c"], state["n"],
                                              state["h"])
    batch = (split_axes(pre, 2),)
    return map_shards(_steps, pre, mixes, *init, groups=batch,
                      ins=((2,), (None,), (1,), (1,), (1,)),
                      outs=((2,), (1,), (1,)),
                      grads=((2,), (SUM,), (1,), (1,), (1,)))


def _slstm_pre(p: Params, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The four f32 pre-activations of x (B, T, d), side by side as
    (T, H, B, 4 hd), [z, i, f, o], heads-major for the step's product:
    over the batch axes only, as the reference pins them before its time
    loop (a model-sharded hd would cost the recurrent mix a collective
    every step)."""
    hd = x.shape[-1] // num_heads
    g = torch.cat([shard(unflatten(dense(p["w_" + g], x), -1,
                                   (num_heads, hd)).float(),
                         ("pod", "data"), None, None, None)
                   for g in "zifo"], dim=-1)                # (B, T, H, 4hd)
    return g.permute(1, 2, 0, 3)


def slstm_train(p: Params, x: torch.Tensor, *,
                num_heads: int) -> torch.Tensor:
    """Full-sequence sLSTM, one step at a time (:func:`_scan`). x: (B, T,
    d_model)."""
    hs, _, _ = _recurrence(_slstm_pre(p, x, num_heads), _mixes(p))
    h = flatten(hs.permute(2, 0, 1, 3), 2).to(x.dtype)         # (B, T, d)
    return dense(p["down"], rmsnorm(p["norm"], h))


def slstm_decode(p: Params, x: torch.Tensor, state: Params, *,
                 num_heads: int) -> tuple[torch.Tensor, Params]:
    """One-token step. x: (B, 1, d_model); the state's c, n, h (B, H,
    hd)."""
    hs, c, n = _recurrence(_slstm_pre(p, x, num_heads), _mixes(p),
                           {k: v.transpose(0, 1) for k, v in state.items()})
    st = {k: v.transpose(0, 1) for k, v in
          (("c", c), ("n", n), ("h", hs[0]))}
    h = flatten(st["h"], 1)[:, None].to(x.dtype)
    return dense(p["down"], rmsnorm(p["norm"], h)), st
