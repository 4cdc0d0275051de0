"""Gated linear attention / Mamba-2 SSD (the LM stack's chunked scan).

:func:`linear_attention` launches the CUDA kernel in
``csrc/linear_attention.cu`` for CUDA tensors and runs
:func:`linear_attention_plain` for CPU tensors. It replaces the Pallas
kernel ``repro/kernels/linear_attention.py`` ``linear_attention`` (body
``_gla_kernel``); the plain version is the port of the reference's
``ref.linear_attention`` oracle, the exact sequential recurrence

    S_t = exp(ld_t) S_{t-1} + k_t^T v_t,    o_t = q_t S_t,

per head, in f32, with the output in q's dtype. q, k: (BH, T, Dk); v:
(BH, T, Dv); log_decay: (BH, T) f32 with entries <= 0. With
``return_final_state`` both also return S_T, (BH, Dk, Dv) f32, the state a
prefill hands to decode; the kernel writes it from the f32 state it
carried (the Dk <= 128 paths; the wide path refuses it).

The kernel computes the same recurrence in chunks of 64 steps (the
chunk-parallel form), so it sums in another order: in f32 (CUDA cores)
the two agree within rtol = atol = 3e-4, the reference's own tolerance
between its chunked and sequential forms. bf16 inputs run on the tensor
cores: the carried state stays f32, and every f32 operand of a product
(the state, the decayed scores A, the decay-weighted keys K o w) enters
as a bf16 hi + lo pair (about 2^-16 relative); with the output rounded
to bf16 the two agree within rtol = atol = 2e-2 and 1e-2 relative L2 per
row.

Key dims above 128 (xlstm-1.3b's mLSTM: Dk 1024, Dv 1025) take a wide
path of two launches, bound by operations (35.2 GFLOP at xlstm-1.3b's
prefill, 0.036 ms at the tensor cores' bf16 peak, against 0.02 ms of
bytes): a first kernel forms each chunk's decayed scores A
once (into a (BH, chunks, 64, 64) f32 scratch), a second walks the
chunks with the state split over blocks. bf16 runs on the tensor cores:
a block owns 128 key dims x 64 value columns of a head's f32 state in
registers, the ceil(Dk / 128) key-slice blocks of a (head, value tile)
form a thread-block cluster that sums their Q S partials in rank order
through distributed shared memory, and the output rounds as the Dk <= 128
path's does (the same hi + lo pairs, w scaling V instead of K): within
2e-2 and 1e-2 relative L2 per row. Dv = 1025 (the normaliser's ones
column) runs its last column in one warp of 16 columns, and its V rows,
2050 bytes apart, load 2 bytes an element. f32 stays on the CUDA cores,
per (head, 32-column Dv tile) with the (Dk, 32) state in shared memory,
within 3e-4. Both repeat their bits from launch to launch.

:func:`chunked_linear_attention` is the port of the reference's
``ref.chunked_linear_attention``, the differentiable chunk-parallel form
that training and the dry run take (``mixer_impl="chunked"``): plain
PyTorch, no kernel, autograd through it.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import _lib

MAX_KEY_DIM = 128      # the one-pass kernels keep the state in registers
WIDE_KEY_DIM = 1024    # the wide path splits the state over blocks
CHUNK = 64             # steps per chunk of every path


def dv_tile_for(Dk: int, Dv: int) -> int:
    """Dv columns per block of the bf16 kernel: 64, so that a head's
    scores are formed once, unless Dk > 64 (32 keeps the state's registers
    in bounds) or Dv <= 32. A split of Dv = 64 into two 32-column tiles,
    to double the blocks of a small batch, is slower on an H100
    (``chip_smoke.py`` times both).

    Args:
        Dk: key dim.
        Dv: value dim.

    Returns:
        32 or 64.
    """
    return 32 if Dk > 64 or Dv <= 32 else 64


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           log_decay: torch.Tensor) -> None:
    if q.dim() != 3 or q.shape != k.shape:
        raise ValueError(f"linear_attention: q and k must be one "
                         f"(BH, T, Dk) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if v.dim() != 3 or v.shape[:2] != q.shape[:2]:
        raise ValueError(f"linear_attention: v {tuple(v.shape)} must be "
                         f"(BH, T, Dv) for q {tuple(q.shape)}")
    if tuple(log_decay.shape) != tuple(q.shape[:2]):
        raise ValueError(f"linear_attention: log_decay "
                         f"{tuple(log_decay.shape)} must be "
                         f"{tuple(q.shape[:2])}")


def linear_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, log_decay: torch.Tensor, *,
                           return_final_state: bool = False):
    """The exact sequential recurrence in plain PyTorch (any device): one
    step per time index over a (BH, Dk, Dv) f32 state; with
    ``return_final_state`` also that state after the last step."""
    _check(q, k, v, log_decay)
    BH, T, Dk = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    decay = torch.exp(log_decay.float())
    S = torch.zeros(BH, Dk, v.shape[-1], dtype=torch.float32,
                    device=q.device)
    out = torch.empty(BH, T, v.shape[-1], dtype=torch.float32,
                      device=q.device)
    for t in range(T):
        S = decay[:, t, None, None] * S + \
            kf[:, t, :, None] * vf[:, t, None, :]
        out[:, t] = torch.einsum("bk,bkv->bv", qf[:, t], S)
    if return_final_state:
        return out.to(q.dtype), S
    return out.to(q.dtype)


class _PrefixSum(torch.autograd.Function):
    """``torch.cumsum(x, -1)`` whose backward forms the reverse prefix sum
    of the gradient as ``g.sum(-1) - g.cumsum(-1) + g`` (in the gradient's
    dtype), where ``cumsum``'s own backward flips the gradient twice: torch
    2.11's DTensor has no sharding strategy for ``flip``, so a partitioned
    training step through the chunked forms would not trace there."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return torch.cumsum(x, dim=-1)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return g.sum(dim=-1, keepdim=True) - torch.cumsum(g, dim=-1) + g


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """The inclusive prefix sum of ``x`` along its last dim, differentiable
    without ``flip`` (see :class:`_PrefixSum`)."""
    return _PrefixSum.apply(x)


def _chunk_step(S: torch.Tensor, qc: torch.Tensor, kc: torch.Tensor,
                vc: torch.Tensor, ld: torch.Tensor, above: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the chunk-parallel form: its outputs (intra-chunk
    scores plus the carried state's read) and the state after it.

    The decays come from prefix sums of ``ld`` kept in f64, and the
    intra-chunk decay exp(cum_i - cum_j) is formed only for i >= j (the
    rest is exp(-inf) = 0), as the CUDA kernels form it: the reference
    forms it for every (i, j) and masks after the product, so under steep
    decays its masked entries are inf and its gradient is inf * 0.
    """
    cum = prefix_sum(ld.double())                              # (BH, C)
    total = cum[:, -1:]
    diff = (cum[:, :, None] - cum[:, None, :]).float()
    gamma = torch.exp(diff.masked_fill(above, float("-inf")))
    a = torch.matmul(qc, kc.transpose(1, 2)) * gamma           # (BH, C, C)
    intra = torch.matmul(a, vc)
    inter = torch.matmul(qc * torch.exp(cum.float())[..., None], S)
    k_dec = kc * torch.exp((total - cum).float())[..., None]
    S = torch.exp(total.float())[..., None] * S + \
        torch.matmul(k_dec.transpose(1, 2), vc)
    return intra + inter, S


def chunked_linear_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, log_decay: torch.Tensor, *,
                             chunk: int = 128,
                             remat_chunks: bool = True) -> torch.Tensor:
    """The chunk-parallel form of the recurrence in plain PyTorch,
    differentiable: training's path through the SSD and mLSTM mixers.

    T is padded with zeros to a multiple of ``chunk`` and the output
    cropped back. Each chunk computes in f32 and carries a (BH, Dk, Dv)
    f32 state to the next. ``remat_chunks`` recomputes each chunk in the
    backward pass (``torch.utils.checkpoint``) when a gradient is taken,
    so only the carried states are kept: without it the mLSTM's
    1024 x 1025 memories keep T / chunk f32 states a head.

    Args:
        q, k: (BH, T, Dk).
        v: (BH, T, Dv).
        log_decay: (BH, T), entries <= 0.
        chunk: steps per chunk.
        remat_chunks: recompute each chunk in the backward pass.

    Returns:
        (BH, T, Dv) in q's dtype.
    """
    _check(q, k, v, log_decay)
    BH, T, Dk = q.shape
    Dv = v.shape[-1]
    pad = (-T) % chunk
    if pad:
        # zeros concatenated, not F.pad: torch 2.11's DTensor mis-places a
        # padded tensor (the same values)
        q, k, v, log_decay = (torch.cat(
            [a, a.new_zeros(()).expand(BH, pad, *a.shape[2:])], dim=1)
            for a in (q, k, v, log_decay))
    nc = q.shape[1] // chunk

    def chunks(a):
        return a.float().reshape(BH, nc, chunk, a.shape[-1]).unbind(1)

    qs, ks, vs = chunks(q), chunks(k), chunks(v)
    lds = log_decay.float().reshape(BH, nc, chunk).unbind(1)
    above = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=q.device).triu(1)                 # j > i
    remat = remat_chunks and torch.is_grad_enabled() and any(
        a.requires_grad for a in (q, k, v, log_decay))
    S = torch.zeros(BH, Dk, Dv, dtype=torch.float32, device=q.device)
    outs = []
    for c in range(nc):
        args = (S, qs[c], ks[c], vs[c], lds[c], above)
        if remat:
            o, S = checkpoint(_chunk_step, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            o, S = _chunk_step(*args)
        outs.append(o)
    out = torch.cat(outs, dim=1)[:, :T]
    return out.to(q.dtype)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_decay: torch.Tensor, *,
                     return_final_state: bool = False):
    """Chunked gated linear attention.

    Args:
        q, k: (BH, T, Dk) float32 or bfloat16.
        v: (BH, T, Dv) of q's dtype.
        log_decay: (BH, T) float32, entries <= 0.
        return_final_state: also return each head's state after the last
            step.

    Returns:
        (BH, T, Dv) in q's dtype; with ``return_final_state`` the pair of
        it and the (BH, Dk, Dv) f32 final state.

    Raises:
        ValueError: shape, dtype, device or contiguity the kernel does not
            take (on CUDA also Dk > 1024, or ``return_final_state`` with
            Dk > 128); an input that requires grad while grad mode is on,
            on every device (no backward).
        RuntimeError: the launch was refused.
    """
    _check(q, k, v, log_decay)
    _lib.refuse_dtensor("linear_attention", q, k, v, log_decay)
    _lib.refuse_grad("linear_attention",
                     'linear_attention_plain, mixer_impl="ref"', q, k, v,
                     log_decay)
    if q.device.type == "cpu":
        return linear_attention_plain(q, k, v, log_decay,
                                      return_final_state=return_final_state)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"linear_attention: expects float32 or bfloat16, "
                         f"got {q.dtype}")
    BH, T, Dk = q.shape
    if Dk > WIDE_KEY_DIM:
        raise ValueError(f"linear_attention: key dim {Dk} > {WIDE_KEY_DIM}")
    if return_final_state and Dk > MAX_KEY_DIM:
        raise ValueError(f"linear_attention: the final state is returned "
                         f"for key dims up to {MAX_KEY_DIM}, got {Dk}")
    out = torch.empty(BH, T, v.shape[-1], dtype=q.dtype, device=q.device)
    state = None
    if return_final_state:
        state = (torch.zeros if T == 0 else torch.empty)(
            BH, Dk, v.shape[-1], dtype=torch.float32, device=q.device)
    _lib.require_cuda("linear_attention", (q, q.dtype), (k, q.dtype),
                      (v, q.dtype), (log_decay, torch.float32),
                      (out, q.dtype))
    lib = _lib.library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), log_decay.data_ptr())
    args = (*ptrs, out.data_ptr(), None if state is None else state.data_ptr(),
            BH, T, Dk, v.shape[-1])
    if Dk > MAX_KEY_DIM:
        scores = torch.empty(BH, -(-T // CHUNK), CHUNK, CHUNK,
                             dtype=torch.float32, device=q.device)
        err = lib.linear_attention_wide(
            *ptrs, scores.data_ptr(), out.data_ptr(), BH, T, Dk, v.shape[-1],
            int(q.dtype == torch.bfloat16), _lib.stream_of(q))
    elif q.dtype == torch.float32:
        err = lib.linear_attention_f32(*args, _lib.stream_of(q))
    else:
        err = lib.linear_attention_bf16(
            *args, dv_tile_for(Dk, v.shape[-1]), _lib.stream_of(q))
    _lib.check(err, "linear_attention")
    linear_attention.launches += 1
    return (out, state) if return_final_state else out


linear_attention.launches = 0
