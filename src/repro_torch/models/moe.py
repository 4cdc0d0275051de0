"""Mixture-of-Experts layer (qwen3-moe 128e/top-8, phi3.5-moe 16e/top-2).

Sort-based capacity dispatch, as the reference computes it:
  1. top-k routing with renormalised gates (router in f32),
  2. flat (token, k) slots sorted by expert id (a stable sort),
  3. rank within the expert gives the capacity slot; slots at rank >=
     capacity are dropped (their combine weight is zero, so the residual
     passes the token through),
  4. the gathered (E, C, d) activations go through each expert's gated
     SiLU MLP as batched products over the expert axis,
  5. a scatter-add combines the outputs back onto the tokens.

The reference has no Pallas kernel here (XLA computes the products), so
neither has the port: the expert products are ``torch.einsum``.
:func:`route` returns the dispatch so that a caller can see which slots
were dropped.
"""
from __future__ import annotations

import torch

from .layers import _normal, dense, init_dense, silu
from .sharding import (MODEL_AXIS, SUM, folded, map_shards, pinned,
                       replicated, rule_axes, settled, shard, shard_range,
                       split_axes)

Params = dict


def init_moe(generator: torch.Generator, d_model: int, moe_d_ff: int,
             num_experts: int, *, device: torch.device,
             dtype: torch.dtype = torch.float32) -> Params:
    """The router (f32) and the (E, ...) expert kernels, stored in
    ``dtype`` (bf16 for serving: :func:`moe_layer` casts them to the
    activations' dtype anyway)."""
    scale = d_model ** -0.5

    def experts(d_in, d_out, s):
        return _normal(generator, (num_experts, d_in, d_out), s,
                       device).to(dtype)

    return {
        "router": init_dense(generator, d_model, num_experts, device=device,
                             scale=scale),
        "wi_gate": experts(d_model, moe_d_ff, scale),
        "wi_up": experts(d_model, moe_d_ff, scale),
        "wo": experts(moe_d_ff, d_model, moe_d_ff ** -0.5),
    }


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of 0..n-1 occurs in ``idx``: ``torch.bincount`` with
    ``minlength=n`` for indices below n, as a scatter-add of ones, whose
    output shape does not depend on the data (so it also runs on the meta
    device, which the dry run traces on)."""
    idx = replicated(idx)   # scatter_add_: no sharded strategy
    return idx.new_zeros(n).scatter_add_(0, idx, torch.ones_like(idx))


def route(p: Params, xf: torch.Tensor, *, num_experts: int, top_k: int,
          capacity_factor: float) -> dict:
    """The dispatch of (N, d) tokens.

    Returns:
        ``sorted_token`` of the (token, k) pairs in expert order, ``keep``
        (False where the pair was dropped for capacity) and ``slot`` in
        that order; ``pair_slot``, ``pair_keep`` and ``pair_gate``, the
        same per pair in token order (token-major, k a token); ``capacity``
        and the Switch-style ``aux`` loss.
    """
    N = xf.shape[0]
    logits = dense(p["router"], xf.float())                     # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)    # (N, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # load-balancing auxiliary loss (Switch-style)
    density = _counts(expert_idx[:, 0], num_experts).float() / N
    aux = num_experts * torch.sum(density * probs.mean(dim=0))

    capacity = max(1, int(capacity_factor * N * top_k / num_experts))
    flat_expert = expert_idx.reshape(-1)                        # (N*k,)
    flat_token = torch.arange(N, device=xf.device).repeat_interleave(top_k)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    counts = _counts(sorted_expert, num_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(N * top_k, device=xf.device) - starts[sorted_expert]
    keep = rank < capacity
    slot = sorted_expert * capacity + torch.where(keep, rank, 0)
    back = torch.argsort(order)         # each pair's place in expert order
    return {"sorted_token": flat_token[order], "keep": keep, "slot": slot,
            "pair_slot": slot[back], "pair_keep": keep[back],
            "pair_gate": gate_vals.reshape(-1),
            "capacity": capacity, "aux": aux}


def _scatter(x: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor, *,
             top_k: int, lo: int, rows: int) -> torch.Tensor:
    """Rows ``lo:lo + rows`` of the (E * C, d) expert buffer that the
    (token, k) pairs of the tokens ``x`` fill, the pairs in token order:
    each kept pair whose slot falls there adds its token; a pair dropped,
    or bound for other rows, adds zero to row 0 (every slot is one pair's,
    so the sum is exact)."""
    mine = keep & (slot >= lo) & (slot < lo + rows)
    src = torch.where(mine[:, None], x.repeat_interleave(top_k, dim=0),
                      torch.zeros((), dtype=x.dtype, device=x.device))
    return x.new_zeros(rows, x.shape[1]).index_add(
        0, torch.where(mine, slot - lo, 0), src)


def _gather(out: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
            gate: torch.Tensor, *, top_k: int, lo: int) -> torch.Tensor:
    """The f32 gate-weighted sum, per token, of its pairs' rows of the
    expert outputs, where ``out`` holds rows ``lo:lo + len(out)`` of them
    (the pairs in token order; a pair dropped, or whose row is elsewhere,
    adds zero)."""
    mine = keep & (slot >= lo) & (slot < lo + out.shape[0])
    contrib = out[torch.where(mine, slot - lo, 0)].float() * \
        (gate * mine)[:, None]
    token = torch.arange(slot.shape[0], device=out.device) // top_k
    return contrib.new_zeros(slot.shape[0] // top_k, out.shape[1]).index_add(
        0, token, contrib)


def moe_layer(p: Params, x: torch.Tensor, *, num_experts: int, top_k: int,
              capacity_factor: float = 1.25
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out in x's dtype, f32 aux loss).

    Under a mesh no token row moves: each rank scatter-adds the pairs of
    its own tokens into the expert rows it holds (a partial sum over the
    batch axes, then all-reduced), and gathers its tokens' outputs from
    them (a partial sum over the expert axis, all-reduced in f32), as
    GSPMD partitions the reference's scatter-adds."""
    B, T, d = x.shape
    # tokens, and their gradient, over the batch axes only: a (B * T) dim
    # split over two mesh dims is one DTensor cannot view apart again
    xf = shard(shard(x, ("pod", "data"), None, None).reshape(B * T, d),
               ("pod", "data"), None)
    r = route(p, xf, num_experts=num_experts, top_k=top_k,
              capacity_factor=capacity_factor)
    C = r["capacity"]
    E_C = num_experts * C
    pairs = (r["pair_slot"], r["pair_keep"])
    # two groups of mesh dims: those that split the tokens (the batch
    # axes) and those that split the expert rows (model over E, where it
    # divides, as the reference pins them)
    groups = (split_axes(xf, 0), rule_axes((num_experts, d), 0, MODEL_AXIS,
                                           None))
    lo, rows = shard_range(xf, E_C, groups[1])
    # the pairs split as their tokens are: a rank's tokens summed into its
    # expert rows, a partial sum over the token split
    buf = map_shards(
        lambda a, s, k: _scatter(a, s, k, top_k=top_k, lo=lo, rows=rows),
        xf, *pairs, groups=groups, ins=((0, None),) * 3, outs=((SUM, 0),),
        grads=((0, SUM), (0, None), (0, None)))
    buf = shard(buf.reshape(num_experts, C, d), "model", None, None)

    h = silu(torch.einsum("ecd,edf->ecf", buf, p["wi_gate"].to(x.dtype)))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["wi_up"].to(x.dtype))
    h = shard(h, "model", None, None)
    out_e = shard(torch.einsum("ecf,efd->ecd", h, p["wo"].to(x.dtype)),
                  "model", None, None)
    out_flat = out_e.reshape(E_C, d)

    # combine: f32 gate-weighted outputs summed in f32 and rounded once
    # to x's dtype, as the reference's compiled scatter-add sums them; a
    # rank's tokens gathered from its expert rows, a partial sum over the
    # expert split
    combined = map_shards(
        lambda o, s, k, g: _gather(o, s, k, g, top_k=top_k, lo=lo),
        out_flat, *pairs, r["pair_gate"], groups=groups,
        ins=((None, 0), (0, None), (0, None), (0, None)), outs=((0, SUM),),
        grads=((SUM, 0), (0, None), (0, None), (0, SUM)))
    combined = folded(settled(combined), B)
    # pinned: the gradient comes back on the output's placements, and not
    # sharded past the first dim, which torch 2.11's DTensor cannot
    # view-flatten
    return pinned(combined.to(x.dtype).reshape(B, T, d)), r["aux"]
