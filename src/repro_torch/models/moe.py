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
from .sharding import pinned, replicated, shard

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
        ``sorted_token``, ``sorted_gate`` and ``slot`` of the (token, k)
        pairs in expert order, ``keep`` (False where the pair was dropped
        for capacity), ``capacity`` and the Switch-style ``aux`` loss.
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
    return {"sorted_token": flat_token[order],
            "sorted_gate": gate_vals.reshape(-1)[order],
            "keep": keep,
            "slot": sorted_expert * capacity + torch.where(keep, rank, 0),
            "capacity": capacity, "aux": aux}


def moe_layer(p: Params, x: torch.Tensor, *, num_experts: int, top_k: int,
              capacity_factor: float = 1.25
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out in x's dtype, f32 aux loss)."""
    B, T, d = x.shape
    # tokens, and their gradient, over the batch axes only: a (B * T) dim
    # split over two mesh dims is one DTensor cannot view apart again
    xf = shard(shard(x, ("pod", "data"), None, None).reshape(B * T, d),
               ("pod", "data"), None)
    r = route(p, xf, num_experts=num_experts, top_k=top_k,
              capacity_factor=capacity_factor)
    keep, slot, C = r["keep"], r["slot"], r["capacity"]

    # gather tokens into (E * C, d); a dropped pair adds zero to slot 0.
    # New buffers are built whole (under a mesh: replicated) and the
    # expert axis pinned over model where the reference pins it.
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    gathered = shard(torch.where(keep[:, None], xf[r["sorted_token"]], zero),
                     ("pod", "data"), None)
    # index_add: no sharded strategy (torch 2.11 runs it on the shards)
    buf = torch.zeros(num_experts * C, d, dtype=x.dtype,
                      device=x.device).index_add(0, slot,
                                                 replicated(gathered))
    buf = shard(buf.reshape(num_experts, C, d), "model", None, None)

    h = silu(torch.einsum("ecd,edf->ecf", buf, p["wi_gate"].to(x.dtype)))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["wi_up"].to(x.dtype))
    h = shard(h, "model", None, None)
    out_e = shard(torch.einsum("ecf,efd->ecd", h, p["wo"].to(x.dtype)),
                  "model", None, None)
    out_flat = out_e.reshape(num_experts * C, d)

    # combine: f32 gate-weighted outputs summed in f32 and rounded once
    # to x's dtype, as the reference's compiled scatter-add sums them
    expert_out = shard(out_flat[slot], ("pod", "data"), None)
    contrib = expert_out.float() * (r["sorted_gate"] * keep)[:, None]
    combined = torch.zeros(B * T, d, dtype=contrib.dtype,
                           device=x.device).index_add(
        0, r["sorted_token"], replicated(contrib))   # index_add, as above
    # pinned: the gradient comes back replicated, as ``combined`` is, and
    # not sharded past the first dim, which torch 2.11's DTensor cannot
    # view-flatten
    return pinned(combined.to(x.dtype).reshape(B, T, d)), r["aux"]
