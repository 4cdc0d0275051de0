"""Gradient utilities: clipping, accumulation, cross-group compression.

`compress_bf16` + `ErrorFeedback` implement 2x gradient-traffic compression
for a cross-group all-reduce: gradients are cast to bf16 before the
reduction and the quantization residual is fed back into the next step's
gradient (error feedback keeps convergence unbiased in expectation). The
cast rounds to nearest even, as the reference's does, so both packages
give the same bits.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ..tree import leaves, tree_map

Params = Any


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the f32 sums of squares, one per leaf, added in leaf order."""
    sums = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(sum(sums))


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    # a tensor numerator: a Python float over a tensor is a reciprocal
    # times the float in torch, which rounds twice
    limit = torch.tensor(max_norm, dtype=norm.dtype, device=norm.device)
    scale = torch.clamp(limit / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


class ErrorFeedback(NamedTuple):
    residual: Params

    @classmethod
    def init(cls, params: Params) -> "ErrorFeedback":
        return cls(residual=tree_map(torch.zeros_like, params))


def compress_bf16(grads: Params, ef: Optional[ErrorFeedback] = None
                  ) -> tuple[Params, Optional[ErrorFeedback]]:
    """Cast grads to bf16 for the wire; error-feedback the residual."""
    if ef is not None:
        grads = tree_map(lambda g, r: g + r, grads, ef.residual)
    wire = tree_map(lambda g: g.to(torch.bfloat16), grads)
    if ef is not None:
        new_res = tree_map(lambda g, w: g - w.to(g.dtype), grads, wire)
        return wire, ErrorFeedback(residual=new_res)
    return wire, None


def accumulate_grads(loss_fn: Callable, params: Params,
                     microbatches: list[dict]
                     ) -> tuple[torch.Tensor, Params]:
    """Sequential gradient accumulation over microbatches.

    ``loss_fn(params, batch)`` returns ``(loss, aux)``; each microbatch's
    gradient comes from ``torch.autograd.grad`` with respect to detached
    views of the leaves (``params`` itself keeps no graph), and the
    gradients are summed in microbatch order, then divided by their count.
    Partitioned, each gradient comes back on its parameter's placements.
    """
    total_loss = 0.0
    acc = None
    for mb in microbatches:
        loss, grads = value_and_grad(loss_fn, params, mb)
        total_loss = total_loss + loss
        acc = grads if acc is None else tree_map(torch.add, acc, grads)
    n = len(microbatches)
    return total_loss / n, tree_map(_placed_as, tree_map(lambda x: x / n,
                                                         acc), params)


def _placed_as(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """A partitioned gradient on its parameter's placements: its pending
    sums reduced once, here, rather than by every optimizer op that reads
    it; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(grad, DTensor):
        return grad
    return grad.redistribute(param.device_mesh, param.placements)


def value_and_grad(loss_fn: Callable, params: Params, batch: dict
                   ) -> tuple[torch.Tensor, Params]:
    """``loss_fn(params, batch)[0]`` and its gradient tree, as
    ``jax.value_and_grad(loss_fn, has_aux=True)`` gives them (the aux is
    dropped): the leaves are detached views of ``params`` that require
    grad, so ``params`` keeps no graph."""
    with torch.enable_grad():
        views = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = loss_fn(views, batch)
        flat = leaves(views)
        # a leaf the loss does not reach (a VLM's projector on text-only
        # batches) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
    grad_of = {id(v): g for v, g in zip(flat, grads)}
    return loss.detach(), tree_map(lambda v: grad_of[id(v)], views)
