"""AdamW over the port's parameter trees (dicts and lists of tensors).

State layout mirrors the param tree (m, v per leaf + a scalar step), as
the reference's does. The update is the reference's formula, operation for
operation in f32: bias corrections ``1 - b**step``, then
``p - lr * (mh / (sqrt(vh) + eps) + wd * p)``. This is not
``torch.optim.AdamW``, whose decoupled decay scales ``p`` by
``1 - lr * wd`` first and so gives other bits.

The update works in place: ``m``, ``v`` and the parameters are written
where they lie, so a 596 M-parameter model keeps one copy of its state on
the card. ``update`` returns the same trees it was given, with the
reference's signature; a caller that needs the old values copies them
first.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..tree import leaves, tree_map

Params = Any


class AdamWState(NamedTuple):
    step: torch.Tensor        # int32, 0-d, on the CPU
    m: Params
    v: Params


def _bias_correction(b: float, step: int) -> float:
    """``1 - b**step`` in f32, with the power rounded once from f64 (the
    reference's f32 power is correctly rounded where torch's ``powf`` is
    an ulp off, e.g. 0.9**31)."""
    power = np.float32(np.float64(np.float32(b)) ** step)
    return float(np.float32(1) - power)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params: Params) -> AdamWState:
        zeros = torch.zeros_like
        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          m=tree_map(zeros, params),
                          v=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState, params: Params
               ) -> tuple[Params, AdamWState]:
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        lr = float(torch.as_tensor(lr, dtype=torch.float32))
        b1, b2 = self.b1, self.b2
        bc1 = _bias_correction(b1, int(step))
        bc2 = _bias_correction(b2, int(step))
        scalars = {}

        def scalar(value: float, device: torch.device) -> torch.Tensor:
            # a 0-d tensor on the leaf's device: a tensor divisor divides
            # (a Python float divisor is a multiply by its reciprocal on
            # CUDA), and an f32 value multiplies as the reference's f32 does
            key = (value, device)
            if key not in scalars:
                scalars[key] = torch.tensor(value, dtype=torch.float32,
                                            device=device)
            return scalars[key]

        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state.m), leaves(state.v)):
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * (1 - b2) * g)
            mh = m / scalar(bc1, m.device)
            vh = v / scalar(bc2, v.device)
            upd = mh.div_(vh.sqrt_().add_(self.eps)).add_(
                self.weight_decay * p)
            p.sub_(upd.mul_(scalar(lr, p.device)))
        return params, AdamWState(step=step, m=state.m, v=state.v)
