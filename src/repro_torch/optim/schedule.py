"""LR schedules: cosine and WSD (Warmup-Stable-Decay, MiniCPM).

WSD is the schedule minicpm-2b trains with: linear warmup → long stable
plateau → short (10 %) exponential-ish decay. Exposed as callables
step → lr for AdamW. A step is an int or a 0-d tensor; the value is a 0-d
f32 tensor on the step's device, computed in f32 as the reference computes
it, operation for operation.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup_cosine(peak_lr: float, warmup: int, total: int,
                         floor: float = 0.1):
    def lr(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, peak_lr * cos)
    return lr


def wsd(peak_lr: float, warmup: int, total: int, decay_frac: float = 0.1,
        floor: float = 0.01):
    """MiniCPM's Warmup-Stable-Decay."""
    decay_start = int(total * (1.0 - decay_frac))

    def lr(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - decay_start)
                           / max(total - decay_start, 1), 0.0, 1.0)
        dec = peak_lr * (floor ** frac)     # exponential decay to floor·peak
        stable = torch.full_like(step, peak_lr)
        return torch.where(step < warmup, warm,
                           torch.where(step < decay_start, stable, dec))
    return lr


def make_schedule(name: str, peak_lr: float, warmup: int, total: int):
    if name == "wsd":
        return wsd(peak_lr, warmup, total)
    return linear_warmup_cosine(peak_lr, warmup, total)
