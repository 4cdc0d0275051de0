"""The plain PyTorch versions under the reference oracles' names.

The reference keeps its pure-jnp oracles in ``repro/kernels/ref.py``;
this module gives the port's plain versions the same names, so code
written against ``ref.taylor_sin`` or ``ref.attention`` reads the same in
both packages. Each name binds the plain version its kernel module
already holds: nothing here computes on its own, save the whole-image
Gaussian (the halo blur with both context blocks missing) and ``matmul``.
``attention`` takes no ``scale``: it is always D^-1/2, the hand
kernel's, and no caller in either package passes another.

``matmul`` is the library GEMM (``torch.matmul``), as the reference's
oracle is XLA's (``jnp.matmul``) and as the hand wrapper's CPU path runs
it; :func:`~repro_torch.kernels.matmul.matmul_plain` is the hand
kernel's k-ordered check, one launch per k on a card, and serves no
oracle.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention_plain
from .gaussian import GAUSS_TAPS, gaussian_blur_halo_plain
from .linear_attention import chunked_linear_attention, linear_attention_plain
from .mandelbrot import mandelbrot_plain
from .rap import rap_plain
from .raytrace import raytrace_plain
from .taylor import taylor_sin_plain

__all__ = [
    "GAUSS_TAPS", "attention", "chunked_linear_attention", "gaussian_blur",
    "linear_attention", "mandelbrot", "matmul", "rap", "raytrace",
    "taylor_sin",
]

taylor_sin = taylor_sin_plain
mandelbrot = mandelbrot_plain
raytrace = raytrace_plain
rap = rap_plain
attention = flash_attention_plain
linear_attention = linear_attention_plain


def gaussian_blur(img: torch.Tensor, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Separable 5x5 Gaussian blur with zero padding; img (H, W) f32.

    The halo blur's plain version with both 2-row context blocks missing
    (zeros), as the hand wrapper's whole-image entry runs its kernel.
    """
    return gaussian_blur_halo_plain(img, lo_pad=2, hi_pad=2, out=out)


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = A @ B in f32 through the library GEMM; a (M, K), b (K, N)."""
    return torch.matmul(a, b, out=out)
