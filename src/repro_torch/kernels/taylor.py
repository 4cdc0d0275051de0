"""Taylor-series sine (paper benchmark: Taylor).

:func:`taylor_sin` launches the CUDA kernel in ``csrc/taylor.cu`` for a
CUDA tensor and runs :func:`taylor_sin_plain` for a CPU tensor. It
replaces the Pallas kernel ``repro/kernels/taylor.py`` ``taylor_sin``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _lib


def _taylor_body(x: torch.Tensor, terms: int,
                 out: Optional[torch.Tensor]) -> torch.Tensor:
    x2 = x * x
    acc = torch.zeros_like(x)
    term = x
    for k in range(terms):
        acc = acc + term
        denom = torch.tensor((2.0 * k + 2.0) * (2.0 * k + 3.0),
                             dtype=x.dtype, device=x.device)
        term = -term * x2 / denom
    if out is None:
        return acc
    return out.copy_(acc)


def taylor_sin_plain(x: torch.Tensor, *, terms: int = 12,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sin(x) from ``terms`` Taylor terms in plain PyTorch (any device;
    one TorchScript call on the CPU, :func:`_lib.run_plain`).

    term <- -term * x^2 / ((2k+2)(2k+3)), in the kernel's operation order.
    The divisor is a tensor on x's device: CUDA turns division by a Python
    scalar into a multiplication by its reciprocal, which is not the
    kernel's IEEE division.
    """
    return _lib.run_plain(_taylor_body, x, int(terms), out)


def taylor_sin(x: torch.Tensor, *, terms: int = 12,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Elementwise sin(x) via ``terms`` Taylor terms; x any shape, f32.

    Args:
        x: input; a CUDA tensor runs the hand kernel on the current
            stream, a CPU tensor runs :func:`taylor_sin_plain`.
        terms: number of series terms.
        out: optional output of x's shape, written in place.

    Returns:
        The result (``out`` when given).

    Raises:
        ValueError: dtype, device, shape or contiguity the kernel does not
            take.
        RuntimeError: the launch was refused.
    """
    if out is not None and out.shape != x.shape:
        raise ValueError(f"taylor_sin: out shape {tuple(out.shape)} != "
                         f"input shape {tuple(x.shape)}")
    _lib.refuse_dtensor("taylor_sin", x, out)
    if x.device.type == "cpu":
        return taylor_sin_plain(x, terms=terms, out=out)
    if out is None:
        out = torch.empty_like(x)
    _lib.require_cuda_f32("taylor_sin", x, out)
    lib = _lib.library()
    err = lib.taylor_sin_f32(x.data_ptr(), out.data_ptr(), x.numel(),
                             int(terms), _lib.stream_of(x))
    _lib.check(err, "taylor_sin")
    taylor_sin.launches += 1
    return out


taylor_sin.launches = 0
