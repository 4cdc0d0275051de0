"""Mandelbrot escape counts (paper benchmark: Mandelbrot).

:func:`mandelbrot` launches the CUDA kernel in ``csrc/mandelbrot.cu`` for
CUDA tensors and runs :func:`mandelbrot_plain` for CPU tensors. It
replaces the Pallas kernel ``repro/kernels/mandelbrot.py`` ``mandelbrot``
(body ``_mandel_kernel``). Kernel and plain version agree exactly.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _lib


def _check(cre: torch.Tensor, cim: torch.Tensor,
           out: Optional[torch.Tensor]) -> None:
    if cre.shape != cim.shape:
        raise ValueError(f"mandelbrot: cre {tuple(cre.shape)} and cim "
                         f"{tuple(cim.shape)} differ in shape")
    if out is not None and out.shape != cre.shape:
        raise ValueError(f"mandelbrot: out shape {tuple(out.shape)} != "
                         f"{tuple(cre.shape)}")


def _mandelbrot_body(cre: torch.Tensor, cim: torch.Tensor, max_iter: int,
                     out: Optional[torch.Tensor]) -> torch.Tensor:
    zr = torch.zeros_like(cre)
    zi = torch.zeros_like(cim)
    it = torch.zeros_like(cre)
    alive = torch.ones(cre.shape, dtype=torch.bool, device=cre.device)
    for _ in range(max_iter):
        zr2, zi2 = zr * zr, zi * zi
        alive = alive & (zr2 + zi2 <= 4.0)
        zr, zi = (torch.where(alive, zr2 - zi2 + cre, zr),
                  torch.where(alive, 2.0 * zr * zi + cim, zi))
        it = it + alive.to(it.dtype)
    if out is None:
        return it
    return out.copy_(it)


def mandelbrot_plain(cre: torch.Tensor, cim: torch.Tensor, *,
                     max_iter: int = 64,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Escape iterations in plain PyTorch (any device; one TorchScript
    call on the CPU, :func:`_lib.run_plain`).

    |z|^2 <= 4 is tested before each update and escaped points stay
    frozen, as in the reference.
    """
    _check(cre, cim, out)
    return _lib.run_plain(_mandelbrot_body, cre, cim, int(max_iter), out)


def mandelbrot(cre: torch.Tensor, cim: torch.Tensor, *, max_iter: int = 64,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Escape iterations (f32) for points cre + i*cim; equal shapes.

    Args:
        cre: real parts, float32.
        cim: imaginary parts, float32, same shape.
        max_iter: iteration budget.
        out: optional output of the same shape, written in place.

    Returns:
        The escape counts (``out`` when given).

    Raises:
        ValueError: shape, dtype, device or contiguity the kernel does not
            take.
        RuntimeError: the launch was refused.
    """
    _check(cre, cim, out)
    _lib.refuse_dtensor("mandelbrot", cre, cim, out)
    if cre.device.type == "cpu":
        return mandelbrot_plain(cre, cim, max_iter=max_iter, out=out)
    if out is None:
        out = torch.empty_like(cre)
    _lib.require_cuda_f32("mandelbrot", cre, cim, out)
    lib = _lib.library()
    err = lib.mandelbrot_f32(cre.data_ptr(), cim.data_ptr(), out.data_ptr(),
                             cre.numel(), int(max_iter),
                             _lib.stream_of(cre))
    _lib.check(err, "mandelbrot")
    mandelbrot.launches += 1
    return out


mandelbrot.launches = 0
