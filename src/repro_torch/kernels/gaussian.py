"""Separable 5x5 Gaussian blur (paper benchmark: Gaussian).

:func:`gaussian_blur_halo` launches the CUDA kernel in ``csrc/gaussian.cu``
for a CUDA tensor and runs :func:`gaussian_blur_halo_plain` for a CPU
tensor; :func:`gaussian_blur` is the whole-image entry on top of it. They
replace the Pallas entry points ``repro/kernels/gaussian.py``
``gaussian_blur_halo`` and ``gaussian_blur`` (body ``_blur_kernel``).

The halo entry blurs the interior of a row block that carries two rows of
context above and below. ``lo_pad``/``hi_pad`` say how many of those
context rows are missing from ``img`` and count as zeros: a package read
in place at the top or bottom of the image passes only the rows that
exist, so no zero-filled copy is made.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from . import _lib

GAUSS_TAPS = (0.0625, 0.25, 0.375, 0.25, 0.0625)   # [1, 4, 6, 4, 1] / 16


def _out_rows(img: torch.Tensor, lo_pad: int, hi_pad: int) -> int:
    if img.dim() != 2:
        raise ValueError(f"gaussian: expects a 2-D (rows, W) image, got "
                         f"shape {tuple(img.shape)}")
    if lo_pad < 0 or hi_pad < 0:
        raise ValueError("gaussian: pads must be >= 0")
    rows = img.shape[0] + lo_pad + hi_pad - 4
    if rows < 0:
        raise ValueError(f"gaussian: {img.shape[0]} rows plus pads "
                         f"{lo_pad}+{hi_pad} hold no 2+2-row halo")
    return rows


def _taps5(t: List[float], a: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor, d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    s = t[0] * a + t[1] * b + t[2] * c + t[3] * d
    return torch.add(s, t[4] * e)


def _blur_body(img: torch.Tensor, taps: List[float], lo_pad: int,
               hi_pad: int, rows: int,
               out: Optional[torch.Tensor]) -> torch.Tensor:
    W = img.shape[1]
    p = F.pad(img, [0, 0, lo_pad, hi_pad])
    vert = _taps5(taps, p[0:rows], p[1:1 + rows], p[2:2 + rows], p[3:3 + rows],
                  p[4:4 + rows])
    h = F.pad(vert, [2, 2])
    blurred = _taps5(taps, h[:, 0:W], h[:, 1:1 + W], h[:, 2:2 + W],
                     h[:, 3:3 + W], h[:, 4:4 + W])
    if out is None:
        return blurred
    return out.copy_(blurred)


def gaussian_blur_halo_plain(img: torch.Tensor, *, lo_pad: int = 0,
                             hi_pad: int = 0,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The halo blur in plain PyTorch (any device; one TorchScript call on
    the CPU, :func:`_lib.run_plain`), the kernel's order."""
    rows = _out_rows(img, lo_pad, hi_pad)
    return _lib.run_plain(_blur_body, img, list(GAUSS_TAPS), int(lo_pad),
                          int(hi_pad), rows, out)


def gaussian_blur_halo(img: torch.Tensor, *, lo_pad: int = 0,
                       hi_pad: int = 0,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Blur the interior of a 2+2-row-halo'd row block.

    Args:
        img: (R, W) float32 rows; with no pads R = H + 4 and the result is
            the (H, W) interior.
        lo_pad: context rows missing above ``img`` (zeros).
        hi_pad: context rows missing below ``img`` (zeros).
        out: optional (H, W) output, written in place.

    Returns:
        The (H, W) blurred interior, H = R + lo_pad + hi_pad - 4.

    Raises:
        ValueError: shape, dtype, device or contiguity the kernel does not
            take.
        RuntimeError: the launch was refused.
    """
    rows = _out_rows(img, lo_pad, hi_pad)
    W = img.shape[1]
    if out is not None and tuple(out.shape) != (rows, W):
        raise ValueError(f"gaussian: out shape {tuple(out.shape)} != "
                         f"{(rows, W)}")
    _lib.refuse_dtensor("gaussian_blur_halo", img, out)
    if img.device.type == "cpu":
        return gaussian_blur_halo_plain(img, lo_pad=lo_pad, hi_pad=hi_pad,
                                        out=out)
    if out is None:
        out = torch.empty((rows, W), dtype=img.dtype, device=img.device)
    _lib.require_cuda_f32("gaussian_blur_halo", img, out)
    lib = _lib.library()
    err = lib.gaussian_rows_f32(img.data_ptr(), img.shape[0], W, int(lo_pad),
                                out.data_ptr(), rows, _lib.stream_of(img))
    _lib.check(err, "gaussian_blur_halo")
    gaussian_blur_halo.launches += 1
    return out


gaussian_blur_halo.launches = 0


def gaussian_blur(img: torch.Tensor, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """5x5 separable Gaussian blur with zero padding; img (H, W) float32.

    The whole image is the halo entry's block with both 2-row context
    blocks missing, so the zero rows are never materialized.
    """
    return gaussian_blur_halo(img, lo_pad=2, hi_pad=2, out=out)
