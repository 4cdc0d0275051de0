"""Resource Allocation Problem row utilities (paper benchmark: Rap).

:func:`rap` launches the CUDA kernel in ``csrc/rap.cu`` for CUDA tensors
and runs :func:`rap_plain` for CPU tensors. It replaces the Pallas kernel
``repro/kernels/rap.py`` ``rap`` (body ``_rap_kernel``).

Row i of an (N, L) f32 matrix sums ``log1p(max(v_ij, 0))`` over its first
``lengths[i]`` columns: a length above L counts as L, one at or below 0
gives 0, as the reference's iota mask does. The kernel reads only the
columns that count and sums them in another order than the plain
version, so the two agree within rtol 1e-5, atol 1e-6 * L.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _lib


def _check(values: torch.Tensor, lengths: torch.Tensor,
           out: Optional[torch.Tensor]) -> None:
    if values.dim() != 2:
        raise ValueError(f"rap: values must be (N, L), got "
                         f"{tuple(values.shape)}")
    if tuple(lengths.shape) != (values.shape[0],):
        raise ValueError(f"rap: lengths {tuple(lengths.shape)} do not match "
                         f"{values.shape[0]} rows")
    if out is not None and tuple(out.shape) != (values.shape[0],):
        raise ValueError(f"rap: out shape {tuple(out.shape)} != "
                         f"{(values.shape[0],)}")


def rap_plain(values: torch.Tensor, lengths: torch.Tensor, *,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked row sums in plain PyTorch (any device), the reference's way:
    every column's utility, masked by ``column < length``, then summed."""
    _check(values, lengths, out)
    col = torch.arange(values.shape[1], device=values.device)
    mask = col[None, :] < lengths[:, None]
    util = torch.log1p(torch.clamp_min(values, 0.0))
    return torch.sum(torch.where(mask, util, 0.0), dim=1, out=out)


def rap(values: torch.Tensor, lengths: torch.Tensor, *,
        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row utility sum over each row's first ``lengths[i]`` columns.

    Args:
        values: (N, L) float32.
        lengths: (N,) int32 (not cast: another dtype is refused).
        out: optional (N,) float32 output, written in place.

    Returns:
        The (N,) utilities (``out`` when given).

    Raises:
        ValueError: shape, dtype, device or contiguity the kernel does not
            take.
        RuntimeError: the launch was refused.
    """
    _check(values, lengths, out)
    if values.device.type == "cpu":
        return rap_plain(values, lengths, out=out)
    if out is None:
        out = torch.empty(values.shape[0], dtype=values.dtype,
                          device=values.device)
    _lib.require_cuda("rap", (values, torch.float32),
                      (lengths, torch.int32), (out, torch.float32))
    lib = _lib.library()
    err = lib.rap_f32(values.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                      values.shape[0], values.shape[1],
                      _lib.stream_of(values))
    _lib.check(err, "rap")
    rap.launches += 1
    return out


rap.launches = 0
