"""C = A @ B in f32 (paper benchmark: MatMul).

:func:`matmul` launches the CUDA kernel in ``csrc/matmul.cu`` for CUDA
tensors and runs :func:`matmul_plain` for CPU tensors. It replaces the
Pallas kernel ``repro/kernels/matmul.py`` ``matmul`` (body
``_matmul_kernel``).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _lib


def _check_shapes(a: torch.Tensor, b: torch.Tensor,
                  out: Optional[torch.Tensor]) -> tuple[int, int, int]:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not compose")
    M, K = a.shape
    N = b.shape[1]
    if out is not None and tuple(out.shape) != (M, N):
        raise ValueError(f"matmul: out shape {tuple(out.shape)} != {(M, N)}")
    return M, N, K


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A @ B in plain PyTorch (any device): f32 rank-1 updates in ascending k.

    Deliberately not ``torch.matmul``: the sum runs in the kernel's k
    order, one multiply and one add per step.
    """
    M, N, K = _check_shapes(a, b, out)
    acc = torch.zeros((M, N), dtype=a.dtype, device=a.device)
    for k in range(K):
        acc.addcmul_(a[:, k:k + 1], b[k:k + 1, :])
    if out is None:
        return acc
    return out.copy_(acc)


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = A @ B with f32 accumulation; any M, N, K, no padding.

    Args:
        a: (M, K) float32.
        b: (K, N) float32.
        out: optional (M, N) output, written in place.

    Returns:
        The (M, N) product (``out`` when given).

    Raises:
        ValueError: shape, dtype, device or contiguity the kernel does not
            take.
        RuntimeError: the launch was refused.
    """
    M, N, K = _check_shapes(a, b, out)
    if a.device.type == "cpu":
        return matmul_plain(a, b, out=out)
    if out is None:
        out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    _lib.require_cuda_f32("matmul", a, b, out)
    lib = _lib.library()
    err = lib.matmul_f32(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                         _lib.stream_of(a))
    _lib.check(err, "matmul")
    matmul.launches += 1
    return out


matmul.launches = 0
