"""C = A @ B in f32 (paper benchmark: MatMul).

:func:`matmul` launches the CUDA kernel in ``csrc/matmul.cu`` for CUDA
tensors; it replaces the Pallas kernel ``repro/kernels/matmul.py``
``matmul`` (body ``_matmul_kernel``). For CPU tensors it runs the CPU's
f32 GEMM (``torch.matmul``), as the reference's CPU unit runs XLA's GEMM
(``ref.matmul``) outside any Pallas kernel.

The kernel's block tile comes from :func:`tile_for`: the main path calls
it per package, from one 4864-row launch down to dynamic's ~50-row
packages, and a 128 x 128 grid over 50 rows would leave most SMs idle.

:func:`matmul_plain` is the k-ordered loop the CUDA kernel is held
against (tests and ``chip_smoke.py``); nothing on the co-execution path
calls it.
"""
from __future__ import annotations

import functools
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


# the kernel's block tiles (rows, columns), largest first; one body
# (csrc/matmul.cu) serves all three, with an 8x8, 4x4 or 2x4 micro-tile
TILES = ((128, 128), (64, 64), (32, 64))
H100_SMS = 132


def tile_for(M: int, N: int, sms: int = H100_SMS) -> tuple[int, int]:
    """The kernel's block tile for an (M, N) output.

    Args:
        M, N: output rows and columns (both >= 1).
        sms: streaming multiprocessors to fill.

    Returns:
        The largest tile of :data:`TILES` whose grid has at least ``sms``
        blocks, else the smallest tile (whose grid is then the largest).
    """
    for bm, bn in TILES:
        if -(-M // bm) * -(-N // bn) >= sms:
            return bm, bn
    return TILES[-1]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    _lib.refuse_dtensor("matmul", a, b, out)
    if a.device.type == "cpu":
        if out is None:
            return torch.matmul(a, b)
        return torch.matmul(a, b, out=out)
    if out is None:
        out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    _lib.require_cuda_f32("matmul", a, b, out)
    tile_m, tile_n = tile_for(M, N, _sm_count(a.device))
    lib = _lib.library()
    err = lib.matmul_f32(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                         tile_m, tile_n, _lib.stream_of(a))
    _lib.check(err, "matmul")
    matmul.launches += 1
    return out


matmul.launches = 0
