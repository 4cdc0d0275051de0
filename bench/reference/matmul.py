"""MatMul's plain reference: C = A @ B in PyTorch, f32 with TF32 off.

Computed from the benchmark's own host inputs, in blocks of rows, on the
device the check runs on. ``precision`` names the control's lower
precisions: ``tf32`` (the card's TF32 GEMM; on the CPU the inputs rounded
to TF32's 10-bit mantissa, then an f32 GEMM) and ``bf16``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

PRECISIONS = ("f32", "tf32", "bf16")
CONTROL = "tf32"
BLOCK_ROWS = 1024


@contextlib.contextmanager
def _tf32(on: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to nearest (ties to even) on a 10-bit mantissa."""
    bits = x.contiguous().view(torch.int32)
    keep = bits + 0xFFF + ((bits >> 13) & 1)
    return (keep & ~0x1FFF).view(torch.float32)


def _product(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "bf16":
        return (a.bfloat16() @ b.bfloat16()).float()
    if precision == "tf32" and a.device.type == "cuda":
        with _tf32(True):
            return a @ b
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    elif precision != "f32":
        raise ValueError(f"unknown precision {precision!r}; choose from "
                         f"{PRECISIONS}")
    with _tf32(False):
        return a @ b


def reference(inputs: list, device: str, precision: str = "f32"
              ) -> torch.Tensor:
    """A @ B for one client's inputs, on ``device``."""
    a_host, b_host = inputs[0], inputs[1]
    b = torch.from_numpy(b_host).to(device)
    M, N = a_host.shape[0], b_host.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=device)
    for r0 in range(0, M, BLOCK_ROWS):
        a = torch.from_numpy(np.ascontiguousarray(
            a_host[r0:r0 + BLOCK_ROWS])).to(device)
        out[r0:r0 + BLOCK_ROWS] = _product(a, b, precision)
    return out


def _worst(diff: torch.Tensor) -> float:
    """The largest absolute gap; infinite where any gap is not a number."""
    if bool(torch.isnan(diff).any()):
        return float("inf")
    return float(diff.abs().max())


def compare(out: np.ndarray, ref: torch.Tensor) -> dict:
    """The largest gap of any output from the reference, over its RMS.

    The RMS of C (about sqrt(K) for normal inputs) sets the scale an f32
    GEMM's rounding grows with, whatever order it sums in.
    """
    rms = float(ref.double().pow(2).mean().sqrt())
    err = 0.0
    for r0 in range(0, ref.shape[0], BLOCK_ROWS):
        got = torch.from_numpy(np.ascontiguousarray(
            out[r0:r0 + BLOCK_ROWS])).to(ref.device)
        err = max(err, _worst(got - ref[r0:r0 + BLOCK_ROWS]))
    return {"max_err_over_rms": err / rms}
