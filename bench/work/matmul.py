"""MatMul's work, counted from its shapes (a frozen copy of the port's
smoke-test counts): 2 M N K operations, and every byte of A, B and C once,
4 (M K + K N + M N).

A package of ``size`` rows reads its rows of A and all of B, and writes
its rows of C.
"""
from __future__ import annotations

PEAK = "f32_flops_per_s"


def items(config: dict) -> int:
    """Table 1's work-items a launch: the M N outputs."""
    return int(config["M"]) * int(config["N"])


class Counter:
    """Operations and bytes of any range of rows of one client's launch."""

    def __init__(self, inputs: list, device: str = "cpu"):
        (_, self.K), self.N = inputs[0].shape, inputs[1].shape[1]

    def count(self, offset: int, size: int) -> tuple[int, int]:
        """``(operations, bytes)`` of rows [offset, offset + size)."""
        K, N = self.K, self.N
        return 2 * size * N * K, 4 * (size * K + K * N + size * N)
