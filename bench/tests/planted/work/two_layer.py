"""The planted two-layer model's work, counted from its shapes: 2 D H
operations a request in the first layer and 2 H V in the second; each
input byte read once and the f32 logits written once.

``count_part`` gives one kernel's part of a launch: ``hidden`` (x W1
and the gelu) or ``logits`` (h W2).
"""
from __future__ import annotations

PEAK = "bf16_dense_flops_per_s"


def items(config: dict) -> int:
    """Requests a launch: the batch."""
    return int(config["batch"])


class Counter:
    """Operations and bytes of any range of one client's batch."""

    def __init__(self, inputs: dict, device: str = "cpu"):
        w1, w2 = inputs["weights"]["w1"], inputs["weights"]["w2"]
        (self.D, self.H), self.V = tuple(w1.shape), int(w2.shape[1])
        self.b = w1.element_size()

    def count_part(self, kernel: str, offset: int, size: int
                   ) -> tuple[int, int]:
        """``(operations, bytes)`` of ``kernel`` over requests [offset,
        offset + size)."""
        D, H, V, b = self.D, self.H, self.V, self.b
        if kernel == "hidden":
            return 2 * size * D * H, b * (size * D + D * H + size * H)
        if kernel == "logits":
            return 2 * size * H * V, b * (size * H + H * V) + 4 * size * V
        raise KeyError(f"no kernel {kernel!r}; choose hidden or logits")

    def count(self, offset: int, size: int) -> tuple[int, int]:
        """``(operations, bytes)`` of requests [offset, offset + size)."""
        D, H, V, b = self.D, self.H, self.V, self.b
        return (2 * size * (D * H + H * V),
                b * (size * D + D * H + H * V) + 4 * size * V)
