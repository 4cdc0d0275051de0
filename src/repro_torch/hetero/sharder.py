"""Quantize continuous group shares into microbatch assignments + a memo
of step functions per assignment.

Shares → integer microbatch counts via the largest-remainder method (sum
preserved exactly; alive groups with nonzero share get ≥1 microbatch).
Each distinct assignment keys a cache entry. In the reference an entry is
a compiled executable, and the recompile cost is the step-level analogue
of the paper's package-launch overhead, so policies are designed to change
assignments rarely (HGuided's damped corrections) while staying balanced.
PyTorch runs eagerly and compiles nothing, so here the cache is a plain
memo; it still counts ``compilations`` (distinct assignments seen), the
number the reference reports.
"""
from __future__ import annotations

from typing import Any, Callable, Hashable


def quantize_shares(shares: dict[str, float], total_microbatches: int
                    ) -> dict[str, int]:
    """Largest-remainder quantization; every live group gets ≥ 1."""
    if not shares:
        return {}
    if total_microbatches < len(shares):
        raise ValueError(
            f"{total_microbatches} microbatches cannot feed "
            f"{len(shares)} groups")
    raw = {k: v * total_microbatches for k, v in shares.items()}
    floored = {k: max(1, int(v)) for k, v in raw.items()}
    drift = total_microbatches - sum(floored.values())
    # distribute the drift by largest remainder (or take from smallest)
    rema = sorted(shares, key=lambda k: raw[k] - int(raw[k]), reverse=True)
    i = 0
    while drift != 0:
        k = rema[i % len(rema)]
        if drift > 0:
            floored[k] += 1
            drift -= 1
        elif floored[k] > 1:
            floored[k] -= 1
            drift += 1
        i += 1
    return floored


class ExecutableCache:
    """Step-function memo keyed by the microbatch assignment."""

    def __init__(self, compile_fn: Callable[[Hashable], Any]):
        self._compile = compile_fn
        self._cache: dict[Hashable, Any] = {}
        self.compilations = 0

    def get(self, assignment: dict[str, int]) -> Any:
        key = tuple(sorted(assignment.items()))
        if key not in self._cache:
            self._cache[key] = self._compile(key)
            self.compilations += 1
        return self._cache[key]

    def __len__(self) -> int:
        return len(self._cache)
