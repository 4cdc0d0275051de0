"""Per-group throughput monitoring + straggler detection.

A *group* is a co-execution unit at fleet scale: a card, a host, or a
simulated device group. The monitor keeps an EWMA of tokens/second per
group; stragglers are groups whose throughput falls below
`straggler_factor ×` the median. The rebalance policies (rebalance.py)
consume `shares()` and the supervisor (ft/) consumes `stragglers()`.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Optional

from ..core.profiler import EwmaThroughput


@dataclasses.dataclass
class GroupStats:
    name: str
    ewma: EwmaThroughput
    steps: int = 0
    alive: bool = True

    @property
    def throughput(self) -> float:
        return self.ewma.value


class GroupMonitor:
    def __init__(self, names: list[str], *, halflife: float = 4.0,
                 straggler_factor: float = 0.6):
        self.groups = {n: GroupStats(n, EwmaThroughput(halflife=halflife))
                       for n in names}
        self.straggler_factor = straggler_factor

    def record(self, name: str, tokens: float, seconds: float) -> None:
        g = self.groups[name]
        g.ewma.update(tokens, seconds)
        g.steps += 1

    def mark_dead(self, name: str) -> None:
        self.groups[name].alive = False

    def revive(self, name: str) -> None:
        self.groups[name].alive = True

    def alive(self) -> list[str]:
        return [n for n, g in self.groups.items() if g.alive]

    def throughputs(self) -> dict[str, float]:
        return {n: g.throughput for n, g in self.groups.items() if g.alive}

    def shares(self, fallback: Optional[dict[str, float]] = None
               ) -> dict[str, float]:
        """Measured relative speeds (normalized), hints before warm-up."""
        tps = self.throughputs()
        if not tps:
            return {}
        if any(v <= 0 for v in tps.values()):
            if fallback:
                alive = {n: fallback.get(n, 1.0) for n in tps}
            else:
                alive = {n: 1.0 for n in tps}
            tot = sum(alive.values())
            return {n: v / tot for n, v in alive.items()}
        tot = sum(tps.values())
        return {n: v / tot for n, v in tps.items()}

    def stragglers(self, warmup: int = 3) -> list[str]:
        """Groups below straggler_factor x median throughput.

        Groups with fewer than `warmup` observations are excluded: the
        first step folds compilation into the measurement, which would
        otherwise flag whichever group compiled first.
        """
        tps = {n: v for n, v in self.throughputs().items()
               if v > 0 and self.groups[n].steps >= warmup}
        if len(tps) < 2:
            return []
        med = statistics.median(tps.values())
        return [n for n, v in tps.items()
                if v < self.straggler_factor * med]
