"""Online throughput profiling for Coexecution Units.

The HGuided scheduler needs relative computing speeds. The paper takes a
programmer hint (``dist(0.35)``) but the runtime also refines speeds online;
we implement that refinement as an exponentially-weighted moving average of
measured package throughput (items/second), which also powers the hetero/
step-level monitor and straggler detection.
"""
from __future__ import annotations

import dataclasses
import math
import threading


@dataclasses.dataclass
class EwmaThroughput:
    """EWMA of items/second with debiased warm-up."""

    halflife: float = 4.0      # in number of observations
    _value: float = 0.0
    _weight: float = 0.0

    def update(self, items: float, seconds: float) -> float:
        if seconds <= 0:
            return self.value
        rate = items / seconds
        decay = math.exp(-math.log(2.0) / self.halflife)
        self._value = decay * self._value + (1 - decay) * rate
        self._weight = decay * self._weight + (1 - decay)
        return self.value

    @property
    def value(self) -> float:
        return self._value / self._weight if self._weight > 0 else 0.0


class SpeedBoard:
    """Thread-safe per-unit throughput board shared with the Scheduler.

    On the persistent engine one board outlives every launch: speeds
    learned from earlier launches' packages seed the adaptive (HGuided)
    refinement of later ones. Cumulative busy/items counters let callers
    compute utilization over the engine's lifetime; per-launch stats are
    kept separately (from each launch's own packages) so concurrent
    launches stay isolated.
    """

    def __init__(self, num_units: int, hints: list[float] | None = None):
        self._ewma = [EwmaThroughput() for _ in range(num_units)]
        self._hints = list(hints) if hints else [1.0] * num_units
        self._busy_s = [0.0] * num_units
        self._items = [0.0] * num_units
        self._lock = threading.Lock()

    def record(self, unit: int, items: float, seconds: float) -> None:
        with self._lock:
            self._ewma[unit].update(items, seconds)
            self._busy_s[unit] += max(seconds, 0.0)
            self._items[unit] += items

    def snapshot(self) -> dict[int, dict[str, float]]:
        """Point-in-time view: {unit: {speed, busy_s, items}} (lifetime)."""
        with self._lock:
            return {i: {"speed": (e.value if e.value > 0 else hint),
                        "busy_s": b, "items": n}
                    for i, (e, hint, b, n)
                    in enumerate(zip(self._ewma, self._hints,
                                     self._busy_s, self._items))}

    def speeds(self) -> list[float]:
        """Measured speeds, falling back to hints before observations."""
        with self._lock:
            out = []
            for hint, e in zip(self._hints, self._ewma):
                v = e.value
                out.append(v if v > 0 else hint)
            return out

    def relative(self) -> list[float]:
        s = self.speeds()
        tot = sum(s)
        return [x / tot for x in s] if tot > 0 else s
