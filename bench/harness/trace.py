"""The device trace of a ``--trace 1`` run, on the host's clock.

``torch.profiler`` with CUDA activity only (CUPTI) records every kernel,
copy and set that ran on the card, the program's hand kernels (launched
through ``ctypes``) among them. Kineto stamps them in Unix nanoseconds;
one paired reading of ``time.time_ns`` and ``time.perf_counter_ns`` puts
them on the window's clock, so idle gaps can be named by what the host
was doing then.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

from . import stats

# kineto activities on the device that are not device work
NOT_WORK = ("annotation", "runtime", "driver", "sync", "overhead")
TOP = 10


@dataclasses.dataclass
class DeviceTrace:
    """Device operations as ``(name, kind, start_s, end_s)``, host clock."""

    events: list
    t_start: float
    t_end: float

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return stats.covered([(s, e) for _, _, s, e in self.events],
                             self.t_start, self.t_end)

    def kernel_seconds(self, needle: str) -> float:
        """Device seconds of the kernels whose name holds ``needle``."""
        return sum(min(e, self.t_end) - max(s, self.t_start)
                   for name, _, s, e in self.events
                   if needle in name
                   and e > self.t_start and s < self.t_end)

    def top_ops(self, n: int = TOP) -> list:
        """The ``n`` operation names that took the most device time."""
        total = defaultdict(float)
        for name, _, s, e in self.events:
            total[name] += e - s
        return [[name, sec] for name, sec in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, host_spans: list, n: int = TOP) -> list:
        """The ``n`` longest idle gaps, each named by the host spans active
        at its middle (``host_spans``: ``(kind, start_s, end_s)``)."""
        gaps = stats.gaps([(s, e) for _, _, s, e in self.events],
                          self.t_start, self.t_end)
        out = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = (s + e) / 2
            active = defaultdict(int)
            for kind, hs, he in host_spans:
                if hs <= mid < he:
                    active[kind] += 1
            label = ", ".join(f"{k} x{v}" for k, v in sorted(active.items()))
            out.append([label or "host idle", e - s])
        return out


def _clock_offset_ns() -> int:
    """Unix ns minus ``perf_counter_ns`` now (the tightest of 5 readings)."""
    best = None
    for _ in range(5):
        p0 = time.perf_counter_ns()
        t = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, t - (p0 + p1) // 2)
    return best[1]


class Tracer:
    """``with Tracer() as tr: ...``; then ``tr.trace(t_start, t_end)``."""

    def __init__(self):
        self._prof = None
        self._offset_ns = 0
        self.kinds = defaultdict(int)   # device activities seen, by kind

    def __enter__(self) -> "Tracer":
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._offset_ns = _clock_offset_ns()
        return self

    def __exit__(self, *exc) -> None:
        self._prof.__exit__(*exc)

    def trace(self, t_start: float, t_end: float) -> DeviceTrace:
        """The device operations the profiler saw, on the host clock."""
        from torch.autograd import DeviceType

        events = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            kind = str(e.activity_type()) if hasattr(e, "activity_type") \
                else "kernel"
            self.kinds[kind] += 1
            if any(word in kind for word in NOT_WORK):
                continue
            start = (e.start_ns() - self._offset_ns) * 1e-9
            events.append((e.name(), kind, start,
                           start + e.duration_ns() * 1e-9))
        return DeviceTrace(events=events, t_start=t_start, t_end=t_end)
