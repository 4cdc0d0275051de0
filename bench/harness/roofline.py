"""A kernel's share of its roofline, from the device trace.

The counted work of the packages the CUDA unit ran (each package's rows
by the configuration's work module, whatever implements the kernel), at
the roofline, over that kernel's device seconds by name in the trace.

A system without packages reads its counts from the work module for the
whole launch, or for a named kernel's part of it (``Counter.count_part``),
through ``launch_bound_s`` and ``launch_share``; ``launch_bound_s`` of
the whole launches is also ``metrics/launch_mfu.py``'s bound.
"""
from __future__ import annotations

from typing import Optional


def kernel_share(run, needle: str) -> Optional[float]:
    """Percent of the roofline the kernel named ``needle`` reached."""
    if run.trace is None or run.peaks is None:
        return None
    seconds = run.trace.kernel_seconds(needle)
    if seconds <= 0:
        return None
    bound = 0.0
    for r in run.window.ok:
        for p in getattr(r.stats, "packages", ()):
            if run.unit_kind(p.unit) == "cuda":
                bound += run.bound_s(*run.counter(r.client).count(p.offset,
                                                                  p.size))
    return 100.0 * bound / seconds if bound > 0 else None


def launch_bound_s(run, part: Optional[str] = None) -> Optional[float]:
    """The least device seconds of the window's finished launches at the
    roofline: each launch's counted work over its whole index space
    (``Counter.count(0, total)``), or with ``part`` the part of it that
    the kernel ``part`` does (``Counter.count_part(part, 0, total)``).
    ``None`` without peaks."""
    if run.peaks is None:
        return None
    bound = 0.0
    for r in run.window.ok:
        counter = run.counter(r.client)
        counted = (counter.count(0, run.total) if part is None
                   else counter.count_part(part, 0, run.total))
        bound += run.bound_s(*counted)
    return bound


def launch_share(run, needle: str, part: Optional[str] = None
                 ) -> Optional[float]:
    """Percent of the roofline the kernels named ``needle`` reached on the
    window's launches' counted work (whole, or ``part``'s), over their
    device seconds in the trace; ``None`` without a trace, peaks or
    such kernels."""
    if run.trace is None:
        return None
    seconds = run.trace.kernel_seconds(needle)
    bound = launch_bound_s(run, part)
    if seconds <= 0 or not bound:
        return None
    return 100.0 * bound / seconds
