"""A kernel's share of its roofline, from the device trace.

The counted work of the packages the CUDA unit ran (each package's rows
by the configuration's work module, whatever implements the kernel), at
the roofline, over that kernel's device seconds by name in the trace.
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
