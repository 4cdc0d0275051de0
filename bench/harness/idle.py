"""The program's own spans, read from each launch's ``LaunchStats``, and
the card's idle time split by what the program was doing.

``LaunchStats.timeline()`` gives a launch's spans on the clock of the
package stamps (``time.perf_counter``), which is the window's clock and,
through the trace's offset, the device trace's. A program without
timelines (the parent of this reader, the control) gives none: every
reader then returns ``None``.

The card's idle time (the complement of the union of the trace's
operations, as ``device_idle_frac`` takes it) is attributed once per
instant, in this order: ``usm``, a ``plan`` or ``settle`` span of any
launch open; ``cpu``, else a CPU unit's package ``compute`` open;
``other``, else any other span of the program open (``admit``,
``queue``, a CUDA package's ``stage``, ``compute`` or ``collect``, a CPU
package's ``stage`` or ``collect``); ``unattributed``, no span open. The
four add up to the idle time.
"""
from __future__ import annotations

from typing import Optional

from . import stats

USM = ("plan", "settle")
CLASSES = ("usm", "cpu", "other", "unattributed")


def timelines(run) -> list:
    """The timelines of the window's finished launches (none without)."""
    out = []
    for r in run.window.ok:
        timeline = getattr(r.stats, "timeline", None)
        if timeline is not None:
            out.append(timeline())
    return [tl for tl in out if tl]


def spans(run, name: str) -> list:
    """Every span ``name`` of the window's launches."""
    return [s for tl in timelines(run) for s in tl if s.name == name]


def mean_ms(values: list) -> Optional[float]:
    """The mean of ``values`` (seconds) in ms, or ``None`` if empty."""
    return 1e3 * sum(values) / len(values) if values else None


def _intersect(a: list, b: list) -> list:
    """The intersection of two ordered lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _length(intervals: list) -> float:
    return sum(e - s for s, e in intervals)


def split(run) -> Optional[dict]:
    """The card's idle seconds of the traced window by class.

    Returns:
        ``{"usm", "cpu", "other", "unattributed", "window_s"}`` in
        seconds, or ``None`` without a trace or without spans.
    """
    trace = run.trace
    if trace is None or trace.window_s <= 0:
        return None
    tls = timelines(run)
    if not tls:
        return None
    lo, hi = trace.t_start, trace.t_end
    program = [s for tl in tls for s in tl[1:]]     # the root left out
    classes = (
        ("usm", [s for s in program if s.name in USM]),
        ("cpu", [s for s in program if s.name == "compute"
                 and s.unit is not None and run.unit_kind(s.unit) == "cpu"]),
        ("other", program),
    )
    rest = stats.gaps([(s, e) for _, _, s, e in trace.events], lo, hi)
    out = {"window_s": trace.window_s}
    for name, chosen in classes:
        pairs = [(s.start, s.end) for s in chosen]
        out[name] = _length(_intersect(rest, stats.union(pairs, lo, hi)))
        rest = _intersect(rest, stats.gaps(pairs, lo, hi))
    out["unattributed"] = _length(rest)
    return out


def idle_frac(run, name: str) -> Optional[float]:
    """One class's idle seconds over the traced window, or ``None``."""
    got = split(run)
    return None if got is None else got[name] / got["window_s"]
