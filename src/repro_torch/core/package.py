"""Work packages over a 1-D data-parallel index space.

The paper's Coexecutor Runtime splits a kernel's NDRange into *packages*
(contiguous ranges of work-items) that are dispatched to Coexecution Units.
Multi-dimensional problems are flattened to rows/pixels before packaging,
exactly as the reference implementation does.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class PackageState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"


@dataclasses.dataclass(frozen=True)
class Range:
    """Half-open interval [offset, offset + size) of work-items."""

    offset: int
    size: int

    def __post_init__(self) -> None:
        if self.size < 0:
            raise ValueError(f"negative range size {self.size}")
        if self.offset < 0:
            raise ValueError(f"negative range offset {self.offset}")

    @property
    def end(self) -> int:
        return self.offset + self.size

    def overlaps(self, other: "Range") -> bool:
        return self.offset < other.end and other.offset < self.end


@dataclasses.dataclass
class Package:
    """A schedulable unit of work: a range plus bookkeeping.

    Mirrors the `package` class handed to the application lambda in the
    paper's Listing 1 (``pkg.offset`` / ``pkg.size``).
    """

    rng: Range
    seq: int                      # emission order, global
    unit: Optional[int] = None    # Coexecution Unit id it was issued to
    state: PackageState = PackageState.PENDING
    # timeline bookkeeping (filled by the Commander / simulator)
    t_issue: float = 0.0
    t_launch: float = 0.0
    t_complete: float = 0.0
    t_collected: float = 0.0
    # (name, value) pairs measured while the data plane staged it, such as
    # ("usm_copy_bytes", n) on a CUDA unit under USM; the stage span's counts
    stage_counts: tuple = ()

    @property
    def offset(self) -> int:
        return self.rng.offset

    @property
    def size(self) -> int:
        return self.rng.size

    @property
    def compute_time(self) -> float:
        return self.t_complete - self.t_launch


def validate_cover(packages: list[Package], total: int) -> None:
    """Assert that packages exactly tile [0, total) — no gaps, no overlap.

    This is the core correctness invariant of every scheduler: each
    work-item is computed exactly once regardless of policy.
    """
    got = sorted((p.rng for p in packages), key=lambda r: r.offset)
    cursor = 0
    for r in got:
        if r.offset != cursor:
            raise AssertionError(
                f"package cover broken at {cursor}: next range starts at "
                f"{r.offset} (gap or overlap)"
            )
        cursor = r.end
    if cursor != total:
        raise AssertionError(f"package cover ends at {cursor}, expected {total}")
