"""Load-balancing algorithms of the Coexecutor Runtime (paper §3.2).

Three policies implemented exactly as defined in the paper and its
antecedents (Maat [15], EngineCL [16], HGuided [18]), plus a fourth from
the same dynamic-policy family the paper argues for:

* ``Static``        — one package per unit, sized proportionally to the
                      unit's relative computing speed. Minimal management;
                      cannot adapt.
* ``Dynamic``       — N equal packages, handed to units on demand as they
                      go idle. Adapts to irregularity; pays one host⇄device
                      round trip per package.
* ``HGuided``       — package size for unit *i* when ``rem`` items remain:
                      ``max(min_pkg, rem * speed_i / (K * sum(speeds)))``,
                      so packages start large (∝ speed) and shrink as the
                      execution progresses. Few synchronisation points,
                      near-1.0 balance, no per-benchmark tuning parameter.
* ``WorkStealing``  — per-unit deques seeded by the static split and chopped
                      into chunks; a unit drains its own deque and, when
                      empty, steals half the remainder of the most-loaded
                      victim. Adapts like Dynamic but without the central
                      remaining-work cursor every package request contends
                      on — the natural fit for the persistent engine, where
                      packages of many concurrent launches interleave.

All schedulers hand out contiguous ranges aligned to ``granularity`` (the
kernel's local work size / hardware vector width), except possibly the final
package which takes whatever remains.

Thread-safety: `next_package` is called under the Director's/engine's
per-launch lock (real runtime) or single-threaded (simulator); schedulers
themselves are not internally locked.
"""
from __future__ import annotations

import abc
import collections
import math
from typing import Optional, Sequence

from .package import Package, Range


def _align_up(x: int, g: int) -> int:
    return ((x + g - 1) // g) * g


def static_bounds(total: int, speeds: Sequence[float],
                  granularity: int = 1) -> list[int]:
    """Monotone, granularity-aligned region boundaries ∝ relative speed.

    Returns ``len(speeds) + 1`` cumulative boundaries with ``bounds[0] == 0``
    and ``bounds[-1] == total``: exact cover by construction (the tail unit
    absorbs any alignment remainder; a unit whose share rounds to zero gets
    an empty region). Shared by the Static and WorkStealing seeds.
    """
    tot_speed = sum(speeds)
    cum = 0.0
    bounds = [0]
    for s in list(speeds)[:-1]:
        cum += total * s / tot_speed
        b = _align_up(int(round(cum)), granularity)
        bounds.append(min(max(b, bounds[-1]), total))
    bounds.append(total)
    return bounds


class Scheduler(abc.ABC):
    """Base class: owns the remaining-work cursor and the package log."""

    name: str = "base"

    def __init__(self, total: int, num_units: int, *, granularity: int = 1):
        if total <= 0:
            raise ValueError("total work must be positive")
        if num_units <= 0:
            raise ValueError("need at least one Coexecution Unit")
        if granularity <= 0:
            raise ValueError("granularity must be positive")
        self.total = int(total)
        self.num_units = int(num_units)
        self.granularity = int(granularity)
        self._cursor = 0
        self._seq = 0
        self.issued: list[Package] = []

    @property
    def remaining(self) -> int:
        """Work-items not yet handed out."""
        return self.total - self._cursor

    def done(self) -> bool:
        """Whether the whole index space has been issued as packages."""
        return self._cursor >= self.total

    def quantum_hint(self) -> int:
        """Typical package size in work-items, for cross-launch policies.

        The admission layer's deficit-round-robin needs a credit quantum
        on the same scale as the packages this scheduler emits (too small
        and every pull overdrafts; too large and fairness goes coarse).
        Policies with a natural package size override this; the default is
        a fraction of the index space per unit.

        Returns:
            A positive package-size estimate, at least ``granularity``.
        """
        return max(self.granularity, self.total // max(1, 4 * self.num_units))

    def _cap_size(self, size: int, max_items: Optional[int]) -> int:
        """Apply a preemption cap: align *down* to granularity, floor g.

        The cap comes from WFQ credit reclamation
        (:class:`~.admission.AdmissionConfig` ``preempt``): a capped
        package must not exceed the tenant's remaining credit by more
        than one granularity-aligned chunk, so the cap rounds down
        (whereas uncapped sizing rounds up to stay aligned).
        """
        if max_items is None:
            return size
        cap = max(int(max_items), 1)
        if cap >= size:
            return size
        return max((cap // self.granularity) * self.granularity,
                   self.granularity)

    # -- policy hook ------------------------------------------------------
    @abc.abstractmethod
    def _package_size(self, unit: int) -> int:
        """Size of the next package for `unit`, given current remaining."""

    # -- public API (called by the Commander loop) -------------------------
    def next_package(self, unit: int,
                     max_items: Optional[int] = None) -> Optional[Package]:
        """Emit the next contiguous package for an idle unit.

        Args:
            unit: Coexecution Unit index requesting work.
            max_items: optional preemption cap — the admission layer's
                WFQ credit reclamation asks for at most this many items;
                the emitted package may exceed it only up to granularity
                alignment (never below one granularity chunk).

        Returns:
            A fresh :class:`~.package.Package`, or ``None`` when this
            scheduler has nothing (left) for that unit.
        """
        if self.done():
            return None
        size = self._package_size(unit)
        size = max(1, min(size, self.remaining))
        # align to granularity unless this is the tail; a preemption cap
        # aligns down instead so the pull stays within credit
        if size < self.remaining:
            size = min(_align_up(size, self.granularity), self.remaining)
        size = min(self._cap_size(size, max_items), self.remaining)
        pkg = Package(rng=Range(self._cursor, size), seq=self._seq, unit=unit)
        self._cursor += size
        self._seq += 1
        self.issued.append(pkg)
        return pkg

    # -- elastic-cluster hooks ---------------------------------------------
    def reissue(self, rng: Range, unit: int) -> Package:
        """Re-emit a previously issued range after its unit died.

        The range was already cut from the index space (the cursor moved
        when it was first issued), so this only mints a fresh package
        around the *same* interval for a surviving unit — which is what
        makes recovery bitwise-identical to an undisturbed run.

        Args:
            rng: the exact lost interval, as first issued.
            unit: the surviving Coexecution Unit taking the work over.
        """
        pkg = Package(rng=rng, seq=self._seq, unit=unit)
        self._seq += 1
        self.issued.append(pkg)
        return pkg

    def unit_lost(self, unit: int) -> list[Range]:
        """Release work reserved for a dead unit.

        Policies with per-unit reservations (static regions, work-stealing
        deques) override this to hand the un-issued remainder back as
        ranges the execution loop re-issues to survivors; cursor-based
        policies reserve nothing, so the default releases nothing.

        Args:
            unit: index of the dead Coexecution Unit.

        Returns:
            Ranges no longer servable by this scheduler itself (they are
            accounted as issued here; the loop re-emits them).
        """
        return []

    def unit_joined(self, unit: int, speed: Optional[float] = None) -> None:
        """Accommodate a unit joining (or growing) the pool.

        The base scheduler only tracks the unit count; policies with
        per-unit structures (speeds, regions, deques) extend them so the
        newcomer can pull immediately.

        Args:
            unit: index of the joining Coexecution Unit.
            speed: optional relative-throughput hint for the newcomer.
        """
        if unit >= self.num_units:
            self.num_units = unit + 1


class StaticScheduler(Scheduler):
    """One package per unit, split ∝ relative speed (paper's `Static`)."""

    name = "static"

    def __init__(self, total: int, num_units: int, *,
                 speeds: Optional[Sequence[float]] = None, granularity: int = 1):
        super().__init__(total, num_units, granularity=granularity)
        if speeds is None:
            speeds = [1.0] * num_units
        if len(speeds) != num_units:
            raise ValueError("speeds length must match num_units")
        if any(s <= 0 for s in speeds):
            raise ValueError("speeds must be positive")
        self.speeds = [float(s) for s in speeds]
        # Precompute the split from aligned cumulative boundaries: exact
        # cover by construction; a unit whose share rounds to zero simply
        # gets no package.
        bounds = static_bounds(total, self.speeds, granularity)
        self._sizes = [bounds[i + 1] - bounds[i] for i in range(num_units)]
        self._bounds = bounds
        # per-unit region cursor: uncapped serving emits the whole region
        # as one package (the paper's semantics); a preemption cap may
        # split it, in which case the remainder stays servable.
        self._next = [bounds[i] for i in range(num_units)]

    def _package_size(self, unit: int) -> int:  # pragma: no cover - unused
        return self._sizes[unit]

    def quantum_hint(self) -> int:
        """Largest static share — one package is one unit's whole region."""
        return max(max(self._sizes), self.granularity)

    def next_package(self, unit: int,
                     max_items: Optional[int] = None) -> Optional[Package]:
        """Serve unit `unit` (the rest of) its precomputed region.

        Args:
            unit: Coexecution Unit index requesting work.
            max_items: optional preemption cap (splits the region; the
                remainder is served by later pulls).

        Returns:
            The unit's static share as one package (or the next capped
            slice of it), or ``None`` once the unit's region is drained
            (including shares that rounded to zero).
        """
        # Unit i's region is [bounds[i], bounds[i+1]) — deterministic
        # placement, as the paper's static split fixes regions at
        # configure time.
        lo, hi = self._next[unit], self._bounds[unit + 1]
        if lo >= hi or self.done():
            return None     # drained, or share rounded away
        size = self._cap_size(hi - lo, max_items)
        size = min(size, hi - lo)
        pkg = Package(rng=Range(lo, size), seq=self._seq, unit=unit)
        self._next[unit] = lo + size
        self._seq += 1
        self._cursor += size
        self.issued.append(pkg)
        return pkg

    def unit_lost(self, unit: int) -> list[Range]:
        """Hand back the un-served remainder of the dead unit's region.

        The region is marked drained (cursor advanced) so the launch can
        still complete: the released range is re-issued by the execution
        loop to whichever survivor idles first — the one adaptation the
        paper's static policy ever makes.
        """
        if unit >= len(self._next):
            return []
        lo, hi = self._next[unit], self._bounds[unit + 1]
        if lo >= hi:
            return []
        self._next[unit] = hi
        self._cursor += hi - lo
        return [Range(lo, hi - lo)]

    def unit_joined(self, unit: int, speed: Optional[float] = None) -> None:
        """A late joiner gets an empty region — static splits are fixed."""
        super().unit_joined(unit, speed)
        while len(self._next) < self.num_units:
            self._next.append(self.total)
            self._bounds.append(self.total)
            self._sizes.append(0)
            self.speeds.append(float(speed) if speed and speed > 0 else
                               sum(self.speeds) / len(self.speeds))


class DynamicScheduler(Scheduler):
    """N equal packages served on demand (paper's `Dynamic`, Dyn5/Dyn200)."""

    name = "dynamic"

    def __init__(self, total: int, num_units: int, *, num_packages: int = 200,
                 granularity: int = 1):
        super().__init__(total, num_units, granularity=granularity)
        if num_packages <= 0:
            raise ValueError("num_packages must be positive")
        self.num_packages = int(num_packages)
        self._pkg_size = max(1, math.ceil(total / self.num_packages))

    def _package_size(self, unit: int) -> int:
        return self._pkg_size

    def quantum_hint(self) -> int:
        """The fixed equal-package size, granularity-aligned.

        Aligned up exactly as :meth:`next_package` aligns the emitted
        packages, so the WFQ credit quantum matches real package sizes —
        which is also what keeps the engine's member-unit fused
        schedulers and the DES's item-unit ones on the same credit scale.
        """
        return max(_align_up(self._pkg_size, self.granularity),
                   self.granularity)


class HGuidedScheduler(Scheduler):
    """Heterogeneous guided self-scheduling (paper's `HGuided`).

    size_i = max(min_package, remaining * speed_i / (K * sum(speeds)))

    `speeds` is the computational-power hint (the `dist` 0.35 in Listing 1
    translates to speeds [0.35, 0.65] for [CPU, GPU]). K (the divisor)
    defaults to 2 as in the reference implementation.
    """

    name = "hguided"

    def __init__(self, total: int, num_units: int, *,
                 speeds: Optional[Sequence[float]] = None,
                 divisor: float = 2.0,
                 min_package: int = 1,
                 granularity: int = 1):
        super().__init__(total, num_units, granularity=granularity)
        if speeds is None:
            speeds = [1.0] * num_units
        if len(speeds) != num_units:
            raise ValueError("speeds length must match num_units")
        if any(s <= 0 for s in speeds):
            raise ValueError("speeds must be positive")
        if divisor <= 0:
            raise ValueError("divisor must be positive")
        self.speeds = [float(s) for s in speeds]
        self.divisor = float(divisor)
        self.min_package = max(int(min_package), granularity)

    def _package_size(self, unit: int) -> int:
        share = self.remaining * self.speeds[unit] / (
            self.divisor * sum(self.speeds))
        return max(self.min_package, int(share))

    def update_speed(self, unit: int, speed: float) -> None:
        """Online speed refinement from the profiler (EWMA throughput)."""
        if speed > 0:
            self.speeds[unit] = float(speed)

    def unit_joined(self, unit: int, speed: Optional[float] = None) -> None:
        """Grant the newcomer a speed share (hetero's ``add_group`` move).

        With no hint it enters at the pool's mean speed, shrinking every
        incumbent's *relative* share proportionally — the same
        renormalizing grant :func:`repro_torch.core.cluster.grant_share`
        models — and the guided sizing formula adapts from the next pull.
        """
        super().unit_joined(unit, speed)
        while len(self.speeds) < self.num_units:
            self.speeds.append(float(speed) if speed and speed > 0 else
                               sum(self.speeds) / len(self.speeds))


class WorkStealingScheduler(Scheduler):
    """Per-unit deques seeded by the static split; idle units steal.

    Seeding: unit *i*'s region ``[bounds[i], bounds[i+1])`` (∝ speed, same
    boundaries as `Static`) is chopped into granularity-aligned chunks of
    ``~region/chunks_per_unit`` items, queued oldest-first in its own deque.

    Serving: ``next_package(i)`` pops the front of deque *i*. When the deque
    is empty the unit steals **half the remainder** (by chunk count, from
    the far end, preserving the victim's locality) of the most-loaded
    victim. ``None`` is returned only when every deque is empty — a unit
    never retires while any work remains anywhere, which is the termination
    property the Commander loop relies on.

    Compared to `Dynamic`/`HGuided`, there is no central remaining-work
    cursor: units touch shared state only on the (rare) steal path, so many
    concurrent launches on a persistent engine do not serialize on one
    cursor per package request. The total package count is fixed at seed
    time (steals move chunks, never split them), making the package count
    identical between the real engine and the DES for a given problem.
    """

    name = "work_stealing"

    def __init__(self, total: int, num_units: int, *,
                 speeds: Optional[Sequence[float]] = None,
                 chunks_per_unit: int = 8,
                 chunk_items: Optional[int] = None,
                 granularity: int = 1):
        super().__init__(total, num_units, granularity=granularity)
        if speeds is None:
            speeds = [1.0] * num_units
        if len(speeds) != num_units:
            raise ValueError("speeds length must match num_units")
        if any(s <= 0 for s in speeds):
            raise ValueError("speeds must be positive")
        if chunks_per_unit <= 0:
            raise ValueError("chunks_per_unit must be positive")
        if chunk_items is not None and chunk_items <= 0:
            raise ValueError("chunk_items must be positive")
        self.speeds = [float(s) for s in speeds]
        self.steals = 0
        bounds = static_bounds(total, self.speeds, granularity)
        self._deques: list[collections.deque[Range]] = []
        self._load = [0] * num_units        # un-issued items per deque
        self._chunk_hint = granularity
        for i in range(num_units):
            lo, hi = bounds[i], bounds[i + 1]
            dq: collections.deque[Range] = collections.deque()
            if hi > lo:
                step = (chunk_items if chunk_items is not None
                        else max(1, math.ceil((hi - lo) / chunks_per_unit)))
                step = _align_up(step, granularity)
                self._chunk_hint = max(self._chunk_hint, step)
                for off in range(lo, hi, step):
                    dq.append(Range(off, min(step, hi - off)))
            self._deques.append(dq)
            self._load[i] = hi - lo

    def _package_size(self, unit: int) -> int:  # pragma: no cover - unused
        dq = self._deques[unit]
        return dq[0].size if dq else 0

    def quantum_hint(self) -> int:
        """The seed chunk size (steals move chunks, never resize them)."""
        return self._chunk_hint

    def _steal_into(self, unit: int) -> None:
        victim = max((j for j in range(self.num_units) if j != unit),
                     key=lambda j: self._load[j], default=None)
        if victim is None or self._load[victim] == 0:
            return
        vq = self._deques[victim]
        take = (len(vq) + 1) // 2
        stolen = [vq.pop() for _ in range(take)]
        moved = sum(r.size for r in stolen)
        self._load[victim] -= moved
        self._load[unit] += moved
        # re-reverse so the thief also serves its loot in ascending order
        self._deques[unit].extend(reversed(stolen))
        self.steals += 1

    def next_package(self, unit: int,
                     max_items: Optional[int] = None) -> Optional[Package]:
        """Pop the unit's next chunk, stealing first if its deque is dry.

        Args:
            unit: Coexecution Unit index requesting work.
            max_items: optional preemption cap — a larger front chunk is
                split, its remainder staying at the front of this unit's
                deque (locality preserved; only capped pulls ever split,
                so the uncapped package count stays seed-deterministic).

        Returns:
            The next chunk as a package, or ``None`` only when every
            deque in the system is empty.
        """
        dq = self._deques[unit]
        if not dq:
            self._steal_into(unit)
        if not dq:
            return None
        rng = dq.popleft()
        take = self._cap_size(rng.size, max_items)
        if take < rng.size:
            dq.appendleft(Range(rng.offset + take, rng.size - take))
            rng = Range(rng.offset, take)
        self._load[unit] -= rng.size
        pkg = Package(rng=rng, seq=self._seq, unit=unit)
        self._seq += 1
        self._cursor += rng.size
        self.issued.append(pkg)
        return pkg

    def unit_lost(self, unit: int) -> list[Range]:
        """Drain the dead unit's deque; its chunks go to the re-issue queue.

        Survivors can no longer steal from it (load drops to zero), and
        the released chunks keep their seed boundaries, so the total
        package count stays deterministic across the disturbance.
        """
        if unit >= len(self._deques):
            return []
        dq = self._deques[unit]
        freed = list(dq)
        dq.clear()
        moved = sum(r.size for r in freed)
        self._load[unit] = 0
        self._cursor += moved
        return freed

    def unit_joined(self, unit: int, speed: Optional[float] = None) -> None:
        """A late joiner starts empty and steals its first chunks."""
        super().unit_joined(unit, speed)
        while len(self._deques) < self.num_units:
            self._deques.append(collections.deque())
            self._load.append(0)
            self.speeds.append(float(speed) if speed and speed > 0 else
                               sum(self.speeds) / len(self.speeds))


# ---------------------------------------------------------------------------
# Registration with the repro_torch.api plugin registry
# ---------------------------------------------------------------------------
# The built-in policies register by name like any third-party plugin would:
# the registry (not an if-chain here) is the single policy selection point,
# and each registration declares exactly the option fields its constructor
# accepts so misspelled options fail with a ValueError naming the key.

def _dyn_shorthand(key: str) -> Optional[dict]:
    """``dynN`` → Dynamic with N packages (``dyn5``/``dyn200`` of §5)."""
    if key.startswith("dyn") and key != "dynamic" and key[3:].isdigit():
        return {"num_packages": int(key[3:])}
    return None


def _register_builtin_policies() -> None:
    """Idempotently register the paper's four policies (import side)."""
    from repro_torch.api.registry import register_scheduler

    register_scheduler("static", StaticScheduler, fields=("speeds",),
                       speed_hint=True, overwrite=True)
    register_scheduler("dynamic", DynamicScheduler,
                       fields=("num_packages",),
                       shorthand=_dyn_shorthand, overwrite=True)
    register_scheduler("hguided", HGuidedScheduler,
                       fields=("speeds", "divisor", "min_package"),
                       speed_hint=True, overwrite=True)
    register_scheduler("work_stealing", WorkStealingScheduler,
                       fields=("speeds", "chunks_per_unit", "chunk_items"),
                       speed_hint=True, overwrite=True)


_register_builtin_policies()

# policies whose constructor takes a `speeds` hint (the paper's dist(0.35)).
# Kept as a constant for backward compatibility; the registry is the source
# of truth (repro_torch.api.speed_hint_policies()).
SPEED_HINT_POLICIES = ("static", "hguided", "work_stealing")
