"""Elastic cluster tier: a runtime-resizable unit pool with exact recovery.

The paper's Coexecutor Runtime fixes its device set for the life of a
kernel. This module grows past that — the ROADMAP's "elastic scale-out"
item — by treating pool membership as a runtime property of the shared
:class:`~repro_torch.core.exec.ExecutionLoop`:

* :class:`UnitPool` — provisioned Coexecution Unit slots that
  ``grow``/``shrink``/``drain`` at runtime (dormant slots are simply dead
  units that revive cheaply);
* :class:`Autoscaler` — watches admission queue depth and resizes the
  pool with hysteresis (separate up/down thresholds), sustain/idle
  windows and a cooldown, so bursts scale out and lulls scale in without
  thrash;
* :class:`Supervisor` — heartbeat-based failure detection with a grace
  window, straggler flagging against the pool's typical package service
  time, scripted failure injection via :class:`FailurePlan`, and
  speed-share bookkeeping using the renormalizing drop/grant moves the
  reference's ``hetero/rebalance.py`` models
  (:func:`absorb_share`/:func:`grant_share`);
* :class:`ClusterSimBackend` — DES substrate where failures and joins
  are scripted events on the virtual clock, so a 1000-unit pool is
  deterministically testable;
* :class:`ClusterRealBackend` — the thread-backed twin for small pools
  (the engine's ``RealBackend``, which drops a dead unit's dispatches),
  driven in lockstep by :func:`replay_cluster_lockstep` for structural
  parity pinning (same style as the traffic lockstep harness).

Recovery is **exact-once** by construction: the loop's per-package
ownership ledger disowns a dead unit's in-flight packages (a zombie
completion is dropped), their exact :class:`~repro_torch.core.package.Range`\\ s
re-emit to survivors, and per-unit scheduler reservations (static
regions, work-stealing deques) are harvested so nothing strands. A
recovered launch's package cover — and therefore its results — is
bitwise-identical to an undisturbed run, and per-launch counters balance
exactly because the lost attempt is never charged.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import json
import pathlib
from typing import Callable, Optional, Sequence

from .admission import AdmissionConfig
from .engine import RealBackend
from .exec import ExecutionLoop, LaunchState
from .memory import MemoryCosts, MemoryModel
from .package import Package
from .scheduler import DynamicScheduler
from .sim import SimBackend, Workload, _SimLaunchState
from .traffic import (Trace, _percentile_ms, _resolve_config,
                      capacity_items_per_s)
from .units import SimUnit

__all__ = [
    "Autoscaler", "ClusterRealBackend", "ClusterReplay", "ClusterSimBackend",
    "FailurePlan", "InjectedFailure", "PLAN_VERSION", "Supervisor",
    "UnitPool", "absorb_share", "grant_share", "replay_cluster_lockstep",
    "replay_trace_cluster",
]

PLAN_VERSION = 1


class InjectedFailure(RuntimeError):
    """Deterministic failure raised/applied by a :class:`FailurePlan`."""


# ---------------------------------------------------------------------------
# Share bookkeeping (the reference's hetero/rebalance.py moves)
# ---------------------------------------------------------------------------

def absorb_share(shares: dict[str, float], name: str) -> dict[str, float]:
    """Remove one member's share and renormalize the survivors.

    The pure form of the reference's ``RebalancePolicy.drop_group``:
    the departed member's share is redistributed proportionally, so the
    survivors keep their relative ratios and the total returns to 1.

    Args:
        shares: normalized share per member name.
        name: the departing member (absent names are a no-op).

    Returns:
        A fresh normalized share dict without ``name``.
    """
    out = {k: float(v) for k, v in shares.items() if k != name}
    tot = sum(out.values())
    if tot > 0:
        out = {k: v / tot for k, v in out.items()}
    return out


def grant_share(shares: dict[str, float], name: str,
                hint_share: float) -> dict[str, float]:
    """Grant a newcomer ``hint_share``, scaling incumbents proportionally.

    The pure form of the reference's ``RebalancePolicy.add_group``: every
    incumbent keeps its relative ratio inside the remaining
    ``1 - hint_share`` of the pool.

    Args:
        shares: normalized share per member name.
        name: the joining member.
        hint_share: the newcomer's share in ``(0, 1]``.

    Returns:
        A fresh normalized share dict including ``name``.
    """
    if not 0.0 < hint_share <= 1.0:
        raise ValueError(f"hint share must be in (0, 1], got {hint_share}")
    scale = 1.0 - hint_share
    out = {k: float(v) * scale for k, v in shares.items()}
    out[name] = float(hint_share)
    return out


# ---------------------------------------------------------------------------
# FailurePlan: reproducible failure scenarios as artifacts
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FailurePlan:
    """Scripted failures, as a reproducible JSON artifact.

    Two keyings coexist because two consumers do:

    * ``events`` — *step*-keyed actions for a training supervisor (the
      reference's ``ft`` package; carried so plans round-trip whole):
      ``"crash"`` raises :class:`InjectedFailure` once,
      ``"kill:<group>"`` removes a device group.
    * ``timeline`` — *time*-keyed ``(t_seconds, action)`` pairs for the
      serving cluster: ``"kill:<unit>"`` fails a Coexecution Unit at
      virtual time ``t``, ``"join:<unit>"`` brings one (back) in. The
      unit token is an index or a unit name.

    JSON round trips mirror :class:`~repro_torch.core.traffic.Trace`:
    :meth:`to_json`/:meth:`from_json` are lossless and
    :meth:`save`/:meth:`load` make a scenario a committed artifact.
    """

    events: dict[int, str] = dataclasses.field(default_factory=dict)
    timeline: tuple[tuple[float, str], ...] = ()

    def __post_init__(self) -> None:
        self.timeline = tuple((float(t), str(a)) for t, a in self.timeline)

    def check(self, step: int) -> Optional[str]:
        """The training-loop action scheduled for ``step`` (or None)."""
        return self.events.get(step)

    def validate(self) -> "FailurePlan":
        """Raise ValueError on malformed actions or negative times."""
        for t, action in self.timeline:
            kind, _, token = action.partition(":")
            if t < 0:
                raise ValueError(f"negative plan time {t}")
            if kind not in ("kill", "join") or not token:
                raise ValueError(f"unknown plan action {action!r} "
                                 "(want kill:<unit> or join:<unit>)")
        return self

    # -- JSON round trip (Trace.save/Trace.load style) ----------------------
    def to_dict(self) -> dict:
        """Lossless plain-dict form (versioned, JSON-serializable)."""
        return {
            "version": PLAN_VERSION,
            "events": {str(k): str(v)
                       for k, v in sorted(self.events.items())},
            "timeline": [[t, a] for t, a in self.timeline],
        }

    @classmethod
    def from_dict(cls, data: dict) -> "FailurePlan":
        """Inverse of :meth:`to_dict`; validates version and actions."""
        version = data.get("version")
        if version != PLAN_VERSION:
            raise ValueError(f"unsupported failure-plan version {version!r} "
                             f"(this build reads {PLAN_VERSION})")
        events = {int(k): str(v) for k, v in data.get("events", {}).items()}
        timeline = tuple((float(t), str(a))
                         for t, a in data.get("timeline", []))
        return cls(events=events, timeline=timeline).validate()

    def to_json(self, indent: Optional[int] = None) -> str:
        """Serialize :meth:`to_dict` as stable-key JSON text."""
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "FailurePlan":
        """Inverse of :meth:`to_json`."""
        return cls.from_dict(json.loads(text))

    def save(self, path) -> None:
        """Write the plan as pretty-printed JSON (committed-artifact form)."""
        pathlib.Path(path).write_text(self.to_json(indent=2) + "\n")

    @classmethod
    def load(cls, path) -> "FailurePlan":
        """Read a plan previously written by :meth:`save`.

        Args:
            path: JSON file written by :meth:`save`.

        Returns:
            The validated plan.
        """
        return cls.from_json(pathlib.Path(path).read_text())


def _resolve_unit(token: str, names: Sequence[str]) -> int:
    """A plan's unit token (index or name) → unit index."""
    if token.lstrip("-").isdigit():
        unit = int(token)
    else:
        try:
            unit = list(names).index(token)
        except ValueError:
            raise ValueError(f"unknown unit {token!r} "
                             f"(pool: {list(names)})") from None
    if not 0 <= unit < len(names):
        raise ValueError(f"unit index {unit} outside the provisioned "
                         f"pool of {len(names)}")
    return unit


# ---------------------------------------------------------------------------
# Supervisor: failure detection, straggler flagging, share bookkeeping
# ---------------------------------------------------------------------------

class Supervisor:
    """Failure detector and recovery orchestrator over one execution loop.

    Carries the reference's ``ft/supervisor.py`` ideas over to serving:
    scripted :class:`FailurePlan` injection, heartbeat-based detection
    (a unit whose last beat is older than ``grace_s`` is declared dead),
    and straggler flagging (a package outstanding for more than
    ``straggler_factor`` times the pool's EWMA package service time).
    Death routes through :meth:`ExecutionLoop.unit_lost`, which performs
    the exact-once package re-issue; the supervisor adds the *policy*
    layer (when to declare death) plus the speed-share bookkeeping the
    reference's ``hetero/rebalance.py`` models.
    """

    def __init__(self, loop: ExecutionLoop, *, heartbeat_s: float = 0.05,
                 grace_s: float = 0.2, straggler_factor: float = 4.0,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        """Build a supervisor.

        Args:
            loop: the execution loop whose pool this supervises.
            heartbeat_s: expected beat interval (drives check cadence).
            grace_s: silence beyond this declares a unit dead.
            straggler_factor: outstanding-age multiple of the EWMA
                package service time that flags a straggler.
            on_straggler: optional ``(unit, age_s)`` callback per flag.
        """
        if grace_s <= 0 or heartbeat_s <= 0:
            raise ValueError("heartbeat and grace intervals must be positive")
        self.loop = loop
        self.heartbeat_s = float(heartbeat_s)
        self.grace_s = float(grace_s)
        self.straggler_factor = float(straggler_factor)
        self.on_straggler = on_straggler
        self._beats: dict[int, float] = {}  # guarded-by: caller
        self._speed: dict[int, float] = {}  # guarded-by: caller
        self._service_ema: Optional[float] = None  # guarded-by: caller
        self._flagged: set[tuple[int, float]] = set()  # guarded-by: caller
        self.shares: dict[str, float] = {}  # guarded-by: caller
        self.kills: list[tuple[float, int]] = []
        self.joins: list[tuple[float, int]] = []
        self.leaves: list[tuple[float, int]] = []
        self.stragglers: list[tuple[float, int]] = []

    # -- membership ---------------------------------------------------------
    def register(self, unit: int, speed: float = 1.0, *,
                 t: float = 0.0) -> None:
        """Start supervising one live unit (grants it a speed share)."""
        self._beats[unit] = float(t)
        self._speed[unit] = float(speed)
        tot = sum(self._speed.values())
        self.shares = grant_share(self.shares, self.loop.unit_names[unit],
                                  float(speed) / tot)

    def fail_unit(self, unit: int, t: float = 0.0) -> int:
        """Declare one unit dead; its work re-issues to survivors.

        Returns:
            Number of ranges :meth:`ExecutionLoop.unit_lost` queued.
        """
        moved = self.loop.unit_lost(unit)
        self._absorb(unit)
        self.kills.append((float(t), unit))
        return moved

    def retire_unit(self, unit: int, t: float = 0.0) -> None:
        """Gracefully remove a drained unit (scale-in, not a failure)."""
        if self.loop.in_flight_of(unit):
            raise ValueError(f"unit {unit} still owns in-flight packages")
        self.loop.unit_lost(unit)
        self._absorb(unit)
        self.leaves.append((float(t), unit))

    def join_unit(self, unit: int, t: float = 0.0, *,
                  speed: float = 1.0, name: Optional[str] = None) -> None:
        """Bring a unit (back) into the pool and grant it a share."""
        self.loop.unit_joined(unit, name=name, speed=speed)
        self.register(unit, speed, t=t)
        self.joins.append((float(t), unit))

    def _absorb(self, unit: int) -> None:
        self._beats.pop(unit, None)
        self._speed.pop(unit, None)
        self.shares = absorb_share(self.shares, self.loop.unit_names[unit])

    # -- detection ----------------------------------------------------------
    def beat(self, unit: int, t: float) -> None:
        """Record a liveness beat (monotone per unit)."""
        if unit in self._beats:
            self._beats[unit] = max(self._beats[unit], float(t))

    def check(self, t: float) -> list[int]:
        """Declare units silent for longer than ``grace_s`` dead.

        Args:
            t: Current backend time in seconds.

        Returns:
            The unit indices failed by this check, in index order.
        """
        stale = sorted(u for u, b in self._beats.items()
                       if t - b > self.grace_s
                       and u not in self.loop.dead_units)
        for u in stale:
            self.fail_unit(u, t)
        return stale

    def note_service(self, seconds: float) -> None:
        """Feed one package's issue-to-complete time into the EWMA."""
        if seconds <= 0:
            return
        self._service_ema = (seconds if self._service_ema is None
                             else 0.8 * self._service_ema + 0.2 * seconds)

    def flag_stragglers(self, t: float) -> list[int]:
        """Flag units whose oldest in-flight package is suspiciously old.

        A straggler is flagged once per incident (per outstanding issue
        time); it is *not* killed — that stays a policy decision for the
        caller (or the heartbeat check, if the unit also goes silent).
        """
        ref = (self._service_ema if self._service_ema is not None
               else self.grace_s)
        out = []
        for u in sorted(self._beats):
            if u in self.loop.dead_units:
                continue
            t0 = self.loop.oldest_issue(u)
            if t0 is None or (t - t0) <= self.straggler_factor * ref:
                continue
            key = (u, t0)
            if key in self._flagged:
                continue
            self._flagged.add(key)
            self.stragglers.append((float(t), u))
            out.append(u)
            if self.on_straggler is not None:
                self.on_straggler(u, t - t0)
        return out


# ---------------------------------------------------------------------------
# UnitPool + Autoscaler
# ---------------------------------------------------------------------------

class UnitPool:
    """Runtime-resizable set of Coexecution Units over one execution loop.

    The pool is *provisioned* at its maximum size (every slot has a unit
    name, a backend lane and — on the real backend — a worker thread) and
    *activates* a subset: a dormant slot is simply a dead unit index, so
    ``grow`` is a revival and ``shrink``/``drain`` a graceful loss. This
    keeps both backends structurally identical across resizes — no
    arrays ever reallocate mid-run — which is what makes elastic runs
    lockstep-comparable between the DES and the threaded engine.
    """

    def __init__(self, loop: ExecutionLoop, *, min_units: int = 1,
                 max_units: Optional[int] = None,
                 supervisor: Optional[Supervisor] = None,
                 speeds: Optional[Sequence[float]] = None):
        """Provision the pool and park slots above the floor.

        Args:
            loop: the execution loop; must already name ``max_units``
                units (the provisioned slots).
            min_units: slots active at start and the scale-in floor.
            max_units: provisioned ceiling; defaults to the loop's unit
                count and must equal it.
            supervisor: optional supervisor kept in sync on every
                membership change.
            speeds: per-slot relative speed hints (shares, scheduler
                hints for late joiners).
        """
        total = len(loop.unit_names)
        self.max_units = total if max_units is None else int(max_units)
        if self.max_units != total:
            raise ValueError(
                f"pool must be provisioned at max_units: loop has {total} "
                f"unit slots, max_units={self.max_units}")
        self.min_units = int(min_units)
        if not 1 <= self.min_units <= self.max_units:
            raise ValueError(f"need 1 <= min_units <= max_units, got "
                             f"{self.min_units}..{self.max_units}")
        self.loop = loop
        self.supervisor = supervisor
        self.speeds = (list(speeds) if speeds is not None  # guarded-by: caller
                       else [1.0] * total)
        if len(self.speeds) != total:
            raise ValueError("speeds length must match the provisioned pool")
        for u in range(self.min_units, total):
            loop.unit_lost(u)       # dormant: provisioned but not joined
        if supervisor is not None:
            for u in range(self.min_units):
                supervisor.register(u, self.speeds[u])

    @property
    def alive(self) -> list[int]:
        """Active unit indices, ascending."""
        return [i for i in range(self.max_units)
                if i not in self.loop.dead_units]

    @property
    def size(self) -> int:
        """Number of active units."""
        return self.max_units - len(self.loop.dead_units)

    def grow(self, n: int = 1, *, now: float = 0.0) -> list[int]:
        """Activate up to ``n`` dormant slots (lowest indices first).

        Args:
            n: Maximum number of slots to activate.
            now: Backend time stamped on the join events.

        Returns:
            The indices actually activated (may be fewer than ``n``).
        """
        grown = []
        for _ in range(max(n, 0)):
            if self.size >= self.max_units:
                break
            u = min(self.loop.dead_units)
            if self.supervisor is not None:
                self.supervisor.join_unit(u, now, speed=self.speeds[u])
            else:
                self.loop.unit_joined(u, speed=self.speeds[u])
            grown.append(u)
        return grown

    def drain(self, unit: int, *, now: float = 0.0) -> bool:
        """Gracefully retire one idle unit.

        Refuses while the unit still owns in-flight packages — drain is
        for scale-in, where nothing may be lost or re-issued; a unit that
        must leave *now* regardless is a failure
        (:meth:`Supervisor.fail_unit`).

        Args:
            unit: Index of the unit to retire.
            now: Backend time stamped on the leave event.

        Returns:
            ``True`` when the unit left, ``False`` when it still holds
            in-flight work (call again once it drains).
        """
        if unit in self.loop.dead_units:
            return True
        if self.loop.in_flight_of(unit):
            return False
        if self.supervisor is not None:
            self.supervisor.retire_unit(unit, now)
        else:
            self.loop.unit_lost(unit)
        return True

    def shrink(self, n: int = 1, *, now: float = 0.0) -> list[int]:
        """Retire up to ``n`` idle units (highest indices first).

        Respects the ``min_units`` floor and skips units with in-flight
        work, so a shrink can be partial; the autoscaler simply retries
        on a later tick.

        Returns:
            The indices actually retired.
        """
        shrunk = []
        for u in reversed(self.alive):
            if len(shrunk) >= max(n, 0) or self.size <= self.min_units:
                break
            if self.loop.in_flight_of(u):
                continue
            if self.drain(u, now=now):
                shrunk.append(u)
        return shrunk


class Autoscaler:
    """Queue-depth autoscaling with hysteresis, sustain windows, cooldown.

    Scale-out requires the admission depth to sit at or above
    ``scale_up_depth`` for ``sustain_s`` straight; scale-in requires it
    at or below ``scale_down_depth`` for ``idle_s``. The two thresholds
    form the hysteresis band (depths between them hold the pool steady),
    and ``cooldown_s`` separates consecutive resizes so a burst cannot
    thrash the pool.
    """

    def __init__(self, pool: UnitPool, *, scale_up_depth: int = 8,
                 scale_down_depth: int = 1, sustain_s: float = 0.1,
                 idle_s: float = 0.5, cooldown_s: float = 0.25,
                 step: int = 1):
        if scale_down_depth >= scale_up_depth:
            raise ValueError("hysteresis needs scale_down_depth < "
                             "scale_up_depth")
        if step <= 0:
            raise ValueError("step must be positive")
        self.pool = pool
        self.scale_up_depth = int(scale_up_depth)
        self.scale_down_depth = int(scale_down_depth)
        self.sustain_s = float(sustain_s)
        self.idle_s = float(idle_s)
        self.cooldown_s = float(cooldown_s)
        self.step = int(step)
        self._over_since: Optional[float] = None  # guarded-by: caller
        self._under_since: Optional[float] = None  # guarded-by: caller
        self._last_resize: Optional[float] = None  # guarded-by: caller
        self.actions: list[tuple[float, int]] = []   # (t, signed delta)

    def _cooled(self, t: float) -> bool:
        return (self._last_resize is None
                or t - self._last_resize >= self.cooldown_s)

    def observe(self, t: float, depth: int) -> int:
        """Feed one (time, queue-depth) sample; maybe resize the pool.

        Args:
            t: sample time (the caller's clock — virtual or wall).
            depth: admission queue depth (admitted-but-unfinished
                launches).

        Returns:
            The signed unit-count change actually performed (0 mostly).
        """
        if depth >= self.scale_up_depth:
            self._under_since = None
            if self._over_since is None:
                self._over_since = t
            if (t - self._over_since >= self.sustain_s and self._cooled(t)
                    and self.pool.size < self.pool.max_units):
                grown = self.pool.grow(self.step, now=t)
                if grown:
                    self._last_resize = t
                    self._over_since = None
                    self.actions.append((t, len(grown)))
                    return len(grown)
        elif depth <= self.scale_down_depth:
            self._over_since = None
            if self._under_since is None:
                self._under_since = t
            if (t - self._under_since >= self.idle_s and self._cooled(t)
                    and self.pool.size > self.pool.min_units):
                shrunk = self.pool.shrink(self.step, now=t)
                if shrunk:
                    self._last_resize = t
                    self._under_since = None
                    self.actions.append((t, -len(shrunk)))
                    return -len(shrunk)
        else:
            self._over_since = None
            self._under_since = None
        return 0


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

class ClusterSimBackend(SimBackend):
    """DES substrate for an elastic pool: scripted deaths, deterministic.

    Extends :class:`~repro_torch.core.sim.SimBackend` with a cluster event
    pump (:meth:`run`): a :class:`FailurePlan` timeline injects
    ``kill``/``join`` events on the virtual clock, an optional
    :class:`Autoscaler` resizes the pool on queue depth, and an optional
    :class:`Supervisor` keeps share/liveness bookkeeping.

    Death semantics: a package whose modeled compute would end *after*
    its unit's scripted death is the one in flight when the unit dies.
    It is held un-dispatched (nothing charged — exactly like the real
    backend, where the doomed dispatch never executes) until the kill
    event harvests it through :meth:`ExecutionLoop.unit_lost`, after
    which survivors re-compute the identical range. A package whose
    compute ends before the death completes normally.
    """

    def __init__(self, units: Sequence[SimUnit], memory: MemoryModel,
                 costs: MemoryCosts, *, pipeline_depth: int = 1):
        super().__init__(units, memory, costs,
                         pipeline_depth=pipeline_depth)
        self.kills: list[tuple[float, int]] = []
        self.joins: list[tuple[float, int]] = []
        self.scale_events: list[tuple[float, int]] = []  # (t, new size)
        self._kill_at: dict[int, collections.deque[float]] = {}  # guarded-by: caller
        # packages held in flight on a unit that dies before finishing
        # them — up to pipeline_depth per unit, issue order preserved
        self._doomed: dict[int, list[tuple[_SimLaunchState, Package]]] = {}  # guarded-by: caller

    def _doomed_full(self, unit: int) -> bool:
        """Whether the unit's in-flight pipeline is saturated with doomed
        packages (it must stop pulling until its scripted kill fires)."""
        return len(self._doomed.get(unit, ())) >= self.pipeline_depth

    def run(self, loop: ExecutionLoop,                      # type: ignore[override]
            entries: Sequence[_SimLaunchState], *,
            plan: Optional[FailurePlan] = None,
            supervisor: Optional[Supervisor] = None,
            autoscaler: Optional[Autoscaler] = None) -> None:
        """Advance virtual time until every admitted launch settles.

        Control events (kills/joins) sort before unit pulls at the same
        instant, so a unit declared dead at ``t`` cannot pull at ``t``.

        Args:
            loop: the shared control plane built over this backend.
            entries: launches to admit, each at its ``t_submit``.
            plan: scripted failure timeline (``kill:<u>``/``join:<u>``).
            supervisor: records membership changes and service beats.
            autoscaler: resizes the pool from admission queue depth.
        """
        names = [u.name for u in self.units]
        tie = itertools.count()
        evq: list[tuple[float, int, int, str, int]] = []
        self._kill_at = {}
        self._doomed = {}
        if plan is not None:
            for t, action in sorted(plan.validate().timeline):
                heapq.heappush(evq, (float(t), 0, next(tie), action, -1))
                kind, _, token = action.partition(":")
                if kind == "kill":
                    u = _resolve_unit(token, names)
                    self._kill_at.setdefault(
                        u, collections.deque()).append(float(t))
        pending = collections.deque(sorted(entries,
                                           key=lambda e: e.t_submit))
        parked: set[int] = set()    # units that found no work last pull
        for i, u in enumerate(self.units):
            if i not in loop.dead_units:
                heapq.heappush(evq, (u.setup_s, 1, next(tie), "idle", i))

        def wake_all(t: float) -> None:
            parked.clear()
            for j in range(len(self.units)):
                if j not in loop.dead_units and not self._doomed_full(j):
                    heapq.heappush(evq, (t + 1e-9, 1, next(tie), "idle", j))

        while evq:
            t, _, _, kind, i = heapq.heappop(evq)
            self.t = t
            while pending and pending[0].t_submit <= t + 1e-12:
                entry = pending.popleft()
                if not loop.offer(entry, now=entry.t_submit):
                    self.shed.append(entry)
            if autoscaler is not None:
                if autoscaler.observe(t, loop.admission.in_flight):
                    self.scale_events.append((t, autoscaler.pool.size))
                    wake_all(t)
            if kind != "idle":
                akind, _, token = kind.partition(":")
                u = _resolve_unit(token, names)
                if akind == "kill":
                    if supervisor is not None:
                        supervisor.fail_unit(u, t)
                    else:
                        loop.unit_lost(u)
                    self._doomed.pop(u, None)
                    dq = self._kill_at.get(u)
                    if dq:
                        dq.popleft()
                    self.kills.append((t, u))
                    wake_all(t)
                else:           # join
                    if supervisor is not None:
                        supervisor.join_unit(u, t, speed=self.units[u].speed)
                    else:
                        loop.unit_joined(u, speed=self.units[u].speed)
                    self.joins.append((t, u))
                    heapq.heappush(evq, (t + self.units[u].setup_s, 1,
                                         next(tie), "idle", u))
                if supervisor is not None:
                    supervisor.flag_stragglers(t)
                continue
            if i in loop.dead_units or self._doomed_full(i):
                continue
            parked.discard(i)
            work = loop.pull(i, now=t, force_flush=not pending)
            if work is None:
                # Park, but stay wakeable: the next arrival or fusion
                # ripening re-arms us directly, and *any* completion on
                # another unit notifies the parked set below — the DES
                # equivalent of the engine's condition-variable
                # ``notify_all``, without which the drain phase after the
                # last arrival degrades toward a single serving unit
                # (policies with bounded pull windows return ``None``
                # transiently near each launch boundary).
                parked.add(i)
                wake = pending[0].t_submit if pending else None
                ripen = loop.admission.next_ripen_in(t)
                if ripen is not None:
                    t_r = t + max(ripen, 1e-9)
                    wake = t_r if wake is None else min(wake, t_r)
                if wake is not None:
                    heapq.heappush(evq, (max(wake, t + 1e-9), 1,
                                         next(tie), "idle", i))
                continue
            entry, pkg = work
            kills = self._kill_at.get(i)
            if kills:
                _, _, compute_end = self._model_compute(i, entry, pkg)
                # in-order per-unit completion: once one in-flight
                # package runs past the kill, everything pulled behind
                # it is lost with the unit too
                if i in self._doomed or compute_end >= kills[0] - 1e-12:
                    # dies mid-package: hold the attempt in flight,
                    # uncharged; the kill event harvests it for re-issue
                    self._doomed.setdefault(i, []).append((entry, pkg))
                    if not self._doomed_full(i):
                        # a pipelined unit keeps pulling until its
                        # in-flight window is saturated
                        heapq.heappush(evq, (t + 1e-9, 1, next(tie),
                                             "idle", i))
                    continue
            self.dispatch(i, entry, pkg)
            loop.complete(entry, pkg)
            if supervisor is not None:
                supervisor.beat(i, pkg.t_complete)
                supervisor.note_service(pkg.t_complete - pkg.t_issue)
            # re-arm on the serial clock (busy_until), not the recorded
            # pipelined completion — keeps pull pacing depth-invariant
            heapq.heappush(evq, (self.busy_until[i], 1, next(tie),
                                 "idle", i))
            if parked:
                # a completion may unblock work for parked units (launch
                # finalization frees the policy's pull window)
                for j in sorted(parked):
                    if j not in loop.dead_units and not self._doomed_full(j):
                        heapq.heappush(evq, (self.busy_until[i] + 1e-9, 1,
                                             next(tie), "idle", j))
                parked.clear()

        if not loop.drained():
            raise RuntimeError(
                "cluster simulation wedged: work remains but no live unit "
                "can serve it (did the plan kill the whole pool?)")


#: Thread-backed substrate with pool membership. The engine's
#: :class:`~repro_torch.core.engine.RealBackend` already drops a dispatch
#: pulled by a unit that was declared dead afterwards (the package was
#: disowned and its range re-issued, so running it would double-compute;
#: the loop's ledger drops the zombie completion), once its ``loop``
#: attribute points at the :class:`ExecutionLoop`. The cluster tier uses
#: it under the reference's name.
ClusterRealBackend = RealBackend


# ---------------------------------------------------------------------------
# Replay harnesses
# ---------------------------------------------------------------------------

def replay_cluster_lockstep(trace: Trace, loop: ExecutionLoop, make_launch, *,
                            events: Sequence[tuple[int, str]] = (),
                            max_sweeps: int = 1_000_000):
    """Deterministic shared harness for cluster parity tests.

    Replays a trace arrival by arrival on *any* backend with an
    identical pull/kill/join interleaving, so the decision log, package
    sequences and counter totals of the real engine and the DES can be
    compared structurally (the cluster twin of the traffic module's
    ``replay_trace_lockstep``).

    A ``kill`` is applied with work genuinely in flight: the harness
    pulls one package per live unit and *holds* them, declares the
    victim dead (harvesting its held package for re-issue), then
    dispatches only the survivors' held packages. Both backends thus
    agree bit-for-bit on which attempt was lost.

    Args:
        trace: the arrival sequence to replay.
        loop: an :class:`ExecutionLoop` over the backend under test.
        make_launch: ``(arrival, loop) -> LaunchState`` payload factory.
        events: ``(arrival_index, action)`` pairs — the action
            (``kill:<u>``/``leave:<u>``/``join:<u>``) is applied right
            after that arrival is offered.
        max_sweeps: drain-phase safety bound.

    Returns:
        ``(admitted, shed)`` launch lists, in arrival order.
    """
    backend = loop.backend
    names = list(loop.unit_names)
    n = len(names)
    admitted: list[LaunchState] = []
    shed: list[LaunchState] = []
    ev_of: dict[int, list[str]] = {}
    for idx, action in events:
        ev_of.setdefault(int(idx), []).append(str(action))

    def sweep(now: float, force: bool) -> bool:
        progressed = False
        for u in range(n):
            work = loop.pull(u, now=now, force_flush=force)
            if work is None:
                continue
            launch, pkg = work
            backend.dispatch(u, launch, pkg)
            loop.complete(launch, pkg)
            progressed = True
        return progressed

    def apply(action: str, now: float) -> None:
        akind, _, token = action.partition(":")
        u = _resolve_unit(token, names)
        if akind == "kill":
            held = []
            for j in range(n):
                if j in loop.dead_units:
                    continue
                w = loop.pull(j, now=now)
                if w is not None:
                    held.append((j, w))
            loop.unit_lost(u)
            for j, (launch, pkg) in held:
                if j == u:
                    continue    # the lost attempt: harvested, never run
                backend.dispatch(j, launch, pkg)
                loop.complete(launch, pkg)
        elif akind == "leave":
            # graceful scale-in: the unit leaves idle, nothing in flight
            # to disown (only scheduler reservations get harvested)
            loop.unit_lost(u)
        elif akind == "join":
            loop.unit_joined(u)
        else:
            raise ValueError(f"unknown lockstep action {action!r}")

    for idx, a in enumerate(trace.arrivals):
        launch = make_launch(a, loop)
        launch.t_submit = a.t
        if launch.deadline is None and a.slo_ms is not None:
            launch.deadline = a.t + a.slo_ms / 1e3
        if loop.offer(launch, now=a.t):
            admitted.append(launch)
        else:
            shed.append(launch)
        for action in ev_of.get(idx, ()):
            apply(action, a.t)
        sweep(a.t, False)

    t_end = trace.arrivals[-1].t if trace.arrivals else 0.0
    sweeps = 0
    while not loop.drained():
        progressed = sweep(t_end, True)
        sweeps += 1
        if sweeps > max_sweeps or not (progressed or loop.drained()):
            raise AssertionError(
                "cluster lockstep replay wedged: work remains but no live "
                "unit makes progress")
    return admitted, shed


@dataclasses.dataclass
class ClusterReplay:
    """Outcome of replaying one trace through the elastic cluster DES.

    ``lost``/``duplicated`` are the exact-once audit: ``lost`` counts
    arrivals that neither completed nor were shed (or failed cover
    validation), ``duplicated`` counts launches delivered more than
    once. Both must be zero for any plan — that is the tentpole's
    correctness claim, and the cluster benchmark pins it.
    """

    trace: Trace
    min_units: int
    max_units: int
    arrivals: int
    admitted: int
    shed_count: int
    completed: int
    lost: int
    duplicated: int
    reissued: int
    kills: list[tuple[float, int]]
    joins: list[tuple[float, int]]
    scale_events: list[tuple[float, int]]
    latencies_s: list[float]
    launches: list = dataclasses.field(default_factory=list, repr=False)

    def covers(self) -> dict[int, tuple[tuple[int, int], ...]]:
        """Sorted ``(offset, size)`` package cover per delivered launch id.

        The bitwise-identity audit: a run disturbed by kills must produce
        exactly the covers an undisturbed run produces.
        """
        return {e.id: tuple(sorted((p.offset, p.size)
                                   for p in e.stats.packages))
                for e in self.launches if e.stats is not None}

    def data_totals(self) -> dict[int, tuple[int, int, int, int, int]]:
        """Per-launch (dispatches, h2d, h2d_bytes, d2h, d2h_bytes) totals."""
        out = {}
        for e in self.launches:
            if e.stats is None:
                continue
            d = e.stats.data
            out[e.id] = (d.dispatches, d.h2d_copies, int(d.h2d_bytes),
                         d.d2h_copies, int(d.d2h_bytes))
        return out

    def p50_ms(self) -> float:
        """Median completed-launch latency in milliseconds."""
        return _percentile_ms(self.latencies_s, 50)

    def p99_ms(self) -> float:
        """p99 completed-launch latency in milliseconds."""
        return _percentile_ms(self.latencies_s, 99)


def replay_trace_cluster(trace: Trace, units: Sequence[SimUnit], *,
                         admission=None, spec=None, memory=None,
                         plan: Optional[FailurePlan] = None,
                         min_units: Optional[int] = None,
                         autoscale: bool = False,
                         autoscale_opts: Optional[dict] = None,
                         supervise: bool = True,
                         num_packages: int = 8,
                         granularity: int = 1) -> ClusterReplay:
    """Replay a trace through the elastic cluster tier in virtual time.

    The provisioned pool is ``units`` (its length is ``max_units``);
    ``min_units`` of them start active and the rest are dormant slots an
    :class:`Autoscaler` (when ``autoscale``) activates under sustained
    backlog. Scripted deaths/joins come from ``plan``.

    Args:
        trace: the arrival sequence to replay.
        units: provisioned simulated units (length = pool ceiling).
        admission: policy name/config/spec section (``None``: spec's).
        spec: optional ``CoexecSpec`` supplying admission/memory.
        memory: memory model override (default spec's, else USM).
        plan: scripted ``kill``/``join`` timeline.
        min_units: initially active units (default: all of them).
        autoscale: resize between ``min_units`` and the full pool on
            admission queue depth.
        autoscale_opts: :class:`Autoscaler` keyword overrides.
        supervise: keep a :class:`Supervisor` in the loop (share and
            membership bookkeeping; scripted kills route through it).
        num_packages: dynamic-scheduler packages per launch.
        granularity: package alignment in work-items.

    Returns:
        The :class:`ClusterReplay` audit + latency record.
    """
    n = len(units)
    lo = n if min_units is None else int(min_units)
    active = list(units)[:lo]
    cfg = _resolve_config(admission, spec, active)
    if memory is None:
        memory = (spec.memory_model() if spec is not None
                  else MemoryModel.USM)
    depth = int(spec.units.pipeline_depth) if spec is not None else 1
    backend = ClusterSimBackend(units, memory, MemoryCosts(),
                                pipeline_depth=depth)
    loop = ExecutionLoop(backend, [u.name for u in units], cfg)
    supervisor = Supervisor(loop) if supervise else None
    pool = UnitPool(loop, min_units=lo, supervisor=supervisor,
                    speeds=[u.speed for u in units])
    scaler = (Autoscaler(pool, **(autoscale_opts or {}))
              if autoscale else None)

    entries = []
    for a in trace.arrivals:
        wl = Workload("traffic", a.items, 8.0, 8.0, 1e4)
        sched = DynamicScheduler(a.items, n,
                                 num_packages=min(num_packages, a.items),
                                 granularity=granularity)
        entry = _SimLaunchState(loop.next_id(), sched, wl, tenant=a.tenant,
                                weight=a.weight, t_submit=a.t)
        if a.slo_ms is not None:
            entry.deadline = a.t + a.slo_ms / 1e3
        entries.append(entry)

    backend.run(loop, entries, plan=plan, supervisor=supervisor,
                autoscaler=scaler)

    delivered = backend.delivered
    seen: collections.Counter = collections.Counter(e.id for e in delivered)
    duplicated = sum(c - 1 for c in seen.values() if c > 1)
    lost = len(entries) - len(seen) - len(backend.shed)
    return ClusterReplay(
        trace=trace, min_units=lo, max_units=n,
        arrivals=len(entries),
        admitted=len(entries) - len(backend.shed),
        shed_count=len(backend.shed),
        completed=len(delivered),
        lost=lost, duplicated=duplicated,
        reissued=loop.reissued,
        kills=list(backend.kills), joins=list(backend.joins),
        scale_events=list(backend.scale_events),
        latencies_s=[e.stats.total_s for e in delivered
                     if e.stats is not None],
        launches=list(delivered))
