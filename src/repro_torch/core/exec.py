"""Shared co-execution control plane: one loop, two backends.

The paper's central claim is that one kernel and one load-balancing
policy should run unchanged across heterogeneous devices. Before this
module, the repo violated its own version of that principle: the real
engine (:mod:`repro_torch.core.engine`, worker threads + torch dispatch) and the
discrete-event simulator (:mod:`repro_torch.core.sim`, virtual clock) each
reimplemented the full Commander control loop — admission pulls,
scheduler refresh, launch-fusion staging and de-mux, finalization, and
dispatch/H2D/D2H counter attribution — so every policy had to be written
twice and parity-tested by hand.

:class:`ExecutionLoop` is the single implementation of that control
plane. A :class:`Backend` supplies only the execution substrate:

* **how time flows** — :meth:`Backend.now` is the wall clock for the
  engine's ``RealBackend`` and the virtual clock for the simulator's
  ``SimBackend``;
* **how a package runs** — :meth:`Backend.dispatch` either executes it
  through the data plane on a :class:`~repro_torch.core.units.TorchUnit` or
  models its cost on a :class:`~repro_torch.core.units.SimUnit`;
* **how a worker parks** — :meth:`Backend.wait_next_event` blocks a
  worker thread (real) or advances the event queue (sim);
* **how fused payloads materialize and results land** — the remaining
  hooks (:meth:`Backend.fuse_payload`, :meth:`Backend.deliver`, ...).

Everything policy-shaped — which launch an idle unit serves (FIFO/WFQ
via the :class:`~repro_torch.core.admission.AdmissionController`, including
preemptive pull-capping), when staged fusion groups ripen, how a fused
batch de-multiplexes to its members, when a launch finalizes, and how
data-plane counters are attributed (remainder-distributed integer shares
for fused members) — is decided *here, once*, so a new policy is a
one-place change that both substrates inherit structurally.
"""
from __future__ import annotations

import abc
import collections
import dataclasses
import itertools
from typing import Optional, Sequence

from .admission import AdmissionConfig, AdmissionController
from .dataplane import DataPlaneCounters
from .package import Package, Range, validate_cover
from .scheduler import Scheduler

__all__ = ["Backend", "ExecutionLoop", "LaunchState", "LaunchStats", "Span"]


@dataclasses.dataclass(frozen=True)
class Span:
    """One phase of a launch's life, on the clock of the package stamps.

    ``launch`` is the launch's id, ``parent`` the name of the span it
    nests in (``None`` for the root ``launch``), ``unit`` the index of
    the Coexecution Unit whose worker ran it (``None`` on a caller's
    thread) and ``counts`` ``(name, value)`` pairs measured inside it,
    such as ``("lock_wait_s", 0.002)`` where a ``plan`` or ``settle``
    took the lock over mapped host ranges, or ``("usm_copy_bytes", n)``
    on a CUDA unit's ``stage`` under USM.
    """

    name: str
    launch: Optional[int]
    parent: Optional[str]
    start: float
    end: float
    unit: Optional[int] = None
    counts: tuple = ()

    @property
    def seconds(self) -> float:
        """The span's length."""
        return self.end - self.start

    def count(self, name: str, default: Optional[float] = 0.0
              ) -> Optional[float]:
        """The value of the count ``name``, or ``default``."""
        return dict(self.counts).get(name, default)


@dataclasses.dataclass
class LaunchStats:
    """Per-launch metrics mirroring the paper's measurements.

    Produced by the shared :class:`ExecutionLoop` for *both* backends, so
    real-vs-sim counter parity is structural rather than test-enforced.
    Isolated per launch: concurrent launches on the same units each get
    their own instance (busy seconds derive from this launch's packages
    only, never from cumulative unit counters). For a launch served
    through a fused batch, ``packages`` holds one synthesized package
    covering the launch's whole index space, timed by the shared dispatch
    that computed it, and ``data`` is the member's remainder-distributed
    integer share of the batch's counters — summing member stats recovers
    the batch's real copy/dispatch totals exactly.

    ``data`` carries the launch's data-plane accounting — dispatches and
    explicit H2D/D2H staging copies/bytes — so the USM-vs-BUFFERS
    distinction of the configured :class:`~.memory.MemoryModel` is
    observable per launch (USM performs zero staging copies).

    ``launch_id`` is the launch's id (``LaunchHandle.launch_id``) and
    ``spans`` the phases the backend recorded outside the packages: the
    engine's ``plan``, ``admit`` and ``settle``; the simulator records
    none. :meth:`timeline` adds the phases the package stamps give.
    """

    total_s: float
    packages: list[Package]
    unit_busy_s: dict[str, float]
    data: DataPlaneCounters = dataclasses.field(
        default_factory=DataPlaneCounters)
    launch_id: Optional[int] = None
    spans: list[Span] = dataclasses.field(default_factory=list)

    @property
    def num_packages(self) -> int:
        """Number of packages this launch was served as."""
        return len(self.packages)

    def timeline(self) -> list[Span]:
        """The launch's whole tree of spans, the root first.

        Below the root ``launch`` (from the first span's start to the last
        one's end) come the recorded :attr:`spans`; ``queue``, from the
        launch's admission (the end of ``admit``, else ``total_s`` before
        the last collection) to its first package's issue; and for each
        package, on its unit, ``stage`` (``t_issue`` to ``t_launch``,
        with the package's ``stage_counts``), ``compute`` (to
        ``t_complete``) and ``collect`` (to ``t_collected``). The rest is
        in start order.
        """
        lid = self.launch_id
        spans = list(self.spans)
        if self.packages:
            admit = [s.end for s in self.spans if s.name == "admit"]
            end = max(p.t_collected for p in self.packages)
            submitted = admit[0] if admit else end - self.total_s
            spans.append(Span("queue", lid, "launch", submitted,
                              min(p.t_issue for p in self.packages)))
        for p in self.packages:
            spans += [Span("stage", lid, "launch", p.t_issue, p.t_launch,
                           unit=p.unit, counts=p.stage_counts),
                      Span("compute", lid, "launch", p.t_launch,
                           p.t_complete, unit=p.unit),
                      Span("collect", lid, "launch", p.t_complete,
                           p.t_collected, unit=p.unit)]
        spans.sort(key=lambda s: s.start)
        if not spans:
            return []
        root = Span("launch", lid, None, spans[0].start,
                    max(s.end for s in spans))
        return [root] + spans


class LaunchState:
    """Control-plane state of one in-flight co-execution (both backends).

    Backends subclass this with their payload — the real engine adds the
    kernel/arrays/handle, the simulator adds the modeled workload — but
    every field the :class:`ExecutionLoop` reads or writes lives here,
    which is what lets one loop implementation schedule both substrates.

    ``wfq_cost_scale`` converts scheduler units to work-items for WFQ
    credit (an engine-side fused batch schedules in members, each worth a
    whole member index space); ``member_span`` is the inverse axis: how
    many scheduler units one fused member occupies (1 for the engine's
    member-unit schedulers, the per-member item count for the
    simulator's item-unit schedulers).
    """

    __slots__ = ("id", "scheduler", "tenant", "weight", "t_submit",
                 "deadline", "fuse_key", "fuse_bucket", "slots", "members",
                 "member_span", "wfq_cost_scale", "done_pkgs", "outstanding",
                 "pending_reissue", "failed", "finalized", "fused", "stats")

    def __init__(self, launch_id: int, scheduler: Scheduler, *,
                 tenant: Optional[str] = None, weight: float = 1.0,
                 t_submit: float = 0.0):
        self.id = launch_id
        self.scheduler = scheduler
        self.tenant = tenant if tenant is not None else f"launch-{launch_id}"
        self.weight = float(weight)
        self.t_submit = t_submit
        self.deadline: Optional[float] = None   # absolute, backend clock
        self.fuse_key = None
        self.fuse_bucket: Optional[int] = None  # pad size under fuse_buckets
        self.slots = 1
        self.members: Optional[list["LaunchState"]] = None
        self.member_span = 1
        self.wfq_cost_scale = 1
        self.done_pkgs: list[Package] = []
        self.outstanding = 0          # issued but not yet collected
        self.pending_reissue = 0      # ranges queued for re-issue (unit loss)
        self.failed = False
        self.finalized = False
        self.fused = False            # served through a coalesced batch
        self.stats: Optional[LaunchStats] = None


class Backend(abc.ABC):
    """Execution substrate driven by the shared :class:`ExecutionLoop`.

    The three abstract methods are the whole substrate contract —
    wall-clock threads (``RealBackend``) and the virtual-clock DES
    (``SimBackend``) differ *only* here plus the payload hooks below.
    The loop sets :attr:`loop` to itself at construction so hooks can
    reach shared helpers (e.g. :meth:`ExecutionLoop.member_spans`).
    """

    loop: "ExecutionLoop" = None

    @abc.abstractmethod
    def now(self) -> float:
        """Current time: wall seconds (real) or virtual seconds (sim)."""

    @abc.abstractmethod
    def dispatch(self, unit: int, launch: LaunchState, pkg: Package) -> None:
        """Run or model one package on ``unit``.

        Args:
            unit: index of the Coexecution Unit serving the package.
            launch: the owning launch (payload fields are backend-typed).
            pkg: the package to execute; the backend fills its
                ``t_complete``/``t_collected`` timestamps (``t_issue`` is
                stamped by :meth:`ExecutionLoop.pull`).
        """

    @abc.abstractmethod
    def wait_next_event(self) -> None:
        """Park until more work may exist (thread wait / event advance)."""

    # -- payload hooks (overridden per substrate) ---------------------------
    def fuse_payload(self, members: list[LaunchState],
                     launch_id: int) -> LaunchState:
        """Materialize the backend payload of a fused batch.

        Args:
            members: ≥2 staged fusion-eligible launches (same fuse key).
            launch_id: id the loop assigned the fused entry.

        Returns:
            A fresh :class:`LaunchState` whose scheduler covers the
            members' combined index space; tenant/weight/slots are
            filled in by the loop afterwards.
        """
        raise NotImplementedError("this backend does not support fusion")

    def launch_counters(self, launch: LaunchState) -> DataPlaneCounters:
        """Snapshot one launch's data-plane accounting."""
        return DataPlaneCounters()

    def commit_member(self, fused: LaunchState, member: LaunchState,
                      index: int, cover: Package) -> None:
        """Land one fused member's output (engine: copy its row out)."""

    def deliver(self, launch: LaunchState) -> None:
        """Hand a finalized launch (stats populated) to the caller."""

    def fail(self, launch: LaunchState, err: BaseException) -> None:
        """Surface a launch failure (engine: resolve the handle future).

        Args:
            launch: the failing launch — for a fused batch the loop calls
                this once per member, never for the synthetic batch entry.
            err: the package error or cover-validation failure.
        """
        raise err

    def refresh_speeds(self, launch: LaunchState) -> None:
        """Feed measured throughput into an adaptive launch's scheduler."""

    def on_package(self, launch: LaunchState, pkg: Package) -> None:
        """Observe one collected package (sim: service-curve sampling)."""

    def package_lost(self, launch: LaunchState, pkg: Package) -> None:
        """Roll back substrate accounting of a package lost to unit death.

        Called by :meth:`ExecutionLoop.unit_lost` for every in-flight
        package the dead unit owned, *before* its range is queued for
        re-issue. A backend that charged counters or modeled cost at
        dispatch time undoes that here so the disturbed run's accounting
        equals an undisturbed one (the lost attempt never happened as far
        as the data plane is concerned). Default: nothing was charged yet.
        """


class ExecutionLoop:
    """The one Commander loop both backends drive.

    Owns the :class:`~repro_torch.core.admission.AdmissionController` and every
    control-plane decision between ``submit`` and launch completion. The
    caller serializes all calls (the engine under its condition variable,
    the simulator single-threaded) exactly as with the controller itself.
    """

    def __init__(self, backend: Backend, unit_names: Sequence[str],
                 config: Optional[AdmissionConfig] = None, *,
                 validate: bool = True):
        """Build the loop over a backend and its named units.

        Args:
            backend: the execution substrate (real or simulated).
            unit_names: one display name per Coexecution Unit — the keys
                of every ``LaunchStats.unit_busy_s`` the loop produces.
            config: admission configuration; default is plain FIFO.
            validate: assert each launch's packages exactly tile its
                index space at finalization.
        """
        self.backend = backend
        backend.loop = self
        self.unit_names = list(unit_names)
        self.validate = validate
        self._ids = itertools.count()
        # Elastic-cluster state: which unit indices are currently dead, a
        # per-unit ownership ledger of in-flight packages keyed by
        # (launch id, package seq), and the queue of ranges harvested from
        # dead units awaiting exact re-issue to survivors. A pipelined
        # unit (pipeline_depth >= 2) holds several entries here at once —
        # one per pulled-but-uncompleted package, in issue order — and
        # unit_lost disowns *all* of them, so a unit that dies with a
        # full pipeline re-issues every in-flight range exactly once.
        self.dead_units: set[int] = set()
        self._owned: dict[int, dict[tuple[int, int],
                                    tuple[LaunchState, Package]]] = {}
        self._reissue: collections.deque[tuple[LaunchState, Range]] = \
            collections.deque()
        self.reissued = 0             # packages re-emitted after unit loss
        self.admission = AdmissionController(
            len(self.unit_names), config,
            fuse_materialize=self._materialize_fused,
            speed_refresh=backend.refresh_speeds,
            on_activate=self._scrub_dead_units)

    # -- identity / capacity -----------------------------------------------
    def next_id(self) -> int:
        """A fresh launch id (shared across plain and fused launches)."""
        return next(self._ids)

    def drained(self) -> bool:
        """True when no admitted or staged work remains anywhere."""
        return self.admission.drained()

    # -- admission ---------------------------------------------------------
    def admit(self, launch: LaunchState, now: Optional[float] = None) -> None:
        """Admit one launch: activate it, or stage it for fusion.

        Args:
            launch: the launch to admit; capacity is the caller's concern
                (the engine gates on ``max_inflight`` before admitting).
            now: admission time; defaults to the backend clock.
        """
        self.admission.admit(launch, self.backend.now() if now is None
                             else now)

    def offer(self, launch: LaunchState, now: Optional[float] = None) -> bool:
        """Offer one arriving launch: shed it, or admit it (logged).

        The open-loop entry point both substrates use for timed traffic:
        assigns the config's default SLO deadline when the launch has
        none, asks the admission controller's deadline shed estimator
        for a verdict, and admits on acceptance. The decision depends
        only on the arrival sequence and the config (see
        :meth:`~repro_torch.core.admission.AdmissionController.offer`), which
        is what makes replayed accept/shed sequences identical across
        the real engine and the DES.

        Args:
            launch: the arriving launch; its ``deadline`` (absolute, on
                this backend's clock) may already be set by the caller.
            now: arrival time; defaults to the backend clock.

        Returns:
            ``True`` when the launch was admitted, ``False`` when shed
            (the caller surfaces the rejection — the engine resolves the
            handle with :class:`~repro_torch.core.admission.LaunchShed`).
        """
        t = self.backend.now() if now is None else now
        cfg = self.admission.config
        if launch.deadline is None and cfg.slo_ms is not None:
            launch.deadline = t + cfg.slo_ms / 1e3
        if not self.admission.offer(launch, t):
            return False
        self.admission.admit(launch, t)
        return True

    # -- package flow ------------------------------------------------------
    def pull(self, unit: int, *, now: Optional[float] = None,
             force_flush: bool = False
             ) -> Optional[tuple[LaunchState, Package]]:
        """Pick the next package for an idle unit under the active policy.

        Flushes ripened fusion groups first, then asks the admission
        controller whose turn it is. The returned package is stamped with
        ``t_issue`` and counted as outstanding on its launch.

        Args:
            unit: index of the idle Coexecution Unit.
            now: current time; defaults to the backend clock.
            force_flush: materialize staged fusion groups regardless of
                window ripeness (engine shutdown; simulator once no
                further submissions can arrive).

        Returns:
            ``(launch, package)``, or ``None`` when nothing can serve
            this unit right now.
        """
        if unit in self.dead_units:
            return None
        t = self.backend.now() if now is None else now
        self.admission.flush(t, force=force_flush)
        # Recovery work jumps the queue: a re-issued range was already
        # admitted and WFQ-charged at its original issue, so serving it
        # first keeps fairness attribution exact and clears the backlog a
        # dead unit left behind before new packages are cut.
        while self._reissue:
            launch, rng = self._reissue.popleft()
            launch.pending_reissue -= 1
            if launch.failed or launch.finalized:
                continue
            pkg = launch.scheduler.reissue(rng, unit)
            launch.outstanding += 1
            pkg.t_issue = t
            self._owned.setdefault(unit, {})[(launch.id, pkg.seq)] = \
                (launch, pkg)
            self.admission.dispatched += 1
            self.reissued += 1
            return launch, pkg
        got = self.admission.next_work(unit)
        if got is not None:
            launch, pkg = got
            launch.outstanding += 1
            pkg.t_issue = t
            self._owned.setdefault(unit, {})[(launch.id, pkg.seq)] = \
                (launch, pkg)
        return got

    def complete(self, launch: LaunchState, pkg: Package,
                 error: Optional[BaseException] = None) -> None:
        """Record one served package; finalize the launch when drained.

        Args:
            launch: the package's launch.
            pkg: the package the backend just executed/modeled.
            error: the package's failure, if it had one — fails the whole
                launch (first error wins).

        A package whose issuing unit died since the pull was *disowned*
        by :meth:`unit_lost` (its range is already queued for re-issue);
        a late completion from such a zombie worker is dropped here so
        the work-item is never counted twice.
        """
        owned = self._owned.get(pkg.unit)
        key = (launch.id, pkg.seq)
        if owned is None or key not in owned:
            return      # disowned: the unit died, the range was re-issued
        del owned[key]
        launch.outstanding -= 1
        if error is not None:
            self.fail(launch, error)
            return
        if launch.failed:
            return      # a sibling package already failed the launch
        launch.done_pkgs.append(pkg)
        self.backend.on_package(launch, pkg)
        if (launch.scheduler.done() and launch.outstanding == 0
                and launch.pending_reissue == 0):
            self._finalize(launch)

    def fail(self, launch: LaunchState, err: BaseException) -> None:
        """Abort a launch on its first error (idempotent).

        Args:
            launch: the launch (or fused batch) that failed.
            err: the error to surface through the backend, once per
                member for a fused batch.
        """
        if launch.failed or launch.finalized:
            return
        launch.failed = True
        launch.finalized = True
        self.admission.discard(launch)
        for target in (launch.members if launch.members is not None
                       else [launch]):
            self.backend.fail(target, err)

    # -- elastic membership ------------------------------------------------
    def in_flight_of(self, unit: int) -> int:
        """Number of issued-but-uncollected packages a unit currently owns.

        Bounded by the engine's ``pipeline_depth``: a serial unit owns at
        most one package between pull and complete, a pipelined worker
        keeps up to ``depth`` staged/computing/collecting at once.
        """
        return len(self._owned.get(unit, ()))

    def oldest_issue(self, unit: int) -> Optional[float]:
        """Issue time of the unit's longest-outstanding package (or None).

        The supervisor's straggler detector compares this age against the
        pool's typical package service time.
        """
        owned = self._owned.get(unit)
        if not owned:
            return None
        return min(p.t_issue for _, p in owned.values())

    def unit_lost(self, unit: int) -> int:
        """Declare one unit dead and queue its work for exact re-issue.

        Idempotent per death. Two kinds of work migrate to survivors:

        * **in-flight packages** the unit pulled but never completed —
          each is disowned (a zombie completion is dropped by
          :meth:`complete`), rolled back through
          :meth:`Backend.package_lost`, and its exact :class:`Range`
          queued for re-emission;
        * **reserved un-issued work** a partitioned scheduler set aside
          for this unit (a static region, work-stealing chunks) —
          harvested via :meth:`~repro_torch.core.scheduler.Scheduler.unit_lost`
          from every active launch so nothing strands on a dead unit.

        Because a re-issued range is bitwise the same interval, survivors
        recompute exactly the lost work-items: the finished launch is
        bitwise-identical to an undisturbed run and per-launch counters
        balance exactly (the lost attempt is uncounted, the re-issue
        recounted).

        Args:
            unit: index of the dead Coexecution Unit.

        Returns:
            Number of ranges queued for re-issue by this call.
        """
        if unit in self.dead_units:
            return 0
        self.dead_units.add(unit)
        moved = 0
        for launch, pkg in self._owned.pop(unit, {}).values():
            launch.outstanding -= 1
            if launch.failed or launch.finalized:
                continue    # nothing to recover for an aborted launch
            self.backend.package_lost(launch, pkg)
            self.admission.dispatched -= 1
            launch.pending_reissue += 1
            self._reissue.append((launch, Range(pkg.offset, pkg.size)))
            moved += 1
        for entry in self.admission.active_entries():
            moved += self._harvest_reserved(entry, unit)
        return moved

    def unit_joined(self, unit: int, *, name: Optional[str] = None,
                    speed: Optional[float] = None) -> None:
        """Bring a unit (back) into the pool.

        A known index is a revival — the dormant/dead unit simply starts
        pulling again (its statically reserved regions were given away at
        loss time; adaptive policies serve it naturally). An index one
        past the end grows the pool, and every active launch's scheduler
        is notified so per-unit structures exist before the first pull.

        Args:
            unit: index of the joining Coexecution Unit.
            name: display name for a brand-new unit.
            speed: relative throughput hint for adaptive schedulers.
        """
        if unit < len(self.unit_names):
            self.dead_units.discard(unit)
            return
        if unit != len(self.unit_names):
            raise ValueError(f"unit {unit} would leave a gap in the pool "
                             f"(size {len(self.unit_names)})")
        self.unit_names.append(name or f"unit{unit}")
        self.admission.num_units = len(self.unit_names)
        for entry in self.admission.active_entries():
            hook = getattr(entry.scheduler, "unit_joined", None)
            if hook is not None:
                hook(unit, speed=speed)

    def _harvest_reserved(self, entry: LaunchState, unit: int) -> int:
        """Queue one launch's dead-unit scheduler reservations for re-issue."""
        hook = getattr(entry.scheduler, "unit_lost", None)
        if hook is None or entry.failed or entry.finalized:
            return 0
        moved = 0
        for rng in hook(unit):
            entry.pending_reissue += 1
            self._reissue.append((entry, rng))
            moved += 1
        return moved

    def _scrub_dead_units(self, entry: LaunchState) -> None:
        """Strip dead-unit reservations from a newly activated launch.

        A launch admitted (or a fusion group materialized) while part of
        the pool is dead carries scheduler regions no one will ever pull;
        they move straight to the re-issue queue so the launch cannot
        wedge waiting on a unit that is not coming back.
        """
        for unit in self.dead_units:
            self._harvest_reserved(entry, unit)

    # -- fusion ------------------------------------------------------------
    def _materialize_fused(self, members: list[LaunchState]) -> LaunchState:
        """Coalesce staged member launches into one schedulable entry.

        The backend builds the payload (the engine stacks inputs along a
        member axis; the simulator concatenates workloads); the
        shared bookkeeping — id, tenant flow, combined weight, earliest
        submit time — happens here so both substrates agree on how a
        fused batch participates in admission.
        """
        fused = self.backend.fuse_payload(list(members), self.next_id())
        fused.tenant = f"fused-{fused.id}"
        fused.weight = sum(m.weight for m in members)
        fused.t_submit = min(m.t_submit for m in members)
        # EDF urgency of a batch is its most urgent member's deadline
        fused.deadline = min((m.deadline for m in members
                              if m.deadline is not None), default=None)
        fused.members = list(members)
        for m in members:
            m.fused = True
        return fused

    @staticmethod
    def member_spans(launch: LaunchState, pkg: Package):
        """Attribute one fused package's work to the members it covers.

        Args:
            launch: a fused batch entry (``members`` is not ``None``).
            pkg: one of its dispatched packages.

        Yields:
            ``(member, items)`` pairs — real work-items of each member
            this package computed (used for tenant service curves).
        """
        span = launch.member_span
        scale = launch.wfq_cost_scale
        first = pkg.offset // span
        last = -(-(pkg.offset + pkg.size) // span)
        for mi in range(first, last):
            lo = max(pkg.offset, mi * span)
            hi = min(pkg.offset + pkg.size, (mi + 1) * span)
            if hi > lo:
                yield launch.members[mi], (hi - lo) * scale

    # -- finalization ------------------------------------------------------
    def _busy_of(self, pkgs: Sequence[Package]) -> dict[str, float]:
        """Per-unit busy seconds derived from one launch's packages only."""
        busy = {name: 0.0 for name in self.unit_names}
        for p in pkgs:
            busy[self.unit_names[p.unit]] += max(p.t_complete - p.t_issue,
                                                 0.0)
        return busy

    def _finalize(self, launch: LaunchState) -> None:
        """Resolve a launch whose last package was collected."""
        if launch.finalized:
            return
        launch.finalized = True
        self.admission.discard(launch)
        # The launch ends when its last package is collected — taken from
        # the package timeline, not the backend clock: on the sim backend
        # the clock still reads the final package's *issue* time here
        # (its modeled cost has not advanced the event queue yet), and
        # the timeline is what both backends stamp identically.
        end = max((p.t_collected for p in launch.done_pkgs),
                  default=self.backend.now())
        if self.validate:
            try:
                validate_cover(launch.done_pkgs, launch.scheduler.total)
            except BaseException as e:
                launch.failed = True
                for target in (launch.members if launch.members is not None
                               else [launch]):
                    self.backend.fail(target, e)
                return
        if launch.members is not None:
            self._demux_fused(launch, end)
            return
        launch.stats = LaunchStats(
            total_s=end - launch.t_submit,
            packages=list(launch.done_pkgs),
            unit_busy_s=self._busy_of(launch.done_pkgs),
            data=self.backend.launch_counters(launch), launch_id=launch.id)
        self.backend.deliver(launch)

    def _demux_fused(self, fused: LaunchState, end: float) -> None:
        """Scatter a completed fused batch back to its member launches.

        Each member gets its output committed through the backend and a
        synthesized single-package stats record timed by the shared
        dispatch that computed it. The batch's data-plane accounting is
        attributed in remainder-distributed integer shares
        (:meth:`~repro_torch.core.dataplane.DataPlaneCounters.split`), so
        summing member stats recovers the batch's real copy/dispatch
        totals exactly even when ``counters % members != 0``.
        """
        pkgs = sorted(fused.done_pkgs, key=lambda p: p.offset)
        shares = self.backend.launch_counters(fused).split(len(fused.members))
        span = fused.member_span
        for i, m in enumerate(fused.members):
            start = i * span
            cover = next(p for p in pkgs
                         if p.offset <= start < p.offset + p.size)
            mp = Package(rng=Range(0, m.scheduler.total), seq=0,
                         unit=cover.unit)
            mp.t_issue, mp.t_launch = cover.t_issue, cover.t_launch
            mp.t_complete, mp.t_collected = cover.t_complete, cover.t_collected
            busy = {name: 0.0 for name in self.unit_names}
            members_in_cover = max(cover.size // span, 1)
            busy[self.unit_names[cover.unit]] = max(
                cover.t_complete - cover.t_issue, 0.0) / members_in_cover
            self.backend.commit_member(fused, m, i, cover)
            m.finalized = True
            m.stats = LaunchStats(total_s=end - m.t_submit, packages=[mp],
                                  unit_busy_s=busy, data=shares[i],
                                  launch_id=m.id)
            self.backend.deliver(m)
