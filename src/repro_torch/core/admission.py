"""Cross-launch admission control for the persistent engine (and DES).

A plain :class:`~.engine.CoexecEngine` is multi-tenant but strictly FIFO:
packages of concurrent launches drain in submit order, one launch at a
time, with no limit on how much work callers may pile up. EngineCL
(arXiv:1805.02755) and the time-constrained co-execution follow-up
(arXiv:2010.12607) both observe that under dynamic load the *queueing
discipline* — not just the intra-launch split — determines throughput and
fairness. This module is that discipline, factored out of the engine so
the exact same policies run on the real worker threads and on the
discrete-event simulator:

* **Weighted-fair queueing** (``policy="wfq"``) — deficit-round-robin over
  *packages* across tenants: each tenant accrues credit proportional to
  its weight and spends it per work-item served, so two tenants at
  weights 2:1 see a 2:1 completed-item ratio while both are backlogged.
  ``policy="fifo"`` keeps the plain strict-submit-order behavior.
* **Launch fusion** (``fuse=True``) — small concurrent launches with the
  same kernel and shapes are staged for a short batching window and
  coalesced into one fused launch whose index space is *members*; N tiny
  requests then cost ~one dispatch per unit instead of N full scheduler
  drains. The caller supplies the materializer (the engine stacks inputs
  and vmaps the kernel; the simulator concatenates workloads) and
  de-multiplexes on completion.
* **Deadline-aware admission** (``policy="edf"``) — WFQ's deficit
  machinery with the scan ordered earliest-absolute-deadline-first and
  rank-based credit boosts for the flows nearest their deadline
  (``edf_boost``), the time-constrained setting of arXiv:2010.12607.
* **Load shedding** (``shed=True``) — :meth:`AdmissionController.offer`
  runs a virtual single-server finish-time estimator over the offered
  arrivals (capacity ``shed_rate`` items/s); a launch whose estimated
  finish misses its deadline is rejected up to a bounded fraction of the
  offered load (``shed_budget``), so overload degrades gracefully
  instead of collapsing every tenant's p99. Decisions depend only on
  the arrival sequence and the config, never on the execution substrate,
  which is what makes the accept/shed sequence reproducible bit-for-bit
  between the real engine and the DES.
* **Backpressure** (``max_inflight``) — a cap on admitted-but-unfinished
  launches; :meth:`AdmissionController.has_capacity` lets the engine's
  ``submit(..., block=True)`` path wait instead of queueing unboundedly.

The controller is deliberately *not* thread-safe: the engine calls it
under its condition variable, the simulator single-threaded. Entries are
duck-typed — anything with ``scheduler``, ``tenant``, ``weight`` and
optionally ``fuse_key`` / ``slots`` / ``failed`` / ``deadline``
attributes schedules.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

from .package import Package

ADMISSION_POLICIES = ("fifo", "wfq", "edf")


class AdmissionFull(RuntimeError):
    """Raised by non-blocking submission when the engine is at capacity.

    Signals that :class:`AdmissionConfig.max_inflight` launches are already
    admitted and unfinished; the caller should retry later, shed load, or
    submit with ``block=True`` to wait for a slot.
    """


class LaunchShed(AdmissionFull):
    """The admission layer rejected a launch to protect its SLO budget.

    Raised from :meth:`~repro_torch.core.engine.LaunchHandle.result` /
    returned from :meth:`~repro_torch.core.engine.LaunchHandle.exception`
    *immediately* — a shed launch's handle is resolved at submit time,
    never left to dangle until a wait timeout. Subclasses
    :class:`AdmissionFull` so existing at-capacity handlers keep working.
    """


def fusion_bucket(total: int) -> int:
    """Smallest power of two ≥ ``total`` (the bucketed-fusion pad size).

    Args:
        total: a launch's index-space size in work-items.

    Returns:
        The power-of-2 bucket the launch pads up to under
        ``fuse_buckets=True`` (1 for non-positive totals).
    """
    return 1 << max(int(total) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Tuning knobs of the admission layer.

    Args:
        policy: ``"fifo"`` (strict submit order),
            ``"wfq"`` (deficit-round-robin weighted fairness per tenant),
            or ``"edf"`` (WFQ credit with the scan ordered
            earliest-deadline-first and starved flows refilled with
            deadline-rank boosts).
        fuse: stage fusion-eligible launches and coalesce concurrent ones
            into shared dispatches.
        fuse_threshold: largest launch (work-items) eligible for fusion;
            bigger launches keep both units busy on their own and gain
            nothing from batching.
        fuse_limit: maximum members per fused batch — a full group is
            materialized immediately without waiting for the window.
        fuse_wait_s: batching window. A staged group is held until this
            much time passed since its first member (or the group is
            full/force-flushed); 0 fuses exactly the launches that are
            concurrently queued, which is what the simulator uses.
        max_inflight: cap on admitted-but-unfinished launches (fused
            members each count as one); ``None`` means unbounded.
        quantum: DRR credit granted per round in work-items; ``None``
            derives it from the active schedulers' package-size hints.
        preempt: let WFQ reclaim credit mid-launch by capping the
            per-pull package size of an over-served tenant at its
            remaining credit. Without it, deficit round robin lets one
            pull overdraft by a whole (possibly huge) package — surplus
            round robin — which is fair in the long run but bursty at
            short horizons. Inert under ``policy="fifo"`` (there is no
            credit to reclaim).
        fuse_buckets: widen fusion eligibility to near-identical shapes:
            launches whose index spaces fall in the same power-of-2 size
            bucket (:func:`fusion_bucket`) share a fuse key and pad up
            to the bucket size, so mixed real-world traffic still fuses
            instead of degenerating to singleton dispatches.
        slo_ms: default per-launch SLO in milliseconds — a launch
            submitted without an explicit deadline gets
            ``t_submit + slo_ms/1e3``; ``None`` leaves deadlines unset.
        shed: reject launches whose estimated finish time misses their
            deadline (see :meth:`AdmissionController.offer`), up to the
            rejection budget. Requires ``shed_rate`` to have any effect.
        shed_budget: bounded rejection fraction — at most this share of
            the offered launches is ever shed; past the budget overload
            degrades gracefully (launches are admitted late rather than
            rejected).
        shed_rate: the admission estimator's capacity in work-items per
            second (a virtual single server); ``None`` disables the
            estimator (nothing is ever shed).
        edf_boost: credit-boost strength for the EDF refill — a starved
            flow at deadline rank ``r`` (0 = most urgent) earns credit
            at ``weight * (1 + edf_boost / (r + 1))``, so the launches
            nearest their deadline pull ahead deterministically.

    Raises:
        ValueError: on an unknown policy or non-positive limits.
    """

    policy: str = "fifo"
    fuse: bool = False
    fuse_threshold: int = 1 << 12
    fuse_limit: int = 64
    fuse_wait_s: float = 0.002
    max_inflight: Optional[int] = None
    quantum: Optional[int] = None
    preempt: bool = False
    fuse_buckets: bool = False
    slo_ms: Optional[float] = None
    shed: bool = False
    shed_budget: float = 0.25
    shed_rate: Optional[float] = None
    edf_boost: float = 1.0

    def __post_init__(self) -> None:
        if self.policy not in ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {self.policy!r}; "
                             f"choose from {ADMISSION_POLICIES}")
        if self.fuse_threshold <= 0 or self.fuse_limit <= 0:
            raise ValueError("fuse_threshold and fuse_limit must be positive")
        if self.fuse_wait_s < 0:
            raise ValueError("fuse_wait_s must be non-negative")
        if self.max_inflight is not None and self.max_inflight <= 0:
            raise ValueError("max_inflight must be positive (or None)")
        if self.quantum is not None and self.quantum <= 0:
            raise ValueError("quantum must be positive (or None)")
        if self.slo_ms is not None and not self.slo_ms > 0:
            raise ValueError("slo_ms must be positive (or None)")
        if not 0.0 <= self.shed_budget <= 1.0:
            raise ValueError("shed_budget must be within [0, 1]")
        if self.shed_rate is not None and not self.shed_rate > 0:
            raise ValueError("shed_rate must be positive (or None)")
        if self.edf_boost < 0:
            raise ValueError("edf_boost must be non-negative")


def coerce_admission(admission) -> AdmissionConfig:
    """Normalize a policy name or config object into an AdmissionConfig.

    Args:
        admission: an :class:`AdmissionConfig`, a declarative spec with a
            ``to_config()`` method (:class:`repro_torch.api.spec.AdmissionSpec`),
            a policy-name string (``"fifo"`` / ``"wfq"``), or ``None`` for
            the default config.

    Returns:
        The equivalent :class:`AdmissionConfig`.
    """
    if admission is None:
        return AdmissionConfig()
    if isinstance(admission, AdmissionConfig):
        return admission
    if hasattr(admission, "to_config"):     # AdmissionSpec, duck-typed to
        return admission.to_config()        # keep core free of api imports
    return AdmissionConfig(policy=str(admission).lower())


class _TenantQueue:
    """Per-tenant flow state for the DRR scan (entries in submit order)."""

    __slots__ = ("key", "weight", "deficit", "entries")

    def __init__(self, key: str, weight: float):
        self.key = key
        self.weight = weight
        self.deficit = 0.0
        self.entries: list = []


class _FusionGroup:
    """Staged fusion-eligible launches sharing one fuse key."""

    __slots__ = ("key", "members", "t_first")

    def __init__(self, key, t_first: float):
        self.key = key
        self.members: list = []
        self.t_first = t_first


class AdmissionController:
    """Queueing discipline between ``submit`` and the per-unit workers.

    Owns the set of admitted launches and decides, per idle unit, which
    launch's scheduler gets to emit the next package. The caller (engine
    or simulator) serializes all calls and remains responsible for
    executing packages and finalizing launches.

    Attributes:
        config: the immutable :class:`AdmissionConfig` in force.
        dispatched: packages handed out over the controller's lifetime.
        fused_batches: fused launches materialized so far.
        fused_members: total members coalesced into those batches.
        offered: launches offered through :meth:`offer` so far.
        shed_count: offered launches rejected by the shed estimator.
        decision_log: ``("accept" | "shed", tenant)`` per offered launch,
            in offer order — the structural surface the real-vs-sim
            trace-replay parity tests compare.
        fusion_log: one tuple of member tenants per materialized fused
            batch, in materialization order.
    """

    def __init__(self, num_units: int,
                 config: Optional[AdmissionConfig] = None, *,
                 fuse_materialize: Optional[Callable] = None,
                 speed_refresh: Optional[Callable] = None,
                 on_activate: Optional[Callable] = None):
        """Build a controller.

        Args:
            num_units: Coexecution Unit count (bounds the DRR scan).
            config: admission configuration; default is plain FIFO.
            fuse_materialize: callback ``(members) -> fused_entry`` that
                coalesces ≥2 staged launches into one schedulable entry;
                when ``None``, staged groups are admitted member-by-member.
            speed_refresh: optional per-entry hook invoked right before
                pulling a package (the engine refreshes HGuided speeds).
            on_activate: optional hook invoked with each entry as it
                becomes schedulable (the execution loop strips dead-unit
                scheduler reservations here in elastic-cluster mode).
        """
        self.num_units = int(num_units)
        self.config = config or AdmissionConfig()
        self._fuse_materialize = fuse_materialize
        self._speed_refresh = speed_refresh
        self._on_activate = on_activate
        self._active: list = []     # FIFO admit order; guarded-by: caller
        self._tenants: dict[str, _TenantQueue] = {}  # guarded-by: caller
        self._ring: list[str] = []  # DRR service order; guarded-by: caller
        self._rr = 0  # guarded-by: caller
        self._staged: dict = {}     # fuse_key -> group; guarded-by: caller
        self._in_flight = 0  # guarded-by: caller
        self._auto_quantum = 1  # guarded-by: caller
        self.dispatched = 0
        self.fused_batches = 0
        self.fused_members = 0
        self.offered = 0
        self.shed_count = 0
        self._vfinish = 0.0  # shed estimator's virtual finish; guarded-by: caller
        self.decision_log: list[tuple[str, str]] = []
        self.fusion_log: list[tuple[str, ...]] = []

    # -- capacity ----------------------------------------------------------
    @property
    def in_flight(self) -> int:
        """Admitted-but-unfinished launches (fused members count singly)."""
        return self._in_flight

    def has_capacity(self) -> bool:
        """Whether one more launch may be admitted under ``max_inflight``."""
        cap = self.config.max_inflight
        return cap is None or self._in_flight < cap

    def drained(self) -> bool:
        """True when no admitted or staged work remains anywhere."""
        return not self._active and not self._staged

    def active_entries(self) -> list:
        """Schedulable entries in admit order (staged members excluded)."""
        return list(self._active)

    # -- admission ---------------------------------------------------------
    def offer(self, entry, now: float = 0.0) -> bool:
        """Accept-or-shed decision for one arriving launch (logged).

        Runs the deadline shed estimator: a virtual single server of
        capacity ``shed_rate`` items/s serves accepted launches in offer
        order; a launch whose estimated finish misses its ``deadline``
        is shed, as long as doing so keeps the shed fraction within
        ``shed_budget`` of everything offered so far (past the budget
        the launch is admitted late instead — graceful degradation).
        The verdict depends only on the arrival sequence, each entry's
        ``scheduler.total``/``deadline`` and the config — never on the
        execution substrate — so a trace replayed through the real
        engine and the DES produces the *same* accept/shed sequence.

        The caller still calls :meth:`admit` for accepted entries (or
        :meth:`~repro_torch.core.exec.ExecutionLoop.offer`, which does both).

        Args:
            entry: launch-like object (``scheduler``/``tenant``; an
                optional ``deadline`` attribute holds its absolute
                deadline in the caller's clock).
            now: the entry's arrival time on that same clock.

        Returns:
            ``True`` to admit, ``False`` when the launch was shed.
        """
        self.offered += 1
        cfg = self.config
        deadline = getattr(entry, "deadline", None)
        finish = None
        if cfg.shed_rate is not None:
            start = max(self._vfinish, float(now))
            finish = start + entry.scheduler.total / cfg.shed_rate
        if (cfg.shed and finish is not None and deadline is not None
                and finish > deadline
                and self.shed_count + 1 <= cfg.shed_budget * self.offered):
            self.shed_count += 1
            self.decision_log.append(("shed", entry.tenant))
            return False
        if finish is not None:
            self._vfinish = finish
        self.decision_log.append(("accept", entry.tenant))
        return True

    def admit(self, entry, now: float = 0.0) -> None:
        """Admit one launch: activate it, or stage it for fusion.

        Args:
            entry: launch-like object (``scheduler``/``tenant``/``weight``,
                optional ``fuse_key``). Capacity is *not* checked here —
                callers gate on :meth:`has_capacity` first (the engine
                blocks or raises :class:`AdmissionFull` before admitting).
            now: current time (wall for the engine, virtual for the DES),
                used to timestamp fusion groups.

        Raises:
            ValueError: on a non-positive tenant weight.
        """
        if not float(entry.weight) > 0:
            raise ValueError(f"tenant weight must be positive, "
                             f"got {entry.weight!r}")
        self._in_flight += getattr(entry, "slots", 1)
        key = getattr(entry, "fuse_key", None)
        if self.config.fuse and key is not None:
            group = self._staged.get(key)
            if group is None:
                group = self._staged[key] = _FusionGroup(key, now)
            group.members.append(entry)
            if len(group.members) >= self.config.fuse_limit:
                self._flush_group(key)
            return
        self._activate(entry)

    def _activate(self, entry) -> None:
        """Make an entry schedulable (joins its tenant's DRR flow)."""
        self._active.append(entry)
        if self._on_activate is not None:
            self._on_activate(entry)
        # wfq_cost_scale converts an entry's package sizes to work-items
        # (engine-side fused batches schedule in member units, each worth
        # one member's whole index space of credit)
        scale = getattr(entry, "wfq_cost_scale", 1)
        self._auto_quantum = max(self._auto_quantum,
                                 entry.scheduler.quantum_hint() * scale)
        tq = self._tenants.get(entry.tenant)
        if tq is None:
            tq = self._tenants[entry.tenant] = _TenantQueue(
                entry.tenant, float(entry.weight))
            self._ring.append(entry.tenant)
        tq.weight = float(entry.weight)       # latest submission wins
        tq.entries.append(entry)

    def discard(self, entry) -> None:
        """Forget a finalized/failed entry and free its capacity slots.

        Args:
            entry: the launch previously admitted (or a fused entry
                produced by the materializer, which frees all its
                members' slots at once).
        """
        self._in_flight -= getattr(entry, "slots", 1)
        if entry in self._active:
            self._active.remove(entry)
        tq = self._tenants.get(getattr(entry, "tenant", None))
        if tq is not None and entry in tq.entries:
            tq.entries.remove(entry)
            if not tq.entries:      # classic DRR: credit dies with the flow
                del self._tenants[tq.key]
                self._ring.remove(tq.key)

    # -- fusion staging ----------------------------------------------------
    def pending_fusion(self) -> int:
        """Staged members still waiting in their batching window."""
        return sum(len(g.members) for g in self._staged.values())

    def next_ripen_in(self, now: float) -> Optional[float]:
        """Seconds until the oldest staged group ripens (None if empty)."""
        if not self._staged:
            return None
        t_first = min(g.t_first for g in self._staged.values())
        return max(0.0, self.config.fuse_wait_s - (now - t_first))

    def flush(self, now: float = 0.0, force: bool = False) -> None:
        """Materialize every staged group whose batching window elapsed.

        Args:
            now: current time, compared against each group's first-member
                timestamp.
            force: flush regardless of ripeness (engine shutdown, or the
                simulator once no further submissions can arrive).
        """
        for key in list(self._staged):
            group = self._staged[key]
            if (force or len(group.members) >= self.config.fuse_limit
                    or now - group.t_first >= self.config.fuse_wait_s):
                self._flush_group(key)

    def _flush_group(self, key) -> None:
        """Turn one staged group into schedulable entries."""
        group = self._staged.pop(key)
        if len(group.members) < 2 or self._fuse_materialize is None:
            for m in group.members:
                self._activate(m)
            return
        fused = self._fuse_materialize(group.members)
        fused.slots = sum(getattr(m, "slots", 1) for m in group.members)
        self.fused_batches += 1
        self.fused_members += len(group.members)
        self.fusion_log.append(tuple(m.tenant for m in group.members))
        self._activate(fused)

    # -- package selection -------------------------------------------------
    def next_work(self, unit: int) -> Optional[tuple[object, Package]]:
        """Pick the next package for an idle unit under the active policy.

        Args:
            unit: index of the idle Coexecution Unit.

        Returns:
            ``(entry, package)`` for the launch whose turn it is, or
            ``None`` when no admitted launch can serve this unit right now
            (drained schedulers, staged-only work, or per-unit exhaustion
            such as a static share already served).
        """
        if self.config.policy == "wfq":
            return self._next_wfq(unit)
        if self.config.policy == "edf":
            return self._next_edf(unit)
        return self._next_fifo(unit)

    def _pull(self, entry, unit: int,
              max_items: Optional[int] = None) -> Optional[Package]:
        """Ask one entry's scheduler for a package (with speed refresh)."""
        if getattr(entry, "failed", False):
            return None
        if self._speed_refresh is not None:
            self._speed_refresh(entry)
        if max_items is None:
            return entry.scheduler.next_package(unit)
        return entry.scheduler.next_package(unit, max_items=max_items)

    def _next_fifo(self, unit: int) -> Optional[tuple[object, Package]]:
        """FIFO: the first admitted launch with a package wins."""
        for entry in self._active:
            pkg = self._pull(entry, unit)
            if pkg is not None:
                self.dispatched += 1
                return entry, pkg
        return None

    def _quantum(self) -> int:
        """DRR credit per round: configured, or the largest package hint."""
        return self.config.quantum or self._auto_quantum

    def _next_wfq(self, unit: int) -> Optional[tuple[object, Package]]:
        """Deficit-round-robin scan over tenant flows.

        A flow with credit serves one package and pays its size (credit
        may go briefly negative — surplus round robin — so schedulers
        keep full control of package sizing). When a full pass finds only
        credit-starved flows, the scan *fast-forwards* them the minimum
        number of whole rounds (``weight * quantum`` each) that puts the
        closest flow back in credit — equivalent to running those empty
        DRR rounds one by one, so service per tenant converges to the
        weight ratio while flows stay backlogged (the 2:1 fairness
        property the tests pin) for any weight or quantum scale, and
        ``None`` is returned only when no flow can serve this unit at
        all.

        With ``config.preempt`` the scan additionally caps each pull at
        the flow's remaining credit (in the entry's scheduler units via
        ``wfq_cost_scale``): a tenant whose scheduler wants to emit a
        giant package is preempted mid-launch down to what its credit
        covers, so overdraft is bounded by one granularity-aligned chunk
        instead of one whole package — the short-horizon fairness the
        preemption tests and benchmarks measure.
        """
        n = len(self._ring)
        if n == 0:
            return None
        while True:
            starved: list[_TenantQueue] = []
            for _ in range(n):
                tq = self._tenants[self._ring[self._rr % n]]
                if not tq.entries:
                    self._rr += 1
                    continue
                if tq.deficit <= 0.0:
                    starved.append(tq)
                    self._rr += 1
                    continue
                got = None
                for entry in tq.entries:
                    cap = None
                    if self.config.preempt:
                        scale = max(getattr(entry, "wfq_cost_scale", 1), 1)
                        cap = max(1, int(tq.deficit // scale))
                    pkg = self._pull(entry, unit, cap)
                    if pkg is not None:
                        got = (entry, pkg)
                        break
                if got is None:     # nothing for *this* unit in this flow
                    self._rr += 1
                    continue
                tq.deficit -= got[1].size * getattr(got[0], "wfq_cost_scale",
                                                    1)
                if tq.deficit <= 0.0:
                    self._rr += 1
                self.dispatched += 1
                return got
            if not starved:
                return None
            # fast-forward the empty rounds: every starved flow earns
            # whole rounds of credit until the closest one goes positive
            # (each pass retires at least one flow from `starved`, so
            # this terminates within len(ring) passes).
            q = self._quantum()
            k = min(math.floor(-tq.deficit / (tq.weight * q)) + 1
                    for tq in starved)
            for tq in starved:
                tq.deficit += k * tq.weight * q

    def _flow_deadline(self, tq: _TenantQueue) -> float:
        """A flow's urgency: earliest member deadline (inf when unset)."""
        return min((e.deadline for e in tq.entries
                    if getattr(e, "deadline", None) is not None),
                   default=math.inf)

    def _next_edf(self, unit: int) -> Optional[tuple[object, Package]]:
        """Earliest-deadline-first DRR scan with deadline-rank boosts.

        WFQ's credit machinery (including preemptive pull-capping) with
        two deadline-aware twists, both deterministic functions of the
        admitted set — no clock reads, so both substrates decide alike:

        * the serve scan visits flows earliest-absolute-deadline-first
          (deadline-free flows last, in stable ring order) instead of
          round-robin, so an urgent tenant with credit is always served
          before a relaxed one;
        * the starved-flow fast-forward refill grants credit at an
          *effective* weight ``weight * (1 + edf_boost / (rank + 1))``
          where rank orders starved flows by deadline — the flows
          nearest their deadline come back into credit sooner and
          therefore accumulate service faster while the pressure lasts.

        Boosted credit is quantized to whole quanta (``round`` of the
        effective weight, floored at one) so deficits stay multiples of
        the package-sized quantum: fractional credit would make the
        preemptive pull cap shave remainder-sized slivers off packages,
        multiplying per-package host overhead under load.
        """
        if not self._ring:
            return None
        while True:
            ranked = sorted(
                (tq for tq in (self._tenants[key] for key in self._ring)
                 if tq.entries),
                key=lambda tq: (self._flow_deadline(tq),
                                self._ring.index(tq.key)))
            if not ranked:
                return None
            starved: list[_TenantQueue] = []
            for tq in ranked:
                if tq.deficit <= 0.0:
                    starved.append(tq)
                    continue
                got = None
                for entry in tq.entries:
                    cap = None
                    if self.config.preempt:
                        scale = max(getattr(entry, "wfq_cost_scale", 1), 1)
                        cap = max(1, int(tq.deficit // scale))
                    pkg = self._pull(entry, unit, cap)
                    if pkg is not None:
                        got = (entry, pkg)
                        break
                if got is None:     # nothing for *this* unit in this flow
                    continue
                tq.deficit -= got[1].size * getattr(got[0], "wfq_cost_scale",
                                                    1)
                self.dispatched += 1
                return got
            if not starved:
                return None
            # deadline-rank boosted fast-forward: starved flows earn whole
            # rounds of credit at their boosted effective weight until the
            # closest one goes positive (same termination argument as the
            # WFQ refill — each pass retires at least one flow).
            q = self._quantum()
            boost = self.config.edf_boost
            by_deadline = sorted(starved,
                                 key=lambda tq: (self._flow_deadline(tq),
                                                 self._ring.index(tq.key)))
            eff = {id(tq): max(1.0, round(tq.weight *
                                          (1.0 + boost / (rank + 1))))
                   for rank, tq in enumerate(by_deadline)}
            k = min(math.floor(-tq.deficit / (eff[id(tq)] * q)) + 1
                    for tq in starved)
            for tq in starved:
                tq.deficit += k * eff[id(tq)] * q


def service_fairness_curve(service: Sequence[tuple[float, str, int]],
                           tenants: Sequence[str], *,
                           samples: int = 9) -> list[float]:
    """Jain fairness of cumulative per-tenant service at sampled horizons.

    The *fairness curve* preemption is judged on: at each of ``samples``
    evenly spaced horizons across the service timeline, take Jain's index
    over how many work-items each tenant has completed so far. Bursty
    service (one tenant receiving a giant package while others wait)
    shows up as a sagging curve even when end-to-end latencies come out
    equal; preemptive pull-capping lifts it.

    Args:
        service: ``(t_complete, tenant, items)`` per dispatched package,
            as produced by both execution backends (any monotone measure
            works for ``t_complete`` — virtual seconds, wall seconds, or
            a dispatch index).
        tenants: the tenant population (tenants with no service yet
            count as zero allocations — that is the point).
        samples: number of evenly spaced horizons to sample.

    Returns:
        One Jain index per horizon, in time order (empty-service
        horizons report 1.0 — nobody is ahead).

    Raises:
        ValueError: if ``tenants`` is empty.
    """
    if not tenants:
        raise ValueError("service_fairness_curve needs at least one tenant")
    events = sorted(service)
    if not events:
        return [1.0] * samples
    t_end = events[-1][0]
    served = {t: 0 for t in tenants}
    curve: list[float] = []
    idx = 0
    for k in range(1, samples + 1):
        horizon = t_end * k / (samples + 1)
        while idx < len(events) and events[idx][0] <= horizon:
            _, tenant, items = events[idx]
            if tenant in served:
                served[tenant] += items
            idx += 1
        total = sum(served.values())
        curve.append(jain_index(list(served.values())) if total else 1.0)
    return curve


def jain_index(allocations: Sequence[float]) -> float:
    """Jain's fairness index over per-tenant allocations.

    Args:
        allocations: one non-negative service measure per tenant
            (items/second, completed items, 1/latency, ...).

    Returns:
        A value in ``(0, 1]``; 1.0 means perfectly equal allocations,
        ``1/n`` means one tenant got everything.

    Raises:
        ValueError: if ``allocations`` is empty.
    """
    xs = [float(x) for x in allocations]
    if not xs:
        raise ValueError("jain_index of empty sequence")
    s = sum(xs)
    s2 = sum(x * x for x in xs)
    return (s * s) / (len(xs) * s2) if s2 > 0 else 1.0
