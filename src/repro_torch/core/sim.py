"""Discrete-event simulation of the Commander loop (paper Figs. 2a/4).

The simulator replays the exact Commander/Coexecution-Unit protocol:

  unit idle ──request──▶ Scheduler.next_package ──▶ host launches package
  (host is a serial resource: launch + collection costs serialize on it,
  reproducing the paper's "CPU manages the runtime resources as the host,
  increasing the CPU load") ──▶ unit computes ──▶ host collects output
  (cost depends on the memory model: USM ≈ free, Buffers ∝ bytes).

Compute time for a package is ``sum(weight[i]**alpha_u for i in range) /
speed_u`` — `weights` capture data irregularity (Mandelbrot iteration
counts, Ray scene density, Rap row lengths); regular kernels have
weights = 1. While more than one unit is busy and the combined working set
exceeds the shared LLC, a contention factor slows both units (the paper's
MatMul observation in §5.3).

The output timeline feeds the paper's metrics: balance = T_gpu/T_cpu,
speedup = T_fastest_alone / T_coexec, energy via core.energy.

Control-plane decisions are NOT made here. Both :func:`simulate` (one
launch) and :func:`simulate_multi` (concurrent launches) drive the exact
:class:`~repro_torch.core.exec.ExecutionLoop` the real engine's worker threads
drive — admission pulls (FIFO, WFQ, preemptive pull-capping), launch
fusion and its de-mux, finalization and counter attribution all run in
that one shared implementation. This module contributes only the
:class:`SimBackend` substrate: a virtual clock, the calibrated package
cost model, and the event queue that advances time — so fairness, fusion
and preemption behavior measured here is structurally the behavior of
the real engine, in deterministic virtual time.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
from typing import Optional, Sequence

import numpy as np

from .admission import AdmissionConfig, coerce_admission, fusion_bucket
from .dataplane import DataPlaneCounters
from .energy import EnergyReport, PowerModel, energy_report
from .exec import Backend, ExecutionLoop, LaunchState
from .memory import MemoryCosts, MemoryModel
from .package import Package
from .scheduler import DynamicScheduler, Scheduler


@dataclasses.dataclass(frozen=True)
class Workload:
    """A data-parallel problem as the DES sees it.

    weights — per-item relative cost (mean ≈ 1), or None for regular
              kernels. Stored as a float64 array of length `total`.
    """

    name: str
    total: int
    bytes_in_per_item: float
    bytes_out_per_item: float
    working_set_bytes: float
    weights: Optional[np.ndarray] = None
    # LLC sensitivity: 1.0 for kernels with heavy temporal reuse (MatMul —
    # the paper's §5.3 hardware-counter analysis: "the LLC memory suffers
    # constant invalidations between CPU and GPU"); 0.0 for streaming
    # kernels whose working set never profits from the LLC.
    contention_scale: float = 0.0

    def weights_prefix(self) -> Optional[np.ndarray]:
        """Prefix-summed per-item weights (None for regular kernels)."""
        if self.weights is None:
            return None
        p = np.zeros(self.total + 1, dtype=np.float64)
        np.cumsum(self.weights, out=p[1:])
        return p


@dataclasses.dataclass
class SimResult:
    """Timeline + metrics of one simulated co-execution.

    ``data`` mirrors the real engine's per-launch
    :class:`~.dataplane.DataPlaneCounters`, and since both substrates now
    share one control plane it is literally produced by the same
    finalization code (the modeled dispatch count and the staging copies
    the memory model implies: one H2D and one D2H per package under
    BUFFERS, none under USM) — spec-driven real-vs-sim comparisons read
    the same counter surface.
    """

    workload: str
    policy: str
    memory: str
    total_s: float
    unit_finish_s: dict[str, float]      # last compute completion per unit
    unit_busy_s: dict[str, float]        # total compute seconds per unit
    host_busy_s: float                   # serialized launch+collect seconds
    packages: list[Package]
    num_packages: int
    data: DataPlaneCounters = dataclasses.field(
        default_factory=DataPlaneCounters)

    def balance(self, fast: str = "gpu", slow: str = "cpu") -> float:
        """Paper's balancing efficiency T_fast/T_slow (1.0 = perfect)."""
        num = self.unit_finish_s.get(fast, 0.0)
        den = self.unit_finish_s.get(slow, 0.0)
        return num / den if den > 0 else float("inf")

    def energy(self, power: PowerModel,
               kinds: dict[str, str]) -> EnergyReport:
        """Model this run's energy from its busy timeline (paper §5.2)."""
        busy: dict[str, float] = {}
        for name, b in self.unit_busy_s.items():
            kind = kinds[name]
            busy[kind] = busy.get(kind, 0.0) + b
        # host management burns CPU-core time on top of CPU compute
        busy["cpu"] = busy.get("cpu", 0.0) + self.host_busy_s
        return energy_report(power, busy, self.total_s)


def _count_package(counters: DataPlaneCounters, memory: MemoryModel,
                   in_bytes: float, out_bytes: float) -> None:
    """Model one package's data-plane accounting (mirrors the real planes)."""
    counters.dispatches += 1
    if memory is MemoryModel.BUFFERS:
        counters.h2d_copies += 1
        counters.h2d_bytes += int(in_bytes)
        counters.d2h_copies += 1
        counters.d2h_bytes += int(out_bytes)


def _item_costs(workload: Workload, unit: "SimUnit") -> np.ndarray:
    """Per-item seconds for `unit` (prefix-summed by the caller)."""
    if workload.weights is None:
        return None
    w = workload.weights.astype(np.float64)
    if unit.alpha != 1.0:
        # NOT renormalized: `speed` is the unit's throughput on *uniform*
        # (weight=1) data; alpha>1 genuinely slows the unit on heavy items
        # (branch divergence on the paper's iGPU). This is what makes
        # irregular co-execution speedups exceed the uniform capacity bound
        # 1 + s_cpu/s_gpu, as observed for Ray (1.48) and Rap (2.46).
        w = np.power(w, unit.alpha)
    return np.concatenate([[0.0], np.cumsum(w)])


class _SimLaunchState(LaunchState):
    """Simulator payload of one launch: the modeled workload + counters."""

    __slots__ = ("workload", "counters")

    def __init__(self, launch_id: int, scheduler: Scheduler,
                 workload: Workload, *, tenant: Optional[str] = None,
                 weight: float = 1.0, t_submit: float = 0.0):
        super().__init__(launch_id, scheduler, tenant=tenant, weight=weight,
                         t_submit=t_submit)
        self.workload = workload
        self.counters = DataPlaneCounters()


class SimBackend(Backend):
    """Virtual-clock substrate: models package costs instead of running them.

    Owns the event queue (`(time, tiebreak, unit)` heap), the calibrated
    cost model (launch/collect/contention via :class:`MemoryCosts`), the
    per-unit busy/finish timelines and the tenant service curve. It makes
    no scheduling decisions — :meth:`run` asks the shared
    :class:`~repro_torch.core.exec.ExecutionLoop` for every package exactly as
    an engine worker thread does, just in virtual time.
    """

    def __init__(self, units: Sequence["SimUnit"], memory: MemoryModel,
                 costs: MemoryCosts, *, pipeline_depth: int = 1):
        self.units = list(units)
        self.memory = memory
        self.costs = costs
        # mirrors the real engine's per-unit dispatch pipeline: with
        # depth >= 2 a package that arrives back-to-back with the unit's
        # previous compute was staged *during* that compute, so its
        # launch cost no longer delays the device (the host still pays
        # it). The DES runs a two-clock model: scheduler decisions
        # (pull pacing, contention, kill checks) stay on the *serial*
        # clock — `busy_until` keeps the serial horizon, which is what
        # keeps package covers and counter totals depth-invariant for
        # every policy — while the *recorded* package timeline drops
        # the hidden launch costs. Depth 1 reproduces the serial
        # timeline exactly on both clocks.
        self.pipeline_depth = max(1, int(pipeline_depth))
        n = len(self.units)
        self.t = 0.0
        self.counters = DataPlaneCounters()      # run-wide aggregation
        self.busy_until = [0.0] * n              # serial compute horizon
        self._hidden = [0.0] * n  # launch cost hidden per pipeline chain
        self.collector_free = [0.0] * n          # per-unit collection thread
        self.unit_finish = {u.name: 0.0 for u in self.units}
        self.unit_busy = {u.name: 0.0 for u in self.units}
        self.host_busy = 0.0
        self.last_collect = 0.0
        # (t_complete, tenant, items) per dispatched package
        self.service: list[tuple[float, str, int]] = []
        self.delivered: list[_SimLaunchState] = []
        self.shed: list[_SimLaunchState] = []    # rejected at admission
        # (id(workload), unit name) -> (workload, its prefix-summed costs)
        self._prefix: dict[tuple[int, str],
                           tuple[Workload, Optional[np.ndarray]]] = {}

    # -- substrate contract -------------------------------------------------
    def now(self) -> float:
        """The virtual clock (seconds since simulation start)."""
        return self.t

    def dispatch(self, unit: int, launch: _SimLaunchState,
                 pkg: Package) -> None:
        """Model one package's launch, compute and collection in virtual time.

        Args:
            unit: index of the serving simulated unit.
            launch: the owning launch (its ``workload`` prices the items).
            pkg: the package; its full timeline
                (``t_launch``/``t_complete``/``t_collected``) is filled.
        """
        wl = launch.workload
        u = self.units[unit]
        in_bytes = pkg.size * wl.bytes_in_per_item
        out_bytes = pkg.size * wl.bytes_out_per_item
        _count_package(self.counters, self.memory, in_bytes, out_bytes)
        _count_package(launch.counters, self.memory, in_bytes, out_bytes)

        launch_cost, t_launch, compute_end = \
            self._model_compute(unit, launch, pkg)
        # pipelined overlap: a package pulled back-to-back with this
        # unit's previous compute was staged *during* that compute, so
        # its launch cost is hidden from the recorded device timeline
        # (the host still pays it). The hidden costs accumulate along
        # one back-to-back chain and reset when the pipeline drains;
        # `busy_until` keeps the serial horizon so every scheduling
        # decision is identical to the depth-1 run.
        prestaged = (self.pipeline_depth > 1
                     and self.busy_until[unit] > 0.0
                     and self.busy_until[unit] >= pkg.t_issue - 1e-12)
        if prestaged:
            self._hidden[unit] += launch_cost
        else:
            self._hidden[unit] = 0.0
        shift = self._hidden[unit]
        self.host_busy += launch_cost
        pkg.t_launch = t_launch - shift
        if prestaged:
            # staged while the previous package computed: the recorded
            # issue coincides with the device picking it up
            pkg.t_issue = pkg.t_launch
        self.busy_until[unit] = compute_end
        self.unit_busy[u.name] += compute_end - t_launch
        self.unit_finish[u.name] = max(self.unit_finish[u.name],
                                       compute_end - shift)
        pkg.t_complete = compute_end - shift

        # collection on the unit's manager thread; overlaps the unit's next
        # compute (paper: "overlapping computation and communication") but
        # collections of one unit serialize among themselves.
        collect_start = max(pkg.t_complete, self.collector_free[unit])
        collect_cost = self.costs.collect_cost(self.memory, int(out_bytes))
        self.collector_free[unit] = collect_start + collect_cost
        self.host_busy += collect_cost
        pkg.t_collected = self.collector_free[unit]
        self.last_collect = max(self.last_collect, pkg.t_collected)

    def wait_next_event(self) -> None:
        """No-op: :meth:`run` advances virtual time through its heap."""

    def _model_compute(self, unit: int, launch: _SimLaunchState,
                       pkg: Package) -> tuple[float, float, float]:
        """Price one package without mutating any state.

        Given the backend's *current* busy horizons and the package's
        stamped ``t_issue``, returns ``(launch_cost, t_launch,
        compute_end)`` — the *serial-clock* timeline :meth:`dispatch`
        prices decisions with (:meth:`dispatch` then subtracts the
        pipeline's hidden launch costs from the recorded stamps, never
        from these). Factored out so the elastic-cluster backend can
        ask "would this package finish before its unit's scripted
        death?" and, when not, model the attempt as lost without ever
        charging its cost.
        """
        wl = launch.workload
        u = self.units[unit]
        in_bytes = pkg.size * wl.bytes_in_per_item
        launch_cost = self.costs.launch_cost(self.memory, int(in_bytes))
        t_launch = pkg.t_issue + launch_cost
        # compute; LLC contention applies while any *other* unit is busy
        pfx = self._prefix_for(wl, u)
        if pfx is None:
            base = pkg.size / u.speed
        else:
            base = float(pfx[pkg.offset + pkg.size] - pfx[pkg.offset]) \
                / u.speed
        others_busy = any(self.busy_until[j] > t_launch
                          for j in range(len(self.units)) if j != unit)
        factor = 1.0
        if others_busy and wl.contention_scale > 0.0:
            pen = self.costs.contention_penalty(wl.working_set_bytes)
            factor = 1.0 + wl.contention_scale * (pen - 1.0)
        return launch_cost, t_launch, t_launch + base * factor

    # -- payload hooks ------------------------------------------------------
    def fuse_payload(self, members: list[_SimLaunchState],
                     launch_id: int) -> _SimLaunchState:
        """Lay member workloads end to end into one fused workload.

        The fused index space is the members' item spaces concatenated
        (weights tiled); its scheduler hands out member-aligned packages,
        one per unit, so a batch of N tiny launches costs ~`num_units`
        dispatches. One scheduler unit is one work-item, so
        ``member_span`` (items per member) drives the shared de-mux.

        Args:
            members: the staged same-shaped launches to coalesce.
            launch_id: id assigned by the loop.

        Returns:
            The fused sim launch (tenant/weight set by the loop).
        """
        base = members[0].workload
        k = len(members)
        # bucketed members pad up to the shared power-of-2 bucket (pad
        # items are modeled at unit weight — the engine really computes
        # them); exact-shape fusion has bucket == total, no padding
        T = members[0].fuse_bucket or max(m.workload.total for m in members)
        if any(m.workload.weights is not None for m in members) \
                or any(m.workload.total != T for m in members):
            weights = np.concatenate([np.concatenate([
                m.workload.weights if m.workload.weights is not None
                else np.ones(m.workload.total),
                np.ones(T - m.workload.total)]) for m in members])
        else:
            weights = None
        wl = Workload(
            name=f"fused:{base.name}x{k}", total=k * T,
            bytes_in_per_item=base.bytes_in_per_item,
            bytes_out_per_item=base.bytes_out_per_item,
            working_set_bytes=max(m.workload.working_set_bytes
                                  for m in members),
            weights=weights, contention_scale=base.contention_scale)
        n_units = len(self.units)
        sched = DynamicScheduler(k * T, n_units,
                                 num_packages=min(k, n_units), granularity=T)
        fused = _SimLaunchState(launch_id, sched, wl)
        fused.member_span = T
        fused.wfq_cost_scale = 1
        fused.fuse_bucket = T
        return fused

    def launch_counters(self, launch: _SimLaunchState) -> DataPlaneCounters:
        """The launch's modeled data-plane accounting."""
        return launch.counters.snapshot()

    def on_package(self, launch: _SimLaunchState, pkg: Package) -> None:
        """Record the tenant service curve (fused work credits members)."""
        if launch.members is None:
            self.service.append((pkg.t_complete, launch.tenant, pkg.size))
        else:
            for m, items in ExecutionLoop.member_spans(launch, pkg):
                self.service.append((pkg.t_complete, m.tenant, items))

    def deliver(self, launch: _SimLaunchState) -> None:
        """Collect a finalized launch (stats already populated)."""
        self.delivered.append(launch)

    # -- the event pump -----------------------------------------------------
    def _prefix_for(self, wl: Workload, u: "SimUnit") -> Optional[np.ndarray]:
        # The entry holds the workload itself: keyed by id() alone, a fused
        # batch's workload freed after its launch lets a later one reuse
        # the id and read a stale prefix of another length.
        key = (id(wl), u.name)
        if key not in self._prefix:
            self._prefix[key] = (wl, _item_costs(wl, u))
        return self._prefix[key][1]

    def run(self, loop: ExecutionLoop,
            entries: Sequence[_SimLaunchState]) -> None:
        """Advance virtual time until every admitted launch finalizes.

        Each Coexecution Unit has its own management thread (paper Fig.
        2a): launch/collect costs are paid on the unit's own timeline,
        not on a global serial host. Units couple only through the shared
        loop (package order under the admission policy) and the
        shared-LLC contention factor; host-side management seconds are
        accumulated for the energy model (the CPU does double duty as
        host — §5.1). Every scheduling decision — whose package an idle
        unit serves, fusion staging/ripening, finalization — is a call
        into ``loop``, identical to an engine worker thread.

        Args:
            loop: the shared control plane built over this backend.
            entries: launches to admit, each at its ``t_submit``.
        """
        pending = collections.deque(sorted(entries,
                                           key=lambda e: e.t_submit))
        evq: list[tuple[float, int, int]] = []  # (t_idle, tiebreak, unit)
        tie = 0
        for i, u in enumerate(self.units):
            heapq.heappush(evq, (u.setup_s, tie, i))
            tie += 1

        while evq:
            t, _, i = heapq.heappop(evq)
            self.t = t
            while pending and pending[0].t_submit <= t + 1e-12:
                entry = pending.popleft()
                # open-loop arrival: the shed estimator may reject the
                # entry outright (same decision sequence as the engine)
                if not loop.offer(entry, now=entry.t_submit):
                    self.shed.append(entry)
            work = loop.pull(i, now=t, force_flush=not pending)
            if work is None:
                # nothing for this unit *now*: park until the next
                # submission or fusion-window ripening, else retire.
                wake = pending[0].t_submit if pending else None
                ripen = loop.admission.next_ripen_in(t)
                if ripen is not None:
                    t_r = t + max(ripen, 1e-9)
                    wake = t_r if wake is None else min(wake, t_r)
                if wake is not None:
                    heapq.heappush(evq, (max(wake, t + 1e-9), tie, i))
                    tie += 1
                continue
            entry, pkg = work
            self.dispatch(i, entry, pkg)
            loop.complete(entry, pkg)
            # the unit re-arms on the serial clock (busy_until), not the
            # recorded pipelined completion — pull pacing is what keeps
            # scheduler decisions depth-invariant
            heapq.heappush(evq, (self.busy_until[i], tie, i))
            tie += 1


def _run_sim(entries: Sequence[_SimLaunchState], units: Sequence["SimUnit"],
             cfg: AdmissionConfig, memory: MemoryModel, costs: MemoryCosts,
             validate: bool, pipeline_depth: int = 1
             ) -> tuple[SimBackend, ExecutionLoop]:
    """Drive the shared loop over a SimBackend until the entries finish."""
    backend = SimBackend(units, memory, costs,
                         pipeline_depth=pipeline_depth)
    loop = ExecutionLoop(backend, [u.name for u in units], cfg,
                         validate=validate)
    backend.run(loop, entries)
    settled = len(backend.delivered) + len(backend.shed)
    if settled != len(entries):
        shed_set = set(map(id, backend.shed))
        stuck = sorted(e.tenant for e in entries
                       if e.stats is None and not e.failed
                       and id(e) not in shed_set)
        raise RuntimeError(
            f"simulation finished {settled}/{len(entries)} "
            f"launches; admission wedged (undrained tenants: "
            f"{stuck or 'in-controller'}) — this is a scheduling bug, "
            f"not a caller error")
    return backend, loop


def simulate(scheduler: Optional[Scheduler], units: Sequence["SimUnit"],
             workload: Workload, *,
             memory: Optional[MemoryModel] = None,
             costs: MemoryCosts = MemoryCosts(),
             validate: bool = True, spec=None) -> SimResult:
    """Run the Commander loop in virtual time. Deterministic.

    Args:
        scheduler: fresh one-shot load balancer, or ``None`` to build one
            from ``spec`` (its policy/options/dist drive the split, with
            the units' calibrated speeds as the default hint).
        units: the simulated Coexecution Units.
        workload: the data-parallel problem.
        memory: package-movement cost model; ``None`` takes the spec's
            memory section (USM when no spec is given either).
        costs: calibrated data-movement cost parameters.
        validate: assert the packages exactly tile the index space.
        spec: optional :class:`~repro_torch.api.spec.CoexecSpec` — the same
            object that configures the real engine drives the DES, which
            is what keeps real-vs-sim parity spec-driven.

    Returns:
        The run's :class:`SimResult`.

    Raises:
        ValueError: scheduler/unit count mismatch, or ``scheduler=None``
            without a spec.
    """
    n = len(units)
    if memory is None:
        memory = spec.memory_model() if spec is not None else MemoryModel.USM
    if scheduler is None:
        if spec is None:
            raise ValueError("need a scheduler or a spec to build one from")
        speeds = spec.speeds_for(n) or [u.speed for u in units]
        scheduler = spec.scheduler.build(workload.total, n, speeds=speeds)
    if scheduler.num_units != n:
        raise ValueError("scheduler/unit count mismatch")

    entry = _SimLaunchState(0, scheduler, workload,
                            tenant=f"sim:{workload.name}")
    depth = int(spec.units.pipeline_depth) if spec is not None else 1
    backend, _ = _run_sim([entry], units, AdmissionConfig(), memory, costs,
                          validate, pipeline_depth=depth)
    stats = entry.stats
    return SimResult(
        workload=workload.name,
        policy=scheduler.name,
        memory=memory.value,
        total_s=backend.last_collect,
        unit_finish_s=backend.unit_finish,
        unit_busy_s=backend.unit_busy,
        host_busy_s=backend.host_busy,
        packages=stats.packages,
        num_packages=stats.num_packages,
        data=stats.data,
    )


def solo_run(unit: "SimUnit", workload: Workload, *,
             memory: MemoryModel = MemoryModel.USM,
             costs: MemoryCosts = MemoryCosts()) -> SimResult:
    """Baseline: the whole problem on one device, one package."""
    from .scheduler import StaticScheduler

    sched = StaticScheduler(workload.total, 1, speeds=[unit.speed])
    return simulate(sched, [unit], workload, memory=memory, costs=costs)


# ---------------------------------------------------------------------------
# Multi-launch DES: the admission layer in virtual time
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LaunchSpec:
    """One tenant's co-execution request for :func:`simulate_multi`.

    Attributes:
        workload: the data-parallel problem this launch computes.
        scheduler: fresh one-shot intra-launch load balancer.
        tenant: fairness flow (defaults to a unique per-launch tenant).
        weight: relative WFQ share of the tenant.
        t_submit: virtual submission time.
        deadline_s: relative SLO deadline in seconds after ``t_submit``;
            ``None`` falls back to the admission config's ``slo_ms``
            default (when set). Drives EDF urgency and load shedding.
    """

    workload: Workload
    scheduler: Scheduler
    tenant: str = ""
    weight: float = 1.0
    t_submit: float = 0.0
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class LaunchSimResult:
    """Completion record of one launch in a multi-launch simulation."""

    tenant: str
    workload: str
    t_submit: float
    t_finish: float
    items: int
    num_packages: int          # real dispatches that served this launch
    fused: bool = False        # served through a coalesced batch
    deadline: Optional[float] = None   # absolute virtual-time SLO target
    data: DataPlaneCounters = dataclasses.field(
        default_factory=DataPlaneCounters)

    @property
    def latency_s(self) -> float:
        """Submit-to-last-collection latency in virtual seconds."""
        return self.t_finish - self.t_submit

    @property
    def deadline_missed(self) -> Optional[bool]:
        """Whether the launch finished past its deadline (None = no SLO)."""
        if self.deadline is None:
            return None
        return self.t_finish > self.deadline


@dataclasses.dataclass
class ShedRecord:
    """One launch the admission layer rejected instead of serving."""

    tenant: str
    workload: str
    t_submit: float
    items: int
    deadline: Optional[float] = None


@dataclasses.dataclass
class MultiSimResult:
    """Timeline + per-launch metrics of one multi-tenant simulation.

    ``data`` aggregates the modeled data-plane accounting across every
    dispatched package (same surface as the real engine's per-launch
    counters: staging copies are zero under USM, one H2D + one D2H per
    package under BUFFERS); each :class:`LaunchSimResult` additionally
    carries its own share, produced by the shared loop's finalization —
    for fused batches the remainder-distributed integer split, so
    per-launch ``data`` sums back to the batch totals exactly.
    """

    total_s: float
    launches: list[LaunchSimResult]
    dispatched_packages: int   # real dispatches across all launches
    fused_batches: int
    fused_members: int
    host_busy_s: float
    # (t_complete, tenant, items) per dispatched package — service curve
    service: list[tuple[float, str, int]]
    shed: list[ShedRecord] = dataclasses.field(default_factory=list)
    # ("accept" | "shed", tenant) per offered launch, in offer order
    decisions: list[tuple[str, str]] = dataclasses.field(
        default_factory=list)
    # member-tenant tuples per materialized fused batch
    fusion_groups: list[tuple[str, ...]] = dataclasses.field(
        default_factory=list)
    data: DataPlaneCounters = dataclasses.field(
        default_factory=DataPlaneCounters)

    def latencies(self) -> list[float]:
        """Per-launch latencies in completion order."""
        return [r.latency_s for r in self.launches]

    def shed_fraction(self) -> float:
        """Rejected launches as a fraction of everything offered."""
        offered = len(self.launches) + len(self.shed)
        return len(self.shed) / offered if offered else 0.0

    def deadline_miss_rate(self) -> float:
        """Admitted launches that finished past their deadline.

        Returns:
            Misses over admitted deadline-carrying launches (0.0 when no
            launch carried a deadline). Shed launches are not counted —
            they never ran; :meth:`shed_fraction` reports them.
        """
        with_slo = [r for r in self.launches if r.deadline is not None]
        if not with_slo:
            return 0.0
        return sum(bool(r.deadline_missed) for r in with_slo) / len(with_slo)

    def tenant_service_until(self, t: float) -> dict[str, int]:
        """Work-items completed per tenant up to virtual time ``t``.

        Args:
            t: inclusive virtual-time horizon.

        Returns:
            Mapping tenant → items whose compute finished by ``t`` (the
            measure the WFQ fairness tests take ratios of).
        """
        served: dict[str, int] = {}
        for tc, tenant, items in self.service:
            if tc <= t:
                served[tenant] = served.get(tenant, 0) + items
        return served

    def fairness_curve(self, *, samples: int = 9) -> list[float]:
        """Time-sampled Jain fairness of per-tenant service.

        Args:
            samples: evenly spaced horizons to sample across the run.

        Returns:
            One Jain index per horizon (see
            :func:`~repro_torch.core.admission.service_fairness_curve`) — the
            curve preemptive pull-capping tightens.
        """
        from .admission import service_fairness_curve

        tenants = sorted({r.tenant for r in self.launches})
        return service_fairness_curve(self.service, tenants,
                                      samples=samples)


def simulate_multi(specs: Sequence[LaunchSpec], units: Sequence["SimUnit"], *,
                   admission=None,
                   memory: Optional[MemoryModel] = None,
                   costs: MemoryCosts = MemoryCosts(),
                   validate: bool = True, spec=None) -> MultiSimResult:
    """Run concurrent co-executions through the shared control plane.

    The exact :class:`~repro_torch.core.exec.ExecutionLoop` the real engine
    uses arbitrates which launch each idle unit serves — so FIFO vs WFQ
    fairness (with or without preemptive pull-capping), launch fusion and
    backpressure-free latency are measured deterministically.

    Args:
        specs: one :class:`LaunchSpec` per launch; schedulers must be
            fresh and built for ``len(units)``.
        admission: policy name, :class:`~.admission.AdmissionConfig`, or
            :class:`~repro_torch.api.spec.AdmissionSpec`; ``None`` takes the
            admission section of ``spec`` (plain FIFO without one).
        memory: USM or BUFFERS package-movement cost model; ``None``
            takes the spec's memory section (USM without one).
        costs: calibrated data-movement cost parameters.
        validate: assert each launch's packages exactly tile its space.
        spec: optional :class:`~repro_torch.api.spec.CoexecSpec` — the same
            object that configures the real engine supplies the admission
            and memory sections here, keeping both substrates in sync.

    Returns:
        A :class:`MultiSimResult` with per-launch latencies, the tenant
        service curve, and dispatch/fusion counters.

    Raises:
        ValueError: on a scheduler/unit-count mismatch or non-positive
            tenant weight.
    """
    n = len(units)
    if memory is None:
        memory = spec.memory_model() if spec is not None else MemoryModel.USM
    if admission is None and spec is not None:
        cfg = spec.admission_config()
    else:
        cfg = coerce_admission(admission)
    for ls in specs:
        if ls.scheduler.num_units != n:
            raise ValueError("scheduler/unit count mismatch in spec")

    def fuse_key(ls: LaunchSpec):
        if not cfg.fuse or ls.workload.total > cfg.fuse_threshold:
            return None
        wl = ls.workload
        if cfg.fuse_buckets:
            return (wl.name, "bucket", fusion_bucket(wl.total),
                    wl.bytes_in_per_item, wl.bytes_out_per_item)
        return (wl.name, wl.total, wl.bytes_in_per_item,
                wl.bytes_out_per_item)

    entries = []
    for i, ls in enumerate(specs):
        entry = _SimLaunchState(i, ls.scheduler, ls.workload,
                                tenant=ls.tenant or f"launch-{i}",
                                weight=ls.weight, t_submit=ls.t_submit)
        entry.fuse_key = fuse_key(ls)
        if entry.fuse_key is not None and cfg.fuse_buckets:
            entry.fuse_bucket = fusion_bucket(ls.workload.total)
        if ls.deadline_s is not None:
            entry.deadline = ls.t_submit + ls.deadline_s
        elif cfg.slo_ms is not None:
            entry.deadline = ls.t_submit + cfg.slo_ms / 1e3
        entries.append(entry)

    depth = int(spec.units.pipeline_depth) if spec is not None else 1
    backend, loop = _run_sim(entries, units, cfg, memory, costs, validate,
                             pipeline_depth=depth)

    results = [LaunchSimResult(
        tenant=e.tenant, workload=e.workload.name, t_submit=e.t_submit,
        t_finish=max(p.t_collected for p in e.stats.packages),
        items=e.scheduler.total, num_packages=e.stats.num_packages,
        fused=e.fused, deadline=e.deadline,
        data=e.stats.data) for e in backend.delivered]

    shed = [ShedRecord(tenant=e.tenant, workload=e.workload.name,
                       t_submit=e.t_submit, items=e.workload.total,
                       deadline=e.deadline) for e in backend.shed]

    return MultiSimResult(
        total_s=backend.last_collect,
        launches=results,
        dispatched_packages=loop.admission.dispatched,
        fused_batches=loop.admission.fused_batches,
        fused_members=loop.admission.fused_members,
        host_busy_s=backend.host_busy,
        service=backend.service,
        shed=shed,
        decisions=list(loop.admission.decision_log),
        fusion_groups=list(loop.admission.fusion_log),
        data=backend.counters,
    )
