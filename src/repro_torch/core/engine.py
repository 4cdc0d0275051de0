"""Persistent co-execution engine (EngineCL-style, arXiv:1805.02755).

The paper's antecedent EngineCL shows that co-execution management overhead
stays under 1% only when the runtime is a *persistent engine*: worker threads
are created once and fed work, instead of being spawned and joined per
launch. This module provides that engine for the Coexecutor Runtime:

* one long-lived management thread per Coexecution Unit, started by
  :meth:`CoexecEngine.start` and parked on a condition variable when idle;
* a multi-tenant launch queue — any number of callers may
  :meth:`CoexecEngine.submit` co-executions concurrently; packages from all
  in-flight launches interleave on the same units under the engine's
  admission policy (FIFO by default — the Commander protocol of Fig. 2a —
  or weighted-fair queueing across tenants, optionally with preemptive
  pull-capping);
* the shared control plane of :class:`~repro_torch.core.exec.ExecutionLoop`
  between ``submit`` and the workers: the same loop as the reference
  decides admission pulls, launch fusion + de-mux, finalization and
  counter attribution here —
  this module contributes only the :class:`RealBackend` execution
  substrate (threads, wall clock, data-plane dispatch on
  :class:`~repro_torch.core.units.TorchUnit`\\ s, each worker on its
  unit's CUDA stream);
* per-launch isolation — each launch owns its scheduler, output container,
  package log and :class:`LaunchStats`; completion is surfaced through a
  :class:`LaunchHandle` future, so independent callers never observe each
  other's state;
* a persistent :class:`~.profiler.SpeedBoard` — throughput measured on
  earlier launches seeds the adaptive (HGuided) speed refinement of later
  ones, which a per-launch thread pool could never do;
* a per-memory-model data plane (:mod:`~repro_torch.core.dataplane`) between
  the workers and the units: the spec's ``MemorySpec`` selects zero-copy
  unified-shared-memory movement or per-package staged buffers, with
  copy/dispatch counters surfaced in each launch's :class:`LaunchStats`.

Configuration is declarative only: build a
:class:`~repro_torch.api.spec.CoexecSpec`.

Lifecycle::

    engine = CoexecEngine.from_spec(spec)       # or CoexecEngine(units,
    engine.start()                              #        spec=spec)
    h1 = engine.submit(sched1, kernel_a, inputs_a, out_a, tenant="u1")
    h2 = engine.submit(sched2, kernel_b, inputs_b, out_b, tenant="u2")
    out_a = h1.result(); out_b = h2.result()
    engine.shutdown()            # drains in-flight launches, joins threads

or, scoped::

    with CoexecEngine(units) as engine:
        out = engine.submit(sched, kernel, inputs, out).result()
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from .admission import (AdmissionConfig, AdmissionController, AdmissionFull,
                        LaunchShed, fusion_bucket)
from .dataplane import (ArgSpec, CoexecKernel, DataPlaneCounters,
                        OutputSpec, as_coexec_kernel, make_plane,
                        page_aligned_zeros)
from .exec import Backend, ExecutionLoop, LaunchState, LaunchStats, Span
from .memory import MemoryModel
from .package import Package
from .profiler import SpeedBoard
from .scheduler import DynamicScheduler, HGuidedScheduler, Scheduler
from .units import TorchUnit

# Pre-3.11 `concurrent.futures.TimeoutError` is not the builtin; subclass
# whichever classes exist so `except TimeoutError` catches both flavors.
_TIMEOUT_BASES = ((TimeoutError,)
                  if concurrent.futures.TimeoutError is TimeoutError
                  else (concurrent.futures.TimeoutError, TimeoutError))


class LaunchWaitTimeout(*_TIMEOUT_BASES):
    """The *wait* on a LaunchHandle timed out; the launch itself is fine.

    Distinguishes "I gave up waiting" from "the launch failed": a launch
    whose kernel raised ``TimeoutError`` surfaces that original exception
    from :meth:`LaunchHandle.result` / returns it from
    :meth:`LaunchHandle.exception`, never this class. Subclasses
    ``TimeoutError`` (both flavors), so broad handlers keep working.
    """


class LaunchHandle:
    """Future for one submitted co-execution.

    ``result()`` blocks until the launch's whole index space has been
    computed and collected, then returns the output container. ``stats``
    is populated before the future resolves.
    """

    def __init__(self, launch_id: int):
        self.launch_id = launch_id
        self.stats: Optional[LaunchStats] = None
        self._future: concurrent.futures.Future = concurrent.futures.Future()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the launch completes and return its output.

        Args:
            timeout: max seconds to wait; ``None`` waits forever.

        Returns:
            The launch's output container (the ``out`` array passed to
            ``submit``, now fully written).

        Raises:
            LaunchWaitTimeout: the wait timed out while the launch is
                still in flight (never raised for a finished launch).
            BaseException: whatever the launch itself failed with — a
                kernel's own ``TimeoutError`` surfaces as-is and is
                therefore distinguishable from a wait timeout.
        """
        try:
            return self._future.result(timeout)
        except _TIMEOUT_BASES as e:
            if not self._future.done():
                raise LaunchWaitTimeout(
                    f"launch {self.launch_id} still in flight after "
                    f"{timeout}s") from None
            if self._future.exception() is e:
                raise    # the launch *failed* with a TimeoutError: keep it
            # the launch settled in the instant after the wait expired:
            # surface its real outcome, not the raced wait timeout
            return self._future.result()

    def exception(self, timeout: Optional[float] = None):
        """Block until the launch settles and return its exception.

        Args:
            timeout: max seconds to wait; ``None`` waits forever.

        Returns:
            The exception the launch failed with (``TimeoutError``
            included — returned, not raised), or ``None`` on success.

        Raises:
            LaunchWaitTimeout: the wait timed out while the launch is
                still in flight. This is the only exception this method
                raises, so raise-vs-return cleanly separates "gave up
                waiting" from "launch failed".
        """
        try:
            return self._future.exception(timeout)
        except _TIMEOUT_BASES:
            if not self._future.done():
                raise LaunchWaitTimeout(
                    f"launch {self.launch_id} still in flight after "
                    f"{timeout}s") from None
            # settled in the instant after the wait expired (a stored
            # TimeoutError is *returned* above, never raised, so the only
            # raise path here is the raced wait timeout)
            return self._future.exception()

    def done(self) -> bool:
        """Whether the launch has completed (successfully or not)."""
        return self._future.done()

    @property
    def packages(self) -> list[Package]:
        """Packages served for this launch (empty until completion)."""
        return self.stats.packages if self.stats is not None else []


class _Launch(LaunchState):
    """Engine payload of one in-flight co-execution (real arrays, future).

    The control-plane fields live on :class:`~repro_torch.core.exec.LaunchState`
    (the shared loop reads/writes only those); this subclass adds what
    the :class:`RealBackend` needs to actually run packages, and
    ``spans``: the ``plan`` and ``admit`` spans, until its stats exist.
    """

    __slots__ = ("kernel", "inputs", "out", "adaptive", "handle", "plan",
                 "on_units", "outcome", "spans")

    def __init__(self, launch_id: int, scheduler: Scheduler, kernel: Callable,
                 inputs: Sequence[np.ndarray], out: np.ndarray,
                 adaptive: bool):
        super().__init__(launch_id, scheduler,
                         t_submit=time.perf_counter())
        self.kernel = kernel
        self.inputs = inputs
        self.out = out
        self.adaptive = adaptive
        self.handle = LaunchHandle(launch_id)
        self.plan = None             # LaunchPlan, set by the engine
        # packages pulled by an engine worker and not yet completed by
        # it, zombies of a killed unit included (guarded by the engine's
        # lock), and the result or error waiting for them to drain
        self.on_units = 0
        self.outcome = None
        self.spans: list[Span] = []


def _fuse_key(config: AdmissionConfig, scheduler: Scheduler,
              kernel: CoexecKernel, inputs: Sequence[np.ndarray],
              out: np.ndarray):
    """Coalescing key, or None when this launch is not fusion-eligible.

    Eligible launches are small (≤ ``fuse_threshold`` items) with every
    input and the output indexed by the full index space on axis 0 —
    the shape contract that makes member stacking a pure reshape.
    Kernels with broadcast args, halos or non-zero split axes are
    ineligible (their operands do not stack along the member axis).

    With ``config.fuse_buckets`` the key holds the power-of-2 size
    bucket plus the per-array *trailing* shapes instead of the exact
    shapes, so near-identical launches coalesce: members pad up to the
    bucket along axis 0 in :meth:`RealBackend.fuse_payload` and de-mux
    back to their exact extents in :meth:`RealBackend.commit_member`.
    """
    if not config.fuse or not kernel.all_split:
        return None
    total = scheduler.total
    if total > config.fuse_threshold:
        return None
    arrs = [np.asarray(a) for a in inputs]
    if any(a.ndim < 1 or a.shape[0] != total for a in arrs):
        return None
    if out.shape[0] != total:
        return None
    if config.fuse_buckets:
        return (kernel, "bucket", fusion_bucket(total),
                tuple((a.shape[1:], str(a.dtype)) for a in arrs),
                tuple(out.shape[1:]), str(out.dtype))
    return (kernel, total,
            tuple((a.shape, str(a.dtype)) for a in arrs),
            tuple(out.shape), str(out.dtype))


@dataclasses.dataclass(frozen=True)
class _FusedBody:
    """Body of a fused batch: whole members at member-local offset 0.

    A fused package covers whole members, so each member's chunk spans
    its entire index space and the right kernel offset is 0; this takes
    the place of the reference's ``jax.vmap`` over the member axis. The
    chunks and ``out`` are member-stacked ``(members, bucket, ...)``. A
    ``rowwise`` kernel runs them as one ``(members * bucket, ...)`` chunk
    written straight into ``out`` (one hand-kernel launch per package);
    any other kernel runs once per member, which keeps a body that reads
    ``offset`` faithful to its unfused execution.
    """

    kernel: CoexecKernel

    def __call__(self, offset, *chunks, out):
        fn = self.kernel.fn
        if self.kernel.rowwise:
            rows = out.shape[0] * out.shape[1]
            fn(0, *(c.view(rows, *c.shape[2:]) for c in chunks),
               out=out.view(rows, *out.shape[2:]))
        else:
            for i in range(out.shape[0]):
                fn(0, *(c[i] for c in chunks), out=out[i])
        return out


class RealBackend(Backend):
    """Wall-clock torch execution substrate for the shared control plane.

    Supplies what :class:`~repro_torch.core.exec.ExecutionLoop` cannot decide —
    real time, real dispatch through the configured data plane on each
    unit's stream, member stacking for fused batches, and future
    resolution — while
    every scheduling decision stays in the loop. The engine's worker
    threads call :meth:`dispatch` outside the engine lock; everything
    else runs caller-serialized like the loop itself.
    """

    def __init__(self, units: Sequence[TorchUnit], plane, *,
                 board: Optional[SpeedBoard] = None,
                 condition: Optional[threading.Condition] = None):
        self.units = list(units)
        self.plane = plane
        self.board = board
        self.condition = condition
        # set once by the engine, before its workers start, for the
        # dead-unit guard of elastic membership
        self.loop = None  # guarded-by: caller
        # set by the engine: a launch resolves only once none of its
        # packages runs on a unit and its output is unmapped (settle)
        self.settles = False
        # the unit index of an engine worker's thread (see serve_on)
        self._thread = threading.local()

    def serve_on(self, unit: int) -> None:
        """Mark the calling thread as the worker of ``unit``.

        A ``settle`` span the thread records names that unit.
        """
        self._thread.unit = unit

    # -- substrate contract -------------------------------------------------
    def now(self) -> float:
        """Wall-clock seconds (``time.perf_counter``)."""
        return time.perf_counter()

    def dispatch(self, unit: int, launch: _Launch, pkg: Package) -> None:
        """Run one package through the data plane on a real unit.

        Args:
            unit: index of the serving Coexecution Unit.
            launch: the owning launch (its ``plan`` carries the bound
                arrays and counters).
            pkg: the package to execute; the plane stamps
                ``t_complete``/``t_collected``.
        """
        if self.loop is not None and unit in self.loop.dead_units:
            # the unit was declared dead after this worker pulled: the
            # package is already disowned and its range re-issued, so
            # executing it would double-compute (and double-count) —
            # drop it; the loop's ledger drops the zombie completion too
            return
        self.plane.execute(self.units[unit], launch.plan, pkg)
        if self.board is not None:
            self.board.record(unit, pkg.size,
                              max(pkg.t_complete - pkg.t_issue, 1e-9))

    # -- pipelined dispatch (phases of `dispatch`, overlappable) ------------
    def begin(self, unit: int, launch: _Launch, pkg: Package):
        """Stage + issue one package without waiting for the device.

        The first two data-plane phases of :meth:`dispatch`: materialize
        the package's inputs and launch the kernel asynchronously. The
        worker may then pull and stage further packages while this one
        computes, up to its pipeline depth.

        Args:
            unit: index of the serving Coexecution Unit.
            launch: the owning launch.
            pkg: the package to put in flight.

        Returns:
            The in-flight device output handle for :meth:`finish`, or
            ``None`` when the unit is already dead (the package was
            disowned and re-issued; its completion is a zombie).
        """
        if self.loop is not None and unit in self.loop.dead_units:
            return None
        u = self.units[unit]
        with u.stream_context():
            staged = self.plane.stage(u, launch.plan, pkg)
            return self.plane.issue(u, launch.plan, pkg, staged)

    def finish(self, unit: int, launch: _Launch, pkg: Package, out_dev,
               *, busy_floor: float = 0.0) -> None:
        """Await and collect one in-flight package (phase 3).

        Blocks on the device result, lands it in the launch's output
        container and feeds the SpeedBoard. ``busy_floor`` is the
        previous package's completion time on this unit: with several
        packages in flight their issue→complete spans overlap, so busy
        time and throughput are measured from whichever is later —
        issue or the moment the device actually became free.

        Args:
            unit: index of the serving Coexecution Unit.
            launch: the owning launch.
            pkg: the package to complete (in issue order per unit).
            out_dev: handle from :meth:`begin` (``None`` = dropped).
            busy_floor: completion time of the unit's previous package.
        """
        if out_dev is None:
            return
        u = self.units[unit]
        with u.stream_context():
            self.plane.complete(u, launch.plan, pkg, out_dev,
                                busy_floor=busy_floor)
        if self.board is not None:
            self.board.record(
                unit, pkg.size,
                max(pkg.t_complete - max(pkg.t_issue, busy_floor), 1e-9))

    def wait_next_event(self, timeout: Optional[float] = None) -> None:
        """Park the calling worker on the engine's condition variable.

        Args:
            timeout: max seconds to sleep, or ``None`` to wait for the
                next notify (every state change — submit, completion,
                kill/join, shutdown — notifies, so no poll is needed).
                The caller must hold the condition.
        """
        if self.condition is not None:
            self.condition.wait(timeout=timeout)

    # -- payload hooks ------------------------------------------------------
    def refresh_speeds(self, launch: _Launch) -> None:
        """Feed SpeedBoard throughput into an adaptive launch's scheduler."""
        if (self.board is not None and getattr(launch, "adaptive", False)
                and isinstance(launch.scheduler, HGuidedScheduler)):
            for i, s in enumerate(self.board.speeds()):
                launch.scheduler.update_speed(i, s)

    def fuse_payload(self, members: list[_Launch],
                     launch_id: int) -> _Launch:
        """Stack member inputs along a new leading *member* axis.

        The fused index space is the member count, split across units by
        a Dynamic scheduler with one package per unit, so N small
        requests cost ~one dispatch per unit. One scheduler unit is one
        member, so ``wfq_cost_scale`` converts credit back to work-items.

        Args:
            members: the staged same-shaped launches to coalesce.
            launch_id: id assigned by the loop.

        Returns:
            The fused engine launch (tenant/weight set by the loop).
        """
        first = members[0]
        # bucketed members pad along axis 0 up to the shared power-of-2
        # bucket; exact-shape fusion has bucket == total (no padding)
        bucket = first.fuse_bucket or max(m.scheduler.total for m in members)

        def stacked(j: int) -> np.ndarray:
            # zero pad rows past each member's extent; the batch owns its
            # pages, so USM copies it to a CUDA unit as it stands
            a = np.asarray(first.inputs[j])
            batch = page_aligned_zeros((len(members), bucket, *a.shape[1:]),
                                       a.dtype)
            for k, m in enumerate(members):
                batch[k, :np.asarray(m.inputs[j]).shape[0]] = m.inputs[j]
            return batch

        inputs = [stacked(j) for j in range(len(first.inputs))]
        out = page_aligned_zeros((len(members), bucket, *first.out.shape[1:]),
                                 first.out.dtype)
        n_units = len(self.units)
        sched = DynamicScheduler(len(members), n_units,
                                 num_packages=min(len(members), n_units))
        kernel = CoexecKernel(
            f"{first.kernel.name}[fused]", _FusedBody(first.kernel),
            tuple(ArgSpec(a.name) for a in first.kernel.args),
            OutputSpec(dtype=first.kernel.out.dtype))
        fused = _Launch(launch_id, sched, kernel, inputs, out,
                        adaptive=False)
        fused.plan = self.plane.plan(kernel, inputs, out, sched.total,
                                     units=self.units)
        # the fused scheduler's index space is *members*; WFQ credit is
        # accounted in work-items, so each member unit costs its whole
        # (bucket-padded) index space — keeps engine fairness on the
        # sim's scale, identically for exact and bucketed fusion
        fused.wfq_cost_scale = bucket
        fused.fuse_bucket = bucket
        fused.member_span = 1
        return fused

    def launch_counters(self, launch: _Launch) -> DataPlaneCounters:
        """The launch's data-plane accounting (from its plan)."""
        return launch.plan.counters.snapshot()

    def commit_member(self, fused: _Launch, member: _Launch, index: int,
                      cover: Package) -> None:
        """Copy one member's output row out of the fused batch result.

        Bucketed members copy only their own extent — the bucket's pad
        rows are computed (on padded zero inputs) but never land. The
        member's own plan never ran a package; :meth:`deliver` releases
        it.
        """
        np.copyto(member.out, fused.out[index][:member.out.shape[0]])

    def deliver(self, launch: _Launch) -> None:
        """Resolve the launch's future with its (now written) output."""
        launch.stats.spans[:0] = launch.spans
        launch.handle.stats = launch.stats
        self._resolve(launch, launch.out)

    def fail(self, launch: _Launch, err: BaseException) -> None:
        """Resolve the launch's future with its failure."""
        self._resolve(launch, err)

    def _resolve(self, launch: _Launch, outcome) -> None:
        """Resolve now, or, under an engine, once the launch settles.

        Under USM a CUDA unit writes the launch's output through its
        page-locked mapping and reads device copies of its inputs, so the
        caller gets them back only when no package of the launch (a
        killed unit's zombie included) runs on a unit, the copies are
        freed and the mapping is gone: a copy the caller makes of ``out``
        can then never race the unmapping. A fused member's own plan
        never ran a package: it is released here in any case.
        """
        if self.settles and launch.on_units:
            launch.outcome = outcome        # settle() resolves it
            return
        if launch.plan is not None and (self.settles or launch.fused):
            self._release(launch)
        _set_outcome(launch, outcome)

    def settle(self, launch: _Launch) -> None:
        """Unmap a launch none of whose packages runs, then resolve it."""
        self._release(launch)
        outcome, launch.outcome = launch.outcome, None
        if outcome is not None:
            _set_outcome(launch, outcome)

    def _release(self, launch: _Launch) -> None:
        """Release the launch's plan, as its ``settle`` span if it has
        stats, on the unit of the worker thread that runs it."""
        t0 = time.perf_counter()
        waited = launch.plan.release()
        if launch.stats is not None:
            launch.stats.spans.append(Span(
                "settle", launch.id, "launch", t0, time.perf_counter(),
                unit=getattr(self._thread, "unit", None),
                counts=_lock_wait(waited)))


def _lock_wait(seconds: Optional[float]) -> tuple:
    """A span's ``lock_wait_s`` count: none where no range was (un)mapped."""
    return () if seconds is None else (("lock_wait_s", seconds),)


def _set_outcome(launch: _Launch, outcome) -> None:
    """Set the launch's future to its output or its error."""
    if isinstance(outcome, BaseException):
        launch.handle._future.set_exception(outcome)
    else:
        launch.handle._future.set_result(outcome)


class CoexecEngine:
    """Long-lived per-unit worker threads fed from a multi-tenant queue.

    The queueing discipline between ``submit`` and the workers is the
    shared :class:`~repro_torch.core.exec.ExecutionLoop` (``engine.loop``) and
    its :class:`~.admission.AdmissionController` (``engine.admission``):
    FIFO, weighted-fair or EDF (optionally preemptive), deadline
    shedding and backpressure — the reference's control plane.
    """

    def __init__(self, units: Sequence[TorchUnit], *, spec=None):
        """Build an engine over a fixed set of Coexecution Units.

        Configuration is a declarative
        :class:`~repro_torch.api.spec.CoexecSpec` (``spec=`` here, or
        :meth:`from_spec` to also build the units); with no spec the
        engine runs USM memory and plain FIFO admission.

        Args:
            units: the Coexecution Units; one worker thread each.
            spec: a ``CoexecSpec`` supplying memory + admission config.

        Raises:
            ValueError: empty unit list or invalid spec sections.
        """
        if not units:
            raise ValueError("need at least one Coexecution Unit")
        self.units = list(units)
        if spec is not None:
            self.spec = spec
            self.memory = spec.memory_model()
            cfg = spec.admission_config()
        else:
            self.spec = None
            self.memory = MemoryModel.USM
            cfg = AdmissionConfig()
        # the data plane implementing self.memory: USM = zero-copy shared
        # views + in-place collection, BUFFERS = per-package staging copies
        self.plane = make_plane(self.memory)
        # packages a unit may have in flight: 1 = serial stage/compute/
        # collect; >= 2 overlaps staging/collection with device compute
        self.pipeline_depth = max(
            1, int(spec.units.pipeline_depth)) if spec is not None else 1
        self.board = SpeedBoard(len(self.units),
                                hints=[u.speed_hint for u in self.units])
        self._cv = threading.Condition()
        self.backend = RealBackend(self.units, self.plane, board=self.board,
                                   condition=self._cv)
        self.backend.settles = True
        self.loop = ExecutionLoop(self.backend,
                                  [u.name for u in self.units], cfg)
        self.backend.loop = self.loop   # dead-unit dispatch guard
        self._threads: list[threading.Thread] = []  # guarded-by: _cv
        self._stop = False  # guarded-by: _cv
        self._started = False  # guarded-by: _cv

    @classmethod
    def from_spec(cls, spec, *, units: Optional[Sequence[TorchUnit]] = None
                  ) -> "CoexecEngine":
        """Build an engine entirely from a :class:`CoexecSpec`.

        Args:
            spec: the declarative configuration; its ``units`` section is
                materialized unless ``units`` is supplied.
            units: pre-built Coexecution Units overriding the spec's
                ``units`` section.

        Returns:
            A constructed (not yet started) engine.
        """
        units = list(units) if units is not None else spec.build_units()
        return cls(units, spec=spec)

    @property
    def admission(self) -> AdmissionController:
        """The shared loop's admission controller (policy + counters)."""
        return self.loop.admission

    # -- lifecycle ---------------------------------------------------------
    @property
    def running(self) -> bool:
        """Whether the engine has started and not yet shut down."""
        with self._cv:
            return self._started and not self._stop

    def start(self) -> "CoexecEngine":
        """Spawn the per-unit management threads (idempotent).

        Returns:
            The engine itself, for chaining.

        Raises:
            RuntimeError: if the engine was already shut down.
        """
        with self._cv:
            if self._started:
                if self._stop:
                    raise RuntimeError("engine was shut down; build a new one")
                return self
            self._started = True
            self._threads = threads = [
                threading.Thread(target=self._worker, args=(i,),
                                 name=f"counit-{u.name}-{i}", daemon=True)
                for i, u in enumerate(self.units)]
        for t in threads:
            t.start()
        return self

    def shutdown(self, wait: bool = True) -> None:
        """Stop accepting launches; drain in-flight ones, join workers.

        Args:
            wait: block until every worker thread has exited.
        """
        with self._cv:
            self._stop = True
            self._cv.notify_all()
            threads = list(self._threads)
        if wait:
            for t in threads:
                t.join()

    def kill_unit(self, unit_idx: int) -> int:
        """Declare one Coexecution Unit dead; its work re-issues exactly.

        The unit's in-flight packages are disowned and their exact ranges
        re-emitted to the surviving units (the loop's ownership ledger
        guarantees exact-once accounting), per-unit scheduler
        reservations are harvested, and the unit's worker thread parks —
        a completion it races in is dropped as a zombie. Pending
        ``LaunchHandle`` objects resolve normally once survivors finish the
        re-issued cover; no handle ever spuriously times out or errors
        because a unit died.

        Args:
            unit_idx: index of the unit to fail.

        Returns:
            Number of in-flight/reserved ranges queued for re-issue.

        Raises:
            RuntimeError: killing the last live unit (nothing could
                serve the re-issued work).
        """
        with self._cv:
            live = len(self.units) - len(self.loop.dead_units)
            if unit_idx not in self.loop.dead_units and live <= 1:
                raise RuntimeError("cannot kill the last live unit")
            moved = self.loop.unit_lost(unit_idx)
            self._cv.notify_all()
        return moved

    def kill_unit_when_held(self, unit_idx: int, handle: LaunchHandle,
                            poll_s: float = 1e-4) -> Optional[int]:
        """Kill a unit the moment it holds a package of a running launch.

        The check and the kill happen under the engine's lock, so the
        package cannot complete in between.

        Args:
            unit_idx: index of the unit to fail.
            handle: the running launch to watch.
            poll_s: seconds between checks.

        Returns:
            What :meth:`kill_unit` returns, or ``None`` when the launch
            finished before the unit held a package.
        """
        while not handle.done():
            with self._cv:
                if self.loop.in_flight_of(unit_idx):
                    return self.kill_unit(unit_idx)
            time.sleep(poll_s)
        return None

    def join_unit(self, unit_idx: int) -> None:
        """Bring a previously killed unit back into the pool.

        Args:
            unit_idx: index of a provisioned (possibly dead) unit.
        """
        with self._cv:
            self.loop.unit_joined(unit_idx,
                                  speed=self.units[unit_idx].speed_hint)
            self._cv.notify_all()

    def __enter__(self) -> "CoexecEngine":
        """Start the engine on context entry."""
        return self.start()

    def __exit__(self, *exc) -> None:
        """Drain and shut the engine down on context exit."""
        self.shutdown()

    # -- submission --------------------------------------------------------
    def submit(self, scheduler: Scheduler, kernel: Callable,
               inputs: Sequence[np.ndarray], out: np.ndarray,
               *, adaptive: bool = True, tenant: Optional[str] = None,
               weight: float = 1.0, block: bool = True,
               deadline_s: Optional[float] = None,
               t_plan: Optional[float] = None) -> LaunchHandle:
        """Enqueue one co-execution; returns immediately with its handle.

        The scheduler must be built for this engine's unit count. Packages
        are pulled on demand by whichever units go idle, interleaved with
        every other in-flight launch under the admission policy.

        Args:
            scheduler: fresh one-shot load balancer for this launch.
            kernel: a typed :class:`~.dataplane.CoexecKernel`, or a legacy
                positional closure ``fn(offset, *chunks) -> chunk_out``
                on tensors (treated as all-``SPLIT`` axis-0 arguments).
            inputs: full host input arrays (moved per the kernel's
                declared per-argument semantics and the engine's memory
                model; a typed kernel's trailing ``BROADCAST`` defaults
                may be omitted).
            out: preallocated output container the results land in.
            adaptive: refresh HGuided speeds from the engine's SpeedBoard.
            tenant: fairness flow this launch belongs to; defaults to a
                per-launch tenant (WFQ then means fair across launches).
            weight: relative WFQ share of the tenant (latest submit wins).
            block: when the engine is at ``max_inflight`` capacity, wait
                for a slot (True) or raise immediately (False).
            deadline_s: relative SLO deadline in seconds from submission;
                ``None`` falls back to the admission config's ``slo_ms``
                default (when set). Under ``shed=True`` a launch whose
                estimated finish misses this deadline is rejected — its
                handle resolves *immediately* with
                :class:`~repro_torch.core.admission.LaunchShed`, on both the
                blocking and non-blocking submit paths.
            t_plan: ``time.perf_counter()`` at which the caller began
                planning the launch (the start of its ``plan`` span);
                default this call's entry.

        Returns:
            The launch's :class:`LaunchHandle`.

        Raises:
            ValueError: mismatched unit count, reused scheduler,
                non-positive weight, or inputs that do not satisfy the
                kernel's declared argument semantics.
            RuntimeError: engine not started, or shut down.
            AdmissionFull: at capacity and ``block=False``.
        """
        if t_plan is None:
            t_plan = time.perf_counter()
        kernel = as_coexec_kernel(kernel, len(inputs))
        if scheduler.num_units != len(self.units):
            raise ValueError(
                f"scheduler built for {scheduler.num_units} units, engine "
                f"has {len(self.units)}")
        if scheduler.issued or scheduler.done():
            # A drained scheduler would hand out no packages, so the launch
            # could never reach its completion path (and would wedge
            # shutdown's drain). Schedulers are one-shot by design.
            raise ValueError("scheduler has already issued work; build a "
                             "fresh scheduler per launch")
        if weight <= 0:
            raise ValueError("weight must be positive")
        # plan time: bind the arrays (USM maps the output for CUDA
        # units), then load the kernel once per unit outside the engine
        # lock, so no first dispatch charges the library load to a unit's
        # busy clock — it would otherwise poison the adaptive speed
        # estimates
        plan = self.plane.plan(kernel, inputs, out, scheduler.total,
                               units=self.units)
        try:
            self.plane.prewarm(self.units, plan,
                               getattr(scheduler, "granularity", 1))
            return self._admit(scheduler, kernel, inputs, out, plan,
                               adaptive=adaptive, tenant=tenant,
                               weight=weight, block=block,
                               deadline_s=deadline_s,
                               planned=(t_plan, time.perf_counter()))
        except BaseException:
            plan.release()
            raise

    def _admit(self, scheduler, kernel, inputs, out, plan, *, adaptive,
               tenant, weight, block, deadline_s, planned) -> LaunchHandle:
        """Enqueue one planned launch under the engine lock.

        ``planned`` is the ``plan`` span's start and end; the ``admit``
        span runs from that end to the offer to the loop (``t_submit``).
        """
        with self._cv:
            if self._stop:
                raise RuntimeError("engine is shut down")
            if not self._started:
                raise RuntimeError("engine not started; call start() first "
                                   "(or use it as a context manager)")
            while not self.admission.has_capacity():
                if not block:
                    raise AdmissionFull(
                        f"{self.admission.in_flight} launches in flight "
                        f"(max_inflight="
                        f"{self.admission.config.max_inflight})")
                self._cv.wait(timeout=0.05)
                if self._stop:
                    raise RuntimeError("engine is shut down")
            launch = _Launch(self.loop.next_id(), scheduler, kernel, inputs,
                             out, adaptive)
            launch.plan = plan
            launch.spans += [
                Span("plan", launch.id, "launch", *planned,
                     counts=_lock_wait(plan.map_lock_wait_s)),
                Span("admit", launch.id, "launch", planned[1],
                     launch.t_submit)]
            if tenant is not None:
                launch.tenant = str(tenant)
            launch.weight = float(weight)
            if deadline_s is not None:
                launch.deadline = launch.t_submit + float(deadline_s)
            launch.fuse_key = _fuse_key(self.admission.config, scheduler,
                                        kernel, inputs, out)
            if launch.fuse_key is not None \
                    and self.admission.config.fuse_buckets:
                launch.fuse_bucket = fusion_bucket(scheduler.total)
            if not self.loop.offer(launch, now=launch.t_submit):
                # shed: resolve the handle before returning so result()
                # raises LaunchShed immediately instead of blocking until
                # a wait timeout (the future carries a pre-set exception)
                plan.release()
                self.backend.fail(launch, LaunchShed(
                    f"launch {launch.id} shed: estimated finish misses its "
                    f"deadline under the offered load"))
                return launch.handle
            self._cv.notify_all()
        return launch.handle

    # -- worker loop -------------------------------------------------------
    def _retire_oldest(self, unit_idx: int, inflight: collections.deque,
                       busy_floor: float) -> float:
        """Complete the unit's oldest in-flight package, in issue order.

        Blocks on the device result outside the lock, then re-enters the
        loop under ``_cv`` to record the completion — zombies (packages
        disowned by ``unit_lost`` mid-flight) are dropped by the loop's
        ownership ledger exactly like the serial path's.

        Args:
            unit_idx: the worker's unit index.
            inflight: the worker's in-flight FIFO (oldest first).
            busy_floor: completion time of the previous package.

        Returns:
            The new busy floor (this package's completion time).
        """
        launch, pkg, out_dev = inflight.popleft()
        try:
            self.backend.finish(unit_idx, launch, pkg, out_dev,
                                busy_floor=busy_floor)
        except BaseException as e:
            self._complete(launch, pkg, error=e)
            return busy_floor
        self._complete(launch, pkg)
        return pkg.t_complete or busy_floor

    def _complete(self, launch: _Launch, pkg: Package,
                  error: Optional[BaseException] = None) -> None:
        """Record one package in the loop; settle the launch once drained.

        A launch's mapped host ranges (USM on a CUDA unit) are unmapped,
        and its future resolved, only when it is finalized *and* no
        package of it still runs on any unit — a failed launch may have
        siblings running, a killed unit a zombie.
        """
        with self._cv:
            self.loop.complete(launch, pkg, error=error)
            launch.on_units -= 1
            settled = launch.finalized and launch.on_units == 0
            self._cv.notify_all()
        if settled:
            self.backend.settle(launch)

    def _worker(self, unit_idx: int) -> None:
        """One Coexecution Unit's management thread, pipelined per unit.

        Pull → stage+issue → complete, with up to ``pipeline_depth``
        packages in flight: while package *k* computes on the device the
        worker pulls and stages *k+1* and collects *k-1*, so the device
        no longer idles during host-side pull/stage/collect (and the
        host no longer idles during compute). ``pipeline_depth=1``
        degenerates to the serial pull–dispatch–complete loop. In-flight
        packages retire strictly in issue order, so the scheduler's
        speed refresh, the ownership ledger and counter attribution see
        the same per-package event sequence as the serial path.

        All control-plane decisions happen inside the shared
        :class:`~repro_torch.core.exec.ExecutionLoop` under the engine lock;
        only the (expensive) data-plane phases run unlocked. The thread
        makes its unit's CUDA stream current for its whole life (the
        current stream is per thread).
        """
        self.backend.serve_on(unit_idx)
        with self.units[unit_idx].stream_context():
            self._work(unit_idx)

    def _work(self, unit_idx: int) -> None:
        """The body of :meth:`_worker`, on the unit's stream."""
        depth = self.pipeline_depth
        # this worker's in-flight packages, oldest first — only this
        # thread touches it, but the *count* it bounds (how many pulled-
        # but-incomplete packages the unit owns) is mirrored in the
        # loop's ownership ledger under _cv
        inflight: collections.deque = collections.deque()
        busy_floor = 0.0
        while True:
            with self._cv:
                work = self.loop.pull(unit_idx, force_flush=self._stop)
                while work is None:
                    if inflight:
                        # nothing new to pull: drain the pipeline instead
                        # of parking on top of unfinished packages
                        break
                    if self._stop and self.loop.drained():
                        return
                    # Park until a submit / completion / shutdown wakes
                    # us, or — when a staged fusion group is ripening —
                    # exactly until its flush deadline. Every state
                    # change notifies the condition, so an untimed wait
                    # needs no poll-interval safety net.
                    ripen = self.admission.next_ripen_in(time.perf_counter())
                    self.backend.wait_next_event(
                        timeout=None if ripen is None else max(ripen, 1e-4))
                    work = self.loop.pull(unit_idx, force_flush=self._stop)
                if work is not None:
                    work[0].on_units += 1
            if work is None:
                busy_floor = self._retire_oldest(unit_idx, inflight,
                                                 busy_floor)
                continue
            launch, pkg = work
            try:
                # the engine's data plane stages inputs per the memory
                # model (USM: in-place views, device copies of the inputs
                # and the output mapped on CUDA; BUFFERS: pooled
                # per-package copies) and issues the kernel on the unit's
                # stream; collection happens at retire time.
                out_dev = self.backend.begin(unit_idx, launch, pkg)
            except BaseException as e:
                self._complete(launch, pkg, error=e)
                continue
            inflight.append((launch, pkg, out_dev))
            while len(inflight) >= depth:
                busy_floor = self._retire_oldest(unit_idx, inflight,
                                                 busy_floor)
