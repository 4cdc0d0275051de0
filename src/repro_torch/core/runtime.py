"""Public Coexecutor Runtime API (paper §3.3, Listing 1).

Python rendering of the paper's C++ API, configured by a declarative
:class:`~repro_torch.api.spec.CoexecSpec`::

    from repro_torch.api import CoexecSpec

    spec = (CoexecSpec.builder().policy("hguided").dist(0.35)
            .memory("usm").build())
    rt = CoexecutorRuntime.from_spec(spec)
    out = rt.launch(n, kernel, inputs)           # blocking co-execution

    h1 = rt.launch_async(n, kernel_a, inputs_a)  # non-blocking: a Future
    h2 = rt.launch_async(m, kernel_b, inputs_b)  # co-executions interleave
    out_a, out_b = h1.result(), h2.result()

`kernel` is a typed :class:`~repro_torch.core.dataplane.CoexecKernel` whose
body runs one package on torch tensors — the analogue of the SYCL
command-group lambda. The runtime splits the
index space with the configured load balancer, co-executes on all units, and
the results land in the expected host container, exactly as the paper
describes ("the data resulting from the computation will be in the expected
data structures").

Execution is backed by a persistent :class:`~.engine.CoexecEngine` (started
on first launch, reused across launches): many co-executions from
independent callers interleave safely on the same units, each with its own
scheduler and :class:`~.engine.LaunchStats`. ``shutdown()`` (or use as a
context manager) drains the engine and joins its worker threads.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .dataplane import ArgRole, CoexecKernel
from .engine import CoexecEngine, LaunchHandle, LaunchStats
from .units import TorchUnit

__all__ = ["CoexecutorRuntime", "LaunchStats", "counits_from_devices",
           "measured_dist"]


def default_devices() -> list[str]:
    """The paper's CPU+GPU pair on the card's host: [``cuda:0``, ``cpu``].

    Raises:
        RuntimeError: CUDA is not available (no quiet CPU-only pool).
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "counits_from_devices() co-executes on [cuda:0, cpu] and "
            "CUDA is not available; pass devices explicitly (e.g. "
            "['cpu', 'cpu']) to run on the CPU")
    return ["cuda:0", "cpu"]


def counits_from_devices(devices: Optional[Sequence] = None,
                         *, kinds: Optional[Sequence[str]] = None,
                         speed_hints: Optional[Sequence[float]] = None,
                         ) -> list[TorchUnit]:
    """One Coexecution Unit per torch device.

    With no argument this is the paper's CPU+GPU pair on the card's host:
    [``cuda:0``, ``cpu``], of kinds ``gpu`` and ``cpu``. There is no quiet
    CPU-only fallback: without CUDA the default raises, and a caller that
    wants CPU units names them (the tests pass ``["cpu", "cpu"]``).

    Args:
        devices: torch devices or their names; the same device may back
            several units (names then get a ``#n`` suffix).
        kinds: per-unit energy-model kinds (default from the device).
        speed_hints: per-unit relative throughput hints.

    Returns:
        The units, in device order.

    Raises:
        RuntimeError: ``devices`` is omitted and CUDA is not available.
    """
    if devices is None:
        devices = default_devices()
    units = []
    seen: dict[str, int] = {}
    for i, d in enumerate(devices):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        kind = kinds[i] if kinds else ("gpu" if d.type == "cuda" else d.type)
        hint = speed_hints[i] if speed_hints else 1.0
        name = str(d)
        # the same device may back several units (the CPU test pair);
        # names must stay unique or per-unit stats merge
        n = seen.get(name, 0)
        seen[name] = n + 1
        if n:
            name = f"{name}#{n}"
        units.append(TorchUnit(name, d, kind=kind, speed_hint=hint))
    return units


def measured_dist(units, kernel, inputs, total: int, memory: str = "usm"
                  ) -> tuple[float, ...]:
    """Per-unit computing-power shares measured on the served kernel.

    Each unit runs one package of the launch alone: 1/8 of its items on
    a CUDA unit, 1/256 on a CPU unit (hundreds of times slower on the
    paper's kernels). A unit's speed is the package's items over its
    busy seconds (the kernel is loaded before the clock starts).

    Args:
        units: the units to measure.
        kernel: the served :class:`~repro_torch.core.CoexecKernel`.
        inputs: one request's inputs.
        total: the request's items.
        memory: the data plane to measure under (``usm``/``buffers``).

    Returns:
        The shares, summing to 1, in unit order.
    """
    from ..api import CoexecSpec

    spec = CoexecSpec.builder().policy("static").memory(memory).build()
    speeds = []
    for unit in units:
        rows = max(1, total // (256 if unit.device.type == "cpu" else 8))
        part = [a[(slice(None),) * arg.axis + (slice(0, rows),)]
                if arg.role is ArgRole.SPLIT else a
                for arg, a in zip(kernel.args, kernel.bind(inputs))]
        with CoexecutorRuntime.from_spec(spec, units=[unit]) as rt:
            rt.launch(rows, kernel, part)
            busy = sum(rt.last_stats.unit_busy_s.values())
        speeds.append(rows / max(busy, 1e-9))
    return tuple(v / sum(speeds) for v in speeds)


class CoexecutorRuntime:
    """The paper's `coexecutor_runtime<policy>` object, spec-configured."""

    def __init__(self, policy: str = "hguided", *, spec=None):
        """Build a runtime for one scheduling policy (or a full spec).

        Args:
            policy: intra-launch policy name (Listing 1's ``<hg>``);
                ignored when ``spec`` is given.
            spec: full :class:`~repro_torch.api.spec.CoexecSpec`; when omitted
                an all-default spec with ``policy`` is used.
        """
        from repro_torch.api.spec import CoexecSpec, SchedulerSpec

        if spec is None:
            spec = CoexecSpec(scheduler=SchedulerSpec(policy=policy))
        self._spec = spec
        self._units: Optional[list[TorchUnit]] = None
        self._engine: Optional[CoexecEngine] = None
        # two threads' first launches must not start two engines
        self._engine_lock = threading.Lock()
        self.last_stats: Optional[LaunchStats] = None

    # -- declarative configuration (the CoexecSpec surface) ----------------
    @classmethod
    def from_spec(cls, spec, *, units: Optional[Sequence[TorchUnit]] = None
                  ) -> "CoexecutorRuntime":
        """Build a runtime entirely from a :class:`CoexecSpec`.

        Args:
            spec: the declarative configuration (validated here).
            units: pre-built Coexecution Units overriding the spec's
                ``units`` section (units are runtime objects, so specs
                describe them rather than contain them).

        Returns:
            A configured runtime (engine starts on first launch).
        """
        rt = cls(spec=spec.validate())
        if units is not None:
            rt._units = list(units)
        return rt

    @property
    def spec(self):
        """The :class:`CoexecSpec` in force (frozen; replace to change)."""
        return self._spec

    @property
    def policy(self) -> str:
        """The configured intra-launch scheduling policy name."""
        return self._spec.scheduler.policy

    def configure(self, spec, *, units: Optional[Sequence[TorchUnit]] = None
                  ) -> "CoexecutorRuntime":
        """Swap in a new spec (the non-deprecated ``config`` successor).

        Args:
            spec: the new declarative configuration (validated here).
            units: pre-built units overriding the spec's ``units``
                section; ``None`` keeps previously supplied units.

        Returns:
            The runtime itself, for chaining. Reconfiguring shuts down
            any running engine (units/memory/admission may have changed).
        """
        self._spec = spec.validate()
        if units is not None:
            self._units = list(units)
        self.shutdown()
        return self

    # -- engine lifecycle ---------------------------------------------------
    @property
    def engine(self) -> Optional[CoexecEngine]:
        """The persistent engine, if one has been started."""
        return self._engine

    def _get_engine(self) -> CoexecEngine:
        with self._engine_lock:
            if self._engine is None or not self._engine.running:
                if self._units is None:
                    self._units = self._spec.build_units()
                if any(u.device.type == "cuda" for u in self._units):
                    # the CPU unit's plain kernels use torch's intra-op
                    # threads; leave one core to drive the CUDA unit
                    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 1))
                self._engine = CoexecEngine.from_spec(
                    self._spec, units=self._units).start()
            return self._engine

    def shutdown(self) -> None:
        """Drain in-flight launches and join the engine's workers."""
        with self._engine_lock:
            engine, self._engine = self._engine, None
        if engine is not None:
            engine.shutdown()

    def __enter__(self) -> "CoexecutorRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- launch (paper: runtime.launch(size, lambda)) -----------------------
    def launch_async(self, total: int, kernel: Callable,
                     inputs: Sequence[np.ndarray],
                     out: Optional[np.ndarray] = None,
                     *, out_dtype=np.float32,
                     out_trailing_shape: tuple = (),
                     granularity: int = 1,
                     tenant: Optional[str] = None,
                     weight: float = 1.0,
                     block: bool = True) -> LaunchHandle:
        """Non-blocking co-execution: returns a :class:`LaunchHandle`.

        Any number of launches may be in flight at once; their packages
        interleave on the engine's units under the configured admission
        policy, and each handle carries its own isolated stats.
        ``handle.result()`` blocks until this launch's whole index space
        is computed and collected.

        Args:
            total: size of the 1-D index space to co-execute.
            kernel: a registered/typed
                :class:`~repro_torch.core.dataplane.CoexecKernel`, or a legacy
                package closure ``fn(offset, *chunks) -> chunk_out``.
            inputs: full host input arrays (moved per the kernel's
                declared per-argument semantics).
            out: output container; allocated when ``None`` (a typed
                kernel's declared output slot wins over ``out_dtype`` /
                ``out_trailing_shape``).
            out_dtype: dtype of the allocated output.
            out_trailing_shape: trailing dims of the allocated output.
            granularity: package alignment; overrides the spec's
                ``scheduler.granularity`` when not 1.
            tenant: fairness flow for WFQ admission (defaults to a
                per-launch tenant).
            weight: relative WFQ share of the tenant.
            block: wait for an admission slot when the engine is at
                ``max_inflight`` capacity, instead of raising.

        Returns:
            The launch's :class:`LaunchHandle` future.

        Raises:
            AdmissionFull: engine at capacity and ``block=False``.
            ValueError: invalid scheduler parameters for this policy.
        """
        t_plan = time.perf_counter()      # the launch's plan span starts
        engine = self._get_engine()
        n = len(engine.units)
        sched_spec = self._spec.scheduler
        if granularity != 1:
            sched_spec = sched_spec.replace(granularity=granularity)
        sched = sched_spec.build(total, n, speeds=self._spec.speeds_for(n))
        if out is None:
            if isinstance(kernel, CoexecKernel):
                out = kernel.alloc_out(total, inputs)
            else:
                out = np.zeros((total, *out_trailing_shape), dtype=out_dtype)
        return engine.submit(sched, kernel, inputs, out,
                             tenant=tenant, weight=weight, block=block,
                             t_plan=t_plan)

    def launch(self, total: int, kernel: Callable,
               inputs: Sequence[np.ndarray],
               out: Optional[np.ndarray] = None,
               *, out_dtype=np.float32,
               out_trailing_shape: tuple = (),
               granularity: int = 1) -> np.ndarray:
        """Blocking co-execution — a thin wrapper over :meth:`launch_async`."""
        handle = self.launch_async(total, kernel, inputs, out,
                                   out_dtype=out_dtype,
                                   out_trailing_shape=out_trailing_shape,
                                   granularity=granularity)
        result = handle.result()
        self.last_stats = handle.stats
        return result
