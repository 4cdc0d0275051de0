"""Declarative, typed configuration for a co-execution: ``CoexecSpec``.

The paper's runtime is configured through a tiny imperative surface
(``rt.config(policy, units, dist, memory)`` — §3.3, Listing 1).
``CoexecSpec`` is its declarative form, ported from the reference field
for field: a frozen dataclass tree that

* is the one source of truth — the real engine, the discrete-event
  simulator and the serve CLI all construct from the same object;
* round-trips losslessly: ``CoexecSpec.from_dict(spec.to_dict()) == spec``
  and likewise through JSON, so experiment configs are artifacts;
* validates against the plugin registry
  (:mod:`repro_torch.api.registry`) — unknown policies raise ``KeyError``,
  unknown/misspelled policy options raise ``ValueError`` naming the key
  and the accepted fields;
* builds fluently::

      spec = (CoexecSpec.builder()
              .policy("hguided")
              .admission(wfq=True, max_inflight=64)
              .memory("usm")
              .build())

Sub-spec field metadata carries the CLI derivation (flag name, help,
choices) consumed by :mod:`repro_torch.api.cli`, which is how the serve
CLI grows one flag per field. A JSON written by the reference's
``CoexecSpec.to_json`` reads back here with an equal ``to_dict()``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Sequence

from ..core.admission import ADMISSION_POLICIES, AdmissionConfig
from ..core.memory import MemoryModel
from . import registry

__all__ = [
    "UnitsSpec", "SchedulerSpec", "AdmissionSpec", "MemorySpec",
    "WorkloadSpec", "TrafficSpec", "ClusterSpec", "CoexecSpec",
    "CoexecSpecBuilder", "SPEC_VERSION",
]

SPEC_VERSION = 1

#: The kernel implementation axis, the reference's four choices:
#: ``pallas`` runs the hand CUDA kernel on CUDA tensors (the plain
#: PyTorch version on CPU tensors), ``xla`` and ``ref`` the plain
#: version (one body under two registry objects), and ``auto`` resolves
#: to ``pallas`` where a CUDA card is, ``xla`` elsewhere
#: (:func:`repro_torch.kernels.default_impl`).
KERNEL_IMPL_CHOICES = ("auto", "pallas", "xla", "ref")


def _freeze(value: Any) -> Any:
    """Recursively turn lists into tuples (hashable, frozen-friendly)."""
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    return value


def _thaw(value: Any) -> Any:
    """Recursively turn tuples into lists (JSON-friendly)."""
    if isinstance(value, tuple):
        return [_thaw(v) for v in value]
    return value


def _cli(flag: str, help_: str, **extra) -> dict:
    """Dataclass field metadata block (CLI flag name, help, choices)."""
    return {"cli": flag, "help": help_, **extra}


def _sub_from_dict(cls, data: dict):
    """Build one sub-spec from a plain dict, freezing list values."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - names)
    if unknown:
        raise ValueError(f"unknown {cls.__name__} field(s) {unknown!r}; "
                         f"accepted: {sorted(names)}")
    return cls(**{k: _freeze(v) for k, v in data.items()})


class _SubSpec:
    """Shared dict/round-trip plumbing for the frozen sub-specs."""

    def to_dict(self) -> dict:
        """Plain-dict form (JSON-safe: tuples become lists)."""
        return {f.name: _thaw(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, data: dict):
        """Inverse of :meth:`to_dict` (lists re-frozen to tuples).

        Args:
            data: mapping of field names to values.

        Returns:
            A new instance equal to the one ``to_dict`` was called on.

        Raises:
            ValueError: unknown field names.
        """
        return _sub_from_dict(cls, data)

    def replace(self, **changes):
        """A copy with the given fields replaced (frozen-safe)."""
        return dataclasses.replace(self, **{k: _freeze(v)
                                            for k, v in changes.items()})


@dataclasses.dataclass(frozen=True)
class UnitsSpec(_SubSpec):
    """Which Coexecution Units to build, and their computing-power hint.

    ``count=None`` means the paper's CPU+GPU pair, [``cuda:0``, ``cpu``]
    on the card's host; a ``count`` larger than that pool replicates its
    first device. Building needs CUDA: a CPU-only caller passes its units
    (``counits_from_devices(["cpu", "cpu"])``) instead. ``dist`` is the
    paper's ``dist(0.35)``: a single value is the
    first unit's share (remainder spread evenly), a full tuple is
    per-unit shares.
    """

    count: Optional[int] = dataclasses.field(
        default=None, metadata=_cli(
            "units", "number of Coexecution Units (default: one per "
                     "local device)"))
    kinds: tuple[str, ...] = dataclasses.field(
        default=(), metadata=_cli(
            "unit-kinds", "per-unit energy-model kind (comma list, e.g. "
                          "cpu,gpu)"))
    speed_hints: tuple[float, ...] = dataclasses.field(
        default=(), metadata=_cli(
            "speed-hints", "per-unit relative speed hints (comma list)"))
    dist: tuple[float, ...] = dataclasses.field(
        default=(), metadata=_cli(
            "dist", "computing-power shares: one value = first unit's "
                    "share (paper's dist(0.35)), or per-unit comma list"))
    pipeline_depth: int = dataclasses.field(
        default=1, metadata=_cli(
            "pipeline-depth", "packages a unit may have in flight at "
                              "once (1 = serial stage/compute/collect)"))

    def resolve_dist(self, num_units: int) -> Optional[list[float]]:
        """Expand ``dist`` into per-unit shares for ``num_units`` units.

        Args:
            num_units: unit count the shares must cover.

        Returns:
            Per-unit shares, or ``None`` when no hint was given.

        Raises:
            ValueError: a multi-value ``dist`` whose length mismatches
                ``num_units``, or non-positive shares.
        """
        if not self.dist:
            return None
        if any(not float(d) > 0 for d in self.dist):
            raise ValueError(f"dist shares must be positive, "
                             f"got {self.dist!r}")
        if len(self.dist) == 1:
            first = float(self.dist[0])
            rest = (1.0 - first) / max(num_units - 1, 1)
            return [first] + [rest] * (num_units - 1)
        if len(self.dist) != num_units:
            raise ValueError(f"dist has {len(self.dist)} shares for "
                             f"{num_units} units")
        return [float(d) for d in self.dist]

    def build(self) -> list:
        """Materialize the described :class:`~repro_torch.core.units.TorchUnit`\\ s.

        Returns:
            One unit per requested slot over [``cuda:0``, ``cpu``]; a
            count beyond that pool replicates the first device.

        Raises:
            RuntimeError: CUDA is not available (no quiet CPU-only pool).
        """
        from ..core.runtime import counits_from_devices, default_devices

        devices = default_devices()
        if self.count is not None:
            if self.count <= len(devices):
                devices = devices[:self.count]
            else:
                devices = devices[:1] * self.count
        kinds = list(self.kinds) if self.kinds else None
        hints = [float(h) for h in self.speed_hints] \
            if self.speed_hints else None
        return counits_from_devices(devices, kinds=kinds, speed_hints=hints)


@dataclasses.dataclass(frozen=True)
class SchedulerSpec(_SubSpec):
    """Intra-launch load-balancing policy and its options.

    ``options`` holds policy-specific knobs (``num_packages``,
    ``chunks_per_unit``, ``divisor``, ...) as a sorted tuple of pairs so
    the spec stays frozen and order-insensitively equal; use
    :meth:`options_dict` / :meth:`with_options` to work with them.
    """

    policy: str = dataclasses.field(
        default="hguided", metadata=_cli(
            "policy", "intra-launch scheduling policy (or 'all' to sweep "
                      "every registered policy)"))
    granularity: int = dataclasses.field(
        default=1, metadata=_cli(
            "granularity", "package alignment in work-items (local work "
                           "size)"))
    options: tuple[tuple[str, Any], ...] = dataclasses.field(
        default=(), metadata=_cli(
            "scheduler-opt", "policy-specific option as key=value "
                             "(repeatable)", kv=True))

    def __post_init__(self) -> None:
        normalized = tuple(sorted((str(k), _freeze(v))
                                  for k, v in self.options))
        object.__setattr__(self, "options", normalized)

    def options_dict(self) -> dict:
        """The policy options as a plain dict."""
        return {k: v for k, v in self.options}

    def with_options(self, **options) -> "SchedulerSpec":
        """A copy with the given options merged in (None removes a key)."""
        merged = self.options_dict()
        for k, v in options.items():
            if v is None:
                merged.pop(k, None)
            else:
                merged[k] = v
        return self.replace(options=tuple(merged.items()))

    def to_dict(self) -> dict:
        """Plain-dict form; ``options`` becomes a mapping."""
        d = super().to_dict()
        d["options"] = {k: _thaw(v) for k, v in self.options}
        return d

    @classmethod
    def from_dict(cls, data: dict) -> "SchedulerSpec":
        """Inverse of :meth:`to_dict` (mapping options re-frozen).

        Args:
            data: mapping of field names to values; ``options`` may be a
                mapping or a pair sequence.

        Returns:
            The reconstructed spec.
        """
        data = dict(data)
        opts = data.get("options", {})
        if isinstance(opts, dict):
            data["options"] = tuple(opts.items())
        return _sub_from_dict(cls, data)

    def validate(self) -> None:
        """Check the policy exists and every option is accepted.

        Raises:
            KeyError: unknown policy.
            ValueError: unknown option key (named, with accepted fields)
                or non-positive granularity.
        """
        if self.granularity <= 0:
            raise ValueError("granularity must be positive")
        if self.policy != "all":
            registry.validate_scheduler_options(self.policy,
                                                self.options_dict())

    def build(self, total: int, num_units: int, *,
              speeds: Optional[Sequence[float]] = None):
        """Build a fresh one-shot scheduler from this spec.

        Args:
            total: size of the 1-D index space.
            num_units: Coexecution Unit count.
            speeds: computing-power hint, applied only when the policy's
                plugin declares it takes one and the spec's options do
                not already pin ``speeds``.

        Returns:
            The constructed scheduler.
        """
        plugin, _ = registry.resolve_scheduler(self.policy)
        kw = self.options_dict()
        kw.setdefault("granularity", self.granularity)
        if speeds is not None and plugin.speed_hint:
            kw.setdefault("speeds", list(speeds))
        return registry.build_scheduler(self.policy, total, num_units, **kw)


@dataclasses.dataclass(frozen=True)
class AdmissionSpec(_SubSpec):
    """Cross-launch queueing discipline (mirrors ``AdmissionConfig``)."""

    policy: str = dataclasses.field(
        default="fifo", metadata=_cli(
            "admission", "cross-launch queueing: FIFO drain or "
                         "weighted-fair deficit round robin",
            choices=ADMISSION_POLICIES))
    fuse: bool = dataclasses.field(
        default=False, metadata=_cli(
            "fuse", "coalesce small same-shaped concurrent launches into "
                    "shared dispatches"))
    fuse_threshold: int = dataclasses.field(
        default=1 << 12, metadata=_cli(
            "fuse-threshold", "largest launch (work-items) eligible for "
                              "fusion"))
    fuse_limit: int = dataclasses.field(
        default=64, metadata=_cli(
            "fuse-limit", "maximum members per fused batch"))
    fuse_wait_s: float = dataclasses.field(
        default=0.002, metadata=_cli(
            "fuse-wait-s", "fusion batching window in seconds"))
    max_inflight: Optional[int] = dataclasses.field(
        default=None, metadata=_cli(
            "max-inflight", "backpressure cap on admitted launches"))
    quantum: Optional[int] = dataclasses.field(
        default=None, metadata=_cli(
            "quantum", "WFQ deficit-round-robin credit per round "
                       "(work-items; default derives from package hints)"))
    preempt: bool = dataclasses.field(
        default=False, metadata=_cli(
            "preempt", "WFQ reclaims credit mid-launch by capping "
                       "per-pull package sizes of over-served tenants"))
    fuse_buckets: bool = dataclasses.field(
        default=False, metadata=_cli(
            "fuse-buckets", "pad near-identical launch shapes up to "
                            "power-of-2 buckets so mixed traffic still "
                            "fuses"))
    slo_ms: Optional[float] = dataclasses.field(
        default=None, metadata=_cli(
            "slo-ms", "default per-launch deadline in milliseconds "
                      "(EDF urgency + shedding reference)"))
    shed: bool = dataclasses.field(
        default=False, metadata=_cli(
            "shed", "reject launches whose estimated finish misses the "
                    "deadline (bounded by --shed-budget)"))
    shed_budget: float = dataclasses.field(
        default=0.25, metadata=_cli(
            "shed-budget", "maximum fraction of offered launches the "
                           "shedder may reject"))
    shed_rate: Optional[float] = dataclasses.field(
        default=None, metadata=_cli(
            "shed-rate", "service-rate estimate in items/s for the shed "
                         "finish predictor (default: derived capacity)"))
    edf_boost: float = dataclasses.field(
        default=1.0, metadata=_cli(
            "edf-boost", "EDF credit boost factor for deadline-ranked "
                         "refills (0 disables the boost)"))

    def to_config(self) -> AdmissionConfig:
        """The equivalent :class:`~repro_torch.core.admission.AdmissionConfig`.

        Returns:
            A validated config (construction runs its checks).

        Raises:
            ValueError: invalid policy or limits.
        """
        return AdmissionConfig(
            policy=self.policy, fuse=self.fuse,
            fuse_threshold=self.fuse_threshold, fuse_limit=self.fuse_limit,
            fuse_wait_s=self.fuse_wait_s, max_inflight=self.max_inflight,
            quantum=self.quantum, preempt=self.preempt,
            fuse_buckets=self.fuse_buckets, slo_ms=self.slo_ms,
            shed=self.shed, shed_budget=self.shed_budget,
            shed_rate=self.shed_rate, edf_boost=self.edf_boost)

    @classmethod
    def from_config(cls, config: AdmissionConfig) -> "AdmissionSpec":
        """Lift an imperative config into the declarative spec.

        Args:
            config: an existing admission configuration.

        Returns:
            The equivalent spec (``to_config`` inverts it).
        """
        return cls(policy=config.policy, fuse=config.fuse,
                   fuse_threshold=config.fuse_threshold,
                   fuse_limit=config.fuse_limit,
                   fuse_wait_s=config.fuse_wait_s,
                   max_inflight=config.max_inflight,
                   quantum=config.quantum, preempt=config.preempt,
                   fuse_buckets=config.fuse_buckets, slo_ms=config.slo_ms,
                   shed=config.shed, shed_budget=config.shed_budget,
                   shed_rate=config.shed_rate, edf_boost=config.edf_boost)

    def validate(self) -> None:
        """Check policy/limits by constructing the config once.

        Raises:
            ValueError: invalid policy or limits.
        """
        self.to_config()


@dataclasses.dataclass(frozen=True)
class MemorySpec(_SubSpec):
    """Memory model governing package data movement (paper §3.1)."""

    model: str = dataclasses.field(
        default="usm", metadata=_cli(
            "memory", "collection semantics: unified shared memory or "
                      "per-package buffers",
            choices=tuple(m.value for m in MemoryModel)))

    def to_model(self) -> MemoryModel:
        """The equivalent :class:`~repro_torch.core.memory.MemoryModel`.

        Returns:
            The enum member for :attr:`model`.

        Raises:
            ValueError: unknown model name.
        """
        return MemoryModel(str(self.model).lower())

    def validate(self) -> None:
        """Check the model name maps to a known memory model.

        Raises:
            ValueError: unknown model name.
        """
        self.to_model()


@dataclasses.dataclass(frozen=True)
class WorkloadSpec(_SubSpec):
    """What to run: profile, kernel, per-launch size, and serving shape."""

    name: str = dataclasses.field(
        default="taylor", metadata=_cli(
            "workload", "registered workload profile (paper Table 1 "
                        "benchmarks, or a plugin)"))
    kernel: str = dataclasses.field(
        default="", metadata=_cli(
            "kernel", "registered package kernel for the real engine "
                      "(default: the workload's same-named kernel, "
                      "falling back to taylor)"))
    kernel_impl: str = dataclasses.field(
        default="auto", metadata=_cli(
            "kernel-impl", "kernel implementation variant to serve "
                           "(pallas = the hand CUDA kernel on CUDA "
                           "tensors, the plain version on CPU tensors; "
                           "xla and ref = the plain PyTorch version, "
                           "as two registry objects; auto = pallas "
                           "where a CUDA card is, xla elsewhere)",
            choices=KERNEL_IMPL_CHOICES))
    size_scale: float = dataclasses.field(
        default=1.0, metadata=_cli(
            "size-scale", "problem-size multiplier for the profile "
                          "(Fig. 8 sweeps)"))
    items: int = dataclasses.field(
        default=1 << 16, metadata=_cli(
            "n", "work-items per real co-execution request"))
    requests: int = dataclasses.field(
        default=16, metadata=_cli(
            "requests", "number of requests to serve per policy"))
    concurrent: int = dataclasses.field(
        default=8, metadata=_cli(
            "concurrent", "max in-flight launch_async requests"))
    tenants: Optional[int] = dataclasses.field(
        default=None, metadata=_cli(
            "tenants", "concurrent tenants for the multi-tenant DES sweep"))

    def validate(self) -> None:
        """Check the profile/kernel exist and the serving shape is sane.

        Raises:
            KeyError: unknown workload profile, or an explicitly named
                kernel that is not registered.
            ValueError: non-positive sizes/counts.
        """
        if self.name not in registry.workload_names():
            raise KeyError(f"unknown workload {self.name!r}; choose from "
                           f"{list(registry.workload_names())}")
        if self.kernel and self.kernel not in registry.kernel_names():
            raise KeyError(f"unknown kernel {self.kernel!r}; choose from "
                           f"{list(registry.kernel_names())}")
        if self.kernel_impl not in KERNEL_IMPL_CHOICES:
            raise ValueError(
                f"unknown kernel_impl {self.kernel_impl!r}; choose from "
                f"{list(KERNEL_IMPL_CHOICES)}")
        if self.items <= 0 or self.requests <= 0 or self.concurrent <= 0:
            raise ValueError("items/requests/concurrent must be positive")
        if self.size_scale <= 0:
            raise ValueError("size_scale must be positive")
        if self.tenants is not None and self.tenants < 1:
            raise ValueError("tenants must be a positive integer (or None)")

    def build(self):
        """Materialize the profile via the workload registry.

        Returns:
            ``(Workload, cpu_unit, gpu_unit)`` for the built-ins.
        """
        return registry.build_workload(self.name,
                                       size_scale=self.size_scale)

    def resolve_kernel(self) -> str:
        """The kernel name real co-execution paths should serve.

        Returns:
            The explicit :attr:`kernel` when set; otherwise the
            workload's same-named registered kernel, falling back to
            ``"taylor"`` for profiles with no kernel twin.
        """
        if self.kernel:
            return self.kernel
        if self.name in registry.kernel_names():
            return self.name
        return "taylor"

    def build_kernel(self):
        """Resolve the served kernel through the kernel registry.

        The :attr:`kernel_impl` axis is passed through, so ``--kernel-impl
        pallas`` serves the hand-kernel body of the selected kernel on
        every unit (``auto`` defers to the kernel's backend-aware default).

        Returns:
            The registered :class:`~repro_torch.core.dataplane.CoexecKernel`.
        """
        return registry.build_kernel(self.resolve_kernel(),
                                     impl=self.kernel_impl)


@dataclasses.dataclass(frozen=True)
class TrafficSpec(_SubSpec):
    """Open-loop arrival process feeding the serving loop.

    ``arrival="closed"`` keeps today's closed-loop sweeps (submit a
    fixed batch, drain). ``"poisson"`` and ``"burst"`` synthesize a
    seeded open-loop trace via :func:`repro_torch.core.traffic.synthesize_trace`
    (``launch/serve.py`` ``trace_from_spec``) — the same trace replays
    identically on the real engine and the DES, which is what the parity
    harness pins.
    """

    arrival: str = dataclasses.field(
        default="closed", metadata=_cli(
            "arrival", "arrival process: closed-loop batch, Poisson, or "
                       "bursty on/off Poisson",
            choices=("closed", "poisson", "burst")))
    rate: float = dataclasses.field(
        default=0.0, metadata=_cli(
            "rate", "mean offered arrival rate in launches/s (0 derives "
                    "from --load and measured capacity)"))
    load: float = dataclasses.field(
        default=1.2, metadata=_cli(
            "load", "offered load as a multiple of serving capacity, "
                    "used when --rate is 0"))
    arrivals: int = dataclasses.field(
        default=2048, metadata=_cli(
            "arrivals", "number of arrivals to synthesize per replay"))
    burst: float = dataclasses.field(
        default=4.0, metadata=_cli(
            "burst", "on-phase rate multiplier for --arrival burst"))
    burst_duty: float = dataclasses.field(
        default=0.2, metadata=_cli(
            "burst-duty", "fraction of each burst cycle spent in the "
                          "on phase (burst*duty must stay below 1)"))
    item_jitter: float = dataclasses.field(
        default=0.0, metadata=_cli(
            "item-jitter", "log-uniform spread of per-arrival item "
                           "counts (0 = uniform size)"))
    seed: int = dataclasses.field(
        default=0, metadata=_cli(
            "traffic-seed", "PRNG seed for trace synthesis"))
    trace: str = dataclasses.field(
        default="", metadata=_cli(
            "trace", "replay a saved JSON trace instead of synthesizing "
                     "one (overrides the arrival/rate knobs)"))

    def validate(self) -> None:
        """Check the arrival process and its knobs.

        Raises:
            ValueError: unknown arrival name, non-positive counts, or a
                burst shape whose off-phase rate would go negative.
        """
        if self.arrival not in ("closed", "poisson", "burst"):
            raise ValueError(
                f"unknown arrival {self.arrival!r}; choose from "
                f"['closed', 'poisson', 'burst']")
        if self.rate < 0:
            raise ValueError("rate must be >= 0")
        if self.load <= 0:
            raise ValueError("load must be positive")
        if self.arrivals < 1:
            raise ValueError("arrivals must be a positive integer")
        if self.burst < 1:
            raise ValueError("burst must be >= 1")
        if not 0 < self.burst_duty < 1:
            raise ValueError("burst_duty must be in (0, 1)")
        if self.burst * self.burst_duty >= 1:
            raise ValueError("burst * burst_duty must be < 1 so the "
                             "off-phase rate stays positive")
        if self.item_jitter < 0:
            raise ValueError("item_jitter must be >= 0")


@dataclasses.dataclass(frozen=True)
class ClusterSpec(_SubSpec):
    """Elastic cluster tier: pool sizing, failure detection, autoscaling.

    Configures :mod:`repro_torch.core.cluster`: the provisioned pool ceiling
    and active floor, the supervisor's heartbeat/grace/straggler knobs,
    an optional committed :class:`~repro_torch.core.cluster.FailurePlan` to
    inject, and the admission-depth autoscaler's hysteresis band.
    Disabled by default — the static unit set of the paper's runtime.
    """

    enabled: bool = dataclasses.field(
        default=False, metadata=_cli(
            "cluster", "serve through the elastic cluster tier "
                       "(resizable pool + failure recovery)"))
    min_units: int = dataclasses.field(
        default=1, metadata=_cli(
            "cluster-min-units", "active units at start and the "
                                 "scale-in floor"))
    max_units: Optional[int] = dataclasses.field(
        default=None, metadata=_cli(
            "cluster-max-units", "provisioned pool ceiling (default: "
                                 "the built unit count)"))
    heartbeat_s: float = dataclasses.field(
        default=0.05, metadata=_cli(
            "cluster-heartbeat-s", "expected liveness beat interval in "
                                   "seconds"))
    grace_s: float = dataclasses.field(
        default=0.2, metadata=_cli(
            "cluster-grace-s", "silence beyond this declares a unit "
                               "dead"))
    straggler_factor: float = dataclasses.field(
        default=4.0, metadata=_cli(
            "cluster-straggler-factor", "outstanding-age multiple of the "
                                        "EWMA package service time that "
                                        "flags a straggler"))
    failure_plan: str = dataclasses.field(
        default="", metadata=_cli(
            "cluster-failure-plan", "JSON FailurePlan to inject "
                                    "(scripted kill/join timeline)"))
    autoscale: bool = dataclasses.field(
        default=False, metadata=_cli(
            "cluster-autoscale", "resize the pool from admission queue "
                                 "depth between min and max units"))
    scale_up_depth: int = dataclasses.field(
        default=8, metadata=_cli(
            "cluster-scale-up-depth", "queue depth that (sustained) "
                                      "triggers scale-out"))
    scale_down_depth: int = dataclasses.field(
        default=1, metadata=_cli(
            "cluster-scale-down-depth", "queue depth at or below which "
                                        "(sustained) the pool scales in"))
    sustain_s: float = dataclasses.field(
        default=0.1, metadata=_cli(
            "cluster-sustain-s", "seconds the backlog must persist "
                                 "before scale-out"))
    idle_s: float = dataclasses.field(
        default=0.5, metadata=_cli(
            "cluster-idle-s", "seconds of idleness before scale-in"))
    cooldown_s: float = dataclasses.field(
        default=0.25, metadata=_cli(
            "cluster-cooldown-s", "minimum seconds between consecutive "
                                  "resizes"))

    def validate(self) -> None:
        """Check pool bounds, detector intervals and the hysteresis band.

        Raises:
            ValueError: inverted pool bounds, non-positive intervals, or
                a hysteresis band with scale_down >= scale_up.
        """
        if self.min_units < 1:
            raise ValueError("min_units must be >= 1")
        if self.max_units is not None and self.max_units < self.min_units:
            raise ValueError(f"max_units ({self.max_units}) must be >= "
                             f"min_units ({self.min_units})")
        if self.heartbeat_s <= 0 or self.grace_s <= 0:
            raise ValueError("heartbeat_s and grace_s must be positive")
        if self.straggler_factor <= 0:
            raise ValueError("straggler_factor must be positive")
        if self.scale_down_depth >= self.scale_up_depth:
            raise ValueError("hysteresis needs scale_down_depth < "
                             "scale_up_depth")
        if self.sustain_s < 0 or self.idle_s < 0 or self.cooldown_s < 0:
            raise ValueError("sustain_s/idle_s/cooldown_s must be >= 0")

    def load_plan(self):
        """The configured failure plan, loaded (``None`` when unset).

        Returns:
            A :class:`~repro_torch.core.cluster.FailurePlan`, or ``None``.
        """
        if not self.failure_plan:
            return None
        from ..core.cluster import FailurePlan

        return FailurePlan.load(self.failure_plan)

    def autoscaler_opts(self) -> dict:
        """Keyword arguments for :class:`~repro_torch.core.cluster.Autoscaler`."""
        return dict(scale_up_depth=self.scale_up_depth,
                    scale_down_depth=self.scale_down_depth,
                    sustain_s=self.sustain_s, idle_s=self.idle_s,
                    cooldown_s=self.cooldown_s)


@dataclasses.dataclass(frozen=True)
class CoexecSpec(_SubSpec):
    """The single declarative description of one co-execution setup.

    One object configures everything the runtime stack needs: the real
    :class:`~repro_torch.core.engine.CoexecEngine` (via
    :meth:`~repro_torch.core.engine.CoexecEngine.from_spec`), the
    paper-facing :class:`~repro_torch.core.runtime.CoexecutorRuntime` (via
    ``configure``), the simulators (``simulate(..., spec=...)`` /
    ``simulate_multi(..., spec=...)``) and the serve CLI (which derives
    its flags from these fields). Frozen; use :meth:`replace`, the builder,
    or the sub-spec ``replace`` methods to derive variants.
    """

    units: UnitsSpec = dataclasses.field(default_factory=UnitsSpec)
    scheduler: SchedulerSpec = dataclasses.field(
        default_factory=SchedulerSpec)
    admission: AdmissionSpec = dataclasses.field(
        default_factory=AdmissionSpec)
    memory: MemorySpec = dataclasses.field(default_factory=MemorySpec)
    workload: WorkloadSpec = dataclasses.field(default_factory=WorkloadSpec)
    traffic: TrafficSpec = dataclasses.field(default_factory=TrafficSpec)
    cluster: ClusterSpec = dataclasses.field(default_factory=ClusterSpec)

    # -- round-trip serialization ------------------------------------------
    def to_dict(self) -> dict:
        """Nested plain-dict form, tagged with a schema version."""
        return {
            "version": SPEC_VERSION,
            "units": self.units.to_dict(),
            "scheduler": self.scheduler.to_dict(),
            "admission": self.admission.to_dict(),
            "memory": self.memory.to_dict(),
            "workload": self.workload.to_dict(),
            "traffic": self.traffic.to_dict(),
            "cluster": self.cluster.to_dict(),
        }

    @classmethod
    def from_dict(cls, data: dict) -> "CoexecSpec":
        """Lossless inverse of :meth:`to_dict`.

        Args:
            data: a :meth:`to_dict` result (missing sections default).

        Returns:
            A spec equal to the serialized one.

        Raises:
            ValueError: unsupported schema version or unknown fields.
        """
        version = data.get("version", SPEC_VERSION)
        if version != SPEC_VERSION:
            raise ValueError(f"unsupported CoexecSpec version {version!r} "
                             f"(this build reads version {SPEC_VERSION})")
        return cls(
            units=UnitsSpec.from_dict(data.get("units", {})),
            scheduler=SchedulerSpec.from_dict(data.get("scheduler", {})),
            admission=AdmissionSpec.from_dict(data.get("admission", {})),
            memory=MemorySpec.from_dict(data.get("memory", {})),
            workload=WorkloadSpec.from_dict(data.get("workload", {})),
            traffic=TrafficSpec.from_dict(data.get("traffic", {})),
            cluster=ClusterSpec.from_dict(data.get("cluster", {})),
        )

    def to_json(self, **dumps_kw) -> str:
        """JSON form of :meth:`to_dict` (sorted keys by default)."""
        dumps_kw.setdefault("sort_keys", True)
        return json.dumps(self.to_dict(), **dumps_kw)

    @classmethod
    def from_json(cls, text: str) -> "CoexecSpec":
        """Inverse of :meth:`to_json`.

        Args:
            text: a JSON document produced by :meth:`to_json`.

        Returns:
            A spec equal to the serialized one.
        """
        return cls.from_dict(json.loads(text))

    # -- validation ---------------------------------------------------------
    def validate(self) -> "CoexecSpec":
        """Validate every section against the registry and core checks.

        Returns:
            The spec itself, for chaining.

        Raises:
            KeyError: unknown policy or workload profile.
            ValueError: unknown policy option (named, with accepted
                fields) or invalid values anywhere in the tree.
        """
        self.scheduler.validate()
        self.admission.validate()
        self.memory.validate()
        self.workload.validate()
        self.traffic.validate()
        self.cluster.validate()
        if self.units.dist:
            n = self.units.count if self.units.count is not None \
                else max(len(self.units.dist), 1)
            self.units.resolve_dist(n)
        if int(self.units.pipeline_depth) < 1:
            raise ValueError(f"pipeline_depth must be >= 1, "
                             f"got {self.units.pipeline_depth!r}")
        return self

    # -- builders -----------------------------------------------------------
    @classmethod
    def builder(cls, base: Optional["CoexecSpec"] = None
                ) -> "CoexecSpecBuilder":
        """A fluent builder, optionally seeded from an existing spec.

        Args:
            base: spec to start from (default: all defaults).

        Returns:
            A :class:`CoexecSpecBuilder`.
        """
        return CoexecSpecBuilder(base if base is not None else cls())

    # -- materialization ----------------------------------------------------
    def speeds_for(self, num_units: int) -> Optional[list[float]]:
        """Per-unit computing-power shares for ``num_units`` units."""
        return self.units.resolve_dist(num_units)

    def build_scheduler(self, total: int, num_units: int):
        """Scheduler for one launch, with the spec's ``dist`` hint wired.

        Args:
            total: launch index-space size.
            num_units: Coexecution Unit count.

        Returns:
            A fresh one-shot scheduler.
        """
        return self.scheduler.build(total, num_units,
                                    speeds=self.speeds_for(num_units))

    def build_units(self) -> list:
        """The described real Coexecution Units (see ``UnitsSpec.build``)."""
        return self.units.build()

    def build_workload(self):
        """The described workload profile (see ``WorkloadSpec.build``)."""
        return self.workload.build()

    def build_kernel(self):
        """The served kernel (see ``WorkloadSpec.build_kernel``)."""
        return self.workload.build_kernel()

    def admission_config(self) -> AdmissionConfig:
        """The admission section as a core ``AdmissionConfig``."""
        return self.admission.to_config()

    def memory_model(self) -> MemoryModel:
        """The memory section as a core ``MemoryModel``."""
        return self.memory.to_model()

    def runtime(self, units: Optional[Sequence] = None):
        """A :class:`~repro_torch.core.runtime.CoexecutorRuntime` on this spec.

        Args:
            units: pre-built units overriding the ``units`` section.

        Returns:
            A configured (not yet started) runtime.
        """
        from ..core.runtime import CoexecutorRuntime

        return CoexecutorRuntime.from_spec(self, units=units)

    def engine(self, units: Optional[Sequence] = None):
        """A :class:`~repro_torch.core.engine.CoexecEngine` on this spec.

        Args:
            units: pre-built units overriding the ``units`` section.

        Returns:
            A constructed (not yet started) engine.
        """
        from ..core.engine import CoexecEngine

        return CoexecEngine.from_spec(self, units=units)


class CoexecSpecBuilder:
    """Fluent construction of a :class:`CoexecSpec`.

    Every method returns the builder; :meth:`build` freezes and validates.
    Example::

        spec = (CoexecSpec.builder()
                .policy("work_stealing", chunks_per_unit=4)
                .units(count=2, speed_hints=(0.4, 0.6))
                .dist(0.4)
                .admission(wfq=True, max_inflight=64)
                .fuse(True)
                .build())
    """

    def __init__(self, base: CoexecSpec):
        self._spec = base

    def _update(self, **changes) -> "CoexecSpecBuilder":
        self._spec = self._spec.replace(**changes)
        return self

    def policy(self, name: str, **options) -> "CoexecSpecBuilder":
        """Select the scheduling policy (plus policy-specific options)."""
        sched = self._spec.scheduler.replace(policy=str(name))
        if options:
            sched = sched.with_options(**options)
        return self._update(scheduler=sched)

    def scheduler_options(self, **options) -> "CoexecSpecBuilder":
        """Merge policy options without changing the policy."""
        return self._update(
            scheduler=self._spec.scheduler.with_options(**options))

    def granularity(self, granularity: int) -> "CoexecSpecBuilder":
        """Set the package alignment (local work size)."""
        return self._update(
            scheduler=self._spec.scheduler.replace(
                granularity=int(granularity)))

    def units(self, count: Optional[int] = None,
              kinds: Sequence[str] = (),
              speed_hints: Sequence[float] = (),
              pipeline_depth: Optional[int] = None) -> "CoexecSpecBuilder":
        """Describe the Coexecution Units to build."""
        depth = self._spec.units.pipeline_depth if pipeline_depth is None \
            else int(pipeline_depth)
        return self._update(units=self._spec.units.replace(
            count=count, kinds=tuple(kinds),
            speed_hints=tuple(speed_hints), pipeline_depth=depth))

    def pipeline_depth(self, depth: int) -> "CoexecSpecBuilder":
        """Set how many packages a unit may have in flight at once."""
        return self._update(units=self._spec.units.replace(
            pipeline_depth=int(depth)))

    def dist(self, *shares: float) -> "CoexecSpecBuilder":
        """Computing-power hint: one first-unit share, or per-unit shares."""
        return self._update(
            units=self._spec.units.replace(dist=tuple(shares)))

    def memory(self, model: str) -> "CoexecSpecBuilder":
        """Select the memory model (``"usm"`` / ``"buffers"``)."""
        return self._update(memory=self._spec.memory.replace(
            model=str(model)))

    def admission(self, policy: Optional[str] = None, *,
                  wfq: Optional[bool] = None,
                  max_inflight: Optional[int] = None,
                  quantum: Optional[int] = None,
                  preempt: Optional[bool] = None) -> "CoexecSpecBuilder":
        """Configure cross-launch admission.

        Args:
            policy: explicit policy name (``"fifo"`` / ``"wfq"``).
            wfq: shorthand — ``True`` selects ``"wfq"``, ``False``
                ``"fifo"`` (ignored when ``policy`` is given).
            max_inflight: backpressure cap (``None`` leaves it unchanged).
            quantum: WFQ credit per round (``None`` leaves it unchanged).
            preempt: WFQ mid-launch credit reclamation — cap per-pull
                package sizes of over-served tenants (``None`` leaves it
                unchanged).

        Returns:
            The builder.
        """
        adm = self._spec.admission
        if policy is not None:
            adm = adm.replace(policy=str(policy))
        elif wfq is not None:
            adm = adm.replace(policy="wfq" if wfq else "fifo")
        if max_inflight is not None:
            adm = adm.replace(max_inflight=int(max_inflight))
        if quantum is not None:
            adm = adm.replace(quantum=int(quantum))
        if preempt is not None:
            adm = adm.replace(preempt=bool(preempt))
        return self._update(admission=adm)

    def slo(self, slo_ms: Optional[float], *,
            shed: Optional[bool] = None,
            shed_budget: Optional[float] = None,
            shed_rate: Optional[float] = None,
            edf_boost: Optional[float] = None) -> "CoexecSpecBuilder":
        """Configure deadline-aware admission (SLO + load shedding).

        Args:
            slo_ms: default per-launch deadline in milliseconds
                (``None`` clears it).
            shed: reject predicted deadline misses (``None`` leaves it
                unchanged).
            shed_budget: maximum rejected fraction of offered launches.
            shed_rate: service-rate estimate in items/s for the finish
                predictor.
            edf_boost: EDF credit-boost factor for deadline-ranked
                refills.

        Returns:
            The builder.
        """
        adm = self._spec.admission.replace(slo_ms=slo_ms)
        if shed is not None:
            adm = adm.replace(shed=bool(shed))
        if shed_budget is not None:
            adm = adm.replace(shed_budget=float(shed_budget))
        if shed_rate is not None:
            adm = adm.replace(shed_rate=float(shed_rate))
        if edf_boost is not None:
            adm = adm.replace(edf_boost=float(edf_boost))
        return self._update(admission=adm)

    def traffic(self, arrival: Optional[str] = None,
                **changes) -> "CoexecSpecBuilder":
        """Configure the open-loop arrival process.

        Args:
            arrival: process name (``"closed"`` / ``"poisson"`` /
                ``"burst"``).
            **changes: any other :class:`TrafficSpec` field.

        Returns:
            The builder.
        """
        tr = self._spec.traffic
        if arrival is not None:
            tr = tr.replace(arrival=str(arrival))
        if changes:
            tr = tr.replace(**changes)
        return self._update(traffic=tr)

    def cluster(self, on: bool = True, *,
                min_units: Optional[int] = None,
                max_units: Optional[int] = None,
                autoscale: Optional[bool] = None,
                failure_plan: Optional[str] = None,
                **changes) -> "CoexecSpecBuilder":
        """Configure the elastic cluster tier.

        Args:
            on: serve through the resizable pool.
            min_units: active floor (``None`` leaves it unchanged).
            max_units: provisioned ceiling.
            autoscale: resize on admission queue depth.
            failure_plan: path to a committed FailurePlan JSON.
            **changes: any other :class:`ClusterSpec` field.

        Returns:
            The builder.
        """
        cl = self._spec.cluster.replace(enabled=bool(on))
        if min_units is not None:
            cl = cl.replace(min_units=int(min_units))
        if max_units is not None:
            cl = cl.replace(max_units=int(max_units))
        if autoscale is not None:
            cl = cl.replace(autoscale=bool(autoscale))
        if failure_plan is not None:
            cl = cl.replace(failure_plan=str(failure_plan))
        if changes:
            cl = cl.replace(**changes)
        return self._update(cluster=cl)

    def fuse(self, on: bool = True, *,
             threshold: Optional[int] = None,
             limit: Optional[int] = None,
             wait_s: Optional[float] = None) -> "CoexecSpecBuilder":
        """Toggle launch fusion (and optionally tune its window/limits)."""
        adm = self._spec.admission.replace(fuse=bool(on))
        if threshold is not None:
            adm = adm.replace(fuse_threshold=int(threshold))
        if limit is not None:
            adm = adm.replace(fuse_limit=int(limit))
        if wait_s is not None:
            adm = adm.replace(fuse_wait_s=float(wait_s))
        return self._update(admission=adm)

    def workload(self, name: Optional[str] = None, *,
                 kernel: Optional[str] = None,
                 kernel_impl: Optional[str] = None,
                 items: Optional[int] = None,
                 requests: Optional[int] = None,
                 concurrent: Optional[int] = None,
                 tenants: Optional[int] = None,
                 size_scale: Optional[float] = None) -> "CoexecSpecBuilder":
        """Describe what to run and the serving shape."""
        wl = self._spec.workload
        if name is not None:
            wl = wl.replace(name=str(name))
        if kernel is not None:
            wl = wl.replace(kernel=str(kernel))
        if kernel_impl is not None:
            wl = wl.replace(kernel_impl=str(kernel_impl))
        if items is not None:
            wl = wl.replace(items=int(items))
        if requests is not None:
            wl = wl.replace(requests=int(requests))
        if concurrent is not None:
            wl = wl.replace(concurrent=int(concurrent))
        if tenants is not None:
            wl = wl.replace(tenants=int(tenants))
        if size_scale is not None:
            wl = wl.replace(size_scale=float(size_scale))
        return self._update(workload=wl)

    def build(self) -> CoexecSpec:
        """Freeze and validate the spec.

        Returns:
            The validated :class:`CoexecSpec`.

        Raises:
            KeyError: unknown policy or workload profile.
            ValueError: invalid options anywhere in the tree.
        """
        return self._spec.validate()
