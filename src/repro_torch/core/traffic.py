"""Open-loop traffic: seeded trace synthesis, JSON replay, SLO stats.

Every sweep the repo ran before this module was closed-loop — submit a
fixed batch, drain — which hides exactly the tail behavior the paper's
time-constrained setting cares about. This module supplies the missing
open-loop side as *data*, not as another execution path: a
:class:`Trace` is a plain list of timed :class:`Arrival` records that
replays through the one shared :class:`~repro_torch.core.exec.ExecutionLoop`
on either substrate.

Two replay modes cover the two questions asked of a trace:

* :func:`replay_trace_sim` pushes the trace through
  :func:`~repro_torch.core.sim.simulate_multi`'s event pump for *metrics* —
  virtual-time per-tenant p50/p99 latency, deadline-miss rate and shed
  fraction under the calibrated cost model.
* :func:`replay_trace_lockstep` drives any backend (real engine units or
  the DES) with a deterministic trace-timed serve order for *structure*
  — the accept/shed decision sequence and the fusion groupings. Because
  admission decisions depend only on the arrival sequence and the
  config (the shed estimator keeps its own virtual finish horizon; see
  :meth:`~repro_torch.core.admission.AdmissionController.offer`), the same
  trace produces the same decision log on both substrates — the parity
  the trace-replay harness pins.

Synthesis is deterministic and *scale-stable*: unit-rate exponential
gaps are drawn once from the seed and divided by the offered rate, so
the same seed at a higher rate yields the exact same arrival sequence
compressed in time — which is what makes "deadline-miss rate is
monotone in offered load" a well-posed single-seed assertion.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Optional, Sequence, Union

import numpy as np

from .admission import AdmissionConfig, coerce_admission
from .scheduler import DynamicScheduler
from .sim import LaunchSpec, MultiSimResult, Workload, simulate_multi
from .units import SimUnit

__all__ = [
    "Arrival", "Trace", "TenantRow", "TrafficReplay", "synthesize_trace",
    "capacity_items_per_s", "replay_trace_sim", "replay_trace_lockstep",
    "tenant_rows",
]

TRACE_VERSION = 1

# Modeled bytes moved per work-item for the synthetic serving workload —
# small and uniform so traffic replays stress scheduling, not bandwidth.
_BYTES_PER_ITEM = 8.0
_WORKING_SET = 1e4

# Default derating of raw unit speeds when the shed estimator's
# ``shed_rate`` is not configured: serialized per-package host costs
# (launch + collect) eat a measurable slice of nominal capacity under
# sustained load, and an estimator fed the raw sum admits launches the
# host can never finish on time.
SHED_RATE_MARGIN = 0.8


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One open-loop request: who asks for how much work, when.

    Attributes:
        t: absolute arrival time in seconds from trace start.
        tenant: fairness flow the request belongs to.
        items: launch index-space size (work-items).
        weight: tenant's relative WFQ share.
        slo_ms: relative deadline in milliseconds (``None`` defers to
            the admission config's ``slo_ms`` default, if any).
    """

    t: float
    tenant: str
    items: int
    weight: float = 1.0
    slo_ms: Optional[float] = None

    def deadline(self) -> Optional[float]:
        """Absolute deadline in trace seconds (``None`` without an SLO)."""
        if self.slo_ms is None:
            return None
        return self.t + self.slo_ms / 1e3


@dataclasses.dataclass(frozen=True)
class Trace:
    """An ordered open-loop arrival sequence plus its provenance.

    Traces are artifacts: :meth:`to_json`/:meth:`from_json` round-trip
    losslessly, so a synthesized trace can be committed and replayed
    byte-identically by CI on either backend.
    """

    arrivals: tuple[Arrival, ...]
    meta: dict = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.arrivals)

    def tenants(self) -> list[str]:
        """Distinct tenant names in first-arrival order."""
        seen: dict[str, None] = {}
        for a in self.arrivals:
            seen.setdefault(a.tenant)
        return list(seen)

    def duration_s(self) -> float:
        """Last arrival time (0.0 for an empty trace)."""
        return self.arrivals[-1].t if self.arrivals else 0.0

    def offered_rate(self) -> float:
        """Mean offered arrival rate in launches/s over the trace."""
        d = self.duration_s()
        return len(self.arrivals) / d if d > 0 else 0.0

    def scaled(self, factor: float) -> "Trace":
        """The same arrival sequence with time compressed by ``factor``.

        Args:
            factor: load multiplier; every timestamp is divided by it,
                so ``factor > 1`` offers the identical sequence faster.

        Returns:
            A new trace (meta carries the applied factor).
        """
        if factor <= 0:
            raise ValueError("factor must be positive")
        arrivals = tuple(dataclasses.replace(a, t=a.t / factor)
                         for a in self.arrivals)
        meta = dict(self.meta)
        meta["scaled_by"] = meta.get("scaled_by", 1.0) * factor
        return Trace(arrivals, meta)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        """Plain-dict form, tagged with a trace schema version."""
        return {
            "version": TRACE_VERSION,
            "meta": dict(self.meta),
            "arrivals": [
                {"t": a.t, "tenant": a.tenant, "items": a.items,
                 "weight": a.weight, "slo_ms": a.slo_ms}
                for a in self.arrivals],
        }

    @classmethod
    def from_dict(cls, data: dict) -> "Trace":
        """Lossless inverse of :meth:`to_dict`.

        Args:
            data: a :meth:`to_dict` result.

        Returns:
            The deserialized trace.

        Raises:
            ValueError: unsupported trace schema version.
        """
        version = data.get("version", TRACE_VERSION)
        if version != TRACE_VERSION:
            raise ValueError(f"unsupported trace version {version!r} "
                             f"(this build reads version {TRACE_VERSION})")
        arrivals = tuple(
            Arrival(t=float(a["t"]), tenant=str(a["tenant"]),
                    items=int(a["items"]),
                    weight=float(a.get("weight", 1.0)),
                    slo_ms=a.get("slo_ms"))
            for a in data.get("arrivals", []))
        return cls(arrivals, dict(data.get("meta", {})))

    def to_json(self, **dumps_kw) -> str:
        """JSON form of :meth:`to_dict` (sorted keys by default)."""
        dumps_kw.setdefault("sort_keys", True)
        return json.dumps(self.to_dict(), **dumps_kw)

    @classmethod
    def from_json(cls, text: str) -> "Trace":
        """Inverse of :meth:`to_json`.

        Args:
            text: a JSON document produced by :meth:`to_json`.

        Returns:
            The deserialized trace.
        """
        return cls.from_dict(json.loads(text))

    def save(self, path: Union[str, pathlib.Path]) -> None:
        """Write the trace as pretty-printed JSON.

        Args:
            path: destination file path.
        """
        pathlib.Path(path).write_text(self.to_json(indent=2) + "\n")

    @classmethod
    def load(cls, path: Union[str, pathlib.Path]) -> "Trace":
        """Read a trace written by :meth:`save`.

        Args:
            path: source file path.

        Returns:
            The deserialized trace.
        """
        return cls.from_json(pathlib.Path(path).read_text())


def synthesize_trace(arrivals: int, rate: float, *,
                     arrival: str = "poisson",
                     tenants: Union[int, Sequence[str]] = 4,
                     mix: Optional[Sequence[float]] = None,
                     tenant_weights: Optional[Sequence[float]] = None,
                     items: int = 1024,
                     item_jitter: float = 0.0,
                     slo_ms: Optional[float] = None,
                     burst: float = 4.0,
                     burst_duty: float = 0.2,
                     burst_cycle: int = 128,
                     seed: int = 0) -> Trace:
    """Deterministically synthesize an open-loop arrival trace.

    ``"poisson"`` draws i.i.d. exponential inter-arrival gaps at
    ``rate``. ``"burst"`` is an on/off modulated Poisson process: during
    the on phase (``burst_duty`` of each cycle) the instantaneous rate
    is ``burst * rate``; the off phase runs at the complementary rate
    ``(1 - burst_duty*burst) / (1 - burst_duty) * rate`` so the
    time-averaged rate stays ``rate``. All randomness comes from
    ``seed``, and gaps are unit-rate samples divided by the phase rate —
    so the same seed at a different ``rate`` produces the identical
    arrival sequence with time rescaled exactly.

    Args:
        arrivals: number of arrivals to generate.
        rate: mean offered rate in launches/s (must be positive).
        arrival: ``"poisson"`` or ``"burst"``.
        tenants: tenant count (named ``t0..tN-1``) or explicit names.
        mix: per-tenant arrival probabilities (default uniform).
        tenant_weights: per-tenant WFQ weights (default all 1.0).
        items: work-items per launch before jitter.
        item_jitter: log2-uniform spread of per-arrival item counts —
            each launch gets ``items * 2**U(-j, +j)`` items (0 = every
            launch identical).
        slo_ms: relative deadline stamped on every arrival (or ``None``).
        burst: on-phase rate multiplier (``arrival="burst"`` only).
        burst_duty: on-phase fraction of each cycle, in (0, 1);
            ``burst * burst_duty`` must stay below 1.
        burst_cycle: expected arrivals per on/off cycle (sets the cycle
            period to ``burst_cycle / rate`` seconds).
        seed: PRNG seed.

    Returns:
        A :class:`Trace` with synthesis parameters recorded in ``meta``.

    Raises:
        ValueError: non-positive counts/rate, unknown arrival process,
            or a burst shape whose off-phase rate is not positive.
    """
    if arrivals < 1:
        raise ValueError("arrivals must be a positive integer")
    if rate <= 0:
        raise ValueError("rate must be positive")
    if arrival not in ("poisson", "burst"):
        raise ValueError(f"unknown arrival process {arrival!r}; "
                         f"choose from ['poisson', 'burst']")
    if arrival == "burst":
        if burst < 1:
            raise ValueError("burst must be >= 1")
        if not 0 < burst_duty < 1:
            raise ValueError("burst_duty must be in (0, 1)")
        if burst * burst_duty >= 1:
            raise ValueError("burst * burst_duty must be < 1 so the "
                             "off-phase rate stays positive")
    names = ([f"t{i}" for i in range(int(tenants))]
             if isinstance(tenants, int) else [str(t) for t in tenants])
    if not names:
        raise ValueError("at least one tenant is required")
    probs = None
    if mix is not None:
        p = np.asarray(mix, dtype=np.float64)
        if len(p) != len(names) or np.any(p < 0) or p.sum() <= 0:
            raise ValueError("mix must be non-negative, one per tenant")
        probs = p / p.sum()
    w_of = {n: 1.0 for n in names}
    if tenant_weights is not None:
        if len(tenant_weights) != len(names):
            raise ValueError("tenant_weights must have one entry per "
                             "tenant")
        w_of = {n: float(w) for n, w in zip(names, tenant_weights)}

    rng = np.random.default_rng(seed)
    gaps = rng.exponential(size=arrivals)          # unit-rate samples
    tenant_idx = rng.integers(0, len(names), size=arrivals) \
        if probs is None else rng.choice(len(names), size=arrivals, p=probs)
    jitter = (np.exp2(rng.uniform(-item_jitter, item_jitter,
                                  size=arrivals))
              if item_jitter > 0 else np.ones(arrivals))

    low = ((1.0 - burst_duty * burst) / (1.0 - burst_duty)
           if arrival == "burst" else 1.0)
    cycle_s = burst_cycle / rate
    on_s = burst_duty * cycle_s
    out: list[Arrival] = []
    t = 0.0
    for i in range(arrivals):
        factor = burst if (arrival == "burst"
                           and t % cycle_s < on_s) else \
            (low if arrival == "burst" else 1.0)
        t += gaps[i] / (rate * factor)
        n_items = max(1, int(round(items * jitter[i])))
        name = names[tenant_idx[i]]
        out.append(Arrival(t=t, tenant=name, items=n_items,
                           weight=w_of[name], slo_ms=slo_ms))
    meta = {"arrival": arrival, "rate": rate, "seed": seed,
            "items": items, "item_jitter": item_jitter,
            "tenants": names, "slo_ms": slo_ms}
    if arrival == "burst":
        meta.update(burst=burst, burst_duty=burst_duty,
                    burst_cycle=burst_cycle)
    return Trace(tuple(out), meta)


def capacity_items_per_s(units: Sequence[SimUnit]) -> float:
    """Aggregate modeled serving capacity of a DES unit set.

    Args:
        units: the simulated Coexecution Units.

    Returns:
        Summed unit speeds in work-items/s — the natural default for
        the shed estimator's ``shed_rate`` and for converting a
        ``--load`` multiple into an arrival rate.
    """
    return float(sum(u.speed for u in units))


@dataclasses.dataclass
class TenantRow:
    """Per-tenant serving outcome of one trace replay."""

    tenant: str
    arrivals: int
    admitted: int
    shed: int
    p50_ms: float
    p99_ms: float
    miss_rate: float


@dataclasses.dataclass
class TrafficReplay:
    """Outcome of replaying one trace through the DES event pump.

    Attributes:
        trace: the replayed trace.
        result: the underlying multi-launch simulation result.
        rows: per-tenant latency/SLO rows (stable tenant order).
    """

    trace: Trace
    result: MultiSimResult
    rows: list[TenantRow]

    @property
    def decisions(self) -> list[tuple[str, str]]:
        """The accept/shed decision sequence, in offer order."""
        return self.result.decisions

    @property
    def fusion_groups(self) -> list[tuple[str, ...]]:
        """Member-tenant tuples of every materialized fused batch."""
        return self.result.fusion_groups

    def admitted_latencies_ms(self) -> list[float]:
        """Latencies of admitted launches in milliseconds."""
        return [r.latency_s * 1e3 for r in self.result.launches]

    def p99_ms(self) -> float:
        """Admitted-launch p99 latency in milliseconds (0 when empty)."""
        lats = self.admitted_latencies_ms()
        return float(np.percentile(lats, 99)) if lats else 0.0

    def p50_ms(self) -> float:
        """Admitted-launch median latency in milliseconds (0 when empty)."""
        lats = self.admitted_latencies_ms()
        return float(np.percentile(lats, 50)) if lats else 0.0

    def miss_rate(self) -> float:
        """Deadline-miss rate over admitted deadline-carrying launches."""
        return self.result.deadline_miss_rate()

    def shed_fraction(self) -> float:
        """Shed launches as a fraction of everything offered."""
        return self.result.shed_fraction()


def _percentile_ms(latencies_s: list[float], q: float) -> float:
    return float(np.percentile([v * 1e3 for v in latencies_s], q)) \
        if latencies_s else 0.0


def tenant_rows(trace: Trace, result: MultiSimResult) -> list[TenantRow]:
    """Fold a replay result into per-tenant latency/SLO rows.

    Args:
        trace: the replayed trace (fixes tenant order).
        result: the simulation result for that trace.

    Returns:
        One :class:`TenantRow` per tenant, in first-arrival order.
    """
    offered: dict[str, int] = {}
    for a in trace.arrivals:
        offered[a.tenant] = offered.get(a.tenant, 0) + 1
    by_tenant: dict[str, list] = {t: [] for t in offered}
    for r in result.launches:
        by_tenant.setdefault(r.tenant, []).append(r)
    shed_of: dict[str, int] = {}
    for s in result.shed:
        shed_of[s.tenant] = shed_of.get(s.tenant, 0) + 1
    rows = []
    for tenant in trace.tenants():
        served = by_tenant.get(tenant, [])
        lats = [r.latency_s for r in served]
        with_slo = [r for r in served if r.deadline is not None]
        miss = (sum(bool(r.deadline_missed) for r in with_slo)
                / len(with_slo)) if with_slo else 0.0
        rows.append(TenantRow(
            tenant=tenant, arrivals=offered.get(tenant, 0),
            admitted=len(served), shed=shed_of.get(tenant, 0),
            p50_ms=_percentile_ms(lats, 50), p99_ms=_percentile_ms(lats, 99),
            miss_rate=miss))
    return rows


def _resolve_config(admission, spec,
                    units: Sequence[SimUnit]) -> AdmissionConfig:
    """Admission config with the shed estimator's rate defaulted.

    The shed predictor needs a service-rate estimate; when shedding is
    on and no explicit ``shed_rate`` was configured, the modeled
    capacity of the unit set is the deterministic default both replay
    modes share — which is what keeps real/sim decisions identical.
    """
    if admission is None and spec is not None:
        cfg = spec.admission_config()
    else:
        cfg = coerce_admission(admission)
    if cfg.shed and cfg.shed_rate is None:
        cfg = dataclasses.replace(
            cfg, shed_rate=SHED_RATE_MARGIN * capacity_items_per_s(units))
    return cfg


def replay_trace_sim(trace: Trace, units: Sequence[SimUnit], *,
                     admission=None, spec=None, memory=None,
                     num_packages: int = 8,
                     granularity: int = 1) -> TrafficReplay:
    """Replay a trace through the DES event pump for latency/SLO stats.

    Each arrival becomes one :class:`~repro_torch.core.sim.LaunchSpec` with a
    uniform synthetic workload sized by the arrival, submitted at its
    trace time; :func:`~repro_torch.core.sim.simulate_multi` then runs the
    shared control plane in virtual time.

    Args:
        trace: the arrival sequence to replay.
        units: simulated Coexecution Units.
        admission: policy name, :class:`~.admission.AdmissionConfig` or
            ``AdmissionSpec`` (``None`` takes the spec's section).
        spec: optional ``CoexecSpec`` supplying admission/memory.
        memory: memory model override (default: spec's, else USM).
        num_packages: packages per launch for the dynamic scheduler.
        granularity: package alignment in work-items.

    Returns:
        A :class:`TrafficReplay` with the sim result and tenant rows.
    """
    cfg = _resolve_config(admission, spec, units)
    n = len(units)
    specs = []
    for a in trace.arrivals:
        wl = Workload("traffic", a.items, _BYTES_PER_ITEM, _BYTES_PER_ITEM,
                      _WORKING_SET)
        sched = DynamicScheduler(a.items, n,
                                 num_packages=min(num_packages, a.items),
                                 granularity=granularity)
        specs.append(LaunchSpec(workload=wl, scheduler=sched,
                                tenant=a.tenant, weight=a.weight,
                                t_submit=a.t,
                                deadline_s=None if a.slo_ms is None
                                else a.slo_ms / 1e3))
    result = simulate_multi(specs, units, admission=cfg,
                            memory=memory, spec=spec)
    return TrafficReplay(trace=trace, result=result,
                         rows=tenant_rows(trace, result))


def replay_trace_lockstep(trace: Trace, loop, make_launch, *,
                          pulls_per_arrival: int = 1,
                          max_sweeps: int = 1_000_000):
    """Drive any backend through a trace with a deterministic serve order.

    The structural twin of :func:`replay_trace_sim`: arrivals are
    offered at their trace times (``loop.offer(..., now=a.t)``), and
    after each arrival every unit is offered ``pulls_per_arrival``
    pulls at the same trace time — then the loop drains with forced
    fusion flushes. Applied to a ``RealBackend`` and a ``SimBackend``
    with the same trace and config, every control-plane decision — the
    accept/shed sequence in ``loop.admission.decision_log`` and the
    fusion groupings in ``loop.admission.fusion_log`` — must come out
    identical, because nothing in the serve order depends on backend
    time.

    Args:
        trace: the arrival sequence to replay.
        loop: an :class:`~repro_torch.core.exec.ExecutionLoop` over either
            backend, configured with the admission config under test
            (set ``shed_rate`` explicitly — see :func:`_resolve_config`).
        make_launch: callable ``(arrival, loop) -> LaunchState`` that
            builds the backend-typed launch (scheduler, payload,
            ``fuse_key``/``fuse_bucket``) for one arrival.
        pulls_per_arrival: serve sweeps interleaved per arrival.
        max_sweeps: drain-phase safety bound.

    Returns:
        ``(admitted, shed)`` lists of the backend-typed launch states,
        in arrival order.

    Raises:
        AssertionError: the drain phase wedged or did not converge.
    """
    backend = loop.backend
    n_units = len(loop.unit_names)
    admitted, shed = [], []

    def sweep(now: float, force_flush: bool) -> bool:
        progressed = False
        for u in range(n_units):
            work = loop.pull(u, now=now, force_flush=force_flush)
            if work is None:
                continue
            launch, pkg = work
            backend.dispatch(u, launch, pkg)
            loop.complete(launch, pkg)
            progressed = True
        return progressed

    for a in trace.arrivals:
        launch = make_launch(a, loop)
        launch.t_submit = a.t
        if a.slo_ms is not None:
            launch.deadline = a.t + a.slo_ms / 1e3
        if not loop.offer(launch, now=a.t):
            shed.append(launch)
            continue
        admitted.append(launch)
        for _ in range(pulls_per_arrival):
            sweep(a.t, False)
    t_end = trace.duration_s()
    for _ in range(max_sweeps):
        if loop.drained():
            return admitted, shed
        if not sweep(t_end, True) and not loop.drained():
            raise AssertionError("lockstep replay wedged with work "
                                 "outstanding")
    raise AssertionError("lockstep replay did not converge")
