"""Serving launcher: batched LM decoding, plus a co-execution request
server over the persistent CoexecEngine and its discrete-event twins.

Default (LM) mode: requests are random prompts batched up to ``--batch``,
stepped through ``Model.decode_step`` and decoded greedily over the
unpadded vocabulary. The CLI serves the reduced config (as the reference
does) on ``--device`` (``cuda:0`` unless the caller asks for ``cpu``).

    python -m repro_torch.launch.serve --arch zamba2-7b

Co-execution mode: each "request" is one data-parallel kernel launch
served through ``CoexecutorRuntime.launch_async`` on a long-lived engine
over [``cuda:0``, ``cpu``] — up to ``--concurrent`` launches interleave on
the same Coexecution Units, and every CUDA package runs the kernel's
hand-written wrapper (nothing falls back to the plain version on the
card; without CUDA the real mode errors). Every co-execution flag is
*derived* from the :class:`repro_torch.api.CoexecSpec` fields (see
:mod:`repro_torch.api.cli`): the parsed flags fold into one spec that
drives the real engine and the DES identically, ``--spec-json`` dumps the
resolved spec as a reproducible artifact, and ``--list`` prints every
registered scheduler/workload/kernel with its declared option fields.
``--policy all`` sweeps every registered policy; with ``--coexec sim``
the same sweep runs on the DES, whose virtual seconds are the paper
testbed's calibration, not the card's. ``--admission wfq`` / ``--fuse``
/ ``--preempt`` / ``--tenants N`` switch the sim path to the
multi-tenant DES sweep, ``--arrival poisson|burst`` to the open-loop
SLO replay, and ``--cluster`` to the elastic cluster tier.

    python -m repro_torch.launch.serve --coexec real \
        --policy all --requests 16 --concurrent 8 --n 65536 \
        --kernel mandelbrot --memory buffers
    python -m repro_torch.launch.serve --coexec sim \
        --policy all --workload mandelbrot
    python -m repro_torch.launch.serve --coexec sim \
        --admission wfq --fuse --tenants 16
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..models import Model, build_model


def serve_lm(model: Model, params, *, requests: int, batch: int,
             prompt_len: int, max_tokens: int, seed: int = 1,
             device: torch.device | str = "cuda:0") -> dict:
    """Serve ``requests`` random prompts in batches of ``batch``.

    Args:
        model: the built model; ``params`` its parameters on ``device``.
        requests: how many requests to serve.
        batch: requests per batch (the last batch is padded to it).
        prompt_len: tokens per prompt (P).
        max_tokens: tokens generated per request (G).
        seed: seeds the prompts' generator.
        device: where the cache and the tokens live.

    Returns:
        ``{"requests", "tokens", "seconds"}``: requests served, tokens
        processed (requests * (P + G)), and the wall time in seconds, up
        to the last batch's final token on the host.
    """
    device = torch.device(device)
    cfg = model.cfg
    B, P, G = batch, prompt_len, max_tokens
    gen = torch.Generator().manual_seed(seed)
    served = 0
    t0 = time.perf_counter()
    for _ in range(-(-requests // B)):
        n = min(B, requests - served)
        prompts = torch.randint(0, cfg.vocab_size, (B, P),
                                generator=gen).to(device)
        cache = model.init_cache(B, P + G, device=device)
        for t in range(P):
            logits, cache = model.decode_step(params, prompts[:, t:t + 1],
                                              cache)
        cur = torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None]
        for _ in range(G - 1):
            logits, cache = model.decode_step(params, cur, cache)
            cur = torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None]
        cur.cpu()                      # the batch's last token is done
        served += n
    return {"requests": served, "tokens": served * (P + G),
            "seconds": time.perf_counter() - t0}


def _percentile_ms(sorted_s: list, q: float) -> float:
    """Nearest-rank percentile of sorted seconds, in milliseconds."""
    import math

    if not sorted_s:
        return float("nan")
    idx = max(0, math.ceil(q * len(sorted_s)) - 1)
    return 1e3 * sorted_s[idx]


def default_serve_spec():
    """The serve CLI's base spec: the paper's CPU+GPU pair.

    Equal to the reference's in every section but ``units``: its two
    units are [``cuda:0``, ``cpu``], whose devices decide their kinds
    (``gpu``, ``cpu``), and it gives no ``speed_hints`` and no ``dist``,
    so :func:`coexec_real_rows` measures the shares on the devices. The
    reference names two faked CPU units with hints (0.4, 0.6) and dist
    0.4, which on [``cuda:0``, ``cpu``] would hand the CPU 60 % of a
    static split. Flags the user passes override these fields (see
    :func:`repro_torch.api.cli.spec_from_args`).
    """
    from ..api import CoexecSpec

    return (CoexecSpec.builder()
            .policy("all")      # sweep every registered policy by default
            .units(count=2)
            .workload("mandelbrot")
            .build())


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
    from ..core import ArgRole, CoexecutorRuntime

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


def _sweep_policies(spec) -> tuple[str, ...]:
    """Expand ``policy="all"`` into every registered policy name."""
    from ..api import scheduler_names

    if spec.scheduler.policy == "all":
        return scheduler_names()
    return (spec.scheduler.policy,)


def coexec_real_rows(spec=None, *, policies=None, units=None,
                     on_result=None) -> list[dict]:
    """Serve ``spec.workload.requests`` kernel launches per policy through
    the persistent engine (at most ``spec.workload.concurrent`` in
    flight); one measurement dict each. The spec's admission section
    selects the engine's cross-launch queueing policy; its workload
    section picks the served kernel (any registered kernel, via
    ``--kernel`` or the workload's name) and its memory section the data
    plane, whose dispatch/copy counters are aggregated into each row.

    A spec without ``dist`` (the default) gets the shares
    :func:`measured_dist` measures on the units, once per call; each
    row's ``dist`` is the one in force. Each policy's runtime first
    serves one untimed warm-up launch, which loads the kernel once on
    every unit (nothing compiles per shape on CUDA); the clock starts
    after it. ``device_idle_frac`` is the share of unit-seconds no unit
    computed over the timed window, pooled over the units (one minus
    their mean occupancy); ``unit_idle_frac`` is each unit's own share
    by name. ``host_overhead_frac`` is the staging plus collection
    seconds over the window.

    Args:
        spec: the serve spec (default :func:`default_serve_spec`).
        policies: policy names to sweep (default: the spec's, ``all``
            expanded).
        units: pre-built units (default ``spec.build_units()``:
            [``cuda:0``, ``cpu``], which raises without CUDA).
        on_result: optional ``(policy, request, inputs, output)`` callback
            for every served request's output, in completion order, while
            later requests may be in flight (a launch's arrays are
            unmapped before its handle resolves, and the arrays the port
            allocates own their pages, so copying them to the card is
            safe under USM).

    Returns:
        One row per policy.
    """
    from ..api import kernel_demo_inputs
    from ..core import CoexecutorRuntime, jain_index, service_fairness_curve
    from ..kernels import resolve_impl

    if spec is None:
        spec = default_serve_spec()
    if units is None:
        units = spec.build_units()
    n = spec.workload.items
    requests = spec.workload.requests
    concurrent = spec.workload.concurrent
    kname = spec.workload.resolve_kernel()
    impl = resolve_impl(spec.workload.kernel_impl)
    kernel = spec.workload.build_kernel()
    datas = [kernel_demo_inputs(kname, n, seed=i) for i in range(requests)]
    if not spec.units.dist:
        spec = spec.replace(units=spec.units.replace(dist=measured_dist(
            units, kernel, datas[0], n, spec.memory.model)))
    rows = []
    for policy in (policies or _sweep_policies(spec)):
        pspec = spec.replace(
            scheduler=spec.scheduler.replace(policy=policy))
        with CoexecutorRuntime.from_spec(pspec, units=units) as rt:
            rt.launch(n, kernel, datas[0])          # warm-up, untimed
            busy0 = [u.busy_s for u in units]
            t0 = time.perf_counter()
            served, pkgs, lats, inflight = 0, 0, [], []
            h2d, d2h, dispatches = 0, 0, 0
            host_s = 0.0        # staging + collection (non-compute) time
            service = []        # (t_complete, tenant, items) per package

            def _reap(h, t_sub, i):
                nonlocal served, pkgs, h2d, d2h, dispatches, host_s
                out = h.result()
                served, pkgs = served + 1, pkgs + h.stats.num_packages
                h2d += h.stats.data.h2d_copies
                d2h += h.stats.data.d2h_copies
                dispatches += h.stats.data.dispatches
                host_s += sum((p.t_launch - p.t_issue)
                              + (p.t_collected - p.t_complete)
                              for p in h.stats.packages)
                service.extend((p.t_complete, f"t{i}", p.size)
                               for p in h.stats.packages)
                lats.append(time.perf_counter() - t_sub)
                if on_result is not None:
                    on_result(policy, i, datas[i], out)

            for i, d in enumerate(datas):
                inflight.append((rt.launch_async(n, kernel, d,
                                                 tenant=f"t{i}"),
                                 time.perf_counter(), i))
                if len(inflight) >= concurrent:
                    _reap(*inflight.pop(0))
            for h, t_sub, i in inflight:
                _reap(h, t_sub, i)
            dt = time.perf_counter() - t0
            busy = [u.busy_s - b for u, b in zip(units, busy0)]
        lats.sort()
        # fairness of throughput across requests + the time-sampled
        # service fairness curve (the measure --preempt tightens), on a
        # duration-weighted deterministic clock (items computed)
        thru = [n / max(lat, 1e-9) for lat in lats]
        clock, ticked = 0, []
        for _, tenant, items in sorted(service):
            clock += items
            ticked.append((clock, tenant, items))
        curve = service_fairness_curve(
            ticked, [f"t{i}" for i in range(requests)])
        rows.append(dict(kernel=kname, impl=impl,
                         memory=spec.memory.model,
                         policy=policy, requests=served, n=n,
                         concurrent=concurrent, seconds=dt, packages=pkgs,
                         req_per_s=served / dt,
                         items_per_s=served * n / dt,
                         dispatches=dispatches,
                         h2d_copies=h2d, d2h_copies=d2h,
                         device_idle_frac=max(
                             0.0, 1.0 - sum(busy) / (len(units) * dt)),
                         unit_idle_frac={u.name: max(0.0, 1.0 - b / dt)
                                         for u, b in zip(units, busy)},
                         dist=list(pspec.speeds_for(len(units))),
                         host_overhead_frac=host_s / dt,
                         fairness=jain_index(thru),
                         fairness_curve_mean=float(sum(curve) / len(curve)),
                         fairness_curve_min=float(min(curve)),
                         p50_ms=_percentile_ms(lats, 0.5),
                         p99_ms=_percentile_ms(lats, 0.99)))
    return rows


def coexec_sim_rows(spec=None, *, policies=None) -> list[dict]:
    """The same policy sweep on the DES (virtual time, deterministic).

    The spec's scheduler section (options, granularity) drives the DES
    split exactly as it drives the real engine; the speed hint is the
    DES units' calibrated speeds (the profile's ground truth), not the
    spec's ``dist`` — `dist` describes real devices the DES replaces.
    """
    from ..core import paper_workload, simulate

    if spec is None:
        spec = default_serve_spec()
    workload = spec.workload.name
    wl, cpu, gpu = paper_workload(workload,
                                  size_scale=spec.workload.size_scale)
    rows = []
    for policy in (policies or _sweep_policies(spec)):
        sched = spec.scheduler.replace(policy=policy).build(
            wl.total, 2, speeds=[cpu.speed, gpu.speed])
        r = simulate(sched, [cpu, gpu], wl, spec=spec)
        busy = sum(r.unit_busy_s.values())
        span = max(r.total_s, 1e-12)
        rows.append(dict(workload=workload, policy=policy,
                         memory=r.memory,
                         seconds=r.total_s, packages=r.num_packages,
                         balance=r.balance(),
                         steals=getattr(sched, "steals", 0),
                         dispatches=r.data.dispatches,
                         h2d_copies=r.data.h2d_copies,
                         d2h_copies=r.data.d2h_copies,
                         device_idle_frac=max(
                             0.0, 1.0 - busy / (len(r.unit_busy_s) * span)),
                         host_overhead_frac=r.host_busy_s / span))
    return rows


def coexec_multi_rows(spec=None, *, tenants=None, policies=None,
                      per_tenant_items: int = 2048,
                      num_packages: int = 16,
                      admissions=None,
                      fuse_modes=None,
                      preempt_modes=None) -> list[dict]:
    """Multi-tenant admission sweep on the DES: one row per (tenant count,
    policy, admission policy, fusion mode, preemption mode) with p50/p99
    latency, Jain fairness over per-tenant throughput, the time-sampled
    service fairness curve (the measure ``--preempt`` tightens), and
    total dispatched packages. Sweep axes default to the single point the
    spec describes (its admission policy/fuse/preempt flags and
    ``workload.tenants``); pass tuples to sweep. Shared by
    ``serve --coexec sim --admission/--fuse/--preempt/--tenants``.
    """
    import numpy as np

    from ..core import (LaunchSpec, Workload, jain_index, paper_workload,
                        simulate_multi)

    if spec is None:
        spec = default_serve_spec()
    workload = spec.workload.name
    if tenants is None:
        tenants = (spec.workload.tenants or 8,)
    if admissions is None:
        admissions = (spec.admission.policy,)
    if fuse_modes is None:
        fuse_modes = (spec.admission.fuse,)
    if preempt_modes is None:
        preempt_modes = (spec.admission.preempt,)
    base, cpu, gpu = paper_workload(workload)
    per_item_in = base.bytes_in_per_item
    per_item_out = base.bytes_out_per_item
    # keep the profile's irregularity: resample its per-item weights to
    # the per-tenant problem size (as paper_workload does for size sweeps)
    weights = None
    if base.weights is not None:
        idx = np.linspace(0, len(base.weights) - 1,
                          per_tenant_items).astype(int)
        weights = base.weights[idx]

    def sched_for(policy):
        # the spec's scheduler options/granularity apply; dynamic gets a
        # per-tenant-sized package count unless the spec pins one
        sched_spec = spec.scheduler.replace(policy=policy)
        if policy == "dynamic" and \
                "num_packages" not in sched_spec.options_dict():
            sched_spec = sched_spec.with_options(num_packages=num_packages)
        return sched_spec.build(per_tenant_items, 2,
                                speeds=[cpu.speed, gpu.speed])

    def specs(nt, policy):
        out = []
        for t in range(nt):
            wl = Workload(name=base.name, total=per_tenant_items,
                          bytes_in_per_item=per_item_in,
                          bytes_out_per_item=per_item_out,
                          working_set_bytes=base.working_set_bytes
                          * per_tenant_items / base.total,
                          weights=weights,
                          contention_scale=base.contention_scale)
            out.append(LaunchSpec(wl, sched_for(policy), tenant=f"t{t}"))
        return out

    rows = []
    for policy in (policies or ("dynamic",)):
        for nt in tenants:
            for adm in admissions:
                for fuse in fuse_modes:
                    for preempt in preempt_modes:
                        if preempt and adm != "wfq" \
                                and False in preempt_modes:
                            # sweeping both modes: fifo+preempt would
                            # duplicate the fifo row (preemption only
                            # reclaims WFQ credit). A single-point
                            # request still produces its row, with the
                            # flag inert.
                            continue
                        cfg = spec.admission.replace(
                            policy=adm, fuse=fuse, preempt=preempt,
                            fuse_threshold=per_tenant_items,
                            fuse_wait_s=0.0).to_config()
                        res = simulate_multi(specs(nt, policy), [cpu, gpu],
                                             admission=cfg)
                        lats = sorted(res.latencies())
                        thru = [r.items / max(r.latency_s, 1e-12)
                                for r in res.launches]
                        curve = res.fairness_curve()
                        rows.append(dict(
                            workload=workload, tenants=nt, admission=adm,
                            fuse=fuse, preempt=preempt, policy=policy,
                            p50_ms=_percentile_ms(lats, 0.5),
                            p99_ms=_percentile_ms(lats, 0.99),
                            fairness=jain_index(thru),
                            fairness_curve_mean=float(
                                sum(curve) / len(curve)),
                            fairness_curve_min=float(min(curve)),
                            packages=res.dispatched_packages,
                            fused_batches=res.fused_batches,
                            total_ms=1e3 * res.total_s))
    return rows


def trace_from_spec(spec, capacity_items_s: float):
    """Build (or load) the open-loop trace the spec's traffic section asks
    for.

    Args:
        spec: a ``CoexecSpec`` with ``traffic.arrival != "closed"``.
        capacity_items_s: modeled serving capacity in work-items/s, used
            to turn ``traffic.load`` into an arrival rate when
            ``traffic.rate`` is 0.

    Returns:
        A :class:`repro_torch.core.Trace`.
    """
    from ..core import Trace, synthesize_trace

    tr = spec.traffic
    if tr.trace:
        return Trace.load(tr.trace)
    items = spec.workload.items
    rate = tr.rate if tr.rate > 0 else tr.load * capacity_items_s / items
    return synthesize_trace(
        tr.arrivals, rate, arrival=tr.arrival,
        tenants=spec.workload.tenants or 8, items=items,
        item_jitter=tr.item_jitter, slo_ms=spec.admission.slo_ms,
        burst=tr.burst, burst_duty=tr.burst_duty, seed=tr.seed)


def traffic_rows(spec=None, *, loads=None, admissions=None,
                 arrival_kinds=None, tenants=None) -> list[dict]:
    """Open-loop SLO sweep on the DES: one aggregate row per (arrival
    process, load multiple, admission mode) with admitted-launch
    p50/p99 latency, deadline-miss rate, shed fraction and fusion
    counters. Sweep axes default to the single point the spec describes;
    pass tuples to sweep. Serves ``serve --coexec sim --arrival ...``.

    Each admission mode is a dict of ``AdmissionSpec.replace`` overrides
    (e.g. ``{"policy": "edf", "preempt": True, "shed": True}``); a
    string is shorthand for ``{"policy": <string>}``.
    """
    from ..core import capacity_items_per_s, paper_workload, replay_trace_sim

    if spec is None:
        spec = default_serve_spec()
    _, cpu, gpu = paper_workload(spec.workload.name)
    units = [cpu, gpu]
    cap = capacity_items_per_s(units)
    if loads is None:
        loads = (spec.traffic.load,)
    if admissions is None:
        admissions = ({},)
    if arrival_kinds is None:
        arrival_kinds = (spec.traffic.arrival
                         if spec.traffic.arrival != "closed" else "poisson",)
    if tenants is None:
        tenants = spec.workload.tenants or 8
    rows = []
    for arrival in arrival_kinds:
        for load in loads:
            tspec = spec.replace(
                traffic=spec.traffic.replace(arrival=arrival, load=load),
                workload=spec.workload.replace(tenants=tenants))
            trace = trace_from_spec(tspec, cap)
            # a file trace describes itself; the spec's synthesis knobs
            # didn't shape it
            row_arrival = arrival
            row_tenants = tenants
            if tspec.traffic.trace:
                row_arrival = str(trace.meta.get("arrival", "trace"))
                row_tenants = len(trace.tenants())
            for mode in admissions:
                if isinstance(mode, str):
                    mode = {"policy": mode}
                adm = tspec.admission.replace(**mode)
                rep = replay_trace_sim(trace, units,
                                       admission=adm.to_config())
                r = rep.result
                rows.append(dict(
                    workload=spec.workload.name, arrival=row_arrival,
                    tenants=row_tenants, load=float(load),
                    admission=adm.policy, preempt=adm.preempt,
                    shed=adm.shed, slo_ms=adm.slo_ms,
                    arrivals=len(trace),
                    admitted=len(r.launches), shed_count=len(r.shed),
                    p50_ms=rep.p50_ms(), p99_ms=rep.p99_ms(),
                    miss_rate=rep.miss_rate(),
                    shed_fraction=rep.shed_fraction(),
                    packages=r.dispatched_packages,
                    fused_batches=r.fused_batches,
                    total_ms=1e3 * r.total_s))
    return rows


def cluster_pool_units(spec, n: int) -> list:
    """Provision ``n`` simulated pool units from the workload's pair.

    The paper's calibrated CPU/GPU units are cloned round-robin across
    the pool slots, so an elastic pool keeps the heterogeneous speed mix
    the profiles were calibrated against.
    """
    from ..core import SimUnit, paper_workload

    _, cpu, gpu = paper_workload(spec.workload.name)
    pair = (cpu, gpu)
    return [SimUnit(f"{pair[i % 2].name}{i}", pair[i % 2].kind,
                    speed=pair[i % 2].speed, alpha=pair[i % 2].alpha,
                    setup_s=pair[i % 2].setup_s) for i in range(n)]


def cluster_rows(spec=None, *, plans=None) -> list[dict]:
    """Elastic-cluster serve on the DES: one audit row per failure plan.

    Replays the spec's open-loop trace through
    :func:`repro_torch.core.replay_trace_cluster` — the runtime-resizable pool
    with exact package re-issue — and reports the exact-once audit
    (``lost``/``duplicated`` must be 0) next to the latency percentiles.
    ``plans`` maps row names to :class:`repro_torch.core.FailurePlan` objects
    (``None`` plans run undisturbed); it defaults to the single plan the
    spec's ``cluster.failure_plan`` names, or an undisturbed run. Serves
    ``serve --coexec sim --cluster``.
    """
    import dataclasses

    from ..core import capacity_items_per_s, replay_trace_cluster

    if spec is None:
        spec = default_serve_spec()
    if spec.traffic.arrival == "closed" and not spec.traffic.trace:
        # The cluster tier replays an open-loop trace; a closed-loop
        # spec (the CLI default) has none, so fall back to poisson
        # arrivals instead of rejecting the run.
        spec = dataclasses.replace(
            spec, traffic=dataclasses.replace(spec.traffic,
                                              arrival="poisson"))
    cl = spec.cluster
    n = cl.max_units if cl.max_units is not None else max(cl.min_units, 4)
    units = cluster_pool_units(spec, n)
    active = units[:cl.min_units]
    trace = trace_from_spec(spec, capacity_items_per_s(active))
    if plans is None:
        plans = {"plan" if cl.failure_plan else "undisturbed":
                 cl.load_plan()}
    rows = []
    for name, plan in plans.items():
        rep = replay_trace_cluster(
            trace, units, spec=spec, plan=plan,
            min_units=cl.min_units, autoscale=cl.autoscale,
            autoscale_opts=cl.autoscaler_opts(),
            granularity=spec.scheduler.granularity)
        rows.append(dict(
            name=name, workload=spec.workload.name,
            arrival=spec.traffic.arrival, admission=spec.admission.policy,
            min_units=rep.min_units, max_units=rep.max_units,
            autoscale=cl.autoscale, arrivals=rep.arrivals,
            admitted=rep.admitted, shed_count=rep.shed_count,
            completed=rep.completed, lost=rep.lost,
            duplicated=rep.duplicated, reissued=rep.reissued,
            kills=len(rep.kills), joins=len(rep.joins),
            resizes=len(rep.scale_events),
            p50_ms=rep.p50_ms(), p99_ms=rep.p99_ms()))
    return rows


def serve_coexec_cluster(spec) -> list[dict]:
    """Elastic-cluster serve: audit + latency row per failure plan."""
    rows = cluster_rows(spec)
    for row in rows:
        print(f"[serve/cluster] {row['workload']}/{row['arrival']}"
              f"/{row['admission']} pool={row['min_units']}.."
              f"{row['max_units']}"
              f"{'+autoscale' if row['autoscale'] else ''} "
              f"({row['name']}): {row['admitted']}/{row['arrivals']} "
              f"admitted, {row['completed']} completed, "
              f"lost={row['lost']} dup={row['duplicated']} "
              f"reissued={row['reissued']} kills={row['kills']} "
              f"joins={row['joins']} resizes={row['resizes']}, "
              f"p50={row['p50_ms']:.2f}ms p99={row['p99_ms']:.2f}ms")
    return rows


def traffic_tenant_rows(spec=None) -> list[dict]:
    """Per-tenant serving outcome of the spec's open-loop replay: one row
    per tenant with arrivals/admitted/shed counts, p50/p99 admitted
    latency and deadline-miss rate — the serve columns the SLO work
    surfaces.
    """
    from ..core import capacity_items_per_s, paper_workload, replay_trace_sim

    if spec is None:
        spec = default_serve_spec()
    _, cpu, gpu = paper_workload(spec.workload.name)
    units = [cpu, gpu]
    trace = trace_from_spec(spec, capacity_items_per_s(units))
    rep = replay_trace_sim(trace, units, spec=spec)
    return [dict(tenant=t.tenant, arrivals=t.arrivals, admitted=t.admitted,
                 shed=t.shed, p50_ms=t.p50_ms, p99_ms=t.p99_ms,
                 miss_rate=t.miss_rate) for t in rep.rows]


def serve_coexec_traffic(spec) -> list[dict]:
    """Open-loop serve: aggregate row plus per-tenant p50/p99/miss/shed."""
    rows = traffic_rows(spec)
    for row in rows:
        print(f"[serve/traffic] {row['workload']}/{row['arrival']}"
              f"/{row['tenants']}t load={row['load']:.2f} "
              f"{row['admission']}"
              f"{'+preempt' if row['preempt'] else ''}"
              f"{'+shed' if row['shed'] else ''}: "
              f"{row['admitted']}/{row['arrivals']} admitted "
              f"(shed {row['shed_count']}), "
              f"p50={row['p50_ms']:.2f}ms p99={row['p99_ms']:.2f}ms "
              f"miss={row['miss_rate']:.3f}")
    for row in traffic_tenant_rows(spec):
        print(f"[serve/traffic]   {row['tenant']:>8s}: "
              f"arrivals={row['arrivals']:4d} admitted={row['admitted']:4d} "
              f"shed={row['shed']:3d} p50={row['p50_ms']:8.2f}ms "
              f"p99={row['p99_ms']:8.2f}ms miss={row['miss_rate']:.3f}")
    return rows


def serve_coexec_real(spec, *, units=None, on_result=None) -> list[dict]:
    """Real serve on the engine: one row per policy (wall-clock times).

    Prints the reference's columns plus the shares in force (``dist``),
    each unit's idle share and the host overhead share of the timed
    window.
    """
    rows = coexec_real_rows(spec, units=units, on_result=on_result)
    for row in rows:
        print(f"[serve/coexec] {row['kernel']}[{row['impl']}]"
              f"/{row['policy']:13s} "
              f"({spec.admission.policy}"
              f"{'+fuse' if spec.admission.fuse else ''}"
              f"{'+preempt' if spec.admission.preempt else ''}"
              f"/{row['memory']}): {row['requests']} "
              f"requests ({row['concurrent']} in flight) in "
              f"{row['seconds']:.3f}s = {row['req_per_s']:6.1f} req/s, "
              f"{row['items_per_s'] / 1e6:7.2f} "
              f"Mitems/s, {row['packages']} packages, "
              f"copies h2d={row['h2d_copies']} d2h={row['d2h_copies']}, "
              f"fairness={row['fairness']:.3f} "
              f"curve={row['fairness_curve_mean']:.3f}, "
              f"p50={row['p50_ms']:.1f}ms p99={row['p99_ms']:.1f}ms, "
              f"dist={','.join(f'{d:.6g}' for d in row['dist'])} "
              f"device_idle={row['device_idle_frac']:.3f} ("
              f"{' '.join(f'{k}={v:.3f}' for k, v in row['unit_idle_frac'].items())}"
              f") host_overhead={row['host_overhead_frac']:.3f}")
    return rows


def serve_coexec_sim(spec) -> list[dict]:
    """DES serve (virtual time): cluster, traffic, multi-tenant or sweep."""
    if spec.cluster.enabled:
        return serve_coexec_cluster(spec)
    if spec.traffic.arrival != "closed" or spec.traffic.trace:
        return serve_coexec_traffic(spec)
    multi = (spec.admission.policy != "fifo" or spec.admission.fuse
             or spec.workload.tenants is not None)
    if multi:
        rows = coexec_multi_rows(spec, policies=_sweep_policies(spec))
        for row in rows:
            print(f"[serve/coexec-multi] {row['workload']}"
                  f"/{row['policy']}/{row['tenants']}t/{row['admission']}"
                  f"{'+fuse' if row['fuse'] else ''}"
                  f"{'+preempt' if row['preempt'] else ''}: "
                  f"p50={row['p50_ms']:.2f}ms p99={row['p99_ms']:.2f}ms "
                  f"fairness={row['fairness']:.3f} "
                  f"curve={row['fairness_curve_mean']:.3f} "
                  f"packages={row['packages']} "
                  f"(fused_batches={row['fused_batches']})")
        return rows
    rows = coexec_sim_rows(spec)
    for row in rows:
        print(f"[serve/coexec-sim] {row['workload']}/{row['policy']:13s}: "
              f"{row['seconds']:7.3f}s, {row['packages']:4d} packages, "
              f"balance={row['balance']:.2f}, steals={row['steals']}")
    return rows


def build_parser() -> argparse.ArgumentParser:
    """The serve CLI parser: LM flags + spec-derived co-execution flags.

    Returns:
        A parser whose co-execution flags are generated from the
        ``CoexecSpec`` fields by :func:`repro_torch.api.cli.add_spec_args`
        — adding a spec field adds a serve flag with no edit here.
    """
    from ..api import add_spec_args

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda:0",
                    help="LM mode: cuda:0 (default) or cpu")
    ap.add_argument("--coexec", choices=["off", "real", "sim"],
                    default="off",
                    help="serve co-execution kernel requests instead of LM "
                         "decode: 'real' uses the persistent CoexecEngine "
                         "on [cuda:0, cpu], 'sim' the discrete-event "
                         "simulator")
    ap.add_argument("--spec-json", action="store_true",
                    help="print the resolved CoexecSpec as JSON and exit")
    ap.add_argument("--list", action="store_true",
                    help="print registered schedulers, workloads and "
                         "kernels (with their option fields) and exit")
    add_spec_args(ap)
    return ap


def main(argv=None, *, on_result=None):
    """Run the serve CLI.

    Args:
        argv: command-line arguments (default ``sys.argv[1:]``).
        on_result: ``--coexec real`` only: a ``(policy, request, inputs,
            output)`` callback per served request (see
            :func:`coexec_real_rows`).

    Returns:
        The printed rows of a co-execution mode (``None`` otherwise).
    """
    from ..api import registry_listing, spec_from_args

    ap = build_parser()
    args = ap.parse_args(argv)
    if args.list:
        print(registry_listing())
        return None
    try:
        spec = spec_from_args(args, base=default_serve_spec()).validate()
    except (KeyError, ValueError) as e:
        ap.error(str(e))

    if args.spec_json:
        print(spec.to_json(indent=2))
        return None
    if args.coexec == "real":
        try:
            units = spec.build_units()
        except RuntimeError as e:       # no CUDA: no quiet CPU-only pool
            ap.error(str(e))
        return serve_coexec_real(spec, units=units, on_result=on_result)
    if args.coexec == "sim":
        return serve_coexec_sim(spec)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error(f"{device} is not available; pass --device cpu")
    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen, device)
    out = serve_lm(model, params, requests=spec.workload.requests,
                   batch=args.batch, prompt_len=args.prompt_len,
                   max_tokens=args.max_tokens, device=device)
    print(f"[serve] {out['requests']} requests, {out['tokens']} tokens in "
          f"{out['seconds']:.2f}s ({out['tokens'] / out['seconds']:.0f} "
          f"tok/s) on {device}")
    return None


if __name__ == "__main__":
    main()
