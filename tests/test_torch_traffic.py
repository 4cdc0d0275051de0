"""The port's open-loop traffic tier against the reference's, exactly.

* Trace synthesis (poisson and burst) gives the same arrivals, and the
  committed ``benchmarks/traces/example_trace.json`` loads and
  round-trips to the same JSON in both packages.
* ``replay_trace_sim`` gives the same decision log, shed set, admitted
  p50/p99 and per-tenant rows (virtual seconds of the paper testbed).
* The lockstep replay drives the port's thread-free ``RealBackend`` over
  two ``cpu`` units with the taylor kernel and the reference's DES with
  the same trace and config: the accept/shed log, the fusion groups and
  the fused batch count must be identical for {fifo, wfq, edf} x
  {preempt} x {fuse} at pipeline depth 1 and 2 (the matrix of
  ``tests/test_traffic.py``), and every admitted launch's output equals
  the plain version bit for bit.
"""
import pathlib

import numpy as np
import pytest
import torch

import repro.core.sim as ref_sim_module
from repro.api import build_scheduler as ref_build_scheduler
from repro.core import AdmissionConfig as RefConfig
from repro.core import ExecutionLoop as RefLoop
from repro.core import MemoryModel as RefMemory
from repro.core import SimUnit as RefSimUnit
from repro.core import Trace as RefTrace
from repro.core import Workload as RefWorkload
from repro.core import fusion_bucket as ref_fusion_bucket
from repro.core import replay_trace_lockstep as ref_replay_trace_lockstep
from repro.core import replay_trace_sim as ref_replay_trace_sim
from repro.core import synthesize_trace as ref_synthesize_trace
from repro.core.memory import MemoryCosts as RefCosts
from repro.core.sim import SimBackend as RefSimBackend
from repro.core.sim import _SimLaunchState as RefSimLaunch
from repro_torch.api import build_kernel, build_scheduler
from repro_torch.core import (AdmissionConfig, ExecutionLoop, MemoryModel,
                              SimUnit, Trace, counits_from_devices,
                              fusion_bucket, make_plane,
                              replay_trace_lockstep, replay_trace_sim,
                              synthesize_trace, tenant_rows)
from repro_torch.core.engine import RealBackend, _Launch, _fuse_key
from repro_torch.kernels import taylor_sin_plain

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLE = REPO / "benchmarks" / "traces" / "example_trace.json"
NUNITS = 2


@pytest.fixture(autouse=True)
def reference_prefix_cache_holds_its_workloads(monkeypatch):
    """Run the reference's DES with a cost-prefix cache that holds each
    workload, as the port's does. The reference keys the cache by id()
    alone (ROADMAP queue 3): a fused batch's workload freed after its
    launch lets a later one reuse the id and read a stale prefix, which
    fails or skews a fused replay now and then. The arithmetic is the
    reference's own ``_item_costs``."""
    def prefix_for(self, wl, u):
        key = (id(wl), u.name)
        if key not in self._prefix:
            self._prefix[key] = (wl, ref_sim_module._item_costs(wl, u))
        return self._prefix[key][1]

    monkeypatch.setattr(ref_sim_module.SimBackend, "_prefix_for",
                        prefix_for)


def sim_units(cls, speed):
    return [cls(f"u{i}", "cpu", speed=speed, setup_s=1e-3)
            for i in range(NUNITS)]


def rows_of(rows) -> list:
    return [(r.tenant, r.arrivals, r.admitted, r.shed, r.p50_ms, r.p99_ms,
             r.miss_rate) for r in rows]


@pytest.mark.parametrize("arrival", ["poisson", "burst"])
def test_synthesized_traces_equal_reference(arrival):
    kw = dict(arrival=arrival, tenants=5, mix=[3, 1, 1, 2, 1],
              tenant_weights=[1, 2, 1, 1, 3], items=300, item_jitter=0.7,
              slo_ms=30.0, seed=11)
    got = synthesize_trace(200, 90.0, **kw)
    want = ref_synthesize_trace(200, 90.0, **kw)
    assert got.to_json() == want.to_json()
    assert got.tenants() == want.tenants()
    assert got.offered_rate() == want.offered_rate()
    assert got.scaled(2.0).to_json() == want.scaled(2.0).to_json()


def test_committed_trace_loads_and_round_trips(tmp_path):
    before = EXAMPLE.read_bytes()
    got, want = Trace.load(EXAMPLE), RefTrace.load(EXAMPLE)
    assert len(got) == 64 and got.to_json() == want.to_json()
    assert Trace.from_json(got.to_json()) == got
    path = tmp_path / "t.json"
    got.save(path)
    assert Trace.load(path) == got
    assert RefTrace.load(path).to_json() == want.to_json()
    assert EXAMPLE.read_bytes() == before       # read, never written
    with pytest.raises(ValueError):
        Trace.from_dict({"version": 99, "arrivals": []})


@pytest.mark.parametrize("policy,preempt,shed", [
    ("fifo", False, False), ("wfq", True, False), ("edf", True, True)])
def test_replay_trace_sim_equals_reference(policy, preempt, shed):
    kw = dict(tenants=6, items=256, item_jitter=0.5, slo_ms=40.0, seed=9)
    trace = synthesize_trace(300, 30.0, **kw)
    ref_trace = ref_synthesize_trace(300, 30.0, **kw)
    cfg = dict(policy=policy, preempt=preempt, shed=shed, shed_budget=0.5,
               slo_ms=40.0, fuse=True, fuse_buckets=True,
               fuse_threshold=512)
    got = replay_trace_sim(trace, sim_units(SimUnit, 5000.0),
                           admission=AdmissionConfig(**cfg))
    want = ref_replay_trace_sim(ref_trace, sim_units(RefSimUnit, 5000.0),
                                admission=RefConfig(**cfg))
    assert got.decisions == want.decisions
    assert got.fusion_groups == want.fusion_groups
    assert [(s.tenant, s.t_submit, s.items, s.deadline)
            for s in got.result.shed] == \
        [(s.tenant, s.t_submit, s.items, s.deadline)
         for s in want.result.shed]
    assert (got.p50_ms(), got.p99_ms(), got.miss_rate(),
            got.shed_fraction()) == \
        (want.p50_ms(), want.p99_ms(), want.miss_rate(),
         want.shed_fraction())
    assert got.admitted_latencies_ms() == want.admitted_latencies_ms()
    assert rows_of(got.rows) == rows_of(want.rows)
    assert rows_of(tenant_rows(trace, got.result)) == rows_of(want.rows)
    if shed:
        assert got.result.shed


def test_committed_trace_replays_like_the_reference():
    cfg = dict(policy="edf", preempt=True, shed=True, shed_budget=0.5,
               slo_ms=40.0)
    got = replay_trace_sim(Trace.load(EXAMPLE), sim_units(SimUnit, 5000.0),
                           admission=AdmissionConfig(**cfg))
    want = ref_replay_trace_sim(RefTrace.load(EXAMPLE),
                                sim_units(RefSimUnit, 5000.0),
                                admission=RefConfig(**cfg))
    assert len(got.decisions) == 64
    assert got.decisions == want.decisions
    assert rows_of(got.rows) == rows_of(want.rows)


# -- lockstep: the port's real backend against the reference's DES ---------

def lockstep_cfg(cls, policy, preempt, fuse):
    # fuse_wait_s > 0 keeps staged fusion groups open across the serve
    # sweeps instead of ripening as singletons
    return cls(policy=policy, preempt=preempt, fuse=fuse, fuse_buckets=fuse,
               fuse_threshold=1024, fuse_wait_s=0.1, shed=True,
               shed_rate=2000.0, shed_budget=0.5, slo_ms=50.0)


def lockstep_trace(make):
    # ~2x the shed estimator's 2000 items/s: a real mix of accepts and
    # sheds, with jitter so bucketing actually buckets
    return make(24, 40.0, tenants=4, items=96, item_jitter=0.8,
                slo_ms=50.0, seed=3)


def run_port_real(trace, cfg):
    units = counits_from_devices(["cpu"] * NUNITS, speed_hints=[0.5, 0.5])
    backend = RealBackend(units, make_plane(MemoryModel.USM))
    loop = ExecutionLoop(backend, [u.name for u in units], cfg)
    kernel = build_kernel("taylor")
    datas = {}

    def make_launch(a, lp):
        sched = build_scheduler("dyn8", a.items, NUNITS)
        x = np.random.default_rng(a.items).uniform(
            -2, 2, a.items).astype(np.float32)
        out = np.zeros(a.items, np.float32)
        launch = _Launch(lp.next_id(), sched, kernel, [x], out,
                         adaptive=False)
        launch.plan = backend.plane.plan(kernel, [x], out, a.items)
        launch.tenant, launch.weight = a.tenant, a.weight
        launch.fuse_key = _fuse_key(cfg, sched, kernel, [x], out)
        if launch.fuse_key is not None and cfg.fuse_buckets:
            launch.fuse_bucket = fusion_bucket(a.items)
        datas[launch.id] = x
        return launch

    admitted, shed = replay_trace_lockstep(trace, loop, make_launch)
    return loop, admitted, shed, datas


def run_ref_sim(trace, cfg, depth):
    units = sim_units(RefSimUnit, 1000.0)
    backend = RefSimBackend(units, RefMemory.USM, RefCosts(),
                            pipeline_depth=depth)
    loop = RefLoop(backend, [u.name for u in units], cfg)

    def make_launch(a, lp):
        entry = RefSimLaunch(
            lp.next_id(), ref_build_scheduler("dyn8", a.items, NUNITS),
            RefWorkload("traffic", a.items, 8.0, 8.0, 1e4),
            tenant=a.tenant, weight=a.weight)
        if cfg.fuse and a.items <= cfg.fuse_threshold:
            entry.fuse_key = ("traffic", "bucket",
                              ref_fusion_bucket(a.items), 8.0, 8.0)
            entry.fuse_bucket = ref_fusion_bucket(a.items)
        return entry

    admitted, shed = ref_replay_trace_lockstep(trace, loop, make_launch)
    return loop, admitted, shed


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("preempt", [False, True])
@pytest.mark.parametrize("policy", ["fifo", "wfq", "edf"])
def test_lockstep_port_real_equals_reference_sim(policy, preempt, fuse,
                                                 depth):
    real_loop, real_adm, real_shed, datas = run_port_real(
        lockstep_trace(synthesize_trace),
        lockstep_cfg(AdmissionConfig, policy, preempt, fuse))
    sim_loop, sim_adm, sim_shed = run_ref_sim(
        lockstep_trace(ref_synthesize_trace),
        lockstep_cfg(RefConfig, policy, preempt, fuse), depth)
    assert real_loop.admission.decision_log == \
        sim_loop.admission.decision_log
    assert real_loop.admission.fusion_log == sim_loop.admission.fusion_log
    assert real_loop.admission.fused_batches == \
        sim_loop.admission.fused_batches
    assert len(real_shed) == len(sim_shed) > 0
    assert len(real_adm) == len(sim_adm) > 0
    if fuse:
        assert real_loop.admission.fused_batches > 0
    for launch in real_adm:
        want = taylor_sin_plain(torch.from_numpy(datas[launch.id])).numpy()
        np.testing.assert_array_equal(launch.handle.result(timeout=5), want)
