"""The port's elastic cluster tier against the reference's, exactly.

Each scenario runs once per package on the same inputs, and what the
tier decides must be equal: ``FailurePlan`` JSON (and the committed
``benchmarks/failure_plans/example_plan.json``, which both read as it
stands), the ``Supervisor``'s deaths, shares and straggler flags, the
``UnitPool`` and ``Autoscaler`` resizes, and ``replay_trace_cluster``'s
exact-once audit (``lost``, ``duplicated``, ``reissued``, kills, joins,
resizes, covers, per-launch counters and latencies in virtual seconds).
Then the real-vs-sim cluster lockstep of ``tests/test_cluster.py`` runs
its three event scripts on the port's ``ClusterRealBackend`` over three
``cpu`` units with the taylor kernel: the decision log, the re-issue
count and every launch's cover equal the port's DES and the reference's
DES, and every output equals the plain version bit for bit.
"""
import pathlib

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.cluster as ref_cluster
import repro.core.sim as ref_sim
import repro_torch.core as core
import repro_torch.core.cluster as cluster
import repro_torch.core.sim as sim
from repro_torch.api import build_kernel
from repro_torch.core.engine import RealBackend, _Launch
from repro_torch.kernels import taylor_sin_plain

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLE = REPO / "benchmarks" / "failure_plans" / "example_plan.json"
SIDES = {"ref": (ref_core, ref_cluster, ref_sim),
         "port": (core, cluster, sim)}
NUNITS = 3      # a kill must leave >= 2 survivors
EVENT_SCRIPTS = {
    "kill": [(5, "kill:2")],
    "leave": [(5, "leave:2")],
    "kill+join": [(5, "kill:2"), (14, "join:2")],
}


def sim_units(c, n=NUNITS, speed=50_000.0):
    return [c.SimUnit(f"u{i}", "cpu", speed=speed, setup_s=1e-3)
            for i in range(n)]


def cluster_trace(c, arrivals=24, items=96, seed=3):
    return c.synthesize_trace(arrivals, 40.0, tenants=4, items=items,
                              item_jitter=0.8, slo_ms=50.0, seed=seed)


def bare_loop(side, n=NUNITS):
    c, cl, _ = SIDES[side]
    units = sim_units(c, n)
    backend = cl.ClusterSimBackend(units, c.MemoryModel.USM, c.MemoryCosts())
    return c.ExecutionLoop(backend, [u.name for u in units],
                           c.AdmissionConfig(policy="wfq", slo_ms=50.0))


def new_entry(side, loop, units=NUNITS):
    c, _, s = SIDES[side]
    return s._SimLaunchState(loop.next_id(),
                             c.DynamicScheduler(64, units, num_packages=8),
                             c.Workload("t", 64, 8.0, 8.0, 1e4))


@pytest.mark.parametrize("side", ["ref", "port"])
def test_failure_plan_json_equals_reference(side, tmp_path):
    plan = SIDES[side][1].FailurePlan(
        events={5: "crash", 9: "kill:B"},
        timeline=((0.05, "kill:1"), (0.2, "join:u2")))
    want = ref_cluster.FailurePlan(
        events={5: "crash", 9: "kill:B"},
        timeline=((0.05, "kill:1"), (0.2, "join:u2")))
    assert plan.to_json() == want.to_json()
    path = tmp_path / "plan.json"
    plan.save(path)
    assert cluster.FailurePlan.load(path) == \
        cluster.FailurePlan.from_json(want.to_json())
    assert ref_cluster.FailurePlan.load(path) == want
    assert cluster.FailurePlan.load(path).check(5) == "crash"


def test_committed_plan_loads_as_the_reference_reads_it():
    before = EXAMPLE.read_bytes()
    got = cluster.FailurePlan.load(EXAMPLE).validate()
    want = ref_cluster.FailurePlan.load(EXAMPLE)
    assert got.to_json() == want.to_json()
    assert any(a.startswith("kill:") for _, a in got.timeline)
    assert EXAMPLE.read_bytes() == before       # read, never written


def test_malformed_plans_and_tokens_raise_as_in_the_reference():
    for bad in ({"version": 99}, {"version": 1, "timeline": [[0.1, "x:1"]]},
                {"version": 1, "timeline": [[-0.1, "kill:1"]]}):
        for cl in (cluster, ref_cluster):
            with pytest.raises(ValueError):
                cl.FailurePlan.from_dict(bad)
    names = ["cpu0", "gpu1", "gpu2"]
    for token in ("1", "gpu2"):
        assert cluster._resolve_unit(token, names) == \
            ref_cluster._resolve_unit(token, names)
    for token in ("7", "nope"):
        with pytest.raises(ValueError):
            cluster._resolve_unit(token, names)


def test_shares_equal_reference():
    def story(cl):
        s = cl.grant_share(cl.grant_share({}, "a", 1.0), "b", 0.25)
        s = cl.grant_share(s, "c", 0.2)
        return s, cl.absorb_share(s, "c"), cl.absorb_share(s, "zzz")

    assert story(cluster) == story(ref_cluster)
    with pytest.raises(ValueError):
        cluster.grant_share({}, "d", 1.5)


def supervisor_story(side):
    _, cl, _ = SIDES[side]
    loop = bare_loop(side)
    flagged = []
    sup = cl.Supervisor(loop, heartbeat_s=0.01, grace_s=0.05,
                        straggler_factor=2.0,
                        on_straggler=lambda u, age: flagged.append((u, age)))
    for u in range(NUNITS):
        sup.register(u, 1.0 + u, t=0.0)
    entry = new_entry(side, loop)
    assert loop.offer(entry, now=0.0)
    assert loop.pull(0, now=0.0) is not None
    sup.note_service(0.01)
    out = [sup.flag_stragglers(0.015), sup.flag_stragglers(0.03)]
    sup.beat(0, 0.04)
    sup.beat(1, 0.04)
    out += [sup.check(0.03), sup.check(0.06), sup.check(0.06),
            sorted(loop.dead_units), dict(sup.shares)]
    sup.join_unit(2, 0.07, speed=2.0)
    out += [dict(sup.shares), sup.kills, sup.joins, sup.stragglers, flagged,
            loop.reissued]
    with pytest.raises(ValueError):
        sup.retire_unit(0)              # unit 0 still holds its package
    return out


def test_supervisor_decisions_equal_reference():
    assert supervisor_story("port") == supervisor_story("ref")


def pool_story(side):
    _, cl, _ = SIDES[side]
    loop = bare_loop(side, n=4)
    pool = cl.UnitPool(loop, min_units=2, speeds=[1.0, 2.0, 3.0, 4.0])
    out = [pool.size, pool.alive, sorted(loop.dead_units), pool.grow(1)]
    assert loop.offer(new_entry(side, loop, 4), now=0.0)
    assert loop.pull(2, now=0.0) is not None
    out += [pool.drain(2), pool.shrink(2), pool.alive, pool.shrink(1)]
    pool2 = cl.UnitPool(bare_loop(side, n=4), min_units=1)
    scaler = cl.Autoscaler(pool2, scale_up_depth=4, scale_down_depth=1,
                           sustain_s=0.1, idle_s=0.2, cooldown_s=0.5)
    for t, depth in ((0.0, 8), (0.05, 8), (0.11, 8), (0.3, 8), (0.7, 8),
                     (0.8, 2), (1.5, 0), (1.72, 0), (2.5, 0), (3.0, 9)):
        out.append((scaler.observe(t, depth), pool2.size))
    out.append(scaler.actions)
    return out


def test_pool_and_autoscaler_decisions_equal_reference():
    assert pool_story("port") == pool_story("ref")


def audit(rep) -> tuple:
    return (rep.min_units, rep.max_units, rep.arrivals, rep.admitted,
            rep.shed_count, rep.completed, rep.lost, rep.duplicated,
            rep.reissued, rep.kills, rep.joins, rep.scale_events,
            rep.latencies_s, rep.covers(), rep.data_totals(), rep.p50_ms(),
            rep.p99_ms())


def replay(side, policy, timeline, autoscale):
    c, _, _ = SIDES[side]
    trace = c.synthesize_trace(60, 40.0, tenants=4, items=4096,
                               item_jitter=0.8, slo_ms=200.0, seed=3)
    units = sim_units(c, n=4, speed=20_000.0)
    plan = c.FailurePlan(timeline=timeline) if timeline else None
    return c.replay_trace_cluster(
        trace, units, admission=policy, plan=plan,
        min_units=2 if autoscale else None, autoscale=autoscale,
        autoscale_opts=dict(scale_up_depth=3, sustain_s=0.02,
                            cooldown_s=0.05) if autoscale else None)


@pytest.mark.parametrize("policy,timeline,autoscale", [
    ("wfq", (), False),
    ("wfq", ((0.2, "kill:3"),), False),
    ("edf", ((0.2, "kill:3"),), False),
    ("fifo", ((0.2, "kill:3"), (0.5, "kill:1"), (0.8, "join:3"),
              (1.0, "join:1")), False),
    ("wfq", ((0.3, "kill:0"),), True),
])
def test_replay_trace_cluster_audit_equals_reference(policy, timeline,
                                                     autoscale):
    got = replay("port", policy, timeline, autoscale)
    want = replay("ref", policy, timeline, autoscale)
    assert audit(got) == audit(want)
    assert got.lost == 0 and got.duplicated == 0
    if timeline:
        assert got.reissued > 0
    if autoscale:
        assert got.scale_events


def test_killing_the_whole_pool_wedges_loudly():
    trace = cluster_trace(core)
    plan = core.FailurePlan(timeline=((0.1, "kill:0"), (0.1, "kill:1")))
    with pytest.raises(RuntimeError, match="wedged"):
        core.replay_trace_cluster(trace, sim_units(core, 2),
                                  admission="wfq", plan=plan)


# -- real-vs-sim cluster lockstep on the port's CPU units ------------------

def run_port_real(trace, cfg, events):
    units = core.counits_from_devices(["cpu"] * NUNITS,
                                      speed_hints=[1.0 / NUNITS] * NUNITS)
    backend = core.ClusterRealBackend(units,
                                      core.make_plane(core.MemoryModel.USM))
    loop = core.ExecutionLoop(backend, [u.name for u in units], cfg)
    backend.loop = loop
    kernel = build_kernel("taylor")
    datas = {}

    def make_launch(a, lp):
        sched = core.DynamicScheduler(a.items, NUNITS, num_packages=8)
        x = np.random.default_rng(a.items).uniform(
            -2, 2, a.items).astype(np.float32)
        out = np.zeros(a.items, np.float32)
        launch = _Launch(lp.next_id(), sched, kernel, [x], out,
                         adaptive=False)
        launch.plan = backend.plane.plan(kernel, [x], out, a.items)
        launch.tenant, launch.weight = a.tenant, a.weight
        datas[launch.id] = x
        return launch

    admitted, shed = core.replay_cluster_lockstep(trace, loop, make_launch,
                                                  events=events)
    return loop, admitted, shed, datas


def run_sim(side, trace, cfg, events, depth):
    c, cl, s = SIDES[side]
    units = sim_units(c, speed=1000.0)
    backend = cl.ClusterSimBackend(units, c.MemoryModel.USM, c.MemoryCosts(),
                                   pipeline_depth=depth)
    loop = c.ExecutionLoop(backend, [u.name for u in units], cfg)

    def make_launch(a, lp):
        return s._SimLaunchState(
            lp.next_id(), c.DynamicScheduler(a.items, NUNITS,
                                             num_packages=8),
            c.Workload("traffic", a.items, 8.0, 8.0, 1e4), tenant=a.tenant,
            weight=a.weight)

    admitted, shed = c.replay_cluster_lockstep(trace, loop, make_launch,
                                               events=events)
    return loop, admitted, shed


def covers(launches) -> dict:
    return {l.id: tuple(sorted((p.offset, p.size) for p in l.stats.packages))
            for l in launches}


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("policy", ["wfq", "edf"])
@pytest.mark.parametrize("script", sorted(EVENT_SCRIPTS))
def test_cluster_lockstep_port_real_equals_sim(script, policy, depth):
    assert core.ClusterRealBackend is RealBackend
    events = EVENT_SCRIPTS[script]
    real_loop, real_adm, real_shed, datas = run_port_real(
        cluster_trace(core),
        core.AdmissionConfig(policy=policy, slo_ms=50.0), events)
    sims = [run_sim(side, cluster_trace(SIDES[side][0]),
                    SIDES[side][0].AdmissionConfig(policy=policy,
                                                   slo_ms=50.0),
                    events, depth) for side in ("port", "ref")]
    for sim_loop, sim_adm, sim_shed in sims:
        assert real_loop.admission.decision_log == \
            sim_loop.admission.decision_log
        assert len(real_adm) == len(sim_adm) > 0
        assert len(real_shed) == len(sim_shed)
        assert real_loop.reissued == sim_loop.reissued
        assert covers(real_adm) == covers(sim_adm)
    if script.startswith("kill"):
        assert real_loop.reissued > 0
    for launch in real_adm:
        core.validate_cover(launch.stats.packages, launch.scheduler.total)
        want = taylor_sin_plain(torch.from_numpy(datas[launch.id])).numpy()
        np.testing.assert_array_equal(launch.handle.result(timeout=5), want)


# -- the engine's kill helper on the port's CPU units ----------------------

@pytest.mark.timeout(60)
def test_kill_unit_when_held_reissues_the_held_package():
    """``kill_unit_when_held`` kills unit 1 while its package runs (the
    package blocks until the kill is seen); unit 0 serves the re-issued
    range and the cover is exact. The handle resolves only once the
    killed unit's zombie package has stopped running too. On a finished
    launch the helper kills none."""
    import threading
    import time

    held, killed = threading.Event(), threading.Event()

    def body(offset, x, *, out):
        worker = threading.current_thread().name   # counit-<unit>-<index>
        if worker.startswith("counit-") and worker.endswith("-1"):
            held.set()
            killed.wait(30)             # held until the kill lands
        elif worker.startswith("counit-"):
            held.wait(30)               # unit 0 cannot drain the launch
        return torch.mul(x, 2.0, out=out)

    kernel = core.CoexecKernel("double", body, (core.ArgSpec("x"),))
    units = core.counits_from_devices(["cpu", "cpu"])
    n = 4096
    x = np.arange(n, dtype=np.float32)
    with core.CoexecEngine(units) as engine:
        handle = engine.submit(core.DynamicScheduler(n, 2, num_packages=16),
                               kernel, [x], np.zeros(n, np.float32))
        moved = engine.kill_unit_when_held(1, handle)
        for _ in range(1000):               # unit 0 finalizes the launch
            with engine._cv:
                if not engine.admission.active_entries():
                    break
            time.sleep(0.01)
        assert not engine.admission.active_entries()
        assert not handle.done()            # the zombie still runs
        killed.set()
        np.testing.assert_array_equal(handle.result(timeout=30), x * 2.0)
        assert moved == 1 and engine.loop.reissued == 1
        assert engine.loop.dead_units == {1}
        core.validate_cover(handle.stats.packages, n)
        assert {p.unit for p in handle.stats.packages} == {0}
        engine.join_unit(1)
        assert engine.kill_unit_when_held(1, handle) is None
        assert engine.loop.dead_units == set()
