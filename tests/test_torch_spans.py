"""A launch's spans outside its packages, on the CPU.

Every launch of the port's engine carries, in ``LaunchStats.spans``, its
``plan`` (scheduler, output, data-plane plan and pre-warm), ``admit``
(the engine lock and any wait for capacity) and ``settle`` (the release
of its plan before its future is set), each keyed by its ``launch_id``;
``LaunchStats.timeline()`` adds the root ``launch``, ``queue`` and each
package's ``stage``, ``compute`` and ``collect``. Held here on a
``["cpu", "cpu"]`` runtime under USM and under BUFFERS: the tree is
whole, nested and ordered, lies inside the caller's own clock readings
around the call, and stays per launch under concurrency, fusion and
shedding. The simulator records no spans, and the control plane still
reads no clock.
"""
import pathlib
import sys
import threading
import time

import pytest

from repro_torch.api import CoexecSpec, build_kernel, kernel_demo_inputs
from repro_torch.core import (CoexecEngine, CoexecutorRuntime, LaunchShed,
                              LaunchStats, Package, Range, Span,
                              counits_from_devices)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MEMORIES = ("usm", "buffers")
OUTSIDE = ("plan", "admit", "settle")
PHASES = ("stage", "compute", "collect")


def runtime(memory: str, policy: str = "dynamic") -> CoexecutorRuntime:
    spec = (CoexecSpec.builder().policy(policy)
            .units(count=2, kinds=("cpu", "cpu"), speed_hints=(0.5, 0.5))
            .dist(0.5).memory(memory).build())
    return CoexecutorRuntime.from_spec(
        spec, units=counits_from_devices(["cpu", "cpu"]))


def names(timeline) -> list:
    return [s.name for s in timeline]


def assert_whole(stats, launch_id, lo, hi):
    """The tree of one finished launch, between the caller's clock
    readings ``lo`` and ``hi``."""
    tl = stats.timeline()
    assert stats.launch_id == launch_id
    root = tl[0]
    assert (root.name, root.parent) == ("launch", None)
    for name in OUTSIDE + ("queue",):
        assert names(tl).count(name) == 1, (name, names(tl))
    for name in PHASES:
        assert names(tl).count(name) == len(stats.packages), name
    by = {s.name: s for s in tl}
    for s in tl:
        assert s.launch == launch_id
        assert lo <= s.start <= s.end <= hi, s
        assert root.start <= s.start and s.end <= root.end, s
        if s is not root:
            assert s.parent == "launch"
    # plan, admit, queue, the packages, settle: one after another
    assert by["plan"].end <= by["admit"].start
    assert by["admit"].end <= by["queue"].start
    assert by["queue"].end == min(p.t_issue for p in stats.packages)
    assert max(p.t_collected for p in stats.packages) <= by["settle"].start
    assert by["settle"].end == root.end and by["plan"].start == root.start
    for p in stats.packages:
        assert p.t_issue <= p.t_launch <= p.t_complete <= p.t_collected
    # CPU units map nothing: no wait for the lock over mapped ranges
    for name in ("plan", "settle"):
        assert by[name].count("lock_wait_s", None) is None
    # starts in order after the root
    assert [s.start for s in tl[1:]] == sorted(s.start for s in tl[1:])
    return by


@pytest.mark.parametrize("memory", MEMORIES)
def test_every_launch_has_its_whole_tree(memory):
    kernel = build_kernel("taylor")
    with runtime(memory) as rt:
        for seed in range(3):
            x = kernel_demo_inputs("taylor", 4096, seed=seed)
            lo = time.perf_counter()
            h = rt.launch_async(4096, kernel, x)
            h.result(timeout=60)
            hi = time.perf_counter()
            by = assert_whole(h.stats, h.launch_id, lo, hi)
            # a worker settles a launch whose packages ran on units
            assert by["settle"].unit in (0, 1)
            assert by["plan"].unit is None and by["admit"].unit is None


@pytest.mark.parametrize("memory", MEMORIES)
def test_the_package_phases_are_the_package_stamps(memory):
    kernel = build_kernel("matmul")
    x = kernel_demo_inputs("matmul", 256, seed=1)
    with runtime(memory) as rt:
        h = rt.launch_async(256, kernel, x)
        h.result(timeout=60)
    tl = h.stats.timeline()
    stamps = sorted((name, p.unit, s, e) for p in h.stats.packages
                    for name, s, e in (("stage", p.t_issue, p.t_launch),
                                       ("compute", p.t_launch, p.t_complete),
                                       ("collect", p.t_complete,
                                        p.t_collected)))
    got = sorted((s.name, s.unit, s.start, s.end) for s in tl
                 if s.name in PHASES)
    assert got == stamps
    # the recorded spans are the only ones kept on the stats
    assert sorted(s.name for s in h.stats.spans) == sorted(OUTSIDE)


@pytest.mark.parametrize("memory", MEMORIES)
def test_concurrent_launches_keep_their_own_ids(memory):
    kernel = build_kernel("mandelbrot")
    with runtime(memory) as rt:
        lo = time.perf_counter()
        handles = [rt.launch_async(
            20_000, kernel, kernel_demo_inputs("mandelbrot", 20_000,
                                               seed=s)) for s in range(4)]
        for h in handles:
            h.result(timeout=60)
        hi = time.perf_counter()
    ids = [h.launch_id for h in handles]
    assert len(set(ids)) == len(ids)
    for h in handles:
        assert_whole(h.stats, h.launch_id, lo, hi)


@pytest.mark.parametrize("memory", MEMORIES)
def test_launches_from_two_threads_keep_their_own_ids(memory):
    kernel = build_kernel("taylor")
    got = {}
    with runtime(memory) as rt:
        def client(c):
            for s in range(3):
                x = kernel_demo_inputs("taylor", 8192, seed=10 * c + s)
                lo = time.perf_counter()
                h = rt.launch_async(8192, kernel, x)
                h.result(timeout=60)
                got.setdefault(c, []).append((h, lo, time.perf_counter()))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    runs = [r for rs in got.values() for r in rs]
    assert len(runs) == 6
    assert len({h.launch_id for h, _, _ in runs}) == 6
    for h, lo, hi in runs:
        assert_whole(h.stats, h.launch_id, lo, hi)


@pytest.mark.timeout(120)
def test_first_launches_from_many_threads_start_one_engine():
    """Twelve threads make a fresh runtime's first launch at once, with
    the interpreter switching threads every microsecond: one engine
    serves them all, so no two launches share an id."""
    kernel = build_kernel("taylor")
    x = kernel_demo_inputs("taylor", 64, seed=0)
    handles, go = [], threading.Barrier(12)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with runtime("usm") as rt:
            def client():
                go.wait(timeout=30)
                handles.append(rt.launch_async(64, kernel, x))

            threads = [threading.Thread(target=client) for _ in range(12)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
            for h in handles:
                h.result(timeout=60)
            engine = rt.engine
    finally:
        sys.setswitchinterval(switch)
    assert len(handles) == 12
    assert len({h.launch_id for h in handles}) == 12
    assert engine.loop.next_id() == 12      # every id from one engine


@pytest.mark.parametrize("memory", MEMORIES)
def test_fused_members_carry_their_own_plan_and_admit(memory):
    spec = (CoexecSpec.builder().policy("dynamic")
            .units(count=2, kinds=("cpu", "cpu"), speed_hints=(0.5, 0.5))
            .memory(memory).fuse(True, threshold=4096, limit=4, wait_s=30.0)
            .build())
    kernel = build_kernel("taylor")
    units = counits_from_devices(["cpu", "cpu"])
    lo = time.perf_counter()
    with CoexecEngine.from_spec(spec, units=units) as engine:
        handles = []
        for i in range(4):
            x = kernel_demo_inputs("taylor", 256, seed=i)
            handles.append(engine.submit(spec.build_scheduler(256, 2),
                                         kernel, x,
                                         kernel.alloc_out(256, x)))
        for h in handles:
            h.result(timeout=60)
        assert engine.admission.fused_members == 4
    hi = time.perf_counter()
    for h in handles:
        by = assert_whole(h.stats, h.launch_id, lo, hi)
        plan = [s for s in h.stats.spans if s.name == "plan"]
        admit = [s for s in h.stats.spans if s.name == "admit"]
        assert len(plan) == len(admit) == 1
        assert plan[0].launch == admit[0].launch == h.launch_id
        assert by["settle"].launch == h.launch_id
    # each member planned in its own submit: four distinct plan spans
    assert len({[s for s in h.stats.spans if s.name == "plan"][0]
                for h in handles}) == 4


@pytest.mark.timeout(120)
@pytest.mark.parametrize("memory", MEMORIES)
def test_a_shed_launch_neither_hangs_nor_takes_spans(memory):
    spec = (CoexecSpec.builder().policy("dynamic")
            .units(count=2, kinds=("cpu", "cpu"), speed_hints=(0.5, 0.5))
            .memory(memory).build())
    spec = spec.replace(admission=spec.admission.replace(
        shed=True, shed_rate=1000.0, shed_budget=0.5, slo_ms=50.0))
    kernel = build_kernel("taylor")
    units = counits_from_devices(["cpu", "cpu"])
    with CoexecEngine.from_spec(spec, units=units) as engine:
        lo = time.perf_counter()
        handles = []
        for i in range(2):
            x = kernel_demo_inputs("taylor", 40, seed=i)
            handles.append(engine.submit(spec.build_scheduler(40, 2), kernel,
                                         x, kernel.alloc_out(40, x)))
        first, shed = handles
        t0 = time.perf_counter()
        assert isinstance(shed.exception(timeout=10), LaunchShed)
        assert time.perf_counter() - t0 < 1.0     # resolved at submit
        assert shed.stats is None
        first.result(timeout=60)
        hi = time.perf_counter()
    assert_whole(first.stats, first.launch_id, lo, hi)


def test_the_simulator_records_no_spans():
    from repro_torch.core import (AdmissionConfig, MemoryCosts, MemoryModel,
                                  SimUnit, Workload)
    from repro_torch.core.scheduler import DynamicScheduler
    from repro_torch.core.sim import _run_sim, _SimLaunchState

    units = [SimUnit("u0", "cpu", speed=100.0), SimUnit("u1", "gpu",
                                                        speed=300.0)]
    entries = [_SimLaunchState(i, DynamicScheduler(64, 2, num_packages=8),
                               Workload(f"w{i}", 64, 8.0, 8.0, 1e4),
                               tenant=f"t{i}") for i in range(2)]
    _run_sim(entries, units, AdmissionConfig(), MemoryModel.USM,
             MemoryCosts(), True)
    for e in entries:
        assert e.stats.spans == []
        assert e.stats.launch_id == e.id
        tl = e.stats.timeline()
        assert names(tl)[0] == "launch"
        assert "plan" not in names(tl) and "settle" not in names(tl)
        assert names(tl).count("compute") == len(e.stats.packages)


def test_a_span_reads_its_length_and_counts():
    s = Span("plan", 3, "launch", 1.0, 1.25, counts=(("lock_wait_s", 0.1),))
    assert s.seconds == 0.25
    assert s.count("lock_wait_s") == 0.1
    assert s.count("missing") == 0.0
    with pytest.raises(AttributeError):
        s.end = 2.0                                # frozen


@pytest.mark.parametrize("name", ["taylor", "gaussian", "matmul",
                                  "mandelbrot", "ray", "rap"])
def test_a_usm_launch_on_cpu_units_copies_nothing(name):
    """CPU units read a USM launch's arrays in place: no span carries
    ``usm_copy_bytes`` and no staging copy is counted."""
    kernel = build_kernel(name)
    with runtime("usm") as rt:
        h = rt.launch_async(1024, kernel,
                            kernel_demo_inputs(name, 1024, seed=4))
        h.result(timeout=60)
    assert all(s.count("usm_copy_bytes", None) is None
               for s in h.stats.timeline())
    assert all(p.stage_counts == () for p in h.stats.packages)
    data = h.stats.data
    assert (data.h2d_copies, data.h2d_bytes, data.d2h_copies,
            data.d2h_bytes) == (0, 0, 0, 0)
    assert data.dispatches == h.stats.num_packages


def test_a_stage_span_carries_its_package_counts():
    pkg = Package(Range(0, 8), seq=0, unit=0, t_issue=1.0, t_launch=1.5,
                  t_complete=2.0, t_collected=2.5,
                  stage_counts=(("usm_copy_bytes", 96),))
    stats = LaunchStats(total_s=1.5, packages=[pkg], unit_busy_s={},
                        launch_id=7)
    stage, = [s for s in stats.timeline() if s.name == "stage"]
    assert (stage.start, stage.end) == (1.0, 1.5)
    assert stage.count("usm_copy_bytes") == 96
    compute, = [s for s in stats.timeline() if s.name == "compute"]
    assert compute.counts == ()


def test_the_control_plane_still_reads_no_clock():
    from repro_torch.analysis.core import load_source
    from repro_torch.analysis.determinism import check_determinism

    path = ROOT / "src" / "repro_torch" / "core" / "exec.py"
    findings = check_determinism(load_source(path))
    assert [f for f in findings if f.rule == "det-wall-clock"] == []
    assert findings == []
