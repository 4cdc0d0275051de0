"""The span readers on synthetic stamps and a synthetic device trace:
``plan_ms``, ``settle_ms``, ``map_lock_wait_ms`` and the card's idle time
split by what the program was doing (``harness/idle.py``)."""
from __future__ import annotations

import types

import pytest

from test_bench_stats import read, record

SPAN_METRICS = ("plan_ms", "settle_ms", "map_lock_wait_ms", "idle_usm_frac",
                "idle_cpu_frac", "idle_unattributed_frac")
IDLE = ("idle_usm_frac", "idle_cpu_frac", "idle_unattributed_frac")


def pkg(unit, off, size, t_issue, t_launch, t_complete, t_collected):
    from repro_torch.core.package import Package, Range

    return Package(Range(off, size), 0, unit=unit, t_issue=t_issue,
                   t_launch=t_launch, t_complete=t_complete,
                   t_collected=t_collected)


def stats(launch_id, plan, admit_end, packages, settle, *, plan_wait=0.0,
          settle_wait=0.0):
    """``LaunchStats`` of one launch: ``plan`` and ``settle`` as
    ``(start, end)``, ``admit`` from the plan's end to ``admit_end``."""
    from repro_torch.core import LaunchStats, Span

    end = max(p.t_collected for p in packages)
    return LaunchStats(
        total_s=end - admit_end, packages=packages,
        unit_busy_s={"cuda:0": 0.0, "cpu": 0.0}, launch_id=launch_id,
        spans=[Span("plan", launch_id, "launch", *plan,
                    counts=(("lock_wait_s", plan_wait),)),
               Span("admit", launch_id, "launch", plan[1], admit_end),
               Span("settle", launch_id, "launch", *settle, unit=0,
                    counts=(("lock_wait_s", settle_wait),))])


def trace(events, t_start=0.0, t_end=10.0):
    from bench.harness.trace import DeviceTrace

    return DeviceTrace(events=[("k", "kernel", s, e) for s, e in events],
                       t_start=t_start, t_end=t_end)


def run_of(launches, tr=None):
    """A run record of finished launches (``LaunchStats``), units
    [cuda:0, cpu], the window [0, 10] s."""
    run = record([1.0] * len(launches), t_start=0.0, seconds=10.0, trace=tr)
    for r, st in zip(run.window.records, launches):
        r.stats = st
    return run


def two_launches():
    """Launch 0: plan 0-1 s, admit to 1.1, queue to 1.2, a CUDA package
    computing 1.3-2.0 and a CPU package 1.25-3.0, settle 3.1-3.5. Launch
    1: plan 3.0-4.0, admit to 4.05, queue to 4.1, one CPU package
    computing 4.2-6.0, settle 6.1-6.2."""
    one = stats(0, (0.0, 1.0), 1.1,
                [pkg(0, 0, 10, 1.2, 1.3, 2.0, 2.1),
                 pkg(1, 10, 10, 1.2, 1.25, 3.0, 3.05)], (3.1, 3.5),
                plan_wait=0.2, settle_wait=0.01)
    two = stats(1, (3.0, 4.0), 4.05, [pkg(1, 0, 20, 4.1, 4.2, 6.0, 6.1)],
                (6.1, 6.2), plan_wait=0.0, settle_wait=0.03)
    return [one, two]


def test_plan_settle_and_lock_wait_from_known_spans():
    run = run_of(two_launches())
    assert read("plan_ms", run) == pytest.approx(1e3 * (1.0 + 1.0) / 2)
    assert read("settle_ms", run) == pytest.approx(1e3 * (0.4 + 0.1) / 2)
    # per launch: 0.2 + 0.01 and 0.0 + 0.03
    assert read("map_lock_wait_ms", run) == pytest.approx(
        1e3 * (0.21 + 0.03) / 2)


def test_a_failed_launch_is_left_out():
    run = run_of(two_launches())
    run.window.records[1].error = "RuntimeError: x"
    assert read("plan_ms", run) == pytest.approx(1e3)
    assert read("settle_ms", run) == pytest.approx(400.0)


def test_idle_is_split_in_order_and_each_instant_once():
    from bench.harness import idle

    # the card busy 1.5-1.9 and 7.0-8.0 s: idle 8.6 s of 10
    run = run_of(two_launches(), trace([(1.5, 1.9), (7.0, 8.0)]))
    got = idle.split(run)
    # plan or settle open: 0-1, 3.0-4.0 (3.1-3.5 overlaps), 6.1-6.2
    assert got["usm"] == pytest.approx(1.0 + 1.0 + 0.1)
    # else a CPU package computing: 1.25-1.5 and 1.9-3.0, 4.2-6.0
    assert got["cpu"] == pytest.approx(0.25 + 1.1 + 1.8)
    # else any span: admit, queue and stages over 1.0-1.25 and 4.0-4.2,
    # a CPU package's collect 6.0-6.1 (its other collect, 3.0-3.05, lies
    # in launch 1's plan)
    assert got["other"] == pytest.approx(0.25 + 0.2 + 0.1)
    # nothing open: 6.2-7.0 and 8.0-10.0
    assert got["unattributed"] == pytest.approx(0.8 + 2.0)
    assert read("idle_usm_frac", run) == pytest.approx(2.1 / 10)
    assert read("idle_cpu_frac", run) == pytest.approx(3.15 / 10)
    assert read("idle_unattributed_frac", run) == pytest.approx(2.8 / 10)


def test_the_four_classes_add_up_to_device_idle_frac():
    from bench.harness import idle

    for events in ([], [(0.5, 2.5)], [(1.5, 1.9), (7.0, 8.0)],
                   [(0.0, 10.0)], [(2.0, 3.2), (3.3, 5.0), (9.0, 12.0)]):
        run = run_of(two_launches(), trace(events))
        got = idle.split(run)
        total = sum(got[c] for c in idle.CLASSES) / got["window_s"]
        assert total == pytest.approx(read("device_idle_frac", run)), events
        assert sum(read(m, run) for m in IDLE) <= read(
            "device_idle_frac", run) + 1e-12


def test_plan_and_settle_come_before_a_cpu_package():
    # the second launch plans while the first one's CPU package computes
    # and the card is idle: the instant counts as plan's
    one = stats(0, (0.0, 0.5), 0.6, [pkg(1, 0, 10, 0.7, 0.8, 5.0, 5.1)],
                (5.1, 5.2))
    two = stats(1, (1.0, 2.0), 2.1, [pkg(0, 0, 10, 5.2, 5.3, 6.0, 6.1)],
                (6.1, 6.3))
    run = run_of([one, two], trace([(5.3, 6.0)], t_end=7.0))
    from bench.harness import idle

    got = idle.split(run)
    assert got["usm"] == pytest.approx(0.5 + 1.0 + 0.1 + 0.2)
    # launch 0's CPU package computes 0.8-5.0; launch 1 plans 1.0-2.0
    assert got["cpu"] == pytest.approx((1.0 - 0.8) + (5.0 - 2.0))


def test_spans_are_clipped_to_the_window():
    from bench.harness import idle

    # the window is [2, 8]: launch 0's plan (0-1) lies outside it, launch
    # 1's plan (3-4) inside
    run = run_of(two_launches(), trace([], t_start=2.0, t_end=8.0))
    got = idle.split(run)
    assert got["window_s"] == pytest.approx(6.0)
    # plan 3.0-4.0, settle 3.1-3.5 inside it, 6.1-6.2
    assert got["usm"] == pytest.approx(1.0 + 0.1)
    # CPU compute 2.0-3.0 and 4.2-6.0
    assert got["cpu"] == pytest.approx(1.0 + 1.8)
    assert sum(got[c] for c in idle.CLASSES) == pytest.approx(6.0)


def test_no_trace_or_no_spans_reads_nothing():
    # without a trace: the idle shares are left out, the spans' means not
    run = run_of(two_launches())
    for metric in IDLE:
        assert read(metric, run) is None, metric
    assert read("plan_ms", run) is not None
    # the control: no stats at all
    run = record([0.1, 0.1], trace=trace([(0.0, 1.0)]))
    for metric in SPAN_METRICS:
        assert read(metric, run) is None, metric
    # a program whose stats have no timeline (this reader's parent)
    old = types.SimpleNamespace(total_s=0.05, num_packages=1, packages=[],
                                unit_busy_s={})
    for r in run.window.records:
        r.stats = old
    for metric in SPAN_METRICS:
        assert read(metric, run) is None, metric


def test_launches_that_mapped_nothing_give_no_lock_wait():
    from repro_torch.core import LaunchStats, Span

    # CPU units alone: plan and settle carry no lock_wait_s count
    st = LaunchStats(total_s=1.0, packages=[pkg(1, 0, 10, 1.2, 1.3, 2.0,
                                                 2.1)],
                     unit_busy_s={}, launch_id=0,
                     spans=[Span("plan", 0, "launch", 0.0, 1.0),
                            Span("admit", 0, "launch", 1.0, 1.1),
                            Span("settle", 0, "launch", 2.2, 2.3, unit=1)])
    run = run_of([st])
    assert read("map_lock_wait_ms", run) is None
    assert read("settle_ms", run) == pytest.approx(100.0)
    # one launch that mapped beside one that did not: the mean of the one
    run = run_of([st, two_launches()[0]])
    assert read("map_lock_wait_ms", run) == pytest.approx(210.0)
