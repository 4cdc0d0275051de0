"""The end-to-end and device metrics on synthetic stamps."""
from __future__ import annotations

import math
import types

import pytest

from conftest import small_cell


def record(latencies, *, t_start=10.0, seconds=4.0, trace=None,
           cell="matmul-t1.pair-usm"):
    """A run record whose launches took ``latencies``, none failed."""
    from bench.harness import loop, runner

    recs = [loop.LaunchRecord(0, t_start + i * 0.01, t_start + i * 0.01,
                              t_start + i * 0.01 + lat)
            for i, lat in enumerate(latencies)]
    window = loop.Window(t_start=t_start, t_end=t_start + seconds,
                         records=recs, kept={})
    return runner.RunRecord(cell=small_cell(cell), setup_s=7.5,
                            window=window, units=[("cuda:0", "cuda"),
                                                  ("cpu", "cpu")],
                            inputs=[], total=0, device="cpu", peaks=None,
                            trace=trace)


def read(metric, run):
    from bench.harness import spec

    return spec.reader(run.cell, metric).read(run)


def test_items_per_s_counts_every_launch_over_the_window():
    run = record([0.1] * 40, seconds=4.0)
    # 40 launches of a 64 x 48 product (the small matmul) over 4 s
    assert read("items_per_s", run) == pytest.approx(40 * 3072 / 4.0)


def test_a_failed_launch_adds_no_items():
    run = record([0.1] * 10, seconds=2.0)
    run.window.records[3].error = "RuntimeError: x"
    assert read("items_per_s", run) == pytest.approx(9 * 3072 / 2.0)


def test_setup_s_is_the_record_s():
    assert read("setup_s", record([0.1])) == 7.5


def test_union_gaps_and_covered():
    from bench.harness import stats

    iv = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0), (-1.0, 0.5), (9.0, 12.0)]
    assert stats.union(iv, 0.0, 10.0) == [(0.0, 0.5), (1.0, 3.0),
                                          (5.0, 6.0), (9.0, 10.0)]
    assert stats.covered(iv, 0.0, 10.0) == pytest.approx(4.5)
    assert stats.gaps(iv, 0.0, 10.0) == [(0.5, 1.0), (3.0, 5.0),
                                         (6.0, 9.0)]
    assert stats.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_device_idle_frac_is_one_less_the_union_over_the_window():
    from bench.harness.trace import DeviceTrace

    events = [("k", "kernel", 10.0, 11.0), ("k", "kernel", 10.5, 11.5),
              ("Memcpy HtoD", "gpu_memcpy", 12.0, 12.5),
              ("k", "kernel", 13.5, 15.0)]
    tr = DeviceTrace(events=events, t_start=10.0, t_end=14.0)
    assert tr.busy_s == pytest.approx(2.5)
    run = record([0.1], trace=tr)
    assert read("device_idle_frac", run) == pytest.approx(1 - 2.5 / 4.0)
    assert tr.kernel_seconds("k") == pytest.approx(1.0 + 1.0 + 0.5)
    assert tr.top_ops(1) == [["k", 3.5]]


def test_idle_gaps_are_named_by_the_host_spans_then():
    from bench.harness.trace import DeviceTrace

    tr = DeviceTrace(events=[("k", "kernel", 1.0, 2.0)], t_start=0.0,
                     t_end=5.0)
    spans = [("submit", 2.5, 4.0), ("wait", 2.0, 5.0), ("wait", 0.0, 1.0)]
    gaps = tr.idle_gaps(spans)
    assert gaps[0][0] == "submit x1, wait x1" and gaps[0][1] == 3.0
    assert gaps[1] == ["wait x1", 1.0]


def test_spread_is_the_quartile_distance_over_the_median():
    from bench.harness.stats import spread

    vals = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, _, q3 = 1.75, 3.5, 5.25
    assert spread(vals) == pytest.approx((q3 - q1) / 3.5)
    assert not math.isnan(spread([2.0, 2.0, 2.0]))


def test_a_reader_without_its_source_returns_nothing():
    run = record([0.1])
    for metric in ("device_idle_frac", "matmul_roofline", "launch_mfu",
                   "launch_overhead_ms", "packages_per_launch"):
        assert read(metric, run) is None, metric


def test_package_readers_on_synthetic_stats():
    from repro_torch.core.package import Package, Range

    def pkg(unit, off, size, t):
        return Package(Range(off, size), 0, unit=unit, t_issue=t,
                       t_launch=t + 0.001, t_complete=t + 0.011,
                       t_collected=t + 0.012)

    stats = types.SimpleNamespace(
        total_s=0.05, num_packages=3,
        packages=[pkg(0, 0, 600, 10.0), pkg(1, 600, 200, 10.0),
                  pkg(0, 800, 1600, 10.02)],
        unit_busy_s={"cuda:0": 0.02, "cpu": 0.01})
    run = record([0.08, 0.08], seconds=2.0)
    for r in run.window.records:
        r.stats = stats
    assert read("launch_overhead_ms", run) == pytest.approx(30.0)
    assert read("packages_per_launch", run) == pytest.approx(3.0)
    assert read("cpu_items_frac", run) == pytest.approx(200 / 2400)
    assert read("cpu_busy_frac", run) == pytest.approx(0.02 / 2.0)
    # 3 packages a launch, 2 ms of staging and collection each
    assert read("host_overhead_frac", run) == pytest.approx(
        2 * 3 * 0.002 / 2.0)
