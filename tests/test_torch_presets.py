"""The H100 host's presets, the port's counterparts of the reference's TPU
presets, on the CPU.

``H100_POWER`` and ``H100_MEMORY_COSTS`` (measured on the card by
``chip_smoke.py`` phase 13) are a well-formed ``PowerModel`` and
``MemoryCosts``; the DES (``simulate``, ``solo_run``, ``simulate_multi``)
runs every paper workload on them under both memory models with exact
covers, and ``energy_report`` integrates on them as its formula says.
The paper's calibration, which the parity tests hold to the reference's,
stays as it is: ``PAPER_POWER`` and the ``MemoryCosts()`` defaults equal
the reference's field for field, and the port has no TPU preset.
"""
import dataclasses
import math

import pytest

import repro.core as ref_core
from repro_torch import core
from repro_torch.core import (H100_MEMORY_COSTS, H100_POWER, LaunchSpec,
                              MemoryCosts, MemoryModel, PowerModel,
                              energy_report, paper_workload, simulate,
                              simulate_multi, solo_run)
from repro_torch.core.scheduler import HGuidedScheduler

KINDS = {"cpu": "cpu", "gpu": "gpu"}


def test_presets_are_well_formed_and_exported():
    assert isinstance(H100_POWER, PowerModel)
    assert set(H100_POWER.busy_w) == set(H100_POWER.idle_w) == \
        {"cpu", "gpu"}
    for watts in (*H100_POWER.busy_w.values(), *H100_POWER.idle_w.values(),
                  H100_POWER.uncore_dram_w):
        assert math.isfinite(watts) and watts >= 0
    assert H100_POWER.busy_w["gpu"] > H100_POWER.idle_w["gpu"] > 0
    assert isinstance(H100_MEMORY_COSTS, MemoryCosts)
    for field in dataclasses.fields(MemoryCosts):
        value = getattr(H100_MEMORY_COSTS, field.name)
        assert math.isfinite(value) and value >= 0, field.name
    assert H100_MEMORY_COSTS.copy_bw_Bps > 1e9
    assert H100_MEMORY_COSTS.llc_bytes >= 2**20
    assert H100_MEMORY_COSTS != MemoryCosts()
    assert {"H100_POWER", "H100_MEMORY_COSTS"} <= set(core.__all__)


def test_the_paper_calibration_stays_the_references():
    assert dataclasses.asdict(core.PAPER_POWER) == \
        dataclasses.asdict(ref_core.PAPER_POWER)
    assert dataclasses.asdict(MemoryCosts()) == \
        dataclasses.asdict(ref_core.MemoryCosts())
    assert not hasattr(core, "TPU_POWER")
    assert not hasattr(core, "TPU_MEMORY_COSTS")


@pytest.mark.parametrize("memory", [MemoryModel.USM, MemoryModel.BUFFERS])
@pytest.mark.parametrize("name", ["taylor", "gaussian", "matmul",
                                  "mandelbrot", "ray", "rap"])
def test_des_runs_every_paper_workload_on_the_presets(name, memory):
    wl, cpu, gpu = paper_workload(name)
    sched = HGuidedScheduler(wl.total, 2, speeds=[gpu.speed, cpu.speed])
    res = simulate(sched, [gpu, cpu], wl, memory=memory,
                   costs=H100_MEMORY_COSTS)
    assert sum(p.size for p in res.packages) == wl.total
    solo = solo_run(gpu, wl, memory=memory, costs=H100_MEMORY_COSTS)
    assert res.total_s > 0 and solo.total_s > 0
    # the presets' package costs are what the DES charges the host: each
    # package's fixed costs, and under BUFFERS its copies on top
    per_package = H100_MEMORY_COSTS.launch_cost(memory, 0) + \
        H100_MEMORY_COSTS.collect_cost(memory, 0)
    fixed = res.num_packages * per_package
    if memory is MemoryModel.USM:
        assert res.host_busy_s == pytest.approx(fixed, rel=1e-9)
    else:
        assert res.host_busy_s > fixed
    report = res.energy(H100_POWER, KINDS)
    assert report.total_J > 0 and report.edp == \
        report.total_J * res.total_s
    assert core.edp_ratio(solo.energy(H100_POWER, KINDS), report) > 0


def test_simulate_multi_runs_on_the_presets():
    specs = []
    for i, name in enumerate(("taylor", "rap", "mandelbrot")):
        wl, cpu, gpu = paper_workload(name, size_scale=0.05)
        specs.append(LaunchSpec(wl, HGuidedScheduler(
            wl.total, 2, speeds=[gpu.speed, cpu.speed]), tenant=name,
            t_submit=0.01 * i))
    _, cpu, gpu = paper_workload("taylor")
    res = simulate_multi(specs, [gpu, cpu], costs=H100_MEMORY_COSTS)
    assert len(res.launches) == 3 and not res.shed
    assert all(r.latency_s > 0 for r in res.launches)


def test_energy_report_integrates_the_presets():
    busy = {"gpu": 1.5, "cpu": 0.5}
    got = energy_report(H100_POWER, busy, 2.0)
    p = H100_POWER
    want = {kind: p.busy_w[kind] * b + p.idle_w[kind] * (2.0 - b)
            for kind, b in busy.items()}
    assert got.per_unit_J == pytest.approx(want, rel=1e-12)
    assert got.uncore_dram_J == pytest.approx(2.0 * p.uncore_dram_w)
    assert got.total_J == pytest.approx(sum(want.values())
                                        + 2.0 * p.uncore_dram_w)
