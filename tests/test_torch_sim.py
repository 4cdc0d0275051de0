"""The port's discrete-event simulator against the reference's, bit for bit.

The DES is numpy and Python only, so on the same profile, scheduler and
memory model both packages must give *equal* results, not close ones:
``total_s``, per-unit busy and finish seconds, the package sequence with
every timestamp, ``DataPlaneCounters`` and the modeled ``EnergyReport``
(``PAPER_POWER``, the paper testbed's calibration). ``simulate_multi``
is held the same way on a multi-tenant WFQ + fusion mix. The paper
anchors of ``tests/test_sim.py`` (HGuided balance, the Ray and Rap
speedups, the EDP geomean of about 1.7x) are then checked on the port
alone. Every time here is a virtual second of the paper's testbed.
"""
import dataclasses

import pytest

import repro.api as ref_api
import repro.core.sim as ref_sim_module
import repro.core as ref_core
from repro.core.workloads import effective_shares as ref_effective_shares
import repro_torch.api as api
import repro_torch.core as core
import repro_torch.core.sim as sim
from repro_torch.core.workloads import effective_shares

SIDES = {"ref": (ref_core, ref_api, ref_effective_shares),
         "port": (core, api, effective_shares)}
POLICIES = ("static", "dynamic", "hguided", "work_stealing")
KINDS = {"gpu": "gpu", "cpu": "cpu"}


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


def packages(pkgs) -> list:
    return [(p.seq, p.unit, p.offset, p.size, p.t_issue, p.t_launch,
             p.t_complete, p.t_collected) for p in pkgs]


def counters(d) -> tuple:
    return (d.dispatches, d.h2d_copies, d.h2d_bytes, d.d2h_copies,
            d.d2h_bytes)


def energy(report) -> tuple:
    return (dict(report.per_unit_J), report.uncore_dram_J, report.runtime_s,
            report.total_J, report.edp)


def simulate_on(side, name, policy, memory):
    c, a, shares = SIDES[side]
    wl, cpu, gpu = c.paper_workload(name)
    kw = ({"speeds": shares(wl, cpu, gpu, hint_error=0.25)}
          if policy in ("static", "hguided", "work_stealing") else {})
    sched = a.build_scheduler(policy, wl.total, 2, **kw)
    mem = c.MemoryModel(memory)
    res = c.simulate(sched, [cpu, gpu], wl, memory=mem)
    solo = c.solo_run(gpu, wl, memory=mem)
    return res, solo, (wl, cpu, gpu)


@pytest.mark.parametrize("memory", ["usm", "buffers"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", sorted(core.ALL_BENCHMARKS))
def test_simulate_equals_reference(name, policy, memory):
    ref, ref_solo, (rwl, rcpu, rgpu) = simulate_on("ref", name, policy,
                                                    memory)
    got, solo, (wl, cpu, gpu) = simulate_on("port", name, policy, memory)
    assert (wl.total, wl.bytes_in_per_item, wl.bytes_out_per_item,
            wl.working_set_bytes, wl.contention_scale) == \
        (rwl.total, rwl.bytes_in_per_item, rwl.bytes_out_per_item,
         rwl.working_set_bytes, rwl.contention_scale)
    assert (wl.weights is None) == (rwl.weights is None)
    if wl.weights is not None:
        assert wl.weights.tobytes() == rwl.weights.tobytes()
    assert dataclasses.astuple(cpu) == dataclasses.astuple(rcpu)
    assert dataclasses.astuple(gpu) == dataclasses.astuple(rgpu)
    for g, r in ((got, ref), (solo, ref_solo)):
        assert (g.workload, g.policy, g.memory) == \
            (r.workload, r.policy, r.memory)
        assert g.total_s == r.total_s
        assert g.unit_busy_s == r.unit_busy_s
        assert g.unit_finish_s == r.unit_finish_s
        assert g.host_busy_s == r.host_busy_s
        assert g.num_packages == r.num_packages
        assert packages(g.packages) == packages(r.packages)
        assert counters(g.data) == counters(r.data)
        assert energy(g.energy(core.PAPER_POWER, KINDS)) == \
            energy(r.energy(ref_core.PAPER_POWER, KINDS))
    assert got.balance() == ref.balance()


def multi_on(side, name, policy, admission, fuse):
    c, a, shares = SIDES[side]
    base, cpu, gpu = c.paper_workload(name)
    specs = []
    for t in range(6):
        items = (512, 768)[t % 2]
        wl = c.Workload(name, items, base.bytes_in_per_item,
                        base.bytes_out_per_item, base.working_set_bytes,
                        contention_scale=base.contention_scale)
        kw = ({"speeds": [cpu.speed, gpu.speed]}
              if policy in ("static", "hguided", "work_stealing") else {})
        specs.append(c.LaunchSpec(
            wl, a.build_scheduler(policy, items, 2, **kw),
            tenant=f"t{t % 3}", weight=1.0 + t % 2,
            t_submit=0.002 * (t // 4)))
    cfg = c.AdmissionConfig(policy=admission, fuse=fuse,
                            fuse_threshold=1024, fuse_wait_s=0.0)
    return c.simulate_multi(specs, [cpu, gpu], admission=cfg)


@pytest.mark.parametrize("admission,fuse", [("fifo", False), ("wfq", True)])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", sorted(core.ALL_BENCHMARKS))
def test_simulate_multi_equals_reference(name, policy, admission, fuse):
    ref = multi_on("ref", name, policy, admission, fuse)
    got = multi_on("port", name, policy, admission, fuse)
    assert got.total_s == ref.total_s
    assert [(r.tenant, r.workload, r.t_submit, r.t_finish, r.items,
             r.num_packages, r.fused, r.deadline, counters(r.data))
            for r in got.launches] == \
        [(r.tenant, r.workload, r.t_submit, r.t_finish, r.items,
          r.num_packages, r.fused, r.deadline, counters(r.data))
         for r in ref.launches]
    assert (got.dispatched_packages, got.fused_batches,
            got.fused_members, got.host_busy_s) == \
        (ref.dispatched_packages, ref.fused_batches, ref.fused_members,
         ref.host_busy_s)
    assert got.service == ref.service
    assert got.decisions == ref.decisions
    assert got.fusion_groups == ref.fusion_groups
    assert counters(got.data) == counters(ref.data)
    assert got.fairness_curve() == ref.fairness_curve()
    assert (got.fused_batches > 0) == fuse


def test_energy_model_equals_reference():
    busy = {"cpu": 1.25, "gpu": 0.75}
    got = core.energy_report(core.PAPER_POWER, busy, 2.0)
    ref = ref_core.energy_report(ref_core.PAPER_POWER, busy, 2.0)
    assert energy(got) == energy(ref)
    assert dataclasses.asdict(core.PAPER_POWER) == \
        dataclasses.asdict(ref_core.PAPER_POWER)
    assert core.geomean([1.5, 2.0, 3.0]) == ref_core.geomean([1.5, 2.0, 3.0])
    assert core.edp_ratio(got, got) == 1.0
    with pytest.raises(ValueError):
        core.geomean([])
    assert not hasattr(core, "TPU_POWER")


# -- the paper anchors on the port alone (tests/test_sim.py) ---------------

def port_speedup(name, policy="hguided"):
    res, solo, _ = simulate_on("port", name, policy, "usm")
    return solo.total_s / res.total_s


@pytest.mark.parametrize("name", sorted(core.ALL_BENCHMARKS))
def test_hguided_balance_near_one(name):
    """Fig. 5 top: HGuided balancing efficiency ≈ 1 on every benchmark."""
    res, _, _ = simulate_on("port", name, "hguided", "usm")
    assert 0.9 <= res.balance() <= 1.1, res.balance()


def test_paper_speedup_anchors():
    """§5.1: HGuided speedups range from 1.48 (Ray) to 2.46 (Rap)."""
    assert port_speedup("ray") == pytest.approx(1.48, abs=0.07)
    assert port_speedup("rap") == pytest.approx(2.46, abs=0.07)
    for name in core.ALL_BENCHMARKS:
        assert 1.3 <= port_speedup(name) <= 2.6, name


def test_edp_geomean_near_paper():
    """Fig. 7: HGuided+USM ≈ 1.72x more energy-efficient than GPU-only,
    favorable on every benchmark."""
    ratios = []
    for name in core.ALL_BENCHMARKS:
        res, solo, _ = simulate_on("port", name, "hguided", "usm")
        r = core.edp_ratio(solo.energy(core.PAPER_POWER, KINDS),
                           res.energy(core.PAPER_POWER, KINDS))
        assert r > 1.0, (name, r)
        ratios.append(r)
    assert 1.45 <= core.geomean(ratios) <= 2.0


def test_sim_unit_is_frozen_and_prices_like_the_reference():
    import numpy as np

    unit = core.SimUnit("gpu", "gpu", speed=250.0, alpha=1.5)
    ref = ref_core.SimUnit("gpu", "gpu", speed=250.0, alpha=1.5)
    prefix = np.concatenate([[0.0], np.cumsum(np.linspace(0.5, 1.5, 64))])
    for args in ((None, 3, 17), (prefix, 0, 64), (prefix, 9, 20)):
        assert unit.package_seconds(*args) == ref.package_seconds(*args)
    with pytest.raises(dataclasses.FrozenInstanceError):
        unit.speed = 1.0


def test_prefix_cache_survives_workload_id_reuse():
    """A workload freed after its launch (a fused batch's) must not hand
    its cached cost prefix to a later workload that reuses its id(): the
    reference keys the cache by id() alone and can read a stale prefix of
    another length (an IndexError in a fused open-loop replay)."""
    import numpy as np

    unit = core.SimUnit("u0", "cpu", speed=100.0)
    backend = sim.SimBackend([unit], core.MemoryModel.USM,
                             core.MemoryCosts())
    short = core.Workload("a", 4, 8.0, 8.0, 1e4, weights=np.ones(4))
    assert len(backend._prefix_for(short, unit)) == 5
    stale = id(short)
    del short
    for _ in range(1000):           # CPython reuses the freed slot
        longer = core.Workload("b", 64, 8.0, 8.0, 1e4,
                               weights=np.arange(1.0, 65.0))
        if id(longer) == stale:
            break
    got = backend._prefix_for(longer, unit)
    np.testing.assert_array_equal(got, np.concatenate(
        [[0.0], np.cumsum(np.arange(1.0, 65.0))]))
