"""The port's control plane decides exactly as the reference's.

The reference ``ExecutionLoop`` (JAX ``RealBackend``) and the port's (torch
``RealBackend``) get the same launches — tenants, weights, deadlines,
offer times — and the same deterministic round-robin serve order over two
CPU units (the drive of ``tests/test_exec.py``). For the four policies ×
{fifo, wfq, edf} × {preempt off, on} every per-unit ``(offset, size)``
sequence, every admission and shed decision and the dispatch count must
be identical: these are exact, not toleranced, comparisons.
"""
import numpy as np
import pytest

import jax

from repro.api import build_kernel as ref_build_kernel
from repro.api import build_scheduler as ref_build_scheduler
from repro.core import AdmissionConfig as RefAdmissionConfig
from repro.core import ExecutionLoop as RefLoop
from repro.core import MemoryModel as RefMemoryModel
from repro.core import counits_from_devices as ref_counits
from repro.core.dataplane import make_plane as ref_make_plane
from repro.core.engine import RealBackend as RefBackend
from repro.core.engine import _Launch as RefLaunch
from repro_torch.api import build_kernel, build_scheduler
from repro_torch.core import (AdmissionConfig, ExecutionLoop, MemoryModel,
                              counits_from_devices, make_plane)
from repro_torch.core.engine import RealBackend, _Launch

NUNITS = 2
SPEEDS = [0.4, 0.6]
POLICIES = ["static", "dyn8", "hguided", "work_stealing"]
# (tenant, weight, total, absolute deadline, offer time): with
# shed_rate=1000 items/s the second launch's estimated finish misses its
# deadline and is shed within the 0.5 budget; the others are admitted
LAUNCHES = [("t0", 1.0, 240, 0.5, 0.0), ("t1", 2.0, 160, 0.2, 0.01),
            ("t2", 1.0, 300, 0.9, 0.02), ("t3", 3.0, 96, 0.7, 0.03)]


@pytest.fixture(scope="module")
def ref_units():
    return ref_counits(jax.local_devices()[:1] * NUNITS,
                       kinds=["cpu"] * NUNITS, speed_hints=SPEEDS)


@pytest.fixture(scope="module")
def port_units():
    return counits_from_devices(["cpu"] * NUNITS, speed_hints=SPEEDS)


def sched_kw(policy):
    return {"speeds": SPEEDS} if policy in ("static", "hguided",
                                            "work_stealing") else {}


def drive(loop):
    """Serve one package per unit per sweep, round-robin, until drained."""
    for _ in range(100_000):
        if loop.drained():
            return
        progressed = False
        for u in range(NUNITS):
            work = loop.pull(u, force_flush=True)
            if work is None:
                continue
            launch, pkg = work
            loop.backend.dispatch(u, launch, pkg)
            loop.complete(launch, pkg)
            progressed = True
        if not progressed and not loop.drained():
            raise AssertionError("drive wedged with work outstanding")
    raise AssertionError("drive did not converge")


def run(side, policy, admission, preempt, units):
    """Offer the launches to one package's loop, drive, and summarize."""
    if side == "ref":
        cfg_cls, loop_cls, backend_cls, launch_cls = (
            RefAdmissionConfig, RefLoop, RefBackend, RefLaunch)
        plane = ref_make_plane(RefMemoryModel.USM)
        kernel, build = ref_build_kernel("taylor"), ref_build_scheduler
    else:
        cfg_cls, loop_cls, backend_cls, launch_cls = (
            AdmissionConfig, ExecutionLoop, RealBackend, _Launch)
        plane = make_plane(MemoryModel.USM)
        kernel, build = build_kernel("taylor"), build_scheduler
    cfg = cfg_cls(policy=admission, preempt=preempt, quantum=32,
                  shed=True, shed_rate=1000.0, shed_budget=0.5)
    backend = backend_cls(units, plane)
    loop = loop_cls(backend, [u.name for u in units], cfg)
    data_rng = np.random.default_rng(5)
    launches = []
    for tenant, weight, total, deadline, t_offer in LAUNCHES:
        x = data_rng.uniform(-2, 2, total).astype(np.float32)
        out = np.zeros(total, np.float32)
        launch = launch_cls(loop.next_id(),
                            build(policy, total, NUNITS, **sched_kw(policy)),
                            kernel, [x], out, adaptive=False)
        launch.plan = plane.plan(kernel, [x], out, total)
        launch.tenant, launch.weight = tenant, weight
        launch.deadline = deadline
        loop.offer(launch, now=t_offer)
        launches.append(launch)
    drive(loop)
    return {
        "decisions": list(loop.admission.decision_log),
        "dispatched": loop.admission.dispatched,
        "packages": {l.tenant: [(p.unit, p.offset, p.size)
                                for p in l.done_pkgs] for l in launches},
        "finalized": [l.finalized for l in launches],
    }


@pytest.mark.parametrize("preempt", [False, True])
@pytest.mark.parametrize("admission", ["fifo", "wfq", "edf"])
@pytest.mark.parametrize("policy", POLICIES)
def test_control_plane_decisions_identical(policy, admission, preempt,
                                           ref_units, port_units):
    want = run("ref", policy, admission, preempt, ref_units)
    got = run("port", policy, admission, preempt, port_units)
    assert ("shed", "t1") in want["decisions"]
    assert got["decisions"] == want["decisions"]
    assert got["dispatched"] == want["dispatched"]
    assert got["finalized"] == want["finalized"]
    for tenant, seq in want["packages"].items():
        assert got["packages"][tenant] == seq, tenant
