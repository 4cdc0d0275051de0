"""Launch fusion in both packages: the same launches, the same batches.

The loop-level tests drive each package's ``RealBackend`` and
``ExecutionLoop`` directly, with every launch admitted before the first
pull and one package per unit per sweep in a fixed round-robin order (as
``tests/test_exec.py`` does), so the grouping is deterministic. For each
of the six paper kernels under fifo and wfq, with ``fuse_buckets`` off
and on, and on both planes, the reference (JAX, two units over one CPU
device) and the port (two ``cpu`` units) must agree on:

* ``fused_batches`` and ``fused_members`` (gaussian, matmul and ray have
  a halo or a broadcast argument and never fuse);
* each member's output, within the kernel's tolerance (as in
  ``tests/test_torch_runtime.py``), and bit for bit with the port's own
  unfused run. One exception to the tolerances: the reference computes a
  fused batch through a jit-compiled ``jax.vmap``, where XLA contracts
  Mandelbrot's updates into FMAs, so a point on the set's boundary may
  escape an iteration or two apart; at most 1 % of the points may differ
  from the reference there (the port's fused counts stay bit for bit
  equal to its unfused ones and to its plain version);
* each member's ``DataPlaneCounters`` share and synthesized package.

The engine-level tests submit through ``CoexecEngine`` with threads; a
group of ``fuse_limit`` members flushes at the last submit, so the batch
is the same in both packages even though which unit takes which package
is not.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.api import CoexecSpec as RefSpec
from repro.api import build_kernel as ref_build_kernel
from repro.api import build_scheduler as ref_build_scheduler
from repro.api import kernel_demo_inputs as ref_demo_inputs
from repro.core import AdmissionConfig as RefConfig
from repro.core import CoexecEngine as RefEngine
from repro.core import ExecutionLoop as RefLoop
from repro.core import MemoryModel as RefMemory
from repro.core import counits_from_devices as ref_counits
from repro.core.dataplane import as_coexec_kernel as ref_as_kernel
from repro.core.dataplane import make_plane as ref_make_plane
from repro.core.engine import RealBackend as RefBackend
from repro.core.engine import _fuse_key as ref_fuse_key
from repro.core.engine import _Launch as RefLaunch
from repro_torch.api import (CoexecSpec, build_kernel, build_scheduler,
                             kernel_demo_inputs)
from repro_torch.core import (AdmissionConfig, ArgSpec, CoexecEngine,
                              CoexecKernel, ExecutionLoop, MemoryModel,
                              counits_from_devices)
from repro_torch.core.dataplane import as_coexec_kernel, make_plane
from repro_torch.core.engine import RealBackend, _fuse_key, _Launch

KERNELS = ("taylor", "gaussian", "matmul", "mandelbrot", "ray", "rap")
FUSABLE = ("taylor", "mandelbrot", "rap")
TOL = {"taylor": (1e-5, 1e-6), "gaussian": (1e-5, 1e-6),
       "matmul": (1e-5, 1e-6 * 32), "mandelbrot": (0.0, 0.0),
       "ray": (0.0, 1e-4), "rap": (1e-5, 1e-6 * 48)}
SPEEDS = (0.5, 0.5)


def sizes(buckets: bool) -> list[int]:
    """Six launches: one size, or six sizes sharing the 128 bucket."""
    return [100 - 5 * i for i in range(6)] if buckets else [100] * 6


def assert_close(name, got, want, what="", fused_ref=False):
    """Within the kernel's tolerance of the reference's output.

    For ray at most 0.1 % of rays may flip at a silhouette; against the
    reference's fused (vmapped) Mandelbrot at most 1 % of points may
    differ (see the module docstring).
    """
    rtol, atol = TOL[name]
    if name == "ray" or (name == "mandelbrot" and fused_ref):
        off = np.abs(got - want) > atol
        assert off.mean() <= (1e-3 if name == "ray" else 1e-2), \
            (what, int(off.sum()))
        return
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def drive(loop, n_units=2):
    """One package per unit per sweep, round-robin, until drained."""
    for _ in range(100_000):
        if loop.drained():
            return
        progressed = False
        for u in range(n_units):
            work = loop.pull(u, force_flush=True)
            if work is None:
                continue
            launch, pkg = work
            loop.backend.dispatch(u, launch, pkg)
            loop.complete(launch, pkg)
            progressed = True
        if not progressed:
            raise AssertionError("drive wedged with work outstanding")
    raise AssertionError("drive did not converge")


def run_ref(name, admission, memory, buckets, kernel=None, inputs=None):
    units = ref_counits(jax.local_devices()[:1] * 2, kinds=["cpu"] * 2,
                        speed_hints=list(SPEEDS))
    cfg = RefConfig(policy=admission, fuse=True, fuse_threshold=1024,
                    fuse_limit=8, fuse_buckets=buckets)
    backend = RefBackend(units, ref_make_plane(RefMemory(memory)))
    loop = RefLoop(backend, [u.name for u in units], cfg)
    kernel = kernel or ref_build_kernel(name)
    launches = []
    for i, n in enumerate(sizes(buckets)):
        x = inputs[i] if inputs else ref_demo_inputs(name, n, seed=i)
        out = kernel.alloc_out(n, x)
        s = ref_build_scheduler("dyn4", n, 2)
        launch = RefLaunch(loop.next_id(), s, kernel, x, out,
                           adaptive=False)
        launch.plan = backend.plane.plan(kernel, x, out, n)
        launch.tenant = f"t{i}"
        launch.fuse_key = ref_fuse_key(cfg, s, kernel, x, out)
        if launch.fuse_key is not None and buckets:
            from repro.core.admission import fusion_bucket
            launch.fuse_bucket = fusion_bucket(n)
        launches.append(launch)
    for launch in launches:
        loop.admit(launch, now=0.0)
    drive(loop)
    return launches, loop


def run_port(name, admission, memory, buckets, fuse=True, kernel=None,
             inputs=None):
    units = counits_from_devices(["cpu", "cpu"], speed_hints=SPEEDS)
    cfg = AdmissionConfig(policy=admission, fuse=fuse, fuse_threshold=1024,
                          fuse_limit=8, fuse_buckets=buckets)
    backend = RealBackend(units, make_plane(MemoryModel(memory)))
    loop = ExecutionLoop(backend, [u.name for u in units], cfg)
    kernel = kernel or build_kernel(name)
    launches = []
    for i, n in enumerate(sizes(buckets)):
        x = inputs[i] if inputs else kernel_demo_inputs(name, n, seed=i)
        out = kernel.alloc_out(n, x)
        s = build_scheduler("dyn4", n, 2)
        launch = _Launch(loop.next_id(), s, kernel, x, out, adaptive=False)
        launch.plan = backend.plane.plan(kernel, x, out, n)
        launch.tenant = f"t{i}"
        launch.fuse_key = _fuse_key(cfg, s, kernel, x, out)
        if launch.fuse_key is not None and buckets:
            from repro_torch.core.admission import fusion_bucket
            launch.fuse_bucket = fusion_bucket(n)
        launches.append(launch)
    for launch in launches:
        loop.admit(launch, now=0.0)
    drive(loop)
    return launches, loop


def member_record(launch):
    return ([(p.offset, p.size, p.unit) for p in launch.stats.packages],
            launch.stats.data.to_dict())


@pytest.mark.timeout(240)
@pytest.mark.parametrize("buckets", [False, True], ids=["exact", "buckets"])
@pytest.mark.parametrize("admission", ["fifo", "wfq"])
@pytest.mark.parametrize("name", KERNELS)
def test_fused_batches_match_reference(name, admission, buckets):
    for memory in ("usm", "buffers"):
        ref, ref_loop = run_ref(name, admission, memory, buckets)
        got, loop = run_port(name, admission, memory, buckets)
        plain, _ = run_port(name, admission, memory, buckets, fuse=False)
        what = f"{name} {admission} {memory} buckets={buckets}"
        want_batches = 1 if name in FUSABLE else 0
        assert loop.admission.fused_batches == want_batches, what
        assert ref_loop.admission.fused_batches == want_batches, what
        assert (loop.admission.fused_members
                == ref_loop.admission.fused_members
                == 6 * want_batches), what
        for g, r, p in zip(got, ref, plain):
            out = g.handle.result(timeout=1)
            assert_close(name, out, r.handle.result(timeout=1), what,
                         fused_ref=True)
            np.testing.assert_array_equal(out, p.handle.result(timeout=1))
            assert g.fused == r.fused == (name in FUSABLE)
            assert member_record(g) == member_record(r), what


@pytest.mark.parametrize("name", ["gaussian", "matmul", "ray"])
def test_halo_and_broadcast_kernels_never_get_a_fuse_key(name):
    kernel = build_kernel(name)
    cfg = AdmissionConfig(fuse=True, fuse_threshold=1 << 20)
    x = kernel_demo_inputs(name, 64, seed=0)
    assert not kernel.all_split
    assert _fuse_key(cfg, build_scheduler("dyn4", 64, 2), kernel, x,
                     kernel.alloc_out(64, x)) is None


def test_fuse_key_needs_fuse_and_a_small_launch():
    kernel = build_kernel("taylor")
    x = kernel_demo_inputs("taylor", 64, seed=0)
    out = kernel.alloc_out(64, x)
    sched = build_scheduler("dyn4", 64, 2)
    assert _fuse_key(AdmissionConfig(fuse=False), sched, kernel, x,
                     out) is None
    assert _fuse_key(AdmissionConfig(fuse=True, fuse_threshold=63), sched,
                     kernel, x, out) is None
    exact = _fuse_key(AdmissionConfig(fuse=True), sched, kernel, x, out)
    bucket = _fuse_key(AdmissionConfig(fuse=True, fuse_buckets=True), sched,
                       kernel, x, out)
    assert exact is not None and bucket is not None and exact != bucket


def test_offset_reading_closure_runs_per_member_at_offset_zero():
    """A body that reads ``offset`` (here: adds each row's global index)
    must see a whole member at offset 0, as under the reference's vmap."""
    def ref_fn(offset, c):
        return c + (jnp.arange(c.shape[0], dtype=c.dtype) + offset)

    def port_fn(offset, c):
        return c + (torch.arange(c.shape[0], dtype=c.dtype) + offset)

    xs = [np.random.default_rng(i).normal(size=100).astype(np.float32)
          for i in range(6)]
    inputs = [[x] for x in xs]
    ref, ref_loop = run_ref("indexed", "fifo", "buffers", False,
                            kernel=ref_as_kernel(ref_fn, 1), inputs=inputs)
    got, loop = run_port("indexed", "fifo", "buffers", False,
                         kernel=as_coexec_kernel(port_fn, 1), inputs=inputs)
    assert loop.admission.fused_batches == ref_loop.admission.fused_batches \
        == 1
    want = [x + np.arange(100, dtype=np.float32) for x in xs]
    for g, r, w in zip(got, ref, want):
        np.testing.assert_array_equal(g.handle.result(timeout=1), w)
        np.testing.assert_array_equal(r.handle.result(timeout=1), w)


@pytest.mark.parametrize("rowwise", [True, False])
def test_rowwise_kernel_runs_once_per_package(rowwise):
    """A ``rowwise`` kernel serves a whole fused package in one call on a
    flat (members * bucket,) chunk; any other runs once per member."""
    calls = []

    def fn(offset, x, *, out):
        calls.append((offset, tuple(x.shape)))
        return torch.mul(x, 3.0, out=out)

    kernel = CoexecKernel("triple", fn, (ArgSpec("x"),), rowwise=rowwise)
    inputs = [[np.full(100, i, np.float32)] for i in range(6)]
    got, loop = run_port("triple", "fifo", "usm", False, kernel=kernel,
                         inputs=inputs)
    assert loop.admission.fused_batches == 1
    packages = loop.admission.dispatched
    if rowwise:
        assert len(calls) == 2 and all(c[0] == 0 for c in calls)
        assert sorted(c[1] for c in calls) == [(300,), (300,)]
    else:
        assert calls == [(0, (100,))] * 6
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g.handle.result(timeout=1),
                                      np.full(100, 3.0 * i, np.float32))
    assert packages >= 2


def engine_spec(cls, memory, buckets):
    spec = (cls.builder().policy("dyn4").memory(memory)
            .units(count=2, kinds=("cpu", "cpu"), speed_hints=SPEEDS)
            .fuse(True, threshold=4096, limit=8, wait_s=30.0).build())
    return spec.replace(admission=spec.admission.replace(
        fuse_buckets=buckets))


@pytest.mark.timeout(240)
@pytest.mark.parametrize("buckets", [False, True], ids=["exact", "buckets"])
@pytest.mark.parametrize("memory", ["usm", "buffers"])
@pytest.mark.parametrize("name", FUSABLE)
def test_engine_fusion_matches_reference(name, memory, buckets):
    """Eight concurrent submits through each package's threaded engine."""
    ns = [256 - 9 * i * buckets for i in range(8)]
    ref_units = engine_spec(RefSpec, memory, buckets).build_units()
    port_units = counits_from_devices(["cpu", "cpu"], speed_hints=SPEEDS)
    results = {}
    for pkg, spec_cls, engine_cls, units, build, demo in (
            ("ref", RefSpec, RefEngine, ref_units, ref_build_kernel,
             ref_demo_inputs),
            ("port", CoexecSpec, CoexecEngine, port_units, build_kernel,
             kernel_demo_inputs)):
        spec = engine_spec(spec_cls, memory, buckets)
        kernel = build(name)
        with engine_cls.from_spec(spec, units=units) as engine:
            handles = []
            for i, n in enumerate(ns):
                x = demo(name, n, seed=i)
                handles.append(engine.submit(spec.build_scheduler(n, 2),
                                             kernel, x,
                                             kernel.alloc_out(n, x)))
            outs = [h.result(timeout=120).copy() for h in handles]
            data = [h.stats.data.to_dict() for h in handles]
            results[pkg] = (outs, data, engine.admission.fused_batches,
                            engine.admission.fused_members)
    (ref_outs, ref_data, ref_b, ref_m) = results["ref"]
    (outs, data, b, m) = results["port"]
    assert (b, m) == (ref_b, ref_m) == (1, 8)
    assert data == ref_data
    kernel = build_kernel(name)
    for i, (n, got, want) in enumerate(zip(ns, outs, ref_outs)):
        assert_close(name, got, want, f"{name} {memory}", fused_ref=True)
        x = [torch.from_numpy(a) for a in kernel_demo_inputs(name, n,
                                                             seed=i)]
        alone = kernel.fn(0, *x, out=torch.empty(got.shape))
        np.testing.assert_array_equal(got, alone.numpy())
