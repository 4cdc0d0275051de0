"""The whole slice: ``CoexecutorRuntime`` in both packages on two CPU units.

For each of the six paper kernels × {usm, buffers} × pipeline depth
{1, 2}, the same seeded demo inputs run through the reference runtime
(JAX, two units over one CPU device) and the port's (two ``cpu`` units):

* outputs agree within each kernel's tolerance (as in
  ``tests/test_torch_kernels.py``: taylor/gaussian rtol 1e-5 atol 1e-6,
  matmul rtol 1e-5 atol 1e-6*K, mandelbrot exact, ray atol 1e-4 with at
  most 0.1 % of rays beyond it, rap rtol 1e-5 atol 1e-6*L);
* under ``static`` and ``dynamic`` the package covers and the
  ``DataPlaneCounters`` totals are equal — which unit served a dynamic
  package depends on thread timing in both packages, so covers are
  compared as sorted ranges;
* under ``hguided`` only outputs are compared: its covers depend on
  request order even in the reference.

Within the port, USM and BUFFERS agree bitwise and USM makes no copy.
"""
import json
import mmap

import numpy as np
import pytest
import torch

from repro.api import CoexecSpec as RefSpec
from repro.api import build_kernel as ref_build_kernel
from repro.api import kernel_demo_inputs as ref_demo_inputs
from repro.core import CoexecutorRuntime as RefRuntime
from repro_torch.api import CoexecSpec, build_kernel, kernel_demo_inputs
from repro_torch.core import (CoexecEngine, CoexecKernel, ArgSpec,
                              CoexecutorRuntime, counits_from_devices)

KERNELS = ("taylor", "gaussian", "matmul", "mandelbrot", "ray", "rap")
N = 300          # not a power of two: uneven packages and bucket pads
TOL = {"taylor": (1e-5, 1e-6), "gaussian": (1e-5, 1e-6),
       "matmul": (1e-5, 1e-6 * 32), "mandelbrot": (0.0, 0.0),
       "ray": (0.0, 1e-4), "rap": (1e-5, 1e-6 * 48)}


def assert_close(name, got, want, what=""):
    """Within the kernel's tolerance; for ray, at most 0.1 % of the rays
    may lie beyond it (an FMA-contracted silhouette test flips a hit)."""
    rtol, atol = TOL[name]
    if name == "ray":
        off = np.abs(got - want) > atol + rtol * np.abs(want)
        assert off.mean() <= 1e-3, (what, int(off.sum()))
        return
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def spec_of(cls, policy, memory, depth):
    return (cls.builder().policy(policy)
            .units(count=2, kinds=("cpu", "cpu"), speed_hints=(0.4, 0.6),
                   pipeline_depth=depth)
            .dist(0.4).memory(memory).build())


@pytest.fixture(scope="module")
def ref_units():
    return spec_of(RefSpec, "hguided", "usm", 1).build_units()


@pytest.fixture(scope="module")
def port_units():
    return counits_from_devices(["cpu", "cpu"], speed_hints=(0.4, 0.6))


def launch(runtime_cls, spec, units, kernel, inputs):
    with runtime_cls.from_spec(spec, units=units) as rt:
        out = rt.launch(N, kernel, inputs)
        return out.copy(), rt.last_stats


def cover(stats):
    return sorted((p.offset, p.size) for p in stats.packages)


@pytest.mark.timeout(240)
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("memory", ["usm", "buffers"])
@pytest.mark.parametrize("name", KERNELS)
def test_runtime_matches_reference(name, memory, depth, ref_units,
                                   port_units):
    ref_inputs = ref_demo_inputs(name, N, seed=11)
    inputs = kernel_demo_inputs(name, N, seed=11)
    for a, b in zip(ref_inputs, inputs):
        np.testing.assert_array_equal(a, b)
    for policy in ("static", "dynamic", "hguided"):
        want, want_stats = launch(RefRuntime,
                                  spec_of(RefSpec, policy, memory, depth),
                                  ref_units, ref_build_kernel(name),
                                  ref_inputs)
        got, got_stats = launch(CoexecutorRuntime,
                                spec_of(CoexecSpec, policy, memory, depth),
                                port_units, build_kernel(name), inputs)
        assert_close(name, got, want, f"{name} {memory} {policy}")
        if policy != "hguided":
            assert cover(got_stats) == cover(want_stats), policy
            assert got_stats.data.to_dict() == want_stats.data.to_dict(), \
                policy


@pytest.mark.timeout(240)
@pytest.mark.parametrize("name", KERNELS)
def test_usm_and_buffers_bitwise_within_port(name, port_units):
    inputs = kernel_demo_inputs(name, N, seed=7)
    outs, stats = {}, {}
    for memory in ("usm", "buffers"):
        outs[memory], stats[memory] = launch(
            CoexecutorRuntime, spec_of(CoexecSpec, "dyn16", memory, 2),
            port_units, build_kernel(name), inputs)
    np.testing.assert_array_equal(outs["usm"], outs["buffers"])
    usm, buf = stats["usm"].data, stats["buffers"].data
    assert usm.h2d_copies == usm.d2h_copies == 0
    assert usm.h2d_bytes == usm.d2h_bytes == 0
    assert buf.d2h_copies == stats["buffers"].num_packages
    assert buf.h2d_copies == (stats["buffers"].num_packages
                              * len(build_kernel(name).args))
    assert usm.dispatches == stats["usm"].num_packages


def test_spec_json_from_reference_round_trips():
    ref = (RefSpec.builder().policy("work_stealing", chunks_per_unit=4)
           .units(count=2, kinds=("gpu", "cpu"), speed_hints=(0.7, 0.3),
                  pipeline_depth=2)
           .dist(0.3).memory("buffers")
           .admission(policy="edf", max_inflight=8, preempt=True)
           .slo(25.0, shed=True, shed_rate=1e6)
           .workload("mandelbrot", kernel="mandelbrot", items=4096)
           .build())
    text = ref.to_json()
    port = CoexecSpec.from_json(text)
    assert port.to_dict() == json.loads(text) == ref.to_dict()
    assert port.workload.kernel_impl == "auto"
    assert CoexecSpec.from_json(port.to_json()) == port
    port.validate()


def test_reference_only_kernel_impls_are_rejected():
    spec = CoexecSpec()
    for impl in ("pallas", "xla", "ref"):
        bad = spec.replace(workload=spec.workload.replace(kernel_impl=impl))
        with pytest.raises(ValueError, match="'auto'"):
            bad.validate()
        with pytest.raises(ValueError, match="'auto'"):
            build_kernel("taylor", impl=impl)
    assert build_kernel("taylor", impl="auto") is build_kernel("taylor")


def test_default_units_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        counits_from_devices()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CoexecSpec().build_units()


def test_cpu_units_are_named_and_kinded():
    units = counits_from_devices(["cpu", "cpu"])
    assert [u.name for u in units] == ["cpu", "cpu#1"]
    assert [u.kind for u in units] == ["cpu", "cpu"]
    assert all(u.stream is None for u in units)


def test_fusion_is_rejected_loudly(port_units):
    """A fusing spec builds an engine; a fusion setting that cannot work
    is refused at construction, naming the fields."""
    spec = CoexecSpec.builder().fuse(True).build()
    with CoexecEngine.from_spec(spec, units=port_units) as engine:
        assert engine.admission.config.fuse
    bad = spec.replace(admission=spec.admission.replace(fuse_threshold=0))
    with pytest.raises(ValueError, match="fuse_threshold"):
        CoexecEngine.from_spec(bad, units=port_units)


@pytest.mark.timeout(60)
def test_kernel_returning_non_tensor_fails_launch(port_units):
    bad = CoexecKernel("bad", lambda offset, x, *, out: x.numpy(),
                       (ArgSpec("x"),))
    spec = spec_of(CoexecSpec, "dyn8", "usm", 2)
    with CoexecEngine.from_spec(spec, units=port_units) as engine:
        x = np.ones(64, np.float32)
        h = engine.submit(spec.build_scheduler(64, 2), bad, [x],
                          np.zeros(64, np.float32))
        assert isinstance(h.exception(timeout=30), TypeError)


@pytest.mark.parametrize("lo,hi,ranges,hits,gaps", [
    (0, 8192, [], [], [(0, 8192)]),
    (4096, 12288, [(0, 8192)], [(0, 8192)], [(8192, 12288)]),
    (0, 16384, [(4096, 8192)], [(4096, 8192)], [(0, 4096), (8192, 16384)]),
    (4096, 8192, [(0, 16384)], [(0, 16384)], []),
    (0, 4096, [(8192, 12288)], [], [(0, 4096)]),
])
def test_mapped_pages_split_into_disjoint_ranges(lo, hi, ranges, hits,
                                                 gaps):
    """USM on CUDA: arrays sharing pages share one page-lock registration."""
    from repro_torch.core.dataplane import _split_pages

    assert _split_pages(lo, hi, ranges) == (hits, gaps)


@pytest.mark.parametrize("shape,dtype", [((5,), np.float32),
                                         ((3, 48), np.int32),
                                         ((1025,), np.uint8),
                                         ((0, 8), np.float32), ((), np.int64)])
def test_page_aligned_zeros_own_their_pages(shape, dtype):
    """USM maps an array in place only when no other allocation shares
    its pages; the port's own arrays are allocated so."""
    from repro_torch.core.dataplane import (_PAGE, owns_pages,
                                            page_aligned_zeros)

    a = page_aligned_zeros(shape, dtype)
    assert a.shape == shape and a.dtype == dtype and not a.any()
    assert a.flags.c_contiguous and owns_pages(a)
    if a.nbytes:
        assert a.ctypes.data % _PAGE == 0
        root = a.base
        while isinstance(root.base, np.ndarray):
            root = root.base
        end = -(-(a.ctypes.data + a.nbytes) // _PAGE) * _PAGE
        assert end <= root.ctypes.data + root.nbytes


@pytest.mark.parametrize("offset,count,owns", [
    (0, mmap.PAGESIZE, True),       # one whole page of a page-aligned map
    (0, 2 * mmap.PAGESIZE, True),
    (64, 1024, False),              # inside a page other memory may share
    (mmap.PAGESIZE - 8, 16, False),  # straddles a page boundary
    (100, 0, True),                 # empty: touches no page
])
def test_owns_pages_of_memory_outside_numpy(offset, count, owns):
    """Memory numpy does not own counts as the array's own only where the
    array starts and ends on page boundaries; page_exclusive copies the
    rest into an array that owns its pages, values unchanged."""
    from repro_torch.core.dataplane import owns_pages, page_exclusive

    buf = mmap.mmap(-1, 4 * mmap.PAGESIZE)
    a = np.frombuffer(buf, np.uint8, count=count, offset=offset)
    assert owns_pages(a) == owns
    b = page_exclusive(a)
    assert owns_pages(b) and (b is a) == owns
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("name", KERNELS)
def test_demo_inputs_and_outputs_own_their_pages(name):
    """What the serve path allocates maps in place under USM, so copying
    a served request between host and card never meets a page another
    launch holds locked."""
    from repro_torch.core.dataplane import owns_pages

    kernel = build_kernel(name)
    inputs = kernel_demo_inputs(name, 1000, seed=1)
    for got, want in zip(inputs, ref_demo_inputs(name, 1000, seed=1)):
        assert owns_pages(got)
        np.testing.assert_array_equal(got, np.asarray(want))
    assert owns_pages(kernel.alloc_out(1000, inputs))


@pytest.mark.timeout(60)
def test_legacy_closure_runs_as_all_split_kernel(port_units):
    """A positional closure returning its chunk still lands in ``out``."""
    spec = spec_of(CoexecSpec, "dyn8", "buffers", 1)
    x = np.arange(100, dtype=np.float32)
    with CoexecutorRuntime.from_spec(spec, units=port_units) as rt:
        out = rt.launch(100, lambda offset, chunk: chunk * 2.0, [x])
    np.testing.assert_array_equal(out, x * 2.0)
