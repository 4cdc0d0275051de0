"""The hand CUDA kernels and the [cuda:0, cpu] pair, on the card.

Every test here carries the ``cuda`` mark and skips without a GPU; on the
card run ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
The kernels build from ``src/repro_torch/kernels/csrc`` at first use.
Tolerances: taylor, gaussian, mandelbrot and ray equal their plain
versions bit for bit (the kernels use the plain versions' IEEE operations
in the same order); matmul within rtol 1e-5, atol 1e-6 * K (FMA vs
separate multiply and add); rap within rtol 1e-5, atol 1e-6 * L (another
summation order).
"""
import numpy as np
import pytest
import torch

from repro_torch.api import CoexecSpec, build_kernel, kernel_demo_inputs
from repro_torch.core import (CoexecEngine, CoexecutorRuntime,
                              counits_from_devices)
from repro_torch.core import dataplane
from repro_torch.kernels import (demo_spheres, gaussian_blur_halo,
                                 gaussian_blur_halo_plain, mandelbrot,
                                 mandelbrot_plain, matmul, matmul_plain, rap,
                                 rap_plain, raytrace, raytrace_plain,
                                 taylor_sin, taylor_sin_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run with -m cuda on the card")
    return torch.device("cuda:0")


def test_taylor_equals_plain(dev):
    x = torch.linspace(-3, 3, 100_003, device=dev)
    before = taylor_sin.launches
    got = taylor_sin(x)
    assert taylor_sin.launches == before + 1
    assert torch.equal(got, taylor_sin_plain(x))


@pytest.mark.parametrize("lo,hi", [(0, 0), (2, 0), (1, 2)])
def test_gaussian_equals_plain(dev, lo, hi):
    img = torch.randn(301, 257, device=dev)
    assert torch.equal(gaussian_blur_halo(img, lo_pad=lo, hi_pad=hi),
                       gaussian_blur_halo_plain(img, lo_pad=lo, hi_pad=hi))


@pytest.mark.parametrize("m,k,n", [(65, 129, 63), (1, 7, 300), (256, 64, 5)])
def test_matmul_close_to_plain(dev, m, k, n):
    a = torch.randn(m, k, device=dev)
    b = torch.randn(k, n, device=dev)
    torch.testing.assert_close(matmul(a, b), matmul_plain(a, b),
                               rtol=1e-5, atol=1e-6 * k)


def test_mandelbrot_equals_plain(dev):
    cim, cre = torch.meshgrid(torch.linspace(-1.4, 1.4, 333, device=dev),
                              torch.linspace(-2.2, 0.8, 517, device=dev),
                              indexing="ij")
    cre, cim = cre.contiguous(), cim.contiguous()
    assert torch.equal(mandelbrot(cre, cim), mandelbrot_plain(cre, cim))


@pytest.mark.parametrize("num", [8, 1, 300])
def test_raytrace_equals_plain(dev, num):
    """A 501 x 613 camera grid, so rays graze every sphere's silhouette."""
    dy, dx = torch.meshgrid(torch.linspace(-0.4, 0.4, 501, device=dev),
                            torch.linspace(-0.4, 0.4, 613, device=dev),
                            indexing="ij")
    dx, dy = dx.contiguous(), dy.contiguous()
    dz = torch.sqrt(torch.clamp_min(1 - dx * dx - dy * dy, 0.5))
    spheres = torch.from_numpy(demo_spheres(num, seed=5)).to(dev)
    before = raytrace.launches
    got = raytrace(dx, dy, dz, spheres)
    assert raytrace.launches == before + 1
    want = raytrace_plain(dx, dy, dz, spheres)
    assert torch.equal(got, want)
    assert int((want > 0).sum()) > 0        # the scene is in view


def test_raytrace_refuses_too_many_spheres(dev):
    x = torch.ones(4, device=dev)
    with pytest.raises(ValueError, match="at most"):
        raytrace(x, x, x, torch.ones(4096, 5, device=dev))


@pytest.mark.parametrize("n,L", [(1000, 48), (37, 1), (513, 100)])
def test_rap_close_to_plain(dev, n, L):
    values = torch.randn(n, L, device=dev)
    lengths = torch.randint(-3, L + 4, (n,), dtype=torch.int32, device=dev)
    before = rap.launches
    got = rap(values, lengths)
    assert rap.launches == before + 1
    torch.testing.assert_close(got, rap_plain(values, lengths),
                               rtol=1e-5, atol=1e-6 * L)


def test_rap_refuses_int64_lengths(dev):
    with pytest.raises(ValueError, match="int32"):
        rap(torch.ones(4, 3, device=dev),
            torch.ones(4, dtype=torch.int64, device=dev))


@pytest.mark.parametrize("memory", ["usm", "buffers"])
@pytest.mark.parametrize("name", ["taylor", "mandelbrot", "rap", "ray"])
def test_fused_engine_matches_unfused(dev, name, memory):
    """Eight same-shaped launches on [cuda:0, cpu], fused and unfused."""
    n, members = 4096, 8
    kernel = build_kernel(name)
    inputs = [kernel_demo_inputs(name, n, seed=i) for i in range(members)]
    outs = {}
    for fuse in (False, True):
        spec = (CoexecSpec.builder().policy("dynamic").memory(memory)
                .fuse(fuse, threshold=4096, limit=members, wait_s=5.0)
                .build())
        with CoexecEngine.from_spec(spec) as engine:
            handles = [engine.submit(spec.build_scheduler(n, 2), kernel, x,
                                     kernel.alloc_out(n, x))
                       for x in inputs]
            outs[fuse] = [h.result(timeout=120) for h in handles]
            fused = engine.admission.fused_batches
        assert fused == (1 if fuse and name != "ray" else 0)
    tol = {"rap": (1e-5, 1e-6 * 48)}.get(name, (0.0, 0.0))
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_allclose(a, b, rtol=tol[0], atol=tol[1])
    assert not dataplane._mapped


@pytest.mark.parametrize("memory", ["usm", "buffers"])
@pytest.mark.parametrize("name", ["taylor", "gaussian", "matmul",
                                  "mandelbrot", "ray", "rap"])
def test_coexecution_on_gpu_and_cpu(dev, name, memory):
    n = 4099
    inputs = kernel_demo_inputs(name, n, seed=1)
    kernel = build_kernel(name)
    with CoexecutorRuntime.from_spec(
            CoexecSpec.builder().policy("dyn16").memory(memory).build(),
            units=counits_from_devices(["cpu"])) as rt:
        want = rt.launch(n, kernel, inputs)
    spec = (CoexecSpec.builder().policy("dyn16").memory(memory)
            .pipeline_depth(2).build())
    with CoexecutorRuntime.from_spec(spec) as rt:
        got = rt.launch(n, kernel, inputs)
        stats = rt.last_stats
    assert set(stats.unit_busy_s) == {"cuda:0", "cpu"}
    # demo matmul inputs have K = 32, demo rap rows L = 48
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * (48 if name == "rap" else 32))
    served = {p.unit for p in stats.packages}
    assert 0 in served
    if memory == "usm":
        assert stats.data.h2d_copies == stats.data.d2h_copies == 0
    else:
        assert stats.data.d2h_copies == stats.num_packages
    assert not dataplane._mapped      # every mapped range was released
