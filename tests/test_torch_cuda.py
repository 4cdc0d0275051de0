"""The hand CUDA kernels and the [cuda:0, cpu] pair, on the card.

Every test here carries the ``cuda`` mark and skips without a GPU; on the
card run ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
The kernels build from ``src/repro_torch/kernels/csrc`` at first use.
Tolerances: taylor, gaussian and mandelbrot equal their plain versions
bit for bit (the kernels use the plain versions' IEEE operations in the
same order); matmul within rtol 1e-5, atol 1e-6 * K (FMA vs separate
multiply and add).
"""
import numpy as np
import pytest
import torch

from repro_torch.api import CoexecSpec, build_kernel, kernel_demo_inputs
from repro_torch.core import CoexecutorRuntime, counits_from_devices
from repro_torch.core import dataplane
from repro_torch.kernels import (gaussian_blur_halo, gaussian_blur_halo_plain,
                                 mandelbrot, mandelbrot_plain, matmul,
                                 matmul_plain, taylor_sin, taylor_sin_plain)

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


@pytest.mark.parametrize("memory", ["usm", "buffers"])
@pytest.mark.parametrize("name", ["taylor", "gaussian", "matmul",
                                  "mandelbrot"])
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
    # demo matmul inputs have K = 32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * 32)
    served = {p.unit for p in stats.packages}
    assert 0 in served
    if memory == "usm":
        assert stats.data.h2d_copies == stats.data.d2h_copies == 0
    else:
        assert stats.data.d2h_copies == stats.num_packages
    assert not dataplane._mapped      # every mapped range was released
