"""The hand CUDA kernels and the [cuda:0, cpu] pair, on the card.

Every test here carries the ``cuda`` mark and skips without a GPU; on the
card run ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
The kernels build from ``src/repro_torch/kernels/csrc`` at first use.
Tolerances: taylor, gaussian, mandelbrot and ray equal their plain
versions bit for bit (the kernels use the plain versions' IEEE operations
in the same order), and so does matmul (one fmaf per k in ascending k);
rap within rtol 1e-5, atol 1e-6 * L (another summation order).
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.api import CoexecSpec, build_kernel, kernel_demo_inputs
from repro_torch.core import (CoexecEngine, CoexecutorRuntime,
                              counits_from_devices)
from repro_torch.core import dataplane
from repro_torch.kernels.matmul import TILES
from repro_torch.kernels import (demo_spheres, flash_attention,
                                 flash_attention_plain, gaussian_blur_halo,
                                 gaussian_blur_halo_plain, linear_attention,
                                 linear_attention_plain, mandelbrot,
                                 mandelbrot_plain, matmul, matmul_plain, rap,
                                 rap_plain, raytrace, raytrace_plain,
                                 taylor_sin, taylor_sin_plain)

pytestmark = pytest.mark.cuda
matmul_mod = importlib.import_module("repro_torch.kernels.matmul")
la_mod = importlib.import_module("repro_torch.kernels.linear_attention")


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


def _same_bits(a, b):
    """Equal bit for bit, any NaN matching any NaN."""
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


def _taylor_inputs(dev, n=10_007):
    """[-3, 3] with f32's edges mixed in: zeros, subnormals, the smallest
    normal, overflowing terms (|x| 300-600), inf and NaN."""
    x = torch.linspace(-3, 3, n, device=dev)
    edges = torch.tensor([0.0, -0.0, 1e-45, -1e-40, 1.17549435e-38, 1e-20,
                          337.0, -450.0, 591.0, 1e19, 3.4e38,
                          float("inf"), float("-inf"), float("nan")],
                         device=dev)
    x[::97][:edges.numel()] = edges
    return x


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("same_offset", [False, True])
def test_taylor_equals_plain_on_offset_views(dev, offset, same_offset):
    """Package views start at any item. x at element offset 1-3 with a
    fresh out (x and out misaligned against each other: element by
    element) or an out at the same offset (peeled to a 16-byte boundary,
    then 16-byte accesses)."""
    base = _taylor_inputs(dev)
    x = base[offset:]
    out = torch.empty_like(base)[offset:] if same_offset else None
    got = taylor_sin(x, out=out)
    assert _same_bits(got, taylor_sin_plain(x))


def test_taylor_runtime_terms_equal_plain(dev):
    """A term count other than the main path's 12 runs the runtime-loop
    kernel."""
    x = _taylor_inputs(dev)
    before = taylor_sin.launches
    got = taylor_sin(x, terms=5)
    assert taylor_sin.launches == before + 1
    assert _same_bits(got, taylor_sin_plain(x, terms=5))


@pytest.mark.parametrize("lo,hi", [(0, 0), (2, 0), (1, 2)])
def test_gaussian_equals_plain(dev, lo, hi):
    img = torch.randn(301, 257, device=dev)
    assert torch.equal(gaussian_blur_halo(img, lo_pad=lo, hi_pad=hi),
                       gaussian_blur_halo_plain(img, lo_pad=lo, hi_pad=hi))


@pytest.mark.parametrize("tile", [None, *TILES])
@pytest.mark.parametrize("m,k,n,offset", [
    (65, 129, 63, 0), (1, 7, 300, 0), (256, 64, 5, 0),
    (1, 129, 300, 0), (50, 129, 300, 0), (127, 129, 300, 0),
    (129, 129, 300, 0), (1024, 129, 300, 0), (129, 33, 301, 0),
    (129, 129, 300, 1),
])
def test_matmul_close_to_plain(dev, monkeypatch, m, k, n, offset, tile):
    """Bit for bit: one fmaf per k in ascending k, as the plain version.

    ``tile`` forces each block tile the kernel has (None: ``tile_for``'s
    own pick); ``offset`` shifts B by one float, so its rows lose their
    16-byte alignment and the kernel takes its 4-byte copies.
    """
    if tile is not None:
        monkeypatch.setattr(matmul_mod, "tile_for", lambda *_: tile)
    a = torch.randn(m, k, device=dev)
    b = torch.randn(k * n + offset, device=dev)[offset:].view(k, n)
    before = matmul.launches
    got = matmul(a, b)
    assert matmul.launches == before + 1
    torch.testing.assert_close(got, matmul_plain(a, b), rtol=0, atol=0)


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


# -- the LM stack's kernels: flash attention and linear attention ---------
# Tolerances (stated in the kernel modules): f32 within 2e-5 (flash) and
# 3e-4 (linear attention, the reference's chunked-vs-sequential bound);
# bf16 outputs within 2e-2: a bf16 ulp or two (flash rounds P to bf16
# before P V on the tensor cores; linear attention rounds the same f32
# value).

def _lm_tol(dtype, f32_tol):
    return (f32_tol, f32_tol) if dtype == torch.float32 else (2e-2, 2e-2)


@pytest.mark.parametrize("b,hq,hkv,t,d,causal,window,dtype", [
    (1, 4, 4, 200, 112, True, None, torch.float32),
    (2, 4, 2, 130, 64, True, 32, torch.float32),
    (1, 8, 1, 77, 16, False, None, torch.float32),
    (1, 2, 2, 1500, 64, False, None, torch.float32),
    (1, 4, 4, 300, 128, False, 48, torch.bfloat16),
    (2, 8, 8, 256, 112, True, 100, torch.bfloat16),
    # bf16 runs on the tensor cores: every padded head dim, ragged T,
    # GQA 8/1, a window shorter than a key tile
    (1, 4, 4, 77, 16, True, None, torch.bfloat16),
    (2, 4, 2, 200, 64, True, None, torch.bfloat16),
    (1, 2, 2, 1500, 64, False, None, torch.bfloat16),
    (1, 4, 4, 200, 72, True, None, torch.bfloat16),
    (1, 4, 4, 200, 72, False, 40, torch.bfloat16),
    (1, 8, 1, 200, 112, True, None, torch.bfloat16),
    (1, 8, 1, 77, 128, False, None, torch.bfloat16),
    (2, 4, 4, 200, 128, True, 20, torch.bfloat16),
    (1, 4, 2, 130, 40, False, 20, torch.bfloat16),
    (1, 2, 2, 100, 33, True, None, torch.bfloat16),   # 2-byte copies
])
def test_flash_attention_close_to_plain(dev, b, hq, hkv, t, d, causal,
                                        window, dtype):
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn(b, hq, t, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, hkv, t, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, hkv, t, d, generator=g, device=dev).to(dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    rtol, atol = _lm_tol(dtype, 2e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_one_key_rows_copy_v(dev, dtype):
    """Causal with window = 1: each row reaches exactly its own key, the
    fewest a row can reach (with Tq == Tk and window >= 1 no row reaches
    none), so its output is that key's v row, bit for bit."""
    g = torch.Generator(device=dev).manual_seed(14)
    q, k, v = (torch.randn(1, 4, 150, 64, generator=g, device=dev)
               .to(dtype) for _ in range(3))
    got = flash_attention(q, k, v, causal=True, window=1)
    assert torch.equal(got, v)


@pytest.mark.parametrize("bh,t,dk,dv,dtype,tile", [
    (3, 200, 16, 16, torch.float32, None),
    (3, 64, 32, 48, torch.float32, None),
    (4, 333, 64, 64, torch.float32, None),
    (2, 130, 128, 40, torch.float32, None),
    (2, 256, 64, 64, torch.bfloat16, None),
    # bf16 runs on the tensor cores: ragged T, padded Dk and Dv, Dv tiles
    # of 32 (Dk 128, or forced) and 64, 2-byte copies, many heads
    (3, 40, 64, 64, torch.bfloat16, None),
    (3, 333, 64, 64, torch.bfloat16, None),
    (2, 200, 16, 64, torch.bfloat16, None),
    (2, 200, 128, 64, torch.bfloat16, None),
    (2, 200, 64, 40, torch.bfloat16, None),
    (2, 100, 20, 33, torch.bfloat16, None),
    (3, 333, 64, 64, torch.bfloat16, 64),
    (2, 200, 32, 100, torch.bfloat16, 64),
    (2, 200, 32, 100, torch.bfloat16, 32),
    (264, 128, 64, 64, torch.bfloat16, None),
])
def test_linear_attention_close_to_plain(dev, monkeypatch, bh, t, dk, dv,
                                         dtype, tile):
    if tile is not None:
        monkeypatch.setattr(la_mod, "dv_tile_for", lambda *a, **kw: tile)
    g = torch.Generator(device=dev).manual_seed(12)
    q = torch.randn(bh, t, dk, generator=g, device=dev).to(dtype)
    k = (0.2 * torch.randn(bh, t, dk, generator=g, device=dev)).to(dtype)
    v = torch.randn(bh, t, dv, generator=g, device=dev).to(dtype)
    ld = -(0.1 * torch.randn(bh, t, generator=g, device=dev)).abs()
    before = linear_attention.launches
    got = linear_attention(q, k, v, ld)
    assert linear_attention.launches == before + 1
    want = linear_attention_plain(q, k, v, ld)
    rtol, atol = _lm_tol(dtype, 3e-4)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    if dtype == torch.bfloat16:
        # chip_smoke.py's LINEAR_ROW_REL: a dropped chunk state shows here
        row_rel = ((got.float() - want.float()).norm(dim=-1)
                   / want.float().norm(dim=-1))
        assert float(row_rel.max()) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_attention_steep_decays_stay_finite(dev, dtype):
    """Mamba-2-like decays: the cumulative log-decay falls below -100
    within one chunk, where a growth exp(cum_i - cum_j), i < j, is inf."""
    g = torch.Generator(device=dev).manual_seed(13)
    bh, t, dk, dv = 4, 256, 64, 64
    q = torch.randn(bh, t, dk, generator=g, device=dev).to(dtype)
    k = torch.randn(bh, t, dk, generator=g, device=dev).to(dtype)
    v = torch.randn(bh, t, dv, generator=g, device=dev).to(dtype)
    ld = -4.0 * torch.rand(bh, t, generator=g, device=dev)
    got = linear_attention(q, k, v, ld)
    assert bool(torch.isfinite(got).all())
    rtol, atol = _lm_tol(dtype, 3e-4)
    torch.testing.assert_close(got.float(),
                               linear_attention_plain(q, k, v, ld).float(),
                               rtol=rtol, atol=atol)


def test_lm_kernels_refuse_other_dtypes(dev):
    x = torch.ones(1, 2, 8, 16, dtype=torch.float16, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(x, x, x)
    q = torch.ones(1, 2, 8, 16, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(*(torch.ones(1, 1, 4, 192, device=dev),) * 3)
    a = torch.ones(2, 8, 16, device=dev)
    with pytest.raises(ValueError, match="float32"):
        linear_attention(a, a, a, torch.zeros(2, 8, dtype=torch.float64,
                                               device=dev))


def test_lm_kernels_never_run_the_plain_version_on_cuda(dev, monkeypatch):
    # the package exports the wrappers under the modules' own names
    fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")

    def refuse(*args, **kwargs):
        raise AssertionError("plain version ran on a CUDA tensor")

    monkeypatch.setattr(fa_mod, "flash_attention_plain", refuse)
    monkeypatch.setattr(la_mod, "linear_attention_plain", refuse)
    x = torch.randn(1, 2, 64, 32, device=dev)
    assert fa_mod.flash_attention(x, x, x).shape == x.shape
    a = torch.randn(2, 64, 16, device=dev)
    ld = torch.zeros(2, 64, device=dev)
    assert la_mod.linear_attention(a, a, a, ld).shape == a.shape
