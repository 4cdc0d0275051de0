"""The hand CUDA kernels and the [cuda:0, cpu] pair, on the card.

Every test here carries the ``cuda`` mark and skips without a GPU; on the
card run ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
The kernels build from ``src/repro_torch/kernels/csrc`` at first use.
Tolerances: taylor, gaussian, mandelbrot and ray equal their plain
versions bit for bit (the kernels use the plain versions' IEEE operations
in the same order), and so does matmul (one fmaf per k in ascending k);
rap within rtol 1e-5, atol 1e-6 * L (another summation order).
"""
import dataclasses
import functools
import importlib
import pathlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.api import CoexecSpec, build_kernel, kernel_demo_inputs
from repro_torch.core import (ArgRole, CoexecEngine, CoexecutorRuntime,
                              MemoryModel, counits_from_devices)
from repro_torch.core import dataplane
from repro_torch.kernels.matmul import TILES
from repro_torch.kernels import (decode_attention, decode_attention_plain,
                                 demo_spheres, flash_attention,
                                 flash_attention_plain, gaussian_blur_halo,
                                 gaussian_blur_halo_plain, linear_attention,
                                 linear_attention_plain, mandelbrot,
                                 mandelbrot_plain, matmul, matmul_plain, rap,
                                 rap_plain, raytrace, raytrace_plain,
                                 taylor_sin, taylor_sin_plain)

from repro_torch.configs import get_config
from repro_torch.models import build_model

pytestmark = pytest.mark.cuda
model_mod = importlib.import_module("repro_torch.models.model")
matmul_mod = importlib.import_module("repro_torch.kernels.matmul")
la_mod = importlib.import_module("repro_torch.kernels.linear_attention")
da_mod = importlib.import_module("repro_torch.kernels.decode_attention")


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


def _mandelbrot_points(n, dev, seed=5):
    """n points over the classic viewport, every 7th a point with |c| up
    to 1e30, whose z overflows to inf and then NaN while the warp runs
    on."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cre = torch.rand(n, generator=g, device=dev) * 3.0 - 2.2
    cim = torch.rand(n, generator=g, device=dev) * 2.8 - 1.4
    big = torch.tensor([1e30, -3e29, 2.5, 1e19, -1e30, 0.3], device=dev)
    sel = torch.arange(0, n, 7, device=dev)
    cre[sel] = big[sel % 6]
    cim[sel] = big.flip(0)[sel % 6]
    return cre, cim


@pytest.mark.parametrize("max_iter", [0, 1, 7, 64, 100])
@pytest.mark.parametrize("n", [1, 31, 33, 257, 10**5 + 3])
def test_mandelbrot_equals_plain_for_every_budget(dev, n, max_iter):
    """Sticky counts, U-step groups and the warp vote: ragged last warps,
    budgets below, at and off multiples of the unroll, overflowing z."""
    cre, cim = _mandelbrot_points(n, dev)
    before = mandelbrot.launches
    got = mandelbrot(cre, cim, max_iter=max_iter)
    assert mandelbrot.launches == before + 1
    torch.testing.assert_close(
        got, mandelbrot_plain(cre, cim, max_iter=max_iter), rtol=0, atol=0)


@pytest.mark.parametrize("offset", [1, 3])
def test_mandelbrot_equals_plain_on_views_into_an_out_slice(dev, offset):
    """Package views at odd element offsets, written into a slice of a
    larger output, as the data plane hands them over."""
    cre, cim = _mandelbrot_points(5003, dev)
    a, b = cre[offset:offset + 4001], cim[offset + 2:offset + 4003]
    out = torch.full((a.numel() + 10,), -1.0, device=dev)
    before = mandelbrot.launches
    got = mandelbrot(a, b, out=out[5:5 + a.numel()])
    assert mandelbrot.launches == before + 1
    torch.testing.assert_close(got, mandelbrot_plain(a, b), rtol=0, atol=0)
    assert bool((out[:5] == -1).all()) and bool((out[-5:] == -1).all())


@pytest.mark.parametrize("w", [1, 3, 4, 5, 127, 128, 129, 516, 5120])
@pytest.mark.parametrize("lo,hi", [(0, 0), (2, 2), (1, 0)])
def test_gaussian_equals_plain_for_every_width(dev, w, lo, hi):
    """Strips of 128 columns with their halo, 16-byte accesses when W % 4
    is 0 and 4-byte ones otherwise, runs of rows walked down and up."""
    rows = 21 if w == 5120 else 301
    img = torch.randn(rows, w, device=dev)
    before = gaussian_blur_halo.launches
    got = gaussian_blur_halo(img, lo_pad=lo, hi_pad=hi)
    assert gaussian_blur_halo.launches == before + 1
    torch.testing.assert_close(
        got, gaussian_blur_halo_plain(img, lo_pad=lo, hi_pad=hi), rtol=0,
        atol=0)


@pytest.mark.parametrize("w", [4, 128, 516])
@pytest.mark.parametrize("shift", ["src", "out", "both"])
def test_gaussian_misaligned_by_one_float_equals_plain(dev, w, shift):
    """A source or an output one float off a 16-byte boundary takes the
    4-byte path, even when W % 4 is 0."""
    rows = 67
    base = torch.randn(rows * w + 1, device=dev)
    img = base[1:].view(rows, w) if shift in ("src", "both") else \
        base[:-1].view(rows, w)
    flat = torch.empty((rows - 4) * w + 1, device=dev)
    out = flat[1:].view(rows - 4, w) if shift in ("out", "both") else \
        flat[:-1].view(rows - 4, w)
    before = gaussian_blur_halo.launches
    got = gaussian_blur_halo(img, out=out)
    assert gaussian_blur_halo.launches == before + 1
    torch.testing.assert_close(got, gaussian_blur_halo_plain(img), rtol=0,
                               atol=0)


@pytest.mark.parametrize("w", [516, 5120, 129])
def test_gaussian_row_offset_packages_equal_the_whole_image(dev, w):
    """USM packages: row-offset views of the whole image, with 2 context
    rows where they exist and the missing ones as pads, into row slices of
    one output; together they equal the whole image's blur."""
    h = 203
    img = torch.randn(h, w, device=dev)
    want = gaussian_blur_halo_plain(img, lo_pad=2, hi_pad=2)
    out = torch.full_like(img, float("nan"))
    before = gaussian_blur_halo.launches
    for r0, r1 in ((0, 1), (1, 37), (37, 38), (38, 200), (200, 203)):
        lo, hi = max(0, r0 - 2), min(h, r1 + 2)
        gaussian_blur_halo(img[lo:hi], lo_pad=2 - (r0 - lo),
                           hi_pad=2 - (hi - r1), out=out[r0:r1])
    assert gaussian_blur_halo.launches == before + 5
    torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["mandelbrot", "gaussian"])
def test_kernels_on_mapped_host_memory_equal_plain(dev, name):
    """USM hands the kernels mapped host memory, which takes its own launch
    shape: a chunk of 32 points per warp past the grid device memory gets
    (300,007 points), runs of 64 rows in place of 16."""
    rng = np.random.default_rng(4)
    if name == "mandelbrot":
        n = 300_007
        arrays = [rng.uniform(-2.2, 0.8, n).astype(np.float32),
                  rng.uniform(-1.4, 1.4, n).astype(np.float32),
                  np.zeros(n, np.float32)]
        fn, plain = mandelbrot, mandelbrot_plain
    else:
        arrays = [rng.normal(size=(203, 516)).astype(np.float32),
                  np.zeros((199, 516), np.float32)]
        fn, plain = gaussian_blur_halo, gaussian_blur_halo_plain
    maps = [dataplane._map_host(a, dev) for a in arrays]
    try:
        before = fn.launches
        fn(*(m for m, _ in maps[:-1]), out=maps[-1][0])
        torch.cuda.synchronize()
        assert fn.launches == before + 1
    finally:
        for _, starts in maps:
            dataplane._unmap_host(starts)
    want = plain(*(torch.from_numpy(a).to(dev) for a in arrays[:-1]))
    np.testing.assert_array_equal(arrays[-1], want.cpu().numpy())
    assert not dataplane._mapped


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


def _rays(n, dev, offset=0, seed=7):
    """n unit rays over the camera's field, each component at a float
    offset into its own buffer."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dx, dy = (torch.rand(n, generator=g, device=dev) * 0.8 - 0.4
              for _ in range(2))
    dz = torch.sqrt(torch.clamp_min(1 - dx * dx - dy * dy, 0.5))
    bufs = [torch.empty(n + offset, device=dev) for _ in range(3)]
    for buf, a in zip(bufs, (dx, dy, dz)):
        buf[offset:] = a
    return [buf[offset:] for buf in bufs]


@pytest.mark.parametrize("same_offset", [False, True])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 3, 4099])
@pytest.mark.parametrize("num", [1, 7, 8, 9, 300, 2048])
def test_raytrace_equals_plain_for_every_scene(dev, num, n, offset,
                                                same_offset):
    """The main path's scene size (8, unrolled) and the runtime loop (up to
    2048 spheres, a 64 KB table), n below, at and off a multiple of 4,
    rays at a float offset of 0-3 with out at the same offset (peeled to
    a 16-byte boundary) or fresh (misaligned against them: ray by ray)."""
    rays = _rays(n, dev, offset)
    spheres = torch.from_numpy(demo_spheres(num, seed=5)).to(dev)
    out = (torch.empty(n + offset, device=dev)[offset:] if same_offset
           else None)
    before = raytrace.launches
    got = raytrace(*rays, spheres, out=out)
    assert raytrace.launches == before + 1
    assert torch.equal(got, raytrace_plain(*rays, spheres))


def _rap_inputs(n, L, offset, dev, seed=3):
    """An (n, L) row slice at a float offset, lengths below 0, 0, 1-3, L
    and above L among random ones."""
    g = torch.Generator(device=dev).manual_seed(seed)
    values = torch.randn(n * L + offset, generator=g, device=dev)[
        offset:].view(n, L)
    lengths = torch.randint(-3, L + 4, (n,), generator=g, device=dev,
                            dtype=torch.int32)
    lengths[:9] = torch.tensor([-4, 0, 1, 2, 3, L, L + 1, L + 9,
                                max(L - 1, 0)], device=dev)
    return values, lengths


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("L", [1, 3, 4, 47, 48, 100])
def test_rap_close_to_plain_for_every_width(dev, L, offset):
    """16-byte chunks (L % 4 == 0 and an aligned row slice) or 4-byte ones,
    rows within and past the chunks a lane loads up front (L = 100), a
    ragged last warp of rows; out a slice at the same offset."""
    n = 1000 + 37
    values, lengths = _rap_inputs(n, L, offset, dev)
    out = torch.empty(n + offset, device=dev)[offset:]
    before = rap.launches
    got = rap(values, lengths, out=out)
    assert rap.launches == before + 1
    torch.testing.assert_close(got, rap_plain(values, lengths), rtol=1e-5,
                               atol=1e-6 * L)
    assert bool((got[:2] == 0).all())


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("case", ["ray 8", "ray 9", "rap 48", "rap 47"])
def test_ray_and_rap_on_mapped_host_memory(dev, case, offset):
    """USM hands ray and rap mapped host memory (ray keeps its launch
    shape there, rap takes kSegmentHost-lane segments): arrays at a float
    offset of 0 or 1, rays equal to the plain version bit for bit, rap
    within its tolerance."""
    name, size = case.split()
    size = int(size)
    if name == "ray":
        dev_in = [*_rays(4099, dev, offset),
                  torch.from_numpy(demo_spheres(size, seed=5)).to(dev)]
        fn, plain, tol = raytrace, raytrace_plain, (0.0, 0.0)
    else:
        dev_in = list(_rap_inputs(2053, size, offset, dev))
        fn, plain, tol = rap, rap_plain, (1e-5, 1e-6 * size)
    want = plain(*dev_in)
    host = []
    for a in [*dev_in, want]:                # out: want's shape
        buf = np.empty(a.numel() + offset,
                       np.int32 if a.dtype == torch.int32 else np.float32)
        view = buf[offset:].reshape(tuple(a.shape))
        view[...] = a.cpu().numpy()
        host.append(view)
    host[-1][...] = np.nan
    maps = [dataplane._map_host(a, dev) for a in host]
    try:
        before = fn.launches
        fn(*(m for m, _ in maps[:-1]), out=maps[-1][0])
        torch.cuda.synchronize()
        assert fn.launches == before + 1
    finally:
        for _, starts in maps:
            dataplane._unmap_host(starts)
    np.testing.assert_allclose(host[-1], want.cpu().numpy(), rtol=tol[0],
                               atol=tol[1])
    assert not dataplane._mapped


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
    """The [cuda:0, cpu] pair at pipeline depth 2 equals the CPU unit
    alone, under dyn16 and under static; under static each unit owns half
    the range, so the CUDA unit serves a package by construction. (dyn16
    hands each package to whichever worker pulls first, and a CPU unit
    can drain all 16 of a 4099-item launch before the CUDA unit's worker
    pulls one, so who serves there is not asserted.)"""
    n = 4099
    inputs = kernel_demo_inputs(name, n, seed=1)
    kernel = build_kernel(name)
    with CoexecutorRuntime.from_spec(
            CoexecSpec.builder().policy("dyn16").memory(memory).build(),
            units=counits_from_devices(["cpu"])) as rt:
        want = rt.launch(n, kernel, inputs)
    for policy in ("dyn16", "static"):
        spec = (CoexecSpec.builder().policy(policy).memory(memory)
                .pipeline_depth(2).build())
        with CoexecutorRuntime.from_spec(spec) as rt:
            got = rt.launch(n, kernel, inputs)
            stats = rt.last_stats
        assert set(stats.unit_busy_s) == {"cuda:0", "cpu"}
        # demo matmul inputs have K = 32, demo rap rows L = 48
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * (48 if name == "rap" else 32),
                                   err_msg=policy)
        if policy == "static":
            served = {p.unit for p in stats.packages}
            assert 0 in served
            assert 1 in served
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
    # h2o-danube3-4b's D 120 under a window, internvl2-1b's 14 q heads on
    # 2 kv heads (G = 7, odd), minicpm-2b's D 64 MHA
    (1, 4, 1, 700, 120, True, 256, torch.bfloat16),
    (1, 4, 1, 300, 120, True, 100, torch.float32),
    (2, 14, 2, 333, 64, True, None, torch.bfloat16),
    (1, 14, 2, 200, 64, True, None, torch.float32),
    (1, 6, 6, 257, 64, True, None, torch.bfloat16),
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
    # Dk > 128 takes the two-pass wide path in either dtype: xLSTM's Dk
    # 1024 with Dv 1025 (the normaliser's column), ragged T, Dk 129
    (2, 200, 1024, 1025, torch.float32, None),
    (2, 200, 1024, 1025, torch.bfloat16, None),
    (3, 130, 256, 257, torch.float32, None),
    (2, 64, 129, 40, torch.bfloat16, None),
    # the wide path at one head: bf16 on the tensor cores over a cluster of
    # key slices (129: two ranks, the second one key wide; 1000: a partial
    # last slice), Dv with a one-column tail (1025), 2-byte V rows (1025),
    # 16-byte rows (1024, 1032, 40), a tail warp (40); T of one step, one
    # chunk, one step past it, ragged; f32 on the CUDA cores
    *[(1, t, dk, dv, torch.bfloat16, None) for dk in (129, 1000, 1024)
      for dv in (1024, 1025, 1032, 40) for t in (1, 64, 65, 200)],
    *[(1, t, dk, dv, torch.float32, None) for dk in (129, 1000, 1024)
      for dv in (1025, 40) for t in (1, 65)],
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
@pytest.mark.parametrize("dk,dv", [(64, 64), (1024, 1025)])
def test_linear_attention_steep_decays_stay_finite(dev, dtype, dk, dv):
    """Mamba-2-like decays: the cumulative log-decay falls below -100
    within one chunk, where a growth exp(cum_i - cum_j), i < j, is inf;
    also on the wide path (xlstm-1.3b's Dk 1024, Dv 1025). Keys are
    scaled by (64 / Dk)^1/2, so q . k keeps Dk 64's spread, as the mLSTM
    scales its keys by Dk^-1/2."""
    g = torch.Generator(device=dev).manual_seed(13)
    bh, t = 4, 256
    q = torch.randn(bh, t, dk, generator=g, device=dev).to(dtype)
    k = (torch.randn(bh, t, dk, generator=g, device=dev)
         * (64 / dk) ** 0.5).to(dtype)
    v = torch.randn(bh, t, dv, generator=g, device=dev).to(dtype)
    ld = -4.0 * torch.rand(bh, t, generator=g, device=dev)
    got = linear_attention(q, k, v, ld)
    assert bool(torch.isfinite(got).all())
    rtol, atol = _lm_tol(dtype, 3e-4)
    torch.testing.assert_close(got.float(),
                               linear_attention_plain(q, k, v, ld).float(),
                               rtol=rtol, atol=atol)


def _linear_attention_f64(q, k, v, log_decay):
    """The plain version's sequential recurrence in f64 (the reference
    value the f32 kernel and plain version are both held to)."""
    qd, kd, vd = q.double(), k.double(), v.double()
    decay = torch.exp(log_decay.double())
    S = torch.zeros(q.shape[0], q.shape[2], v.shape[2], dtype=torch.float64,
                    device=q.device)
    out = torch.empty(*v.shape, dtype=torch.float64, device=q.device)
    for t in range(q.shape[1]):
        S = decay[:, t, None, None] * S + kd[:, t, :, None] * vd[:, t, None, :]
        out[:, t] = torch.einsum("bk,bkv->bv", qd[:, t], S)
    return out


@pytest.mark.parametrize("dk,dv", [(64, 64), (1024, 1025)])
def test_linear_attention_f32_unscaled_keys_against_f64(dev, dk, dv):
    """Steep decays at unscaled keys (the inputs of
    ``test_linear_attention_steep_decays_stay_finite`` before its keys are
    scaled; at Dk 1024, q . k is about 32 and outputs reach the hundreds):
    the f32 kernel (the chunk form, its decays exp(cum_i - cum_j) from a
    chunk's prefix sums, which reach -256) and the f32 plain version (the
    sequential recurrence) are both held to an f64 run of the recurrence,
    and the kernel's largest error of an element, and of a row (relative
    L2), must be within twice the plain version's. The two forms sum in
    other orders, so either may be the closer one; decays formed from f32
    prefix sums, or a dot product over the 1024 keys in one accumulator,
    put the kernel 3-22x further."""
    g = torch.Generator(device=dev).manual_seed(13)
    bh, t = 4, 256
    q = torch.randn(bh, t, dk, generator=g, device=dev)
    k = torch.randn(bh, t, dk, generator=g, device=dev)
    v = torch.randn(bh, t, dv, generator=g, device=dev)
    ld = -4.0 * torch.rand(bh, t, generator=g, device=dev)
    exact = _linear_attention_f64(q, k, v, ld)
    got = linear_attention(q, k, v, ld).double()
    plain = linear_attention_plain(q, k, v, ld).double()

    def errors(x):
        diff = (x - exact).abs()
        row = (x - exact).norm(dim=-1) / exact.norm(dim=-1)
        return float(diff.max()), float(row.max())

    (k_abs, k_row), (p_abs, p_row) = errors(got), errors(plain)
    print(f"f32 Dk {dk} Dv {dv} vs f64: kernel max abs {k_abs:.3e}, row "
          f"rel {k_row:.3e}; plain max abs {p_abs:.3e}, row rel "
          f"{p_row:.3e}; max |out| {float(exact.abs().max()):.2f}")
    assert k_abs <= 2 * p_abs and k_row <= 2 * p_row


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_attention_wide_path_repeats_its_bits(dev, dtype):
    """Two launches on the same inputs give the same bits: the wide path
    sums the key slices' partials in rank order, with no atomics (xlstm-1.3b
    amplifies one rounding into its logits, and chip_smoke.py's prefill
    gates read one launch)."""
    g = torch.Generator(device=dev).manual_seed(15)
    bh, t, dk, dv = 4, 200, 1024, 1025
    q = torch.randn(bh, t, dk, generator=g, device=dev).to(dtype)
    k = (torch.randn(bh, t, dk, generator=g, device=dev)
         * dk ** -0.5).to(dtype)
    v = torch.randn(bh, t, dv, generator=g, device=dev).to(dtype)
    ld = torch.nn.functional.logsigmoid(
        torch.randn(bh, t, generator=g, device=dev))
    first = linear_attention(q, k, v, ld)
    assert torch.equal(linear_attention(q, k, v, ld), first)


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
    w = torch.ones(2, 8, 1025, device=dev)
    with pytest.raises(ValueError, match="key dim"):
        linear_attention(w, w, w, torch.zeros(2, 8, device=dev))


def test_lm_kernels_never_run_the_plain_version_on_cuda(dev, monkeypatch):
    # the package exports the wrappers under the modules' own names
    fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")

    def refuse(*args, **kwargs):
        raise AssertionError("plain version ran on a CUDA tensor")

    monkeypatch.setattr(fa_mod, "flash_attention_plain", refuse)
    monkeypatch.setattr(la_mod, "linear_attention_plain", refuse)
    monkeypatch.setattr(da_mod, "decode_attention_plain", refuse)
    x = torch.randn(1, 2, 64, 32, device=dev)
    assert fa_mod.flash_attention(x, x, x).shape == x.shape
    a = torch.randn(2, 64, 16, device=dev)
    ld = torch.zeros(2, 64, device=dev)
    assert la_mod.linear_attention(a, a, a, ld).shape == a.shape
    q = torch.randn(1, 2, 1, 32, device=dev)
    assert da_mod.decode_attention(q, x, x, 63).shape == q.shape


# (B, Hkv, G, S, D, window, pos, q dtype, ring dtype, scale): the zamba2
# cell's shape at its two ends of a launch, a wrapped sliding-window ring
# (h2o-danube3-4b's D 120, G 4), GQA (qwen3-0.6b's 16 q heads on 8), D 112
# (zamba2-7b), D 64 with G 7 (internvl2-1b), G 16 (qwen3-moe's 64 q heads
# on 4), the sliced path (B 1, Hkv 8, 32,768 slots: full, and a ring a
# sixth full, so most slices are empty), and f32 rings (with f32 and with
# bf16 queries) and f32 queries on bf16 rings (an f32 model's default
# cache)
DECODE_CASES = [
    (32, 32, 1, 1056, 224, None, 1024, "bfloat16", "bfloat16", 112 ** -0.5),
    (32, 32, 1, 1056, 224, None, 1055, "bfloat16", "bfloat16", 112 ** -0.5),
    (2, 8, 4, 256, 120, 256, 1000, "bfloat16", "bfloat16", None),
    (2, 8, 4, 300, 120, 100, 777, "bfloat16", "bfloat16", None),
    (4, 8, 2, 512, 128, None, 300, "bfloat16", "bfloat16", None),
    (3, 32, 1, 200, 112, None, 150, "bfloat16", "bfloat16", None),
    (2, 2, 7, 333, 64, None, 332, "bfloat16", "bfloat16", None),
    (2, 4, 16, 260, 128, None, 259, "bfloat16", "bfloat16", None),
    (1, 8, 2, 32768, 128, None, 32767, "bfloat16", "bfloat16", None),
    (1, 8, 2, 32768, 128, None, 5000, "bfloat16", "bfloat16", None),
    (2, 4, 1, 300, 224, None, 299, "float32", "float32", 112 ** -0.5),
    (2, 4, 3, 1000, 64, 64, 4321, "float32", "float32", None),
    (1, 8, 2, 32768, 128, None, 20000, "float32", "float32", None),
    (2, 4, 4, 300, 120, None, 299, "bfloat16", "float32", None),
    (2, 4, 4, 300, 128, None, 299, "float32", "bfloat16", None),
]


@pytest.mark.parametrize("on_device", [False, True])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_close_to_plain(dev, case, on_device):
    """The kernel against ``decode_attention_plain`` on the same tensors,
    with ``pos`` a Python int or a 0-dim tensor on the card: f32 outputs
    within rtol = atol = 1e-5 (another order of summation), bf16 outputs
    within one bf16 ulp (``chip_smoke.within_bf16_ulp``, which takes the
    ulp at no less than 2^-8 of the row's largest value: the f32 sums'
    error is at the scale of the row's terms); two calls bit for bit; one
    launch a call. Every
    slot of the rings holds data, so a slot past ``pos`` or outside the
    window that the kernel read would show."""
    B, Hkv, G, S, D, window, pos, qname, rname, scale = case
    qt, rt = getattr(torch, qname), getattr(torch, rname)
    g = torch.Generator(device=dev).manual_seed(31)
    q = torch.randn(B, Hkv, G, D, generator=g, device=dev).to(qt)
    k, v = (torch.randn(B, Hkv, S, D, generator=g, device=dev).to(rt)
            for _ in range(2))
    at = torch.tensor(pos, device=dev) if on_device else pos
    before = decode_attention.launches
    got = decode_attention(q, k, v, at, scale=scale, window=window)
    assert decode_attention.launches == before + 1
    again = decode_attention(q, k, v, at, scale=scale, window=window)
    want = decode_attention_plain(q, k, v, pos, scale=scale, window=window)
    assert got.dtype == want.dtype == qt and got.shape == q.shape
    assert torch.equal(got, again)
    if qt == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
        import chip_smoke

        assert chip_smoke.within_bf16_ulp(got, want)


def test_decode_attention_replays_in_a_graph_at_each_position(dev):
    """Captured once with ``pos`` a 0-dim tensor on the card, a replay
    reads the position the tensor holds then: replays at positions before
    and after the ring wraps equal eager calls bit for bit, on the one-pass
    and on the sliced path."""
    g = torch.Generator(device=dev).manual_seed(37)
    for B, Hkv, G, S, D in [(32, 32, 1, 1056, 224), (1, 8, 2, 4096, 128)]:
        q = torch.randn(B, Hkv, G, D, generator=g, device=dev).bfloat16()
        k, v = (torch.randn(B, Hkv, S, D, generator=g, device=dev)
                .bfloat16() for _ in range(2))
        pos = torch.zeros((), dtype=torch.int64, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            decode_attention(q, k, v, pos)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = decode_attention(q, k, v, pos)
        for p in (0, 7, S // 2, S - 1, S, 3 * S + 11):
            pos.fill_(p)
            graph.replay()
            assert torch.equal(out, decode_attention(q, k, v, p)), (S, p)


def test_decode_attention_refuses_on_the_card(dev):
    q = torch.zeros(1, 2, 1, 64, device=dev, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="q must be float32 or bfloat16"):
        decode_attention(q.half(), k, k, 3)
    with pytest.raises(ValueError, match="head dim 260"):
        decode_attention(torch.zeros(1, 2, 1, 260, device=dev),
                         *(torch.zeros(1, 2, 8, 260, device=dev),) * 2, 3)
    odd = torch.zeros(k.numel() + 1, device=dev,
                      dtype=torch.bfloat16)[1:].view(k.shape)
    with pytest.raises(ValueError, match="16-byte boundary"):
        decode_attention(q, odd, k, 3)
    with pytest.raises(ValueError, match="0-dim int64"):
        decode_attention(q, k, k, torch.tensor(3, dtype=torch.int32,
                                               device=dev))
    with pytest.raises(ValueError, match="pos must be >= 0"):
        decode_attention(q, k, k, -1)


# -- the serve CLI's real mode and the cluster tier on [cuda:0, cpu] ------

SERVE_TOL = {"taylor": (1e-5, 1e-6), "gaussian": (1e-5, 1e-6),
             "matmul": (1e-5, 1e-6 * 32), "mandelbrot": (0.0, 0.0),
             "ray": (0.0, 1e-4), "rap": (1e-5, 1e-6 * 48)}
WRAPPERS = {"taylor": taylor_sin, "gaussian": gaussian_blur_halo,
            "matmul": matmul, "mandelbrot": mandelbrot, "ray": raytrace,
            "rap": rap}


def _plain_on_host(name, inputs):
    """The kernel's plain version on the whole host input (CPU tensors)."""
    t = [torch.from_numpy(np.asarray(a)) for a in inputs]
    if name == "taylor":
        return taylor_sin_plain(t[0]).numpy()
    if name == "gaussian":
        padded = torch.nn.functional.pad(t[0], (0, 0, 2, 2))
        return gaussian_blur_halo_plain(padded).numpy()
    if name == "matmul":
        return matmul_plain(*t).numpy()
    if name == "mandelbrot":
        return mandelbrot_plain(*t).numpy()
    if name == "ray":
        return raytrace_plain(*t[:3], torch.from_numpy(demo_spheres())).numpy()
    return rap_plain(*t).numpy()


def _assert_plain(name, got, inputs):
    rtol, atol = SERVE_TOL[name]
    want = _plain_on_host(name, inputs)
    if name == "ray":       # a silhouette ray may flip (0.1 %)
        assert (np.abs(got - want) > atol).mean() <= 1e-3
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("memory", ["usm", "buffers"])
@pytest.mark.parametrize("name", ["taylor", "gaussian", "matmul",
                                  "mandelbrot", "ray", "rap"])
def test_serve_real_rows_on_gpu_and_cpu(dev, name, memory):
    """``coexec_real_rows`` on the default [cuda:0, cpu] units serves every
    request of every policy through the hand kernel, each output equal
    to the plain version within its tolerance."""
    from repro_torch.launch import serve

    spec = serve.default_serve_spec()
    spec = spec.replace(
        workload=spec.workload.replace(kernel=name, items=4099, requests=3,
                                       concurrent=2),
        memory=spec.memory.replace(model=memory))
    seen = []

    def check(policy, i, inputs, out):
        _assert_plain(name, out, inputs)
        seen.append((policy, i))

    before = WRAPPERS[name].launches
    rows = serve.coexec_real_rows(spec, on_result=check)
    assert WRAPPERS[name].launches > before
    assert len(seen) == 3 * len(rows) == 3 * len(serve._sweep_policies(spec))
    for row in rows:
        assert row["requests"] == 3
        assert 0.0 <= row["device_idle_frac"] <= 1.0
        assert row["host_overhead_frac"] >= 0.0
    assert not dataplane._mapped


def test_engine_kill_mid_launch_on_gpu_and_cpu(dev):
    """Kill the CPU unit while it holds a package, then (after it joins
    again) cuda:0: the survivor finishes, the cover is exact, the lost
    range is re-issued and the output equals the plain version."""
    from repro_torch.core import DynamicScheduler, validate_cover

    n = 1 << 20
    name = "mandelbrot"
    kernel = build_kernel(name)
    inputs = kernel_demo_inputs(name, n, seed=4)
    spec = CoexecSpec.builder().policy("dynamic").build()
    with CoexecEngine.from_spec(spec) as engine:
        assert [u.device.type for u in engine.units] == ["cuda", "cpu"]
        for victim in (1, 0):
            for _ in range(20):
                reissued = engine.loop.reissued
                handle = engine.submit(
                    DynamicScheduler(n, 2, num_packages=64), kernel, inputs,
                    kernel.alloc_out(n, inputs))
                moved = engine.kill_unit_when_held(victim, handle)
                out = handle.result(timeout=300)
                validate_cover(handle.stats.packages, n)
                _assert_plain(name, out, inputs)
                if moved is not None:
                    break
            assert moved is not None and moved > 0
            assert engine.loop.reissued > reissued
            assert victim in engine.loop.dead_units
            engine.join_unit(victim)
            assert engine.loop.dead_units == set()
    assert not dataplane._mapped


def _busy_alone(kernel, inputs, device, lo, hi):
    """Busy seconds of rows [lo, hi) as one package on a unit of its own
    (a fresh runtime, the kernel already warm in the process)."""
    spec = CoexecSpec.builder().policy("static").memory("usm").build()
    part = [np.ascontiguousarray(a[lo:hi]) if arg.role is ArgRole.SPLIT
            else a for arg, a in zip(kernel.args, inputs)]
    with CoexecutorRuntime.from_spec(
            spec, units=counits_from_devices([device])) as rt:
        rt.launch(hi - lo, kernel, part)
        return sum(rt.last_stats.unit_busy_s.values())


@pytest.mark.parametrize("name", ["taylor", "matmul", "mandelbrot", "ray",
                                  "rap"])
def test_pair_cpu_unit_runs_its_packages_near_their_time_alone(dev, name):
    """``chip_smoke.py`` phase 4's USM hguided pair on [cuda:0, cpu]: Table
    1 inputs, each unit's speed on a package of 1/HINT_FRACS of the rows
    alone as its hint (the second of two), depth 1. The CPU unit's
    packages take at most 3x what the same packages take alone on the CPU,
    their fixed cost included: the median of five launches in which the
    CPU unit ran a package (cuda:0 may finish taylor's rows before it pulls
    one). A plain version runs as one call on the CPU
    (``_lib.run_plain``), so it does not wait for the interpreter lock at
    each op while the CUDA unit's worker runs Python. Gaussian's packages
    carry a halo, which a slice of its rows run alone would not."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    kernel = build_kernel(name)
    inputs = [dataplane.page_exclusive(a) for a in
              chip_smoke.table1_inputs(name, np.random.default_rng(0))]
    n = len(inputs[0])
    hint = {}
    for device in ("cuda:0", "cpu"):
        rows = max(1, n // chip_smoke.HINT_FRACS[device])
        for _ in range(2):      # the second of two: warm
            hint[device] = rows / _busy_alone(kernel, inputs, device, 0, rows)
    gpu, cpu = hint["cuda:0"], hint["cpu"]
    share = gpu / (gpu + cpu)
    spec = (CoexecSpec.builder().policy("hguided").memory("usm")
            .pipeline_depth(1).dist(share, 1.0 - share).build())
    ratios = []
    for _ in range(10):
        units = counits_from_devices(speed_hints=(gpu, cpu))
        with CoexecutorRuntime.from_spec(spec, units=units) as rt:
            rt.launch(n, kernel, inputs)
            stats = rt.last_stats
        pkgs = [p for p in stats.packages
                if units[p.unit].device.type == "cpu"]
        if not pkgs:        # cuda:0 took every row before the CPU pulled
            continue
        paired = stats.unit_busy_s[units[1].name]
        alone = sum(_busy_alone(kernel, inputs, "cpu", p.offset,
                                p.offset + p.size) for p in pkgs)
        ratios.append(paired / alone)
        if len(ratios) == 5:
            break
    print(name, "CPU busy in the pair over alone:", ratios)
    assert len(ratios) == 5, "the CPU unit ran no package in most launches"
    assert sorted(ratios)[2] <= 3.0, ratios


def test_serve_real_without_cuda_errors_and_runs_nothing(dev, monkeypatch,
                                                         capsys):
    """``--coexec real`` on a host whose CUDA is unavailable is a usage
    error: no unit is built and no kernel runs on the CPU instead."""
    from repro_torch.launch import serve

    before = {k: fn.launches for k, fn in WRAPPERS.items()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        serve.main(["--coexec", "real", "--n", "4096", "--requests", "2"])
    assert exc.value.code == 2
    assert "CUDA is not available" in capsys.readouterr().err
    assert {k: fn.launches for k, fn in WRAPPERS.items()} == before



def test_usm_leaves_a_neighbour_sharing_a_page_pageable(dev):
    """USM page-locks whole pages. An input and an output that share their
    pages with other memory are mapped through page-aligned copies, so
    the neighbour's pageable copies to and from the card still work
    while the launch holds its arrays mapped, and the result lands in
    the caller's output."""
    import mmap

    n = 3000
    page = mmap.PAGESIZE
    buf = mmap.mmap(-1, 16 * page)
    x = np.frombuffer(buf, np.float32, count=n, offset=64)
    x[:] = np.random.default_rng(5).uniform(-2, 2, n)
    out = np.frombuffer(buf, np.float32, count=n, offset=64 + 4 * n)
    neighbour = np.frombuffer(buf, np.float32, count=256,
                              offset=64 + 8 * n)
    assert not dataplane.owns_pages(x) and not dataplane.owns_pages(out)
    kernel = build_kernel("taylor")
    plane = dataplane.make_plane(MemoryModel.USM)
    units = counits_from_devices(["cuda:0"])
    plan = plane.plan(kernel, [x], out, n, units=units)
    try:
        assert dataplane._mapped
        neighbour[:] = 3.0
        on_card = torch.from_numpy(neighbour).to(dev)
        torch.testing.assert_close(on_card, torch.full((256,), 3.0,
                                                       device=dev))
        torch.from_numpy(neighbour).copy_(torch.arange(256.0, device=dev))
        assert neighbour[255] == 255.0
        assert plan.out_stage is not None
    finally:
        plan.release()
    assert not dataplane._mapped
    spec = CoexecSpec.builder().policy("dynamic").memory("usm").build()
    with CoexecutorRuntime.from_spec(spec, units=units) as rt:
        got = rt.launch(n, kernel, [x], out=out)
    assert got is out
    np.testing.assert_allclose(out, taylor_sin_plain(torch.from_numpy(
        x.copy())).numpy(), rtol=1e-5, atol=1e-6)
    assert not dataplane._mapped


def test_served_requests_copy_to_the_card_while_others_are_mapped(dev):
    """``on_result`` copies each served taylor request (1 M items) to the
    card and checks it there while up to 7 others are still mapped under
    USM: the arrays the serve path allocates own their pages."""
    from repro_torch.launch import serve

    spec = serve.default_serve_spec()
    spec = spec.replace(
        workload=spec.workload.replace(kernel="taylor", items=1_000_000,
                                       requests=16, concurrent=8),
        memory=spec.memory.replace(model="usm"))
    seen = []

    def check(policy, i, inputs, out):
        got = torch.from_numpy(out).to(dev)
        want = taylor_sin_plain(torch.from_numpy(inputs[0]).to(dev))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        seen.append(i)

    rows = serve.coexec_real_rows(spec, policies=("dynamic", "static"),
                                  on_result=check)
    assert sorted(seen) == sorted(list(range(16)) * 2)
    assert [r["requests"] for r in rows] == [16, 16]
    assert not dataplane._mapped


def test_plan_counts_its_wait_for_the_mapping_lock(dev):
    """A second thread holds the registry of mapped ranges for 50 ms while
    a launch on [cuda:0, cpu] plans under USM: its ``plan`` span counts
    the wait in ``lock_wait_s``."""
    n = 1 << 16
    kernel = build_kernel("taylor")
    spec = CoexecSpec.builder().policy("dynamic").memory("usm").build()
    held = threading.Event()

    def hold():
        with dataplane._mapped_lock:
            held.set()
            time.sleep(0.05)

    with CoexecutorRuntime.from_spec(spec) as rt:
        rt.launch(n, kernel, kernel_demo_inputs("taylor", n, seed=1))
        holder = threading.Thread(target=hold)
        holder.start()
        held.wait()
        h = rt.launch_async(n, kernel, kernel_demo_inputs("taylor", n,
                                                          seed=2))
        h.result(timeout=60)
        holder.join()
    plan, = [s for s in h.stats.spans if s.name == "plan"]
    assert plan.count("lock_wait_s") >= 0.04, plan
    assert plan.seconds >= plan.count("lock_wait_s")
    assert not dataplane._mapped


def test_a_usm_launch_settles_on_a_named_unit(dev):
    """A USM launch on [cuda:0, cpu] unmaps its arrays in ``settle``, on
    the worker of the unit that retired its last package."""
    n = 1 << 20
    kernel = build_kernel("taylor")
    spec = CoexecSpec.builder().policy("hguided").memory("usm").build()
    with CoexecutorRuntime.from_spec(spec) as rt:
        for seed in range(3):
            h = rt.launch_async(n, kernel, kernel_demo_inputs("taylor", n,
                                                              seed=seed))
            h.result(timeout=60)
            settle, = [s for s in h.stats.spans if s.name == "settle"]
            assert settle.seconds > 0
            assert settle.unit in (0, 1)
            assert list(h.stats.unit_busy_s)[settle.unit] in (
                [u.name for u in rt.engine.units])
            assert settle.count("lock_wait_s", None) >= 0
            last = max(h.stats.packages, key=lambda p: p.t_collected)
            assert last.t_collected <= settle.start
    assert not dataplane._mapped


PAPER_KERNELS = ["taylor", "gaussian", "matmul", "mandelbrot", "ray", "rap"]


def _unit_kind_rows(stats, units, n):
    """The device type of the unit that computed each row."""
    rows = np.empty(n, dtype=object)
    for p in stats.packages:
        rows[p.offset:p.offset + p.size] = units[p.unit].device.type
    return rows


@pytest.mark.parametrize("name", PAPER_KERNELS)
def test_usm_launch_equals_buffers_bit_for_bit(dev, name):
    """Under ``dynamic`` a USM launch, whose CUDA unit reads device copies
    of the inputs and writes the mapped output, equals the BUFFERS launch
    bit for bit on every row the same kind of unit computed in both: on
    [cuda:0, cpu], and on cuda:0 alone, where the card computes every row
    and so holds gaussian's halo at both edges of the image."""
    n = 4099
    kernel = build_kernel(name)
    inputs = kernel_demo_inputs(name, n, seed=7)
    for devices in (["cuda:0", "cpu"], ["cuda:0"]):
        outs, kinds = {}, {}
        for memory in ("usm", "buffers"):
            spec = (CoexecSpec.builder().policy("dynamic").memory(memory)
                    .build())
            units = counits_from_devices(devices)
            with CoexecutorRuntime.from_spec(spec, units=units) as rt:
                outs[memory] = rt.launch(n, kernel, inputs)
                kinds[memory] = _unit_kind_rows(rt.last_stats, units, n)
        same = kinds["usm"] == kinds["buffers"]
        if devices == ["cuda:0"]:
            assert same.all()
        np.testing.assert_array_equal(outs["usm"][same],
                                      outs["buffers"][same],
                                      err_msg=str(devices))
    assert not dataplane._mapped


@pytest.mark.parametrize("name", PAPER_KERNELS)
def test_usm_copy_bytes_count_what_the_card_reads(dev, name):
    """Each CUDA package's ``stage`` span counts in ``usm_copy_bytes`` its
    split rows (the halo rows that exist included), and one of them the
    broadcast inputs whole, once a launch; no CPU package carries the
    count, and the staging counters stay 0."""
    n = 4099
    kernel = build_kernel(name)
    inputs = kernel.bind(kernel_demo_inputs(name, n, seed=3))
    broadcast = sum(a.nbytes for arg, a in zip(kernel.args, inputs)
                    if arg.role is ArgRole.BROADCAST)
    for policy in ("static", "dyn16"):
        spec = CoexecSpec.builder().policy(policy).memory("usm").build()
        units = counits_from_devices(["cuda:0", "cpu"])
        with CoexecutorRuntime.from_spec(spec, units=units) as rt:
            rt.launch(n, kernel, inputs)
            stats = rt.last_stats
        stage = {(s.unit, s.start): s for s in stats.timeline()
                 if s.name == "stage"}
        extra = []
        for p in stats.packages:
            got = stage[(p.unit, p.t_issue)].count("usm_copy_bytes", None)
            if units[p.unit].device.type == "cpu":
                assert got is None, p
                continue
            rows = 0
            for arg, a in zip(kernel.args, inputs):
                if arg.role is ArgRole.SPLIT:
                    lo = max(p.offset - arg.halo, 0)
                    hi = min(p.offset + p.size + arg.halo, n)
                    rows += (hi - lo) * (a.nbytes // a.shape[0])
            extra.append(got - rows)
        if policy == "static":
            assert extra, "cuda:0 served no package under static"
        if extra:
            assert sorted(extra)[-1] == broadcast
            assert sum(extra) == broadcast
        assert stats.data.h2d_copies == stats.data.h2d_bytes == 0
        assert stats.data.d2h_copies == stats.data.d2h_bytes == 0
    assert not dataplane._mapped


def test_usm_maps_only_the_output_and_frees_its_copies(dev):
    """While a USM launch is in flight the registry of mapped ranges holds
    its output's pages alone; once it settles the registry is empty and
    the card's allocator holds what it held before the launch."""
    from repro_torch.core import Package, Range

    n = 1 << 14
    kernel = build_kernel("matmul")
    inputs = kernel_demo_inputs("matmul", n, seed=2)
    units = counits_from_devices(["cuda:0", "cpu"])
    spec = CoexecSpec.builder().policy("dynamic").memory("usm").build()
    with CoexecutorRuntime.from_spec(spec, units=units) as rt:
        want = rt.launch(n, kernel, inputs)     # loads the kernel
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    page = dataplane._PAGE
    out = kernel.alloc_out(n, inputs)
    lo = out.ctypes.data - out.ctypes.data % page
    hi = -(-(out.ctypes.data + out.nbytes) // page) * page
    plane = dataplane.make_plane(MemoryModel.USM)
    plan = plane.plan(kernel, inputs, out, n, units=units)
    try:
        assert {s: v[0] for s, v in dataplane._mapped.items()} == {lo: hi}
        for i, unit in enumerate(units):
            pkg = Package(Range(i * n // 2, n // 2), seq=i, unit=i)
            pkg.t_issue = time.perf_counter()
            plane.execute(unit, plan, pkg)
        assert {s: v[0] for s, v in dataplane._mapped.items()} == {lo: hi}
        assert torch.cuda.memory_allocated(dev) > before    # B's copy
    finally:
        plan.release()
    torch.cuda.synchronize()
    assert not dataplane._mapped
    assert torch.cuda.memory_allocated(dev) == before
    # demo matmul inputs have K = 32; who computed which row of `want`
    # is not fixed, and the CPU's GEMM sums in another order
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=32e-6)
    with CoexecutorRuntime.from_spec(spec, units=units) as rt:
        h = rt.launch_async(n, kernel, inputs)
        h.result(timeout=60)
    torch.cuda.synchronize()
    assert not dataplane._mapped
    assert torch.cuda.memory_allocated(dev) == before


# -- every model family's reduced model on cuda:0 ----------------------------

FAMILY_ARCHS = ["qwen3-0.6b", "qwen1.5-110b", "h2o-danube3-4b",
                "minicpm-2b", "internvl2-1b", "phi3.5-moe-42b-a6.6b",
                "qwen3-moe-235b-a22b", "whisper-medium", "xlstm-1.3b",
                "xlstm-wide"]


def _family_cfg(arch):
    if arch == "xlstm-wide":      # 2 heads of 256: the wide kernel path
        return dataclasses.replace(get_config("xlstm-1.3b").reduced(),
                                   d_model=256, num_heads=2)
    return get_config(arch).reduced()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_forward_through_the_kernels(dev, monkeypatch, arch, dtype):
    """The reduced model's forward through the kernels against the plain
    versions, on the same weights. f32 (the residual stream kept in f32):
    the kernels differ by the order of f32 sums, within 2e-3 of logits of
    size 4; bf16 (as served): bf16 rounding flips carried through the
    layers, within the prefill's 0.1 relative L2 of ``chip_smoke.py``."""
    monkeypatch.setattr(model_mod, "embed",
                        functools.partial(model_mod.embed, dtype=dtype))
    cfg = _family_cfg(arch)
    kern = build_model(dataclasses.replace(cfg, attn_impl="flash",
                                           mixer_impl="pallas"))
    plain = build_model(dataclasses.replace(cfg, attn_impl="xla",
                                            mixer_impl="ref"))
    g = torch.Generator(device=dev).manual_seed(21)
    params = kern.init(g, dev)
    B, T = 2, 96
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, T),
                                     generator=g, device=dev)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(B, cfg.encoder_seq, cfg.d_model,
                                      generator=g, device=dev).to(dtype)
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.randn(B, cfg.vision_tokens,
                                             cfg.d_model, generator=g,
                                             device=dev)
    flash_attention.launches = linear_attention.launches = 0
    got, _ = kern.forward(params, batch)
    launched = (flash_attention.launches, linear_attention.launches)
    want, _ = plain.forward(params, batch)
    assert (flash_attention.launches, linear_attention.launches) == launched
    if cfg.family == "ssm":
        assert launched == (0, (cfg.num_layers // cfg.slstm_every)
                            * (cfg.slstm_every - 1))
    else:
        assert launched[0] == cfg.num_layers + cfg.encoder_layers
        assert launched[1] == 0
    V = cfg.vocab_size
    got, want = got[..., :V].float(), want[..., :V].float()
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-3)
    else:
        assert float((got - want).norm() / want.norm()) <= 0.1


# -- training on the card ----------------------------------------------------

def _reduced_trainer(params):
    from repro_torch.data import DataPipeline
    from repro_torch.hetero import HeteroTrainer, make_policy
    from repro_torch.optim import AdamW

    cfg = get_config("qwen3-0.6b").reduced()
    pipe = DataPipeline(seed=5, global_batch=8, seq_len=16,
                        vocab=cfg.vocab_size, num_shards=8)
    return HeteroTrainer(build_model(cfg), params, optimizer=AdamW(lr=1e-3),
                         policy=make_policy("static", {"A": 1.0, "B": 1.0}),
                         pipeline=pipe, group_speeds={"A": 1.0, "B": 0.5},
                         total_microbatches=8)


def test_train_steps_on_card_match_the_cpu(dev, monkeypatch):
    """Three steps of reduced qwen3-0.6b on cuda:0 and on the CPU from the
    same parameters, in f32 (both ``embed`` f32): the card's f32 sums run
    in another order, so losses agree within rtol 1e-5 and the parameters
    after three AdamW steps within 1e-4 relative L2."""
    from repro_torch.tree import leaves, tree_map

    monkeypatch.setattr(model_mod, "embed", functools.partial(
        model_mod.embed, dtype=torch.float32))
    cfg = get_config("qwen3-0.6b").reduced()
    cpu = build_model(cfg).init(torch.Generator().manual_seed(3), "cpu")
    card = tree_map(lambda t: t.to(dev), cpu)
    on_cpu, on_card = _reduced_trainer(cpu), _reduced_trainer(card)
    want = [r.loss for r in on_cpu.run(3)]
    got = [r.loss for r in on_card.run(3)]
    assert on_card.device.type == "cuda"
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for a, b in zip(leaves(on_card.params), leaves(on_cpu.params)):
        assert float((a.cpu() - b).norm() / b.norm()) <= 1e-4


def test_kernels_refuse_grad_on_card(dev):
    """Inputs that require grad are refused on the card, as on the CPU; the
    same inputs without grad mode launch the kernels."""
    q = torch.randn(1, 2, 64, 64, device=dev, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        flash_attention(q, q, q)
    a = torch.randn(2, 64, 32, device=dev, requires_grad=True)
    ld = torch.zeros(2, 64, device=dev)
    with pytest.raises(ValueError, match="no backward"):
        linear_attention(a, a, a, ld)
    before = (flash_attention.launches, linear_attention.launches)
    with torch.no_grad():
        flash_attention(q, q, q)
        linear_attention(a, a, a, ld)
    assert (flash_attention.launches, linear_attention.launches) == \
        (before[0] + 1, before[1] + 1)


def test_save_async_keeps_the_saved_values_on_card(dev, tmp_path):
    """``save_async`` copies the card's tensors to the host before it
    returns: an in-place AdamW step right after it does not reach the file
    being written."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.optim import AdamW

    g = torch.Generator(device=dev).manual_seed(4)
    params = {"w": torch.randn(1 << 24, generator=g, device=dev),
              "b": [torch.randn(7, generator=g, device=dev)]}
    saved = {"w": params["w"].cpu().numpy(),
             "b": [params["b"][0].cpu().numpy()]}
    opt = AdamW(lr=0.1)
    state = opt.init(params)
    ck = Checkpointer(str(tmp_path))
    ck.save_async(1, params)
    opt.update({"w": torch.ones_like(params["w"]),
                "b": [torch.ones_like(params["b"][0])]}, state, params)
    ck.wait()
    step, got = ck.restore(saved)
    assert step == 1
    assert np.array_equal(got["w"], saved["w"])
    assert np.array_equal(got["b"][0], saved["b"][0])
    assert not np.array_equal(params["w"].cpu().numpy(), saved["w"])


# -- the published Zamba2 layout (zamba2-7b-instruct) ----------------------

@pytest.mark.parametrize("b,t", [(32, 1024), (2, 333)])
def test_flash_attention_head_dim_224_takes_the_callers_scale(dev, b, t):
    """Zamba2-7B-Instruct's shared attention: 32 heads of 224 in bf16 with
    the scale (224 / 2)^-1/2 given by the caller, on the tensor-core path's
    widest instantiation, at the cell's prefill shape and at a ragged T:
    the bf16 abs gate and chip_smoke.py's per-row relative L2 gate
    (FLASH_ROW_REL, 1e-2); the default scale gives other outputs."""
    g = torch.Generator(device=dev).manual_seed(21)
    scale = (224 / 2) ** -0.5
    q, k, v = (torch.randn(b, 32, t, 224, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, scale=scale)
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=True, scale=scale).float()
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)
    row = (got.float() - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(row.max()) <= 1e-2
    del want, row
    other = flash_attention(q, k, v, causal=True)
    assert float((other.float() - got.float()).abs().max()) > 0.05


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,t,dk,dv", [(6, 333, 64, 64), (3, 200, 16, 40),
                                        (2, 130, 128, 40), (4, 1, 64, 64)])
def test_linear_attention_returns_the_final_state(dev, dtype, bh, t, dk, dv):
    """The state after the last step, f32 (BH, Dk, Dv), against the plain
    recurrence's on the same inputs: f32 within the kernel's 3e-4; bf16
    within 1e-2 relative L2 a head (the kernel carries the state in f32 and
    forms its update from hi + lo pairs, so only the inputs are bf16 and
    both read them alike), and the outputs are those of a launch without
    the state, bit for bit."""
    g = torch.Generator(device=dev).manual_seed(22)
    q = torch.randn(bh, t, dk, generator=g, device=dev).to(dtype)
    k = (0.2 * torch.randn(bh, t, dk, generator=g, device=dev)).to(dtype)
    v = torch.randn(bh, t, dv, generator=g, device=dev).to(dtype)
    ld = -(0.1 * torch.randn(bh, t, generator=g, device=dev)).abs()
    out, state = linear_attention(q, k, v, ld, return_final_state=True)
    assert torch.equal(out, linear_attention(q, k, v, ld))
    want_out, want = linear_attention_plain(q, k, v, ld,
                                            return_final_state=True)
    assert state.dtype == torch.float32 and state.shape == (bh, dk, dv)
    if dtype == torch.float32:
        torch.testing.assert_close(state, want, rtol=3e-4, atol=3e-4)
    else:
        rel = (state - want).flatten(1).norm(dim=1) / \
            want.flatten(1).norm(dim=1)
        assert float(rel.max()) <= 1e-2


def test_zamba2_instruct_one_period_on_the_card_matches_the_reference(dev):
    """Full widths, one period of layers: 6 Mamba layers with hybrid
    applications at layers 1 and 4 (one on each shared block), bf16
    weights. serve_batch (prefill through the flash and linear-attention
    kernels, decode through the caches) against the f32 reference's full
    forward on the same weights: both numbers the cell's check reads sit
    below the cell's limits, and the fp8 control's above them."""
    import json

    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import params_from_zamba2_state_dict
    from repro_torch.models import zamba2_reference as ref
    from test_torch_zamba2_instruct import config_of, random_state_dict

    cfg = dataclasses.replace(get_config("zamba2-7b-instruct"), num_layers=6,
                              hybrid_layer_ids=(1, 4))
    sd = random_state_dict(config_of(cfg), seed=23, device=dev,
                           dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(24)
    B, P, G = 4, 256, 8
    tokens = torch.randint(0, cfg.vocab_size, (B, P + G), generator=g,
                           device=dev)
    model = build_model(cfg)
    params = params_from_zamba2_state_dict(cfg, sd)
    flash_attention.launches = linear_attention.launches = 0
    with torch.no_grad():
        got, _ = serve_batch(model, params, tokens[:, :P], tokens[:, P:])
    assert (flash_attention.launches, linear_attention.launches) == (2, 6)
    del params
    limits = json.loads((pathlib.Path(__file__).resolve().parents[1]
                         / "bench" / "configs" / "zamba2-7b-instruct.json"
                         ).read_text())["check"]

    def numbers(out, want):
        diff = (out.float() - want).double()
        rms = float(want.double().pow(2).mean().sqrt())
        rows = diff.norm(dim=-1) / want.double().norm(dim=-1)
        return {"max_err_over_rms": float(diff.abs().max()) / rms,
                "max_row_rel_l2": float(rows.max())}

    want = ref.forward(sd, tokens, config_of(cfg), keep_from=P - 1)
    sound = numbers(got, want)
    control = numbers(ref.forward(sd, tokens, config_of(cfg),
                                  keep_from=P - 1, precision="fp8"), want)
    print(f"one period: bf16 {sound}, fp8 control {control}, limits "
          f"{limits}")
    assert all(sound[k] <= limits[k] for k in limits)
    assert any(control[k] > limits[k] for k in limits)


def test_zamba2_instruct_decode_graph_on_the_card_matches_eager_steps(dev):
    """One period of layers at full width, as above: serve_batch's decode
    steps, replays of one captured CUDA graph, against a loop of eager
    ``decode_step`` s on the same prefill, bit for bit (or, should cuBLAS
    pick another algorithm under capture, each position's logits within
    1e-6 of their L2). A second launch with other prompts replays the
    same graph (no capture, G replays) and returns its own logits; another
    B or another params object captures again; a replay reads nothing back
    to the host; dropping the model drops its graph."""
    import gc

    from repro_torch.launch import serve
    from repro_torch.models import params_from_zamba2_state_dict
    from test_torch_zamba2_instruct import config_of, random_state_dict

    cfg = dataclasses.replace(get_config("zamba2-7b-instruct"), num_layers=6,
                              hybrid_layer_ids=(1, 4))
    sd = random_state_dict(config_of(cfg), seed=23, device=dev,
                           dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(25)
    B, P, G = 4, 256, 8
    tokens = torch.randint(0, cfg.vocab_size, (2, B, P + G), generator=g,
                           device=dev)
    model = build_model(cfg)
    params = params_from_zamba2_state_dict(cfg, sd)

    def eager(toks):
        cache = model.init_cache(toks.shape[0], P + G, device=dev,
                                 dtype=torch.bfloat16)
        last, cache = model.prefill(params, {"tokens": toks[:, :P]}, cache)
        out = [last]
        for i in range(P, P + G):
            step, cache = model.decode_step(params, toks[:, i:i + 1], cache)
            out.append(step)
        return torch.stack(out, dim=1)

    def row_rel(a, b):
        rows = (a - b).double().norm(dim=-1) / b.double().norm(dim=-1)
        return float(rows.max())

    def launch(toks, p=params):
        got, spans = serve.serve_batch(model, p, toks[:, :P], toks[:, P:])
        spans = {s.name: s for s in spans}
        # every replay runs the decode-attention kernel once a ring
        assert spans["decode"].count("attn_kernel_launches") == \
            len(cfg.hybrid_layer_ids)
        return got, (spans["launch"].count("graph_captures"),
                     spans["decode"].count("graph_steps"))

    with torch.no_grad():
        first, second = (launch(toks) for toks in tokens)
        assert (first[1], second[1]) == ((1, G), (0, G))
        for (got, _), toks in zip((first, second), tokens):
            want = eager(toks)
            print(f"graphed against eager: bit for bit "
                  f"{torch.equal(got, want)}, row rel L2 "
                  f"{row_rel(got, want):.3g}")
            assert torch.equal(got, want) or row_rel(got, want) <= 1e-6
        assert row_rel(second[0], first[0]) > 1e-2

        holder = serve._HOLDERS[model].graph
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            holder.decode(first[0][:, 0], tokens[0, :, P:])
        finally:
            torch.cuda.set_sync_debug_mode("default")

        fewer, counts = launch(tokens[0, :2])
        assert counts == (1, G)
        want = eager(tokens[0, :2])
        assert torch.equal(fewer, want) or row_rel(fewer, want) <= 1e-6
        assert launch(tokens[0, :2])[1] == (0, G)
        assert launch(tokens[0, :2], dict(params))[1] == (1, G)
    held = len(serve._HOLDERS)
    del model, holder
    gc.collect()
    assert len(serve._HOLDERS) == held - 1


def test_zamba2_instruct_serve_batch_from_threads_on_one_model(dev):
    """One period of layers at full width, as above, served from three
    threads on one model at once, three launches each: two with other
    prompts at one B, a third at another B, whose launches capture the
    decode graph again while the others' wait. A lock per model holds
    each call from the graph's lookup to its last replay, so every
    launch's logits equal its prompts' one-thread logits bit for bit."""
    from repro_torch.launch import serve
    from repro_torch.models import params_from_zamba2_state_dict
    from test_torch_zamba2_instruct import config_of, random_state_dict

    cfg = dataclasses.replace(get_config("zamba2-7b-instruct"), num_layers=6,
                              hybrid_layer_ids=(1, 4))
    sd = random_state_dict(config_of(cfg), seed=27, device=dev,
                           dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(29)
    B, P, G, rounds = 4, 256, 8, 3
    tokens = torch.randint(0, cfg.vocab_size, (3, B, P + G), generator=g,
                           device=dev)
    batches = [tokens[0], tokens[1], tokens[2, :2]]
    model = build_model(cfg)
    params = params_from_zamba2_state_dict(cfg, sd)

    def launch(toks):
        with torch.no_grad():
            got, spans = serve.serve_batch(model, params, toks[:, :P],
                                           toks[:, P:])
        return got, next(s for s in spans if s.name == "launch")

    alone = [launch(toks)[0] for toks in batches]
    assert not torch.equal(alone[0], alone[1])
    start = threading.Barrier(len(batches))
    served = [[] for _ in batches]
    errors = []

    def serve_in_turn(i):
        try:
            start.wait()
            for _ in range(rounds):
                served[i].append(launch(batches[i]))
        except Exception as e:              # reported below
            errors.append(e)

    threads = [threading.Thread(target=serve_in_turn, args=(i,))
               for i in range(len(batches))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    captures = sum(span.count("graph_captures")
                   for runs in served for _, span in runs)
    print(f"threads: {captures} captures in {rounds * len(batches)} "
          f"launches")
    assert captures >= 1
    for want, runs in zip(alone, served):
        assert len(runs) == rounds
        assert all(torch.equal(got, want) for got, _ in runs)


def test_zamba2_instruct_decode_launches_the_kernel_once_a_ring(dev):
    """The published layout's 81 layers and 13 attention applications at a
    small width: the decode span's ``attn_kernel_launches`` reads 13 on
    the launch that captures the decode graph and on one that only
    replays it."""
    from repro_torch.launch import serve
    from repro_torch.models import params_from_zamba2_state_dict
    from test_torch_zamba2_instruct import config_of, random_state_dict

    full = get_config("zamba2-7b-instruct")
    cfg = dataclasses.replace(full.reduced(), num_layers=full.num_layers,
                              hybrid_layer_ids=full.hybrid_layer_ids)
    sd = random_state_dict(config_of(cfg), seed=41, device=dev,
                           dtype=torch.bfloat16)
    model = build_model(cfg)
    params = params_from_zamba2_state_dict(cfg, sd)
    g = torch.Generator(device=dev).manual_seed(43)
    tokens = torch.randint(0, cfg.vocab_size, (2, 2, 19), generator=g,
                           device=dev)
    counts = []
    with torch.no_grad():
        for toks in tokens:
            _, spans = serve.serve_batch(model, params, toks[:, :16],
                                         toks[:, 16:])
            spans = {s.name: s for s in spans}
            counts.append((spans["launch"].count("graph_captures"),
                           spans["decode"].count("attn_kernel_launches")))
    assert len(full.hybrid_layer_ids) == 13
    assert counts == [(1, 13), (0, 13)]
