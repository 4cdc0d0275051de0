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
from repro_torch.core import (CoexecEngine, CoexecutorRuntime, MemoryModel,
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
