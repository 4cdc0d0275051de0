"""The port's kernel modules against the JAX reference, on the CPU.

Each port wrapper, given CPU tensors, runs its plain PyTorch version; the
same numpy inputs go through ``repro.kernels.ref`` and through the Pallas
kernel in interpret mode (as ``tests/test_kernel_impls.py`` runs it).
The hand CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).

Tolerances:

* taylor, gaussian: rtol 1e-5, atol 1e-6 — same f32 operations, the
  reference's oracle orders the Taylor update differently
  (``-term*x*x/(n(n+1))``) and XLA may contract multiply-adds;
* matmul: rtol 1e-5, atol 1e-6 * K — the plain version sums in ascending
  k with one rounding per multiply and add, the CPU wrapper's GEMM, XLA
  and Pallas in other orders, so the error grows with the inner
  dimension;
* mandelbrot: exact — escape counts are integers and every operation is
  a single IEEE rounding in both packages;
* ray: atol 1e-4, with at most 0.1 % of the rays beyond it — XLA
  contracts the dot products into FMAs, which moves ``disc`` by an ulp
  and can flip a hit at a sphere's silhouette (the reference's own XLA
  path and eager oracle already differ by ~1e-5);
* rap: rtol 1e-5, atol 1e-6 * L — the same utilities summed in another
  order.
"""
import importlib
import inspect
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from numpy.testing import assert_allclose

from repro.kernels import ref
from repro.kernels.gaussian import gaussian_blur as pallas_gaussian
from repro.kernels.gaussian import gaussian_blur_halo as pallas_gaussian_halo
from repro.kernels.mandelbrot import mandelbrot as pallas_mandelbrot
from repro.kernels.matmul import matmul as pallas_matmul
from repro.kernels.rap import rap as pallas_rap
from repro.kernels.raytrace import demo_spheres as ref_demo_spheres
from repro.kernels.raytrace import raytrace as pallas_raytrace
from repro.kernels.taylor import taylor_sin as pallas_taylor
from repro_torch.kernels import (_lib, demo_spheres, gaussian_blur,
                                 gaussian_blur_halo,
                                 gaussian_blur_halo_plain, mandelbrot,
                                 mandelbrot_plain, matmul, matmul_plain, rap,
                                 rap_plain, raytrace, raytrace_plain,
                                 taylor_sin, taylor_sin_plain)
from repro_torch.kernels.matmul import H100_SMS, TILES, tile_for

_mm = importlib.import_module("repro_torch.kernels.matmul")

rng = np.random.default_rng(2106)


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("terms", range(1, 13))
def test_taylor_matches_reference(terms):
    x = rng.uniform(-2.5, 2.5, size=1037).astype(np.float32)
    before = taylor_sin.launches
    got = taylor_sin(t(x), terms=terms).numpy()
    assert taylor_sin.launches == before     # CPU tensor: plain version
    np.testing.assert_array_equal(
        got, taylor_sin_plain(t(x), terms=terms).numpy())
    assert_allclose(got, np.asarray(ref.taylor_sin(jnp.asarray(x), terms)),
                    rtol=1e-5, atol=1e-6)
    assert_allclose(got, np.asarray(pallas_taylor(jnp.asarray(x),
                                                  terms=terms, bm=8)),
                    rtol=1e-5, atol=1e-6)


def _taylor_reciprocals() -> list[float]:
    """The RN(1/d) constants of ``csrc/taylor.cu``'s unrolled kernel."""
    src = (_lib.CSRC / "taylor.cu").read_text()
    return [float.fromhex(h) for h in
            re.findall(r"return (0x[0-9a-f.]+p[-+]?\d+)f;", src)]


def _rn32(a: np.ndarray) -> np.ndarray:
    return a.astype(np.float32).astype(np.float64)


def _rn32_on_midpoints(s: np.ndarray, sign: np.ndarray) -> np.ndarray:
    """RN32 of an exact value x from s = RN64(x) and sign = sign(x - s)
    where s is an f32 midpoint: the only case where rounding s again to
    f32 can differ from rounding x."""
    f = _rn32(s)
    f32 = f.astype(np.float32)
    up = np.nextafter(f32, np.float32(np.inf)).astype(np.float64)
    dn = np.nextafter(f32, np.float32(-np.inf)).astype(np.float64)
    f = np.where((s == (f + up) / 2) & (sign > 0), up, f)
    return np.where((s == (f + dn) / 2) & (sign < 0), dn, f)


@pytest.mark.parametrize("k", range(12))
def test_taylor_reciprocal_division_is_correctly_rounded(k):
    """The unrolled CUDA kernel divides by d = (2k+2)(2k+3) as
    q = RN(n r), q' = RN(q + RN(n - q d) r) with r = RN(1/d). Held exactly
    against RN(n / d) for every f32 significand n in [1, 2); scaling n by
    a power of two scales every step exactly, so this covers the normal
    range. Every product below is exact in f64, and the one inexact f64
    sum is rounded to f32 through its exact error term."""
    recips = _taylor_reciprocals()
    assert len(recips) == 12
    d = float((2 * k + 2) * (2 * k + 3))
    r = recips[k]
    assert r == float(np.float32(1.0) / np.float32(d))
    n = np.arange(2**23, 2**24, dtype=np.float64) * 2.0**-23
    q = _rn32(n * r)
    rem = _rn32(n - q * d)              # n - q d is exact in f64
    p = rem * r
    s = q + p                           # two-sum: q + p == s + e exactly
    bb = s - q
    e = (q - (s - bb)) + (p - bb)
    got = _rn32_on_midpoints(s, e)
    # RN32(n / d): n / d is never an f32 midpoint (d's odd part is > 1),
    # and n - s d is exact in f64 for s an f32 midpoint
    s = n / d
    want = _rn32_on_midpoints(s, n - s * d)
    assert int((got != want).sum()) == 0
    assert int((q != want).sum()) > 0   # the correction does the work


@pytest.mark.parametrize("h,w", [(37, 53), (64, 128), (5, 9)])
def test_gaussian_halo_entry_matches_reference(h, w):
    chunk = rng.normal(size=(h + 4, w)).astype(np.float32)
    got = gaussian_blur_halo(t(chunk)).numpy()
    assert got.shape == (h, w)
    want = np.asarray(pallas_gaussian_halo(jnp.asarray(chunk), bm=16))
    assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("h,w", [(37, 53), (200, 96), (1, 7)])
def test_gaussian_whole_image_matches_reference(h, w):
    img = rng.normal(size=(h, w)).astype(np.float32)
    got = gaussian_blur(t(img)).numpy()
    assert_allclose(got, np.asarray(ref.gaussian_blur(jnp.asarray(img))),
                    rtol=1e-5, atol=1e-6)
    if h >= 8:
        assert_allclose(got, np.asarray(pallas_gaussian(jnp.asarray(img),
                                                        bm=8)),
                        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lo,hi", [(0, 0), (2, 0), (0, 2), (1, 2), (2, 2)])
def test_gaussian_missing_halo_rows_are_zero(lo, hi):
    """Rows reported missing equal explicit zero rows, bit for bit."""
    rows = rng.normal(size=(20, 11)).astype(np.float32)
    padded = np.pad(rows, ((lo, hi), (0, 0)))
    got = gaussian_blur_halo(t(rows), lo_pad=lo, hi_pad=hi).numpy()
    want = gaussian_blur_halo_plain(t(padded)).numpy()
    np.testing.assert_array_equal(got, want)


def test_gaussian_rejects_rows_without_halo():
    with pytest.raises(ValueError, match="halo"):
        gaussian_blur_halo(torch.zeros(3, 8))


@pytest.mark.parametrize("m,k,n", [(17, 33, 9), (70, 5, 130), (1, 1, 1),
                                   (65, 129, 63)])
def test_matmul_ragged_matches_reference(m, k, n):
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    before = matmul.launches
    got = matmul(t(a), t(b)).numpy()
    assert matmul.launches == before      # CPU tensor: the CPU's GEMM
    atol = 1e-6 * k
    assert_allclose(got, matmul_plain(t(a), t(b)).numpy(), rtol=1e-5,
                    atol=atol)
    assert_allclose(got, np.asarray(ref.matmul(jnp.asarray(a),
                                               jnp.asarray(b))),
                    rtol=1e-5, atol=atol)
    assert_allclose(got, np.asarray(pallas_matmul(jnp.asarray(a),
                                                  jnp.asarray(b), bm=32,
                                                  bn=32, bk=32)),
                    rtol=1e-5, atol=atol)


def test_cpu_matmul_is_a_gemm_into_out():
    """The CPU unit's matmul is one GEMM (not the k-ordered loop), written
    into the given ``out``, and matches the reference's ``ref.matmul``."""
    a = rng.normal(size=(96, 512)).astype(np.float32)
    b = rng.normal(size=(512, 40)).astype(np.float32)
    out = torch.empty(96, 40)
    assert matmul(t(a), t(b), out=out) is out
    np.testing.assert_array_equal(out.numpy(),
                                  torch.matmul(t(a), t(b)).numpy())
    assert_allclose(out.numpy(), np.asarray(ref.matmul(jnp.asarray(a),
                                                       jnp.asarray(b))),
                    rtol=1e-5, atol=1e-6 * 512)


def test_matmul_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="compose"):
        matmul(torch.zeros(3, 4), torch.zeros(5, 2))


def _blocks(m: int, n: int, tile: tuple[int, int]) -> int:
    return -(-m // tile[0]) * -(-n // tile[1])


@pytest.mark.parametrize("m,n", [
    (1, 300), (1, 4864), (50, 4864), (50, 300), (127, 300), (129, 300),
    (608, 4864), (1024, 300), (1024, 4864), (4864, 4864), (300_000, 64),
    (7, 7), (2200, 1000), (3000, 600),
])
def test_matmul_tile_for_fills_the_sms(m, n):
    """The CUDA kernel's block tile: the largest of TILES whose grid has
    at least one block per SM, the smallest when none has."""
    tile = tile_for(m, n)
    assert tile in TILES
    bm, bn = tile
    gm, gn = -(-m // bm), -(-n // bn)
    # the grid covers the output, and every block owns a row and a column
    assert (gm - 1) * bm < m <= gm * bm and (gn - 1) * bn < n <= gn * bn
    if _blocks(m, n, TILES[-1]) >= H100_SMS:
        assert _blocks(m, n, tile) >= H100_SMS
    for larger in TILES[:TILES.index(tile)]:
        assert _blocks(m, n, larger) < H100_SMS


@pytest.mark.parametrize("m,n,tile", [
    (4864, 4864, (128, 128)), (1024, 1024, (64, 64)), (50, 4864, (32, 64)),
])
def test_matmul_passes_its_tile_to_the_kernel_entry(monkeypatch, m, n,
                                                    tile):
    """On a device tensor the wrapper hands the C entry the shapes and the
    tile that tile_for picks for the card's SM count, and counts one
    launch. The entry and the device checks are stubbed: only the
    wrapper's dispatch runs here."""
    calls = []

    class Lib:
        def matmul_f32(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_mm._lib, "require_cuda_f32", lambda *a: None)
    monkeypatch.setattr(_mm._lib, "library", Lib)
    monkeypatch.setattr(_mm._lib, "stream_of", lambda x: 7)
    monkeypatch.setattr(_mm, "_sm_count", lambda device: H100_SMS)
    k = 129
    a = torch.empty(m, k, device="meta")
    b = torch.empty(k, n, device="meta")
    before = matmul.launches
    out = matmul(a, b)
    assert tuple(out.shape) == (m, n) and matmul.launches == before + 1
    assert len(calls) == 1 and calls[0][3:] == (m, n, k, *tile, 7)
    assert tile_for(m, n) == tile


def test_matmul_tile_for_main_path_shapes():
    """The whole Table 1 launch takes 128 x 128; a dynamic package of ~50
    rows takes 32 x 64 (152 blocks where 64 x 64 gives 76)."""
    assert tile_for(4864, 4864) == (128, 128)
    assert tile_for(50, 4864) == (32, 64)
    assert tile_for(50, 4864, sms=64) == (64, 64)


@pytest.mark.parametrize("side,it", [(31, 32), (64, 64)])
def test_mandelbrot_is_exact(side, it):
    re_ = np.linspace(-2.2, 0.8, side, dtype=np.float32)
    im = np.linspace(-1.4, 1.4, side + 3, dtype=np.float32)
    cre, cim = np.meshgrid(re_, im)
    got = mandelbrot(t(cre), t(cim), max_iter=it).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        ref.mandelbrot(jnp.asarray(cre), jnp.asarray(cim), it)))
    np.testing.assert_array_equal(got, np.asarray(
        pallas_mandelbrot(jnp.asarray(cre), jnp.asarray(cim), max_iter=it,
                          bm=8)))
    np.testing.assert_array_equal(
        got, mandelbrot_plain(t(cre), t(cim), max_iter=it).numpy())


def test_demo_spheres_equal_reference_bit_for_bit():
    for num, seed in ((8, 3), (1, 0), (33, 7)):
        got = demo_spheres(num, seed)
        want = np.asarray(ref_demo_spheres(num, seed))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(demo_spheres(),
                                  np.asarray(ref_demo_spheres()))


def camera_rays(h: int, w: int):
    """A row-major h x w grid of unit rays, as the Table 1 input is made."""
    dx, dy = np.meshgrid(np.linspace(-0.4, 0.4, w, dtype=np.float32),
                         np.linspace(-0.4, 0.4, h, dtype=np.float32))
    dz = np.sqrt(np.maximum(1 - dx**2 - dy**2, 0.5)).astype(np.float32)
    return [np.ascontiguousarray(a.ravel()) for a in (dx, dy, dz)]


def assert_rays_close(got, want, what):
    """atol 1e-4, except for at most 0.1 % of rays (silhouette flips)."""
    off = np.abs(got - want) > 1e-4
    assert off.mean() <= 1e-3, (what, int(off.sum()), got.size)


@pytest.mark.parametrize("h,w,num", [(61, 77, 8), (40, 40, 1), (33, 129, 20)])
def test_raytrace_matches_reference(h, w, num):
    dx, dy, dz = camera_rays(h, w)
    spheres = demo_spheres(num, seed=3)
    before = raytrace.launches
    got = raytrace(t(dx), t(dy), t(dz), t(spheres)).numpy()
    assert raytrace.launches == before       # CPU tensor: plain version
    np.testing.assert_array_equal(
        got, raytrace_plain(t(dx), t(dy), t(dz), t(spheres)).numpy())
    assert (got > 0).any() and (got == 0).any()
    j = [jnp.asarray(a) for a in (dx, dy, dz, spheres)]
    assert_rays_close(got, np.asarray(ref.raytrace(*j)), "ref")
    assert_rays_close(got, np.asarray(pallas_raytrace(*j, bm=8)), "pallas")


def test_raytrace_misses_give_zero_and_out_is_written():
    x = t(np.array([1.0, 0.0], np.float32))
    z = t(np.array([0.0, -1.0], np.float32))     # sideways and backwards
    out = torch.full((2,), 7.0)
    assert raytrace(x, t(np.zeros(2, np.float32)), z,
                    t(demo_spheres()), out=out) is out
    np.testing.assert_array_equal(out.numpy(), [0.0, 0.0])


def test_raytrace_rejects_bad_table():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match=r"\(S, 5\)"):
        raytrace(x, x, x, torch.zeros(3, 4))


@pytest.mark.parametrize("n,L", [(37, 48), (256, 5), (300, 1)])
def test_rap_matches_reference(n, L):
    values = rng.normal(size=(n, L)).astype(np.float32)
    # every edge: 0, L, beyond L, negative, and lengths inside
    lengths = rng.integers(-3, L + 4, size=n).astype(np.int32)
    lengths[:4] = [0, L, L + 7, -5]
    values[2] = values[1]
    before = rap.launches
    got = rap(t(values), t(lengths)).numpy()
    assert rap.launches == before            # CPU tensor: plain version
    np.testing.assert_array_equal(
        got, rap_plain(t(values), t(lengths)).numpy())
    assert got[0] == 0.0 and got[3] == 0.0
    assert got[1] == got[2]                  # a length past L counts as L
    j = (jnp.asarray(values), jnp.asarray(lengths))
    atol = 1e-6 * L
    assert_allclose(got, np.asarray(ref.rap(*j)), rtol=1e-5, atol=atol)
    assert_allclose(got, np.asarray(pallas_rap(*j, bm=8)), rtol=1e-5,
                    atol=atol)


def test_rap_rejects_mismatched_lengths():
    with pytest.raises(ValueError, match="lengths"):
        rap(torch.zeros(4, 3), torch.zeros(5, dtype=torch.int32))


def test_wrappers_write_into_out():
    x = t(rng.uniform(-1, 1, 50).astype(np.float32))
    out = torch.empty(50)
    assert taylor_sin(x, out=out) is out
    with pytest.raises(ValueError, match="out shape"):
        taylor_sin(x, out=torch.empty(49))


@pytest.mark.parametrize("call", [
    lambda x: taylor_sin(x),
    lambda x: mandelbrot(x, x),
    lambda x: matmul(x.view(4, 4), x.view(4, 4)),
    lambda x: gaussian_blur(x.view(4, 4)),
    lambda x: raytrace(x, x, x, x.view(-1)[:15].view(3, 5)),
    lambda x: rap(x.view(4, 4), x[:4].to(torch.int32)),
])
def test_non_cpu_non_cuda_tensor_raises_not_falls_back(call):
    """Only a CPU tensor takes the plain version; others launch or raise."""
    x = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        call(x)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _lib.nvcc_path()


# -- the CUDA kernels' schedules, modelled in plain PyTorch ----------------
# The kernels run only on the card; these models follow their loops, lanes,
# warps and row order step by step on the CPU, with the same f32 operations
# in the same order, and must equal the plain versions, the reference and
# the Pallas kernels bit for bit.

def _cu_constant(source: str, name: str) -> int:
    """The value of ``constexpr int <name> = <value>;`` in csrc/<source>."""
    text = (_lib.CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


MANDEL_UNROLL = _cu_constant("mandelbrot.cu", "kUnroll")


def _mandelbrot_schedule(cre, cim, max_iter, unroll):
    """csrc/mandelbrot.cu's schedule: warps of 32 consecutive points (the
    last padded with lanes that are never alive), a sticky ``alive`` and an
    integer count per lane, groups of ``unroll`` steps between warp votes,
    escaped lanes updating z on into inf and NaN, and the budget's last
    ``max_iter % unroll`` steps one by one, each after a vote.

    Returns:
        The counts as f32 in ``cre``'s shape, and the steps each warp ran.
    """
    n = cre.numel()

    def lanes(x):
        flat = x.reshape(-1)
        return torch.cat([flat, flat.new_zeros(-n % 32)]).view(-1, 32)

    cr, ci = lanes(cre), lanes(cim)
    alive = lanes(torch.ones(n, dtype=torch.bool))
    zr, zi = torch.zeros_like(cr), torch.zeros_like(ci)
    count = torch.zeros(cr.shape, dtype=torch.int32)
    running = torch.ones(cr.shape[0], dtype=torch.bool)
    steps = torch.zeros(cr.shape[0], dtype=torch.int64)

    def vote() -> bool:
        nonlocal running
        running = running & alive.any(1)
        return bool(running.any())

    def step() -> None:
        nonlocal zr, zi, alive, count
        run = running[:, None]
        zr2, zi2 = zr * zr, zi * zi
        alive = torch.where(run, alive & (zr2 + zi2 <= 4.0), alive)
        count = count + (alive & run).to(torch.int32)
        zr, zi = (torch.where(run, zr2 - zi2 + cr, zr),
                  torch.where(run, 2.0 * zr * zi + ci, zi))
        steps.add_(running.to(torch.int64))

    left = max_iter
    while left >= unroll and vote():
        for _ in range(unroll):
            step()
        left -= unroll
    if left < unroll:
        while left > 0 and vote():
            step()
            left -= 1
    return count.reshape(-1)[:n].float().view(cre.shape), steps


def _mandelbrot_all(cre: np.ndarray, cim: np.ndarray, it: int) -> list:
    """The plain version, the reference and the Pallas kernel."""
    return [mandelbrot_plain(t(cre), t(cim), max_iter=it).numpy(),
            np.asarray(ref.mandelbrot(jnp.asarray(cre), jnp.asarray(cim),
                                      it)),
            np.asarray(pallas_mandelbrot(jnp.asarray(cre), jnp.asarray(cim),
                                         max_iter=it, bm=8))]


@pytest.mark.parametrize("side,it", [(31, 32), (64, 64)])
def test_mandelbrot_schedule_matches_reference(side, it):
    re_ = np.linspace(-2.2, 0.8, side, dtype=np.float32)
    im = np.linspace(-1.4, 1.4, side + 3, dtype=np.float32)
    cre, cim = np.meshgrid(re_, im)
    got, _ = _mandelbrot_schedule(t(cre), t(cim), it, MANDEL_UNROLL)
    for want in _mandelbrot_all(cre, cim, it):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("max_iter", sorted({0, 1, MANDEL_UNROLL - 1,
                                             MANDEL_UNROLL + 1, 64, 100}))
def test_mandelbrot_schedule_for_every_budget(max_iter):
    """667 points (the last warp ragged) over the viewport, every 7th with
    |c| up to 1e30 so that z overflows to inf and NaN on escaped lanes,
    at unrolls 1, 2, 4 and 8 and the kernel's."""
    re_ = np.linspace(-2.2, 0.8, 29, dtype=np.float32)
    im = np.linspace(-1.4, 1.4, 23, dtype=np.float32)
    cre, cim = (np.ascontiguousarray(a.ravel()) for a in np.meshgrid(re_,
                                                                      im))
    big = np.array([1e30, -3e29, 2.5, 1e19, -1e30, 0.3], dtype=np.float32)
    cre[::7] = big[np.arange(cre[::7].size) % 6]
    cim[::7] = big[::-1][np.arange(cim[::7].size) % 6]
    wants = _mandelbrot_all(cre, cim, max_iter)
    for unroll in (1, 2, 4, 8, MANDEL_UNROLL):
        got, steps = _mandelbrot_schedule(t(cre), t(cim), max_iter, unroll)
        for want in wants:
            np.testing.assert_array_equal(got.numpy(), want)
        assert int(steps.max()) <= max(max_iter, 0)


def test_mandelbrot_unrolled_budget_is_the_main_paths():
    """csrc/mandelbrot.cu unrolls one budget, kMainIter, in whole groups
    and runs any other in a loop of groups: it must be the budget the main
    path's kernel and the wrapper default to, or the main path would take
    the loop."""
    main = _cu_constant("mandelbrot.cu", "kMainIter")
    ops = importlib.import_module("repro_torch.kernels.ops")
    budgets = {inspect.signature(fn).parameters["max_iter"].default
               for fn in (ops._mandelbrot_kernel_impl, mandelbrot)}
    assert budgets == {main}
    assert main % MANDEL_UNROLL == 0


@pytest.mark.parametrize("unroll", [1, 2, 4, 8])
def test_mandelbrot_schedule_warp_steps_follow_the_unroll_model(unroll):
    """A warp whose slowest lane counts C runs min(64, (C // U + 1) U)
    steps: the count PERF.md weighs against the vote's cost to pick U."""
    re_ = np.linspace(-2.2, 0.8, 96, dtype=np.float32)   # 3 warps a row
    im = np.linspace(-1.4, 1.4, 70, dtype=np.float32)
    cre, cim = np.meshgrid(re_, im)
    got, steps = _mandelbrot_schedule(t(cre), t(cim), 64, unroll)
    slowest = got.reshape(-1, 32).amax(1).long()
    want = torch.clamp((slowest // unroll + 1) * unroll, max=64)
    assert torch.equal(steps, want)
    assert 0 < int((want < 64).sum()) < want.numel()  # warps leave early


def _gaussian_walk(img: torch.Tensor, lo_pad: int, hi_pad: int,
                   run: int = 0) -> torch.Tensor:
    """csrc/gaussian.cu's schedule: runs of ``run`` output rows (0: as its
    launcher sizes them), alternate runs walked up, strips of 128 columns
    with their 2 + 2 halo columns, a ring of row slots filled kDepth rows
    ahead (checked never to overwrite a row before it is read), a 5-row
    window in registers, the vertical pass, the neighbours' columns (the
    halo's at the strip's ends) and the horizontal pass."""
    strip, depth = (_cu_constant("gaussian.cu", k)
                    for k in ("kStrip", "kDepth"))
    slots = depth + 1
    src_rows, W = img.shape
    out_rows = src_rows + lo_pad + hi_pad - 4
    if run == 0:
        run = max(_cu_constant("gaussian.cu", "kRows"),
                  -(-out_rows // 65535))
    out = torch.full((out_rows, W), float("nan"))

    def taps5(a, b, c, d, e):
        s = 0.0625 * a
        s = s + 0.25 * b
        s = s + 0.375 * c
        s = s + 0.25 * d
        return s + 0.0625 * e

    def row(lrow: int, cs: int) -> torch.Tensor:
        """A slot: the strip's columns, then 2 halo columns on the left
        and 2 on the right, zeros where the row or column is missing."""
        slot = torch.zeros(strip + 4)
        sr = lrow - lo_pad
        if 0 <= sr < src_rows:
            cols = torch.cat([torch.arange(cs, cs + strip),
                              torch.tensor([cs - 2, cs - 1, cs + strip,
                                            cs + strip + 1])])
            ok = (cols >= 0) & (cols < W)
            slot[ok] = img[sr, cols[ok]]
        return slot

    for by in range(-(-out_rows // run)):
        r_lo = by * run
        r_hi = min(r_lo + run, out_rows)
        down = by % 2 == 0
        n_steps = r_hi - r_lo + 4

        def lrow(j):
            return r_lo + j if down else r_hi + 3 - j

        for cs in range(0, W, strip):
            ring = [(j, row(lrow(j), cs)) if j < n_steps else None
                    for j in range(depth)] + [None]
            window = [torch.zeros(strip + 4)] * 5
            rd, wr = 0, depth
            for j in range(n_steps):
                held, nw = ring[rd]
                assert held == j
                if j + depth < n_steps:
                    assert ring[wr] is None or ring[wr][0] < j
                    ring[wr] = (j + depth, row(lrow(j + depth), cs))
                rd, wr = (rd + 1) % slots, (wr + 1) % slots
                window = window[1:] + [nw] if down else [nw] + window[:-1]
                if j < 4:
                    continue
                v = taps5(*window)
                ext = torch.cat([v[strip:strip + 2], v[:strip],
                                 v[strip + 2:]])
                o = taps5(*(ext[d:d + strip] for d in range(5)))
                r = lrow(j - 4) if down else lrow(j)
                end = min(cs + strip, W)
                out[r, cs:end] = o[:end - cs]
    return out


@pytest.mark.parametrize("lo,hi", [(lo, hi) for lo in range(3)
                                   for hi in range(3)])
@pytest.mark.parametrize("h", [6, 23, 75])
@pytest.mark.parametrize("w", [1, 3, 4, 5, 127, 128, 129, 516])
def test_gaussian_walk_matches_plain_and_reference(w, h, lo, hi):
    """Runs of 16 rows: one run shorter than a run (h = 6), a full run and
    a short one walked up (23), five runs alternating (75)."""
    img = rng.normal(size=(h, w)).astype(np.float32)
    got = _gaussian_walk(t(img), lo, hi).numpy()
    want = gaussian_blur_halo_plain(t(img), lo_pad=lo, hi_pad=hi).numpy()
    np.testing.assert_array_equal(got, want)
    padded = np.pad(img, ((lo, hi), (0, 0)))
    ref_rows = np.asarray(ref.gaussian_blur(jnp.asarray(padded)))
    np.testing.assert_array_equal(got, ref_rows[2:2 + got.shape[0]])


@pytest.mark.parametrize("run", [1, 5, 24, 64, 71])
def test_gaussian_walk_other_run_lengths(run):
    """Runs of other lengths (the launcher takes 64 over mapped host memory
    and longer ones past the grid's y limit), from one row to all 71,
    walked down and up."""
    img = rng.normal(size=(75, 129)).astype(np.float32)
    got = _gaussian_walk(t(img), 2, 0, run=run).numpy()
    np.testing.assert_array_equal(
        got, gaussian_blur_halo_plain(t(img), lo_pad=2, hi_pad=0).numpy())


# lanes that share a row: on device memory, on mapped host memory
RAP_SEGMENTS = tuple(_cu_constant("rap.cu", k)
                     for k in ("kSegment", "kSegmentHost"))


def _rap_schedule(values: np.ndarray, lengths: np.ndarray, vec: bool,
                  seg: int) -> np.ndarray:
    """csrc/rap.cu's schedule: warps of 32 rows (the last padded with rows
    of length 0), ``seg`` lanes a row and 32 / seg rows at once, lane
    ``sub`` summing the utilities of chunks sub, sub + seg, ... of 4
    columns in order (columns past the length count as 0), the segment's
    lanes added by xor shuffles, every lane ending with the same sum.
    ``vec``: each chunk is one 16-byte load, else 4-byte loads of its
    counted columns; every read is checked to lie in the row and, for
    4-byte loads, before the length."""
    n, L = values.shape
    f32 = np.float32
    out = np.full(n, np.nan, f32)
    for r0 in range(0, n, 32):
        lens = [min(max(int(lengths[r]), 0), L) if r < n else 0
                for r in range(r0, r0 + 32)]
        for lane_row in range(32):         # step * rows at once + segment
            row, length = r0 + lane_row, lens[lane_row]
            sums = []
            for sub in range(seg):
                acc = f32(0.0)
                for c in range(sub, -(-length // 4), seg):
                    cols = range(4 * c, 4 * c + 4)
                    read = cols if vec else [j for j in cols if j < length]
                    assert all(j < L for j in read), (row, c, L)
                    for j in cols:
                        v = values[row, j] if j < length else f32(0.0)
                        acc = f32(acc + np.log1p(np.maximum(v, f32(0.0))))
                sums.append(acc)
            o = 1
            while o < seg:
                sums = [f32(sums[i] + sums[i ^ o]) for i in range(len(sums))]
                o <<= 1
            assert len(set(sums)) == 1
            if row < n:
                out[row] = sums[0]
    return out


@pytest.mark.parametrize("seg", RAP_SEGMENTS)
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("L", [1, 3, 4, 47, 48, 100])
def test_rap_schedule_matches_plain_and_reference(L, offset, seg):
    """Two warps of rows and a ragged third, lengths below 0, 0, 1-3, L and
    above L among random ones, NaN in every column past a row's length (a
    read there would show), rows of a matrix at a float offset of 0-3 (the
    4-byte path; offset 0 with L % 4 == 0 takes 16-byte chunks), with the
    segments device memory and mapped host memory take."""
    n = 70
    base = rng.normal(size=n * L + offset).astype(np.float32)
    values = base[offset:].reshape(n, L)
    lengths = rng.integers(-3, L + 4, size=n).astype(np.int32)
    lengths[:9] = [-4, 0, 1, 2, 3, L, L + 1, L + 9, max(L - 1, 0)]
    for r, length in enumerate(lengths):
        values[r, max(length, 0):] = np.nan
    vec = L % 4 == 0 and offset == 0
    got = _rap_schedule(values, lengths, vec, seg)
    want = rap_plain(t(values), t(lengths)).numpy()
    atol = 1e-6 * L
    assert_allclose(got, want, rtol=1e-5, atol=atol)
    assert got[0] == got[1] == 0.0
    j = (jnp.asarray(values), jnp.asarray(lengths))
    assert_allclose(got, np.asarray(ref.rap(*j)), rtol=1e-5, atol=atol)
    assert_allclose(got, np.asarray(pallas_rap(*j, bm=8)), rtol=1e-5,
                    atol=atol)


def test_rap_main_path_rows_load_up_front():
    """A segment loads kRowChunks chunks of a row a turn ahead; the main
    path's rows (the demo width 48, Table 1's L) must fit in them, else
    they take the loop that loads a chunk at a time. Segments tile a warp."""
    ops = importlib.import_module("repro_torch.kernels.ops")
    assert all(32 % seg == 0 for seg in RAP_SEGMENTS)
    assert 4 * _cu_constant("rap.cu", "kRowChunks") >= ops._RAP_DEMO_L == 48


RAY_RAYS = _cu_constant("raytrace.cu", "kRays")


def _ray_schedule(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor,
                  spheres: torch.Tensor, head: int, vec: bool):
    """csrc/raytrace.cu's schedule, on the plain version's f32 operations:
    ``head`` rays one by one, then threads of kRays consecutive rays and
    warps of 32 threads (a turn's last warp padded with zero rays), the
    tail one by one; ``vec`` False: every ray on its own. For each sphere
    in order every ray gets b and disc; the root, t and the hit tests run
    only where a warp vote (one ray alone: its own test) finds disc > 0.

    Returns:
        The shades, and how many (warp, sphere) votes skipped the root.
    """
    n = dx.numel()
    head = min(head, n) if vec else n
    nv = (n - head) // RAY_RAYS if vec else 0
    body = RAY_RAYS * nv
    group = torch.arange(n)              # one ray alone is its own group
    warp_rays = 32 * RAY_RAYS
    group[head:head + body] = n + torch.arange(body) // warp_rays
    zero, one = dx.new_zeros(()), dx.new_ones(())
    light, eps = dx.new_tensor(0.577), dx.new_tensor(1e-3)
    best_t = torch.full_like(dx, float("inf"))
    shade = torch.zeros_like(dx)
    skipped = 0
    for cx, cy, cz, r, alb in spheres.unbind():
        b = dx * cx + dy * cy + dz * cz
        c = cx * cx + cy * cy + cz * cz - r * r
        disc = b * b - c
        pos = disc > zero
        votes = torch.zeros(n + -(-body // warp_rays) + 1, dtype=torch.bool)
        votes.index_put_((group,), pos, accumulate=True)
        if body % warp_rays and c < zero:    # a padded lane's zero ray
            votes[group[head + body - 1]] = True
        run = votes[group]
        skipped += int((~votes[n:n + -(-body // warp_rays)]).sum())
        root = torch.sqrt(torch.maximum(disc[run], zero).double()).to(
            dx.dtype)
        t = torch.full_like(dx, float("nan"))
        t[run] = b[run] - root
        hit = run & pos & (t > eps) & (t < best_t)
        nx, ny, nz = dx * t - cx, dy * t - cy, dz * t - cz
        lam = torch.maximum(zero, (nx * light + ny * light + nz * light)
                            * (one / torch.maximum(r, r.new_tensor(1e-6))))
        best_t = torch.where(hit, t, best_t)
        shade = torch.where(hit, alb * lam, shade)
    return shade, skipped


def _grazing_rays(n: int, spheres: np.ndarray, offset: int, seed: int):
    """n unit rays at a float offset into their buffers: the first half a
    diagonal sweep of the camera's field, the second aimed within 1e-4 of
    a sphere's silhouette (disc near 0), sphere by sphere."""
    g = np.random.default_rng(seed)
    c, r = spheres[:, :3].astype(np.float64), spheres[:, 3].astype(np.float64)
    k = np.sort(g.integers(0, len(spheres), n))
    # a direction at angle asin(r/|c|) (1 +- 1e-4) from the centre's
    axis = c[k] / np.linalg.norm(c[k], axis=1, keepdims=True)
    side = np.cross(axis, g.normal(size=(n, 3)))
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    ang = np.arcsin(np.clip(r[k] / np.linalg.norm(c[k], axis=1), 0, 1)) * (
        1 + g.uniform(-1e-4, 1e-4, n))
    d = np.cos(ang)[:, None] * axis + np.sin(ang)[:, None] * side
    sweep = np.linspace(-0.4, 0.4, n // 2)
    d[:n // 2] = np.stack([sweep, sweep[::-1], np.ones_like(sweep)], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bufs = [np.empty(n + offset, np.float32) for _ in range(3)]
    for i, buf in enumerate(bufs):
        buf[offset:] = d[:, i]
    return [buf[offset:] for buf in bufs]


@pytest.mark.parametrize("num", [8, 1, 9])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [4697, 1, 3])
def test_raytrace_vote_skip_equals_plain(n, offset, num):
    """The warp vote's skip equals the plain version bit for bit, rays at a
    float offset of 0-3 peeling ``head`` rays to a 16-byte boundary (and,
    out at another offset, ray by ray), n not a multiple of 4; half the
    rays graze a silhouette."""
    spheres = demo_spheres(num, seed=3)
    rays = [t(a) for a in _grazing_rays(n, spheres, offset, seed=n + offset)]
    sph = t(spheres)
    want = raytrace_plain(*rays, sph)
    head = (4 - offset) % 4
    for vec in (False, True):
        got, skipped = _ray_schedule(*rays, sph, head, vec)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    if n > 1000:
        assert (want > 0).sum() > 100 and (want == 0).sum() > 100
        votes = -(-((n - head) // RAY_RAYS) // 32) * num
        assert 0 < skipped < votes          # the vote skips some, not all
        j = [jnp.asarray(a.numpy()) for a in (*rays, sph)]
        assert_rays_close(got.numpy(), np.asarray(ref.raytrace(*j)), "ref")


def test_raytrace_unrolled_scene_is_the_main_paths():
    """csrc/raytrace.cu unrolls the sphere loop for one scene size,
    kMainSpheres: it must be demo_spheres()' default, the scene the main
    path's ray kernel takes when none is given, or the main path would
    take the runtime loop."""
    main = _cu_constant("raytrace.cu", "kMainSpheres")
    assert inspect.signature(demo_spheres).parameters["num"].default == main
    ops = importlib.import_module("repro_torch.kernels.ops")
    (scene,) = [a.default for a in ops._ray_kernel_impl(impl="pallas").args
                if a.name == "spheres"]
    assert scene().shape == (main, 5)


class _TorchCalls(torch.overrides.TorchFunctionMode):
    """Counts the Python-level torch calls made in its block."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.count += 1
        return func(*args, **(kwargs or {}))


def _plain_cases():
    g = torch.Generator().manual_seed(7)
    x = torch.rand(300, generator=g) * 6 - 3
    img = torch.rand(24, 10, generator=g)
    d = torch.randn(3, 200, generator=g)
    d = (d / d.norm(dim=0)).contiguous()
    spheres = torch.from_numpy(demo_spheres(8))
    vals = torch.randn(50, 9, generator=g)
    lens = torch.randint(-1, 11, (50,), generator=g, dtype=torch.int32)
    mods = {m: importlib.import_module(f"repro_torch.kernels.{m}")
            for m in ("taylor", "mandelbrot", "gaussian", "raytrace", "rap")}
    ray = mods["raytrace"]
    return {
        "taylor": (lambda: taylor_sin_plain(x, out=torch.empty(300)),
                   lambda: mods["taylor"]._taylor_body(x, 12, None)),
        "mandelbrot": (lambda: mandelbrot_plain(x, x.flip(0)),
                       lambda: mods["mandelbrot"]._mandelbrot_body(
                           x, x.flip(0), 64, None)),
        "gaussian": (lambda: gaussian_blur_halo_plain(img, lo_pad=2),
                     lambda: mods["gaussian"]._blur_body(
                         img, list(mods["gaussian"].GAUSS_TAPS), 2, 0, 22,
                         None)),
        "ray": (lambda: raytrace_plain(d[0], d[1], d[2], spheres),
                lambda: ray._raytrace_body(
                    d[0], d[1], d[2], spheres,
                    [ray.LIGHT, ray.HIT_EPS, ray.MIN_RADIUS], None)),
        "rap": (lambda: rap_plain(vals, lens),
                lambda: mods["rap"]._rap_body(vals, lens, None)),
    }


@pytest.mark.parametrize("name", ["taylor", "mandelbrot", "gaussian", "ray",
                                  "rap"])
def test_plain_version_runs_as_one_call_on_the_cpu(name):
    """On CPU tensors a plain version runs its body as one TorchScript call
    (``_lib.run_plain``): a handful of Python-level torch calls (its
    checks and the call) where the body op by op
    makes one a step (mandelbrot: hundreds). Each of those gives up the
    interpreter lock and takes it back, which a co-execution pair's CUDA
    worker made the CPU unit wait for. The graph's result is the eager
    body's, bit for bit."""
    plain, body = _plain_cases()[name]
    want = body()
    got = plain()
    assert got.dtype == want.dtype and torch.equal(got, want)
    with _TorchCalls() as graph:
        plain()
    with _TorchCalls() as eager:
        body()
    assert graph.count <= 10 and graph.count < eager.count
