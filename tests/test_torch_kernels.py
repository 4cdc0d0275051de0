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
  k with one rounding per multiply and add, XLA and Pallas in other
  orders, so the error grows with the inner dimension;
* mandelbrot: exact — escape counts are integers and every operation is
  a single IEEE rounding in both packages.
"""
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
from repro.kernels.taylor import taylor_sin as pallas_taylor
from repro_torch.kernels import (_lib, gaussian_blur, gaussian_blur_halo,
                                 gaussian_blur_halo_plain, mandelbrot,
                                 mandelbrot_plain, matmul, matmul_plain,
                                 taylor_sin, taylor_sin_plain)

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
    got = matmul(t(a), t(b)).numpy()
    np.testing.assert_array_equal(got, matmul_plain(t(a), t(b)).numpy())
    atol = 1e-6 * k
    assert_allclose(got, np.asarray(ref.matmul(jnp.asarray(a),
                                               jnp.asarray(b))),
                    rtol=1e-5, atol=atol)
    assert_allclose(got, np.asarray(pallas_matmul(jnp.asarray(a),
                                                  jnp.asarray(b), bm=32,
                                                  bn=32, bk=32)),
                    rtol=1e-5, atol=atol)


def test_matmul_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="compose"):
        matmul(torch.zeros(3, 4), torch.zeros(5, 2))


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
