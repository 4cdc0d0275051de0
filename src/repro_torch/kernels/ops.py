"""The paper's six benchmarks as typed co-executable kernels.

Each kernel declares the reference's per-argument partition semantics —
SPLIT along an axis (with a 2-row halo for the Gaussian stencil),
BROADCAST for MatMul's ``B`` and Ray's sphere table — and output slot,
and registers in the :mod:`repro_torch.api.registry` kernel registry
with the reference's demo-input generator, so one numpy ``Generator``
gives both packages the same arrays.

The implementation axis has one choice, ``auto``
(:data:`~repro_torch.api.spec.KERNEL_IMPL_CHOICES`): every kernel calls
its wrapper, which launches the hand CUDA kernel for CUDA tensors and
runs the plain PyTorch version for CPU tensors (the CPU unit's
implementation).

Taylor, Mandelbrot and Rap declare ``rowwise``: their bodies ignore the
offset and compute each row from that row alone, so a fused batch runs
its member-stacked chunk as one flat chunk, one hand-kernel launch per
package (:mod:`repro_torch.core.engine`). They are the three registered
kernels that can fuse at all, since fusion takes only all-split kernels.
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np

from repro_torch.core.dataplane import (ArgRole, ArgSpec, CoexecKernel,
                                        OutputSpec)

from repro_torch.api.spec import KERNEL_IMPL_CHOICES

from .gaussian import gaussian_blur_halo
from .mandelbrot import mandelbrot
from .matmul import matmul
from .rap import rap
from .raytrace import demo_spheres, raytrace
from .taylor import taylor_sin

_GAUSS_DEMO_W = 96        # demo image width (rows are the index space)
_MATMUL_DEMO_K = 32       # demo inner dim; B is (K, N2)
_MATMUL_DEMO_N2 = 24
_RAP_DEMO_L = 48          # demo candidate-resource count per row


def resolve_impl(impl: str | None = None) -> str:
    """Canonicalize an impl request to one of :data:`KERNEL_IMPL_CHOICES`.

    Raises:
        ValueError: anything else, naming the port's choices (the
            reference's ``pallas`` / ``xla`` / ``ref`` do not exist here).
    """
    if impl not in (None, "", *KERNEL_IMPL_CHOICES):
        raise ValueError(f"unknown kernel impl {impl!r}; the port "
                         f"serves {KERNEL_IMPL_CHOICES}")
    return "auto"


def _impl_axis(inner: Callable) -> Callable:
    """Wrap a cached factory so its ``impl`` option resolves "auto" first.

    ``inner`` is the ``lru_cache``d builder keyed on the *canonical* impl
    name; resolving before the cache keeps the memoization contract
    (same options -> same kernel object) intact across the auto default,
    so ``build_kernel("taylor")``, ``impl="auto"`` and ``impl=""`` share
    one object, which the engine's fusion keys hash on.
    """
    @functools.wraps(inner)
    def factory(*, impl: str = "auto", **options) -> CoexecKernel:
        return inner(impl=resolve_impl(impl), **options)
    return factory


@functools.lru_cache(maxsize=None)
def _taylor_kernel_impl(*, impl: str, terms: int = 12) -> CoexecKernel:
    """Taylor-series sin over a split 1-D array (regular, compute-bound)."""

    def fn(offset, x, *, out, _terms=int(terms)):
        return taylor_sin(x, terms=_terms, out=out)

    return CoexecKernel("taylor", fn, (ArgSpec("x"),), OutputSpec(),
                        rowwise=True)


_taylor_kernel = _impl_axis(_taylor_kernel_impl)


def _taylor_inputs(n: int, rng) -> list:
    return [rng.uniform(-2, 2, n).astype(np.float32)]


@functools.lru_cache(maxsize=None)
def _gaussian_kernel_impl(*, impl: str) -> CoexecKernel:
    """Separable 5x5 blur; rows split with a 2-row zero-filled halo.

    The halo chunk says which context rows lie beyond the image, so the
    kernel treats them as the zero padding of the whole-image stencil.
    """

    def fn(offset, img, *, out):
        return gaussian_blur_halo(img.rows, lo_pad=img.lo_pad, hi_pad=img.hi_pad, out=out)

    return CoexecKernel("gaussian", fn, (ArgSpec("img", halo=2),),
                        OutputSpec(trailing=lambda ins: (ins[0].shape[1],)))


_gaussian_kernel = _impl_axis(_gaussian_kernel_impl)


def _gaussian_inputs(n: int, rng) -> list:
    return [rng.normal(size=(n, _GAUSS_DEMO_W)).astype(np.float32)]


@functools.lru_cache(maxsize=None)
def _matmul_kernel_impl(*, impl: str) -> CoexecKernel:
    """Row-split MatMul: A splits by rows, B broadcasts whole."""

    def fn(offset, a_rows, b, *, out):
        return matmul(a_rows, b, out=out)

    return CoexecKernel(
        "matmul", fn,
        (ArgSpec("a"), ArgSpec("b", role=ArgRole.BROADCAST)),
        OutputSpec(trailing=lambda ins: (ins[1].shape[1],)))


_matmul_kernel = _impl_axis(_matmul_kernel_impl)


def _matmul_inputs(n: int, rng) -> list:
    return [rng.normal(size=(n, _MATMUL_DEMO_K)).astype(np.float32),
            rng.normal(size=(_MATMUL_DEMO_K,
                             _MATMUL_DEMO_N2)).astype(np.float32)]


@functools.lru_cache(maxsize=None)
def _mandelbrot_kernel_impl(*, impl: str, max_iter: int = 64) -> CoexecKernel:
    """Escape iterations over split coordinate arrays (irregular)."""

    def fn(offset, cre, cim, *, out, _it=int(max_iter)):
        return mandelbrot(cre, cim, max_iter=_it, out=out)

    return CoexecKernel("mandelbrot", fn,
                        (ArgSpec("cre"), ArgSpec("cim")), OutputSpec(),
                        rowwise=True)


_mandelbrot_kernel = _impl_axis(_mandelbrot_kernel_impl)


def _mandelbrot_inputs(n: int, rng) -> list:
    return [rng.uniform(-2.2, 0.8, n).astype(np.float32),
            rng.uniform(-1.4, 1.4, n).astype(np.float32)]


@functools.lru_cache(maxsize=None)
def _ray_kernel_impl(*, impl: str) -> CoexecKernel:
    """Ray tracing: split ray directions, broadcast sphere scene.

    The scene is a trailing BROADCAST argument with a default (the demo
    scene), so both ``launch(n, kernel, [dx, dy, dz])`` and an explicit
    ``[dx, dy, dz, spheres]`` work.
    """

    def fn(offset, dx, dy, dz, spheres, *, out):
        return raytrace(dx, dy, dz, spheres, out=out)

    return CoexecKernel(
        "ray", fn,
        (ArgSpec("dx"), ArgSpec("dy"), ArgSpec("dz"),
         ArgSpec("spheres", role=ArgRole.BROADCAST, default=demo_spheres)),
        OutputSpec())


_ray_kernel = _impl_axis(_ray_kernel_impl)


def _ray_inputs(n: int, rng) -> list:
    dx, dy = rng.uniform(-0.4, 0.4, (2, n)).astype(np.float32)
    dz = np.sqrt(np.maximum(1 - dx**2 - dy**2, 0.5)).astype(np.float32)
    return [dx, dy, dz]


@functools.lru_cache(maxsize=None)
def _rap_kernel_impl(*, impl: str) -> CoexecKernel:
    """Resource-allocation rows: values and lengths split together."""

    def fn(offset, values, lengths, *, out):
        return rap(values, lengths, out=out)

    return CoexecKernel("rap", fn,
                        (ArgSpec("values"), ArgSpec("lengths")),
                        OutputSpec(), rowwise=True)


_rap_kernel = _impl_axis(_rap_kernel_impl)


def _rap_inputs(n: int, rng) -> list:
    return [rng.normal(size=(n, _RAP_DEMO_L)).astype(np.float32),
            rng.integers(0, _RAP_DEMO_L, size=n).astype(np.int32)]


def _register_builtin_kernels() -> None:
    """Idempotently register the paper's six kernels (import side)."""
    from repro_torch.api.registry import register_kernel

    register_kernel("taylor", _taylor_kernel, fields=("terms", "impl"),
                    demo_inputs=_taylor_inputs, overwrite=True)
    register_kernel("gaussian", _gaussian_kernel, fields=("impl",),
                    demo_inputs=_gaussian_inputs, overwrite=True)
    register_kernel("matmul", _matmul_kernel, fields=("impl",),
                    demo_inputs=_matmul_inputs, overwrite=True)
    register_kernel("mandelbrot", _mandelbrot_kernel,
                    fields=("max_iter", "impl"),
                    demo_inputs=_mandelbrot_inputs, overwrite=True)
    register_kernel("ray", _ray_kernel, fields=("impl",),
                    demo_inputs=_ray_inputs, overwrite=True)
    register_kernel("rap", _rap_kernel, fields=("impl",),
                    demo_inputs=_rap_inputs, overwrite=True)


_register_builtin_kernels()
