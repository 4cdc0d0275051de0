"""The ``<name>_op`` wrappers and the paper's six typed co-executable
kernels, along the reference's implementation axis.

Two surfaces live here, as in the reference's ``repro/kernels/ops.py``:

* ``<name>_op(...)``: wrappers with implementation dispatch along
  :data:`KERNEL_IMPLS`. ``impl="pallas"`` calls the hand-kernel wrapper,
  which launches the CUDA kernel on CUDA tensors and runs the plain
  PyTorch version on CPU tensors (the reference's interpret mode has no
  counterpart); ``impl="xla"`` and ``impl="ref"`` both call the plain
  version on the tensor's device. ``xla`` is ``ref``'s body under its own
  registry object: it stays an accepted name so the reference's specs
  load, but no ``torch.compile`` stands in for XLA, since it would bring
  a C++ toolchain into every CPU run and change nothing the port checks. The
  default is backend-aware (:func:`default_impl`): the hand kernel where
  a CUDA card is, the plain version elsewhere.
* the paper's six benchmarks as typed co-executable kernels. Each
  declares the reference's per-argument partition semantics (SPLIT along
  an axis, with a 2-row halo for the Gaussian stencil, BROADCAST for
  MatMul's ``B`` and Ray's sphere table) and output slot, and registers
  in the :mod:`repro_torch.api.registry` kernel registry with the
  reference's demo-input generator, so one numpy ``Generator`` gives both
  packages the same arrays. Each factory takes ``impl``: the hand-kernel
  body under ``pallas``, the plain body under ``xla`` and ``ref``, with
  one set of argument specs, output spec, ``rowwise`` flag and demo
  inputs for all three, so the data planes and the fusion keys treat
  them alike.

Taylor, Mandelbrot and Rap declare ``rowwise``: their bodies ignore the
offset and compute each row from that row alone, so a fused batch runs
its member-stacked chunk as one flat chunk, one hand-kernel launch per
package (:mod:`repro_torch.core.engine`). They are the three registered
kernels that can fuse at all, since fusion takes only all-split kernels.
A fused batch holds one kernel object, so two variants never share one.
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.core.dataplane import (ArgRole, ArgSpec, CoexecKernel,
                                        OutputSpec)

from . import ref
from .flash_attention import flash_attention
from .gaussian import (gaussian_blur, gaussian_blur_halo,
                       gaussian_blur_halo_plain)
from .linear_attention import linear_attention
from .mandelbrot import mandelbrot
from .matmul import matmul
from .rap import rap
from .raytrace import demo_spheres, raytrace
from .taylor import taylor_sin

#: The implementation-variant axis every wrapper and registered kernel
#: understands: "pallas" = the hand CUDA kernel (the plain version on CPU
#: tensors), "xla" and "ref" = the plain version (one body, two registry
#: objects).
KERNEL_IMPLS = ("pallas", "xla", "ref")

_GAUSS_DEMO_W = 96        # demo image width (rows are the index space)
_MATMUL_DEMO_K = 32       # demo inner dim; B is (K, N2)
_MATMUL_DEMO_N2 = 24
_RAP_DEMO_L = 48          # demo candidate-resource count per row


def default_impl() -> str:
    """The backend-aware default variant: the hand kernel where a CUDA
    card is, the plain version elsewhere.

    Returns:
        ``"pallas"`` when ``torch.cuda.is_available()``, else ``"xla"``.
    """
    return "pallas" if torch.cuda.is_available() else "xla"


def resolve_impl(impl: str | None = None) -> str:
    """Canonicalize an impl request to one of :data:`KERNEL_IMPLS`.

    Args:
        impl: ``None`` / ``""`` / ``"auto"`` resolve via
            :func:`default_impl`; otherwise must be a member of
            :data:`KERNEL_IMPLS`.

    Returns:
        The canonical implementation name.

    Raises:
        ValueError: unknown implementation name.
    """
    if impl in (None, "", "auto"):
        return default_impl()
    if impl not in KERNEL_IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; choose from "
                         f"{('auto',) + KERNEL_IMPLS}")
    return impl


def _variant(hand_fn: Callable, plain_fn: Callable, impl: str,
             **options) -> Callable:
    """One variant's call with its options bound: the hand-kernel wrapper
    under ``pallas``, the plain version under ``xla`` and ``ref``."""
    return functools.partial(hand_fn if impl == "pallas" else plain_fn,
                             **options)


def _dispatch(hand_fn: Callable, plain_fn: Callable, impl: str | None,
              *a, **kw):
    return _variant(hand_fn, plain_fn, resolve_impl(impl), **kw)(*a)


def matmul_op(a, b, *, impl: str | None = None, **kw):
    """C = A @ B by the ``impl`` variant (see the module docstring)."""
    return _dispatch(matmul, ref.matmul, impl, a, b, **kw)


def gaussian_op(img, *, impl: str | None = None, **kw):
    """The whole image's zero-padded 5x5 blur by the ``impl`` variant."""
    return _dispatch(gaussian_blur, ref.gaussian_blur, impl, img, **kw)


def taylor_op(x, *, impl: str | None = None, **kw):
    """Taylor-series sin(x) by the ``impl`` variant."""
    return _dispatch(taylor_sin, ref.taylor_sin, impl, x, **kw)


def mandelbrot_op(cre, cim, *, impl: str | None = None, **kw):
    """Mandelbrot escape counts by the ``impl`` variant."""
    return _dispatch(mandelbrot, ref.mandelbrot, impl, cre, cim, **kw)


def raytrace_op(dx, dy, dz, spheres, *, impl: str | None = None, **kw):
    """Nearest-hit sphere shading by the ``impl`` variant."""
    return _dispatch(raytrace, ref.raytrace, impl, dx, dy, dz, spheres, **kw)


def rap_op(values, lengths, *, impl: str | None = None, **kw):
    """Resource-allocation row utilities by the ``impl`` variant."""
    return _dispatch(rap, ref.rap, impl, values, lengths, **kw)


def flash_attention_op(q, k, v, *, impl: str | None = None, **kw):
    """Prefill attention by the ``impl`` variant; ``ref`` and ``xla`` run
    :func:`ref.attention <repro_torch.kernels.ref.attention>`."""
    return _dispatch(flash_attention, ref.attention, impl, q, k, v, **kw)


def linear_attention_op(q, k, v, log_decay, *, impl: str | None = None,
                        **kw):
    """Gated linear attention by the ``impl`` variant; ``ref`` and ``xla``
    run the exact sequential recurrence."""
    return _dispatch(linear_attention, ref.linear_attention, impl,
                     q, k, v, log_decay, **kw)


# ---------------------------------------------------------------------------
# Typed co-executable kernels (registered; the paper's Listing-1 benchmarks)
# ---------------------------------------------------------------------------
# Factories are memoized so repeated build_kernel() calls return the same
# CoexecKernel object: the units' warm-up memo and the engine's fusion keys
# hash on it. Each factory takes the `impl` axis; the public entry resolves
# "auto" before hitting the cache, so build_kernel("taylor") and
# build_kernel("taylor", impl=default_impl()) share one object.


def _impl_axis(inner: Callable) -> Callable:
    """Wrap a cached factory so its ``impl`` option resolves "auto" first.

    ``inner`` is the ``lru_cache``d builder keyed on the *canonical* impl
    name; resolving before the cache keeps the memoization contract
    (same options -> same kernel object) intact across the auto default,
    so ``build_kernel("taylor")``, ``impl="auto"``, ``impl=""`` and
    ``impl=default_impl()`` share one object, which the engine's fusion
    keys hash on.
    """
    @functools.wraps(inner)
    def factory(*, impl: str = "auto", **options) -> CoexecKernel:
        return inner(impl=resolve_impl(impl), **options)
    return factory


@functools.lru_cache(maxsize=None)
def _taylor_kernel_impl(*, impl: str, terms: int = 12) -> CoexecKernel:
    """Taylor-series sin over a split 1-D array (regular, compute-bound)."""
    sin = _variant(taylor_sin, ref.taylor_sin, impl, terms=int(terms))

    def fn(offset, x, *, out):
        return sin(x, out=out)

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
    The plain body reads the same chunk through the halo blur's plain
    version, so co-executed output matches :func:`ref.gaussian_blur
    <repro_torch.kernels.ref.gaussian_blur>` on the whole image.
    """
    blur = _variant(gaussian_blur_halo, gaussian_blur_halo_plain, impl)

    def fn(offset, img, *, out):
        return blur(img.rows, lo_pad=img.lo_pad, hi_pad=img.hi_pad, out=out)

    return CoexecKernel("gaussian", fn, (ArgSpec("img", halo=2),),
                        OutputSpec(trailing=lambda ins: (ins[0].shape[1],)))


_gaussian_kernel = _impl_axis(_gaussian_kernel_impl)


def _gaussian_inputs(n: int, rng) -> list:
    return [rng.normal(size=(n, _GAUSS_DEMO_W)).astype(np.float32)]


@functools.lru_cache(maxsize=None)
def _matmul_kernel_impl(*, impl: str) -> CoexecKernel:
    """Row-split MatMul: A splits by rows, B broadcasts whole."""
    mm = _variant(matmul, ref.matmul, impl)

    def fn(offset, a_rows, b, *, out):
        return mm(a_rows, b, out=out)

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
    escape = _variant(mandelbrot, ref.mandelbrot, impl,
                      max_iter=int(max_iter))

    def fn(offset, cre, cim, *, out):
        return escape(cre, cim, out=out)

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
    trace = _variant(raytrace, ref.raytrace, impl)

    def fn(offset, dx, dy, dz, spheres, *, out):
        return trace(dx, dy, dz, spheres, out=out)

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
    rows = _variant(rap, ref.rap, impl)

    def fn(offset, values, lengths, *, out):
        return rows(values, lengths, out=out)

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
