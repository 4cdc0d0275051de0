"""Ray-sphere nearest-hit Lambert shading (paper benchmark: Ray).

:func:`raytrace` launches the CUDA kernel in ``csrc/raytrace.cu`` for CUDA
tensors and runs :func:`raytrace_plain` for CPU tensors. It replaces the
Pallas kernel ``repro/kernels/raytrace.py`` ``raytrace`` (body
``_ray_kernel``). Kernel and plain version run the same IEEE operations
in the same order, so they agree bit for bit.

The scene is an (S, 5) table of spheres, rows [cx, cy, cz, r, albedo];
the rays are unit directions from the origin, one per element of
``dx``/``dy``/``dz``. :func:`demo_spheres` is the reference's demo scene,
drawn with the same numpy generator calls.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _lib

LIGHT = 0.577           # each component of the light direction
HIT_EPS = 1e-3          # a hit needs t > HIT_EPS
MIN_RADIUS = 1e-6       # 1 / max(r, MIN_RADIUS)
MAX_SPHERES = 2048      # the kernel's shared-memory table (32 B a sphere)


def demo_spheres(num: int = 8, seed: int = 3) -> np.ndarray:
    """A reproducible little scene: ``num`` spheres in front of the camera.

    The same ``default_rng(seed)`` draws as the reference's
    ``demo_spheres``, rounded to f32.

    Returns:
        A (num, 5) float32 array, rows [cx, cy, cz, r, albedo].
    """
    rng = np.random.default_rng(seed)
    c = rng.uniform(-2.0, 2.0, size=(num, 3)) + np.array([0.0, 0.0, 5.0])
    r = rng.uniform(0.3, 1.0, size=(num, 1))
    alb = rng.uniform(0.4, 1.0, size=(num, 1))
    return np.concatenate([c, r, alb], axis=1).astype(np.float32)


def _check(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor,
           spheres: torch.Tensor, out: Optional[torch.Tensor]) -> None:
    if not dx.shape == dy.shape == dz.shape:
        raise ValueError(f"raytrace: dx {tuple(dx.shape)}, dy "
                         f"{tuple(dy.shape)} and dz {tuple(dz.shape)} "
                         f"differ in shape")
    if spheres.dim() != 2 or spheres.shape[1] != 5:
        raise ValueError(f"raytrace: spheres must be (S, 5), got "
                         f"{tuple(spheres.shape)}")
    if out is not None and out.shape != dx.shape:
        raise ValueError(f"raytrace: out shape {tuple(out.shape)} != "
                         f"{tuple(dx.shape)}")


def raytrace_plain(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor,
                   spheres: torch.Tensor, *,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Nearest-hit shading in plain PyTorch (any device), reference order.

    Every operation rounds as IEEE f32 does, on any device, so the result
    equals the kernel's bit for bit. Two choices keep it so. Every constant
    is an f32 tensor on the rays' device: CUDA PyTorch turns division by a
    Python scalar into a multiplication by its reciprocal. The square root
    is taken in f64 and rounded to f32: PyTorch's vectorised f32 square
    root on the CPU is not correctly rounded, and an f64 root within an
    f64 ulp of the exact one rounds to the correctly rounded f32 root
    (the exact root of an f32 number never lies that close to a rounding
    midpoint).
    """
    _check(dx, dy, dz, spheres, out)

    def const(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=dx.dtype, device=dx.device)

    zero, one = const(0.0), const(1.0)
    light, eps, rmin = const(LIGHT), const(HIT_EPS), const(MIN_RADIUS)
    best_t = torch.full_like(dx, float("inf"))
    shade = torch.zeros_like(dx)
    for row in spheres.to(device=dx.device, dtype=dx.dtype):
        cx, cy, cz, r, alb = row.unbind()
        # |t d - c|^2 = r^2 for unit d: t^2 - 2 t (d.c) + |c|^2 - r^2 = 0
        b = dx * cx + dy * cy + dz * cz
        c = cx * cx + cy * cy + cz * cz - r * r
        disc = b * b - c
        hit = disc > zero
        root = torch.sqrt(torch.maximum(disc, zero).double()).to(dx.dtype)
        t = b - root
        hit = hit & (t > eps) & (t < best_t)
        nx, ny, nz = dx * t - cx, dy * t - cy, dz * t - cz
        inv = one / torch.maximum(r, rmin)
        lam = torch.maximum(zero, (nx * light + ny * light + nz * light)
                            * inv)
        best_t = torch.where(hit, t, best_t)
        shade = torch.where(hit, alb * lam, shade)
    if out is None:
        return shade
    return out.copy_(shade)


def raytrace(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor,
             spheres: torch.Tensor, *,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shade unit rays from the origin against a sphere table.

    Args:
        dx: ray x components, float32, any shape.
        dy: ray y components, same shape.
        dz: ray z components, same shape.
        spheres: (S, 5) float32, rows [cx, cy, cz, r, albedo];
            S <= :data:`MAX_SPHERES` on CUDA.
        out: optional output of the rays' shape, written in place.

    Returns:
        The intensity per ray (``out`` when given); 0 where no sphere is
        hit.

    Raises:
        ValueError: shape, dtype, device or contiguity the kernel does not
            take, or more than :data:`MAX_SPHERES` spheres.
        RuntimeError: the launch was refused.
    """
    _check(dx, dy, dz, spheres, out)
    if dx.device.type == "cpu":
        return raytrace_plain(dx, dy, dz, spheres, out=out)
    if out is None:
        out = torch.empty_like(dx)
    _lib.require_cuda_f32("raytrace", dx, dy, dz, spheres, out)
    num = spheres.shape[0]
    if num > MAX_SPHERES:
        raise ValueError(f"raytrace: {num} spheres, the kernel holds at "
                         f"most {MAX_SPHERES}")
    lib = _lib.library()
    err = lib.raytrace_f32(dx.data_ptr(), dy.data_ptr(), dz.data_ptr(),
                           spheres.data_ptr(), num, out.data_ptr(),
                           dx.numel(), _lib.stream_of(dx))
    _lib.check(err, "raytrace")
    raytrace.launches += 1
    return out


raytrace.launches = 0
