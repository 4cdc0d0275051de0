"""Hand-written CUDA kernels of the paper's benchmarks, with plain versions."""
from .gaussian import (gaussian_blur, gaussian_blur_halo,
                       gaussian_blur_halo_plain)
from .mandelbrot import mandelbrot, mandelbrot_plain
from .matmul import matmul, matmul_plain
from .taylor import taylor_sin, taylor_sin_plain
from .ops import resolve_impl

__all__ = [
    "gaussian_blur", "gaussian_blur_halo",
    "gaussian_blur_halo_plain", "mandelbrot", "mandelbrot_plain", "matmul",
    "matmul_plain", "resolve_impl", "taylor_sin", "taylor_sin_plain",
]
