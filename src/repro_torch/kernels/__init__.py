"""Hand-written CUDA kernels, with plain versions: the paper's six
benchmarks and the LM stack's two (flash and linear attention)."""
from .flash_attention import flash_attention, flash_attention_plain
from .gaussian import (gaussian_blur, gaussian_blur_halo,
                       gaussian_blur_halo_plain)
from .linear_attention import (chunked_linear_attention, linear_attention,
                               linear_attention_plain)
from .mandelbrot import mandelbrot, mandelbrot_plain
from .matmul import matmul, matmul_plain
from .rap import rap, rap_plain
from .raytrace import demo_spheres, raytrace, raytrace_plain
from .taylor import taylor_sin, taylor_sin_plain
from .ops import resolve_impl

__all__ = [
    "chunked_linear_attention", "demo_spheres", "flash_attention",
    "flash_attention_plain",
    "gaussian_blur", "gaussian_blur_halo",
    "gaussian_blur_halo_plain", "linear_attention",
    "linear_attention_plain", "mandelbrot", "mandelbrot_plain", "matmul",
    "matmul_plain", "rap", "rap_plain", "raytrace", "raytrace_plain",
    "resolve_impl", "taylor_sin", "taylor_sin_plain",
]
