"""Hand-written CUDA kernels, with plain versions: the paper's six
benchmarks and the LM stack's three (flash and linear attention, and
decode attention over a K/V ring).

Layout per kernel: ``<name>.py`` holds the hand-kernel wrapper (it
launches ``csrc/<name>.cu`` on CUDA tensors) and its plain PyTorch
version, ``ref.py`` the plain versions under the reference oracles'
names, ``ops.py`` the ``<name>_op`` wrappers with impl dispatch along
:data:`KERNEL_IMPLS` plus the typed co-executable kernels registered in
the :mod:`repro_torch.api.registry` kernel registry (resolve them with
``repro_torch.api.build_kernel(name, impl=...)``).
"""
from . import ref
from .decode_attention import decode_attention, decode_attention_plain
from .flash_attention import flash_attention, flash_attention_plain
from .gaussian import (gaussian_blur, gaussian_blur_halo,
                       gaussian_blur_halo_plain)
from .linear_attention import (chunked_linear_attention, linear_attention,
                               linear_attention_plain)
from .mandelbrot import mandelbrot, mandelbrot_plain
from .matmul import matmul, matmul_plain
from .ops import (KERNEL_IMPLS, default_impl, flash_attention_op,
                  gaussian_op, linear_attention_op, mandelbrot_op,
                  matmul_op, rap_op, raytrace_op, resolve_impl, taylor_op)
from .rap import rap, rap_plain
from .raytrace import demo_spheres, raytrace, raytrace_plain
from .taylor import taylor_sin, taylor_sin_plain

__all__ = [
    "KERNEL_IMPLS", "chunked_linear_attention", "decode_attention",
    "decode_attention_plain", "default_impl", "demo_spheres", "flash_attention", "flash_attention_op",
    "flash_attention_plain", "gaussian_blur", "gaussian_blur_halo",
    "gaussian_blur_halo_plain", "gaussian_op", "linear_attention",
    "linear_attention_op", "linear_attention_plain", "mandelbrot",
    "mandelbrot_op", "mandelbrot_plain", "matmul", "matmul_op",
    "matmul_plain", "rap", "rap_op", "rap_plain", "raytrace",
    "raytrace_op", "raytrace_plain", "ref", "resolve_impl", "taylor_op",
    "taylor_sin", "taylor_sin_plain",
]
