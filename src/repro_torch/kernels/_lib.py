"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Every source compiles with its own ``nvcc`` process, all started together,
into an object file; the objects link into one shared library with a plain
C interface that :mod:`ctypes` loads. The build happens at first use, into
``build/kernels/`` at the root of the checkout, under a name derived from
the sources, the headers they include (``csrc/*.cuh``) and the flags, so
an edited file is never served stale. Nothing here runs at import time: a
machine without ``nvcc`` can import the port and run its plain versions.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is not 0, because a refused launch never
runs and a later synchronize would not report it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry point; pointers and streams as c_void_p so
# ctypes never truncates them to 32 bits
SIGNATURES = {
    "taylor_sin_f32": (_P, _P, _LL, _I, _P),
    "gaussian_rows_f32": (_P, _LL, _I, _LL, _P, _LL, _P),
    # a, b, c, M, N, K, tile rows, tile columns
    "matmul_f32": (_P, _P, _P, *(_I,) * 5, _P),
    "mandelbrot_f32": (_P, _P, _P, _LL, _I, _P),
    "raytrace_f32": (_P, _P, _P, _P, _I, _P, _LL, _P),
    "rap_f32": (_P, _P, _P, _LL, _I, _P),
    # q, k, v, out, B, Hq, Hkv, T, D, causal, window (0: none), scale
    "flash_attention_f32": (_P, _P, _P, _P, *(_I,) * 7, _F, _P),
    "flash_attention_bf16": (_P, _P, _P, _P, *(_I,) * 7, _F, _P),
    # q, k, v, log_decay, out, final state (null: none), BH, T, Dk, Dv
    # (bf16: then the Dv tile)
    "linear_attention_f32": (*(_P,) * 6, _I, _I, _I, _I, _P),
    "linear_attention_bf16": (*(_P,) * 6, *(_I,) * 5, _P),
    # q, k, v, log_decay, scores scratch, out, BH, T, Dk, Dv, bf16
    "linear_attention_wide": (_P, _P, _P, _P, _P, _P, *(_I,) * 5, _P),
    # q, k, v, out, split outputs, split (max, sum), position on the device
    # (null: the next argument), position, B, Hkv, G, S, D, window (0:
    # none), scale, splits, q and out bf16
    "decode_attention_f32": (*(_P,) * 7, _LL, *(_I,) * 6, _F, _I, _I, _P),
    "decode_attention_bf16": (*(_P,) * 7, _LL, *(_I,) * 6, _F, _I, _I, _P),
    "host_register_mapped": (_P, _LL),
    "host_device_pointer": (_P, ctypes.POINTER(_P)),
    "host_unregister": (_P,),
}

_lock = threading.Lock()
_loaded: dict[str, object] = {}     # guarded-by: _lock
_graph_lock = threading.Lock()
_graphs: dict = {}                  # guarded-by: _graph_lock


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH.

    Raises:
        RuntimeError: no CUDA compiler is installed.
    """
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*_sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile every ``csrc/*.cu`` in parallel and link the library.

    Returns:
        Path of the shared library (reused when already built from the
        same sources and flags).

    Raises:
        RuntimeError: a compile or the link failed (its output attached).
    """
    out_dir = BUILD_DIR / _digest()
    lib = out_dir / "libreprotorch.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for src, _, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name} ==\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = out_dir / f"libreprotorch.{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib


def library():
    """The loaded kernel library, built on first use (thread-safe).

    Returns:
        The :class:`ctypes.CDLL` with every entry point's argtypes set.
    """
    with _lock:
        lib = _loaded.get("lib")
        if lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _loaded["lib"] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error.

    Args:
        err: the returned ``cudaError_t`` value.
        what: the kernel or call, for the message.

    Raises:
        RuntimeError: ``err`` is not 0.
    """
    if err:
        msg = library().cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *specs: tuple[torch.Tensor, torch.dtype]
                 ) -> None:
    """Validate tensors for a kernel launch: one CUDA device, contiguous,
    each of the dtype it is paired with (never cast: a cast would hide a
    wrong input).

    Args:
        name: the kernel, for the message.
        specs: ``(tensor, expected dtype)`` pairs.

    Raises:
        ValueError: a tensor on another device or of another dtype, or
            tensors on different devices.
        ValueError: a non-contiguous tensor (the kernels index densely).
    """
    dev = specs[0][0].device
    for t, dtype in specs:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expects {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")


def require_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """:func:`require_cuda` with every tensor float32."""
    require_cuda(name, *((t, torch.float32) for t in tensors))


def refuse_dtensor(name: str, *tensors) -> None:
    """Refuse a DTensor: a hand kernel reads one device's memory through a
    raw pointer, so on a DTensor it would compute on one rank's shard as
    if it were the whole tensor. A partitioned program runs the chunked
    forms (``attn_impl`` and ``mixer_impl`` "chunked"), as the reference's
    dry run lowers them. Checked on every device.

    Raises:
        ValueError: an input is a DTensor.
    """
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise ValueError(f"{name}: the hand kernel takes whole tensors on "
                         f"one device, not a DTensor; a partitioned program "
                         f"runs the chunked forms")


def refuse_grad(name: str, plain: str, *tensors: torch.Tensor) -> None:
    """Refuse inputs that require grad: a hand kernel writes its output
    through a raw pointer, so autograd would see no graph and a training
    step would take a wrong gradient without an error. The reference
    cannot differentiate its Pallas kernels either. Checked on every
    device, so the CPU (where the wrapper runs the plain version) refuses
    what the card refuses.

    Raises:
        ValueError: grad mode is on and an input requires grad.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{name}: the hand kernel has no backward; take "
                         f"gradients through its plain version ({plain})")


def run_plain(body, *args):
    """Run a plain version's body: one TorchScript call on CPU tensors,
    op by op on any other device.

    Written in Python, a plain version dispatches one torch op a step.
    Each op gives up the interpreter lock while it computes and must take
    it back before the next. Beside another thread that runs Python, as
    the CUDA unit's worker does in a co-execution pair, each of those
    takes waits, so the CPU unit's package ran many times slower than
    alone. The scripted body runs all its ops in one call with the lock
    released. It runs on TorchScript's simple executor (no profiling run,
    no optimisation pass, no fusion: the switch is per thread), so its
    ops and their order are the eager body's, and so are its results,
    bit for bit. The body is scripted once, at its first CPU call.

    Args:
        body: a TorchScript-compatible function of ``args``.
        args: its arguments; the first is a tensor.

    Returns:
        What ``body`` returns.
    """
    if type(args[0]) is not torch.Tensor or args[0].device.type != "cpu":
        return body(*args)
    with _graph_lock:
        graph = _graphs.get(body)
        if graph is None:
            # TorchScript is deprecated in favour of torch.compile, which
            # would need a C++ toolchain at run time and compile once per
            # package shape
            graph = _graphs[body] = torch.jit.script(body)
    with torch.jit.optimized_execution(False):
        return graph(*args)
