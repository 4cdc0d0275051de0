"""Prefill attention with an online softmax (the LM stack's flash kernel).

:func:`flash_attention` launches the CUDA kernel in
``csrc/flash_attention.cu`` for CUDA tensors and runs
:func:`flash_attention_plain` for CPU tensors. It replaces the Pallas
kernel ``repro/kernels/flash_attention.py`` ``flash_attention`` (body
``_flash_kernel``); the plain version is the port of the reference's
``ref.attention`` oracle.

q is (B, Hq, T, D), k and v (B, Hkv, T, D) with Hq a multiple of Hkv
(grouped-query heads: q head h reads kv head h // (Hq // Hkv)). The
scores are scaled by the caller's ``scale``, D^-1/2 unless given (Zamba2's
shared attention scales its D 224 heads by (D / 2)^-1/2); scores, softmax
and PV run in f32 and the output takes q's dtype (f32 or bf16). On CUDA
the bf16 path takes head dims up to 224 (:data:`MAX_HEAD_DIM_BF16`), the
f32 path up to 128 (:data:`MAX_HEAD_DIM`). Query i attends key j when j <= i under ``causal``
and i - j < ``window`` when a window is given.

f32 inputs run on the CUDA cores: q is scaled in f32 before QK^T, and
the kernel agrees with the plain version within rtol = atol = 2e-5 at
small T (5e-5 at T = 8192), another summation order. bf16 inputs run on
the tensor cores: QK^T's products are exact in f32, the scale applies to
the f32 scores, and P is rounded to bf16 before PV (the one rounding the
plain f32 function lacks, 2^-9 relative per weight); with the output
rounded to bf16 the two agree within rtol = atol = 2e-2.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _lib

MAX_HEAD_DIM = 128        # the f32 kernel's output columns on chip
MAX_HEAD_DIM_BF16 = 224   # the tensor-core kernel's (Zamba2's D 224)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q, k, v must be (B, H, T, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, T, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (T, D):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, Hkv, T, D) for q "
                         f"{tuple(q.shape)}")
    if k.shape[1] < 1 or Hq % k.shape[1]:
        raise ValueError(f"flash_attention: {Hq} q heads are not a "
                         f"multiple of {k.shape[1]} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, "
                         f"got {window}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Attention in plain PyTorch (any device), the reference oracle's way:
    full (Tq, Tk) f32 logits, masked to -inf, softmax, then PV.

    q: (B, Hq, Tq, D); k, v: (B, Hkv, Tk, D); a shorter query block is
    aligned to the end of the keys (decode). q is scaled by ``scale``
    (D^-1/2 unless given) in f32. Output in q's dtype.
    """
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    qf = (q.float() * scale).reshape(B, Hkv, G, Tq, D)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float())
    q_idx = torch.arange(Tq, device=q.device)[:, None] + (Tk - Tq)
    k_idx = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_idx >= k_idx
    if window is not None:
        mask &= q_idx - k_idx < window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(B, Hq, Tq, D).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Prefill attention (Tq == Tk) with causal mask, window and GQA.

    Args:
        q: (B, Hq, T, D) float32 or bfloat16.
        k, v: (B, Hkv, T, D) of q's dtype.
        causal: mask keys after the query.
        window: keep only the last ``window`` keys of each query.
        scale: the scores' scale; D^-1/2 unless given.

    Returns:
        (B, Hq, T, D) in q's dtype.

    Raises:
        ValueError: shape, dtype, device or contiguity the kernel does not
            take (on CUDA also D > 224 in bf16, D > 128 in f32); an input
            that requires grad while grad mode is on, on every device (no
            backward).
        RuntimeError: the launch was refused.
    """
    _check(q, k, v, window)
    _lib.refuse_dtensor("flash_attention", q, k, v)
    _lib.refuse_grad("flash_attention",
                     'flash_attention_plain, attn_impl="xla"', q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: expects float32 or bfloat16, "
                         f"got {q.dtype}")
    B, Hq, T, D = q.shape
    widest = MAX_HEAD_DIM_BF16 if q.dtype == torch.bfloat16 else MAX_HEAD_DIM
    if D > widest:
        raise ValueError(f"flash_attention: head dim {D} > {widest}, the "
                         f"widest the {q.dtype} kernel takes (bf16 up to "
                         f"{MAX_HEAD_DIM_BF16}, f32 up to {MAX_HEAD_DIM})")
    out = torch.empty_like(q)
    _lib.require_cuda("flash_attention", *((t, q.dtype)
                                           for t in (q, k, v, out)))
    lib = _lib.library()
    fn = (lib.flash_attention_f32 if q.dtype == torch.float32
          else lib.flash_attention_bf16)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
             k.shape[1], T, D, int(causal), window or 0,
             ctypes.c_float(D ** -0.5 if scale is None else scale),
             _lib.stream_of(q))
    _lib.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
