"""Decode attention over a K/V ring (the LM stack's decode kernel).

:func:`decode_attention` launches the CUDA kernel in
``csrc/decode_attention.cu`` for CUDA tensors and runs
:func:`decode_attention_plain` on any other device (the CPU, and the meta
device the dry run traces on). It replaces no Pallas kernel: the
reference's decode is einsums over its cache
(``repro/models/attention.py:173-178``), which the plain version keeps.

One new token: q is (B, Hkv, G, D), the G query heads of each kv head
(q head h * G + g reads kv head h); k and v are the rings (B, Hkv, S, D)
that :func:`repro_torch.models.attention.attention_decode` keeps, with
the new token's key and value already in slot ``pos % S``. A slot counts
when its age ``(pos % S - slot) mod S`` is at most ``min(pos, S - 1)``
and, with a window, below it. Scores q . k in f32 with q scaled by the
caller's ``scale`` in f32 first, the softmax in f32, then P V in f32 with
P kept in f32; the output takes q's dtype.

The kernel reads each valid K and V row once in the ring's own dtype
(f32 or bf16) and converts it in registers: the plain version's f32 copy
of the whole ring is never made. It agrees with the plain version within
rtol = atol = 1e-5 in f32 (another order of summation) and within one
bf16 ulp of the output in bf16.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _lib

MAX_HEAD_DIM = 256        # the kernel's widest head dim (a multiple of 8)
MAX_GROUP = 16            # query heads a kv head, at most
# one slice of a ring when B * Hkv gives every SM this many blocks; else
# slices of at least MIN_SLICE slots, up to MAX_SLICES
BLOCKS_PER_SM = 2
MIN_SLICE = 256
MAX_SLICES = 64


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, pos, *,
                           scale: Optional[float] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """Decode attention in plain PyTorch (any device, DTensors too): the
    whole ring's f32 logits against the scaled f32 query, masked to -inf
    outside the valid slots, softmax, then P V over the ring in f32.

    Args:
        q: (B, Hkv, G, D), the new token's queries.
        k, v: (B, Hkv, S, D) rings, the new token's already in slot
            ``pos % S``.
        pos: the new token's absolute position, a Python int or a 0-dim
            integer tensor on the rings' device.
        scale: the scores' scale; D^-1/2 unless given.
        window: count only slots less than ``window`` steps old.

    Returns:
        (B, Hkv, G, D) in q's dtype.
    """
    S = k.shape[2]
    slot = pos % S
    # valid slots: ages 0..min(pos, S - 1) relative to the new token
    idx = torch.arange(S, device=q.device)
    age = torch.remainder(slot - idx, S)
    valid = age <= (pos.clamp(max=S - 1) if isinstance(pos, torch.Tensor)
                    else min(pos, S - 1))
    if window is not None:
        valid &= age < window
    qf = q.float() * (q.shape[-1] ** -0.5 if scale is None else scale)
    logits = torch.einsum("bhgd,bhsd->bhgs", qf, k.float())
    logits = logits.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgs,bhsd->bhgd", probs, v.float()).to(q.dtype)


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: Optional[int] = None) -> None:
    """Refuse shapes and dtypes the kernel does not take (any device).

    Raises:
        ValueError: q not (B, Hkv, G, D) or k, v not (B, Hkv, S, D) of the
            same B, Hkv and D; G outside 1..16; D not a multiple of 8 in
            8..256; q not f32 or bf16; k and v not both f32 or both bf16;
            a window below 1.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"decode_attention: q must be (B, Hkv, G, D) and "
                         f"k, v (B, Hkv, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hkv, G, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, Hkv) or k.shape[3] != D \
            or k.shape[2] < 1:
        raise ValueError(f"decode_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, Hkv, S, D) rings "
                         f"for q {tuple(q.shape)}")
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"decode_attention: {G} query heads a kv head; "
                         f"the kernel takes 1 to {MAX_GROUP}")
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head dim {D}; the kernel "
                         f"takes multiples of 8 up to {MAX_HEAD_DIM}")
    kinds = (torch.float32, torch.bfloat16)
    if q.dtype not in kinds:
        raise ValueError(f"decode_attention: q must be float32 or "
                         f"bfloat16, got {q.dtype}")
    if k.dtype not in kinds or v.dtype != k.dtype:
        raise ValueError(f"decode_attention: the rings must be both "
                         f"float32 or both bfloat16, got {k.dtype} and "
                         f"{v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window must be >= 1, "
                         f"got {window}")


def split_count(rows: int, slots: int, sms: int) -> int:
    """Slices of each ring the kernel reads in parallel: 1 where the
    ``rows`` = B * Hkv blocks give every one of ``sms`` SMs
    BLOCKS_PER_SM, else enough for that, each of at least MIN_SLICE of
    the ring's ``slots`` (at most MAX_SLICES). A second pass merges the
    slices in order."""
    if rows >= BLOCKS_PER_SM * sms:
        return 1
    want = -(-BLOCKS_PER_SM * sms // rows)
    return max(1, min(want, slots // MIN_SLICE, MAX_SLICES))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos, *, scale: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """Attention of one new token over the K/V rings (see the module).

    Args:
        q: (B, Hkv, G, D) float32 or bfloat16, G up to 16, D a multiple of
            8 up to 256.
        k, v: (B, Hkv, S, D) rings, both float32 or both bfloat16.
        pos: the new token's absolute position: a Python int, or a 0-dim
            int64 tensor on the rings' device, which the kernel reads when
            it runs (a replayed CUDA graph sees each step's).
        scale: the scores' scale; D^-1/2 unless given.
        window: count only slots less than ``window`` steps old.

    Returns:
        (B, Hkv, G, D) in q's dtype.

    Raises:
        ValueError: on CUDA, what :func:`check_kernel_inputs` refuses, a
            DTensor, an input that requires grad while grad mode is on
            (no backward), tensors on different devices or not
            contiguous, rings not 16-byte aligned, or a ``pos`` that is
            negative or not an int64 scalar on the rings' device.
        RuntimeError: the launch was refused.
    """
    if q.device.type != "cuda":
        return decode_attention_plain(q, k, v, pos, scale=scale,
                                      window=window)
    check_kernel_inputs(q, k, v, window)
    _lib.refuse_dtensor("decode_attention", q, k, v)
    _lib.refuse_grad("decode_attention", "decode_attention_plain", q, k, v)
    out = torch.empty_like(q)
    _lib.require_cuda("decode_attention", (q, q.dtype), (k, k.dtype),
                      (v, k.dtype), (out, q.dtype))
    if (k.data_ptr() | v.data_ptr()) & 15:
        raise ValueError("decode_attention: the rings must start on a "
                         "16-byte boundary")
    if isinstance(pos, torch.Tensor):
        if pos.dim() != 0 or pos.dtype != torch.int64 \
                or pos.device != k.device:
            raise ValueError(f"decode_attention: pos must be a Python int "
                             f"or a 0-dim int64 tensor on {k.device}, got "
                             f"{pos.dtype} {tuple(pos.shape)} on "
                             f"{pos.device}")
        pos_ptr, pos_val = pos.data_ptr(), 0
    else:
        if pos < 0:
            raise ValueError(f"decode_attention: pos must be >= 0, "
                             f"got {pos}")
        pos_ptr, pos_val = None, int(pos)
    B, Hkv, G, D = q.shape
    S = k.shape[2]
    splits = split_count(B * Hkv, S, _sm_count(q.device))
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty(B * Hkv * splits * G * D, device=q.device,
                               dtype=torch.float32)
        part_ml = torch.empty(B * Hkv * splits * G * 2, device=q.device,
                              dtype=torch.float32)
    lib = _lib.library()
    fn = (lib.decode_attention_bf16 if k.dtype == torch.bfloat16
          else lib.decode_attention_f32)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if part_acc is None else part_acc.data_ptr(),
             None if part_ml is None else part_ml.data_ptr(), pos_ptr,
             pos_val, B, Hkv, G, S, D, window or 0,
             ctypes.c_float(D ** -0.5 if scale is None else scale), splits,
             int(q.dtype == torch.bfloat16), _lib.stream_of(q))
    _lib.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
