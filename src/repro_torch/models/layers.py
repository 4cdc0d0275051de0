"""Base layers: norms, dense layers, the MLPs, embeddings, positions.

Plain functions on tensors; parameters are dicts of tensors with the
reference's names, shapes and init scales (``init_*``), so a parameter
tree from the reference converts one to one
(:mod:`repro_torch.models.convert`). Mixed precision follows the
reference, because it is part of the function: :func:`embed` gathers from
a bf16 copy of the table, so the residual stream is bf16; :func:`dense`
casts its kernel to the activations' dtype; :func:`rmsnorm` computes in
f32 and returns the input's dtype (so does :func:`layernorm`);
:func:`unembed` is f32. :func:`cross_entropy` is the training loss.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .sharding import (arange_like, logsumexp, matmul, pad_rows, pinned,
                       settled, shard)

Params = dict


def _normal(generator: torch.Generator, shape, scale: float,
            device: torch.device) -> torch.Tensor:
    """``scale`` times standard normals drawn on the generator's device,
    then moved to ``device`` (on the meta device: the shape alone)."""
    if torch.device(device).type == "meta":
        return torch.empty(*shape, device="meta")
    x = torch.randn(*shape, generator=generator, device=generator.device)
    return (x * scale).to(device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, device: torch.device) -> Params:
    return {"scale": torch.ones(d, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


def init_layernorm(d: int, device: torch.device) -> Params:
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with the sigmoid as 1 / (1 + exp(-x)), each step in
    x's dtype, as the reference computes it: in bf16 this rounds after
    every operation, where ``F.silu`` rounds once (the two differ in
    about a third of bf16 values)."""
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of GELU, each step in x's dtype, as the reference's
    ``jax.nn.gelu`` (``approximate=True``) writes it."""
    c = (2 / torch.pi) ** 0.5
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)) in x's dtype (see :func:`silu`)."""
    return 1 / (1 + torch.exp(-x))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as logaddexp(x, 0), the reference's form."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Dense / MLP
# ---------------------------------------------------------------------------

def init_dense(generator: torch.Generator, d_in: int, d_out: int, *,
               device: torch.device, bias: bool = False,
               scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> Params:
    """A (d_in, d_out) kernel of normals times ``scale`` (d_in^-1/2 by
    default). ``dtype`` stores the kernel rounded to that type: a bf16
    copy gives what :func:`dense` computes on bf16 activations anyway."""
    scale = scale if scale is not None else d_in ** -0.5
    p = {"kernel": _normal(generator, (d_in, d_out), scale, device)
         .to(dtype)}
    if bias:
        p["bias"] = torch.zeros(d_out, device=device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = pinned(matmul(x, p["kernel"].to(x.dtype)))
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def init_mlp(generator: torch.Generator, d: int, d_ff: int, *,
             device: torch.device,
             dtype: torch.dtype = torch.float32) -> Params:
    """Gated SiLU MLP (llama-style)."""
    return {"wi_gate": init_dense(generator, d, d_ff, device=device,
                                  dtype=dtype),
            "wi_up": init_dense(generator, d, d_ff, device=device,
                                dtype=dtype),
            "wo": init_dense(generator, d_ff, d, device=device,
                             scale=d_ff ** -0.5, dtype=dtype)}


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = silu(dense(p["wi_gate"], x)) * dense(p["wi_up"], x)
    # the hidden over model, as the reference pins it
    h = shard(h, ("pod", "data"), None, "model")
    return dense(p["wo"], h)


def init_gelu_mlp(generator: torch.Generator, d: int, d_ff: int, *,
                  device: torch.device,
                  dtype: torch.dtype = torch.float32) -> Params:
    """Plain GELU MLP (whisper-style), with biases."""
    return {"wi": init_dense(generator, d, d_ff, device=device, bias=True,
                             dtype=dtype),
            "wo": init_dense(generator, d_ff, d, device=device, bias=True,
                             scale=d_ff ** -0.5, dtype=dtype)}


def gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return dense(p["wo"], gelu(dense(p["wi"], x)))


# ---------------------------------------------------------------------------
# Embeddings & positions
# ---------------------------------------------------------------------------

def init_embedding(generator: torch.Generator, vocab: int, d: int, *,
                   device: torch.device) -> Params:
    # d^-0.5 keeps tied-unembedding logits O(1) at init
    return {"table": _normal(generator, (vocab, d), d ** -0.5, device)}


def embed(p: Params, tokens: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Rows of the table for ``tokens``, gathered from its ``dtype`` copy
    (rounding each gathered row equals rounding the whole table first).
    ``F.embedding``: on a vocab-sharded DTensor table each rank looks up
    its own rows and the partial rows are summed, where an index would
    gather the whole table."""
    return settled(F.embedding(tokens, p["table"]).to(dtype))


def unembed(p: Params, x: torch.Tensor,
            pad_to: Optional[int] = None) -> torch.Tensor:
    """f32 logits from the embedding table, its vocab dim zero-padded to
    ``pad_to`` (the padded columns come out as 0)."""
    table = p["table"].float()
    if pad_to is not None and pad_to > table.shape[0]:
        # a vocab-sharded table keeps its layout, each rank receiving
        # only the rows its padded shard lacks (``pad_rows``); a
        # replicated one, padded, goes over model, as the rules shard the
        # table. Either way the logits come out vocab-sharded.
        table = shard(pad_rows(table, pad_to), "model", None)
    return pinned(matmul(x.float(), table.t()))


def sinusoidal_positions(seq: int, d: int, dtype: torch.dtype = torch.float32,
                         *, device: torch.device | str = "cpu",
                         offset: int = 0) -> torch.Tensor:
    """Rows ``offset .. offset + seq - 1`` of the reference's sinusoidal
    table: [sin | cos] of pos / 10000^(2i/d), (seq, d) in ``dtype`` (each
    row is computed as the whole table computes it)."""
    pos = torch.arange(offset, offset + seq, dtype=torch.float32,
                       device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2.0 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(dtype)


def rope_frequencies(head_dim: int, theta: float = 10000.0) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    return 1.0 / (theta ** exponent)                      # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               freqs: torch.Tensor) -> torch.Tensor:
    """x: (..., T, D); positions: broadcastable to (..., T)."""
    angles = positions[..., None].float() * freqs        # (..., T, D/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  valid_vocab: Optional[int] = None) -> torch.Tensor:
    """Mean token NLL in f32. logits: (..., Vp) f32; labels integer.

    As the reference computes it: columns >= ``valid_vocab`` (padding) are
    -inf, and the gold logit is a select-and-sum over the vocab dim (not a
    gather); ``mask`` weights the tokens, and the mean is over its sum.
    """
    col = arange_like(logits)
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        logits = logits.masked_fill(col >= valid_vocab, float("-inf"))
    logz = logsumexp(logits, dim=-1)
    gold = torch.where(col == labels[..., None], logits,
                       torch.zeros((), dtype=logits.dtype,
                                   device=logits.device)).sum(dim=-1)
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
