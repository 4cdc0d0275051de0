"""Zamba2's forward pass in plain PyTorch and float32: the reference the
port's published Zamba2 layout (``zamba2-7b-instruct``) is held to.

It reads the parameters by the names of ``transformers``' Zamba2 state
dict (each once, as ``named_parameters`` gives them) and the model's
numbers by the keys of its ``config.json``, and computes the whole
sequence at once: no cache, no batching tricks, no kernel of the port (it
imports torch alone). Each layer's weights are made f32 only while that
layer runs, so the reference fits beside the served weights on a card;
matrix products run with TF32 off.

For each hybrid application j = 0, 1, ... at layer l_j, with e the token
embedding and b = j % num_mem_blocks:

    t = RMSNorm([x ; e]);  q, k, v = t W_q^T, t W_k^T, t W_v^T, RoPE on q, k
    a = softmax(q k^T * (head_dim / 2)^-1/2, causal) v W_o^T
    [g ; u] = n W_gu^T + (n A_j^T) B_j^T,  n = RMSNorm(a)
    x = x + Mamba2(RMSNorm(x + (gelu(g) u W_down^T) W_lin_j^T))

and x = x + Mamba2(RMSNorm(x)) elsewhere; then the final RMSNorm and the
embedding's transpose (the tied LM head). Mamba2: [z, xBC, dt] = h
W_in^T; xBC = silu(causal depthwise conv of width 4, with bias); heads
read B and C of their group (head h: group h // (H / ngroups));
dt = softplus(dt + dt_bias); S_t = exp(-dt_t exp(A_log)) S_{t-1} +
B_t^T (dt_t x_t); y_t = C_t S_t + D x_t; out = (groupwise RMSNorm of
y * silu(z)) W_out^T.

Departures from ``transformers/models/zamba2/modeling_zamba2.py``:

- dt is not clamped below at ``time_step_min``: the model's CUDA path
  (``mamba_chunk_scan_combined`` with ``time_step_limit`` null) does not
  clamp it; its plain-torch path does. Tests draw dt_bias so that no dt
  falls below it.
- the SSD runs chunk by chunk (64 steps) with each chunk's prefix sums of
  log-decays in f64: the recurrence above, exactly, summed in another
  order than the sequential form.
- attention runs a few sequences at a time (``attn_rows``), and logits
  are formed only at the positions asked for.
- ``precision="fp8"`` (a control, not the model): every weight and every
  matrix-product input is rounded to float8_e4m3fn under a per-tensor
  scale (its largest magnitude to 448), then the product runs in f32.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "fp8")
CHUNK = 64
FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """f32 matrix products in f32 (TF32 off), restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x in f32 through float8_e4m3fn under a per-tensor scale."""
    x = x.float()
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Weights:
    """The state dict's tensors as f32 on ``device``, one at a time, in
    the precision asked for."""

    def __init__(self, sd: dict, device, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}; choose "
                             f"from {PRECISIONS}")
        self.sd, self.device, self.fp8 = sd, device, precision == "fp8"

    def __call__(self, name: str) -> torch.Tensor:
        w = self.sd[name].to(self.device, torch.float32)
        return round_fp8(w) if self.fp8 and w.dim() >= 2 else w

    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """x W^T for the (out, in) weight ``name``."""
        if self.fp8:
            x = round_fp8(x)
        return x @ self(name).t()


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float,
         groups: int = 1) -> torch.Tensor:
    g = x.reshape(*x.shape[:-1], groups, x.shape[-1] // groups)
    g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + eps)
    return g.reshape(x.shape) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, H, T, D) rotated at positions 0 .. T-1 (halves rotated)."""
    D, T = x.shape[-1], x.shape[-2]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=x.device) / D)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang).repeat(1, 2), torch.sin(ang).repeat(1, 2)
    half = torch.cat([-x[..., D // 2:], x[..., :D // 2]], dim=-1)
    return x * cos + half * sin


def _attention(q, k, v, scale: float, rows: int) -> torch.Tensor:
    """Causal softmax attention, ``rows`` sequences at a time."""
    T = q.shape[2]
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    outs = []
    for b in range(0, q.shape[0], rows):
        s = torch.matmul(q[b:b + rows], k[b:b + rows].transpose(-1, -2))
        s = (s * scale).masked_fill(~mask, float("-inf"))
        outs.append(torch.matmul(torch.softmax(s, dim=-1), v[b:b + rows]))
    return torch.cat(outs, dim=0)


def _ssd(x, dt, A, Bm, Cm) -> torch.Tensor:
    """The recurrence S_t = exp(dt_t A) S_{t-1} + B_t^T (dt_t x_t),
    y_t = C_t S_t, chunk by chunk. x (B, H, T, P), dt (B, H, T),
    A (H,), Bm and Cm (B, H, T, N); y (B, H, T, P)."""
    Bsz, H, T, P = x.shape
    N = Bm.shape[-1]
    S = x.new_zeros(Bsz, H, N, P)
    ys = []
    for c0 in range(0, T, CHUNK):
        sl = slice(c0, min(c0 + CHUNK, T))
        L = sl.stop - c0
        ld = (dt[:, :, sl] * A[None, :, None]).double()
        cum = torch.cumsum(ld, dim=-1)                       # (B, H, L)
        diff = cum[..., :, None] - cum[..., None, :]
        lower = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(diff.masked_fill(~lower, float("-inf"))).float()
        xdt = x[:, :, sl] * dt[:, :, sl, None]
        scores = torch.matmul(Cm[:, :, sl], Bm[:, :, sl].transpose(-1, -2))
        y = torch.matmul(scores * decay, xdt)
        y = y + torch.exp(cum).float()[..., None] * torch.matmul(
            Cm[:, :, sl], S)
        w = torch.exp(cum[..., -1:] - cum).float()           # (B, H, L)
        S = torch.exp(cum[..., -1]).float()[..., None, None] * S + \
            torch.matmul((Bm[:, :, sl] * w[..., None]).transpose(-1, -2),
                         xdt)
        ys.append(y)
    return torch.cat(ys, dim=2)


def _mamba(W: _Weights, pre: str, h: torch.Tensor,
           cfg: dict) -> torch.Tensor:
    """One Mamba-2 mixer on h (B, T, d)."""
    Bsz, T, d = h.shape
    d_in = cfg["mamba_expand"] * d
    H, P = cfg["n_mamba_heads"], cfg["mamba_headdim"]
    G, N = cfg["mamba_ngroups"], cfg["mamba_d_state"]
    proj = W.linear(h, pre + "in_proj.weight")
    z, xbc, dt = torch.split(proj, [d_in, d_in + 2 * G * N, H], dim=-1)
    w = W(pre + "conv1d.weight")[:, 0, :]                   # (C, width)
    width = w.shape[1]
    padded = torch.cat([xbc.new_zeros(Bsz, width - 1, xbc.shape[-1]), xbc],
                       dim=1)
    conv = W(pre + "conv1d.bias").expand_as(xbc).clone()
    for i in range(width):
        conv = conv + padded[:, i:i + T] * w[:, i]
    xbc = F.silu(conv)
    xs, Bm, Cm = torch.split(xbc, [d_in, G * N, G * N], dim=-1)
    dt = F.softplus(dt + W(pre + "dt_bias"))                 # (B, T, H)
    A = -torch.exp(W(pre + "A_log"))

    def heads(m, width):                                     # (B, H, T, w)
        m = m.reshape(Bsz, T, -1, width).transpose(1, 2)
        return m.repeat_interleave(H // m.shape[1], dim=1)

    x4 = heads(xs, P)
    y = _ssd(x4, dt.transpose(1, 2), A, heads(Bm, N), heads(Cm, N))
    y = y + W(pre + "D")[None, :, None, None] * x4
    y = y.transpose(1, 2).reshape(Bsz, T, d_in)
    y = _rms(y * F.silu(z), W(pre + "norm.weight"), cfg["rms_norm_eps"], G)
    return W.linear(y, pre + "out_proj.weight")


def _shared(W: _Weights, pre: str, j: int, x, e, cfg: dict,
            rows: int) -> torch.Tensor:
    """Application j of the shared block under ``pre``: the s that is
    added to its Mamba layer's input."""
    Bsz, T, _ = x.shape
    eps = cfg["rms_norm_eps"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = cfg["attention_head_dim"]
    t = _rms(torch.cat([x, e], dim=-1), W(pre + "input_layernorm.weight"),
             eps)

    def proj(name, heads):
        return W.linear(t, pre + f"self_attn.{name}_proj.weight").reshape(
            Bsz, T, heads, D).transpose(1, 2)

    q = _rope(proj("q", H), cfg["rope_theta"])
    k = _rope(proj("k", Hkv), cfg["rope_theta"])
    v = proj("v", Hkv)
    if Hkv != H:
        k, v = (m.repeat_interleave(H // Hkv, dim=1) for m in (k, v))
    if W.fp8:
        q, k, v = round_fp8(q), round_fp8(k), round_fp8(v)
    o = _attention(q, k, v, (D / 2) ** -0.5, rows)
    a = W.linear(o.transpose(1, 2).reshape(Bsz, T, H * D),
                 pre + "self_attn.o_proj.weight")
    n = _rms(a, W(pre + "pre_ff_layernorm.weight"), eps)
    ff = pre + "feed_forward."
    ad = ff + f"gate_up_proj_adapter_list.{j}."
    gu = W.linear(n, ff + "gate_up_proj.weight") + W.linear(
        W.linear(n, ad + "0.weight"), ad + "1.weight")
    g, u = torch.chunk(gu, 2, dim=-1)
    return W.linear(F.gelu(g) * u, ff + "down_proj.weight")


def forward(sd: dict, tokens: torch.Tensor, cfg: dict, *,
            keep_from: int = 0, device=None, precision: str = "f32",
            attn_rows: int = 8) -> torch.Tensor:
    """Logits of the whole sequence's forward pass, in f32.

    Args:
        sd: the parameters by state-dict name (any device and dtype).
        tokens: (B, T) token ids.
        cfg: the model's ``config.json`` numbers (``hidden_size``,
            ``num_hidden_layers``, ``hybrid_layer_ids``, ``num_mem_blocks``,
            the attention's and Mamba's sizes, ``rms_norm_eps``,
            ``rope_theta``).
        keep_from: logits only at positions keep_from .. T-1.
        device: where it computes (the tokens' device by default).
        precision: "f32", or "fp8" (the control: see the module).
        attn_rows: sequences a time in attention.

    Returns:
        (B, T - keep_from, vocab) f32.
    """
    device = tokens.device if device is None else torch.device(device)
    W = _Weights(sd, device, precision)
    ids = list(cfg["hybrid_layer_ids"])
    nb = cfg["num_mem_blocks"]
    eps = cfg["rms_norm_eps"]
    with no_tf32(), torch.no_grad():
        table = W("model.embed_tokens.weight")
        e = F.embedding(tokens.to(device), table)
        del table
        x = e
        for i in range(cfg["num_hidden_layers"]):
            h = x
            pre = f"model.layers.{i}."
            if i in ids:
                j = ids.index(i)
                shared = f"model.layers.{ids[j % nb]}.shared_transformer."
                s = _shared(W, shared, j, x, e, cfg, attn_rows)
                h = x + W.linear(s, pre + "linear.weight")
                pre += "mamba_decoder."
            x = x + _mamba(W, pre + "mamba.",
                           _rms(h, W(pre + "input_layernorm.weight"), eps),
                           cfg)
        x = _rms(x[:, keep_from:], W("model.final_layernorm.weight"), eps)
        return W.linear(x, "model.embed_tokens.weight")


def state_dict_shapes(cfg: dict) -> dict:
    """Every parameter's name and shape, as ``transformers``'
    ``Zamba2ForCausalLM`` names them once (``named_parameters``: a shared
    block and its adapters under the first hybrid layer that runs it; the
    tied LM head as the embedding), from the ``config.json`` numbers."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    ids, nb = list(cfg["hybrid_layer_ids"]), cfg["num_mem_blocks"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D, a = cfg["attention_head_dim"], cfg["attention_hidden_size"]
    ff, r = cfg["intermediate_size"], cfg["adapter_rank"]
    d_in = cfg["mamba_expand"] * d
    Hm, GN = cfg["n_mamba_heads"], cfg["mamba_ngroups"] * cfg["mamba_d_state"]
    conv = d_in + 2 * GN
    out = {"model.embed_tokens.weight": (V, d)}
    for i in range(cfg["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        if i in ids:
            j = ids.index(i)
            s = pre + "shared_transformer."
            if j < nb:
                out.update({
                    s + "input_layernorm.weight": (a,),
                    s + "self_attn.q_proj.weight": (H * D, a),
                    s + "self_attn.k_proj.weight": (Hkv * D, a),
                    s + "self_attn.v_proj.weight": (Hkv * D, a),
                    s + "self_attn.o_proj.weight": (d, H * D),
                    s + "pre_ff_layernorm.weight": (d,),
                    s + "feed_forward.gate_up_proj.weight": (2 * ff, d),
                    s + "feed_forward.down_proj.weight": (d, ff)})
            ad = (f"model.layers.{ids[j % nb]}.shared_transformer."
                  f"feed_forward.gate_up_proj_adapter_list.{j}.")
            out.update({ad + "0.weight": (r, d), ad + "1.weight": (2 * ff, r),
                        pre + "linear.weight": (d, d)})
            pre += "mamba_decoder."
        m = pre + "mamba."
        out.update({m + "in_proj.weight": (2 * d_in + 2 * GN + Hm, d),
                    m + "conv1d.weight": (conv, 1, cfg["mamba_d_conv"]),
                    m + "conv1d.bias": (conv,), m + "dt_bias": (Hm,),
                    m + "A_log": (Hm,), m + "D": (Hm,),
                    m + "norm.weight": (d_in,),
                    m + "out_proj.weight": (d, d_in),
                    pre + "input_layernorm.weight": (d,)})
    out["model.final_layernorm.weight"] = (d,)
    return out
