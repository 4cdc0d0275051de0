"""Zamba2-7B-Instruct's inputs: its weights, which every client shares,
drawn on the device from the seed under the names and layouts of
``transformers``' Zamba2 state dict in the configuration's ``dtype``, and
one batch of requests a client: prompts and the tokens its decode steps
are forced to, ids uniform over the vocabulary. Everything stays on the
device. Each set also carries the model's numbers (``model``), the
configuration's ``config.json`` keys that the reference and the work
count read.

Weight scales (the configuration's ``assumed``): each (out, in) matrix
normal times in^-1/2, the dt rows of ``in_proj`` at a tenth of that (so
dt stays near its initial range: at full scale a random dt row makes the
Mamba decays, and so the logits, move far under a rounding); conv1d
weight normal times 0.5 and bias normal times 0.1; norm weights and D
1 + 0.1 normal; A_log and dt_bias as the model initialises them.
"""
from __future__ import annotations

import math

import torch

from bench.harness.host import client_seed

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MODEL_KEYS = ("hidden_size", "num_hidden_layers", "vocab_size",
              "hybrid_layer_ids", "num_mem_blocks", "num_attention_heads",
              "num_key_value_heads", "attention_head_dim",
              "attention_hidden_size", "intermediate_size", "adapter_rank",
              "mamba_expand", "n_mamba_heads", "mamba_headdim",
              "mamba_ngroups", "mamba_d_state", "mamba_d_conv",
              "rms_norm_eps", "rope_theta")


def total(config: dict) -> int:
    """The launch's index space: the batch's requests."""
    return int(config["batch"])


def state_dict_shapes(cfg: dict) -> dict:
    """Every parameter's name and shape, as ``transformers``'
    ``Zamba2ForCausalLM`` names each once (``named_parameters``: a shared
    block and its adapters under the first hybrid layer that runs it, the
    tied LM head as the embedding)."""
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


def _weights(config: dict, g: torch.Generator, device: str) -> dict:
    dtype = DTYPES[config["dtype"]]
    heads = config["n_mamba_heads"]
    lo, hi = (math.log(config[k]) for k in ("time_step_min",
                                             "time_step_max"))
    out = {}
    for name, shape in state_dict_shapes(config).items():
        x = torch.randn(shape, generator=g, device=device)
        if name.endswith("A_log"):
            x = torch.log(torch.arange(1, heads + 1, dtype=torch.float32,
                                       device=device))
        elif name.endswith("dt_bias"):
            dt = torch.exp(lo + (hi - lo) * torch.rand(
                shape, generator=g, device=device))
            x = dt + torch.log(-torch.expm1(-dt))
        elif name.endswith(("conv1d.bias", ".D")):
            x = 0.1 * x + (1.0 if name.endswith(".D") else 0.0)
        elif len(shape) == 1:
            x = 1.0 + 0.1 * x
        elif name.endswith("conv1d.weight"):
            x = 0.5 * x
        else:
            x = x * shape[-1] ** -0.5
            if name.endswith("in_proj.weight"):
                x[-heads:] *= 0.1
        out[name] = x.to(dtype)
    return out


def make(config: dict, clients: int, seed: int, device: str) -> list:
    """``[{"weights", "prompts", "forced", "model"}, ...]``, one a client;
    the weights (name -> tensor) and the model's numbers the same objects
    in every client's set."""
    B, P, G = (int(config[k]) for k in ("batch", "prompt_len",
                                         "decode_steps"))
    V = int(config["vocab_size"])
    g = torch.Generator(device=device)
    g.manual_seed(client_seed(seed, 0, stream=2))
    weights = _weights(config, g, device)
    model = {k: config[k] for k in MODEL_KEYS}
    sets = []
    for c in range(clients):
        g.manual_seed(client_seed(seed, c))
        sets.append({
            "weights": weights, "model": model,
            "prompts": torch.randint(0, V, (B, P), generator=g,
                                     device=device),
            "forced": torch.randint(0, V, (B, G), generator=g,
                                    device=device)})
    return sets
