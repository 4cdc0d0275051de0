"""Parameters from and to the reference package's tree of numpy arrays.

The reference stacks its layers (zamba2's ``superblocks`` leaves are
(n_super, attn_every, ...), a decoder's ``layers`` (L, ...), xLSTM's
``superblocks`` {"mlstm": (n_super, 7, ...), "slstm": (n_super, ...)},
whisper's ``encoder_layers`` and ``layers`` (L, ...)) and the port keeps
lists of per-layer dicts, so :func:`params_from_numpy` unstacks them and
:func:`params_to_numpy` stacks them back (a checkpoint holds the
reference's layout); every other leaf is copied as it is. With the same values both packages
compute the same function, which is how the tests hold the port against
the reference. Nothing here imports the reference: the caller turns its
arrays into numpy first (``jax.tree.map(np.asarray, params)``).
:func:`reference_layout` gives the same stacked layout as shapes only
(meta tensors), for parameters and caches alike: what the sharding rules
and the dry run's byte counts read. :func:`params_from_zamba2_state_dict`
reads the published Zamba2 layout's parameters by the names of its
``transformers`` state dict.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..configs.base import ModelConfig, Zamba2Config


def _tensors(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def _layer(tree: Any, index: tuple) -> Any:
    """The subtree of one stacked layer: every leaf indexed at ``index``."""
    if isinstance(tree, dict):
        return {k: _layer(v, index) for k, v in tree.items()}
    return np.asarray(tree)[index]


def _stack(tree: Any, n: int, device: torch.device,
           prefix: tuple = ()) -> list:
    """The layers of a stacked subtree, one dict each."""
    return [_tensors(_layer(tree, prefix + (i,)), device) for i in range(n)]


def params_from_numpy(cfg: ModelConfig, tree: dict, *,
                      device: torch.device | str = "cuda:0") -> dict:
    """The port's parameters from the reference's numpy tree.

    Args:
        cfg: the config both trees were built for.
        tree: the reference's parameters with numpy leaves.
        device: where the tensors go.

    Returns:
        The tree :meth:`Model.init` would return, with these values.
    """
    device = torch.device(device)
    stacked = {"layers", "encoder_layers", "superblocks", "tail_blocks"}
    out = {k: _tensors(v, device) for k, v in tree.items()
           if k not in stacked}
    if cfg.family in ("dense", "moe", "vlm"):
        out["layers"] = _stack(tree["layers"], cfg.num_layers, device)
    elif cfg.family == "encdec":
        out["encoder_layers"] = _stack(tree["encoder_layers"],
                                       cfg.encoder_layers, device)
        out["layers"] = _stack(tree["layers"], cfg.num_layers, device)
    elif cfg.family == "ssm":
        n_super = cfg.num_layers // cfg.slstm_every
        sb = tree["superblocks"]
        out["superblocks"] = [
            {"mlstm": _stack(sb["mlstm"], cfg.slstm_every - 1, device, (i,)),
             "slstm": _tensors(_layer(sb["slstm"], (i,)), device)}
            for i in range(n_super)]
    elif cfg.family == "hybrid":
        per = cfg.attn_every
        n_super = cfg.num_layers // per
        out["superblocks"] = [_stack(tree["superblocks"], per, device, (i,))
                              for i in range(n_super)]
        out["tail_blocks"] = _stack(tree["tail_blocks"],
                                    cfg.num_layers - n_super * per, device)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return out


def _host(tree: Any) -> Any:
    """numpy copies of a subtree's tensors (never views of them)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True).numpy()


def _empty_like(block: Any) -> Any:
    """A block's subtree with every leaf stacked zero times (zamba2's tail
    when the layers divide into superblocks)."""
    if isinstance(block, dict):
        return {k: _empty_like(v) for k, v in block.items()}
    return np.zeros((0, *block.shape), block.detach().cpu().numpy().dtype)


def _stacked(layers: Sequence[Any]) -> Any:
    """One subtree whose leaves stack the layers' leaves on a new first
    axis (on the tensors' device, then one copy to the host)."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stacked([layer[k] for layer in layers]) for k in first}
    if isinstance(first, list):
        return _stacked([_stacked(layer) for layer in layers])
    if isinstance(first, np.ndarray):
        return np.stack(layers)
    return torch.stack([t.detach() for t in layers]).cpu().numpy()


def params_to_numpy(cfg: ModelConfig, params: dict) -> dict:
    """The reference's numpy tree from the port's parameters: the inverse
    of :func:`params_from_numpy` (the layer lists stacked back into the
    reference's leaves).

    Args:
        cfg: the config the parameters were built for.
        params: the port's parameters (or any tree of its structure, such
            as AdamW's ``m`` and ``v``).

    Returns:
        A tree of fresh numpy arrays with the reference's keys and shapes.
    """
    stacked = {"layers", "encoder_layers", "superblocks", "tail_blocks"}
    out = {k: _host(v) for k, v in params.items() if k not in stacked}
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        for key in ("layers", "encoder_layers"):
            if key in params:
                out[key] = _stacked(params[key])
    elif cfg.family == "ssm":
        sb = params["superblocks"]
        out["superblocks"] = {
            "mlstm": _stacked([s["mlstm"] for s in sb]),
            "slstm": _stacked([s["slstm"] for s in sb])}
    elif cfg.family == "hybrid":
        out["superblocks"] = _stacked(params["superblocks"])
        tail = params["tail_blocks"]
        out["tail_blocks"] = (_stacked(tail) if tail else
                              _empty_like(params["superblocks"][0][0]))
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return out


def params_from_zamba2_state_dict(cfg: Zamba2Config, sd: dict) -> dict:
    """The port's parameters of the published Zamba2 layout from tensors
    named as ``transformers``' ``Zamba2ForCausalLM`` names its parameters
    (each once, as ``named_parameters`` gives them: a shared block under
    the first hybrid layer that runs it, the tied LM head as the
    embedding). Dense kernels are the state dict's (out, in) weights
    transposed, as views (no copy); the embedding table stays as it is;
    norms, the conv and the SSD's scalars are made f32.

    Args:
        cfg: the layout the tensors were drawn for.
        sd: name -> tensor, any device and dtype.

    Returns:
        The tree :meth:`Model.init` of ``build_model(cfg)`` returns.
    """
    def lin(name):
        return {"kernel": sd[name].t()}

    def f32(name):
        return sd[name].float()

    ids = list(cfg.hybrid_layer_ids)
    nb = cfg.num_mem_blocks
    layers = []
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}." + ("mamba_decoder." if i in ids else "")
        m = pre + "mamba."
        layers.append({"ln": {"scale": f32(pre + "input_layernorm.weight")},
                       "mamba": {
                           "in_proj": lin(m + "in_proj.weight"),
                           "conv_w": sd[m + "conv1d.weight"][:, 0, :].t()
                           .float().contiguous(),
                           "conv_b": f32(m + "conv1d.bias"),
                           "A_log": f32(m + "A_log"),
                           "D": f32(m + "D"),
                           "dt_bias": f32(m + "dt_bias"),
                           "norm": {"scale": f32(m + "norm.weight")},
                           "out_proj": lin(m + "out_proj.weight")}})
    shared = [f"model.layers.{ids[b]}.shared_transformer." for b in range(nb)]
    blocks = [{"ln_attn": {"scale": f32(s + "input_layernorm.weight")},
               "attn": {w: lin(s + f"self_attn.{n}_proj.weight")
                        for w, n in (("wq", "q"), ("wk", "k"), ("wv", "v"),
                                     ("wo", "o"))},
               "ln_mlp": {"scale": f32(s + "pre_ff_layernorm.weight")},
               "gate_up": lin(s + "feed_forward.gate_up_proj.weight"),
               "down": lin(s + "feed_forward.down_proj.weight")}
              for s in shared]
    hybrid = []
    for j, layer in enumerate(ids):
        ad = shared[j % nb] + f"feed_forward.gate_up_proj_adapter_list.{j}."
        hybrid.append({"adapter_in": lin(ad + "0.weight"),
                       "adapter_out": lin(ad + "1.weight"),
                       "linear": lin(f"model.layers.{layer}.linear.weight")})
    return {"embed": {"table": sd["model.embed_tokens.weight"]},
            "layers": layers, "blocks": blocks, "hybrid": hybrid,
            "final_norm": {"scale": f32("model.final_layernorm.weight")}}


META = torch.device("meta")


def _meta_stack(items: list, template: Any = None) -> Any:
    """Leaves of ``items`` stacked on a new first dim, as meta tensors;
    ``template`` gives the leaves of a stack of zero items."""
    first = items[0] if items else template
    if isinstance(first, dict):
        return {k: _meta_stack([i[k] for i in items], first[k])
                for k in first}
    return torch.empty((len(items), *first.shape), dtype=first.dtype,
                       device=META)


def _innermost(items: list) -> Any:
    while isinstance(items, list):
        items = items[0]
    return items


def reference_layout(tree: Any) -> Any:
    """The reference's layout of a port tree, shapes and dtypes only.

    Lists of layers stack into leaves with a leading dim (lists of lists,
    zamba2's superblocks and xLSTM's mLSTM blocks, into two), a cache's
    ``len`` (a Python int) becomes an int32 scalar as the reference holds
    it, and every tensor becomes a meta tensor of its shape and dtype. An
    empty list (zamba2's tail when its layers divide into superblocks)
    stacks zero of the blocks its sibling list of superblocks holds.

    Args:
        tree: the port's parameters or cache (any device, meta included).

    Returns:
        A tree of meta tensors with the reference's keys and shapes.
    """
    if isinstance(tree, dict):
        siblings = [v for v in tree.values()
                    if isinstance(v, list) and v and isinstance(v[0], list)]
        return {k: (_meta_stack([], reference_layout(_innermost(siblings)))
                    if isinstance(v, list) and not v
                    else reference_layout(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return _meta_stack([reference_layout(t) for t in tree])
    if isinstance(tree, int):
        return torch.empty((), dtype=torch.int32, device=META)
    return torch.empty(tree.shape, dtype=tree.dtype, device=META)
