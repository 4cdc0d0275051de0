"""Parameters from the reference package's tree, given as numpy arrays.

The reference stacks its layers (zamba2's ``superblocks`` leaves are
(n_super, attn_every, ...), a decoder's ``layers`` (L, ...), xLSTM's
``superblocks`` {"mlstm": (n_super, 7, ...), "slstm": (n_super, ...)},
whisper's ``encoder_layers`` and ``layers`` (L, ...)) and the port keeps
lists of per-layer dicts, so :func:`params_from_numpy` unstacks them;
every other leaf is copied as it is. With the same values both packages
compute the same function, which is how the tests hold the port against
the reference. Nothing here imports the reference: the caller turns its
arrays into numpy first (``jax.tree.map(np.asarray, params)``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig


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
