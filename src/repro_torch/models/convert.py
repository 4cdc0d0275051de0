"""Parameters from the reference package's tree, given as numpy arrays.

The reference stacks its layers (``superblocks`` leaves are (n_super,
attn_every, ...), ``tail_blocks`` leaves (n_tail, ...)) and the port keeps
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


def params_from_numpy(cfg: ModelConfig, tree: dict, *,
                      device: torch.device | str = "cuda:0") -> dict:
    """The port's zamba2 parameters from the reference's numpy tree.

    Args:
        cfg: the hybrid config both trees were built for.
        tree: the reference's parameters with numpy leaves.
        device: where the tensors go.

    Returns:
        The tree :meth:`Model.init` would return, with these values.

    Raises:
        NotImplementedError: a family the port does not build yet.
    """
    if cfg.family != "hybrid":
        raise NotImplementedError(
            f"params_from_numpy: the {cfg.family} family is not ported yet")
    device = torch.device(device)
    per = cfg.attn_every
    n_super = cfg.num_layers // per
    n_tail = cfg.num_layers - n_super * per
    return {
        "embed": _tensors(tree["embed"], device),
        "superblocks": [[_tensors(_layer(tree["superblocks"], (i, j)), device)
                         for j in range(per)] for i in range(n_super)],
        "tail_blocks": [_tensors(_layer(tree["tail_blocks"], (i,)), device)
                        for i in range(n_tail)],
        "shared": _tensors(tree["shared"], device),
        "final_norm": _tensors(tree["final_norm"], device),
    }
