"""Logical→physical sharding rules for params, activations and caches (the
reference's rules, on the port's trees).

Conventions (as the reference's, GSPMD-style):
  * batch-like dims   → ("pod", "data")   (whichever axes the mesh has)
  * model-parallel    → "model": attention heads, FFN hidden, vocab,
                        expert (EP), mamba/mLSTM inner dims
  * everything else   → replicated

A spec is a tuple with one entry a dim: ``None``, an axis name, or a tuple
of axis names, as jax's ``PartitionSpec`` holds them, so a test compares
the two entry for entry. All rules are divisibility-checked against the
mesh in force (:func:`use_mesh`): an axis that does not divide the dim is
dropped. The rules read paths of the reference's stacked layout
(``layers/attn/wq/kernel`` with a leading layer dim), which
``convert.reference_layout`` gives the port's per-layer trees. The port
runs unpartitioned, so :func:`shard` constrains nothing.
"""
from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Any, Iterator, Optional, Sequence

import torch

from ..tree import tree_map_with_path

Spec = tuple

BATCH_AXES = ("pod", "data")
MODEL_AXIS = "model"

# FSDP (ZeRO-3): when enabled, parameter/optimizer leaves additionally
# shard their non-"model" dim over the data axes.
_FSDP = False
_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


def set_fsdp(enabled: bool) -> None:
    global _FSDP
    _FSDP = bool(enabled)


def axis_sizes(mesh: Any) -> dict[str, int]:
    """Axis name → size of a ``DeviceMesh`` or a ``launch.mesh.MeshLayout``
    (both name their axes ``mesh_dim_names``, sized by ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@contextlib.contextmanager
def use_mesh(mesh: Any) -> Iterator[Any]:
    """The mesh the specs resolve against inside the block (jax's
    ``use_abstract_mesh``/``set_mesh``)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def _mesh_axis_sizes() -> dict[str, int]:
    mesh = _MESH.get()
    return {} if mesh is None else axis_sizes(mesh)


def _resolve(spec_axes: Sequence, shape: Sequence[int],
             sizes: dict[str, int]) -> Spec:
    """Filter logical spec entries by mesh presence + divisibility."""
    out = []
    for dim, entry in zip(shape, spec_axes):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = [a for a in axes if a in sizes]
        factor = 1
        for a in axes:
            factor *= sizes[a]
        if axes and dim % factor == 0:
            out.append(tuple(axes) if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    return tuple(out)


def shard(x: torch.Tensor, *spec_axes) -> torch.Tensor:
    """The reference's activation sharding constraint. The port's programs
    are not partitioned, so there is nothing to constrain: ``x`` is
    returned as it is."""
    del spec_axes
    return x


def batch_spec(x_shape: Sequence[int]) -> Spec:
    """(batch, ...) arrays: shard dim 0 over pod+data."""
    sizes = _mesh_axis_sizes()
    axes = [BATCH_AXES] + [None] * (len(x_shape) - 1)
    return _resolve(axes, x_shape, sizes) if sizes else ()


# ---------------------------------------------------------------------------
# Parameter rules: path regex → logical spec per dim (matched in order).
# Paths look like "layers/attn/wq/kernel", "layers/moe/wi_gate", ...
# ---------------------------------------------------------------------------

_PARAM_RULES: list[tuple[str, list]] = [
    # embeddings / unembeddings: vocab over model (dropped where the vocab
    # does not divide)
    (r"embed/table$", [MODEL_AXIS, None]),
    (r"lm_head/kernel$", [None, MODEL_AXIS]),
    # attention: out-features of q/k/v over model, in-features of o
    (r"(attn|self_attn|cross_attn|shared_attn)/w[qkv]/kernel$",
     [None, MODEL_AXIS]),
    (r"(attn|self_attn|cross_attn|shared_attn)/w[qkv]/bias$", [MODEL_AXIS]),
    (r"(attn|self_attn|cross_attn|shared_attn)/wo/kernel$",
     [MODEL_AXIS, None]),
    # dense MLPs
    (r"mlp/wi(_gate|_up)?/kernel$", [None, MODEL_AXIS]),
    (r"mlp/wo/kernel$", [MODEL_AXIS, None]),
    (r"mlp/wi/bias$", [MODEL_AXIS]),
    # MoE: expert-parallel over model
    (r"moe/router/kernel$", [None, None]),
    (r"moe/wi_(gate|up)$", [MODEL_AXIS, None, None]),
    (r"moe/wo$", [MODEL_AXIS, None, None]),
    # Mamba2 / mLSTM inner projections
    (r"(mamba|mlstm)/in_proj/kernel$", [None, MODEL_AXIS]),
    (r"(mamba|mlstm)/(out_proj|down)/kernel$", [MODEL_AXIS, None]),
    (r"mlstm/(up|up_gate|wq|wk|wv|w_if)/kernel$", [None, MODEL_AXIS]),
    # everything else replicated
]

_STACKED = re.compile(r"(^|/)(layers|blocks|encoder_layers|superblocks|"
                      r"tail_blocks)(/|$)")


def param_path_str(path: Sequence) -> str:
    return "/".join(str(k) for k in path)


def param_specs(params: Any) -> Any:
    """A spec for each leaf of a parameter tree in the reference's stacked
    layout (the leading layer dim of a stacked leaf is never sharded)."""
    sizes = _mesh_axis_sizes()

    def spec_for(path, leaf):
        pstr = param_path_str(path)
        ndim = leaf.dim()
        lead = 1 if _STACKED.search(pstr) else 0
        for pattern, axes in _PARAM_RULES:
            if re.search(pattern, pstr):
                body = axes
                if lead + len(body) != ndim:
                    # rule arity mismatch (a leaf stacked twice, as
                    # zamba2's superblocks): the rule's last dims, as the
                    # reference takes them
                    body = axes[-(ndim - lead):] if ndim > lead else []
                full = [None] * lead + list(body)
                if _FSDP and ndim - lead >= 2:
                    # shard the first free dim over the data axes
                    for i in range(lead, ndim):
                        if full[i] is None:
                            full[i] = BATCH_AXES
                            break
                if not sizes:
                    return ()
                return _resolve(full, leaf.shape, sizes)
        full: list[Optional[Any]] = [None] * ndim
        if _FSDP and ndim - lead >= 2:
            full[lead] = BATCH_AXES
        return () if not sizes else _resolve(full, leaf.shape, sizes)

    return tree_map_with_path(spec_for, params)


def cache_specs(cache: Any) -> Any:
    """KV/state caches in the reference's stacked layout: batch dim over
    pod+data, the first trailing dim the model axis divides over model.

    Leaves are (L, B, H, S, D) KV rings, (L, B, H, s, d) SSM states,
    (L, B, W, C) conv buffers, or lengths. The stacked layer dim is never
    sharded.
    """
    sizes = _mesh_axis_sizes()
    model_size = sizes.get(MODEL_AXIS, 1)

    def spec_for(path, leaf):
        if not sizes:
            return ()
        ndim = leaf.dim()
        if ndim <= 1:
            return () if ndim == 0 else _resolve([None], leaf.shape, sizes)
        axes: list = [None, BATCH_AXES] + [None] * (ndim - 2)
        # heads when the model axis divides them, else sequence (ring
        # decode = sequence-parallel attention), else the state dim
        for d in range(2, ndim):
            if leaf.shape[d] % model_size == 0 and \
                    leaf.shape[d] >= model_size:
                axes[d] = MODEL_AXIS
                break
        return _resolve(axes, leaf.shape, sizes)

    return tree_map_with_path(spec_for, cache)
