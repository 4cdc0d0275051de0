"""The reference's parameter specs as its rules mean them, for the tests
that hold the port's placements and per-device bytes to the reference's.

The reference's rules have one fault that the port repairs
(``src/repro/models/sharding.py:160-165``): a rule of two dims on a leaf
stacked twice is padded to the wrong arity, and for zamba2's
``mamba/out_proj`` and the xLSTM's ``mlstm/down`` that puts ``model`` on
the blocks of a superblock instead of on d_inner. :func:`intended` gives
the reference's specs with the rule right-aligned on those two leaves,
resolved by the reference's own ``_resolve``; every other leaf keeps the
reference's spec as it is.
"""
import re

import jax

import repro.models.sharding as ref_sharding

LAYER_DIM_RULES = re.compile(
    r"superblocks/(mamba/out_proj|mlstm/mlstm/down)/kernel$")


def intended(params, specs):
    """``specs``, the reference's ``param_specs(params)`` under the mesh in
    force, with ``[model, None]`` right-aligned on the leaves of
    :data:`LAYER_DIM_RULES` (FSDP's data axes then on the last dim)."""
    sizes = ref_sharding._mesh_axis_sizes()

    def fix(path, leaf, spec):
        if not sizes or not LAYER_DIM_RULES.search(
                ref_sharding.param_path_str(path)):
            return spec
        full = [None] * (leaf.ndim - 2) + [ref_sharding.MODEL_AXIS, None]
        if ref_sharding._FSDP:
            full[-1] = ref_sharding.BATCH_AXES
        return ref_sharding._resolve(full, leaf.shape, sizes)

    return jax.tree_util.tree_map_with_path(fix, params, specs)
