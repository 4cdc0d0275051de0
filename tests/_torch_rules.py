"""The reference's parameter and cache specs as its rules mean them, for
the tests that hold the port's placements and per-device bytes to the
reference's.

The reference's rules have two faults that the port repairs, both on
leaves stacked twice (superblocks x blocks):

- ``param_specs`` (``src/repro/models/sharding.py:160-165``) pads a rule
  of two dims to the wrong arity, and for zamba2's ``mamba/out_proj`` and
  the xLSTM's ``mlstm/down`` that puts ``model`` on the blocks of a
  superblock instead of on d_inner. :func:`intended` gives the
  reference's specs with the rule right-aligned on those two leaves.
- ``cache_specs`` (``src/repro/models/sharding.py:182-211``) takes one
  stacked dim, so on zamba2's ``super`` and the xLSTM's ``mlstm`` caches
  the batch axes land on the blocks dim and ``model`` on the batch.
  :func:`intended_cache` gives its specs with the rule right-aligned
  there: the batch axes on B, ``model`` on the first trailing dim it
  divides.

Both resolve by the reference's own ``_resolve``; every other leaf keeps
the reference's spec as it is.
"""
import re

import jax

import repro.models.sharding as ref_sharding

LAYER_DIM_RULES = re.compile(
    r"superblocks/(mamba/out_proj|mlstm/mlstm/down)/kernel$")
CACHE_STACKED_TWICE = re.compile(r"^(super|mlstm)/")


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


def intended_cache(cache, specs):
    """``specs``, the reference's ``cache_specs(cache)`` under the mesh in
    force, with the rule right-aligned on the leaves of
    :data:`CACHE_STACKED_TWICE` (two stacked dims, then B)."""
    sizes = ref_sharding._mesh_axis_sizes()
    model_size = sizes.get(ref_sharding.MODEL_AXIS, 1)

    def fix(path, leaf, spec):
        if not sizes or leaf.ndim <= 1 or not CACHE_STACKED_TWICE.search(
                ref_sharding.param_path_str(path)):
            return spec
        full = [None, None, ref_sharding.BATCH_AXES] + [None] * (
            leaf.ndim - 3)
        for d in range(3, leaf.ndim):
            if leaf.shape[d] % model_size == 0 and \
                    leaf.shape[d] >= model_size:
                full[d] = ref_sharding.MODEL_AXIS
                break
        return ref_sharding._resolve(full, leaf.shape, sizes)

    return jax.tree_util.tree_map_with_path(fix, cache, specs)
