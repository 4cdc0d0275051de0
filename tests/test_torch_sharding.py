"""The port's sharding rules and layouts against the reference's.

The reference's specs are evaluated in this process on abstract meshes
(``jax.sharding.use_abstract_mesh``: axis names and sizes, no devices) over
``jax.eval_shape`` of its initialisers; the port's over
``reference_layout`` of meta-device trees under the same axis sizes
(``MeshLayout``). Three meshes, FSDP off and on, every family's reduced
config and three full ones (shapes only): every leaf's path, shape, dtype
and spec, entry for entry, and the per-device bytes they give, must be
equal, for parameters and for decode caches. Exact equality throughout:
the rules are the same code on the same shapes, but for the two faults of
the reference's rules that the port repairs (``_torch_rules``: out_proj's
and down's rule, and the cache rule, right-aligned on twice-stacked
superblocks), where the port is held to the rule as the reference's
``_resolve`` gives it.
"""
import os
import types

import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh, AxisType, PartitionSpec as P

import repro.models.sharding as ref_sharding
from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.models import cache_specs as ref_cache_specs
from repro.models import count_params as ref_count_params
from repro.models import param_specs as ref_param_specs
from _torch_rules import intended, intended_cache
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.dryrun import sharded_bytes
from repro_torch.launch.mesh import MeshLayout, make_production_mesh
from repro_torch.models import (build_model, cache_specs, count_params,
                                param_specs, reference_layout, shard)
from repro_torch.models import sharding
from repro_torch.tree import leaves_with_path

# the reference's dry-run module sets XLA_FLAGS for 512 host devices when
# imported: bring this process's backend up first, and restore the flags
jax.devices()
_FLAGS = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as ref_dryrun  # noqa: E402
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

META = torch.device("meta")
MESHES = [((2, 2, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
CONFIGS = [(arch, True) for arch in ARCH_IDS] + [
    ("qwen3-0.6b", False), ("zamba2-7b", False),
    ("phi3.5-moe-42b-a6.6b", False)]


def _configs(arch, reduced):
    if reduced:
        return get_config(arch).reduced(), ref_config(arch).reduced()
    return get_config(arch), ref_config(arch)


def _abstract(shape, axes):
    return AbstractMesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


def _reference_mesh(shape, axes):
    """What the reference's ``sharded_bytes`` reads of a mesh."""
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, dtype=object))


@pytest.fixture
def fsdp(request):
    """FSDP set in both packages for the test, off afterwards."""
    ref_sharding.set_fsdp(request.param)
    sharding.set_fsdp(request.param)
    yield request.param
    ref_sharding.set_fsdp(False)
    sharding.set_fsdp(False)


def _flat_reference(structs, specs):
    out = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_leaves_with_path(structs),
            jax.tree_util.tree_leaves(specs,
                                      is_leaf=lambda x: isinstance(x, P))):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype), tuple(spec))
    return out


def _flat_port(structs, specs):
    out = {}
    for path, leaf in leaves_with_path(structs):
        spec = specs
        for key in path:
            spec = spec[key]
        out["/".join(map(str, path))] = (
            tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""), spec)
    return out


def _cache_shape(reduced):
    return (8, 32) if reduced else (128, 32768)


@pytest.mark.parametrize("fsdp", [False, True], indirect=True)
@pytest.mark.parametrize("mesh_shape,axes", MESHES)
@pytest.mark.parametrize("arch,reduced", CONFIGS)
def test_specs_and_bytes_equal_the_reference(arch, reduced, mesh_shape, axes,
                                             fsdp):
    cfg, ref_cfg = _configs(arch, reduced)
    ref_model, model = ref_build(ref_cfg), build_model(cfg)
    B, S = _cache_shape(reduced)
    with jax.sharding.use_abstract_mesh(_abstract(mesh_shape, axes)):
        ref_params = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
        ref_p_specs = intended(ref_params, ref_param_specs(ref_params))
        ref_cache = jax.eval_shape(lambda: ref_model.init_cache(B, S))
        ref_c_specs = intended_cache(ref_cache,
                                     ref_cache_specs(ref_cache))
    layout = MeshLayout(axes, mesh_shape)
    params = model.init(torch.Generator().manual_seed(0), META)
    p_struct = reference_layout(params)
    c_struct = reference_layout(model.init_cache(B, S, device=META))
    with sharding.use_mesh(layout):
        p_specs = param_specs(p_struct)
        c_specs = cache_specs(c_struct)
    assert count_params(params) == ref_count_params(ref_params)
    assert _flat_port(p_struct, p_specs) == \
        _flat_reference(ref_params, ref_p_specs)
    assert _flat_port(c_struct, c_specs) == \
        _flat_reference(ref_cache, ref_c_specs)
    ref_mesh = _reference_mesh(mesh_shape, axes)
    assert sharded_bytes(p_struct, p_specs, layout) == \
        ref_dryrun.sharded_bytes(ref_params, ref_p_specs, ref_mesh)
    assert sharded_bytes(c_struct, c_specs, layout) == \
        ref_dryrun.sharded_bytes(ref_cache, ref_c_specs, ref_mesh)


@pytest.mark.parametrize("mesh_shape,axes", MESHES)
def test_batch_spec_equals_the_reference(mesh_shape, axes):
    shapes = [(8, 32), (256, 4096), (1, 1), (6, 5), (32, 1500, 1024),
              (128, 1), (4,)]
    with jax.sharding.use_abstract_mesh(_abstract(mesh_shape, axes)):
        want = [tuple(ref_sharding.batch_spec(s)) for s in shapes]
    with sharding.use_mesh(MeshLayout(axes, mesh_shape)):
        got = [sharding.batch_spec(s) for s in shapes]
    assert got == want


def test_no_mesh_gives_empty_specs_and_shard_is_the_identity():
    cfg = get_config("qwen3-0.6b").reduced()
    p_struct = reference_layout(build_model(cfg).init(
        torch.Generator().manual_seed(0), META))
    assert all(spec == () for _, spec in leaves_with_path(
        param_specs(p_struct)))
    assert sharding.batch_spec((8, 32)) == ()
    x = torch.ones(4, 2)
    assert shard(x, ("pod", "data"), "model") is x


def test_rules_are_the_references():
    assert sharding._PARAM_RULES == ref_sharding._PARAM_RULES
    assert (sharding.BATCH_AXES, sharding.MODEL_AXIS) == \
        (ref_sharding.BATCH_AXES, ref_sharding.MODEL_AXIS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_width_layout_and_count_equal_the_reference(arch):
    """Every full config's parameter tree, shapes only: the port's meta
    init in the reference's layout has the reference's paths, shapes,
    dtypes and count."""
    ref_params = jax.eval_shape(ref_build(ref_config(arch)).init,
                                jax.random.PRNGKey(0))
    params = build_model(get_config(arch)).init(
        torch.Generator().manual_seed(0), META)
    p_struct = reference_layout(params)
    want = {k: v[:2] for k, v in _flat_reference(
        ref_params, jax.tree.map(lambda _: P(), ref_params)).items()}
    got = {"/".join(map(str, path)): (tuple(leaf.shape),
                                      str(leaf.dtype).replace("torch.", ""))
           for path, leaf in leaves_with_path(p_struct)}
    assert got == want
    assert count_params(params) == ref_count_params(ref_params)


def test_production_layouts_are_the_references():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert (single.mesh_dim_names, single.shape, single.size()) == \
        (("data", "model"), (16, 16), 256)
    assert (multi.mesh_dim_names, multi.shape, multi.size()) == \
        (("pod", "data", "model"), (2, 16, 16), 512)
