"""The port's dry run against the reference's accounting, on the CPU.

The reference lowers and compiles each cell for 256 or 512 fake devices;
the port traces it on the meta device and keeps the reference's analytic
fields. Here: the inputs, ``GRAD_ACCUM``, the model FLOPs and the
``long_500k`` skip equal the reference's; ``run_cell``'s analytic fields
(parameter count, per-device state, the roofline's FLOPs and bytes, the
model FLOPs, the FSDP decision) equal what the reference's ``run_cell``
computes for the same cell and layout, its specs evaluated on abstract
meshes; full-width cells are traced partitioned at their global shapes on
the production meshes, with collective bytes and a footprint, and on the
card's layout unpartitioned, with neither collectives nor a process group;
every family's reduced config runs train, prefill and decode (the port's
counterpart of ``tests/test_dryrun_small.py``, without the compile); the
CLIs run. All equalities are exact: the same arithmetic on the same
shapes. ``tests/test_torch_partition.py`` holds the partitioned path.
"""
import dataclasses
import json
import math
import os
import types

import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh, AxisType

import repro.models.sharding as ref_sharding
from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.models import cache_specs as ref_cache_specs
from repro.models import count_params as ref_count_params
from repro.models import param_specs as ref_param_specs
from repro.roofline import flops as ref_flops
from _torch_rules import intended, intended_cache
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import MeshLayout, make_mesh
from repro_torch.models import sharding

# the reference's dry-run module sets XLA_FLAGS for 512 host devices when
# imported: bring this process's backend up first, and restore the flags
jax.devices()
_FLAGS = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as ref_dryrun  # noqa: E402
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

LAYOUTS = {"single": ((16, 16), ("data", "model")),
           "multi": ((2, 16, 16), ("pod", "data", "model")),
           "card": ((1, 1), ("data", "model"))}
ANALYTIC = ("n_params", "state_bytes_per_dev", "chips", "flops_per_dev",
            "bytes_per_dev", "model_flops")


@pytest.fixture(autouse=True)
def fsdp_off():
    """``run_cell`` sets FSDP in the port, as the reference's sets it in
    its package: off again after each test, in both."""
    yield
    sharding.set_fsdp(False)
    ref_sharding.set_fsdp(False)


def reference_analytic(arch, shape_name, mesh):
    """The analytic fields the reference's ``run_cell`` computes
    (``launch/dryrun.py:114-122``, ``:203-221``), on an abstract mesh of
    the same axis sizes, its parameter and cache specs with the repairs
    the port makes (``_torch_rules.intended``, ``intended_cache``); and
    its FSDP decision."""
    cfg = dataclasses.replace(ref_config(arch), attn_impl="chunked",
                              mixer_impl="chunked", remat=True)
    shape = SHAPES[shape_name]
    fsdp = cfg.n_params() * 12 / 16 > 8e9
    ref_sharding.set_fsdp(fsdp)
    model = ref_build(cfg)
    mesh_shape, axes = LAYOUTS[mesh]
    fake = types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(mesh_shape, object))
    with jax.sharding.use_abstract_mesh(AbstractMesh(
            mesh_shape, axes, axis_types=(AxisType.Auto,) * len(axes))):
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        n_params = ref_count_params(params)
        param_bytes = ref_dryrun.sharded_bytes(
            params, intended(params, ref_param_specs(params)), fake)
        cache_bytes = 0.0
        if shape.kind == "train":
            state = 3 * param_bytes
        elif shape.kind == "decode":
            cache = jax.eval_shape(lambda: model.init_cache(
                shape.global_batch, shape.seq_len))
            cache_bytes = ref_dryrun.sharded_bytes(
                cache, intended_cache(cache, ref_cache_specs(cache)), fake)
            state = param_bytes + cache_bytes
        else:
            state = param_bytes
    chips = math.prod(mesh_shape)
    dp_shards = chips // mesh_shape[-1]
    return {"n_params": n_params, "state_bytes_per_dev": state,
            "chips": chips,
            "flops_per_dev": ref_flops.cell_flops(cfg, shape)["total_flops"]
            / chips,
            "bytes_per_dev": ref_flops.cell_bytes(
                cfg, shape, param_bytes_per_dev=param_bytes,
                cache_bytes_per_dev=cache_bytes, chips=chips,
                dp_shards=dp_shards),
            "model_flops": ref_dryrun.model_flops_for(cfg, shape,
                                                      n_params)}, fsdp


@pytest.mark.parametrize("arch,shape,mesh", [
    ("qwen3-0.6b", "decode_32k", "single"),
    ("qwen3-0.6b", "train_4k", "multi"),
    ("internvl2-1b", "prefill_32k", "single"),
    ("phi3.5-moe-42b-a6.6b", "decode_32k", "multi"),
    ("qwen1.5-110b", "decode_32k", "single"),
    ("whisper-medium", "decode_32k", "multi"),
    ("zamba2-7b", "long_500k", "single"),
    ("xlstm-1.3b", "long_500k", "multi"),
    ("h2o-danube3-4b", "long_500k", "single")])
def test_full_width_cell_traces_and_accounts_as_the_reference(arch, shape,
                                                              mesh):
    got = dryrun.run_cell(arch, shape, mesh, verbose=False)
    want, fsdp = reference_analytic(arch, shape, mesh)
    assert got["status"] == "ok"
    assert {k: got[k] for k in ANALYTIC} == want
    assert sharding._FSDP == fsdp
    assert (got["arch"], got["shape"], got["mesh"]) == (arch, shape, mesh)
    assert got["traced_flops"] > 0 and got["trace_seconds"] >= 0
    # partitioned on a fake group of the mesh's ranks: rank 0's collective
    # bytes and its peak of live bytes, inputs and state included
    assert got["coll_source"] == dryrun.COLL_SOURCES["partitioned"]
    assert got["coll_bytes_per_dev"] == sum(
        got["coll_breakdown"].values()) > 0
    assert got["hbm_per_dev"] >= got["state_bytes_per_dev"]
    assert not torch.distributed.is_initialized()
    if SHAPES[shape].kind == "decode" and get_config(arch).family in (
            "dense", "vlm", "encdec"):
        # one token against the cache: the whole step's trace (the card's
        # layout) is the analytic count's to a few percent (MoE also
        # computes its capacity's empty slots; for the recurrent families
        # the count takes the chunked form's per-token cost, which a decode
        # step does not run), and one rank runs at least its share of it
        # and at most all of it
        whole = dryrun.run_cell(arch, shape, "card", verbose=False)
        assert whole["traced_flops"] == pytest.approx(
            got["flops_per_dev"] * got["chips"], rel=0.05)
        assert got["flops_per_dev"] * 0.95 <= got["traced_flops"] <= \
            whole["traced_flops"]


def test_card_mesh_is_one_device_and_starts_no_process_group():
    got = dryrun.run_cell("qwen3-0.6b", "decode_32k", "card", verbose=False)
    want, _ = reference_analytic("qwen3-0.6b", "decode_32k", "card")
    assert {k: got[k] for k in ANALYTIC} == want
    assert got["chips"] == 1 and got["mesh"] == "card"
    assert not torch.distributed.is_initialized()
    # one device: no collective, the whole step's footprint and FLOPs
    assert (got["coll_bytes_per_dev"], got["coll_breakdown"],
            got["coll_source"]) == (0.0, {}, dryrun.COLL_SOURCES["card"])
    assert got["hbm_per_dev"] >= got["state_bytes_per_dev"]
    assert got["traced_flops"] == pytest.approx(got["flops_per_dev"],
                                                rel=0.05)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_skip_batch_specs_model_flops_and_accum_equal_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_config(arch)
    one = jax.make_mesh((1, 1), ("data", "model"))
    for name, shape in SHAPES.items():
        if name == "long_500k" and not cfg.subquadratic:
            assert dryrun.run_cell(arch, name, "single") == \
                ref_dryrun.run_cell(arch, name, False)
        structs, specs = dryrun.make_batch_specs(cfg, shape)
        want, _ = ref_dryrun.make_batch_specs(ref_cfg, shape, one)
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in structs.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        assert all(s == () for s in specs.values())   # no mesh in force
        for n in (10**6, 596_049_920):
            assert dryrun.model_flops_for(cfg, shape, n) == \
                ref_dryrun.model_flops_for(ref_cfg, shape, n)
    assert dryrun.GRAD_ACCUM == ref_dryrun.GRAD_ACCUM


SMALL_SHAPES = {"train_4k": ShapeConfig("train_4k", 32, 8, "train"),
                "prefill_32k": ShapeConfig("prefill_32k", 32, 8, "prefill"),
                "decode_32k": ShapeConfig("decode_32k", 32, 8, "decode")}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi3.5-moe-42b-a6.6b",
                                  "zamba2-7b", "xlstm-1.3b", "internvl2-1b",
                                  "whisper-medium"])
def test_reduced_configs_run_every_kind(monkeypatch, arch):
    """Every family's reduced config at B 8, T 32 on the (2, 2, 2) mesh
    (the reference's small dry run's batch and mesh), train, prefill and
    decode, partitioned."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).reduced())
    monkeypatch.setattr(dryrun, "SHAPES", SMALL_SHAPES)
    monkeypatch.setattr(dryrun, "layout_for", lambda m: MeshLayout(
        ("pod", "data", "model"), (2, 2, 2)))
    for name, shape in SMALL_SHAPES.items():
        got = dryrun.run_cell(arch, name, "multi", verbose=False)
        assert got["status"] == "ok" and got["traced_flops"] > 0
        assert got["chips"] == 8 and got["coll_bytes_per_dev"] > 0
        assert got["n_params"] == ref_count_params(
            ref_build(ref_config(arch).reduced()).init(
                jax.random.PRNGKey(0)))
        cfg = dataclasses.replace(get_config(arch).reduced(), remat=True)
        assert got["flops_per_dev"] * got["chips"] == \
            ref_flops.cell_flops(cfg, shape)["total_flops"]


def test_dryrun_cli_writes_each_cell_once(tmp_path, capsys):
    argv = ["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--mesh",
            "multi", "--out", str(tmp_path)]
    dryrun.main(argv)
    path = tmp_path / "qwen3-0.6b__decode_32k__multi.json"
    record = json.loads(path.read_text())
    assert record["status"] == "ok" and record["chips"] == 512
    assert "[qwen3-0.6b × decode_32k × multi]" in capsys.readouterr().out
    dryrun.main(argv)
    assert "[skip existing]" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        dryrun.main(["--out", str(tmp_path)])


def test_grid_runs_each_cell_in_a_child_process(tmp_path):
    """``run_cells``, the pool under ``--all``: each cell in a child
    process of its own that writes its record and its log under the out
    directory; the records come back in the cells' order, and a child
    that fails gives its exit status and log."""
    cells = [("qwen3-0.6b", "long_500k", "single"),
             ("no-such-arch", "train_4k", "single"),
             ("qwen3-0.6b", "long_500k", "multi")]
    got = dryrun.run_cells(cells, str(tmp_path))
    assert [(r["arch"], r["mesh"], r["status"]) for r in got] == [
        ("qwen3-0.6b", "single", "skipped"), ("no-such-arch", "single",
                                              "exit 2"),
        ("qwen3-0.6b", "multi", "skipped")]
    assert "invalid choice" in open(got[1]["log"]).read()
    for cell in cells[::2]:
        key = dryrun.cell_key(*cell)
        assert json.loads((tmp_path / f"{key}.json").read_text()) == \
            got[cells.index(cell)]
        assert (tmp_path / f"{key}.log").exists()


def test_train_cli_dry_run_runs_the_cell():
    single = train_cli.main(["--dry-run", "--arch", "qwen3-0.6b", "--shape",
                             "decode_32k"])
    multi = train_cli.main(["--dry-run", "--arch", "qwen3-0.6b", "--shape",
                            "decode_32k", "--multi-pod"])
    assert (single["status"], single["mesh"], single["chips"]) == \
        ("ok", "single", 256)
    assert (multi["mesh"], multi["chips"]) == ("multi", 512)
    card = train_cli.main(["--dry-run", "--arch", "qwen3-0.6b", "--shape",
                           "decode_32k", "--mesh", "card"])
    assert (card["mesh"], card["chips"], card["coll_bytes_per_dev"]) == \
        ("card", 1, 0.0)
    with pytest.raises(SystemExit):
        train_cli.main(["--dry-run", "--multi-pod", "--mesh", "card"])


def test_make_mesh_on_the_cpu():
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1) and mesh.size() == 1
        assert sharding.axis_sizes(mesh) == {"data": 1, "model": 1}
        with pytest.raises(ValueError, match="rank"):
            make_mesh((2, 1), ("data", "model"), device_type="cpu")
    finally:
        torch.distributed.destroy_process_group()
