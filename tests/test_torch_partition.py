"""The port's partitioned path against the reference's and against itself
unpartitioned, on the CPU.

- Placements: on a (2, 2, 2) ``("pod", "data", "model")`` mesh (a fake
  process group here; 8 host devices for the reference, in a subprocess
  with its own XLA_FLAGS, as ``tests/test_dryrun_small.py`` runs it),
  every parameter and cache leaf of reduced qwen3-0.6b, phi3.5-moe and
  zamba2-7b has, on rank 0, the local shard shape that the reference's
  ``NamedSharding(mesh, spec).shard_shape`` gives its stacked leaf, and
  the local bytes sum to the reference's, exactly. The one leaf where the
  reference's rule lands on a layer dim (zamba2's ``mamba/out_proj``,
  model over the blocks of a superblock) has d_inner over model in the
  port, as the rule means (``_torch_rules``), at the same bytes; zamba2's
  twice-stacked ``super`` caches have the batch over pod and data and
  the heads over model, as the cache rule means (the reference's puts
  model on the batch), at the bytes of that rule.
- A batch smaller than the data axis: every family's reduced config at
  B 8, T 32 on the 16 x 16 mesh traces train, prefill and decode, and the
  per-device state it places equals the reference's ``sharded_bytes``
  (its specs with the two repairs).
- Numbers: on a real group of 4 gloo ranks on the CPU, (2, 2)
  ``("data", "model")``, reduced qwen3-0.6b in f32: the partitioned
  ``prefill_logits`` and one ``loss`` with its gradients equal the
  unpartitioned port's within 1e-5 of each leaf's scale (the unpartitioned
  port is held to the reference elsewhere); a checkpoint written by the
  reference's ``Checkpointer`` restores with ``shardings=`` onto that mesh,
  each rank's local shard equal to its slice of the array.
- The collective counter and the reference's ``collective_bytes`` agree on
  one all-gather, one reduce-scatter, one all-reduce and one all-to-all
  (DTensor's Shard -> Shard redistribution, issued as an all-gather and a
  chunk on a CPU mesh); ``pad_rows`` pads a sharded table by moving only
  the rows that change ranks, so qwen3-0.6b's unembedding gathers no
  table, and on four ranks each padded shard holds the right rows and
  the gradient comes back to the ranks that hold them.
- The dry run: each of the three families moves collective bytes on the
  (2, 2, 2) mesh (the reference's small dry run requires it), the card's
  layout none; no process group outlives a cell, and a fake group is
  never started over a live one. phi3.5-moe's experts gather no token
  row: each rank scatter-adds its own tokens into the expert rows it
  holds, and only those rows are all-reduced.
- torch 2.11's DTensor has no strategy for ``aten.flip``: a partitioned
  training step of zamba2-7b and xlstm-1.3b through the chunked forms
  sends none to a DTensor (``cumsum``'s own backward flips; the chunked
  forms' prefix sum does not, and its value and gradient are
  ``cumsum``'s).
- Twice-stacked caches (zamba2's ``super``, the xLSTM's ``mlstm``): the
  batch over pod and data and model on the heads, so a rank of the
  (2, 2, 2) mesh holds 1/8 of each.
- No DTensor reaches a hand kernel: every wrapper refuses one, and so does
  a partitioned prefill on ``attn_impl="flash"``.
"""
import dataclasses
import inspect
import json
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode

import jax
from jax.sharding import AbstractMesh, AxisType, PartitionSpec as P

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.models import cache_specs as ref_cache_specs
from repro.models import param_specs as ref_param_specs
from repro.roofline import collective_bytes as ref_collective_bytes
from _torch_rules import (CACHE_STACKED_TWICE, LAYER_DIM_RULES, intended,
                          intended_cache)
from repro_torch import kernels
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import chunked_linear_attention
from repro_torch.kernels.linear_attention import prefix_sum
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshLayout, fake_mesh, make_mesh
from repro_torch.models import (build_model, cache_specs, param_specs,
                                reference_layout)
from repro_torch.models import sharding
from repro_torch.optim import value_and_grad
from repro_torch.roofline import TraceCounter
from repro_torch.tree import leaves_with_path

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
META = torch.device("meta")
CUBE = MeshLayout(("pod", "data", "model"), (2, 2, 2))
FAMILIES = ["qwen3-0.6b", "phi3.5-moe-42b-a6.6b", "zamba2-7b"]
B, T = 8, 32

REFERENCE_SHARDS = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.models import build_model, cache_specs, param_specs
from _torch_rules import intended_cache

def shapes(structs, specs):
    out = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_leaves_with_path(structs),
            jax.tree_util.tree_leaves(specs,
                                      is_leaf=lambda x: isinstance(x, P))):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = list(NamedSharding(mesh, spec).shard_shape(leaf.shape))
    return out

mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
result = {}
for arch in sys.argv[1:]:
    model = build_model(get_config(arch).reduced())
    with jax.sharding.set_mesh(mesh):
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        cache = jax.eval_shape(lambda: model.init_cache(%d, %d))
        result[arch] = {"params": shapes(params, param_specs(params)),
                        "cache": shapes(cache, cache_specs(cache)),
                        "cache_intended": shapes(cache, intended_cache(
                            cache, cache_specs(cache)))}
print("RESULT" + json.dumps(result))
""" % (B, T)


def _env():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, os.path.dirname(__file__)]))
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def reference_shards():
    out = subprocess.run([sys.executable, "-c", REFERENCE_SHARDS, *FAMILIES],
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT")][0]
    return json.loads(line[len("RESULT"):])


def _at(tree, key):
    for k in key.split("/"):
        tree = tree[k]
    return tree


def _without_len(tree):
    """A cache's tree without its ``len`` counters (Python ints in the
    port, which are not placed)."""
    if isinstance(tree, dict):
        return {k: _without_len(v) for k, v in tree.items() if k != "len"}
    return tree


@pytest.mark.parametrize("arch", FAMILIES)
def test_local_shards_are_the_references(arch, reference_shards):
    model = build_model(get_config(arch).reduced())
    trees = {"params": model.init(torch.Generator().manual_seed(0), META),
             "cache": model.init_cache(B, T, device=META)}
    with fake_mesh(CUBE) as mesh:
        placed = {"params": sharding.place_params(trees["params"], mesh),
                  "cache": sharding.place_cache(trees["cache"], mesh)}
    assert not dist.is_initialized()
    got_bytes = want_bytes = ref_bytes = 0
    for kind, tree in trees.items():
        ref = reference_shards[arch][kind]
        stacked = reference_layout(tree)
        with sharding.use_mesh(CUBE):
            specs = (param_specs if kind == "params" else cache_specs)(
                stacked)
        want_bytes += dryrun.sharded_bytes(_without_len(stacked),
                                           _without_len(specs), CUBE)
        seen = set()
        for path, leaf in leaves_with_path(placed[kind]):
            if not isinstance(leaf, DTensor):
                assert path[-1] == "len"
                continue
            keys = [k for k in path if not isinstance(k, int)]
            key, lists = "/".join(keys), len(path) - len(keys)
            seen.add(key)
            whole = list(_at(stacked, key).shape)
            local = list(leaf.to_local().shape)
            got_bytes += math.prod(local) * leaf.element_size()
            want = ref[key]
            if kind == "cache" and CACHE_STACKED_TWICE.search(key):
                # the reference puts model on the batch; the port splits
                # the batch over pod and data, and model on what follows
                assert want[lists] == whole[lists] // 2, key
                want = reference_shards[arch]["cache_intended"][key]
                assert want[lists] == whole[lists] // 4, key
            ref_bytes += math.prod(want) * leaf.element_size() / \
                math.prod(whole[:lists])
            if LAYER_DIM_RULES.search(key):
                # the reference splits the blocks of a superblock; the port
                # keeps them whole and splits d_inner over model
                assert want == [*whole[:lists - 1], whole[lists - 1] // 2,
                                *whole[lists:]], key
                assert local == [whole[-2] // 2, whole[-1]], key
                continue
            assert want == whole[:lists] + local, key
        for key in set(ref) - seen:      # counters, empty stacks
            assert key.split("/")[-1] == "len" or 0 in ref[key], key
    assert got_bytes == want_bytes == ref_bytes


def test_placements_split_pod_data_pod_major():
    with fake_mesh(CUBE) as mesh:
        flat = sharding.device_mesh(mesh)
        assert flat.mesh_dim_names == ("pod_data", "model")
        assert flat.mesh.tolist() == torch.arange(8).reshape(4, 2).tolist()
        assert sharding.placements((("pod", "data"), None, "model"),
                                   mesh) == [Shard(0), Shard(2)]
        assert sharding.placements((None, None), mesh) == [Replicate()] * 2
        for bad in (("data", None), (("data", "pod"),), ("model", "model")):
            with pytest.raises(ValueError, match="mesh axes"):
                sharding.placements(bad, mesh)
    with fake_mesh(MeshLayout(("data", "model"), (4, 2))) as mesh:
        assert sharding.device_mesh(mesh) is mesh
        assert sharding.placements(("data", "model"), mesh) == \
            [Shard(0), Shard(1)]


WORKER = r"""
import dataclasses, functools, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def slice_of(arr, spec, coord, names, sizes):
    index = []
    for dim, entry in enumerate(spec):
        if entry is None:
            index.append(slice(None))
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n, i = 1, 0
        for a in axes:
            k = names.index(a)
            i, n = i * sizes[k] + coord[k], n * sizes[k]
        step = arr.shape[dim] // n
        index.append(slice(i * step, (i + 1) * step))
    return arr[tuple(index)]


def run(rank, port, ckpt, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    try:
        from repro_torch.checkpoint import Checkpointer
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import (build_model, model as model_mod,
                                        param_specs, reference_layout,
                                        sharding)
        from repro_torch.optim import value_and_grad
        from repro_torch.tree import leaves, leaves_with_path

        model_mod.embed = functools.partial(model_mod.embed,
                                            dtype=torch.float32)
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")

        def parity(arch):
            # the partitioned prefill, loss and gradients of reduced arch
            # in f32 against the same unpartitioned
            cfg = dataclasses.replace(get_config(arch).reduced(),
                                      attn_impl="chunked",
                                      mixer_impl="chunked")
            model = build_model(cfg)
            params = model.init(torch.Generator().manual_seed(0), "cpu")
            tokens = torch.from_numpy(np.random.default_rng(0).integers(
                0, cfg.vocab_size, (8, 32)))
            batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
            with torch.no_grad():
                want_logits = model.prefill_logits(params, batch)
            want_loss, want_grads = value_and_grad(model.loss, params, batch)

            placed = sharding.place_params(params, mesh)
            with sharding.use_mesh(mesh):
                dbatch = {k: sharding.distribute_tensor(
                    v, mesh, sharding.batch_spec(v.shape))
                    for k, v in batch.items()}
            with sharding.partitioned(mesh):
                with torch.no_grad():
                    logits = model.prefill_logits(placed, dbatch)
                loss, grads = value_and_grad(model.loss, placed, dbatch)
            return {
                "placements": [str(p) for p in logits.placements],
                "logits": float((logits.full_tensor() - want_logits).abs()
                                .max() / want_logits.abs().max()),
                "loss": float(abs(loss.full_tensor() - want_loss)
                              / want_loss),
                "grads": max(float((g.full_tensor() - w).abs().max()
                                   / w.abs().max())
                             for g, w in zip(leaves(grads),
                                             leaves(want_grads))),
                "dtensor_grads": all(type(g).__name__ == "DTensor"
                                     for g in leaves(grads))}

        from repro_torch.models import attention
        attention.init_kv_cache = functools.partial(attention.init_kv_cache,
                                                    dtype=torch.float32)

        def decode_parity(arch, **changes):
            # one partitioned decode step of reduced arch in f32 (its KV
            # ring too), from a cache two plain steps advanced, against the
            # same step unpartitioned: logits and every leaf of the
            # advanced cache
            cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
            model = build_model(cfg)
            params = model.init(torch.Generator().manual_seed(1), "cpu")
            tokens = torch.from_numpy(np.random.default_rng(1).integers(
                0, cfg.vocab_size, (3, 8, 1)))
            with torch.no_grad():
                cache = model.init_cache(8, 32, device="cpu")
                for t in tokens[:2]:
                    _, cache = model.decode_step(params, t, cache)
                want, want_cache = model.decode_step(params, tokens[2],
                                                     cache)
                placed = sharding.place_cache(cache, mesh)
                with sharding.use_mesh(mesh):
                    dtokens = sharding.distribute_tensor(
                        tokens[2], mesh, sharding.batch_spec((8, 1)))
                with sharding.partitioned(mesh):
                    logits, new = model.decode_step(
                        sharding.place_params(params, mesh), dtokens,
                        placed)
            v = cfg.vocab_size
            got = [(path[0], a, b, c) for (path, a), (_, b), (_, c) in zip(
                leaves_with_path(new), leaves_with_path(want_cache),
                leaves_with_path(placed)) if isinstance(b, torch.Tensor)]
            return {
                "logits": float((logits.full_tensor()[:, :v] - want[:, :v])
                                .abs().max() / want[:, :v].abs().max()),
                "cache": max(float((a.full_tensor() - b).abs().max()
                                   / b.abs().max()) for _, a, b, _ in got),
                "leaves": len(got),
                # the Mamba-2 and mLSTM states (the sLSTM's comes back
                # whole over model, which re-places with no collective)
                "placed": all(list(a.placements) == list(c.placements)
                              for key, a, _, c in got
                              if key in ("super", "tail", "mlstm"))}

        result = parity("qwen3-0.6b")
        result["moe"] = parity("phi3.5-moe-42b-a6.6b")
        result["xlstm"] = parity("xlstm-1.3b")
        # the states over model on their heads, as the reduced configs
        # place them; with one head, on the dim after it (the mLSTM's
        # keys, the SSM's state dim), where the read-out is a partial sum
        result["decode"] = {
            "zamba2-7b": decode_parity("zamba2-7b"),
            "xlstm-1.3b": decode_parity("xlstm-1.3b"),
            "zamba2-7b one head": decode_parity("zamba2-7b",
                                                ssm_head_dim=128),
            "xlstm-1.3b one head": decode_parity("xlstm-1.3b",
                                                 num_heads=1)}
        cfg = get_config("qwen3-0.6b").reduced()
        params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                       "cpu")

        # pad_rows on a 1-D mesh of the 4 ranks: 12 rows in shards of 3
        # become 20 in shards of 5, rank 1's from three ranks
        from torch.distributed.device_mesh import DeviceMesh
        line = DeviceMesh("cpu", list(range(4)), mesh_dim_names=("model",))
        rows = torch.arange(36.0).reshape(12, 3)
        weight = torch.arange(60.0).reshape(20, 3)
        sharded = sharding.distribute_tensor(rows, line, ("model",
                                                          None))
        sharded.requires_grad_()
        padded = sharding.pad_rows(sharded, 20)
        (padded * sharding.distribute_tensor(weight, line, ("model", None))
         ).sum().backward()
        result["pad_rows"] = bool(
            torch.equal(padded.full_tensor(),
                        torch.cat([rows, torch.zeros(8, 3)]))
            and torch.equal(sharded.grad.full_tensor(), weight[:12])
            and padded.to_local().shape == (5, 3))

        template = reference_layout(params)
        with sharding.use_mesh(mesh):
            specs = param_specs(template)
            step, restored = Checkpointer(ckpt).restore(template,
                                                        shardings=specs)
        with np.load(os.path.join(ckpt, f"ckpt_{step:010d}.npz")) as data:
            saved = {k: data[k] for k in data.files}
        coord = mesh.get_coordinate()
        names, sizes = list(mesh.mesh_dim_names), list(mesh.shape)
        equal, sharded = [], 0
        for path, leaf in leaves_with_path(restored):
            spec = specs
            for key in path:
                spec = spec[key]
            want = slice_of(saved["##".join(map(str, path))], spec, coord,
                            names, sizes)
            equal.append(bool(np.array_equal(leaf.to_local().numpy(), want)))
            sharded += any(e is not None for e in spec)
        result.update(step=step, restored=len(equal), equal=all(equal),
                      sharded_leaves=sharded)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    port, ckpt, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    mp.spawn(run, args=(port, ckpt, out), nprocs=4, join=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The gloo workers' results: the reference's reduced qwen3-0.6b
    parameters saved at step 7 by its ``Checkpointer``, then the four
    ranks' partitioned forward, gradients and sharded restore."""
    root = tmp_path_factory.mktemp("four_ranks")
    ckpt, out = root / "ckpt", root / "out"
    out.mkdir()
    params = ref_build(ref_config("qwen3-0.6b").reduced()).init(
        jax.random.PRNGKey(3))
    RefCheckpointer(str(ckpt)).save(7, jax.tree.map(np.asarray, params))
    script = root / "worker.py"
    script.write_text(WORKER)
    run = subprocess.run([sys.executable, str(script), str(_free_port()),
                          str(ckpt), str(out)], env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(4)]


def test_partitioned_forward_and_gradients_equal_unpartitioned(four_ranks):
    for r in four_ranks:
        # last-position logits: batch over data, vocab over model
        assert r["placements"] == ["S(0)", "S(1)"]
        assert r["dtensor_grads"]
        assert r["logits"] <= 1e-5 and r["loss"] <= 1e-5
        assert r["grads"] <= 1e-5


def test_partitioned_moe_equals_unpartitioned(four_ranks):
    """phi3.5-moe: its experts over model, each rank scatter-adding only
    its own tokens' rows, with the slots and capacity drops of the whole
    batch."""
    for r in four_ranks:
        r = r["moe"]
        assert r["placements"] == ["S(0)", "S(1)"]
        assert r["dtensor_grads"]
        assert r["logits"] <= 1e-5 and r["loss"] <= 1e-5
        assert r["grads"] <= 1e-5


def test_partitioned_xlstm_equals_unpartitioned(four_ranks):
    """xlstm-1.3b on the chunked mLSTM and the sLSTM's time scan, which
    each rank runs on its own batch rows (its recurrent mixes' gradient a
    partial sum over the data axis)."""
    for r in four_ranks:
        r = r["xlstm"]
        assert r["placements"] == ["S(0)", "S(1)"]
        assert r["dtensor_grads"]
        assert r["logits"] <= 1e-5 and r["loss"] <= 1e-5
        assert r["grads"] <= 1e-5


@pytest.mark.parametrize("case", ["zamba2-7b", "xlstm-1.3b",
                                  "zamba2-7b one head",
                                  "xlstm-1.3b one head"])
def test_partitioned_decode_equals_unpartitioned(four_ranks, case):
    """One decode step of reduced zamba2-7b and xlstm-1.3b on the (2, 2)
    mesh: the Mamba-2 and mLSTM steps run where their kernels and caches
    lie, and the logits and every leaf of the advanced cache equal the
    unpartitioned step's, each leaf placed as the cache came in (so the
    dry run's out placements move no state). With one head the states
    split over model on the dim after the heads, and the read-out is a
    partial sum reduced once."""
    for r in four_ranks:
        r = r["decode"][case]
        assert r["leaves"] > 0 and r["placed"]
        assert r["logits"] <= 1e-5 and r["cache"] <= 1e-5


def test_padded_rows_come_from_the_ranks_that_hold_them(four_ranks):
    assert all(r["pad_rows"] for r in four_ranks)


def test_reference_checkpoint_restores_sharded_onto_four_ranks(four_ranks):
    for r in four_ranks:
        assert r["step"] == 7 and r["equal"]
        assert r["restored"] == four_ranks[0]["restored"] > 0
        assert r["sharded_leaves"] > 0


def test_counter_agrees_with_collective_bytes():
    hlo = "\n".join([
        "%ag = f32[8,16]{1,0} all-gather-start(f32[4,16]{1,0} %x), "
        "dimensions={0}",
        "%agd = f32[8,16]{1,0} all-gather-done(f32[8,16]{1,0} %ag)",
        "%rs = f32[8,8]{1,0} reduce-scatter(f32[8,16]{1,0} %y), "
        "dimensions={1}, to_apply=%add",
        "%ar = f32[8,16]{1,0} all-reduce-start(f32[8,16]{1,0} %z), "
        "to_apply=%add",
        "%ard = f32[8,16]{1,0} all-reduce-done(f32[8,16]{1,0} %ar)"])
    with fake_mesh(MeshLayout(("data", "model"), (2, 2))) as mesh:
        x = DTensor.from_local(torch.empty(4, 16), mesh,
                               [Shard(0), Replicate()])
        partial = DTensor.from_local(torch.empty(8, 16), mesh,
                                     [Replicate(), Partial()])
        with TraceCounter() as counter:
            x.redistribute(mesh, [Replicate(), Replicate()])      # gather
            partial.redistribute(mesh, [Replicate(), Shard(1)])   # scatter
            partial.redistribute(mesh, [Replicate(), Replicate()])
    assert counter.collectives == ref_collective_bytes(hlo) == {
        "all-gather": 512.0, "reduce-scatter": 256.0, "all-reduce": 512.0}


def test_counter_books_a_shard_to_shard_redistribution_as_an_all_to_all():
    """DTensor issues Shard(0) -> Shard(1) as an all-gather and a chunk on
    a CPU mesh: booked as the all-to-all GSPMD would issue, of the bytes it
    returns, and split by what issued it."""
    hlo = ("%a2a = f32[8,8]{1,0} all-to-all(f32[8,8]{1,0} %x), "
           "dimensions={1}")
    with fake_mesh(MeshLayout(("data", "model"), (2, 2))) as mesh:
        x = DTensor.from_local(torch.empty(4, 16), mesh,
                               [Replicate(), Shard(0)])
        with TraceCounter() as counter:
            x.redistribute(mesh, [Replicate(), Shard(1)])
    assert counter.collectives == ref_collective_bytes(hlo) == {
        "all-to-all": 256.0}
    assert counter.by_op == {("all-to-all", "redistribute"): 256.0}


def test_unembedding_pads_the_table_without_gathering_it(small_cells):
    """A qwen3-0.6b step on the (2, 2, 2) mesh: the tied table (256 rows,
    vocab over model) padded to 2048 rows moves only the 128 rows that
    its padded shards take from the other rank, as GSPMD's pad moves
    them, where it was gathered whole; the bytes by op add up to the
    bytes by kind."""
    table = 256 * 64 * 4
    for shape in ("train_4k", "decode_32k"):
        got = dryrun.run_cell("qwen3-0.6b", shape, "multi", verbose=False)
        by_op = {(kind, op): nbytes for kind, op, nbytes
                 in got["coll_by_op"]}
        gathered = sum(nbytes for (kind, op), nbytes in by_op.items()
                       if kind == "all-gather" and "unembed" in op)
        assert gathered < table, by_op
        moved = [nbytes for (kind, op), nbytes in by_op.items()
                 if op.endswith("unembed pad_rows")]
        assert moved == [table / 2], by_op
        for kind, total in got["coll_breakdown"].items():
            assert sum(nbytes for (k, _), nbytes in by_op.items()
                       if k == kind) == total


def test_counter_tracks_live_bytes_and_flops():
    counter = TraceCounter()
    a = torch.empty(64, 32, device=META)
    counter.hold([a, a[1:]])                 # one storage, held once
    with counter:
        b = a @ torch.empty(32, 16, device=META)
        del b
        c = a.t()                            # a view: no new storage
    assert counter.flops == 2 * 64 * 32 * 16
    assert counter.peak_bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert counter.live_bytes == 64 * 32 * 4
    assert counter.collectives == {}
    del c


SMALL = {"train_4k": ShapeConfig("train_4k", T, B, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", T, B, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", T, B, "decode")}


@pytest.fixture
def small_cells(monkeypatch):
    """``run_cell`` on reduced configs at B 8, T 32, with ``multi`` the
    (2, 2, 2) mesh of the reference's small dry run."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).reduced())
    monkeypatch.setattr(dryrun, "SHAPES", SMALL)
    layout = dryrun.layout_for
    monkeypatch.setattr(dryrun, "layout_for", lambda m: CUBE
                        if m == "multi" else layout(m))
    yield
    sharding.set_fsdp(False)


@pytest.mark.parametrize("arch", FAMILIES)
def test_small_mesh_dry_run_moves_collective_bytes(small_cells, arch):
    for shape in ("train_4k", "decode_32k"):
        got = dryrun.run_cell(arch, shape, "multi", verbose=False)
        assert not dist.is_initialized()
        assert got["status"] == "ok" and got["chips"] == 8
        assert got["coll_bytes_per_dev"] == sum(
            got["coll_breakdown"].values()) > 0
        assert got["coll_source"] == dryrun.COLL_SOURCES["partitioned"]
        assert got["hbm_per_dev"] >= got["state_bytes_per_dev"] > 0
        assert got["t_collective"] > 0 and got["traced_flops"] > 0
    card = dryrun.run_cell(arch, "train_4k", "card", verbose=False)
    assert (card["coll_bytes_per_dev"], card["coll_breakdown"],
            card["coll_source"]) == (0.0, {}, dryrun.COLL_SOURCES["card"])
    assert card["hbm_per_dev"] >= card["state_bytes_per_dev"]


SQUARE = MeshLayout(("data", "model"), (16, 16))


def _reference_state(arch):
    """The reference's per-device bytes of reduced ``arch``'s parameters
    and of its B 8, T 32 decode cache, then of the cache's length counters
    (Python ints in the port), on the 16 x 16 mesh: its
    ``sharded_bytes`` arithmetic (``launch/dryrun.py``) over its specs,
    the parameters' and the cache's with the repairs
    (``_torch_rules.intended``, ``intended_cache``)."""
    model = ref_build(ref_config(arch).reduced())
    mesh = AbstractMesh(SQUARE.shape, SQUARE.mesh_dim_names,
                        axis_types=(AxisType.Auto,) * 2)
    sizes = dict(zip(SQUARE.mesh_dim_names, SQUARE.shape))

    def nbytes(structs, specs, counters=False):
        total = 0.0
        for (path, leaf), spec in zip(
                jax.tree_util.tree_leaves_with_path(structs),
                jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))):
            if (getattr(path[-1], "key", None) == "len") != counters:
                continue
            shards = math.prod(sizes[a] for e in spec if e is not None
                               for a in (e if isinstance(e, tuple)
                                         else (e,)))
            total += math.prod(leaf.shape) * leaf.dtype.itemsize / shards
        return total

    with jax.sharding.use_abstract_mesh(mesh):
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        cache = jax.eval_shape(lambda: model.init_cache(B, T))
        c_specs = intended_cache(cache, ref_cache_specs(cache))
        return (nbytes(params, intended(params, ref_param_specs(params))),
                nbytes(cache, c_specs), nbytes(cache, c_specs, True))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_smaller_than_the_data_axis_traces(small_cells, arch):
    """B 8 on a data axis of 16: the rules drop the axis from the batch,
    and no product shards its folded rows where it cannot unfold them."""
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        got = dryrun.run_cell(arch, shape, "single", verbose=False)
        assert got["status"] == "ok" and got["chips"] == 256, shape
        assert got["coll_bytes_per_dev"] == sum(
            got["coll_breakdown"].values())
        assert got["hbm_per_dev"] >= got["state_bytes_per_dev"] > 0
    model = build_model(get_config(arch).reduced())
    params = model.init(torch.Generator().manual_seed(0), META)
    cache = model.init_cache(B, T, device=META)
    with fake_mesh(SQUARE) as mesh:
        placed = [sharding.place_params(params, mesh),
                  sharding.place_cache(cache, mesh)]
    local = [sum(math.prod(leaf.to_local().shape) * leaf.element_size()
                 for _, leaf in leaves_with_path(tree)
                 if isinstance(leaf, DTensor)) for tree in placed]
    *want, counters = _reference_state(arch)
    assert local == want
    assert got["state_bytes_per_dev"] == sum(want) + counters   # decode's


def test_no_group_outlives_a_fake_mesh_and_none_starts_over_a_live_one():
    with pytest.raises(KeyError):
        with fake_mesh(CUBE):
            assert dist.get_world_size() == 8
            raise KeyError("inside")
    assert not dist.is_initialized()
    try:
        make_mesh((1, 1), ("data", "model"), device_type="cpu")
        with pytest.raises(RuntimeError, match="process group is live"):
            with fake_mesh(CUBE):
                pass
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


def test_shard_constrains_under_a_mesh_and_pins_the_gradient():
    x = torch.ones(8, 4)
    assert sharding.shard(x, ("pod", "data"), "model") is x
    with fake_mesh(MeshLayout(("data", "model"), (2, 2))) as mesh:
        d = sharding.distribute_tensor(torch.ones(8, 4), mesh, ("data", None))
        assert sharding.shard(d, ("pod", "data"), "model") is d  # no mesh
        with sharding.partitioned(mesh):
            y = sharding.shard(d.detach().requires_grad_(),
                               ("pod", "data"), "model")
            assert y.placements == (Shard(0), Shard(1))
            z = sharding.shard(y, None, None)      # to replicated
            assert z.placements == (Replicate(), Replicate())
            # 3 does not divide 4: the axis is dropped, as the rules do
            odd = sharding.distribute_tensor(torch.ones(3, 4), mesh,
                                             (None, None))
            assert sharding.shard(odd, "data", None).placements == \
                (Replicate(), Replicate())
            assert sharding.replicated(y).placements == \
                (Replicate(), Replicate())
            heads = sharding.unflatten(sharding.distribute_tensor(
                torch.ones(8, 6), mesh, (None, "model")), -1, (3, 2))
            assert tuple(heads.shape) == (8, 3, 2)


def _dtensor_inputs(name):
    f = torch.float32
    rays = [torch.rand(16) for _ in range(3)]
    return {
        "taylor_sin": (kernels.taylor_sin, [torch.rand(16)]),
        "gaussian_blur_halo": (kernels.gaussian_blur_halo,
                               [torch.rand(8, 8)]),
        "matmul": (kernels.matmul, [torch.rand(4, 4), torch.rand(4, 4)]),
        "mandelbrot": (kernels.mandelbrot, [torch.rand(16), torch.rand(16)]),
        "raytrace": (kernels.raytrace,
                     [*rays, torch.from_numpy(kernels.demo_spheres())]),
        "rap": (kernels.rap, [torch.rand(4, 8),
                              torch.full((4,), 3, dtype=torch.int32)]),
        "flash_attention": (kernels.flash_attention,
                            [torch.rand(1, 2, 8, 4, dtype=f)] * 3),
        "linear_attention": (kernels.linear_attention,
                             [torch.rand(2, 8, 4)] * 3
                             + [-torch.rand(2, 8)]),
    }[name]


@pytest.mark.parametrize("name", [
    "taylor_sin", "gaussian_blur_halo", "matmul", "mandelbrot", "raytrace",
    "rap", "flash_attention", "linear_attention"])
def test_hand_kernels_refuse_a_dtensor(name):
    wrapper, inputs = _dtensor_inputs(name)
    wrapper(*inputs)                        # the plain version on the CPU
    with fake_mesh(MeshLayout(("data", "model"), (1, 2))) as mesh:
        dinputs = [sharding.distribute_tensor(t, mesh, (None,) * t.dim())
                   for t in inputs]
        with pytest.raises(ValueError, match=f"{name}: .*not a DTensor"):
            wrapper(*dinputs)


def test_partitioned_prefill_refuses_the_flash_kernel():
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              attn_impl="flash")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), META)
    with fake_mesh(MeshLayout(("data", "model"), (2, 2))) as mesh:
        placed = sharding.place_params(params, mesh)
        tokens = sharding.distribute_tensor(
            torch.zeros(B, T, dtype=torch.int64, device=META), mesh,
            ("data", None))
        with sharding.partitioned(mesh), torch.no_grad():
            with pytest.raises(ValueError, match="flash_attention: "):
                model.prefill_logits(placed, {"tokens": tokens})


class _DTensorOps(TorchDispatchMode):
    """The names of the aten ops that reach a DTensor (the mode steps aside
    for DTensor to run each, as ``TraceCounter`` does)."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            self.ops.add(func._overloadpacket.__name__)
            return NotImplemented
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b"])
def test_partitioned_training_sends_no_flip_to_a_dtensor(arch):
    """One partitioned training step (loss and backward) of reduced
    ``arch`` on the (2, 2, 2) mesh, as the dry run takes it (chunked
    attention and mixers, remat): torch 2.11's DTensor has no sharding
    strategy for ``aten.flip``, which ``cumsum``'s backward runs, so none
    may reach a DTensor, while the chunked forms' prefix sums do."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              attn_impl="chunked", mixer_impl="chunked",
                              remat=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), META)
    tokens = torch.zeros(B, T, dtype=torch.int64, device=META)
    recorded = _DTensorOps()
    with fake_mesh(CUBE) as mesh:
        placed = sharding.place_params(params, mesh)
        with sharding.use_mesh(mesh):
            batch = {k: sharding.distribute_tensor(
                tokens, mesh, sharding.batch_spec(tokens.shape))
                for k in ("tokens", "labels")}
        with sharding.partitioned(mesh), recorded:
            value_and_grad(model.loss, placed, batch)
    assert "cumsum" in recorded.ops
    assert "flip" not in recorded.ops


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b"])
def test_prefix_sum_is_cumsum_in_value_and_gradient(arch):
    """At the chunk both mixers' chunked form takes (the default of
    ``chunked_linear_attention``), over log decays of the arch's head
    count: the value is ``cumsum``'s bit for bit, the f64 gradient within
    1e-12 of ``cumsum``'s."""
    chunk = inspect.signature(
        chunked_linear_attention).parameters["chunk"].default
    heads = get_config(arch).num_heads
    rng = np.random.default_rng(5)
    ld = torch.from_numpy(-rng.exponential(0.5, (heads, chunk)))
    g = torch.from_numpy(rng.standard_normal((heads, chunk)))
    x = ld.clone().requires_grad_()
    want = torch.cumsum(x, dim=-1)
    (want_grad,) = torch.autograd.grad(want, x, g)
    y = ld.clone().requires_grad_()
    got = prefix_sum(y)
    (got_grad,) = torch.autograd.grad(got, y, g)
    assert got.dtype == torch.float64
    assert torch.equal(got, want)
    assert float((got_grad - want_grad).abs().max()) <= 1e-12


def test_moe_gathers_no_token_rows(small_cells):
    """Reduced phi3.5-moe train_4k on the (2, 2, 2) mesh: each rank
    scatter-adds the (token, k) pairs of its own tokens into the expert
    rows it holds, a partial sum over the batch axes all-reduced, so no
    token row is gathered on the way into or out of the experts: the
    all-gathers booked to ``moe_layer`` come to less than the (N * k, d)
    token rows a layer and microbatch (a quarter of their bytes here: a
    rank's tokens' features gathered over model, as the reference pins
    them, and the route's indices over all N tokens). The cell's all-gathers
    come to at most GSPMD's 1,425,408 B on the same layout
    (``scripts/torch_partition_table.py``), where gathering the rows took
    4,327,424, and the all-reduce of the expert rows is of this rank's
    experts' rows alone."""
    arch = "phi3.5-moe-42b-a6.6b"
    got = dryrun.run_cell(arch, "train_4k", "multi", verbose=False)
    by_op = {(kind, op): nbytes for kind, op, nbytes in got["coll_by_op"]}
    cfg = get_config(arch).reduced()
    accum = dryrun.GRAD_ACCUM[(arch, "train_4k")]
    tokens = B // accum * T
    gathered = sum(nbytes for (kind, op), nbytes in by_op.items()
                   if kind == "all-gather" and "moe_layer" in op)
    assert gathered / (cfg.num_layers * accum) < \
        tokens * cfg.top_k * cfg.d_model * 2
    assert got["coll_breakdown"]["all-gather"] <= 1_425_408
    capacity = int(cfg.capacity_factor * tokens * cfg.top_k
                   / cfg.num_experts)
    rows = cfg.num_experts // CUBE.shape[-1] * capacity * cfg.d_model * 2
    assert by_op[("all-reduce", "block moe_layer shard")] == \
        cfg.num_layers * accum * rows                       # bf16 rows


@pytest.mark.parametrize("arch,block", [("zamba2-7b", "mamba2_decode"),
                                        ("xlstm-1.3b", "mlstm_decode")])
def test_decode_gathers_no_model_split_kernel(small_cells, arch, block):
    """Reduced decode_32k on the (2, 2, 2) mesh: the Mamba-2 and mLSTM
    steps multiply on their kernels' placements (the token rows over the
    batch axes only, partial products reduced once), so no all-gather is
    booked to their products, where gathering the superblocks' model-split
    kernels took 217,088 B (zamba2-7b) and 299,008 B (xlstm-1.3b); and the
    advanced caches are formed where they lie, so the out placements
    redistribute no state. zamba2-7b's total stays within 1.5x of GSPMD's
    144,108 B on the same layout (``scripts/torch_partition_table.py``),
    where it was 405,120 B."""
    got = dryrun.run_cell(arch, "decode_32k", "multi", verbose=False)
    by_op = {(kind, op): nbytes for kind, op, nbytes in got["coll_by_op"]}
    gathered = {op: nbytes for (kind, op), nbytes in by_op.items()
                if kind == "all-gather" and f"{block} dense" in op}
    assert gathered == {}, by_op
    assert not any(op == "redistribute" and kind != "all-gather"
                   for kind, op in by_op), by_op
    if arch == "zamba2-7b":
        assert got["coll_bytes_per_dev"] <= 1.5 * 144_108


@pytest.mark.parametrize("arch,key", [("zamba2-7b", "super"),
                                      ("xlstm-1.3b", "mlstm")])
def test_twice_stacked_caches_split_batch_and_heads(arch, key):
    """B 8 on the (2, 2, 2) mesh: each (B, H, ...) state of a block inside
    a superblock has the batch over pod and data and the heads (or the
    conv buffer's channels) over model, so a rank holds 1/8 of it, where
    the reference's rule (model on the batch) holds 1/2."""
    model = build_model(get_config(arch).reduced())
    cache = model.init_cache(B, T, device=META)
    with fake_mesh(CUBE) as mesh:
        placed = sharding.place_cache(cache, mesh)
    states = leaves_with_path(placed[key])
    assert states
    for path, leaf in states:
        assert leaf.to_local().shape[0] == B // 4, path
        assert leaf.to_local().numel() * 8 == leaf.numel(), path


def test_decode_cell_records_its_placed_cache_by_leaf(small_cells):
    """Reduced zamba2-7b decode on the (2, 2, 2) mesh: the cell's record
    holds each cache leaf's bytes, in all and on rank 0, as ``place_cache``
    put them there: 1/8 of each, the superblocks' Mamba-2 states
    included (the length counters are Python ints, no leaf)."""
    got = dryrun.run_cell("zamba2-7b", "decode_32k", "multi", verbose=False)
    cache = build_model(get_config("zamba2-7b").reduced()).init_cache(
        B, T, device=META)
    by_leaf = got["cache_bytes_by_leaf"]
    assert set(by_leaf) == {"/".join(str(k) for k in path
                                     if not isinstance(k, int))
                            for path, leaf in leaves_with_path(cache)
                            if isinstance(leaf, torch.Tensor)}
    assert "super/state" in by_leaf
    for whole, dev in by_leaf.values():
        assert whole == 8 * dev > 0
