"""Fault tolerance and checkpoints in the port, on the CPU: the reference's
supervisor tests (and its end-to-end training test) on the port's trainer,
the checkpointer's files, keys and host copies, and checkpoints carried
across packages in both directions.

Tolerances: a crash replay equals the clean run bit for bit (the CPU's
arithmetic is deterministic, the pipeline replays the same batches and a
checkpoint restores the same bits); a checkpoint written by one package
restores into the other bit for bit, and the next steps' losses of the two
trainers agree within rtol 1e-5 in f32 (both packages' ``embed`` f32;
another order of f32 sums).
"""
import dataclasses
import functools
import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.model as ref_model_mod
import repro_torch.models.model as model_mod
from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import get_config as ref_config
from repro.data import DataPipeline as RefPipeline
from repro.hetero import HeteroTrainer as RefTrainer
from repro.hetero import make_policy as ref_make_policy
from repro.models import build_model as ref_build
from repro.optim import AdamW as RefAdamW
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.cluster import FailurePlan as ClusterFailurePlan
from repro_torch.data import DataPipeline
from repro_torch.ft import FailurePlan, InjectedFailure, Supervisor
from repro_torch.hetero import HeteroTrainer, make_policy
from repro_torch.models import build_model
from repro_torch.optim import AdamW

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests run many tiny eager ops, which
    more threads only slow down (and take the cores of the other test
    workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_trainer(speeds=None, mbs=4):
    # vlm backbone trained text-only (vision stub absent) for speed
    cfg = dataclasses.replace(get_config("internvl2-1b").reduced(),
                              vision_tokens=0, family="dense")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), CPU)
    pipe = DataPipeline(seed=11, global_batch=mbs, seq_len=16,
                        vocab=cfg.vocab_size, num_shards=mbs)
    speeds = speeds or {"A": 1.0, "B": 0.5}
    policy = make_policy("hguided", {k: 1.0 for k in speeds},
                         total_steps=30)
    return HeteroTrainer(model, params, optimizer=AdamW(lr=1e-3),
                         policy=policy, pipeline=pipe,
                         group_speeds=speeds, total_microbatches=mbs)


# -- the reference's supervisor tests, on the port ----------------------------

def test_failure_plan_is_the_cluster_tiers():
    assert FailurePlan is ClusterFailurePlan
    assert issubclass(InjectedFailure, RuntimeError)


def test_crash_restore_resumes_identical_trajectory():
    """A crash + restore replays to the same losses as a clean run, bit
    for bit: steps 3 and 4 are run again from the step-3 checkpoint."""
    with tempfile.TemporaryDirectory() as d:
        clean = Supervisor(make_trainer(), Checkpointer(d + "/clean"),
                           ckpt_every=3).run(10)
    with tempfile.TemporaryDirectory() as d:
        crashed = Supervisor(
            make_trainer(), Checkpointer(d + "/crash"), ckpt_every=3,
            failure_plan=FailurePlan(events={5: "crash"})).run(10)
    assert crashed.restarts == 1
    np.testing.assert_allclose(sorted(clean.losses)[-3:],
                               sorted(crashed.losses)[-3:], rtol=1e-5)
    assert crashed.steps_run == clean.steps_run == 10
    assert crashed.losses == clean.losses[:5] + clean.losses[3:]


def test_group_failure_elastic_continue():
    with tempfile.TemporaryDirectory() as d:
        tr = make_trainer({"A": 1.0, "B": 1.0, "C": 1.0})
        rep = Supervisor(tr, Checkpointer(d), ckpt_every=5,
                         failure_plan=FailurePlan(events={4: "kill:C"})
                         ).run(8)
    assert rep.groups_lost == ["C"]
    assert rep.steps_run == 8
    assert "C" not in tr.history[-1].assignment
    assert rep.restarts == 0          # no restart needed: elastic


def test_straggler_hook_fires():
    seen = []
    with tempfile.TemporaryDirectory() as d:
        tr = make_trainer({"A": 1.0, "B": 0.2})
        Supervisor(tr, Checkpointer(d), ckpt_every=10,
                   on_straggler=seen.append).run(6)
    assert seen == ["B"]


def test_checkpoint_cadence():
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=10)
        Supervisor(make_trainer(), ck, ckpt_every=2).run(7)
        assert ck.latest_step() is not None
        assert ck.latest_step() >= 6
        assert sorted(os.listdir(d)) == [
            f"ckpt_{s:010d}.npz" for s in (0, 2, 4, 6)] + ["latest"]


def test_e2e_training_learns():
    """The reference's ``test_system.py::test_e2e_training_learns``: the
    tiny LM on the synthetic topic distribution drops its loss by more
    than 0.5 from the random-init level."""
    cfg = get_config("qwen3-0.6b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), CPU)
    pipe = DataPipeline(seed=1, global_batch=8, seq_len=32,
                        vocab=cfg.vocab_size, num_shards=8)
    tr = HeteroTrainer(model, params, optimizer=AdamW(lr=3e-3),
                       policy=make_policy("hguided", {"A": 1.0, "B": 1.0},
                                          total_steps=40),
                       pipeline=pipe, group_speeds={"A": 1.0, "B": 0.7},
                       total_microbatches=8)
    reports = tr.run(40)
    first = np.mean([r.loss for r in reports[:3]])
    last = np.mean([r.loss for r in reports[-3:]])
    assert last < first - 0.5, (first, last)


# -- the checkpointer ---------------------------------------------------------

def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4)},
            "step": np.asarray(7, np.int32),
            "nested": {"m": [torch.ones(3), torch.zeros(2)]}}


def test_checkpoint_roundtrip_exact(tmp_path):
    tree = _tree()
    ck = Checkpointer(str(tmp_path))
    ck.save(7, tree)
    step, got = ck.restore(tree)
    assert step == 7
    assert np.array_equal(got["params"]["w"], tree["params"]["w"].numpy())
    assert got["step"].dtype == np.int32 and int(got["step"]) == 7
    assert [a.tolist() for a in got["nested"]["m"]] == [[1, 1, 1], [0, 0]]
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore({**tree, "params": {"w": torch.zeros(4, 3)}})


def test_checkpoint_async_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in range(5):
        ck.save_async(s, {"x": torch.full((4,), float(s))})
    ck.wait()
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert files == ["ckpt_0000000003.npz", "ckpt_0000000004.npz"]
    assert ck.latest_step() == 4
    _, got = ck.restore({"x": torch.zeros(4)})
    assert got["x"].tolist() == [4.0] * 4
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))


def test_save_async_copies_before_it_returns(tmp_path):
    """The host copy is taken on the caller's thread: an in-place update
    right after ``save_async`` (a CPU tensor's ``.numpy()`` would share
    its memory) does not reach the file."""
    params = {"w": torch.randn(1 << 20, generator=torch.Generator()
                               .manual_seed(0))}
    saved = params["w"].clone()
    opt = AdamW(lr=0.1)
    state = opt.init(params)
    ck = Checkpointer(str(tmp_path))
    ck.save_async(3, params)
    opt.update({"w": torch.ones_like(saved)}, state, params)
    ck.wait()
    _, got = ck.restore({"w": saved})
    assert np.array_equal(got["w"], saved.numpy())
    assert not torch.equal(params["w"], saved)


def test_restore_with_shardings_waits_for_the_mesh(tmp_path):
    """Specs are placed on the ``DeviceMesh`` in force; without one there
    is nothing to place them on."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding

    ck = Checkpointer(str(tmp_path))
    ck.save(0, {"x": torch.arange(4.0), "s": np.asarray(3, np.int32)})
    template = {"x": torch.zeros(4), "s": np.zeros((), np.int32)}
    specs = {"x": ("model",), "s": ()}
    with pytest.raises(ValueError, match="no DeviceMesh in force"):
        ck.restore(template, shardings=specs)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        with sharding.use_mesh(mesh):
            step, tree = ck.restore(template, shardings=specs)
        assert step == 0 and tree["x"].placements == (
            sharding.Replicate(), sharding.Shard(0))
        assert torch.equal(tree["x"].to_local(), torch.arange(4.0))
        assert int(tree["s"].to_local()) == 3
    finally:
        torch.distributed.destroy_process_group()
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({"x": torch.zeros(2)})


def test_keys_and_files_are_the_references(tmp_path):
    """The same tree saved by both packages gives the same keys, arrays
    and file names; each package restores the other's file."""
    tree = {"a": {"b": np.arange(6.0, dtype=np.float32).reshape(2, 3)},
            "c": [np.ones(2, np.float32), np.zeros((1, 2), np.int32)],
            "s": np.asarray(4, np.int32)}
    Checkpointer(str(tmp_path / "ours")).save(4, tree)
    RefCheckpointer(str(tmp_path / "ref")).save(
        4, jax.tree.map(jnp.asarray, tree))
    name = "ckpt_0000000004.npz"
    with np.load(tmp_path / "ours" / name) as a, \
            np.load(tmp_path / "ref" / name) as b:
        assert sorted(a.files) == sorted(b.files) == [
            "a##b", "c##0", "c##1", "s"]
        for k in a.files:
            assert np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
    _, got = Checkpointer(str(tmp_path / "ref")).restore(tree)
    _, want = RefCheckpointer(str(tmp_path / "ours")).restore(tree)
    for a, b, c in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                       jax.tree.leaves(tree)):
        assert np.array_equal(a, c) and np.array_equal(np.asarray(b), c)


# -- checkpoints across packages ----------------------------------------------

@pytest.fixture
def f32_stream(monkeypatch):
    """Both packages' model builders embed tokens in f32."""
    monkeypatch.setattr(ref_model_mod, "embed", functools.partial(
        ref_model_mod.embed, dtype=jnp.float32))
    monkeypatch.setattr(model_mod, "embed", functools.partial(
        model_mod.embed, dtype=torch.float32))


ARCH = "qwen3-0.6b"
PIPE = dict(seed=11, global_batch=4, seq_len=16, num_shards=4)


def _ref_trainer():
    cfg = ref_config(ARCH).reduced()
    model = ref_build(cfg)
    return RefTrainer(model, model.init(jax.random.PRNGKey(0)),
                      optimizer=RefAdamW(lr=1e-3),
                      policy=ref_make_policy("static", {"A": 1.0, "B": 1.0}),
                      pipeline=RefPipeline(vocab=cfg.vocab_size, **PIPE),
                      group_speeds={"A": 1.0, "B": 0.5},
                      total_microbatches=4)


def _trainer(seed=1):
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    return HeteroTrainer(model, model.init(torch.Generator().manual_seed(
        seed), CPU), optimizer=AdamW(lr=1e-3),
        policy=make_policy("static", {"A": 1.0, "B": 1.0}),
        pipeline=DataPipeline(vocab=cfg.vocab_size, **PIPE),
        group_speeds={"A": 1.0, "B": 0.5}, total_microbatches=4)


def _same_state(ours, ref_tree):
    for a, b in zip(jax.tree.leaves(ours.state_tree()),
                    jax.tree.leaves(ref_tree)):
        assert np.array_equal(a, np.asarray(b))


def test_reference_checkpoint_restores_into_the_port(f32_stream, tmp_path):
    ref = _ref_trainer()
    ref.run(2)
    RefCheckpointer(str(tmp_path)).save(ref.step, ref.state_tree())
    ours = _trainer()
    step, tree = Checkpointer(str(tmp_path)).restore(ours.state_tree())
    ours.load_state_tree(tree)
    assert step == ours.step == 2 and int(ours.opt_state.step) == 2
    _same_state(ours, ref.state_tree())
    want = [r.loss for r in ref.run(2)]
    got = [r.loss for r in ours.run(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_port_checkpoint_restores_into_the_reference(f32_stream, tmp_path):
    ours = _trainer()
    ours.run(2)
    ck = Checkpointer(str(tmp_path))
    ck.save_async(ours.step, ours.state_tree())
    ck.wait()
    ref = _ref_trainer()
    step, tree = RefCheckpointer(str(tmp_path)).restore(ref.state_tree())
    ref.load_state_tree(tree)
    assert step == ref.step == 2 and int(ref.opt_state.step) == 2
    _same_state(ours, ref.state_tree())
    want = [r.loss for r in ref.run(2)]
    got = [r.loss for r in ours.run(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
