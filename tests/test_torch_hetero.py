"""Step-level co-execution in the port: quantization, the step cache, the
rebalance policies and the monitor held to the reference exactly (they are
pure Python in both packages), then the port's ``HeteroTrainer`` under the
reference's own trainer tests and beside the reference's trainer, on the
CPU.

Tolerances: assignments, shares, ``rebalanced`` flags, straggler lists
and compilation counts exactly; the two trainers' losses, in f32 (both
packages' ``embed`` f32) from the same parameters under the static
policy, within rtol 1e-5 over three steps (another order of f32 sums in
the forward and backward passes). Step times are taken on a counting
clock (one unit per microbatch gradient, ``counting_clock``) where a test
reads them: the wall clock's ratios are noise under parallel workers.
"""
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.hetero.trainer as ref_trainer_mod
import repro.models.model as ref_model_mod
import repro_torch.hetero.trainer as trainer_mod
import repro_torch.models.model as model_mod
from repro.configs import get_config as ref_config
from repro.data import DataPipeline as RefPipeline
from repro.hetero import ExecutableCache as RefCache
from repro.hetero import GroupMonitor as RefMonitor
from repro.hetero import HeteroTrainer as RefTrainer
from repro.hetero import make_policy as ref_make_policy
from repro.hetero import quantize_shares as ref_quantize
from repro.models import build_model as ref_build
from repro.optim import AdamW as RefAdamW
from repro_torch.configs import get_config
from repro_torch.data import DataPipeline
from repro_torch.hetero import (DynamicPolicy, ExecutableCache,
                                GroupMonitor, HeteroTrainer, HGuidedPolicy,
                                StaticPolicy, make_policy, quantize_shares)
from repro_torch.models import build_model, params_from_numpy
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


# -- quantization and the step cache ------------------------------------------

@pytest.mark.parametrize("seed", range(12))
def test_quantize_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n = int(rng.integers(1, 7))
        total = int(rng.integers(n, 65))
        raw = rng.random(n) + rng.choice([0.0, 0.01, 1.0])
        shares = {f"g{i}": float(v / raw.sum()) for i, v in enumerate(raw)}
        got = quantize_shares(shares, total)
        assert got == ref_quantize(shares, total)
        assert list(got) == list(ref_quantize(shares, total))
        assert sum(got.values()) == total and min(got.values()) >= 1


def test_quantize_rejects_what_the_reference_rejects():
    for shares, total in (({"a": 0.5, "b": 0.5}, 1), ({}, 4)):
        try:
            want = ref_quantize(shares, total)
        except ValueError:
            with pytest.raises(ValueError):
                quantize_shares(shares, total)
        else:
            assert quantize_shares(shares, total) == want


def test_step_cache_counts_as_the_reference_does():
    seq = [{"A": 4, "B": 4}, {"B": 4, "A": 4}, {"A": 5, "B": 3},
           {"A": 4, "B": 4}, {"A": 8}, {"A": 5, "B": 3}]
    ours, ref = ExecutableCache(lambda k: k), RefCache(lambda k: k)
    for a in seq:
        assert ours.get(a) == ref.get(a)
        assert ours.compilations == ref.compilations
        assert len(ours) == len(ref)
    assert ours.compilations == 3


# -- policies -----------------------------------------------------------------

def _measured(rng, names):
    raw = rng.random(len(names)) + 0.05
    return {n: float(v / raw.sum()) for n, v in zip(names, raw)}


@pytest.mark.parametrize("name", ["static", "dynamic", "dyn5", "dyn200",
                                  "hguided"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policies_decide_as_the_reference(name, seed):
    """The same hints and measurements give the same shares and flags,
    through an elastic drop and add."""
    rng = np.random.default_rng(seed)
    hints = {"a": 1.0, "b": float(rng.random() + 0.1), "c": 2.0}
    kw = dict(total_steps=40, period=3, min_share=0.05)
    ours, ref = make_policy(name, hints, **kw), ref_make_policy(name, hints,
                                                                **kw)
    assert type(ours).__name__ == type(ref).__name__
    assert ours.name == ref.name
    names = list(hints)
    for step in range(40):
        if step == 15:
            ours.drop_group("c")
            ref.drop_group("c")
            names = ["a", "b"]
        if step == 30:
            ours.add_group("d", 0.25)
            ref.add_group("d", 0.25)
            names = ["a", "b", "d"]
        m = _measured(rng, names) if step % 7 else {}
        assert ours.update(step, m) == ref.update(step, m)
        assert ours.shares == ref.shares


@pytest.mark.parametrize("cls,name,kw", [
    (StaticPolicy, "static", {}),
    (DynamicPolicy, "dynamic", {"period": 5}),
    (HGuidedPolicy, "hguided", {"total_steps": 100, "min_share": 0.05})])
def test_policy_edges_as_the_reference(cls, name, kw):
    """A dead measurement (all zeros) between live ones, off-period steps
    and the HGuided floor decide as the reference's policies decide."""
    hints = {"fast": 1.0, "slow": 1.0}
    ours, ref = cls(hints, **kw), ref_make_policy(name, hints, **kw)
    for s in range(100):
        m = {"fast": 0.97, "slow": 0.03} if s % 2 else \
            {"fast": 0.0, "slow": 0.0}
        assert ours.update(s, m) == ref.update(s, m)
        assert ours.shares == ref.shares
    with pytest.raises(KeyError):
        make_policy("nope", hints)


# -- monitor ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_monitor_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    names = ["a", "b", "c", "d"]
    ours = GroupMonitor(names, halflife=3.0, straggler_factor=0.6)
    ref = RefMonitor(names, halflife=3.0, straggler_factor=0.6)
    fallback = {"a": 2.0, "b": 1.0}
    assert ours.shares(fallback) == ref.shares(fallback)
    for step in range(30):
        for n in names:
            if n == "d" and step < 5:
                continue
            tokens = float(rng.integers(100, 2000))
            seconds = float(rng.random() * (4.0 if n == "c" else 1.0))
            ours.record(n, tokens, seconds)
            ref.record(n, tokens, seconds)
        if step == 12:
            ours.mark_dead("b")
            ref.mark_dead("b")
        if step == 20:
            ours.revive("b")
            ref.revive("b")
        assert ours.alive() == ref.alive()
        assert ours.throughputs() == ref.throughputs()
        assert ours.shares(fallback) == ref.shares(fallback)
        assert ours.stragglers() == ref.stragglers()
        assert ours.stragglers(warmup=10) == ref.stragglers(warmup=10)


def test_monitor_straggler_detection():
    m = GroupMonitor(["a", "b", "c"], straggler_factor=0.6)
    for _ in range(5):
        m.record("a", 1000, 1.0)
        m.record("b", 1000, 1.05)
        m.record("c", 1000, 4.0)     # 4x slower
    assert m.stragglers() == ["c"]
    m.mark_dead("c")
    assert set(m.alive()) == {"a", "b"}


# -- the trainer: the reference's tests, on the port --------------------------

def make_trainer(policy_name="hguided", speeds=None, steps=20):
    cfg = get_config("qwen3-0.6b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), CPU)
    pipe = DataPipeline(seed=5, global_batch=8, seq_len=16,
                        vocab=cfg.vocab_size, num_shards=8)
    speeds = speeds or {"A": 1.0, "B": 0.5}
    policy = make_policy(policy_name, {k: 1.0 for k in speeds},
                         total_steps=steps)
    return HeteroTrainer(model, params, optimizer=AdamW(lr=1e-3),
                         policy=policy, pipeline=pipe,
                         group_speeds=speeds, total_microbatches=8)


def test_trainer_loss_decreases():
    tr = make_trainer()
    reports = tr.run(15)
    assert reports[-1].loss < reports[0].loss
    assert all(sum(r.assignment.values()) == 8 for r in reports)


def test_hguided_assignment_tracks_speeds():
    tr = make_trainer("hguided", {"A": 1.0, "B": 0.25}, steps=25)
    tr.run(25)
    a = tr.history[-1].assignment
    assert a["A"] > a["B"]            # 4x speed ⇒ more microbatches
    assert a["A"] + a["B"] == 8


def test_gradients_invariant_to_policy():
    """Assignments move *where* microbatches run, never their content or
    the order their gradients are summed in: the loss trajectories (and
    the parameters) are the same bits under every policy."""
    t1 = make_trainer("static")
    t2 = make_trainer("hguided")
    l1 = [r.loss for r in t1.run(5)]
    l2 = [r.loss for r in t2.run(5)]
    assert l1 == l2
    assert [r.assignment for r in t1.history] != \
        [r.assignment for r in t2.history]
    for a, b in zip(jax.tree.leaves(t1.params), jax.tree.leaves(t2.params)):
        assert torch.equal(a, b)


def counting_clock(monkeypatch, trainer, module) -> None:
    """Time ``trainer`` (of the trainer ``module``) on a clock that
    advances one unit per microbatch gradient, in place of the host's
    ``perf_counter``: a group's virtual seconds are then its microbatches
    over its speed, whatever else the host runs."""
    now = [0.0]
    grad_fn = trainer._grad_fn

    def counted(*args, **kwargs):
        now[0] += 1.0
        return grad_fn(*args, **kwargs)

    trainer._grad_fn = counted
    monkeypatch.setattr(module, "time", types.SimpleNamespace(
        perf_counter=lambda: now[0]))


def test_step_time_improves_under_hguided(monkeypatch):
    """Rebalancing shortens the barrier: on the counting clock (the wall
    clock's ratio is noise under parallel test workers), the mean of the
    last three steps is under 0.9 x that of steps 1-3."""
    tr = make_trainer("hguided", {"A": 1.0, "B": 0.2}, steps=30)
    counting_clock(monkeypatch, tr, trainer_mod)
    reports = tr.run(30)
    first = np.mean([r.step_seconds for r in reports[1:4]])
    last = np.mean([r.step_seconds for r in reports[-3:]])
    assert last < first * 0.9         # rebalancing shortened the barrier


def test_step_time_assignments_equal_the_reference_trainers(monkeypatch):
    """Both trainers under hguided on the counting clock: the same
    assignments, rebalance flags and virtual step times, step for step."""
    speeds = {"A": 1.0, "B": 0.2}
    ours = make_trainer("hguided", speeds, steps=30)
    ref_cfg = ref_config("qwen3-0.6b").reduced()
    ref_model = ref_build(ref_cfg)
    ref = RefTrainer(ref_model, ref_model.init(jax.random.PRNGKey(0)),
                     optimizer=RefAdamW(lr=1e-3),
                     policy=ref_make_policy("hguided",
                                            {k: 1.0 for k in speeds},
                                            total_steps=30),
                     pipeline=RefPipeline(seed=5, global_batch=8, seq_len=16,
                                          vocab=ref_cfg.vocab_size,
                                          num_shards=8),
                     group_speeds=speeds, total_microbatches=8)
    counting_clock(monkeypatch, ours, trainer_mod)
    counting_clock(monkeypatch, ref, ref_trainer_mod)
    got, want = ours.run(30), ref.run(30)
    assert [r.assignment for r in got] == [r.assignment for r in want]
    assert [r.rebalanced for r in got] == [r.rebalanced for r in want]
    assert [r.step_seconds for r in got] == [r.step_seconds for r in want]
    assert len({tuple(r.assignment.values()) for r in got}) > 1


def test_kill_group_redistributes():
    tr = make_trainer("hguided", {"A": 1.0, "B": 1.0, "C": 1.0})
    tr.run(3)
    tr.kill_group("C")
    rep = tr.train_step()
    assert "C" not in rep.assignment
    assert sum(rep.assignment.values()) == 8


def test_optimizer_step_holds_only_the_gradient_sum():
    """Only the sum of the step's gradients reaches the optimizer step:
    the trees of the microbatches after the first (the first becomes the
    sum) are freed once added, or a step would hold one more copy of the
    parameters."""
    import weakref

    tr = make_trainer("static", {"A": 1.0, "B": 0.5})
    refs = []
    grad_fn, apply = tr._grad_fn, tr._apply

    def tracked(batch):
        loss, grads = grad_fn(batch)
        refs.append(weakref.ref(grads["embed"]["table"]))
        return loss, grads

    def checked(grads):
        assert len(refs) == 8
        assert refs[0]() is not None            # the sum itself
        assert all(r() is None for r in refs[1:])
        return apply(grads)

    tr.exec_cache = ExecutableCache(lambda key: (tracked, checked))
    tr.train_step()


def test_group_clock_includes_the_step_and_counts_compilations():
    tr = make_trainer("static", {"A": 1.0, "B": 0.5})
    rep = tr.train_step()
    assert rep.step == 0 and tr.step == 1
    assert rep.group_seconds["B"] > 0 and rep.group_seconds["A"] > 0
    assert rep.step_seconds == max(rep.group_seconds.values())
    tr.run(2)
    assert tr.exec_cache.compilations == 1     # static: one assignment


# -- the trainer beside the reference's ---------------------------------------

@pytest.fixture
def f32_stream(monkeypatch):
    """Both packages' model builders embed tokens in f32."""
    monkeypatch.setattr(ref_model_mod, "embed", functools.partial(
        ref_model_mod.embed, dtype=jnp.float32))
    monkeypatch.setattr(model_mod, "embed", functools.partial(
        model_mod.embed, dtype=torch.float32))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi3.5-moe-42b-a6.6b"])
def test_trainer_matches_the_reference_trainer(f32_stream, arch):
    """Both trainers from the same parameters, the same pipeline and the
    static policy: the same assignments and compilation counts, losses
    within rtol 1e-5."""
    ref_cfg = ref_config(arch).reduced()
    cfg = get_config(arch).reduced()
    ref_model = ref_build(ref_cfg)
    tree = ref_model.init(jax.random.PRNGKey(0))
    speeds = {"A": 1.0, "B": 0.5}
    kw = dict(seed=5, global_batch=4, seq_len=16, vocab=cfg.vocab_size,
              num_shards=4)
    ref = RefTrainer(ref_model, tree, optimizer=RefAdamW(lr=1e-3),
                     policy=ref_make_policy("static", {"A": 1.0, "B": 1.0}),
                     pipeline=RefPipeline(**kw), group_speeds=speeds,
                     total_microbatches=4)
    ours = HeteroTrainer(
        build_model(cfg),
        params_from_numpy(cfg, jax.tree.map(np.asarray, tree), device=CPU),
        optimizer=AdamW(lr=1e-3),
        policy=make_policy("static", {"A": 1.0, "B": 1.0}),
        pipeline=DataPipeline(**kw), group_speeds=speeds,
        total_microbatches=4)
    want, got = ref.run(3), ours.run(3)
    assert [r.assignment for r in got] == [r.assignment for r in want]
    assert [r.rebalanced for r in got] == [r.rebalanced for r in want]
    assert ours.exec_cache.compilations == ref.exec_cache.compilations
    np.testing.assert_allclose([r.loss for r in got],
                               [r.loss for r in want], rtol=1e-5)
