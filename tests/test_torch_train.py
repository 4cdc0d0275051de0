"""The port's training substrate against the reference, on the CPU: data,
schedules, AdamW, gradient utilities, the loss, remat, parameter
conversion both ways, and the hand kernels' refusal of gradients.

Tolerances:

- data: bit for bit (both packages run the same numpy code);
- schedules: within one f32 ulp of the peak rate (the two libraries'
  ``cos`` round differently);
- AdamW: ``m``, ``v`` and the step bit for bit against the reference's
  update run op by op; the parameters within 1 f32 ulp at a constant rate,
  because XLA's f32 ``sqrt`` on the CPU is not correctly rounded (it
  differs from the IEEE square root on 0.66 % of inputs by an ulp), and
  within rtol 1e-6 under a schedule (whose rate may differ by an ulp);
  against the reference's compiled update, which contracts the moment
  updates into FMAs, within atol 1e-6;
- ``global_norm``: within 2 f32 ulp (each leaf's f32 sum of squares runs
  in its library's own order); ``clip_by_global_norm``: bit for bit when
  the norm is under the limit, else within rtol 1e-6 (its scale may
  differ by an ulp); ``compress_bf16`` and the error feedback: bit for
  bit (round to nearest even in both);
- ``cross_entropy``: 1e-6 (``Model.loss`` and its gradients per family:
  ``test_torch_train_loss.py``);
- remat: the same gradients bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro_torch.models.model as model_mod
from repro.configs import ARCH_IDS, get_config as ref_config
from repro.data import DataPipeline as RefPipeline
from repro.models import build_model as ref_build
from repro.models import layers as ref_layers
from repro.optim import AdamW as RefAdamW
from repro.optim import ErrorFeedback as RefEF
from repro.optim import accumulate_grads as ref_accumulate
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import compress_bf16 as ref_compress
from repro.optim import global_norm as ref_global_norm
from repro.optim import linear_warmup_cosine as ref_cosine
from repro.optim import make_schedule as ref_make_schedule
from repro.optim import wsd as ref_wsd
from repro_torch.configs import get_config
from repro_torch.data import DataPipeline
from repro_torch.kernels import flash_attention, linear_attention
from repro_torch.models import (build_model, params_from_numpy,
                                params_to_numpy)
from repro_torch.models import layers
from repro_torch.optim import (AdamW, ErrorFeedback, accumulate_grads,
                               clip_by_global_norm, compress_bf16,
                               global_norm, linear_warmup_cosine,
                               make_schedule, value_and_grad, wsd)
from repro_torch.tree import leaves, tree_map

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


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _same_leaves(got, want):
    """Two trees of the same structure, leaf by leaf, bit for bit."""
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8))


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("seed,shards,batch,seq,vocab", [
    (1, 8, 8, 64, 256), (3, 4, 8, 16, 100), (11, 1, 4, 32, 151936),
    (2 ** 31 - 1, 2, 6, 5, 7)])
def test_batches_equal_the_reference_bit_for_bit(seed, shards, batch, seq,
                                                 vocab):
    kw = dict(seed=seed, global_batch=batch, seq_len=seq, vocab=vocab,
              num_shards=shards)
    ours, ref = DataPipeline(**kw), RefPipeline(**kw)
    for step in (0, 1, 7, 1000, 123457):
        for shard in range(shards):
            _same_leaves(ours.batch_at(step, shard), ref.batch_at(step, shard))
    _same_leaves(ours.batch_at(3, 0, batch_override=3),
                 ref.batch_at(3, 0, batch_override=3))


@pytest.mark.parametrize("shards,to", [(1, 1), (4, 2), (2, 8)])
def test_iterators_and_reshard_equal_the_reference(shards, to):
    kw = dict(seed=9, global_batch=8, seq_len=8, vocab=64,
              num_shards=shards, start_step=5)
    ours, ref = DataPipeline(**kw), RefPipeline(**kw)
    it, rit = ours.shard_iterator(shards - 1), ref.shard_iterator(shards - 1)
    for _ in range(3):
        _same_leaves(next(it), next(rit))
    it.close()
    rit.close()
    a, b = ours.reshard(to, start_step=7), ref.reshard(to, start_step=7)
    assert (a.num_shards, a.start_step) == (b.num_shards, b.start_step)
    for shard in range(to):
        _same_leaves(a.batch_at(7, shard), b.batch_at(7, shard))
    _same_leaves(next(a.shard_iterator(0)), next(b.shard_iterator(0)))


# -- schedules ----------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("cosine", (3e-3, 10, 100)), ("cosine", (2.0, 5, 105)),
    ("cosine", (1e-3, 0, 40)), ("wsd", (1.0, 10, 100)),
    ("wsd", (3e-3, 10, 20)), ("wsd", (0.5, 0, 1000))])
def test_schedules_within_one_ulp_of_the_peak(name, args):
    """Steps 0 .. total + 1 against the reference compiled (as its trainer
    runs it) and op by op, within one f32 ulp of the peak rate: XLA's and
    torch's f32 ``cos`` round differently (neither is correctly rounded),
    which moves a value by an ulp of 1 before it is scaled, and the
    reference's own compiled and op-by-op values differ by as much."""
    ours = make_schedule(name, *args)
    peak, total = args[0], args[2]
    steps = np.arange(total + 2, dtype=np.int32)
    got = ours(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    ref = ref_make_schedule(name, *args)
    for want in (jax.jit(ref)(jnp.asarray(steps)), ref(jnp.asarray(steps))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=2 ** -23 * peak)
    # an int step, a 0-d tensor step and the batch agree
    for s in (0, args[1], total // 2, total):
        assert float(ours(s)) == float(ours(torch.tensor(s))) == got[s]


def test_schedule_functions_match_their_reference_defaults():
    steps = np.arange(60, dtype=np.int32)
    for ours, ref in ((linear_warmup_cosine, ref_cosine), (wsd, ref_wsd)):
        np.testing.assert_allclose(
            ours(1.0, 7, 50)(torch.from_numpy(steps)).numpy(),
            np.asarray(ref(1.0, 7, 50)(jnp.asarray(steps))), rtol=0,
            atol=2 ** -23)


# -- AdamW --------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {"w": (rng.normal(size=(17, 5)) * scale).astype(np.float32),
            "layers": [{"k": rng.normal(size=(33,)).astype(np.float32)},
                       {"k": rng.normal(size=(33,)).astype(np.float32)}],
            "b": rng.normal(size=(3, 4, 2)).astype(np.float32)}


@pytest.mark.parametrize("lr", ["const", "cosine"])
def test_adamw_against_the_reference_op_by_op(lr):
    rng = np.random.default_rng(0)
    p = _tree(rng)
    ours = AdamW(lr=1e-3 if lr == "const" else make_schedule(
        "cosine", 3e-3, 3, 12))
    ref = RefAdamW(lr=1e-3 if lr == "const" else ref_make_schedule(
        "cosine", 3e-3, 3, 12))
    tp, jp = _torch(p), jax.tree.map(jnp.asarray, p)
    ts, js = ours.init(tp), ref.init(jp)
    assert ts.step.dtype == torch.int32 and ts.step.shape == ()
    for _ in range(12):
        g = _tree(rng)
        tp, ts = ours.update(_torch(g), ts, tp)
        jp, js = ref.update(jax.tree.map(jnp.asarray, g), js, jp)
        _same_leaves(ts.m, js.m)
        _same_leaves(ts.v, js.v)
        assert int(ts.step) == int(js.step)
        for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
            if lr == "const":
                np.testing.assert_array_max_ulp(a.numpy(), np.asarray(b),
                                                maxulp=1)
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=0)


def test_adamw_against_the_reference_compiled():
    rng = np.random.default_rng(1)
    p = _tree(rng)
    ours, ref = AdamW(lr=1e-3), RefAdamW(lr=1e-3)
    tp, jp = _torch(p), jax.tree.map(jnp.asarray, p)
    ts, js = ours.init(tp), ref.init(jp)
    update = jax.jit(ref.update)
    for _ in range(5):
        g = _tree(rng)
        tp, ts = ours.update(_torch(g), ts, tp)
        jp, js = update(jax.tree.map(jnp.asarray, g), js, jp)
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


def test_adamw_is_not_torch_adamw_and_updates_in_place():
    """The reference's formula decays p inside the step; torch's AdamW
    scales p by 1 - lr * wd first, which gives other values."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    params = {"w": w.clone()}
    opt = AdamW(lr=0.1, weight_decay=0.5)
    state = opt.init(params)
    out, state = opt.update({"w": g}, state, params)
    assert out["w"] is params["w"] and state.m["w"] is not None
    ref = torch.nn.Parameter(w.clone())
    ref.grad = g.clone()
    torch.optim.AdamW([ref], lr=0.1, betas=(0.9, 0.95), eps=1e-8,
                      weight_decay=0.5).step()
    assert not torch.equal(ref.detach(), params["w"])
    mh, vh = 0.1 * g / 0.1, 0.05 * g * g / 0.05
    want = w - 0.1 * (mh / (vh.sqrt() + 1e-8) + 0.5 * w)
    torch.testing.assert_close(params["w"], want, rtol=0, atol=1e-6)


def test_adamw_optimizes_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        params, state = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 1e-2


# -- gradient utilities -------------------------------------------------------

def test_global_norm_and_clip_match_the_reference():
    rng = np.random.default_rng(3)
    for scale in (1e-3, 1.0, 30.0):
        g = _tree(rng, scale)
        norm = global_norm(_torch(g))
        assert norm.dtype == torch.float32 and norm.shape == ()
        np.testing.assert_array_max_ulp(
            norm.numpy(), np.asarray(ref_global_norm(
                jax.tree.map(jnp.asarray, g))), maxulp=2)
        clipped, n = clip_by_global_norm(_torch(g), 1.0)
        want, wn = jax.jit(lambda t: ref_clip(t, 1.0))(
            jax.tree.map(jnp.asarray, g))
        np.testing.assert_array_max_ulp(n.numpy(), np.asarray(wn),
                                        maxulp=2)
        if float(wn) < 1.0:
            _same_leaves(clipped, want)
        for a, b in zip(jax.tree.leaves(clipped), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=0)
    g = {"a": torch.full((10,), 3.0), "b": torch.full((10,), 4.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(250.0))
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def test_compress_bf16_and_error_feedback_equal_the_reference():
    rng = np.random.default_rng(4)
    g = _tree(rng)
    ours, ref = ErrorFeedback.init(_torch(g)), RefEF.init(
        jax.tree.map(jnp.asarray, g))
    for _ in range(6):
        g = _tree(rng)
        wire, ours = compress_bf16(_torch(g), ours)
        rwire, ref = ref_compress(jax.tree.map(jnp.asarray, g), ref)
        for a, b in zip(jax.tree.leaves(wire), jax.tree.leaves(rwire)):
            assert a.dtype == torch.bfloat16
            assert np.array_equal(a.view(torch.int16).numpy(),
                                  np.asarray(b).view(np.int16))
        _same_leaves(ours.residual, ref.residual)
    wire, none = compress_bf16(_torch(g))
    assert none is None and leaves(wire)[0].dtype == torch.bfloat16


def test_accumulate_grads_matches_the_reference():
    rng = np.random.default_rng(5)
    w = rng.normal(size=(6, 3)).astype(np.float32)
    mbs = [{"x": rng.normal(size=(4, 6)).astype(np.float32)}
           for _ in range(3)]

    def ours_loss(p, b):
        y = torch.from_numpy(b["x"]) @ p["w"]
        return (y * y).mean(), {}

    def ref_loss(p, b):
        y = jnp.asarray(b["x"]) @ p["w"]
        return (y * y).mean(), {}

    params = {"w": torch.from_numpy(w.copy())}
    loss, grads = accumulate_grads(ours_loss, params, mbs)
    want_loss, want = ref_accumulate(ref_loss, {"w": jnp.asarray(w)}, mbs)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
    np.testing.assert_allclose(grads["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-6, atol=1e-7)
    assert not params["w"].requires_grad and params["w"].grad is None


# -- the loss -----------------------------------------------------------------

@pytest.mark.parametrize("valid,masked", [(None, False), (20, False),
                                          (20, True)])
def test_cross_entropy_matches_the_reference(valid, masked):
    rng = np.random.default_rng(6)
    logits = (rng.normal(size=(2, 7, 24)) * 3).astype(np.float32)
    labels = rng.integers(0, valid or 24, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32) if masked else None
    got = layers.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels).long(),
        None if mask is None else torch.from_numpy(mask), valid)
    want = ref_layers.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask), valid)
    assert float(got) == pytest.approx(float(want), abs=1e-6)


def _train_batch(cfg, B=2, T=24):
    """A training batch of the config's inputs, from a numpy seed."""
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (B, T + 1))
    batch = {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:])}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))).float()
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.from_numpy(
            rng.normal(size=(B, cfg.vision_tokens, cfg.d_model))).float()
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_train_step_moves_the_parameters(arch):
    """The reference's ``test_one_train_step``: one AdamW step through
    ``Model.loss`` on each reduced config; the loss is finite and the
    parameters move."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), CPU)
    before = tree_map(torch.clone, params)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                     generator=g)}
    batch["labels"] = batch["tokens"]
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(2, cfg.encoder_seq, cfg.d_model,
                                      generator=g).to(torch.bfloat16)
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.randn(2, cfg.vision_tokens,
                                             cfg.d_model, generator=g)
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    loss, grads = value_and_grad(model.loss, params, batch)
    params, state = opt.update(grads, state, params)
    assert bool(torch.isfinite(loss))
    assert int(state.step) == 1
    assert any(not torch.equal(a, b)
               for a, b in zip(leaves(before), leaves(params)))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi3.5-moe-42b-a6.6b",
                                  "whisper-medium", "xlstm-1.3b",
                                  "zamba2-7b"])
def test_remat_gives_the_same_gradients(arch):
    """``remat`` recomputes the blocks the reference wraps in
    ``jax.checkpoint``: the loss and every gradient equal the stored
    forward's bit for bit; without a gradient the blocks run as they are."""
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=False)
    plain, remat = build_model(cfg), build_model(
        dataclasses.replace(cfg, remat=True))
    params = plain.init(torch.Generator().manual_seed(2), CPU)
    batch = _train_batch(cfg)
    want_loss, want = value_and_grad(plain.loss, params, batch)
    got_loss, got = value_and_grad(remat.loss, params, batch)
    assert float(got_loss) == float(want_loss)
    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert torch.equal(remat.loss(params, batch)[0], want_loss)


def test_remat_recomputes_in_the_backward_pass(monkeypatch):
    """The recompute happens: each decoder block runs twice under remat
    (forward, then again in the backward pass), once without."""
    calls = []
    real = model_mod.rmsnorm

    def counting(p, x, eps=1e-6):
        calls.append(1)
        return real(p, x, eps)

    monkeypatch.setattr(model_mod, "rmsnorm", counting)
    cfg = get_config("qwen3-0.6b").reduced()
    batch = _train_batch(cfg)
    counts = {}
    for remat in (False, True):
        model = build_model(dataclasses.replace(cfg, remat=remat))
        params = model.init(torch.Generator().manual_seed(2), CPU)
        calls.clear()
        value_and_grad(model.loss, params, batch)
        counts[remat] = len(calls)
    # two norms a block and the final norm
    assert counts[False] == 2 * cfg.num_layers + 1
    assert counts[True] == 4 * cfg.num_layers + 1


# -- the hand kernels refuse gradients ----------------------------------------

def test_kernels_refuse_inputs_that_require_grad():
    q = torch.randn(1, 2, 16, 8, requires_grad=True)
    with pytest.raises(ValueError, match="no backward.*flash_attention_plain"):
        flash_attention(q, q, q)
    a = torch.randn(2, 16, 8, requires_grad=True)
    ld = -torch.rand(2, 16)
    with pytest.raises(ValueError,
                       match="no backward.*linear_attention_plain"):
        linear_attention(a, a, a, ld)
    with pytest.raises(ValueError, match="no backward"):
        linear_attention(a.detach(), a.detach(), a.detach(),
                         ld.requires_grad_())
    with torch.no_grad():
        assert flash_attention(q, q, q).shape == q.shape
        assert linear_attention(a, a, a, ld).shape == a.shape
    # no input requires grad: the wrapper computes, as serving calls it
    assert flash_attention(q.detach(), q.detach(), q.detach()).shape == \
        q.shape


@pytest.mark.parametrize("arch,impls", [("qwen3-0.6b", ("flash", "ref")),
                                        ("zamba2-7b", ("xla", "pallas")),
                                        ("xlstm-1.3b", ("xla", "pallas"))])
def test_training_through_a_kernel_impl_is_refused(arch, impls):
    """A train step through ``attn_impl="flash"`` or
    ``mixer_impl="pallas"`` raises instead of cutting the graph; the same
    forward without gradients runs, and the plain impls train."""
    cfg = dataclasses.replace(get_config(arch).reduced(), attn_impl=impls[0],
                              mixer_impl=impls[1])
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), CPU)
    batch = _train_batch(cfg)
    with pytest.raises(ValueError, match="no backward"):
        value_and_grad(model.loss, params, batch)
    loss, _ = model.loss(params, batch)
    assert bool(torch.isfinite(loss))
    plain = build_model(dataclasses.replace(cfg, attn_impl="xla",
                                            mixer_impl="ref"))
    got, grads = value_and_grad(plain.loss, params, batch)
    assert float(got) == pytest.approx(float(loss), rel=1e-6)
    assert all(bool(torch.isfinite(g).all()) for g in leaves(grads))


# -- parameter conversion both ways -------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_round_trip_through_the_reference_layout(arch):
    """``params_to_numpy`` inverts ``params_from_numpy``: the reference's
    tree (its structure and shapes from ``jax.eval_shape``, random values)
    comes back bit for bit, and so do the port's parameters."""
    cfg = get_config(arch).reduced()
    shapes = jax.eval_shape(ref_build(ref_config(arch).reduced()).init,
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    tree = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(s.dtype),
                        shapes)
    back = params_to_numpy(cfg, params_from_numpy(cfg, tree, device=CPU))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    _same_leaves(back, tree)
    params = build_model(cfg).init(torch.Generator().manual_seed(1), CPU)
    again = params_from_numpy(cfg, params_to_numpy(cfg, params), device=CPU)
    assert jax.tree.structure(again) == jax.tree.structure(params)
    _same_leaves(again, params)
    # fresh host arrays: writing one leaves the parameters as they were
    out = params_to_numpy(cfg, params)
    out["embed"]["table"][...] = 0
    assert bool(params["embed"]["table"].any())
