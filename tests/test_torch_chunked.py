"""The chunked forms against the reference, on the CPU.

``chunked_linear_attention`` (the SSD and mLSTM mixers' training path) and
``chunked_attention`` take the same numpy arrays as the reference's
``ref.chunked_linear_attention`` and ``models.attention.chunked_attention``
and as the port's plain versions. Every model family's reduced config then
runs with ``attn_impl="chunked"`` and ``mixer_impl="chunked"`` in both
packages, and zamba2-7b and xlstm-1.3b train on the chunked mixers.
Compared in f32. Tolerances:

- ``chunked_linear_attention`` forward: 1e-4 abs and relative (another
  order of f32 sums over outputs of order 100; the largest seen is 7e-5,
  at steep decays, where the reference's f32 prefix sums are the further
  of the two from the exact recurrence); gradients: 1e-5 of each
  gradient's largest magnitude from the plain version's under torch
  autograd (the largest seen is 6e-7);
- ``chunked_attention``: 2e-5, the f32 flash tolerance of
  ``test_torch_lm_kernels.py``;
- whole models in f32: 5e-5 on the logits, as
  ``test_torch_models_families.py``; ``mixer_impl`` "ref" against
  "chunked" within the reference's own 0.05
  (``tests/test_models.py::test_mixer_impl_consistency``);
- a training step's loss 1e-5 and each gradient leaf within 2e-5 of its
  largest magnitude, as ``test_torch_train_loss.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.model as ref_model_mod
import repro_torch.models.model as model_mod
from repro.configs import get_config as ref_config
from repro.data import DataPipeline as RefPipeline
from repro.hetero import HeteroTrainer as RefTrainer
from repro.hetero import make_policy as ref_make_policy
from repro.kernels import ref
from repro.models import build_model as ref_build
from repro.models.attention import chunked_attention as ref_chunked_attention
from repro.optim import AdamW as RefAdamW
from repro_torch.configs import get_config
from repro_torch.data import DataPipeline
from repro_torch.hetero import HeteroTrainer, make_policy
from repro_torch.kernels import (chunked_linear_attention,
                                 flash_attention_plain, linear_attention,
                                 linear_attention_plain)
from repro_torch.models import (build_model, params_from_numpy,
                                params_to_numpy)
from repro_torch.models.attention import attention_train, chunked_attention
from repro_torch.optim import AdamW, value_and_grad

CPU = torch.device("cpu")
ALL_ARCHS = ["qwen3-0.6b", "qwen1.5-110b", "h2o-danube3-4b", "minicpm-2b",
             "internvl2-1b", "phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b",
             "xlstm-1.3b", "whisper-medium", "zamba2-7b"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: many small eager ops, which more threads only
    slow down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _linear_inputs(seed, BH, T, D, lo):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(BH, T, D)).astype(np.float32)
               for _ in range(3))
    ld = rng.uniform(lo, 0.0, size=(BH, T)).astype(np.float32)
    return q, k, v, ld


# -- chunked_linear_attention ------------------------------------------------

@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("BH,T", [(2, 128), (3, 200), (4, 256)])
def test_chunked_linear_attention_matches_reference(BH, T, D):
    arrays = _linear_inputs(BH * 1000 + T + D, BH, T, D, -0.1)
    before = linear_attention.launches
    got = chunked_linear_attention(*(torch.from_numpy(a) for a in arrays))
    assert linear_attention.launches == before     # plain PyTorch, no kernel
    assert got.shape == (BH, T, D) and got.dtype == torch.float32
    want = np.asarray(ref.chunked_linear_attention(
        *(jnp.asarray(a) for a in arrays)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    plain = linear_attention_plain(*(torch.from_numpy(a) for a in arrays))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_chunked_linear_attention_keeps_bf16_and_crops_padding():
    arrays = _linear_inputs(5, 2, 70, 16, -0.1)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays[:3])
    got = chunked_linear_attention(q, k, v, torch.from_numpy(arrays[3]),
                                   chunk=32)
    assert got.shape == (2, 70, 16) and got.dtype == torch.bfloat16
    want = linear_attention_plain(q, k, v, torch.from_numpy(arrays[3]))
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=2e-2, atol=2e-2)


def _grads(fn, arrays, weights, **kw):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*leaves, **kw)
    return torch.autograd.grad((out * weights).sum(), leaves)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("lo", [-0.1, -4.0])
def test_chunked_linear_attention_gradients_match_plain(lo, remat):
    arrays = _linear_inputs(11, 2, 200, 16, lo)
    weights = torch.from_numpy(np.random.default_rng(12).normal(
        size=(2, 200, 16)).astype(np.float32))
    got = _grads(chunked_linear_attention, arrays, weights,
                 remat_chunks=remat)
    want = _grads(linear_attention_plain, arrays, weights)
    for name, g, w in zip(("q", "k", "v", "log_decay"), got, want):
        assert bool(torch.isfinite(g).all()), name
        tol = 1e-5 * float(w.abs().max())
        assert float((g - w).abs().max()) <= tol, name


def test_reference_chunked_gradient_is_not_finite_under_steep_decays():
    """ROADMAP queue 3: ``ref.chunked_linear_attention`` forms
    exp(cum_i - cum_j) for i < j too and masks after the product, so at
    ``ld`` in [-4, 0] its masked entries are inf and ``jax.grad`` gives
    inf * 0; the port forms the decay only for i >= j."""
    q, k, v, ld = _linear_inputs(13, 2, 128, 16, -4.0)

    def loss(q):
        return jnp.sum(ref.chunked_linear_attention(
            q, jnp.asarray(k), jnp.asarray(v), jnp.asarray(ld)))

    assert not np.isfinite(np.asarray(jax.grad(loss)(jnp.asarray(q)))).all()
    tq = torch.from_numpy(q).requires_grad_()
    out = chunked_linear_attention(tq, *(torch.from_numpy(a)
                                         for a in (k, v, ld)))
    (g,) = torch.autograd.grad(out.sum(), [tq])
    assert bool(torch.isfinite(g).all())


def _saved_bytes(remat):
    """Bytes autograd keeps for the backward of one chunked call."""
    arrays = _linear_inputs(14, 2, 512, 32, -0.1)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = chunked_linear_attention(*leaves, remat_chunks=remat)
    return out, sum(saved)


def test_remat_chunks_keeps_only_the_chunk_inputs():
    """With ``remat_chunks`` the backward keeps each chunk's inputs (the
    carried state among them), not its (C, C) scores and decays."""
    with_remat, kept = _saved_bytes(True)
    without, full = _saved_bytes(False)
    assert torch.equal(with_remat, without)
    assert kept < full / 2


# -- chunked_attention ------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 300), (False, 100)])
@pytest.mark.parametrize("hq,hkv,T", [(4, 4, 1024), (4, 2, 1024),
                                      (14, 2, 512), (4, 2, 200),
                                      (14, 2, 600)])
def test_chunked_attention_matches_reference(hq, hkv, T, causal, window):
    rng = np.random.default_rng(hq * 100 + T)
    q = rng.normal(size=(1, hq, T, 16)).astype(np.float32)
    k, v = (rng.normal(size=(1, hkv, T, 16)).astype(np.float32)
            for _ in range(2))
    got = chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=causal, window=window)
    assert got.shape == q.shape and got.dtype == torch.float32
    want = np.asarray(ref_chunked_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal, window=window))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    plain = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_chunked_attention_output_in_q_dtype_and_unknown_impl_refused():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 64, 16)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    assert chunked_attention(q, k, v).dtype == torch.bfloat16
    p = {"wq": {"kernel": torch.zeros(8, 8)}, "wk": {"kernel":
         torch.zeros(8, 8)}, "wv": {"kernel": torch.zeros(8, 8)},
         "wo": {"kernel": torch.zeros(8, 8)}}
    with pytest.raises(ValueError, match="unknown attn_impl"):
        attention_train(p, torch.zeros(1, 4, 8), num_heads=2,
                        num_kv_heads=2, head_dim=4, rope_freqs=None,
                        impl="pallas")


# -- models -----------------------------------------------------------------

@pytest.fixture
def f32_stream(monkeypatch):
    """Both packages' model builders embed tokens in f32."""
    monkeypatch.setattr(ref_model_mod, "embed", functools.partial(
        ref_model_mod.embed, dtype=jnp.float32))
    monkeypatch.setattr(model_mod, "embed", functools.partial(
        model_mod.embed, dtype=torch.float32))


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    return jax.tree.map(np.asarray, ref_build(ref_config(arch).reduced())
                        .init(jax.random.PRNGKey(0)))


def _batches(cfg, B=2, T=48):
    """The same inputs for both packages: (jax batch, torch batch)."""
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tok[:, :-1]),
          "labels": jnp.asarray(tok[:, 1:])}
    tb = {"tokens": torch.from_numpy(tok[:, :-1]).long(),
          "labels": torch.from_numpy(tok[:, 1:]).long()}
    if cfg.family == "encdec":
        fr = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))
        jb["frames"] = jnp.asarray(fr, jnp.float32)
        tb["frames"] = torch.from_numpy(fr).float()
    if cfg.family == "vlm":
        ve = rng.normal(size=(B, cfg.vision_tokens, cfg.d_model))
        jb["vision_embeds"] = jnp.asarray(ve, jnp.float32)
        tb["vision_embeds"] = torch.from_numpy(ve).float()
    return jb, tb


def _chunked(cfg):
    return dataclasses.replace(cfg, attn_impl="chunked",
                               mixer_impl="chunked")


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b"])
def test_mixer_impl_consistency(arch):
    """The port's counterpart of the reference's test: ``mixer_impl``
    "ref" and "chunked" give the same logits."""
    cfg = get_config(arch).reduced()
    params = params_from_numpy(cfg, _reference_params(arch), device=CPU)
    _, batch = _batches(cfg)
    l1, _ = build_model(dataclasses.replace(cfg, mixer_impl="ref")).forward(
        params, batch)
    l2, _ = build_model(dataclasses.replace(
        cfg, mixer_impl="chunked")).forward(params, batch)
    assert float((l1 - l2).abs().max()) < 0.05


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_chunked_forward_matches_reference_f32(f32_stream, arch):
    cfg = _chunked(get_config(arch).reduced())
    tree = _reference_params(arch)
    jb, tb = _batches(cfg)
    want, want_aux = _compiled(ref_build(_chunked(ref_config(arch)
                                                  .reduced())).forward,
                               tree, jb)
    got, aux = build_model(cfg).forward(
        params_from_numpy(cfg, tree, device=CPU), tb)
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 5e-5
    assert float(aux) == pytest.approx(float(want_aux), abs=1e-6)


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b"])
def test_chunked_mixers_train_as_the_reference(f32_stream, arch):
    """One ``HeteroTrainer`` step in each package on the chunked mixers
    (the same assignment, losses within rtol 1e-5), and the loss's
    gradient tree leaf by leaf, as ``test_torch_train_loss.py`` holds
    the plain impls."""
    ref_cfg = dataclasses.replace(ref_config(arch).reduced(),
                                  mixer_impl="chunked")
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              mixer_impl="chunked")
    ref_model, model = ref_build(ref_cfg), build_model(cfg)
    tree = _reference_params(arch)

    jb, tb = _batches(cfg, T=24)
    (want, _), want_grads = _compiled(
        jax.value_and_grad(ref_model.loss, has_aux=True), tree, jb)
    loss, grads = value_and_grad(model.loss,
                                 params_from_numpy(cfg, tree, device=CPU),
                                 tb)
    assert float(loss) == pytest.approx(float(want), abs=1e-5)
    got = params_to_numpy(cfg, grads)
    want_grads = jax.tree.map(np.asarray, want_grads)
    assert jax.tree.structure(got) == jax.tree.structure(want_grads)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want_grads),
                            jax.tree.leaves(got)):
        assert g.shape == w.shape, path
        if w.size:
            tol = 2e-5 * float(np.abs(w).max()) + 1e-7
            assert float(np.abs(g - w).max()) <= tol, path

    speeds = {"A": 1.0, "B": 0.5}
    kw = dict(seed=5, global_batch=4, seq_len=16, vocab=cfg.vocab_size,
              num_shards=4)
    ref_tr = RefTrainer(ref_model, jax.tree.map(jnp.asarray, tree),
                        optimizer=RefAdamW(lr=1e-3),
                        policy=ref_make_policy("static",
                                               {"A": 1.0, "B": 1.0}),
                        pipeline=RefPipeline(**kw), group_speeds=speeds,
                        total_microbatches=4)
    ours = HeteroTrainer(model, params_from_numpy(cfg, tree, device=CPU),
                         optimizer=AdamW(lr=1e-3),
                         policy=make_policy("static", {"A": 1.0, "B": 1.0}),
                         pipeline=DataPipeline(**kw), group_speeds=speeds,
                         total_microbatches=4)
    want_rep, got_rep = ref_tr.train_step(), ours.train_step()
    assert got_rep.assignment == want_rep.assignment
    assert got_rep.loss == pytest.approx(want_rep.loss, rel=1e-5)
