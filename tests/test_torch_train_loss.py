"""``Model.loss`` and its gradient tree against the reference, one reduced
config per family, on the CPU.

Parameters come from the reference's initialiser through numpy
(``params_from_numpy``); the gradients go back through
``params_to_numpy`` into the reference's stacked layout and are compared
leaf by leaf with ``jax.value_and_grad`` of the reference's ``loss``
(compiled with ``xla_allow_excess_precision`` off). Both packages' ``embed``
return f32, as ``test_torch_models_families.py`` patches them, so the
residual stream is f32. Tolerances: 1e-5 on the loss, its ``ce`` and
``aux``; each gradient leaf within 2e-5 of that leaf's largest magnitude
(another order of f32 sums; the largest seen is 4.3e-6).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.model as ref_model_mod
import repro_torch.models.model as model_mod
from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro_torch.configs import get_config
from repro_torch.models import (build_model, params_from_numpy,
                                params_to_numpy)
from repro_torch.optim import value_and_grad

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


@pytest.fixture
def f32_stream(monkeypatch):
    """Both packages' model builders embed tokens in f32."""
    monkeypatch.setattr(ref_model_mod, "embed", functools.partial(
        ref_model_mod.embed, dtype=jnp.float32))
    monkeypatch.setattr(model_mod, "embed", functools.partial(
        model_mod.embed, dtype=torch.float32))


def _train_batches(cfg, B=2, T=24):
    """The same training batch for both packages: (jax, torch)."""
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


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi3.5-moe-42b-a6.6b",
                                  "internvl2-1b", "whisper-medium",
                                  "xlstm-1.3b", "zamba2-7b"])
def test_loss_and_gradients_match_the_reference_f32(f32_stream, arch):
    cfg = get_config(arch).reduced()
    ref_cfg = ref_config(arch).reduced()
    tree = jax.tree.map(np.asarray, ref_build(ref_cfg).init(
        jax.random.PRNGKey(0)))
    jb, tb = _train_batches(cfg)
    fn = jax.jit(jax.value_and_grad(ref_build(ref_cfg).loss, has_aux=True))
    (want, want_parts), want_grads = fn.lower(tree, jb).compile(
        compiler_options={"xla_allow_excess_precision": False})(tree, jb)
    model = build_model(cfg)
    params = params_from_numpy(cfg, tree, device=CPU)
    loss, parts = model.loss(params, tb)
    assert set(parts) == {"loss", "ce", "aux"}
    for key in ("loss", "ce", "aux"):
        assert float(parts[key]) == pytest.approx(float(want_parts[key]),
                                                  abs=1e-5)
    got_loss, grads = value_and_grad(model.loss, params, tb)
    assert float(got_loss) == float(loss)
    got = params_to_numpy(cfg, grads)
    want_grads = jax.tree.map(np.asarray, want_grads)
    assert jax.tree.structure(got) == jax.tree.structure(want_grads)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want_grads),
                            jax.tree.leaves(got)):
        assert g.shape == w.shape, path
        if w.size:
            tol = 2e-5 * float(np.abs(w).max()) + 1e-7
            assert float(np.abs(g - w).max()) <= tol, path
    if cfg.family == "moe":
        assert float(want_parts["aux"]) > 0
