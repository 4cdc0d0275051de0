"""The port's LM stack (configs, layers, attention, Mamba-2, zamba2) against
the reference, on the CPU.

Parameters come from the reference's initialisers through numpy, so both
packages compute with the same values. Modules are compared on f32
inputs within 1e-4. The whole model runs as the model does, with a bf16
residual stream, and is held within 0.05 of the reference's ``forward``,
the bound the reference's own model tests use (``test_models.py``).

The reference's ``forward`` is compiled here with
``xla_allow_excess_precision`` off. With it on (XLA's default), XLA may
keep a fused bf16 chain in f32 and skip roundings the program asks for,
so the compiled forward departs from its own op-by-op composition: by
0.047 to 0.058 in the logits of this reduced model for seeds 0-2. The port
rounds where the program says; against the op-by-op reference it differs
by 0 to 0.049 over seeds 0-7 (bf16 rounding flips amplified through four
layers), and by 0.019 at the seed used here.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build
from repro.models import layers as ref_layers
from repro.models import ssm as ref_ssm
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.kernels import flash_attention, linear_attention
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve_lm
from repro_torch.models import (build_model, count_params, param_bytes,
                                params_from_numpy)
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import ssm

CPU = torch.device("cpu")


def _torch(tree):
    """A reference parameter tree as torch tensors on the CPU."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- configs ----------------------------------------------------------------

@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_config_is_the_reference_config(arch):
    assert ARCH_IDS == REF_ARCH_IDS
    port, ref = get_config(arch), ref_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert port.n_params() == ref.n_params()


def test_shapes_are_the_reference_shapes():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("arch", [a for a in REF_ARCH_IDS
                                  if a != "zamba2-7b"])
def test_every_family_builds_with_the_reference_shapes(arch):
    """init gives the reference's parameter tree, one dict per layer where
    the reference stacks them, shape for shape."""
    cfg = get_config(arch).reduced()
    params = build_model(cfg).init(torch.Generator().manual_seed(0), CPU)
    ref = ref_build(ref_config(arch).reduced()).init(jax.random.PRNGKey(0))
    converted = params_from_numpy(cfg, jax.tree.map(np.asarray, ref),
                                  device=CPU)
    assert jax.tree.map(lambda a: tuple(a.shape), params) == \
        jax.tree.map(lambda a: tuple(a.shape), converted)
    assert count_params(params) == sum(
        a.size for a in jax.tree_util.tree_leaves(ref))


# -- layers -----------------------------------------------------------------

def test_rmsnorm_dense_mlp_match_reference_f32():
    key = jax.random.PRNGKey(1)
    x = _normal(1, 2, 5, 32)
    p_norm = {"scale": jnp.asarray(1 + 0.1 * _normal(2, 32))}
    _close(layers.rmsnorm(_torch(p_norm), torch.from_numpy(x)),
           ref_layers.rmsnorm(p_norm, jnp.asarray(x)))
    p_dense = ref_layers.init_dense(key, 32, 24, bias=True)
    p_dense["bias"] = jnp.asarray(_normal(3, 24))
    _close(layers.dense(_torch(p_dense), torch.from_numpy(x)),
           ref_layers.dense(p_dense, jnp.asarray(x)))
    p_mlp = ref_layers.init_mlp(key, 32, 48)
    _close(layers.mlp(_torch(p_mlp), torch.from_numpy(x)),
           ref_layers.mlp(p_mlp, jnp.asarray(x)))


def test_embed_unembed_and_rope_match_reference():
    p = ref_layers.init_embedding(jax.random.PRNGKey(2), 40, 16)
    tokens = np.array([[0, 5, 39], [7, 7, 1]], np.int32)
    got = layers.embed(_torch(p), torch.from_numpy(tokens).long())
    assert got.dtype == torch.bfloat16
    want = ref_layers.embed(p, jnp.asarray(tokens))
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    x = _normal(4, 2, 3, 16)
    _close(layers.unembed(_torch(p), torch.from_numpy(x), pad_to=64),
           ref_layers.unembed(p, jnp.asarray(x), pad_to=64))
    freqs = ref_layers.rope_frequencies(16, 1e6)
    _close(layers.rope_frequencies(16, 1e6), freqs, 1e-6)
    pos = np.arange(3)[None].repeat(2, 0)
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             layers.rope_frequencies(16, 1e6)),
           ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), freqs))


def test_silu_rounds_as_the_reference_in_bf16():
    x = _normal(5, 4096) * 3
    got = layers.silu(torch.from_numpy(x).to(torch.bfloat16))
    want = jax.jit(jax.nn.silu)(jnp.asarray(x, jnp.bfloat16))
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))


# -- attention --------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("heads,kv,window,qk_norm,rope", [
    (4, 4, 8, False, False), (4, 2, None, True, True)])
def test_attention_train_matches_reference_f32(impl, heads, kv, window,
                                               qk_norm, rope):
    hd, d, t = 16, 32, 24
    p = ref_attn.init_attention(jax.random.PRNGKey(3), d, heads, kv, hd,
                                qk_norm=qk_norm)
    x = _normal(6, 2, t, d)
    freqs = ref_layers.rope_frequencies(hd) if rope else None
    want = ref_attn.attention_train(
        p, jnp.asarray(x), num_heads=heads, num_kv_heads=kv, head_dim=hd,
        rope_freqs=freqs, window=window, impl=impl)
    got = attn.attention_train(
        _torch(p), torch.from_numpy(x), num_heads=heads, num_kv_heads=kv,
        head_dim=hd, rope_freqs=layers.rope_frequencies(hd) if rope
        else None, window=window, impl=impl)
    _close(got, want)


def test_attention_chunked_waits_for_the_training_slice():
    """``impl="chunked"`` was refused until the chunked forms were
    ported; it now runs and matches the reference's chunked attention
    (GQA 4/2, window 3, RoPE)."""
    p = ref_attn.init_attention(jax.random.PRNGKey(3), 8, 4, 2, 4)
    x = _normal(9, 2, 6, 8)
    freqs = ref_layers.rope_frequencies(4)
    want = ref_attn.attention_train(
        p, jnp.asarray(x), num_heads=4, num_kv_heads=2, head_dim=4,
        rope_freqs=freqs, window=3, impl="chunked")
    got = attn.attention_train(
        _torch(p), torch.from_numpy(x), num_heads=4, num_kv_heads=2,
        head_dim=4, rope_freqs=layers.rope_frequencies(4), window=3,
        impl="chunked")
    _close(got, want)


def test_attention_decode_matches_reference_through_the_ring():
    """Ten steps into a ring of 6 slots with a window of 4 (it wraps)."""
    heads, kv, hd, d, steps = 4, 2, 16, 32, 10
    p = ref_attn.init_attention(jax.random.PRNGKey(4), d, heads, kv, hd)
    pt = _torch(p)
    jc = ref_attn.init_kv_cache(2, kv, 6, hd)
    tc = attn.init_kv_cache(2, kv, 6, hd, device=CPU)
    freqs = ref_layers.rope_frequencies(hd)
    for s in range(steps):
        x = _normal(10 + s, 2, 1, d)
        want, jc = ref_attn.attention_decode(
            p, jnp.asarray(x), jc, num_heads=heads, num_kv_heads=kv,
            head_dim=hd, rope_freqs=freqs, window=4)
        got, tc = attn.attention_decode(
            pt, torch.from_numpy(x), tc, num_heads=heads, num_kv_heads=kv,
            head_dim=hd, rope_freqs=layers.rope_frequencies(hd), window=4)
        _close(got, want)
    assert tc["len"] == int(jc["len"]) == steps
    _close(tc["k"], jc["k"], 1e-2)      # bf16 ring, both rounded alike


# -- Mamba-2 ----------------------------------------------------------------

@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_mamba2_train_matches_reference_f32(impl):
    d, s, hd, t = 32, 16, 16, 40
    p = ref_ssm.init_mamba2(jax.random.PRNGKey(5), d, s, hd)
    x = _normal(7, 2, t, d)
    want = ref_ssm.mamba2_train(p, jnp.asarray(x), d_state=s, head_dim=hd,
                                impl=impl)
    got = ssm.mamba2_train(_torch(p), torch.from_numpy(x), d_state=s,
                           head_dim=hd, impl=impl)
    _close(got, want)


def test_mamba2_decode_matches_reference_f32():
    d, s, hd = 32, 16, 16
    p = ref_ssm.init_mamba2(jax.random.PRNGKey(6), d, s, hd)
    pt = _torch(p)
    jc = ref_ssm.init_mamba2_cache(2, d, s, hd)
    tc = ssm.init_mamba2_cache(2, d, s, hd, device=CPU)
    for step in range(6):
        x = _normal(20 + step, 2, 1, d)
        want, jc = ref_ssm.mamba2_decode(p, jnp.asarray(x), jc, d_state=s,
                                         head_dim=hd)
        got, tc = ssm.mamba2_decode(pt, torch.from_numpy(x), tc, d_state=s,
                                    head_dim=hd)
        _close(got, want)
    _close(tc["state"], jc["state"])
    _close(tc["conv"], jc["conv"])


# -- zamba2 as a whole ------------------------------------------------------

SEQ = 48                       # > the reduced window (32): the ring wraps
BATCH = 2


def _zamba(attn_impl="xla", mixer_impl="ref"):
    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(),
                              attn_impl=attn_impl, mixer_impl=mixer_impl)
    ref_cfg = dataclasses.replace(ref_config("zamba2-7b").reduced(),
                                  attn_impl=attn_impl, mixer_impl=mixer_impl)
    return cfg, ref_cfg


@pytest.fixture(scope="module")
def zamba_params():
    _, ref_cfg = _zamba()
    return jax.tree.map(np.asarray, ref_build(ref_cfg).init(
        jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(
        0, 256, (BATCH, SEQ)).astype(np.int32)


def test_reduced_zamba_has_the_compared_size():
    cfg, _ = _zamba()
    assert (cfg.num_layers, cfg.attn_every, cfg.window) == (4, 2, 32)
    assert cfg.vocab_size == 256


@pytest.mark.parametrize("attn_impl,mixer_impl", [("xla", "ref"),
                                                  ("flash", "pallas")])
def test_zamba_forward_matches_reference(zamba_params, tokens, attn_impl,
                                         mixer_impl):
    cfg, ref_cfg = _zamba(attn_impl, mixer_impl)
    ref_model = ref_build(ref_cfg)
    batch = {"tokens": jnp.asarray(tokens)}
    compiled = jax.jit(ref_model.forward).lower(zamba_params, batch).compile(
        compiler_options={"xla_allow_excess_precision": False})
    want, _ = compiled(zamba_params, batch)
    model = build_model(cfg)
    params = params_from_numpy(cfg, zamba_params, device=CPU)
    got, aux = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.float32 and got.shape == (BATCH, SEQ, 2048)
    assert float(aux) == 0.0
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 0.05
    assert not got[..., 256:].any()          # padded columns come out 0
    last = model.prefill_logits(params, {"tokens": torch.from_numpy(tokens)})
    assert torch.equal(last, got[:, -1, :])


def test_zamba_forward_runs_the_kernel_wrappers(zamba_params, tokens):
    """Under flash/pallas the forward calls each wrapper once per layer:
    on CPU tensors the wrappers run their plain versions (no launch)."""
    cfg, _ = _zamba("flash", "pallas")
    model = build_model(cfg)
    params = params_from_numpy(cfg, zamba_params, device=CPU)
    calls = {"flash": 0, "linear": 0}
    fa, la = attn.flash_attention, ssm.linear_attention

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    attn.flash_attention = count("flash", fa)
    ssm.linear_attention = count("linear", la)
    try:
        before = (flash_attention.launches, linear_attention.launches)
        model.forward(params, {"tokens": torch.from_numpy(tokens)})
    finally:
        attn.flash_attention, ssm.linear_attention = fa, la
    assert calls == {"flash": 2, "linear": 4}
    assert (flash_attention.launches, linear_attention.launches) == before


def test_zamba_decode_matches_its_forward(zamba_params, tokens):
    cfg, _ = _zamba()
    model = build_model(cfg)
    params = params_from_numpy(cfg, zamba_params, device=CPU)
    t = torch.from_numpy(tokens)
    full, _ = model.forward(params, {"tokens": t})
    cache = model.init_cache(BATCH, SEQ, device=CPU)
    assert cache["attn"][0]["k"].shape[2] == cfg.window
    worst = 0.0
    for step in range(SEQ):
        logits, cache = model.decode_step(params, t[:, step:step + 1], cache)
        assert bool(torch.isinf(logits[:, 256:]).all())   # masked padding
        worst = max(worst, float((logits[:, :256] -
                                  full[:, step, :256]).abs().max()))
    assert worst < 0.12, worst


@pytest.mark.parametrize("impls", [("xla", "ref"), ("flash", "pallas")])
def test_zamba_modules_with_converted_params_match_reference_f32(
        zamba_params, impls):
    """The first Mamba-2 block and the shared attention, with parameters
    carried by ``params_from_numpy``, on f32 inputs."""
    cfg, _ = _zamba(*impls)
    params = params_from_numpy(cfg, zamba_params, device=CPU)
    x = _normal(8, BATCH, SEQ, cfg.d_model)
    ref_block = jax.tree.map(lambda a: a[0, 0],
                             zamba_params["superblocks"])["mamba"]
    want = ref_ssm.mamba2_train(ref_block, jnp.asarray(x),
                                d_state=cfg.ssm_state,
                                head_dim=cfg.ssm_head_dim, impl=impls[1])
    got = ssm.mamba2_train(params["superblocks"][0][0]["mamba"],
                           torch.from_numpy(x), d_state=cfg.ssm_state,
                           head_dim=cfg.ssm_head_dim, impl=impls[1])
    _close(got, want)
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, rope_freqs=None,
              window=cfg.window, impl=impls[0])
    want = ref_attn.attention_train(zamba_params["shared"]["shared_attn"],
                                    jnp.asarray(x), **kw)
    got = attn.attention_train(params["shared"]["shared_attn"],
                               torch.from_numpy(x), **kw)
    _close(got, want)


def test_zamba_init_has_the_reference_shapes(zamba_params):
    cfg, _ = _zamba()
    params = build_model(cfg).init(torch.Generator().manual_seed(0), CPU)
    converted = params_from_numpy(cfg, zamba_params, device=CPU)
    assert jax.tree.map(lambda a: tuple(a.shape), params) == \
        jax.tree.map(lambda a: tuple(a.shape), converted)
    assert count_params(params) == sum(
        a.size for a in jax.tree_util.tree_leaves(zamba_params))
    assert param_bytes(params) == 4 * count_params(params)


def test_zamba_full_width_parameter_count():
    """81 blocks at d_model 3584: the port's tree has the reference's
    6.64 G parameters (both counted from shapes alone)."""
    cfg = get_config("zamba2-7b")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "meta")
    assert count_params(params["superblocks"][0][0]) == 77_978_064
    shapes = jax.eval_shape(ref_build(ref_config("zamba2-7b")).init,
                            jax.random.PRNGKey(0))
    want = sum(a.size for a in jax.tree_util.tree_leaves(shapes))
    assert count_params(params) == want
    assert 6.63e9 < want < 6.65e9


def test_serve_lm_counts_every_token():
    cfg, _ = _zamba()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), CPU)
    out = serve_lm(model, params, requests=3, batch=2, prompt_len=5,
                   max_tokens=4, seed=1, device=CPU)
    assert out["requests"] == 3
    assert out["tokens"] == 3 * (5 + 4)
    assert out["seconds"] > 0


def test_serve_cli_on_the_cpu(capsys):
    serve_main(["--device", "cpu", "--requests", "2", "--batch", "2",
                "--prompt-len", "4", "--max-tokens", "3"])
    assert "2 requests, 14 tokens" in capsys.readouterr().out
