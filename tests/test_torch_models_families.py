"""The port's dense, MoE, VLM, xLSTM and whisper families against the
reference, on the CPU.

Parameters come from the reference's initialisers through numpy
(``params_from_numpy``), inputs from a numpy seed, so both packages
compute with the same values. Tolerances:

- layers, the MoE layer, mLSTM and sLSTM on f32 inputs: 1e-4 (another
  order of f32 sums); the MoE layer's aux loss and its drop decisions
  exactly;
- each whole model in f32 (both packages' ``embed`` return f32, so the
  residual stream stays f32): 5e-5 on logits of size 4 (the largest seen
  is 8e-6);
- each whole model as served (bf16 residual stream): 0.1. Single bf16
  roundings flip where the two packages sum in another order, and four
  layers carry the flips forward: up to 0.072 (xlstm-1.3b, whose sLSTM
  steps 48 times); the reference's ``forward`` is compiled with
  ``xla_allow_excess_precision`` off (see ``test_torch_models.py``);
- decode against the model's own forward: 0.12, the bound of the
  reference's own ``test_decode_matches_forward``.
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
from repro.models import build_model as ref_build
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models import xlstm as ref_xlstm
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import layers, moe, xlstm

CPU = torch.device("cpu")
ARCHS = ["qwen3-0.6b", "qwen1.5-110b", "h2o-danube3-4b", "minicpm-2b",
         "internvl2-1b", "phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b",
         "xlstm-1.3b", "whisper-medium"]
B, T = 2, 48                 # h2o's reduced window is 32: its ring wraps


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- layers -----------------------------------------------------------------

def test_layernorm_matches_reference_f32():
    x = _normal(1, 2, 5, 32) * 3 + 1
    p = {"scale": jnp.asarray(1 + 0.1 * _normal(2, 32)),
         "bias": jnp.asarray(_normal(3, 32))}
    _close(layers.layernorm(_torch(p), torch.from_numpy(x)),
           ref_layers.layernorm(p, jnp.asarray(x)))
    assert _torch(ref_layers.init_layernorm(8)).keys() == \
        layers.init_layernorm(8, CPU).keys()


def test_gelu_mlp_matches_reference_f32():
    p = ref_layers.init_gelu_mlp(jax.random.PRNGKey(4), 32, 48)
    p["wi"]["bias"] = jnp.asarray(_normal(5, 48))
    p["wo"]["bias"] = jnp.asarray(_normal(6, 32))
    x = _normal(7, 2, 5, 32)
    _close(layers.gelu_mlp(_torch(p), torch.from_numpy(x)),
           ref_layers.gelu_mlp(p, jnp.asarray(x)))
    got = layers.init_gelu_mlp(torch.Generator().manual_seed(0), 32, 48,
                               device=CPU)
    assert jax.tree.map(lambda a: tuple(a.shape), got) == \
        jax.tree.map(lambda a: tuple(a.shape), _torch(p))


@pytest.mark.parametrize("seq,d,offset", [(16, 64, 0), (5, 32, 0),
                                          (1, 64, 1499)])
def test_sinusoidal_positions_match_reference(seq, d, offset):
    want = ref_layers.sinusoidal_positions(offset + seq, d)[offset:]
    _close(layers.sinusoidal_positions(seq, d, offset=offset), want, 1e-6)


# -- MoE --------------------------------------------------------------------

def _reference_dispatch(p, xf, num_experts, top_k, capacity_factor):
    """The reference's drop decisions, from its own router and top-k."""
    logits = ref_layers.dense(p["router"], jnp.asarray(xf))
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    flat = np.asarray(idx).reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=num_experts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(flat.size) - starts[flat[order]]
    capacity = max(1, int(capacity_factor * xf.shape[0] * top_k
                          / num_experts))
    return np.repeat(np.arange(xf.shape[0]), top_k)[order], \
        rank < capacity


@pytest.mark.parametrize("capacity_factor", [0.5, 1.0])
def test_moe_layer_matches_reference_where_capacity_overflows(
        capacity_factor):
    d, ff, E, k = 32, 48, 4, 2
    p = ref_moe.init_moe(jax.random.PRNGKey(8), d, ff, E)
    x = _normal(9, 2, 24, d)
    want, want_aux = ref_moe.moe_layer(p, jnp.asarray(x), num_experts=E,
                                       top_k=k,
                                       capacity_factor=capacity_factor)
    pt = _torch(p)
    got, aux = moe.moe_layer(pt, torch.from_numpy(x), num_experts=E,
                             top_k=k, capacity_factor=capacity_factor)
    _close(got, want)
    assert float(aux) == float(want_aux)
    route = moe.route(pt, torch.from_numpy(x).reshape(-1, d),
                      num_experts=E, top_k=k,
                      capacity_factor=capacity_factor)
    tokens, keep = _reference_dispatch(p, x.reshape(-1, d), E, k,
                                       capacity_factor)
    assert np.array_equal(route["sorted_token"].numpy(), tokens)
    assert np.array_equal(route["keep"].numpy(), keep)
    assert not keep.all()                       # capacity overflowed
    # a token with every pair dropped passes through as exact zeros
    gone = np.setdiff1d(np.arange(48), tokens[keep])
    assert not got.reshape(-1, d)[gone].any()
    assert not np.asarray(want).reshape(-1, d)[gone].any()


def test_moe_layer_bf16_sums_as_the_reference():
    """bf16 activations: the gate-weighted outputs are summed in f32 and
    rounded once, as the reference's compiled scatter-add sums them; the
    two agree within one bf16 ulp of the output's scale (a pair that
    nearly cancels can round apart)."""
    d, ff, E, k = 64, 64, 4, 2
    p = ref_moe.init_moe(jax.random.PRNGKey(0), d, ff, E)
    x = _normal(0, 2, 32, d)
    fn = jax.jit(lambda p, x: ref_moe.moe_layer(p, x, num_experts=E,
                                                top_k=k))
    xb = jnp.asarray(x, jnp.bfloat16)
    want, want_aux = fn.lower(p, xb).compile(compiler_options={
        "xla_allow_excess_precision": False})(p, xb)
    got, aux = moe.moe_layer(_torch(p), torch.from_numpy(x).bfloat16(),
                             num_experts=E, top_k=k)
    assert got.dtype == torch.bfloat16
    assert float(aux) == float(want_aux)
    assert float(np.abs(got.float().numpy()
                        - np.asarray(want, np.float32)).max()) <= 2 ** -7


# -- xLSTM ------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_mlstm_train_matches_reference_f32(impl):
    d, heads = 32, 2
    p = ref_xlstm.init_mlstm(jax.random.PRNGKey(10), d, heads)
    x = _normal(11, 2, 40, d)
    want = ref_xlstm.mlstm_train(p, jnp.asarray(x), num_heads=heads,
                                 impl=impl)
    got = xlstm.mlstm_train(_torch(p), torch.from_numpy(x), num_heads=heads,
                            impl=impl)
    _close(got, want)


def test_mlstm_decode_matches_reference_f32():
    d, heads = 32, 2
    p = ref_xlstm.init_mlstm(jax.random.PRNGKey(12), d, heads)
    pt = _torch(p)
    jc = ref_xlstm.init_mlstm_cache(2, d, heads)
    tc = xlstm.init_mlstm_cache(2, d, heads, device=CPU)
    for step in range(6):
        x = _normal(30 + step, 2, 1, d)
        want, jc = ref_xlstm.mlstm_decode(p, jnp.asarray(x), jc,
                                          num_heads=heads)
        got, tc = xlstm.mlstm_decode(pt, torch.from_numpy(x), tc,
                                     num_heads=heads)
        _close(got, want)
    _close(tc["C"], jc["C"])
    _close(tc["n"], jc["n"])


def test_slstm_train_and_decode_match_reference_f32():
    d, heads = 32, 4
    p = ref_xlstm.init_slstm(jax.random.PRNGKey(13), d, heads)
    pt = _torch(p)
    x = _normal(14, 2, 12, d)
    _close(xlstm.slstm_train(pt, torch.from_numpy(x), num_heads=heads),
           ref_xlstm.slstm_train(p, jnp.asarray(x), num_heads=heads))
    js = ref_xlstm.init_slstm_state(2, d, heads)
    ts = xlstm.init_slstm_state(2, d, heads, device=CPU)
    for step in range(5):
        xs = x[:, step:step + 1]
        want, js = ref_xlstm.slstm_decode(p, jnp.asarray(xs), js,
                                          num_heads=heads)
        got, ts = xlstm.slstm_decode(pt, torch.from_numpy(xs), ts,
                                     num_heads=heads)
        _close(got, want)
    for key in ("c", "n", "h"):
        _close(ts[key], js[key])


def _plain_slstm(pre, mixes, c, n, h):
    """The sLSTM's steps as the reference writes them, through autograd:
    pre (T, H, B, 4 hd) [z, i, f, o], mixes (H, hd, 4 hd)."""
    hd, hs = mixes.shape[1], []
    for t in range(pre.shape[0]):
        a = pre[t] + torch.bmm(h, mixes)
        z = torch.tanh(a[..., :hd])
        i, f, o = torch.sigmoid(a[..., hd:]).split(hd, dim=-1)
        c = f * c + i * z
        n = f * n + i
        h = o * c / torch.clamp(n, min=1.0)
        hs.append(h)
    return torch.stack(hs), c, n


def test_slstm_recurrence_backward_is_autograd_of_its_steps():
    """The sLSTM's time scan (in place, with a backward through time
    written out) in f64: its outputs equal the steps', its gradients of
    pre, the mixes and the initial state are within 1e-12 of autograd's
    through them, with normalisers on both sides of the clamp at 1, and
    pass ``gradcheck``."""
    rng = np.random.default_rng(12)
    T, H, B, hd = 7, 2, 3, 4

    def arr(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale
                                + shift).requires_grad_()

    args = (arr(T, H, B, 4 * hd, scale=2.0), arr(H, hd, 4 * hd, scale=0.5),
            arr(H, B, hd), arr(H, B, hd, scale=0.6, shift=1.0),
            arr(H, B, hd))
    assert (args[3] < 1).any() and (args[3] > 1).any()
    weights = [torch.from_numpy(rng.standard_normal(o.shape))
               for o in _plain_slstm(*args)]
    got, want = xlstm._Recurrence.apply(*args), _plain_slstm(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    grads = [torch.autograd.grad(sum((o * w).sum() for o, w in
                                     zip(out, weights)), args)
             for out in (got, want)]
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-12
    assert torch.autograd.gradcheck(xlstm._Recurrence.apply, args)


@pytest.mark.parametrize("T", [6, 7])
def test_slstm_scan_without_a_gradient_keeps_no_history(monkeypatch, T):
    """With no gradient to take (prefill, decode) the sLSTM scan keeps c
    and n in two slots and the gates in one: its h, c and n equal the
    scan's that keeps what the backward pass reads, at an even and an odd
    T, and the recurrence takes it, not :class:`_Recurrence`, under
    ``no_grad``."""
    rng = np.random.default_rng(13)
    H, B, hd = 2, 3, 4
    args = [torch.from_numpy(rng.standard_normal(shape)) for shape in
            ((T, H, B, 4 * hd), (H, hd, 4 * hd), (H, B, hd), (H, B, hd),
             (H, B, hd))]
    args[3] = args[3] * 0.6 + 1.0
    hs, c, n, saved = xlstm._scan(*args)
    lean = xlstm._scan(*args, history=False)
    assert saved is not None and lean[3] is None
    assert all(torch.equal(a, b) for a, b in zip((hs, c, n), lean[:3]))

    def refused(*_):
        raise AssertionError("no gradient to take: no history")

    monkeypatch.setattr(xlstm._Recurrence, "apply", refused)
    pre, mixes = (a.clone().requires_grad_() for a in args[:2])
    with torch.no_grad():
        got = xlstm._recurrence(pre, mixes, dict(zip("cnh", args[2:])))
    assert all(torch.equal(a, b) for a, b in zip(got, (hs[1:], c, n)))


# -- each family as a whole -------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    return jax.tree.map(np.asarray, ref_build(ref_config(arch).reduced())
                        .init(jax.random.PRNGKey(0)))


def _batches(cfg, dtype):
    """The same inputs for both packages: (jax batch, torch batch)."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.from_numpy(tokens).long()}
    if cfg.family == "encdec":
        frames = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))
        jb["frames"] = jnp.asarray(frames, jnp.dtype(dtype))
        tb["frames"] = torch.from_numpy(frames).to(getattr(torch, dtype))
    if cfg.family == "vlm":
        ve = rng.normal(size=(B, cfg.vision_tokens, cfg.d_model))
        jb["vision_embeds"] = jnp.asarray(ve, jnp.float32)
        tb["vision_embeds"] = torch.from_numpy(ve).float()
    return jb, tb


def _forwards(arch, attn_impl, mixer_impl, dtype):
    """Both packages' logits and aux (the reference's attention is its
    plain ``xla`` one: its Pallas flash attends padded keys without a
    causal mask, ROADMAP queue 3)."""
    ref_cfg = dataclasses.replace(ref_config(arch).reduced(),
                                  attn_impl="xla", mixer_impl=mixer_impl)
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              attn_impl=attn_impl, mixer_impl=mixer_impl)
    tree = _reference_params(arch)
    jb, tb = _batches(cfg, dtype)
    fwd = jax.jit(ref_build(ref_cfg).forward).lower(tree, jb).compile(
        compiler_options={"xla_allow_excess_precision": False})
    want, want_aux = fwd(tree, jb)
    got, aux = build_model(cfg).forward(
        params_from_numpy(cfg, tree, device=CPU), tb)
    return cfg, got, aux, np.asarray(want), float(want_aux)


@pytest.fixture
def f32_stream(monkeypatch):
    """Both packages' model builders embed tokens in f32."""
    monkeypatch.setattr(ref_model_mod, "embed", functools.partial(
        ref_model_mod.embed, dtype=jnp.float32))
    monkeypatch.setattr(model_mod, "embed", functools.partial(
        model_mod.embed, dtype=torch.float32))


@pytest.mark.parametrize("impls", [("xla", "ref"), ("flash", "pallas")])
@pytest.mark.parametrize("arch", ARCHS)
def test_family_forward_matches_reference_f32(f32_stream, arch, impls):
    cfg, got, aux, want, want_aux = _forwards(arch, *impls, "float32")
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) < 5e-5
    assert float(aux) == pytest.approx(want_aux, abs=1e-6)
    if cfg.family != "moe":
        assert want_aux == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_family_forward_matches_reference_as_served(arch):
    _, got, _, want, _ = _forwards(arch, "flash", "pallas", "bfloat16")
    assert float(np.abs(got.numpy() - want).max()) < 0.1


@pytest.mark.parametrize("arch", ARCHS)
def test_family_decode_matches_its_forward(arch):
    """Decode one token at a time (a VLM's decode is text-only, as the
    reference's test has it; MoE at capacity factor 8 in the forward, so
    that neither path drops a token)."""
    cfg = get_config(arch).reduced()
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    model = build_model(cfg)
    params = params_from_numpy(cfg, _reference_params(arch), device=CPU)
    _, batch = _batches(cfg, "bfloat16")
    batch.pop("vision_embeds", None)
    full, _ = model.forward(params, batch)
    cache = model.init_cache(B, T, device=CPU)
    if model.prefill is not None:
        cache = model.prefill(params, batch, cache)
    V, worst = cfg.vocab_size, 0.0
    for t in range(T):
        logits, cache = model.decode_step(params,
                                          batch["tokens"][:, t:t + 1], cache)
        if logits.shape[-1] > V:
            assert bool(torch.isinf(logits[:, V:]).all())
        worst = max(worst, float((logits[:, :V] - full[:, t, :V])
                                 .abs().max()))
    assert worst < 0.12, worst
