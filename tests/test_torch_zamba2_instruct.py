"""The published Zamba2 layout (zamba2-7b-instruct) on the CPU, on seeded
random weights: the port's prefill and decode through its caches against
the plain f32 reference's full forward, the reference against
``transformers``' Zamba2, the full config's parameter count against
``transformers``' at the catalog's numbers, and zamba2-7b (the stand-in)
untouched by the new layout's code."""
from __future__ import annotations

import dataclasses
import hashlib
import os

import pytest
import torch

from repro_torch.configs import ARCH_IDS, ModelConfig, Zamba2Config, get_config
from repro_torch.launch.serve import serve_batch
from repro_torch.models import (build_model, count_params,
                                params_from_zamba2_state_dict)
from repro_torch.models import zamba2_reference as ref
from repro_torch.tree import leaves

CPU = torch.device("cpu")
P, G = 9, 4                  # prompt, then forced decode steps


def config_of(cfg: Zamba2Config) -> dict:
    """The ``config.json`` numbers of a port config."""
    return {"hidden_size": cfg.d_model, "num_hidden_layers": cfg.num_layers,
            "vocab_size": cfg.vocab_size,
            "hybrid_layer_ids": list(cfg.hybrid_layer_ids),
            "num_mem_blocks": cfg.num_mem_blocks,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "attention_head_dim": cfg.resolved_head_dim,
            "attention_hidden_size": 2 * cfg.d_model,
            "intermediate_size": cfg.d_ff, "adapter_rank": cfg.adapter_rank,
            "mamba_expand": 2,
            "n_mamba_heads": 2 * cfg.d_model // cfg.ssm_head_dim,
            "mamba_headdim": cfg.ssm_head_dim,
            "mamba_ngroups": cfg.mamba_ngroups,
            "mamba_d_state": cfg.ssm_state, "mamba_d_conv": 4,
            "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta}


def random_state_dict(cfg: dict, seed: int, device="cpu",
                      dtype: torch.dtype = torch.float32) -> dict:
    """Normals at each weight's fan-in scale, the dt rows of ``in_proj`` at
    a tenth of it; norms near 1, conv bias and D near 0 and 1; A_log and
    dt_bias as the model inits them (A = 1 .. H, dt log-uniform, here in
    [0.01, 0.1], so that softplus(dt + dt_bias) stays above time_step_min,
    1e-3, where ``transformers``' plain path would clamp it)."""
    g = torch.Generator(device=device).manual_seed(seed)
    heads = cfg["n_mamba_heads"]
    sd = {}
    for name, shape in ref.state_dict_shapes(cfg).items():
        x = torch.randn(shape, generator=g, device=device)
        if name.endswith("A_log"):
            x = torch.log(torch.arange(1, shape[0] + 1, dtype=torch.float32,
                                       device=device))
        elif name.endswith("dt_bias"):
            dt = 0.01 * 10 ** torch.rand(shape, generator=g, device=device)
            x = dt + torch.log(-torch.expm1(-dt))
        elif name.endswith(("conv1d.bias", ".D")):
            x = 0.1 * x + (1.0 if name.endswith(".D") else 0.0)
        elif len(shape) == 1:
            x = 1.0 + 0.1 * x
        elif name.endswith("conv1d.weight"):
            x = 0.5 * x
        else:
            x = x * shape[-1] ** -0.5
            if name.endswith("in_proj.weight"):
                x[-heads:] *= 0.1
        sd[name] = x.to(dtype)
    return sd


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("zamba2-7b-instruct").reduced()
    sd = random_state_dict(config_of(cfg), seed=3)
    g = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (3, P + G), generator=g)
    return cfg, sd, tokens


def test_the_config_is_registered_beside_the_assigned_ones():
    cfg = get_config("zamba2-7b-instruct")
    assert "zamba2-7b-instruct" not in ARCH_IDS
    assert isinstance(cfg, Zamba2Config) and cfg.mamba_ngroups == 2
    assert len(cfg.hybrid_layer_ids) == 13 and cfg.num_mem_blocks == 2
    small = cfg.reduced()
    # every kind of work: both blocks, one of them twice, two groups
    assert len(small.hybrid_layer_ids) >= 3 and small.mamba_ngroups == 2


@pytest.mark.parametrize("mixer_impl", ["pallas", "ref"])
def test_prefill_and_decode_match_the_reference(tiny, mixer_impl):
    """serve_batch (prefill through the kernels' wrappers, which run the
    plain versions on CPU tensors, then decode through the caches) against
    the reference's full forward over prompt plus forced tokens, in f32.
    Gate 1e-4 of the logits' RMS: both are f32 and sum in other orders
    (the sequential SSD and its caches against 64-step chunks, attention
    through a cache against a full softmax), and the layers amplify a
    rounding: the f32 reference itself reads 1.6e-5 from an f64 run of
    itself, the port 1.5e-5 from the f32 reference, and 1e-7 relative
    noise on the weights moves the logits 2e-5; a part left out reads
    1e-3 or more (test_a_changed_part_moves_the_logits)."""
    cfg, sd, tokens = tiny
    cfg = dataclasses.replace(cfg, mixer_impl=mixer_impl)
    model = build_model(cfg)
    params = params_from_zamba2_state_dict(cfg, sd)
    with torch.no_grad():
        got, spans = serve_batch(model, params, tokens[:, :P], tokens[:, P:],
                                 launch=7)
    want = ref.forward(sd, tokens, config_of(cfg), keep_from=P - 1)
    assert got.shape == want.shape == (3, G + 1, cfg.vocab_size)
    rms = float(want.pow(2).mean().sqrt())
    assert float((got - want).abs().max()) / rms < 1e-4
    assert [s.name for s in spans] == ["launch", "prefill", "decode"]
    launch, prefill, decode = spans
    assert all(s.launch == 7 for s in spans)
    assert prefill.count("tokens") == 3 * P
    assert (decode.count("steps"), decode.count("tokens")) == (G, 3 * G)
    # on the CPU the decode steps run eagerly: no graph, no kernel
    assert (launch.count("graph_captures"), decode.count("graph_steps"),
            decode.count("attn_kernel_launches")) == (0, 0, 0)
    assert launch.start <= prefill.start < prefill.end <= decode.start
    assert decode.end <= launch.end
    # the K/V rings, their int64 positions, the Mamba states and convs
    rings, hd = len(cfg.hybrid_layer_ids), cfg.resolved_head_dim
    kv = rings * 2 * 3 * cfg.num_kv_heads * (P + G) * hd * 4
    heads = 2 * cfg.d_model // cfg.ssm_head_dim
    conv = 2 * cfg.d_model + 2 * cfg.mamba_ngroups * cfg.ssm_state
    ssm = cfg.num_layers * 3 * 4 * (
        heads * cfg.ssm_state * cfg.ssm_head_dim + 3 * conv)
    assert launch.count("cache_bytes") == kv + 8 * rings + ssm


@pytest.mark.parametrize("window", [None, 4])
def test_attention_decode_takes_its_position_on_the_device(window):
    """``len`` as a 0-dim int64 tensor (what a replayed CUDA graph reads)
    against the Python int: the same outputs and rings bit for bit, in
    f32, over steps that fill the 6-slot ring, reach its last slot and
    wrap, with and without a window; the tensor is the cache's position,
    advanced in place."""
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import rope_frequencies

    B, d, H, Hkv, D, slots = 2, 24, 4, 2, 8, 6
    p = attn.init_attention(torch.Generator().manual_seed(5), d, H, Hkv, D,
                            device=CPU)
    kw = dict(num_heads=H, num_kv_heads=Hkv, head_dim=D, window=window,
              rope_freqs=rope_frequencies(D), scale=(D / 2) ** -0.5)
    on_int = attn.init_kv_cache(B, Hkv, slots, D, device=CPU,
                                dtype=torch.float32)
    on_dev = dict(attn.init_kv_cache(B, Hkv, slots, D, device=CPU,
                                     dtype=torch.float32),
                  len=torch.zeros((), dtype=torch.int64))
    pos = on_dev["len"]
    x = torch.randn(slots + 3, B, 1, d,
                    generator=torch.Generator().manual_seed(6))
    for t in range(slots + 3):
        want, on_int = attn.attention_decode(p, x[t], on_int, **kw)
        got, on_dev = attn.attention_decode(p, x[t], on_dev, **kw)
        assert torch.equal(got, want)
        assert torch.equal(on_dev["k"], on_int["k"])
        assert torch.equal(on_dev["v"], on_int["v"])
        assert on_dev["len"] is pos and int(pos) == on_int["len"] == t + 1


@pytest.mark.parametrize("mixer_impl", ["pallas", "ref"])
def test_decode_step_takes_its_position_on_the_device(tiny, mixer_impl):
    """The tiny layout's decode_step from one prefill, each ring's ``len``
    a 0-dim tensor against the Python int: the logits and the advanced
    caches bit for bit over G steps."""
    cfg, sd, tokens = tiny
    cfg = dataclasses.replace(cfg, mixer_impl=mixer_impl)
    model = build_model(cfg)
    params = params_from_zamba2_state_dict(cfg, sd)

    def rings(cache, pos):
        return [dict(c, k=c["k"].clone(), v=c["v"].clone(), len=pos(c))
                for c in cache["attn"]]

    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": tokens[:, :P]},
                                 model.init_cache(3, P + G, device=CPU,
                                                  dtype=torch.float32))
        on_int = {"attn": rings(cache, lambda c: int(c["len"])),
                  "mamba": cache["mamba"]}
        on_dev = {"attn": rings(cache, lambda c: c["len"].clone()),
                  "mamba": cache["mamba"]}
        for i in range(P, P + G):
            want, on_int = model.decode_step(params, tokens[:, i:i + 1],
                                             on_int)
            got, on_dev = model.decode_step(params, tokens[:, i:i + 1],
                                            on_dev)
            assert torch.equal(got, want)
    for a, b in zip(on_dev["attn"], on_int["attn"]):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
        assert int(a["len"]) == b["len"] == P + G
    for a, b in zip(on_dev["mamba"], on_int["mamba"]):
        assert all(torch.equal(a[n], b[n]) for n in a)


def test_one_cache_serves_batch_after_batch(tiny):
    """``init_cache`` gives each ring's position as a 0-dim int64 tensor.
    One cache, prefilled with prompts A and stepped G times, then
    prefilled with prompts B and stepped G times, gives a fresh cache's
    logits and caches bit for bit each time, its positions P after each
    prefill and P + G after the steps, its rings and positions the same
    tensors throughout: what serve_batch's held decode graph relies on."""
    cfg, sd, tokens = tiny
    model = build_model(cfg)
    params = params_from_zamba2_state_dict(cfg, sd)
    other = torch.randint(0, cfg.vocab_size, tokens.shape,
                          generator=torch.Generator().manual_seed(8))

    def fresh():
        return model.init_cache(3, P + G, device=CPU, dtype=torch.float32)

    def served(cache, toks):
        last, cache = model.prefill(params, {"tokens": toks[:, :P]}, cache)
        assert [int(c["len"]) for c in cache["attn"]] == [P] * 3
        out = [last]
        for i in range(P, P + G):
            step, cache = model.decode_step(params, toks[:, i:i + 1], cache)
            out.append(step)
        assert [int(c["len"]) for c in cache["attn"]] == [P + G] * 3
        return torch.stack(out, dim=1), cache

    held = fresh()
    rings = [leaf for c in held["attn"] for leaf in c.values()]
    assert all(c["len"].shape == () and c["len"].dtype == torch.int64
               for c in held["attn"])
    with torch.no_grad():
        for toks in (tokens, other):
            got, held = served(held, toks)
            want, cache = served(fresh(), toks)
            assert torch.equal(got, want)
            assert all(torch.equal(a, b)
                       for a, b in zip(leaves(held), leaves(cache)))
            assert all(a is b for a, b in zip(
                rings, [leaf for c in held["attn"] for leaf in c.values()]))
    assert not torch.equal(got, served(fresh(), tokens)[0])


def test_the_forward_agrees_with_prefill_and_decode(tiny):
    """Model.forward (no cache) at every position against the reference,
    under the gate of test_prefill_and_decode_match_the_reference."""
    cfg, sd, tokens = tiny
    model = build_model(cfg)
    params = params_from_zamba2_state_dict(cfg, sd)
    with torch.no_grad():
        got, _ = model.forward(params, {"tokens": tokens})
    want = ref.forward(sd, tokens, config_of(cfg))
    rms = float(want.pow(2).mean().sqrt())
    assert float((got - want).abs().max()) / rms < 1e-4


@pytest.mark.parametrize("part", ["adapter", "linear", "embedding_input",
                                  "second_block", "group"])
def test_a_changed_part_moves_the_logits(tiny, part):
    """Each part of the layout reaches the logits: the port and the
    reference both change when it does (so the agreement above is not of
    two functions that leave it out)."""
    cfg, sd, tokens = tiny
    ids = cfg.hybrid_layer_ids
    sd2 = dict(sd)
    if part == "adapter":
        name = (f"model.layers.{ids[0]}.shared_transformer.feed_forward."
                f"gate_up_proj_adapter_list.2.1.weight")
        sd2[name] = sd[name] * 0
    elif part == "linear":
        name = f"model.layers.{ids[1]}.linear.weight"
        sd2[name] = sd[name] * 0.5
    elif part == "embedding_input":
        name = f"model.layers.{ids[0]}.shared_transformer.input_layernorm" \
            ".weight"
        sd2[name] = torch.cat([sd[name][:cfg.d_model],
                               sd[name][cfg.d_model:] * 0])
    elif part == "second_block":
        name = (f"model.layers.{ids[1]}.shared_transformer.self_attn."
                f"v_proj.weight")
        sd2[name] = torch.flip(sd[name], [0])
    else:
        name = f"model.layers.{ids[0]}.mamba_decoder.mamba.in_proj.weight"
        w = sd[name].clone()
        d_in = 2 * cfg.d_model
        n = cfg.ssm_state
        # group 1's B rows swapped with group 0's
        b0 = 2 * d_in
        w[b0:b0 + n], w[b0 + n:b0 + 2 * n] = (sd[name][b0 + n:b0 + 2 * n],
                                              sd[name][b0:b0 + n])
        sd2[name] = w
    model = build_model(cfg)
    with torch.no_grad():
        one, _ = model.forward(params_from_zamba2_state_dict(cfg, sd),
                               {"tokens": tokens})
        two, _ = model.forward(params_from_zamba2_state_dict(cfg, sd2),
                               {"tokens": tokens})
    want = ref.forward(sd2, tokens, config_of(cfg))
    rms = float(want.pow(2).mean().sqrt())
    assert float((two - one).abs().max()) / rms > 1e-3
    assert float((two - want).abs().max()) / rms < 1e-4


def _transformers_model(cfg: Zamba2Config, device="cpu"):
    # transformers would import TensorFlow too (8 s), which no test here
    # uses
    os.environ.setdefault("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    c = config_of(cfg)
    n = cfg.num_layers
    hf = transformers.Zamba2Config(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
        num_hidden_layers=n,
        layers_block_type=["hybrid" if i in cfg.hybrid_layer_ids else
                           "mamba" for i in range(n)],
        mamba_d_state=cfg.ssm_state, mamba_d_conv=4, mamba_expand=2,
        mamba_ngroups=cfg.mamba_ngroups, n_mamba_heads=c["n_mamba_heads"],
        intermediate_size=cfg.d_ff, hidden_act="gelu",
        num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads,
        num_mem_blocks=cfg.num_mem_blocks,
        use_shared_attention_adapter=False, adapter_rank=cfg.adapter_rank,
        use_mem_rope=True, rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.norm_eps, tie_word_embeddings=True,
        use_long_context=False, chunk_size=256)
    hf._attn_implementation = "eager"
    with torch.device(device):
        return transformers.Zamba2ForCausalLM(hf)


def test_the_reference_matches_transformers_zamba2(tiny):
    """The same weights by state-dict name in ``transformers``' Zamba2
    (its plain-torch path, eager attention, f32): the logits agree within
    1e-4 of their RMS, the gate of the port against the reference (the
    reading is 1.1e-5: the two sum the SSD in other chunk orders)."""
    cfg, sd, tokens = tiny
    model = _transformers_model(cfg).eval()
    named = dict(model.named_parameters())
    assert set(named) == set(sd)
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(sd[name])
        want = model(input_ids=tokens, use_cache=False).logits
    got = ref.forward(sd, tokens, config_of(cfg))
    rms = float(want.pow(2).mean().sqrt())
    assert float((got - want).abs().max()) / rms < 1e-4


def test_the_full_parameter_count_equals_transformers():
    """At the catalog's numbers, on the meta device: the port's tree and
    ``transformers``' model hold the same parameters (7,356,749,648, tied),
    under the names and shapes the reference reads."""
    cfg = get_config("zamba2-7b-instruct")
    params = build_model(cfg).init(torch.Generator(), "meta")
    model = _transformers_model(cfg, device="meta")
    theirs = sum(p.numel() for p in model.parameters())
    assert count_params(params) == theirs == 7356749648
    shapes = ref.state_dict_shapes(config_of(cfg) | {"mamba_d_conv": 4})
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == shapes


# zamba2-7b reduced, seed 0, one CPU thread, read on the tree before the
# published layout went in: sha256 of its parameters' bytes (every leaf in
# order), of its forward's logits over tokens 0..23 as (2, 12) and of 4
# decode steps' logits
UNTOUCHED = (
    170144,
    "647e64d92fd121514b1e3a5b3c5d1d4c6f6bd73a14a2aa10bcd64b3e6d2ad769",
    "15f92750aca252b4de5ec403229c291a33faa4a98970ef290b3e827f47f5dc65",
    "35151c95c975af7bc7b8a46834a23b7fe2c1abc45c88227917b19bddeb9ffd3f")


@pytest.mark.parametrize("impls", [("flash", "pallas"), ("xla", "ref")])
def test_zamba2_7b_is_untouched_by_the_new_layout(impls):
    """The stand-in keeps its config's fields (no field of the published
    layout), and its parameters and logits, forward and decode, bit for
    bit as they were read before the layout's code went in."""
    cfg = get_config("zamba2-7b")
    assert type(cfg) is ModelConfig
    small = dataclasses.replace(cfg.reduced(), attn_impl=impls[0],
                                mixer_impl=impls[1])
    model = build_model(small)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params = model.init(torch.Generator().manual_seed(0), CPU)
        tokens = torch.arange(24).reshape(2, 12) % small.vocab_size
        with torch.no_grad():
            logits, _ = model.forward(params, {"tokens": tokens})
            cache = model.init_cache(2, 16, device=CPU)
            steps = []
            for i in range(4):
                step, cache = model.decode_step(params, tokens[:, i:i + 1],
                                                cache)
                steps.append(step)
    finally:
        torch.set_num_threads(threads)
    h = hashlib.sha256()
    for t in leaves(params):
        h.update(t.detach().contiguous().numpy().tobytes())
    assert (count_params(params), h.hexdigest(), _sha(logits),
            _sha(torch.stack(steps, 1))) == UNTOUCHED


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()
