"""The LM kernels' plain versions against the reference, on the CPU.

The same numpy arrays go through the port's wrappers (which run the plain
versions for CPU tensors), the reference's oracles (``repro.kernels.ref``)
and its Pallas kernels in interpret mode, as ``tests/test_kernels.py``
runs them. Tolerances are the reference's own: f32 flash 2e-5, bf16 flash
5e-2, linear attention 3e-4; the bf16 flash kernel's rounding, rebuilt
here in plain torch, is held to the card's gates (2e-2 abs, 1e-2
relative L2 per query row). The CUDA kernels
themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.linear_attention import (
    linear_attention as pallas_linear_attention)
from repro_torch.kernels import (flash_attention, flash_attention_plain,
                                 linear_attention, linear_attention_plain)

B, T = 2, 64


def _qkv(seed, hq, hkv, t, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, hq, t, d)).astype(np.float32),
            rng.normal(size=(B, hkv, t, d)).astype(np.float32),
            rng.normal(size=(B, hkv, t, d)).astype(np.float32))


def _port(fn, arrays, **kw):
    return fn(*(torch.from_numpy(a) for a in arrays), **kw).numpy()


@pytest.mark.parametrize("d", [16, 64, 112])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 32),
                                           (False, None)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
def test_flash_plain_matches_reference_f32(hq, hkv, causal, window, d):
    arrays = _qkv(hq * 100 + d, hq, hkv, T, d)
    before = flash_attention.launches
    got = _port(flash_attention, arrays, causal=causal, window=window)
    assert flash_attention.launches == before   # CPU: the plain version
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    want = np.asarray(ref.attention(jq, jk, jv, causal=causal,
                                    window=window))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    pallas = np.asarray(pallas_flash(jq, jk, jv, causal=causal,
                                     window=window, bq=32, bk=32))
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (False, 48)])
def test_flash_plain_matches_reference_bf16(causal, window):
    arrays = _qkv(7, 4, 2, 128, 128)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    for want in (ref.attention(jq, jk, jv, causal=causal, window=window),
                 pallas_flash(jq, jk, jv, causal=causal, window=window)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=5e-2, atol=5e-2)


def _tensor_core_rounding(q, k, v, *, causal, window, block=64):
    """The bf16 CUDA kernel's arithmetic in plain torch on the CPU
    (``csrc/flash_attention.cu``, namespace ``tc``): raw scores from the
    bf16 inputs in f32, the scale applied to the f32 scores, an online
    softmax over 64-key tiles in base 2, P rounded to bf16 before P V, the
    row sum over the rounded P, the output rounded to bf16."""
    B, Hq, T, D = q.shape
    G = Hq // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    sl2 = D ** -0.5 * 1.4426950408889634
    i = torch.arange(T)[:, None]
    m = torch.full((B, Hq, T, 1), float("-inf"))
    l = torch.zeros(B, Hq, T, 1)
    o = torch.zeros(B, Hq, T, D)
    for k0 in range(0, T, block):
        j = torch.arange(k0, min(T, k0 + block))[None, :]
        s = qf @ kf[:, :, k0:k0 + block].transpose(-1, -2)
        ok = torch.ones(T, j.shape[1], dtype=torch.bool)
        if causal:
            ok &= j <= i
        if window is not None:
            ok &= i - j < window
        s = s.masked_fill(~ok, float("-inf"))
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(mx == float("-inf"), 0.0, mx * sl2)
        corr = torch.exp2(m * sl2 - base)
        p = torch.exp2(s * sl2 - base).to(torch.bfloat16).float()
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + p @ vf[:, :, k0:k0 + block]
        m = mx
    return (o / torch.where(l > 0, l, 1.0)).to(torch.bfloat16)


@pytest.mark.parametrize("d", [64, 112, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_flash_tensor_core_rounding_within_card_gate(hq, hkv, causal,
                                                      window, d):
    """The bf16 kernel's one extra rounding (P in bf16 before P V) keeps it
    within the 2e-2 gate the card holds it to, against ``ref.attention``
    on the same bf16 inputs: the chip-smoke shapes scaled down to T = 200
    (ragged against the 64-key tile), zamba's D 112, qwen3's D 128 and
    GQA, whisper's non-causal D 64, a window shorter than a tile."""
    arrays = _qkv(hq * 10 + d, hq, hkv, 200, d)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = _tensor_core_rounding(q, k, v, causal=causal, window=window)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    want = np.asarray(ref.attention(jq, jk, jv, causal=causal,
                                    window=window), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)
    # and within the same gates of the plain version the card compares
    # with: 2e-2 abs, and 1e-2 relative L2 for every query row
    plain = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), plain.float(), rtol=2e-2,
                               atol=2e-2)
    row_rel = ((got.float() - plain.float()).norm(dim=-1)
               / plain.float().norm(dim=-1))
    assert float(row_rel.max()) <= 1e-2


def test_flash_plain_non_causal_unpadded_length_matches_oracle():
    """T = 200 without a causal mask, held against ``ref.attention`` only.

    The reference's Pallas kernel pads T up to a multiple of its block
    with zero keys and drops them only through the causal mask
    (``repro/kernels/flash_attention.py:105-114``), so without one the
    padded keys are attended: at this shape it differs from
    ``ref.attention`` by up to about 0.07. The port follows the oracle and
    never counts a key at or past T.
    """
    arrays = _qkv(3, 4, 4, 200, 64)
    got = _port(flash_attention, arrays, causal=False)
    want = np.asarray(ref.attention(*(jnp.asarray(a) for a in arrays),
                                    causal=False))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_flash_plain_decode_alignment_matches_oracle():
    """A shorter query block is aligned to the end of the keys, as the
    oracle aligns it (the decode case)."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, 4, 3, 16)).astype(np.float32)
    k = rng.normal(size=(1, 2, 40, 16)).astype(np.float32)
    got = _port(flash_attention_plain, (q, k, k), window=8)
    want = np.asarray(ref.attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(k), window=8))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bad", ["heads", "shape", "window"])
def test_flash_refuses_bad_arguments(bad):
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 3 if bad == "heads" else 2, 8, 16)
    v = torch.zeros(1, 2, 9, 16) if bad == "shape" else k
    with pytest.raises(ValueError):
        flash_attention(q, k, v, window=0 if bad == "window" else None)


def _linear_inputs(seed, t, dk, dv, bh=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(bh, t, dk)).astype(np.float32),
            (rng.normal(size=(bh, t, dk)) * 0.2).astype(np.float32),
            rng.normal(size=(bh, t, dv)).astype(np.float32),
            -np.abs(rng.normal(size=(bh, t)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("dk,dv", [(16, 16), (32, 48)])
@pytest.mark.parametrize("t", [64, 200, 256])
def test_linear_attention_plain_matches_reference(t, dk, dv):
    arrays = _linear_inputs(t + dk, t, dk, dv)
    before = linear_attention.launches
    got = _port(linear_attention, arrays)
    assert linear_attention.launches == before
    ja = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(got, np.asarray(ref.linear_attention(*ja)),
                               rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got, np.asarray(pallas_linear_attention(*ja)),
                               rtol=3e-4, atol=3e-4)


def test_linear_attention_plain_keeps_bf16_dtype():
    arrays = _linear_inputs(9, 64, 16, 16)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays[:3])
    got = linear_attention(q, k, v, torch.from_numpy(arrays[3]))
    assert got.dtype == torch.bfloat16
    want = ref.linear_attention(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in arrays[:3]),
                                jnp.asarray(arrays[3]))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_linear_attention_steep_decays_stay_finite():
    """Mamba-2-like decays: the cumulative log-decay falls below -100
    within one 128-step chunk, where exp(cum_i - cum_j) for i < j is inf
    in f32; the recurrence only ever multiplies by decays <= 1."""
    rng = np.random.default_rng(4)
    bh, t, dk, dv = 4, 256, 32, 32
    q, k, v = (rng.normal(size=(bh, t, d)).astype(np.float32)
               for d in (dk, dk, dv))
    ld = (-4.0 * rng.random(size=(bh, t))).astype(np.float32)
    assert float(np.cumsum(ld[:, :128], axis=1).min()) < -100
    got = _port(linear_attention, (q, k, v, ld))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, np.asarray(ref.linear_attention(*(jnp.asarray(a)
                                                for a in (q, k, v, ld)))),
        rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("bad", ["k", "v", "decay"])
def test_linear_attention_refuses_bad_shapes(bad):
    q = torch.zeros(2, 8, 4)
    k = torch.zeros(2, 8, 5) if bad == "k" else q
    v = torch.zeros(2, 7, 4) if bad == "v" else q
    ld = torch.zeros(2, 9) if bad == "decay" else torch.zeros(2, 8)
    with pytest.raises(ValueError):
        linear_attention(q, k, v, ld)
