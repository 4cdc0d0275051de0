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
import importlib

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
    _linear_plain_matches_reference(t, dk, dv)


@pytest.mark.parametrize("t,dk,dv", [(130, 256, 257), (64, 129, 40)])
def test_linear_attention_plain_matches_reference_wide_keys(t, dk, dv):
    """Key dims past 128 (the CUDA kernel's two-pass path) with a ragged
    Dv, as xLSTM's normaliser column makes it (Dk 1024, Dv 1025 there)."""
    _linear_plain_matches_reference(t, dk, dv, bh=2)


def _linear_plain_matches_reference(t, dk, dv, bh=3):
    arrays = _linear_inputs(t + dk, t, dk, dv, bh)
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


def _linear_tensor_core_rounding(q, k, v, log_decay, *, chunk=64,
                                 split_a=True, split_kw=True, key_slice=None):
    """The bf16 CUDA kernel's arithmetic in plain torch on the CPU
    (``csrc/linear_attention.cu``, namespace ``tensor_core``): per chunk of
    64 steps, f32 scores from the bf16 inputs and the causal decay
    exp(cum_i - cum_j) applied in f32; A as a bf16 hi + lo pair; the
    carried f32 state enters Q S as a hi + lo pair, scaled by exp(cum_i);
    the update adds (K o w)^T V with K o w as a hi + lo pair and the state
    kept in f32; the output rounded to bf16. ``split_a`` / ``split_kw``
    False round that operand to bf16 once instead (the design the kernel
    did not take). ``key_slice``: the wide path's order (namespace
    ``wide``, Dk > 128): Q S is summed over slices of that many key dims,
    one cluster rank each, in rank order, and the decay weights w scale V
    instead of K (the same product K^T (w o V)), as a hi + lo pair."""

    def hi_lo(x, split=True):
        hi = x.to(torch.bfloat16).float()
        return hi, ((x - hi).to(torch.bfloat16).float() if split
                    else torch.zeros_like(x))

    BH, T, Dk = q.shape
    pad = -T % chunk
    qf, kf, vf = (torch.nn.functional.pad(a.float(), (0, 0, 0, pad))
                  for a in (q, k, v))
    ld = torch.nn.functional.pad(log_decay.float(), (0, pad))
    S = torch.zeros(BH, Dk, v.shape[-1])
    out = []
    causal = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    for t0 in range(0, T + pad, chunk):
        qc, kc, vc = (a[:, t0:t0 + chunk] for a in (qf, kf, vf))
        cum = torch.cumsum(ld[:, t0:t0 + chunk], dim=1)
        total = cum[:, -1:]
        gap = (cum[:, :, None] - cum[:, None, :]).masked_fill(~causal,
                                                              float("-inf"))
        a_hi, a_lo = hi_lo(qc @ kc.transpose(1, 2) * torch.exp(gap), split_a)
        s_hi, s_lo = hi_lo(S)
        qs = torch.zeros(BH, chunk, v.shape[-1])
        for k0 in range(0, Dk, key_slice or Dk):
            ks = slice(k0, k0 + (key_slice or Dk))
            qs = qs + (qc[..., ks] @ s_hi[:, ks] + qc[..., ks] @ s_lo[:, ks])
        o = torch.exp(cum)[..., None] * qs + a_hi @ vc + a_lo @ vc
        out.append(o.to(torch.bfloat16))
        w = torch.exp(total - cum)[..., None]
        if key_slice is None:
            kw_hi, kw_lo = hi_lo(kc * w, split_kw)
            upd = kw_hi.transpose(1, 2) @ vc + kw_lo.transpose(1, 2) @ vc
        else:
            vw_hi, vw_lo = hi_lo(vc * w, split_kw)
            upd = kc.transpose(1, 2) @ vw_hi + kc.transpose(1, 2) @ vw_lo
        S = torch.exp(total)[..., None] * S + upd
    return torch.cat(out, dim=1)[:, :T]


def _card_test_inputs(seed, bh, t, dk, dv):
    """bf16 q, k, v and f32 log-decays drawn as ``tests/test_torch_cuda.py``
    draws them: k 0.2 N(0, 1), decays -|0.1 N(0, 1)| (outputs up to ~25)."""
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(bh, t, dk)), 0.2 * rng.normal(size=(bh, t, dk)),
              rng.normal(size=(bh, t, dv)))
    bf = [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
          for a in arrays]
    ld = -np.abs(0.1 * rng.normal(size=(bh, t))).astype(np.float32)
    return bf, torch.from_numpy(ld)


def _row_rel(got, want):
    return float(((got - want).norm(dim=-1)
                  / want.norm(dim=-1).clamp_min(1e-30)).max())


def _mamba2_inputs(seed, bh, t, dk, dv, steep=False):
    """bf16 q, k, v and f32 log-decays drawn as ``chip_smoke.py``'s
    ``linear_case`` draws zamba2-7b's: -softplus(dt + log(expm1(0.01)))
    A_h with A_h = 1 ... 16 over the heads, k = B dt; ``steep``: decays
    -4 U(0, 1), whose sum over a chunk falls below -100."""
    rng = np.random.default_rng(seed)
    A = np.linspace(1.0, 16.0, bh, dtype=np.float32)
    dt = np.logaddexp(0.0, rng.normal(size=(bh, t))
                      + np.log(np.expm1(0.01))).astype(np.float32)
    ld = (-4.0 * rng.random(size=(bh, t)) if steep
          else -dt * A[:, None]).astype(np.float32)
    q = rng.normal(size=(bh, t, dk)).astype(np.float32)
    k = (rng.normal(size=(bh, t, dk)) * dt[..., None]).astype(np.float32)
    v = rng.normal(size=(bh, t, dv)).astype(np.float32)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    return bf, torch.from_numpy(ld)


def _xlstm_inputs(seed, bh, t, dk, dv):
    """bf16 q, k, v and f32 log-decays drawn as ``chip_smoke.py``'s
    ``linear_inputs`` draws xlstm-1.3b's mLSTM: log_sigmoid of a forget
    pre-activation, k scaled by Dk^-1/2 and a sigmoid input gate, v with
    the normaliser's ones-column last."""
    rng = np.random.default_rng(seed)
    ld = -np.logaddexp(0.0, -rng.normal(size=(bh, t))).astype(np.float32)
    gate = 1.0 / (1.0 + np.exp(-rng.normal(size=(bh, t, 1))))
    k = rng.normal(size=(bh, t, dk)) * dk ** -0.5 * gate
    v = np.concatenate([rng.normal(size=(bh, t, dv - 1)),
                        np.ones((bh, t, 1))], axis=-1)
    q = rng.normal(size=(bh, t, dk))
    bf = [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
          for a in (q, k, v)]
    return bf, torch.from_numpy(ld)


@pytest.mark.parametrize("t,dk,dv,draw", [
    (40, 64, 64, "mamba2"), (200, 64, 64, "mamba2"), (512, 64, 64, "mamba2"),
    (200, 128, 64, "mamba2"), (200, 64, 64, "steep"), (256, 64, 64, "card"),
    (200, 128, 64, "card"), (512, 1024, 1025, "xlstm"), (200, 129, 40, "card")])
def test_linear_attention_tensor_core_rounding_within_card_gate(t, dk, dv,
                                                                draw):
    """The bf16 kernel's roundings (A, K o w and S as bf16 hi + lo pairs)
    keep it within the gates the card holds it to: 2e-2 abs and 1e-2
    relative L2 per output row, against ``ref.linear_attention`` on the
    same bf16 inputs and against the plain version. Past 128 key dims the
    wide path's roundings and order: S's hi + lo pair per key slice of
    128, the slices' Q S partials summed in rank order, w o V as the hi +
    lo pair (xlstm-1.3b's draw at its Dk 1024, Dv 1025, and Dk 129)."""
    if draw == "card":
        (q, k, v), ld = _card_test_inputs(t + dk, 2, t, dk, dv)
    elif draw == "xlstm":
        (q, k, v), ld = _xlstm_inputs(t + dk, 2, t, dk, dv)
    else:
        (q, k, v), ld = _mamba2_inputs(t + dk, 8, t, dk, dv, draw == "steep")
    got = _linear_tensor_core_rounding(
        q, k, v, ld, key_slice=128 if dk > 128 else None).float()
    want = np.asarray(ref.linear_attention(
        *(jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(ld.numpy())), np.float32)
    plain = linear_attention_plain(q, k, v, ld).float()
    for other in (torch.from_numpy(want), plain):
        torch.testing.assert_close(got, other, rtol=2e-2, atol=2e-2)
        assert _row_rel(got, other) <= 1e-2


@pytest.mark.parametrize("operand", ["A", "K o w"])
def test_linear_attention_single_bf16_operand_misses_card_gate(operand):
    """Why the kernel splits A and K o w into hi + lo: rounded to bf16 once
    (as flash rounds P), single-bf16 K o w puts a row past the 1e-2
    relative L2 gate (Mamba-2 decays, Dk 128), and single-bf16 A puts
    elements past the 2e-2 abs gate where outputs are large (the card
    tests' draw)."""
    if operand == "A":
        (q, k, v), ld = _card_test_inputs(456, 2, 256, 64, 64)
    else:
        (q, k, v), ld = _mamba2_inputs(328, 8, 200, 128, 64)
    plain = linear_attention_plain(q, k, v, ld).float()
    single = _linear_tensor_core_rounding(
        q, k, v, ld, split_a=operand != "A",
        split_kw=operand != "K o w").float()
    split = _linear_tensor_core_rounding(q, k, v, ld).float()
    if operand == "A":
        over = (single - plain).abs() > 2e-2 + 2e-2 * plain.abs()
        assert int(over.sum()) > 0
        torch.testing.assert_close(split, plain, rtol=2e-2, atol=2e-2)
    else:
        assert _row_rel(single, plain) > 1e-2
    assert _row_rel(split, plain) <= 1e-2


@pytest.mark.parametrize("dk,dv,tile", [
    (64, 64, 64), (16, 64, 64), (20, 33, 64), (64, 100, 64), (128, 64, 32),
    (128, 40, 32), (64, 32, 32), (32, 16, 32)])
def test_linear_attention_passes_its_dv_tile_to_the_bf16_entry(
        monkeypatch, dk, dv, tile):
    """On device tensors the wrapper hands the bf16 C entry the shapes and
    the Dv tile dv_tile_for picks (64, or 32 for Dk > 64 or Dv <= 32), a
    null final-state pointer unless the state is asked for, and counts one
    launch. The entry and the device checks are stubbed: only the
    wrapper's dispatch runs here."""
    la = importlib.import_module("repro_torch.kernels.linear_attention")
    calls = []

    class Lib:
        def linear_attention_bf16(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(la._lib, "require_cuda", lambda *a: None)
    monkeypatch.setattr(la._lib, "library", Lib)
    monkeypatch.setattr(la._lib, "stream_of", lambda x: 7)
    bh, t = 3, 50
    q = torch.empty(bh, t, dk, dtype=torch.bfloat16, device="meta")
    v = torch.empty(bh, t, dv, dtype=torch.bfloat16, device="meta")
    ld = torch.empty(bh, t, device="meta")
    before = linear_attention.launches
    out = la.linear_attention(q, q, v, ld)
    assert tuple(out.shape) == (bh, t, dv) and out.dtype == torch.bfloat16
    assert linear_attention.launches == before + 1
    assert len(calls) == 1 and calls[0][5:] == (None, bh, t, dk, dv, tile,
                                                7)
    assert la.dv_tile_for(dk, dv) == tile
    out, state = la.linear_attention(q, q, v, ld, return_final_state=True)
    assert tuple(state.shape) == (bh, dk, dv)
    assert state.dtype == torch.float32 and calls[1][5] is not None
    assert calls[1][6:] == calls[0][6:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dk,dv,t", [(1024, 1025, 512), (129, 40, 65),
                                     (256, 257, 64)])
def test_linear_attention_takes_the_wide_entry_past_128_keys(
        monkeypatch, dk, dv, t, dtype):
    """Key dims in (128, 1024] go to the two-pass C entry in either dtype
    and count one launch; past 1024 the wrapper raises. Stubbed as
    above."""
    la = importlib.import_module("repro_torch.kernels.linear_attention")
    calls = []

    class Lib:
        def linear_attention_wide(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(la._lib, "require_cuda", lambda *a: None)
    monkeypatch.setattr(la._lib, "library", Lib)
    monkeypatch.setattr(la._lib, "stream_of", lambda x: 7)
    bh = 3
    q = torch.empty(bh, t, dk, dtype=dtype, device="meta")
    v = torch.empty(bh, t, dv, dtype=dtype, device="meta")
    ld = torch.empty(bh, t, device="meta")
    before = linear_attention.launches
    out = la.linear_attention(q, q, v, ld)
    assert tuple(out.shape) == (bh, t, dv) and out.dtype == dtype
    assert linear_attention.launches == before + 1
    assert len(calls) == 1
    assert calls[0][6:] == (bh, t, dk, dv, int(dtype == torch.bfloat16), 7)
    wide = torch.empty(bh, t, 1025, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="key dim 1025 > 1024"):
        la.linear_attention(wide, wide, v, ld)
