"""Decode attention over the K/V rings on the CPU: ``attention_decode``
(now through ``kernels.decode_attention``, whose wrapper runs the plain
version off the card) against a frozen copy of the einsum path it had
before the kernel, bit for bit in f32; the kernel's input check; its
slice count; and the valid-range arithmetic of ``csrc/decode_attention.cu``
mirrored in Python, against the plain version's mask."""
from __future__ import annotations

import importlib
import re

import pytest
import torch

from repro_torch.kernels import _lib
from repro_torch.models import attention as attn
from repro_torch.models.layers import dense, rope_frequencies
from repro_torch.models.sharding import flatten, unflatten

CPU = torch.device("cpu")
# the package exports the wrapper under the module's own name
da = importlib.import_module("repro_torch.kernels.decode_attention")


def frozen_attention_decode(p, x, cache, *, num_heads, num_kv_heads,
                            head_dim, rope_freqs, window=None, scale=None):
    """``attention_decode`` as it was before the decode kernel (plain
    tensors only): the mask from the ring's ages, the f32 query scaled,
    both einsums over the f32 copies of the rings."""
    B = x.shape[0]
    ck, cv = cache["k"], cache["v"]
    max_len = ck.shape[2]
    pos = cache["len"]
    on_device = isinstance(pos, torch.Tensor)
    positions = pos.expand(B, 1) if on_device else \
        torch.full((B, 1), pos, device=x.device)
    q, k, v = attn._project_qkv(p, x, num_heads, num_kv_heads, head_dim,
                                positions, rope_freqs)
    slot = pos % max_len
    attn._write_slot(ck, slot, k[:, :, 0])
    attn._write_slot(cv, slot, v[:, :, 0])
    idx = torch.arange(max_len, device=x.device)
    age = torch.remainder(slot - idx, max_len)
    valid = age <= (pos.clamp(max=max_len - 1) if on_device
                    else min(pos, max_len - 1))
    if window is not None:
        valid &= age < window
    G = num_heads // num_kv_heads
    qf = unflatten(q.float()[:, :, 0], 1, (num_kv_heads, G)) * \
        (head_dim ** -0.5 if scale is None else scale)
    logits = torch.einsum("bhgd,bhsd->bhgs", qf, ck.float())
    logits = logits.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", probs, cv.float())
    out = flatten(out, 1)[:, None].to(x.dtype)
    return dense(p["wo"], out), {"k": ck, "v": cv,
                                 "len": pos.add_(1) if on_device else pos + 1}


@pytest.mark.parametrize("on_device", [False, True])
@pytest.mark.parametrize("heads,kv_heads,window,scale", [
    (4, 4, None, None),            # MHA, D^-1/2
    (8, 2, None, None),            # GQA, 4 q heads a kv head
    (6, 2, 3, None),               # GQA under a window shorter than the ring
    (4, 1, 4, 0.3),                # one kv head, a window, a caller's scale
])
def test_attention_decode_equals_the_einsum_path_bit_for_bit(
        on_device, heads, kv_heads, window, scale):
    """f32, over steps that fill a 5-slot ring, wrap it and run on: the
    outputs and both rings equal the frozen einsum path's bit for bit,
    with ``len`` a Python int or a 0-dim tensor."""
    B, d, D, slots = 3, 40, 8, 5
    p = attn.init_attention(torch.Generator().manual_seed(7), d, heads,
                            kv_heads, D, device=CPU)
    kw = dict(num_heads=heads, num_kv_heads=kv_heads, head_dim=D,
              window=window, rope_freqs=rope_frequencies(D), scale=scale)

    def fresh():
        c = attn.init_kv_cache(B, kv_heads, slots, D, device=CPU,
                               dtype=torch.float32)
        return dict(c, len=torch.zeros((), dtype=torch.int64)) \
            if on_device else c

    mine, theirs = fresh(), fresh()
    x = torch.randn(2 * slots + 2, B, 1, d,
                    generator=torch.Generator().manual_seed(8))
    for t in range(x.shape[0]):
        want, theirs = frozen_attention_decode(p, x[t], theirs, **kw)
        got, mine = attn.attention_decode(p, x[t], mine, **kw)
        assert torch.equal(got, want)
        assert torch.equal(mine["k"], theirs["k"])
        assert torch.equal(mine["v"], theirs["v"])
        assert int(mine["len"]) == int(theirs["len"]) == t + 1


def test_the_wrapper_runs_the_plain_version_off_the_card():
    """On the CPU and on the meta device (the dry run's) the wrapper is the
    plain version; nothing launches."""
    g = torch.Generator().manual_seed(9)
    q = torch.randn(2, 2, 3, 16, generator=g)
    k, v = torch.randn(2, 2, 2, 7, 16, generator=g)
    before = da.decode_attention.launches
    got = da.decode_attention(q, k, v, 9, scale=0.2, window=4)
    assert torch.equal(got, da.decode_attention_plain(q, k, v, 9, scale=0.2,
                                                      window=4))
    meta = da.decode_attention(q.to("meta"), k.to("meta"), v.to("meta"), 3)
    assert meta.device.type == "meta" and meta.shape == q.shape
    assert da.decode_attention.launches == before


def _qkv(G=1, D=224, S=16, dtype=torch.bfloat16, ring=torch.bfloat16):
    q = torch.zeros(2, 3, G, D, dtype=dtype)
    k = torch.zeros(2, 3, S, D, dtype=ring)
    return q, k, k.clone()


@pytest.mark.parametrize("case,match", [
    (dict(dtype=torch.float16), "q must be float32 or bfloat16"),
    (dict(ring=torch.float16), "both float32 or both bfloat16"),
    (dict(D=260), "head dim 260"),
    (dict(D=100), "head dim 100"),
    (dict(G=17), "17 query heads a kv head"),
])
def test_the_kernel_check_refuses_what_the_kernel_does_not_take(case,
                                                                 match):
    with pytest.raises(ValueError, match=match):
        da.check_kernel_inputs(*_qkv(**case))


@pytest.mark.parametrize("case", [
    dict(), dict(D=64, G=16), dict(D=8, dtype=torch.float32),
    dict(D=256, ring=torch.float32), dict(D=120, G=4)])
def test_the_kernel_check_takes_the_ports_shapes(case):
    da.check_kernel_inputs(*_qkv(**case), window=4)


def test_the_kernel_check_refuses_mismatched_rings_and_windows():
    q, k, v = _qkv()
    with pytest.raises(ValueError, match="must be \\(B, Hkv, S, D\\) rings"):
        da.check_kernel_inputs(q, k, v[:, :2])
    with pytest.raises(ValueError, match="both float32 or both bfloat16"):
        da.check_kernel_inputs(q, k, v.to(torch.float32))
    with pytest.raises(ValueError, match="window must be >= 1"):
        da.check_kernel_inputs(q, k, v, window=0)


@pytest.mark.parametrize("rows,slots,sms,want", [
    (32 * 32, 1056, 132, 1),       # zamba2-7b-instruct's decode: one pass
    (264, 4096, 132, 1),           # exactly two blocks an SM
    (1 * 8, 32768, 132, 33),       # qwen3-0.6b decode_32k at batch 1
    (2 * 8, 32768, 132, 17),
    (1, 1 << 20, 132, 64),         # capped
    (4, 300, 132, 1),              # a short ring: slices of 256 or more
    (4, 100, 132, 1),
])
def test_the_slice_count_follows_the_shape(rows, slots, sms, want):
    assert da.split_count(rows, slots, sms) == want


# -- csrc/decode_attention.cu's range arithmetic, mirrored ----------------

def _cu_constant(name: str) -> int:
    text = (_lib.CSRC / "decode_attention.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def kernel_rows(pos: int, S: int, window, D: int, esize: int, G: int,
                splits: int) -> list:
    """The ring slots each slice of the kernel reads, as ``launch`` and
    the kernel's prologue compute them: the tile from the shape, the valid
    span L and its first slot, each slice's tile-aligned part of
    [0, L)."""
    warps, tile_bytes = _cu_constant("WARPS"), _cu_constant("TILE_BYTES")
    groups = 1 if G <= 4 else 2 if G <= 8 else 4
    kw = warps // groups
    lanes = 1
    while lanes < D // 8:
        lanes *= 2
    unit = 2 * (32 // lanes) * kw
    want = tile_bytes // (2 * D * esize)
    tile = want // unit * unit if want > unit else unit
    slot = pos % S
    L = min(pos + 1, S)
    if window:
        L = min(L, window)
    start = slot - L + 1
    if start < 0:
        start += S
    per_split = (-(-L // splits) + tile - 1) // tile * tile
    out = []
    for split in range(splits):
        lo = split * per_split
        hi = min(L, lo + per_split)
        rows = []
        for t in range(lo, max(lo, hi)):
            phys = start + t
            rows.append(phys - S if phys >= S else phys)
        out.append(rows)
    return out


@pytest.mark.parametrize("S,window,D,esize,G,splits", [
    (1056, None, 224, 2, 1, 1),    # the zamba2 cell
    (9, None, 224, 2, 1, 1),
    (40, 7, 120, 2, 4, 1),         # a window shorter than the ring
    (40, 64, 64, 4, 7, 3),         # a window longer than the ring
    (2048, None, 128, 2, 2, 8),    # the slices
    (2048, 300, 128, 2, 16, 8),
    (33, None, 8, 4, 1, 5),
])
def test_the_kernel_reads_each_valid_slot_once(S, window, D, esize, G,
                                               splits):
    """Every slot the plain version's mask keeps is read by exactly one
    slice, no other slot is read, at positions before, at and past the
    ring's wrap; slice 0 (whose max the merge starts from) is never
    empty."""
    for pos in sorted({0, 1, S // 2, S - 2, S - 1, S, S + 3, 2 * S + 5,
                       5 * S - 1}):
        # a zero query weighs the valid slots alike, and with v the
        # identity the plain version's output is those weights
        q, k = torch.zeros(1, 1, 1, S), torch.zeros(1, 1, S, S)
        probs = da.decode_attention_plain(q, k, torch.eye(S)[None, None],
                                          pos, window=window)
        want = torch.nonzero(probs.flatten() > 0).flatten().tolist()
        slices = kernel_rows(pos, S, window, D, esize, G, splits)
        got = sorted(r for rows in slices for r in rows)
        assert got == want, (pos, slices)
        assert slices[0], pos
