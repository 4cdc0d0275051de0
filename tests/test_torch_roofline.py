"""The port's roofline against the reference's ``repro.roofline``.

``flops.py`` is the same arithmetic in both packages, so its counts must be
equal, not close: every (arch x shape) cell's ``cell_flops`` and
``cell_bytes`` and each config's per-token forward FLOPs. The reference's
``tests/test_roofline.py`` cases follow on the port: the collective parser
on the same HLO sample, the remat factor, 6·N, MoE's active parameters,
decode's small FLOPs and the roofline terms. Its ``xscan`` case (loop tags
in compiled HLO) does not carry: the port compiles no HLO and has no
``xscan``. ``Roofline`` is held to the reference's with the constants set
to the same values; the port's own constants are the H100's.
"""
import dataclasses

import pytest

import repro.roofline.analysis as ref_analysis
from repro.configs import get_config as ref_config
from repro.roofline import Roofline as RefRoofline
from repro.roofline import flops as ref_flops
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.roofline import (HBM_BW, LINK_BW, PEAK_FLOPS, Roofline,
                                  cell_bytes, cell_flops, collective_bytes,
                                  forward_flops_per_token)
from repro_torch.roofline import analysis, flops

HLO_SAMPLE = """
  %ar = f32[16,1024]{1,0} all-reduce(%x), metadata={op_name="jit(f)/foo"}
  %ag.1 = bf16[8,256]{1,0} all-gather-start(%y), metadata={op_name="jit(f)/layers.xscan[28]/while/body/bar"}
  %rs = (f32[4,4]{1,0}, f32[4,4]{1,0}) reduce-scatter(%a, %b), metadata={op_name="jit(f)/t"}
  %aa = f32[2,2]{1,0} all-to-all(%c), metadata={op_name="jit(f)/layers.xscan[4]/while/body/attn.xscan[8]/while/body/q"}
  %done = f32[16,1024]{1,0} all-reduce-done(%ar)
"""


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_flops_and_bytes_equal_the_reference(arch, shape):
    cfg, ref_cfg = get_config(arch), ref_config(arch)
    assert cell_flops(cfg, SHAPES[shape]) == ref_flops.cell_flops(
        ref_cfg, SHAPES[shape])
    for remat in (True, False):
        assert cell_flops(dataclasses.replace(cfg, remat=remat),
                          SHAPES[shape]) == ref_flops.cell_flops(
            dataclasses.replace(ref_cfg, remat=remat), SHAPES[shape])
    for chips, dp in ((256, 16), (512, 32), (1, 1)):
        kw = dict(param_bytes_per_dev=1.5e9 / chips,
                  cache_bytes_per_dev=3.25e8 / chips, chips=chips,
                  dp_shards=dp)
        assert cell_bytes(cfg, SHAPES[shape], **kw) == \
            ref_flops.cell_bytes(ref_cfg, SHAPES[shape], **kw)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_token_and_encoder_flops_equal_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_config(arch)
    for T in (1, 4096, 32768):
        for decode in (False, True):
            assert forward_flops_per_token(cfg, T, decode) == \
                ref_flops.forward_flops_per_token(ref_cfg, T, decode)
    assert flops.encoder_flops(cfg, 3) == ref_flops.encoder_flops(ref_cfg, 3)
    assert (flops.ACT_RW_TRAIN, flops.ACT_RW_FWD) == \
        (ref_flops.ACT_RW_TRAIN, ref_flops.ACT_RW_FWD)


def test_collective_parser_kinds_and_multipliers():
    got = collective_bytes(HLO_SAMPLE)
    assert got["all-reduce"] == 16 * 1024 * 4            # -done skipped
    assert got["all-gather"] == 8 * 256 * 2 * 28         # xscan x28
    assert got["reduce-scatter"] == 2 * 16 * 4           # tuple summed
    assert got["all-to-all"] == 4 * 4 * (4 * 8)          # nested scans
    assert got == ref_analysis.collective_bytes(HLO_SAMPLE)


def test_analytic_flops_train_factor():
    """Remat'd train step = 4x the forward pass at the same shape."""
    cfg = get_config("qwen3-0.6b")
    t1 = cell_flops(cfg, SHAPES["train_4k"])["total_flops"]
    fwd = 256 * 4096 * forward_flops_per_token(cfg, 4096)
    assert t1 / fwd == pytest.approx(4.0, rel=0.01)
    # prefill spends more FLOPs per token (longer attended context)
    pref = cell_flops(cfg, SHAPES["prefill_32k"])["total_flops"]
    assert pref / (32 * 32768) > fwd / (256 * 4096)


def test_analytic_flops_close_to_6nd():
    """For dense models at moderate seq, layer flops/token ≈ 6·N_layer."""
    cfg = get_config("qwen1.5-110b")
    fwd = forward_flops_per_token(cfg, 4096)
    assert 1.8 <= fwd / cfg.n_params() <= 3.2


def test_moe_flops_use_active_params():
    moe = get_config("qwen3-moe-235b-a22b")
    fwd = forward_flops_per_token(moe, 4096)
    assert fwd < 0.15 * 2 * moe.n_params()  # nowhere near dense compute
    assert fwd == pytest.approx(2 * moe.n_active_params(), rel=0.5)


def test_decode_flops_much_smaller():
    cfg = get_config("h2o-danube3-4b")
    dec = cell_flops(cfg, SHAPES["decode_32k"])["total_flops"]
    pref = cell_flops(cfg, SHAPES["prefill_32k"])["total_flops"]
    assert dec < pref / 1000


def test_roofline_terms_positive():
    r = Roofline(arch="x", shape="train_4k", mesh="single", chips=256,
                 flops_per_dev=1e15, bytes_per_dev=1e9,
                 coll_bytes_per_dev=1e9, coll_breakdown={},
                 model_flops=2e17)
    assert r.t_compute == pytest.approx(1e15 / PEAK_FLOPS)
    assert r.bottleneck == "compute"
    assert 0 < r.roofline_frac <= 1.0


def test_constants_are_the_h100s():
    """NVIDIA's H100 SXM datasheet: dense bf16, HBM3, one direction of
    NVLink 4; no TPU figure."""
    assert (PEAK_FLOPS, HBM_BW, LINK_BW) == (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("kw", [
    dict(flops_per_dev=1e15, bytes_per_dev=1e9, coll_bytes_per_dev=1e9,
         model_flops=2e17),
    dict(flops_per_dev=3e12, bytes_per_dev=7e10, coll_bytes_per_dev=0.0,
         model_flops=1.5e14, hbm_per_dev=None),
    dict(flops_per_dev=2e9, bytes_per_dev=4e9, coll_bytes_per_dev=5e10,
         model_flops=1e11, hbm_per_dev=2.5e9),
    dict(flops_per_dev=0.0, bytes_per_dev=0.0, coll_bytes_per_dev=0.0,
         model_flops=0.0)])
def test_roofline_dict_equals_the_reference_on_the_same_constants(
        monkeypatch, kw):
    """The reference's ``xla_raw_flops`` is the port's ``traced_flops``;
    ``xla_raw_bytes`` (a compiler's count) has no counterpart."""
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(analysis, name, getattr(ref_analysis, name))
    common = dict(arch="a", shape="decode_32k", mesh="multi", chips=512,
                  coll_breakdown={"all-gather": 1.0}, **kw)
    got = Roofline(traced_flops=7e14, **common).to_dict()
    want = RefRoofline(xla_raw_flops=7e14, xla_raw_bytes=9e9,
                       **common).to_dict()
    want["traced_flops"] = want.pop("xla_raw_flops")
    del want["xla_raw_bytes"]
    assert got == want
