"""The ``s2d=True`` int8 form of the port's ``fused_resblock``
(resblock_w8a8) and the ``a_sub=1`` int8 form of ``fused_block_conv3``
(block_conv3_w8a8), on the CPU.

In bf16 on the card, resblock_w8a8's s2d form runs both SFT passes on the
row tile of csrc/chain_sm90.cuh in its int8-output mode (SFT1 also writing
the rounded sum with a second input, SFT2 reading the fp32 h1) and both
convs on the wgmma s8 tile of csrc/conv3x3_s8_sm90.cuh (conv1 storing h1 in
fp32); block_conv3_w8a8 with ``a_sub=1`` quantizes x once and runs the same
s8 tile over the slot table (the int8 programs' up_conv2.0 and up_conv3.0,
C = 128 → Co = 512, PixelShuffle-folded).

- On s2d weights the port's plain forms equal the JAX Pallas int8 bodies in
  interpret mode, symmetric and asymmetric, with the tolerances
  tests/test_torch_int8.py holds the dense forms to: resblock within 7
  flipped codes' worth on at most 1.5% of the outputs (a last-bit
  difference of t1 can flip a code, which moves h1 and t2 around it),
  block_conv3 bit for bit (the same codes and exact int32 sums).
- The fixture's int8 weights of LE.up_conv2.0 and LE.up_conv3.0, as
  prepared at load, are zero outside the populated slots, so the slot walk
  is exact on the checkpoint (tests/test_torch_s2d_int8.py covers the 10
  resblock and HR layers).
- ``s8_sm90_table`` hands the s8 tile the stride-1 slot table for a_sub = 1,
  C = 128 and Co a multiple of 128, and raises for anything else; the
  route itself is held by test_int8_wrappers_hand_their_kernels_the_route
  (tests/test_torch_s2d_int8.py).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_s2d_int8_rest.py -q
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_int8 import FIXTURE, _assert_q_close, _both, _layer, _t_range
from tests.test_torch_s2d_int8 import _sft4

C = 128  # s2d channels of every trunk and up conv input (natural 32)


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("second", [None, "up_coarse"], ids=["trunk1", "up_coarse"])
def test_resblock_int8_s2d_matches_pallas(asym, second):
    """bf16, Hb = Wb = 16, SFT weights w_s2d_1x1 and convs w_s2d_s1 as the
    programs hand them: the port's plain s2d form (both SFTs over the
    diagonal blocks, t1 and t2 quantized from fp32, h1 fp32, the exact int32
    sums) against the Pallas int8 body; bounds as
    test_resblock_int8_plain_matches_pallas's."""
    from hdrtv_tpu.ops.megakernel import fused_resblock as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_resblock

    rng = np.random.RandomState(210 + 2 * asym + (second is not None))
    hb, wb, dtype = 16, 16, "bf16"
    xj, xt = _both(rng.rand(hb, wb, C) - 0.2, dtype)
    cj, ct = _both(rng.rand(hb, wb, C // 2), dtype)
    kj, kt = {}, {}
    if second == "up_coarse":
        kj[second], kt[second] = _both(rng.rand(hb // 2, wb // 2, 4 * C) * 0.5, dtype)
    s1j, s1t = _sft4(rng, dtype)
    s2j, s2t = _sft4(rng, dtype)
    lo, hi = _t_range(xt, ct, s1t, dtype)
    (w1j, w1t), (b1j, b1t), (q1j, q1t) = _layer(rng, C, C, (lo, hi + 0.5), asym)
    (w2j, w2t), (b2j, b2t), (q2j, q2t) = _layer(rng, C, C, (-0.2, 1.0), asym)
    assert asym == (q1t.pad != 0) == (q2t.pad != 0)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(xj, cj, s1j, w1j.astype(xj.dtype), b1j, s2j, w2j.astype(xj.dtype), b2j, qargs1=q1j,
                      qargs2=q2j, **kj)
    got = fused_resblock(xt, ct, s1t, w1t.to(xt.dtype), b1t, s2t, w2t.to(xt.dtype), b2t, qargs1=q1t, qargs2=q2t,
                         s2d=True, **kt)
    assert got.dtype == torch.bfloat16 and got.shape == (hb, wb, C)
    _assert_q_close(got, want, q2t, dtype, share=1.5e-2, flips=7)


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("hb", [16, 9], ids=["even", "odd_rows"])
def test_block_conv3_int8_s2d_matches_pallas(asym, hb):
    """bf16, PS-folded s2d weight 128 → 512 (up_conv2.0 / up_conv3.0) with
    ReLU, an odd row count as up_conv2's 135: ``fused_block_conv3_q_ref``
    (what the port's wrapper runs on the CPU with ``a_sub=1``) equals the
    Pallas int8 body with ``a_sub=1`` bit for bit, as
    test_block_conv3_int8_plain_equals_pallas[ps512] holds the dense call
    (its Co = 512 form concatenates the halves, so XLA contracts nothing)."""
    from hdrtv_tpu.ops.conv_kernels import fused_block_conv3 as jax_conv
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3, fused_block_conv3_q_ref

    rng = np.random.RandomState(220 + 2 * asym + (hb % 2))
    wb, co = 16, 4 * C
    xj, xt = _both(rng.rand(hb, wb, C) * 1.2 - 0.1, "bf16")
    (wj, wt), (bj, bt), (qj, qt) = _layer(rng, C, co, (-0.1, 1.0), asym, ps=True)
    assert asym == (qt.pad != 0)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_conv(xj, wj.astype(xj.dtype), bj, relu=True, a_sub=1, qargs=qj).astype(np.float32))
    got = fused_block_conv3(xt, wt.to(xt.dtype), bt, relu=True, qargs=qt, a_sub=1)
    assert got.dtype == torch.bfloat16 and got.shape == (hb, wb, co)
    assert torch.equal(got, fused_block_conv3_q_ref(xt, qt, relu=True))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_fixture_int8_up_conv_weights_have_the_s2d_structure():
    """LE.up_conv2.0 and LE.up_conv3.0's int8 weights as prepared at load
    (QArgs.w, (Co, 9·C), C = 128 → Co = 512, PS-folded) are zero outside
    the populated slots of their output sub-positions, which the PS fold
    keeps (it permutes channels inside a sub-position's block only): the
    s8 tile's slot walk skips nothing but zeros."""
    from hdrtv_tpu_torch.ops.megakernel import _s2d_slots_only
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    p = HDRTVNetTorch(FIXTURE, device="cpu").params
    for layer in ("LE.up_conv2.0", "LE.up_conv3.0"):
        qa = p[layer + ".__qargs"]
        w = qa.w.reshape(qa.co, 3, 3, qa.c).permute(1, 2, 3, 0)  # HWIO codes
        assert (qa.c, qa.co) == (C, 4 * C) and int((w != 0).sum()) > 0, layer
        assert torch.equal(_s2d_slots_only(w), w), layer


def test_s8_sm90_table_takes_the_up_convs_and_refuses_other_widths():
    """a_sub = 1, C = 128: the stride-1 slot table, 9 chunks a list, for Co
    = 512 (the up convs) and 128; other widths and a_sub values raise,
    naming what the tile takes."""
    from hdrtv_tpu_torch.ops.conv_kernels import s8_sm90_table, sm90_table

    for co in (512, 128):
        table, per_list = s8_sm90_table("block_conv3", 1, C, co)
        assert per_list == 9 and list(table) == list(sm90_table("block_conv3", 1, 1, C, co, C)[0])
    for a_sub, c, co in ((1, 256, 512), (1, 64, 256), (2, 128, 512), (1, 128, 192)):
        with pytest.raises(ValueError, match="wgmma s8 tile takes a_sub=1 with C = 128"):
            s8_sm90_table("block_conv3", a_sub, c, co)


@pytest.mark.parametrize("mega", [True, False], ids=["mega", "nomega"])
def test_int8_programs_block_conv3_calls_fit_the_s8_tile(monkeypatch, mega):
    """One 64 × 128 frame of each bf16 int8 program on the CPU: every
    block_conv3 call with qargs (the up convs) declares a_sub = 1 with a
    width the s8 tile takes, so none of them raises on the card."""
    from hdrtv_tpu_torch.models import s2d as port_s2d
    from hdrtv_tpu_torch.ops.conv_kernels import s8_sm90_table
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    calls = []

    def spy(x, w, b, *, _fn=port_s2d.fused_block_conv3, **k):
        if k.get("qargs") is not None:
            calls.append((k.get("a_sub", 0), x.shape[-1], w.shape[-1], x.dtype))
        return _fn(x, w, b, **k)

    monkeypatch.setattr(port_s2d, "fused_block_conv3", spy)
    monkeypatch.delenv("HDRTV_INT8_DOWN2", raising=False)
    if mega:
        monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    else:
        monkeypatch.setenv("HDRTV_MEGAKERNEL", "0")
    proc = HDRTVNetTorch(FIXTURE, device="cpu")
    proc.process_rgb48((np.random.RandomState(113).rand(64, 128, 3) * 255).astype(np.uint8))
    assert len(calls) == 2, calls
    for a_sub, c, co, dt in calls:
        assert (a_sub, c, co, dt) == (1, C, 4 * C, torch.bfloat16)
        assert s8_sm90_table("block_conv3", a_sub, c, co)[1] == 9
