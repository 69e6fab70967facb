"""The ``s2d=True`` int8 forms of the port's ``fused_tail`` (tail_w8a8) and
``fused_sft_conv3_v2`` (sft_conv3_w8a8), hdrtv_tpu_torch/ops/megakernel.py,
on the CPU.

With ``s2d=True`` in bf16 on the card, their SFT passes run the row tile of
csrc/chain_sm90.cuh in its int8-output mode and their convs the wgmma s8
tile of csrc/conv3x3_s8_sm90.cuh, which sums only the 9 populated (tap,
sub-position) slots of each output sub-position (``models/s2d.py
s2d_slots``) and reads an out-of-image tap as the layer's pad code.

- On s2d weights the port's plain s2d forms equal the JAX Pallas int8
  bodies in interpret mode, symmetric and asymmetric, with the tolerances
  tests/test_torch_int8.py holds the dense forms to (a last-bit difference
  of t can flip a code).
- The int32 sum over the populated slots alone, walked as the kernel walks
  ``ops/conv_kernels.py conv_chunks``, equals the dense int32 sum exactly,
  pad codes included; with code 0 in place of a non-zero pad code it does
  not (what TMA's zero fill would give).
- Every int8 weight of tests/fixtures/hr_w8a8.npz that the two kernels take
  with ``s2d=True`` is zero outside the populated slots, so the skip is
  exact on the checkpoint.
- ``_sft_hopper`` routes bf16 ``s2d=True`` calls to the Hopper tiles, int8
  or float, and the wrappers hand their kernels that route: the int8 tail,
  sft_conv3 and resblock the slot table, block_conv3's int8 body with
  ``a_sub=1`` too (bf16 and fp32), and the fp32 int8 tail too (the int8-output
  mode of csrc/sft_tf32x3.cuh and the s8 tile's fp32-output epilogue; the
  fp32 float tail the 3×TF32 tiles' route), ``a_sub=0`` the dense kernels;
  other widths raise (tests/test_torch_s2d_int8_rest.py holds resblock_w8a8 and
  block_conv3_w8a8 against the Pallas bodies, tests/test_torch_fp32_int8_tiles.py
  the fp32 int8 tail and sft_conv3).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_s2d_int8.py -q
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hdrtv_tpu.models.s2d import b_s2d, w_s2d_1x1, w_s2d_s1
from tests.test_torch_int8 import FIXTURE, _assert_q_close, _both, _layer, _t_range

f32 = np.float32
CC, C = 16, 32  # natural widths of every SFT and trunk conv of the frame programs


def _sft4(rng, dtype):
    """Four SFT (w, b) pairs as the s2d program has them (w_s2d_1x1 weights,
    b_s2d biases), for both sides."""
    pairs = []
    for ci, co in ((CC, CC), (CC, C), (CC, CC), (CC, C)):
        wj, wt = _both(w_s2d_1x1(rng.randn(1, 1, ci, co).astype(f32) * 0.05)[0, 0], dtype)
        bj, bt = _both(b_s2d(rng.randn(co).astype(f32) * 0.1))
        pairs.append(((wj, bj), (wt, bt)))
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("relu,skip", [(True, False), (False, True)], ids=["relu", "skip"])
def test_sft_conv3_int8_s2d_matches_pallas(asym, relu, skip):
    """bf16, Hb = 24: the Pallas kernel's three row tiles of 8 with their
    halos, against the port's plain s2d form (the SFT over the diagonal
    blocks, t quantized from fp32, the exact int32 sum); bounds as
    test_sft_conv3_int8_plain_matches_pallas's: 2 flips under one output,
    1.4e-3 of the outputs."""
    from hdrtv_tpu.ops.megakernel import fused_sft_conv3_v2 as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_sft_conv3_v2

    rng = np.random.RandomState(160 + 2 * asym + relu)
    hb, wb, dtype = 24, 32, "bf16"
    xj, xt = _both(rng.rand(hb, wb, 4 * C) - 0.2, dtype)
    cj, ct = _both(rng.rand(hb, wb, 4 * CC), dtype)
    sj, st = _both(rng.rand(hb, wb, 4 * C), dtype) if skip else (None, None)
    sftj, sftt = _sft4(rng, dtype)
    (wj, wt), (bj, bt), (qj, qt) = _layer(rng, 4 * C, 4 * C, _t_range(xt, ct, sftt, dtype), asym)
    assert asym == (qt.pad != 0)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(xj, cj, sftj, wj.astype(xj.dtype), bj, relu=relu, skip=sj, qargs=qj)
    got = fused_sft_conv3_v2(xt, ct, sftt, wt.to(xt.dtype), bt, relu=relu, skip=st, qargs=qt, s2d=True)
    assert got.dtype == torch.bfloat16 and got.shape == (hb, wb, 4 * C)
    _assert_q_close(got, want, qt, dtype, share=1.4e-3, flips=2)


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("coarse", [False, True], ids=["s", "up_coarse"])
def test_tail_int8_s2d_matches_pallas(asym, coarse):
    """bf16, packed, Hb = 16 (two Pallas row tiles with their 2-row halos),
    with and without up_coarse; bounds as test_tail_int8_plain_matches_pallas's:
    8 codes, 3.4e-2 of them differing."""
    from hdrtv_tpu.ops.megakernel import fused_tail as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_tail

    rng = np.random.RandomState(180 + 2 * asym + coarse)
    hb, wb, dtype = 16, 16, "bf16"
    sj, st = _both(rng.rand(hb, wb, 4 * C) * 0.6, dtype)
    cj, ct = _both(rng.rand(hb, wb, 4 * CC), dtype)
    kj, kt = _both(rng.rand(hb, wb, 12), dtype)
    uj, ut = _both(rng.rand(hb // 2, wb // 2, 16 * C) * 0.6, dtype) if coarse else (None, None)
    sftj, sftt = _sft4(rng, dtype)
    lo, hi = _t_range(st if not coarse else st + 0.6, ct, sftt, dtype)
    (whj, wht), (bhj, bht), (qj, qt) = _layer(rng, 4 * C, 4 * C, (lo, hi), asym)
    wlj, wlt = _both(w_s2d_s1(rng.randn(3, 3, C, 3).astype(f32) * 0.04), dtype)
    blj, blt = _both(b_s2d(rng.randn(3).astype(f32) * 0.1))
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(sj, cj, kj, sftj, whj.astype(sj.dtype), bhj, wlj, blj, pack=True, up_coarse=uj, qargs_hr=qj)
    got = fused_tail(st, ct, kt, sftt, wht.to(st.dtype), bht, wlt, blt, pack=True, up_coarse=ut, qargs_hr=qt,
                     s2d=True)
    assert got.shape == (hb, 2, wb, 6) and got.dtype == torch.uint16
    w_ = np.asarray(want).astype(np.int64)
    d = np.abs(got.numpy().astype(np.int64) - w_)
    assert w_.max() > w_.min()
    assert d.max() <= 8 and (d > 0).mean() <= 3.4e-2, (int(d.max()), float((d > 0).mean()))


def _int8_layer(rng, asym):
    """An s2d int8 layer, 32 → 32 natural (128 → 128 s2d), quantized as the
    checkpoint's (per output channel), with or without a zero point."""
    from hdrtv_tpu_torch.ops.w8a8 import pack_qargs
    from hdrtv_tpu_torch.quant.int8 import quantize_weight

    wq, ws = quantize_weight(rng.randn(3, 3, C, C).astype(f32) * 0.05)
    b = (rng.randn(4 * C) * 0.1).astype(f32)
    return pack_qargs(w_s2d_s1(wq), b_s2d(ws), f32(0.01), f32(-0.25) if asym else None, b)


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
def test_slot_walk_int32_sum_equals_dense(asym):
    """The kernel's K walk, per output sub-position its 9 chunks (tap, c0)
    of conv_chunks(1, 1, C) over 32 channels each, out-of-image taps carrying
    the pad code: the int32 sums equal the dense 3×3 sums exactly (6 × 10
    s2d pixels: every pixel of the border rows and columns reads pad taps)."""
    from hdrtv_tpu_torch.ops.conv_kernels import conv_chunks
    from hdrtv_tpu_torch.ops.w8a8 import _quantize_act, _tap_views_q

    rng = np.random.RandomState(200 + asym)
    hb, wb, c = 6, 10, 4 * C
    qa = _int8_layer(rng, asym)
    assert asym == (qa.pad != 0)
    q = _quantize_act(torch.from_numpy((rng.rand(hb, wb, c) * 1.6 - 0.3).astype(f32)), qa)
    w9 = qa.w.reshape(qa.co, 9, c).long()

    def walk(views):
        lists = conv_chunks(1, 1, c)
        assert [len(chunks) for chunks in lists] == [9] * 4  # K = 288 of the dense 1152
        nat = qa.co // 4
        acc = torch.zeros(hb * wb, qa.co, dtype=torch.long)
        for so, chunks in enumerate(lists):
            cols = slice(so * nat, (so + 1) * nat)
            for tap, c0 in chunks:
                acc[:, cols] += views[tap].reshape(-1, c)[:, c0:c0 + 32].long() @ w9[cols, tap, c0:c0 + 32].T
        return acc

    views = _tap_views_q(q, qa.pad)
    dense = sum(views[i].reshape(-1, c).long() @ w9[:, i].T for i in range(9))
    assert torch.equal(walk(views), dense)
    # zero-filled borders (TMA's fill) are the pad only when it is 0
    assert torch.equal(walk(_tap_views_q(q, 0)), dense) != asym


def test_fixture_int8_weights_have_the_s2d_structure():
    """Each int8 3×3 weight the two kernels take with s2d=True on the
    checkpoint's programs (LE.HR_conv1, LE.HR_conv2 and the trunk convs),
    as prepared at load (QArgs.w, (Co, 9·C)), is zero outside the populated
    slots: the slot walk skips nothing but zeros."""
    from hdrtv_tpu_torch.ops.megakernel import _s2d_slots_only
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    p = HDRTVNetTorch(FIXTURE, device="cpu").params
    layers = sorted(k[: -len(".__qargs")] for k in p
                    if k.endswith(".__qargs") and (".HR_conv" in k or ".recon_trunk" in k))
    assert {"LE.HR_conv1", "LE.HR_conv2"} <= set(layers) and len(layers) == 10, layers
    for layer in layers:
        qa = p[layer + ".__qargs"]
        w = qa.w.reshape(qa.co, 3, 3, qa.c).permute(1, 2, 3, 0)  # HWIO codes
        assert (qa.c, qa.co) == (4 * C, 4 * C) and int((w != 0).sum()) > 0, layer
        assert torch.equal(_s2d_slots_only(w), w), layer


def test_sft_hopper_routes_bf16_s2d_calls():
    """(1, sm90_table's stride-1 slot table, 9 per list) for a bf16 s2d call
    and for the fp32 tail, float (its 3×TF32 tiles) and int8 (the SFT's
    int8-output mode, the s8 tile), with the fp32 table; (0, None, 0) for
    s2d=False; natural widths other than (16, 32) raise."""
    from hdrtv_tpu_torch.ops.conv_kernels import sm90_table
    from hdrtv_tpu_torch.ops.megakernel import _sft_hopper

    bf = torch.bfloat16
    hopper, table, per_list = _sft_hopper("tail", True, bf, 4 * CC, 4 * C, 4 * C)
    assert (hopper, per_list) == (1, 9) and list(table) == list(sm90_table("tail", 1, 1, 128, 128, 128)[0])
    f32_hopper, f32_table, f32_per_list = _sft_hopper("tail", True, torch.float32, 4 * CC, 4 * C, 4 * C)
    assert (f32_hopper, f32_per_list) == (1, 9)
    assert list(f32_table) == list(sm90_table("tail", 1, 1, 128, 128, 128, dtype=torch.float32)[0])
    q_hopper, q_table, q_per_list = _sft_hopper("tail", True, torch.float32, 4 * CC, 4 * C, 4 * C, quant=True)
    assert (q_hopper, q_per_list) == (1, 9) and list(q_table) == list(f32_table)
    assert _sft_hopper("sft_conv3", False, bf, 4 * CC, 4 * C, 4 * C) == (0, None, 0)
    with pytest.raises(ValueError, match="row tile"):
        _sft_hopper("sft_conv3", True, bf, 4 * CC, 4 * 64, 4 * 64)


@pytest.mark.parametrize("call", ["tail_w8a8", "sft_conv3_w8a8", "resblock_w8a8", "tail_w8a8_fp32",
                                  "block_conv3_w8a8", "block_conv3_w8a8_fp32", "block_conv3_w8a8_a_sub0"])
def test_int8_wrappers_hand_their_kernels_the_route(monkeypatch, call):
    """The card branch of the wrappers, its launch intercepted (device
    checks and the stream stubbed, CPU tensors standing in): the s2d int8
    tail, sft_conv3 and resblock in bf16 and the s2d int8 tail in fp32 hand
    the kernel s2d = 1 and the slot table and count as *_w8a8,
    block_conv3's int8 body with a_sub = 1 (PS-folded 128 → 512) the slot
    table in bf16 and in fp32; block_conv3's int8 body with a_sub = 0 hands
    the dense route (no table)."""
    from hdrtv_tpu_torch.ops import native
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3
    from hdrtv_tpu_torch.ops.megakernel import fused_resblock, fused_sft_conv3_v2, fused_tail

    launched = []
    monkeypatch.setattr(native, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(native, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(native, "stream_of", lambda t: 0)
    monkeypatch.setattr(native, "launch", lambda kernel, dt, *args, counter=None: launched.append(
        (kernel, counter, args)))
    rng = np.random.RandomState(7)
    dt = torch.float32 if call.endswith("fp32") else torch.bfloat16
    x = torch.from_numpy(rng.rand(4, 6, 4 * C).astype(f32)).to(dt)
    cond = torch.from_numpy(rng.rand(4, 6, 4 * CC).astype(f32)).to(dt)
    sft = [(w.to(dt), b) for w, b in _sft4(rng, "f32")[1]]
    qa = _int8_layer(rng, True)
    w = torch.from_numpy(qa.w.reshape(qa.co, 3, 3, qa.c).permute(1, 2, 3, 0).numpy().astype(f32)).to(dt)
    b = qa.bias
    if call.startswith("block_conv3"):
        from tests.test_torch_int8 import _layer

        (_, wp), (_, bp), (_, qp) = _layer(rng, 4 * C, 16 * C, (-0.1, 1.0), True, ps=True)
        a_sub = 0 if call.endswith("a_sub0") else 1
        fused_block_conv3(x, wp.to(dt), bp, relu=True, qargs=qp, a_sub=a_sub)
        (kernel, counter, args), = launched
        assert (kernel, counter) == ("block_conv3", "block_conv3_w8a8")
        got_a_sub, table, per_list = args[-4:-1]
        assert got_a_sub == a_sub
        if a_sub:
            assert per_list == 9 and table is not None
        else:
            assert (table, per_list) == (None, 0)
        return
    if call.startswith("tail"):
        skip = torch.zeros(4, 6, 12, dtype=dt)
        fused_tail(x, cond, skip, sft, w, b, torch.zeros(3, 3, 4 * C, 12, dtype=dt), torch.zeros(12),
                   qargs_hr=qa, s2d=True)
        want = ("tail", "tail_w8a8")
    elif call == "sft_conv3_w8a8":
        fused_sft_conv3_v2(x, cond, sft, w, b, relu=True, qargs=qa, s2d=True)
        want = ("sft_conv3", "sft_conv3_w8a8")
    else:
        fused_resblock(x, cond, sft, w, b, sft, w, b, qargs1=qa, qargs2=qa, s2d=True)
        want = ("resblock", "resblock_w8a8")
    (kernel, counter, args), = launched
    assert (kernel, counter) == want
    hopper, table, per_list = args[-4:-1]
    if call in ("tail_w8a8", "sft_conv3_w8a8", "resblock_w8a8", "tail_w8a8_fp32"):
        assert (hopper, per_list) == (1, 9) and table is not None
    else:
        assert (hopper, table, per_list) == (0, None, 0)
