"""The fp32 int8 s2d bodies of the tail and sft_conv3 (tail_w8a8,
sft_conv3_w8a8 with ``s2d=True``) as the card runs them, on the CPU against
hdrtv_tpu and the port's plain versions:

- the codes of the SFT pass's int8-output mode (``csrc/sft_tf32x3.cuh
  sft_q8_f32_kernel``), emulated in torch (``ops/megakernel.py
  sft_q8_tf32x3_emulation``: fp32 FMA chains in the order of K, t's multiply
  and add rounded apart, ``quantize_codes_fast`` with its band fix-up),
  against the codes of the plain version's fp32 t: every differing code one
  apart, at most chip_smoke.py's INT8_SHARE of the codes and of the int8
  conv's outputs differing; with one TF32 product in place of the chains (a
  planted fault) more of the outputs than INT8_SHARE differ;
- ``quantize_codes_fast`` (the float32 statement of ``csrc/common.cuh
  quantize_code_fast`` and the fix-up of the band around each
  half-integer) against the IEEE division's codes, bit for bit, at 1 ulp
  steps across ±2^-12 of every half-integer of the code range (at most 4096
  steps to a side), symmetric and asymmetric, at three scales; without the
  fix-up it differs;
- each whole call emulated (the pass's codes; the int8 3×3 conv as the s8
  tile's fp32-output epilogue sums it: the exact int32 sum with pad codes
  outside the image, ·yscale, + the folded bias, + the skip, ReLU; for the
  tail conv_last as ``conv_last_tf32x3_emulation``), against the JAX
  ``fused_tail(..., qargs_hr=)`` and ``fused_sft_conv3_v2(..., qargs=)`` in
  fp32 (Pallas in interpret mode) and the port's plain versions: the tail
  packed within tests/test_torch_s2d_int8.py's bounds (8 codes, 3.4e-2 of
  them differing; unpacked the same in value), sft_conv3 within
  ``_assert_q_close``'s.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_fp32_int8_tiles.py -q
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hdrtv_tpu.models.s2d import b_s2d, w_s2d_1x1, w_s2d_s1
from hdrtv_tpu_torch.ops.megakernel import (
    _d2s_fine, _sft_t_rows, conv_last_tf32x3_emulation, fused_sft_conv3_v2, fused_tail, quantize_codes_fast,
    sft_q8_tf32x3_emulation,
)
from hdrtv_tpu_torch.ops.w8a8 import _quantize_act, _rescale, _tap_views_q
from tests.test_torch_int8 import _assert_q_close, _both, _layer

f32 = np.float32
CC, C = 16, 32  # natural widths of every SFT and trunk conv of the frame programs
ATOL = 1e-4  # the fp32 kernels' check against their plain versions on the card (chip_smoke.py ATOL)
TAIL_CODES, TAIL_SHARE = 8, 3.4e-2  # tests/test_torch_s2d_int8.py test_tail_int8_s2d_matches_pallas


def _int8_share() -> dict:
    """chip_smoke.py's INT8_SHARE: the share of an int8 body's outputs that may
    differ from its plain version on the card."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_int8", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.INT8_SHARE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sft4(rng):
    """Four SFT (w, b) pairs as the s2d program has them (w_s2d_1x1 weights,
    b_s2d biases), for both sides, fp32."""
    pairs = []
    for ci, co in ((CC, CC), (CC, C), (CC, CC), (CC, C)):
        wj, wt = _both(w_s2d_1x1(rng.randn(1, 1, ci, co).astype(f32) * 0.05)[0, 0])
        bj, bt = _both(b_s2d(rng.randn(co).astype(f32) * 0.1))
        pairs.append(((wj, bj), (wt, bt)))
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _conv_codes(codes, qa, skip=None, relu=False):
    """The int8 3×3 'same' conv of ``codes`` as the wgmma s8 tile's
    fp32-output epilogue computes it: the exact int32 sum (an out-of-image
    tap reads the pad code), ·yscale and + the folded bias rounded apart,
    then + the skip and the ReLU, fp32."""
    h, w, c = codes.shape
    w9 = qa.w.reshape(qa.co, 9, c).double()
    acc = sum(v.reshape(h * w, c).double() @ w9[:, i].T for i, v in enumerate(_tap_views_q(codes, qa.pad)))
    y = _rescale(acc, qa).reshape(h, w, qa.co)
    if skip is not None:
        y = y + skip
    return torch.clamp_min(y, 0.0) if relu else y


def _inputs(rng, hb, wb, coarse):
    """x (the pass's input: for the tail s + d2s(up_coarse), summed in fp32),
    cond and the SFT for both sides, and the t range the layer is calibrated
    on."""
    sj, st = _both(rng.rand(hb, wb, 4 * C) * 0.6 if coarse else rng.rand(hb, wb, 4 * C) - 0.2)
    cj, ct = _both(rng.rand(hb, wb, 4 * CC))
    uj, ut = _both(rng.rand(hb // 2, wb // 2, 16 * C) * 0.6) if coarse else (None, None)
    sftj, sftt = _sft4(rng)
    x = st + _d2s_fine(ut) if coarse else st
    t = _sft_t_rows(x, ct, sftt, torch.float32)
    return (sj, st), (cj, ct), (uj, ut), (sftj, sftt), x, (float(t.min()), float(t.max()))


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("kernel", ["sft_conv3", "tail"])
def test_q8_pass_codes_match_plain(kernel, asym):
    """The emulated int8-output pass (Hb 24 × 32, the tail's x with
    up_coarse) against the codes of the plain fp32 t: every differing code
    one apart, at most INT8_SHARE[kernel] of the codes and of the conv's
    outputs differing (the FMA chains sum as the plain matmul does: none
    differ); one TF32 product each in place of the chains (the planted
    fault) flips codes and moves more than INT8_SHARE[kernel] of the
    outputs."""
    share = _int8_share()[kernel]
    rng = np.random.RandomState(300 + 2 * (kernel == "tail") + asym)
    _, (_, cond), _, (_, sft), x, t_range = _inputs(rng, 24, 32, kernel == "tail")
    _, _, (_, qa) = _layer(rng, 4 * C, 4 * C, t_range, asym)
    plain = _quantize_act(_sft_t_rows(x, cond, sft, torch.float32), qa)
    got = sft_q8_tf32x3_emulation(x, cond, sft, qa)
    bad = sft_q8_tf32x3_emulation(x, cond, sft, qa, products=1)
    assert got.dtype == torch.int8 and got.shape == plain.shape == (24, 32, 4 * C)
    y_plain = _conv_codes(plain, qa)
    for codes, fault in ((got, False), (bad, True)):
        d = (codes.int() - plain.int()).abs()
        assert int(d.max()) <= 1
        code_share = float((d > 0).float().mean())
        out_share = float((_conv_codes(codes, qa) != y_plain).float().mean())
        if fault:
            assert code_share > 0 and out_share > share, (code_share, out_share)
        else:
            assert code_share <= share and out_share <= share, (code_share, out_share)


def _sweep(scale: float, zero: float | None, cap: int = 4096) -> torch.Tensor:
    """fp32 t at 1 ulp steps across ±2^-12 of every half-integer of the code
    range (in units of the quotient (t − z)/s, and one past each end of the
    range), at most ``cap`` steps to each side of the half-integer's t."""
    lo, hi = (-128, 127) if zero is None else (0, 255)
    z = 0.0 if zero is None else zero
    ts = []
    for k in range(lo - 1, hi + 1):
        m = k + 0.5
        a, b, c = (np.float32((m + d) * scale + z) for d in (-(2.0 ** -12), 0.0, 2.0 ** -12))
        steps = int(min(cap, max(float(b) - float(a), float(c) - float(b)) / float(np.spacing(np.abs(b))) + 1))
        # 1 ulp steps around b, t's fp32 value at the half-integer, by ordered bit patterns
        bits = int(b.view(np.int32))
        order = bits if bits >= 0 else -(bits & 0x7FFFFFFF)
        run = np.arange(order - steps, order + steps + 1, dtype=np.int64)
        ts.append(np.where(run >= 0, run, (-run) | 0x80000000).astype(np.uint32).view(np.float32))
    return torch.from_numpy(np.concatenate(ts))


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("scale", [0.0123, 0.37, 3.1e-4])
def test_quantize_codes_fast_is_the_division(scale, asym):
    """quantize_code_fast with its band fix-up equals rint(t / s) (IEEE
    division, clamped, − 128 asymmetric) bit for bit across every
    half-integer of the code range; the multiply alone does not."""
    from types import SimpleNamespace

    s = float(f32(scale))
    z = float(f32(-0.25 * scale * 40)) if asym else None
    t = _sweep(s, z)
    want = _quantize_act(t, SimpleNamespace(scale=s, zero=z))
    got = quantize_codes_fast(t, s, z)
    assert t.numel() > 50_000 and torch.equal(got, want)
    assert not torch.equal(quantize_codes_fast(t, s, z, fixup=False), want)


def _card_tail(x, cond, skip, sft, qa, w_last, b_last, pack):
    """The fp32 s2d tail_w8a8 as the card computes it: the pass's codes, HR_conv2
    on the s8 tile (ReLU), conv_last on its fp32 tile."""
    h = _conv_codes(sft_q8_tf32x3_emulation(x, cond, sft, qa), qa, relu=True)
    return conv_last_tf32x3_emulation(h, w_last, b_last, skip, pack=pack)


@pytest.mark.parametrize("asym,coarse,pack", [(False, False, True), (False, True, False), (True, False, False),
                                              (True, True, True)],
                         ids=["sym-s-packed", "sym-up_coarse-unpacked", "asym-s-unpacked", "asym-up_coarse-packed"])
def test_tail_w8a8_fp32_s2d_emulation_matches_pallas(asym, coarse, pack):
    """fp32, Hb = 16 (two Pallas row tiles with their 2-row halos): the card
    route's emulation against the JAX kernel in interpret mode and the
    port's plain s2d form. Packed within 8 codes, at most 3.4e-2 of them
    differing (tests/test_torch_s2d_int8.py's bounds); unpacked within 8
    codes' worth (8/65535) and at most 3.4e-2 of the values beyond ATOL."""
    from hdrtv_tpu.ops.megakernel import fused_tail as jax_fn

    rng = np.random.RandomState(320 + 2 * asym + coarse)
    hb, wb = 16, 16
    (sj, st), (cj, ct), (uj, ut), (sftj, sftt), x, t_range = _inputs(rng, hb, wb, coarse)
    kj, kt = _both(rng.rand(hb, wb, 12))
    (whj, wht), (bhj, bht), (qj, qt) = _layer(rng, 4 * C, 4 * C, t_range, asym)
    wlj, wlt = _both(w_s2d_s1(rng.randn(3, 3, C, 3).astype(f32) * 0.04))
    blj, blt = _both(b_s2d(rng.randn(3).astype(f32) * 0.1))
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(sj, cj, kj, sftj, whj, bhj, wlj, blj, pack=pack, up_coarse=uj, qargs_hr=qj)
    got = _card_tail(x, ct, kt, sftt, qt, wlt, blt, pack)
    plain = fused_tail(st, ct, kt, sftt, wht, bht, wlt, blt, pack=pack, up_coarse=ut, qargs_hr=qt, s2d=True)
    for ref in (np.asarray(want), plain.numpy()):
        if pack:
            assert got.shape == (hb, 2, wb, 6) and got.dtype == torch.uint16
            w_ = ref.astype(np.int64)
            d = np.abs(got.numpy().astype(np.int64) - w_)
            assert w_.max() > w_.min()
            assert d.max() <= TAIL_CODES and (d > 0).mean() <= TAIL_SHARE, (int(d.max()), float((d > 0).mean()))
        else:
            assert got.shape == (hb, wb, 12) and got.dtype == torch.float32
            d = np.abs(got.numpy().astype(np.float64) - ref.astype(np.float64))
            assert d.max() <= TAIL_CODES / 65535 and (d > ATOL).mean() <= TAIL_SHARE, (float(d.max()),
                                                                                         float((d > ATOL).mean()))


def _contracted_codes(x, cond, sft, qa):
    """The pass's codes with t's multiply and add contracted into one FMA
    (the product exact in float64, one rounding to fp32 through it), as XLA
    contracts the Pallas body's x·(scale + 1) + shift."""
    from hdrtv_tpu_torch.ops.megakernel import _apply_act, _fma_rows

    c, cc = x.shape[-1] // 4, cond.shape[-1] // 4
    cd = cond.reshape(-1, cc)
    hs, hh = _apply_act(_fma_rows(cd, *sft[0]), "lrelu"), _apply_act(_fma_rows(cd, *sft[2]), "lrelu")
    scale, shift = _fma_rows(hs, *sft[1]), _fma_rows(hh, *sft[3])
    t = (x.reshape(-1, c).double() * (scale + 1.0).double() + shift.double()).float()
    return _quantize_act(t.reshape(x.shape), qa)


@pytest.mark.parametrize("asym,relu,skip", [(False, True, False), (True, False, True)],
                         ids=["sym-relu", "asym-skip"])
def test_sft_conv3_w8a8_fp32_s2d_emulation_matches_pallas(asym, relu, skip):
    """fp32, Hb = 24 (the Pallas kernel's three row tiles of 8 with their
    halos): the card route's emulation (the pass's codes, the conv on the
    s8 tile's fp32-output epilogue with the skip and the ReLU) equals the
    port's plain s2d form within two ulps everywhere, and the JAX kernel in
    interpret mode within ``_assert_q_close``'s bounds (2 flips under one
    output, 1.4e-3 of the outputs differing beyond two ulps:
    tests/test_torch_s2d_int8.py's) on the outputs that no code flipped by
    XLA's contraction of t's multiply and add moves; those (this draw's
    asymmetric layer has one) within the flip bound."""
    from hdrtv_tpu.ops.megakernel import fused_sft_conv3_v2 as jax_fn

    rng = np.random.RandomState(340 + asym)
    hb, wb = 24, 32
    (xj, xt), (cj, ct), _, (sftj, sftt), _, t_range = _inputs(rng, hb, wb, False)
    sj, st = _both(rng.rand(hb, wb, 4 * C)) if skip else (None, None)
    (wj, wt), (bj, bt), (qj, qt) = _layer(rng, 4 * C, 4 * C, t_range, asym)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fn(xj, cj, sftj, wj, bj, relu=relu, skip=sj, qargs=qj))
    got = _conv_codes(sft_q8_tf32x3_emulation(xt, ct, sftt, qt), qt, skip=st, relu=relu)
    plain = fused_sft_conv3_v2(xt, ct, sftt, wt, bt, relu=relu, skip=st, qargs=qt, s2d=True)
    assert got.dtype == torch.float32 and got.shape == (hb, wb, 4 * C)
    _assert_q_close(got, plain.numpy(), qt, "f32", share=0.0, flips=2)
    moved = (_conv_codes(_contracted_codes(xt, ct, sftt, qt), qt, skip=st, relu=relu) != got).numpy()
    assert moved.mean() <= 3 * 9 * C / (hb * wb * 4 * C)  # at most three flipped codes' outputs
    _assert_q_close(got, want, qt, "f32", share=1.0, flips=2)
    _assert_q_close(got[torch.from_numpy(~moved)], want[~moved], qt, "f32", share=1.4e-3, flips=2)
