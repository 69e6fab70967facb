"""Native int8 (W8A8) in hdrtv_tpu_torch on the CPU, against hdrtv_tpu.

The checkpoint is ``tests/fixtures/hr_w8a8.npz`` (+ ``.json``): the JAX
package's ``quantize_params(load_npz("weights/hr_fp32.npz"), mode="w8a8")``
then ``calibrate`` on the three smooth frames of
``tests/test_native_int8_program.py`` (weights per output channel,
activations per tensor, symmetric, abs-max). Regenerate it with

    JAX_PLATFORMS=cpu python -m tests.test_torch_int8

Held here: the port's ``quant/int8.py`` and ``attach_native_int8`` equal
JAX's exactly; each int8 kernel body's plain version against the Pallas
kernel in interpret mode (``block_conv3`` bit for bit; the others up to the
codes a last-bit difference of t flips, counted); the int8 frame programs
against JAX's kernel path; the routing and launch counts; what stays float
and what raises.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "hr_w8a8.npz")
f32 = np.float32


def make_w8a8_checkpoint() -> dict:
    """The fixture's contents, made by the JAX package (PTQ + abs-max
    calibration on three smooth image-like frames)."""
    from hdrtv_tpu.models.hdrtvnet import ModelConfig
    from hdrtv_tpu.models.import_torch import load_npz
    from hdrtv_tpu.quant.calibrate import calibrate
    from hdrtv_tpu.quant.int8 import quantize_params

    q = quantize_params(load_npz(WEIGHTS), mode="w8a8")
    yy, xx = np.mgrid[0:32, 0:48].astype(f32)
    frames = [np.stack([xx / 48 * s, yy / 32 * s, np.full_like(xx, 0.2 + 0.2 * s)], -1) for s in (0.6, 0.9, 1.0)]
    return calibrate(q, frames, ModelConfig())


def _write_checkpoint(path: str, params: dict) -> str:
    np.savez_compressed(path, **params)
    with open(os.path.join(ROOT, "weights", "hr_fp32.json")) as f:
        meta = json.load(f)
    with open(path[: -len(".npz")] + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    return path


@pytest.fixture(scope="module")
def ckpt():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def jax_int8_params(ckpt):
    """The JAX runtime's native-int8 s2d parameters of the fixture."""
    from hdrtv_tpu.models.s2d import attach_native_int8, s2d_transform_params
    from hdrtv_tpu.quant.int8 import predequantize_params

    sp = attach_native_int8(s2d_transform_params(predequantize_params(ckpt)), ckpt)
    return {k: jnp.asarray(v) for k, v in sp.items()}


def test_fixture_regenerates(ckpt):
    """The committed checkpoint is what the JAX package makes now: the same
    keys, int8 codes equal, activation scales within rtol 1e-6."""
    fresh = make_w8a8_checkpoint()
    assert sorted(fresh) == sorted(ckpt)
    n_x = 0
    for k, v in fresh.items():
        if k.endswith(".weight_int8"):
            assert v.dtype == np.int8 and np.array_equal(v, ckpt[k]), k
        elif k.endswith(".x_scale"):
            n_x += 1
            np.testing.assert_allclose(ckpt[k], v, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(ckpt[k], v, rtol=1e-6, err_msg=k)
    assert n_x > 40


@pytest.mark.parametrize("mode,asym", [("w8a8", False), ("w8a8", True), ("w8", False)])
def test_quant_int8_matches_jax(mode, asym):
    """quantize_params, predequantize_params, quantized_layer_summary and
    quantizable_layers of the port equal the JAX package's on hr_fp32.npz."""
    from hdrtv_tpu.models.import_torch import load_npz
    from hdrtv_tpu.quant import int8 as jq
    from hdrtv_tpu_torch.quant import int8 as tq

    fp = load_npz(WEIGHTS)
    assert tq.DEFAULT_EXCLUDE_SUFFIXES == jq.DEFAULT_EXCLUDE_SUFFIXES
    assert tq.quantizable_layers(fp) == jq.quantizable_layers(fp)
    want, got = jq.quantize_params(fp, mode=mode, asymmetric=asym), tq.quantize_params(fp, mode=mode, asymmetric=asym)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype and np.array_equal(got[k], want[k]), k
    assert tq.quantized_layer_summary(got) == jq.quantized_layer_summary(want)
    dq, dj = tq.predequantize_params(got), jq.predequantize_params(want)
    assert sorted(dq) == sorted(dj) and all(np.array_equal(dq[k], dj[k]) for k in dj)
    w, s = tq.quantize_weight(fp["LE.HR_conv1.weight"])
    wj, sj = jq.quantize_weight(fp["LE.HR_conv1.weight"])
    assert np.array_equal(w, wj) and np.array_equal(s, sj)


def _with_zeros(ckpt, layers):
    """The checkpoint with an asymmetric calibration (x_zero) on ``layers``."""
    out = dict(ckpt)
    for i, layer in enumerate(layers):
        out[f"{layer}.x_zero"] = f32(-0.05 * (i % 3 + 1))
    return out


@pytest.mark.parametrize("style", ["symmetric", "asymmetric", "mixed"])
def test_attach_native_int8_matches_jax(ckpt, style):
    """The port's attach_native_int8 on the s2d float parameters equals
    JAX's: the same keys, dtypes and values, for the fixture (symmetric), the
    fixture made asymmetric everywhere (the consolidated down conv carries
    its zeros) and in part (mixed CondNet down calibration: the consolidated
    float weight goes and the program takes the split form)."""
    from hdrtv_tpu.models.s2d import attach_native_int8 as jax_attach
    from hdrtv_tpu.models.s2d import s2d_transform_params as jax_tr
    from hdrtv_tpu.quant.int8 import predequantize_params
    from hdrtv_tpu_torch.models.s2d import attach_native_int8, s2d_transform_params

    layers = sorted(k[: -len(".x_scale")] for k in ckpt if k.endswith(".x_scale"))
    raw = {"symmetric": ckpt, "asymmetric": _with_zeros(ckpt, layers),
           "mixed": _with_zeros(ckpt, ["LE.CondNet2.0", "LE.HR_conv1"])}[style]
    want = jax_attach(jax_tr(predequantize_params(raw)), raw)
    got = attach_native_int8(s2d_transform_params(predequantize_params(raw)), raw)
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k
    qlayers = sorted(k[: -len(".qweight")] for k in got if k.endswith(".qweight"))
    assert len(qlayers) == 25 - (style == "mixed")
    assert ("LE.__cond_down.weight" in got) == (style != "mixed")
    assert ("LE.__cond_down.qx_zeros" in got) == (style == "asymmetric")


# ---------------------------------------------------------------------------
# The int8 kernel bodies: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _both(a, dtype="f32"):
    a = np.ascontiguousarray(a, f32)
    j, t = jnp.asarray(a), torch.from_numpy(a.copy())
    if dtype == "bf16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _sft4(rng, cc, c, dtype):
    pairs = [(_both(rng.randn(ci, co) * 0.05, dtype), _both(rng.randn(co) * 0.1))
             for ci, co in ((cc, cc), (cc, c), (cc, cc), (cc, c))]
    return [(w[0], b[0]) for w, b in pairs], [(w[1], b[1]) for w, b in pairs]


def _layer(rng, c, co, t_range, asym, ps=False):
    """A native-int8 s2d conv layer for both sides: natural weights quantized
    per output channel, s2d-transformed (PixelShuffle-folded with ``ps``);
    the activation scale (and zero) calibrated on ``t_range`` = (min, max)
    of what it quantizes, by abs-max or min/max. Returns the float weight
    and bias pairs and (JAX qargs dict, port QArgs)."""
    from hdrtv_tpu_torch.models.s2d import b_s2d, w_ps_permute, w_s2d_s1, w_s2d_s1_ps
    from hdrtv_tpu_torch.ops.w8a8 import pack_qargs
    from hdrtv_tpu_torch.quant.int8 import quantize_weight

    wq, ws = quantize_weight(rng.randn(3, 3, c // 4, co // 4).astype(f32) * 0.05)
    if ps:
        tq, tsc = w_s2d_s1_ps(wq), np.tile(w_ps_permute(ws.reshape(1, 1, 1, -1))[0, 0, 0], 4)
    else:
        tq, tsc = w_s2d_s1(wq), b_s2d(ws)
    lo, hi = t_range
    if asym:
        s, z = f32((hi - lo) / 255.0), f32(lo)
    else:
        s, z = f32(max(abs(lo), abs(hi)) / 127.0), None
    b = (rng.randn(co) * 0.1).astype(f32)
    qj = {"w_int8": jnp.asarray(tq), "w_scale": jnp.asarray(tsc), "x_scale": jnp.float32(s)}
    if z is not None:
        qj["x_zero"] = jnp.float32(z)
    w = (tq.astype(f32) * tsc).astype(f32)
    return _both(w), _both(b), (qj, _same_bias(pack_qargs(tq, tsc, s, z, b), qj, b))


def _same_bias(qt, qj, b):
    """``qt`` with JAX's folded bias: the zero-point term sums 9·C weight
    products in fp32 in XLA's order, which ``pack_qargs`` does not reproduce
    (it takes the sum exactly; test_pack_qargs_matches_jax bounds the
    difference), so the kernel bodies are compared on the same bias."""
    from hdrtv_tpu.ops.megakernel import _pack_qargs

    bc = np.asarray(_pack_qargs(qj, qt.co)[5])
    return dataclasses.replace(qt, bias=torch.from_numpy(np.asarray(jnp.asarray(b) + bc)))


def _ulps(y, n: int = 1):
    """``n`` fp32 ulps of the epilogue for results ``y`` (of magnitude ≲ 2
    before the skip and ReLU): what XLA's contraction of the rescale and the
    bias add into one FMA moves them by."""
    return n * np.spacing(np.maximum(np.abs(y), 2.0).astype(f32))


def _flip_bound(qa, flips: int = 1) -> float:
    """How far ``flips`` flipped codes under one output can move it: each
    changes the int32 sum by a weight code (|w| ≤ 127), scaled by yscale."""
    return flips * 127.0 * float(qa.yscale.max())


def _assert_q_close(got, want, qa, dtype, *, share, flips=1):
    """Equal up to the epilogue's contraction (fp32: two ulps) but where a
    code flipped: at most ``share`` of the values differ beyond that (in
    bf16: at all), each by at most the flip bound (+ one bf16 step of the
    result, which the flip can also move across a rounding)."""
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    err = np.abs(g - w)
    bound = _flip_bound(qa, flips) + (2.0 ** -7 * np.maximum(1.0, np.abs(w)) if dtype == "bf16" else 0.0)
    assert (err <= bound).all(), (float(err.max()), float(np.max(bound)))
    differ = err > (_ulps(w, 2) if dtype == "f32" else 0.0)
    assert float(differ.mean()) <= share, float(differ.mean())


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
def test_pack_qargs_matches_jax(asym):
    """The load-time preparation against JAX's per-call ``_pack_qargs``:
    yscale and the pad code exact; the folded bias exact when symmetric and
    within 12 fp32 ulps of the zero-point term when asymmetric (another
    summation order of its 1152 products; 5.5 seen)."""
    from hdrtv_tpu.ops.megakernel import _pack_qargs
    from hdrtv_tpu_torch.ops.w8a8 import pack_qargs

    rng = np.random.RandomState(5)
    wq = rng.randint(-127, 128, size=(3, 3, 128, 512)).astype(np.int8)
    ws = (rng.rand(512) * 0.01).astype(f32)
    b = (rng.randn(512) * 0.1).astype(f32)
    s, z = f32(0.0041), (f32(-0.11) if asym else None)
    qj = {"w_int8": jnp.asarray(wq), "w_scale": jnp.asarray(ws), "x_scale": jnp.float32(s)}
    if asym:
        qj["x_zero"] = jnp.float32(z)
    w9, ys, _, _, has_z, bc = _pack_qargs(qj, 512)
    qt = pack_qargs(wq, ws, s, z, b)
    assert has_z == asym and qt.pad == (int(np.clip(np.round(-z / s), 0, 255)) - 128 if asym else 0)
    assert np.array_equal(qt.yscale.numpy(), np.asarray(ys).reshape(-1))
    assert np.array_equal(qt.w.numpy(), np.asarray(w9).reshape(9 * 128, 512).T)
    want = np.asarray(jnp.asarray(b) + bc)
    ulp = np.spacing(np.abs(np.asarray(bc)).astype(f32)).max() if asym else 0.0
    assert np.abs(qt.bias.numpy() - want).max() <= 12 * ulp


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 ``a·b + c`` rounded once (a fused multiply-add): the product is
    exact in fp64, and the fp64 sum rounds to the same fp32 value as the
    exact sum unless it lands exactly on the midpoint of two fp32 values,
    where the sign of its rounding error (TwoSum, exact) decides."""
    p, cd = a.double() * b.double(), c.double()
    r = p + cd
    bv = r - p
    err = (p - (r - bv)) + (cd - bv)
    r32 = r.float()
    inf = torch.tensor(float("inf"))
    other = torch.nextafter(r32, torch.where(r >= r32.double(), inf, -inf))
    mid = (r32.double() + other.double()) * 0.5
    fix = (r == mid) & (r != r32.double()) & (err != 0) & ((err > 0) == (other > r32))
    return torch.where(fix, other, r32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("form", ["relu", "skip", "ps512"])
def test_block_conv3_int8_plain_equals_pallas(dtype, asym, form):
    """Both quantize the same input with the same arithmetic and sum exact
    int32 products (Hb = Wb = 16: one Pallas tile with its zeroed halo, so
    every image edge is in it). The Pallas body rescales, then adds the bias,
    as two jnp ops, and so do the port and its kernel; XLA on the CPU
    contracts the two into one fused multiply-add where nothing separates
    them, which is the body's Co = 128 form (its a_sub form, Co = 512,
    concatenates the halves in between). So: Co = 512 bit for bit; Co = 128
    bit for bit against the same computation with that FMA, and within one
    fp32 ulp of the epilogue without it (12-37% of the values seen one ulp
    apart in fp32, 0.01% one bf16 step apart in bf16)."""
    from jax.experimental.pallas import tpu as pltpu

    from hdrtv_tpu.ops.conv_kernels import fused_block_conv3 as jax_conv
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3
    from hdrtv_tpu_torch.ops.w8a8 import _quantize_act, _tap_views_q

    rng = np.random.RandomState(50 + asym)
    hb, wb, c = 16, 16, 128
    co = 512 if form == "ps512" else 128
    relu = form != "skip"
    xj, xt = _both(rng.rand(hb, wb, c) * 1.2 - 0.1, dtype)
    (wj, wt), (bj, bt), (qj, qt) = _layer(rng, c, co, (-0.1, 1.0), asym, ps=form == "ps512")
    sj, st = _both(rng.rand(hb, wb, co), dtype) if form == "skip" else (None, None)
    wj, wt = wj.astype(xj.dtype), wt.to(xt.dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_conv(xj, wj, bj, relu=relu, skip=sj, a_sub=1, qargs=qj).astype(jnp.float32))
    got = fused_block_conv3(xt, wt, bt, relu=relu, skip=st, qargs=qt)
    assert got.dtype == xt.dtype and got.shape == (hb, wb, co)
    assert asym == (qt.pad != 0)
    if co == 512:
        np.testing.assert_array_equal(got.float().numpy(), want)
        return
    views = _tap_views_q(_quantize_act(xt.float(), qt), qt.pad)
    w9 = qt.w.reshape(co, 9, c).double()
    acc = sum(v.reshape(-1, c).double() @ w9[:, i].T for i, v in enumerate(views)).float()
    y = _fma(acc, qt.yscale, qt.bias).reshape(hb, wb, co)
    y = y + st.float() if st is not None else y
    y = torch.clamp_min(y, 0.0) if relu else y
    np.testing.assert_array_equal(y.to(xt.dtype).float().numpy(), want)
    err = np.abs(got.float().numpy() - want)
    if dtype == "f32":
        assert (err <= _ulps(want)).all(), float(err.max())
    else:
        assert (err <= 2.0 ** -7 * np.maximum(1.0, np.abs(want))).all() and (err > 0).mean() <= 1e-3


def _t_range(x, cond, sft, dtype):
    """min and max of the SFT output t, what an int8 conv after it quantizes."""
    from hdrtv_tpu_torch.ops.megakernel import _sft_t

    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    t = _sft_t(x.float(), cond.to(dt).float(), sft, dt)
    return float(t.min()), float(t.max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("relu,skip", [(True, False), (False, True)], ids=["relu", "skip"])
def test_sft_conv3_int8_plain_matches_pallas(dtype, asym, relu, skip):
    """t is quantized from fp32 in both; scale and shift are fp32 sums taken
    in another order (and XLA contracts t's multiply and add), so t may
    differ in its last bit and flip a code where t/s lies on a rounding
    boundary: 0 to 6.8e-4 of the outputs seen differing beyond the
    epilogue's ulps, each by less than one flipped code's worth plus a bf16
    step; bounds 2 flips under one output and twice the share (Hb = 24: the
    Pallas kernel's three row tiles of 8, with their halos)."""
    from jax.experimental.pallas import tpu as pltpu

    from hdrtv_tpu.ops.megakernel import fused_sft_conv3_v2 as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_sft_conv3_v2

    rng = np.random.RandomState(60 + 2 * asym + relu)
    hb, wb, c, cc = 24, 32, 128, 64
    xj, xt = _both(rng.rand(hb, wb, c) - 0.2, dtype)
    cj, ct = _both(rng.rand(hb, wb, cc), dtype)
    sj, st = _both(rng.rand(hb, wb, c), dtype) if skip else (None, None)
    sftj, sftt = _sft4(rng, cc, c, dtype)
    (wj, wt), (bj, bt), (qj, qt) = _layer(rng, c, c, _t_range(xt, ct, sftt, dtype), asym)
    wj, wt = wj.astype(xj.dtype), wt.to(xt.dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(xj, cj, sftj, wj, bj, relu=relu, skip=sj, qargs=qj)
    got = fused_sft_conv3_v2(xt, ct, sftt, wt, bt, relu=relu, skip=st, qargs=qt)
    _assert_q_close(got, want, qt, dtype, share=1.4e-3, flips=2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("second", [None, "up_coarse", "x_add"])
def test_resblock_int8_plain_matches_pallas(dtype, asym, second):
    """Both convs int8, h1 fp32 between them. A code flipped in t1 moves h1,
    and so t2 and its codes, over a 3×3 neighbourhood: seen up to 7.1e-3 of
    the outputs differing, by up to 3.2 flipped codes' worth of conv2; bounds
    twice that."""
    from jax.experimental.pallas import tpu as pltpu

    from hdrtv_tpu.ops.megakernel import fused_resblock as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_resblock

    rng = np.random.RandomState(70 + asym)
    hb, wb, c, cc = (24, 32, 128, 64) if second is None else (16, 16, 128, 64)
    xj, xt = _both(rng.rand(hb, wb, c) - 0.2, dtype)
    cj, ct = _both(rng.rand(hb, wb, cc), dtype)
    kj, kt = {}, {}
    if second == "up_coarse":
        kj[second], kt[second] = _both(rng.rand(hb // 2, wb // 2, 4 * c) * 0.5, dtype)
    elif second == "x_add":
        kj[second], kt[second] = _both(rng.rand(hb, wb, c) * 0.5, dtype)
    s1j, s1t = _sft4(rng, cc, c, dtype)
    s2j, s2t = _sft4(rng, cc, c, dtype)
    lo, hi = _t_range(xt, ct, s1t, dtype)
    (w1j, w1t), (b1j, b1t), (q1j, q1t) = _layer(rng, c, c, (lo, hi + 0.5), asym)
    (w2j, w2t), (b2j, b2t), (q2j, q2t) = _layer(rng, c, c, (-0.2, 1.0), asym)
    cast = (lambda a: a.astype(xj.dtype)), (lambda a: a.to(xt.dtype))
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(xj, cj, s1j, cast[0](w1j), b1j, s2j, cast[0](w2j), b2j, qargs1=q1j, qargs2=q2j, **kj)
    got = fused_resblock(xt, ct, s1t, cast[1](w1t), b1t, s2t, cast[1](w2t), b2t, qargs1=q1t, qargs2=q2t, **kt)
    _assert_q_close(got, want, q2t, dtype, share=1.5e-2, flips=7)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("coarse", [False, True], ids=["s", "up_coarse"])
def test_tail_int8_plain_matches_pallas(dtype, asym, coarse):
    """HR_conv2 int8 (``qargs_hr``), h rounded to the element type, conv_last
    float, packed to u16 (Hb = 16: two Pallas row tiles with their 2-row
    halos). conv_last's fp32 sum is packed unrounded, so a flipped bf16
    rounding of h, or a flipped code of t, shows as a few codes: seen max 4
    codes and 1.7e-2 of them differing (asymmetric, up_coarse, bf16; at most
    1 code and 3.9e-3 in the other cases); bounds twice that."""
    from jax.experimental.pallas import tpu as pltpu

    from hdrtv_tpu.ops.megakernel import fused_tail as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_tail

    rng = np.random.RandomState(80 + 2 * asym + coarse)
    hb, wb, c, cc = 16, 16, 128, 64
    sj, st = _both(rng.rand(hb, wb, c) * 0.6, dtype)
    cj, ct = _both(rng.rand(hb, wb, cc), dtype)
    kj, kt = _both(rng.rand(hb, wb, 12), dtype)
    uj, ut = _both(rng.rand(hb // 2, wb // 2, 4 * c) * 0.6, dtype) if coarse else (None, None)
    sftj, sftt = _sft4(rng, cc, c, dtype)
    lo, hi = _t_range(st if not coarse else st + 0.6, ct, sftt, dtype)
    (whj, wht), (bhj, bht), (qj, qt) = _layer(rng, c, c, (lo, hi), asym)
    wlj, wlt = _both(rng.randn(3, 3, c, 12) * 0.01, dtype)
    blj, blt = _both(rng.randn(12) * 0.1)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(sj, cj, kj, sftj, whj.astype(sj.dtype), bhj, wlj, blj, pack=True, up_coarse=uj, qargs_hr=qj)
    got = fused_tail(st, ct, kt, sftt, wht.to(st.dtype), bht, wlt, blt, pack=True, up_coarse=ut, qargs_hr=qt)
    assert got.shape == (hb, 2, wb, 6) and got.dtype == torch.uint16
    w_ = np.asarray(want).astype(np.int64)
    d = np.abs(got.numpy().astype(np.int64) - w_)
    assert w_.max() > w_.min()
    assert d.max() <= 8 and (d > 0).mean() <= 3.4e-2, (int(d.max()), float((d > 0).mean()))


def test_int8_wrappers_reject_bad_qargs():
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3
    from hdrtv_tpu_torch.ops.megakernel import fused_resblock

    rng = np.random.RandomState(1)
    (_, wt), (_, bt), (_, qt) = _layer(rng, 128, 128, (0.0, 1.0), False)
    x = torch.zeros(8, 8, 128)
    with pytest.raises(TypeError, match="QArgs"):
        fused_block_conv3(x, wt, bt, qargs={"w_int8": 0})
    with pytest.raises(ValueError, match="channels"):
        fused_block_conv3(torch.zeros(8, 8, 256), torch.zeros(3, 3, 256, 128), bt, qargs=qt)
    sft = [(torch.zeros(64, 64), torch.zeros(64)), (torch.zeros(64, 128), torch.zeros(128))] * 2
    with pytest.raises(ValueError, match="both or neither"):
        fused_resblock(x, torch.zeros(8, 8, 64), sft, wt, bt, sft, wt, bt, qargs1=qt)


# ---------------------------------------------------------------------------
# The int8 frame programs
# ---------------------------------------------------------------------------


def _count_calls(monkeypatch):
    """Calls of each kernel wrapper the frame programs reach, split into the
    float form and the int8 form (``_q``)."""
    from hdrtv_tpu_torch.models import s2d as port_s2d

    calls = {}
    for name in ("fused_agcm_head", "fused_cond_chain", "fused_tail", "fused_sft_conv3_v2", "fused_resblock",
                 "fused_mix_chain", "fused_down2", "fused_block_conv3", "fused_trunk3", "pack_rgb48"):
        def counted(*a, _fn=getattr(port_s2d, name), _name=name, **k):
            quant = any(k.get(q) is not None for q in ("qargs", "qargs1", "qargs_hr"))
            key = _name + ("_q" if quant else "")
            calls[key] = calls.get(key, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(port_s2d, name, counted)
    return calls


# Wrapper calls of one frame whose every level is 8-wide-divisible (the
# 1080p routing): the int8 forms where the JAX program passes qargs.
LAUNCHES = {
    "int8_bf16_mega": {"fused_agcm_head": 1, "fused_cond_chain": 1, "fused_tail_q": 1, "fused_sft_conv3_v2_q": 5,
                       "fused_resblock_q": 2, "fused_mix_chain": 1, "fused_down2": 5, "fused_block_conv3_q": 2,
                       "fused_trunk3": 1},
    "int8_bf16_nomega": {"fused_sft_conv3_v2_q": 6, "fused_resblock_q": 2, "fused_block_conv3_q": 2,
                         "fused_mix_chain": 1, "fused_down2": 5, "fused_trunk3": 1, "pack_rgb48": 1},
    "int8_fp32": {"fused_block_conv3_q": 12, "fused_down2": 5, "fused_trunk3": 1, "pack_rgb48": 1},
}


def _psnr(a, b) -> float:
    mse = float(np.mean((a.astype(np.float64) / 65535.0 - b.astype(np.float64) / 65535.0) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-20))


def smooth_frame(h, w, seed):
    """The u8 frame chip_smoke.py compares int8 against float on: 8 × 8 grey
    blocks, a third clipped to white, under mild noise."""
    rng = np.random.RandomState(seed)
    blocks = np.kron(rng.rand(-(-h // 8), -(-w // 8), 1), np.ones((8, 8, 3)))[:h, :w] * 420
    return np.clip(blocks + rng.randn(h, w, 3) * 10, 0, 255).astype(np.uint8)


def _cascade_note():
    """Why the int8 frame bounds are wide (a docstring shared by the two
    tests below): every int8 layer matches JAX's alone (the body tests above;
    and in the frame, one quantized layer at a time stays within the float
    program's own bound), but a float difference of one rounding upstream
    flips a code where a value lies on a rounding boundary, the flip moves
    that layer's output by a whole quantization step, and the next int8
    layer sees an input that differs by that much, so more codes flip: the
    two packages' int8 frames drift apart up to a share of the quantization
    noise itself (compare test_int8_psnr_against_the_float_program: int8
    against float is 33.9 dB on a smooth frame)."""


def test_int8_mega_program_matches_jax_kernel_path(monkeypatch, jax_int8_params):
    """The default precision on the W8A8 checkpoint: ``HDRTVNetTorch`` on a
    120×256 BGR noise frame (the smallest size that routes like 1080p) runs
    the megakernel program with the int8 forms, against the JAX
    ``ensemble_s2d_rgb48_pairs`` on ``attach_native_int8`` parameters with
    every Pallas kernel in interpret mode (``HDRTV_FORCE_FUSED_TRACE``, or the
    three conv kernels would run lax on float weights and never quantize).
    The float programs differ by max 80, mean 6.5 codes here (bf16
    roundings); the int8 ones by max 7076, mean 468.0, PSNR 39.93 dB, as
    :func:`_cascade_note` explains. Bounds: twice the max and the mean, and
    the PSNR at most 3 dB lower (twice the mean squared difference)."""
    from jax.experimental.pallas import tpu as pltpu

    from hdrtv_tpu.models.layers import BF16
    from hdrtv_tpu.models.s2d import ensemble_s2d_rgb48_pairs
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    h, w = 120, 256
    frame = (np.random.RandomState(120).rand(h, w, 3) * 255).astype(np.uint8)
    calls = _count_calls(monkeypatch)
    monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    proc = HDRTVNetTorch(FIXTURE, device="cpu")
    assert proc.native_int8 and proc.predequantized and proc.policy.compute_dtype == torch.bfloat16
    got = proc.process_rgb48(frame).astype(np.int64)
    assert calls == LAUNCHES["int8_bf16_mega"]

    monkeypatch.setenv("HDRTV_FORCE_FUSED_TRACE", "1")
    monkeypatch.setenv("HDRTV_MEGAKERNEL_INTERPRET", "1")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ensemble_s2d_rgb48_pairs(
            jax_int8_params, jnp.asarray(frame.reshape(h // 2, 2, w // 2, 6)), None, policy=BF16, bgr=True))
    want = want.reshape(h, w, 3).astype(np.int64)
    d = np.abs(got - want)
    assert d.max() <= 14152 and d.mean() <= 936.0 and _psnr(got, want) >= 36.92, (
        int(d.max()), float(d.mean()), _psnr(got, want))


def test_int8_fp32_program_matches_jax_kernel_path(monkeypatch, jax_int8_params):
    """``precision="fp32"`` on the W8A8 checkpoint at 64×96: the 12-call
    block_conv3 routing becomes 7 int8 calls here, because at this size the
    L2 level is 12 blocks wide and the JAX kernel predicate (Wb % 8) keeps
    trunk2, trunk4 and up_conv2 lax, on float weights; the port follows it
    (float block_conv3 there). Against the JAX fp32 kernel path (interpret
    mode): the float programs differ by at most 1 code; the int8 ones by max
    1543, mean 5.32, 3.0% of the values by more than 4 codes, PSNR 63.01 dB,
    as :func:`_cascade_note` explains. Bounds: twice the max, the mean and
    the share, and the PSNR at most 3 dB lower."""
    from jax.experimental.pallas import tpu as pltpu

    from hdrtv_tpu.models.layers import F32
    from hdrtv_tpu.models.s2d import ensemble_s2d_rgb48_flat
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    h, w = 64, 96
    frame = (np.random.RandomState(64).rand(h, w, 3) * 255).astype(np.uint8)
    calls = _count_calls(monkeypatch)
    got = HDRTVNetTorch(FIXTURE, precision="fp32", device="cpu").process_rgb48(frame).astype(np.int64)
    assert calls == {"fused_block_conv3_q": 7, "fused_block_conv3": 5, "fused_down2": 5, "fused_trunk3": 1,
                     "pack_rgb48": 1}
    monkeypatch.setenv("HDRTV_FORCE_FUSED_TRACE", "1")
    monkeypatch.setenv("HDRTV_MEGAKERNEL_INTERPRET", "1")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ensemble_s2d_rgb48_flat(
            jax_int8_params, jnp.asarray(frame.reshape(h, 3 * w)), None, policy=F32, bgr=True))
    want = want.reshape(h, w, 3).astype(np.int64)
    d = np.abs(got - want)
    assert d.max() <= 3086 and d.mean() <= 10.64 and (d > 4).mean() <= 0.06 and _psnr(got, want) >= 60.0, (
        int(d.max()), float(d.mean()), float((d > 4).mean()), _psnr(got, want))


@pytest.mark.parametrize("path", ["int8_bf16_nomega", "int8_fp32"])
def test_int8_programs_route_like_1080p(monkeypatch, path):
    """At 120×256 every level is 8-wide-divisible, as at 1080p: the program
    without the megakernels and the fp32 program call the int8 forms where
    the JAX program passes qargs, and no float form of a quantized layer."""
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    calls = _count_calls(monkeypatch)
    monkeypatch.setenv("HDRTV_MEGAKERNEL", "0")
    precision = "fp32" if path == "int8_fp32" else "fp16"
    out = HDRTVNetTorch(FIXTURE, precision=precision, device="cpu").process_rgb48(smooth_frame(120, 256, 3))
    assert out.shape == (120, 256, 3) and out.dtype == np.uint16
    assert calls == LAUNCHES[path]


def test_int8_psnr_against_the_float_program(monkeypatch):
    """What chip_smoke.py holds the card to: on the smooth 1080p-like frame
    (here 120×256) each int8 program's output differs from the float program
    on the pre-dequantized weights (HDRTVNET_NATIVE_INT8=0), by a PSNR of
    33.85 (mega), 33.51 (no mega) and 33.65 dB (fp32) on the CPU: the
    calibration saw three small smooth frames, this frame clips a third of
    its blocks to white. chip_smoke.py's 1080p frame of the same kind may sit
    at most 3 dB under these (INT8_PSNR_CPU there)."""
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    frame = smooth_frame(120, 256, 1080)
    seen = {}
    for path, precision, mega in (("int8_bf16_mega", "fp16", "1"), ("int8_bf16_nomega", "fp16", "0"),
                                  ("int8_fp32", "fp32", "1")):
        monkeypatch.setenv("HDRTV_MEGAKERNEL", mega)
        monkeypatch.delenv("HDRTVNET_NATIVE_INT8", raising=False)
        q = HDRTVNetTorch(FIXTURE, precision=precision, device="cpu").process_rgb48(frame)
        monkeypatch.setenv("HDRTVNET_NATIVE_INT8", "0")
        f = HDRTVNetTorch(FIXTURE, precision=precision, device="cpu").process_rgb48(frame)
        assert not np.array_equal(q, f)
        seen[path] = _psnr(q, f)
    print("int8 vs float PSNR (dB):", {k: round(v, 2) for k, v in seen.items()})
    want = {"int8_bf16_mega": 33.85, "int8_bf16_nomega": 33.51, "int8_fp32": 33.65}
    assert all(abs(seen[k] - v) < 0.3 for k, v in want.items()), seen


@pytest.mark.parametrize("kind", ["w8", "native_off"])
def test_float_program_on_predequantized_weights(monkeypatch, tmp_path, ckpt, kind):
    """A weight-only (W8) checkpoint, and the W8A8 one with
    HDRTVNET_NATIVE_INT8=0, give exactly the float program on the
    pre-dequantized weights: bit for bit, in the default program."""
    from hdrtv_tpu_torch.quant.int8 import predequantize_params, quantize_params
    from hdrtv_tpu_torch.models.import_npz import load_npz
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    if kind == "w8":
        path = _write_checkpoint(str(tmp_path / "w8.npz"), quantize_params(load_npz(WEIGHTS), mode="w8"))
    else:
        path = FIXTURE
        monkeypatch.setenv("HDRTVNET_NATIVE_INT8", "0")
    dq = _write_checkpoint(str(tmp_path / "dq.npz"), predequantize_params(
        {k: v for k, v in np.load(path).items()}))
    frame = smooth_frame(64, 96, 5)
    proc = HDRTVNetTorch(path, device="cpu")
    assert proc.predequantized and not proc.native_int8
    assert not any(k.endswith(".__qargs") for k in proc.params)
    assert np.array_equal(proc.process_rgb48(frame), HDRTVNetTorch(dq, device="cpu").process_rgb48(frame))


def test_int8_params_are_prepared_once(ckpt):
    """int8 codes stay int8 and the scales fp32 under bf16; each quantized
    3×3 conv has its QArgs (Python scale and pad, fp32 yscale and bias), the
    consolidated down conv one per branch (what down2 takes under
    HDRTV_INT8_DOWN2=1); the 1×1s keep their raw int8 keys only."""
    from hdrtv_tpu_torch.ops.w8a8 import QArgs
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    p = HDRTVNetTorch(FIXTURE, device="cpu").params
    assert p["LE.HR_conv2.qweight"].dtype == torch.int8
    assert p["LE.HR_conv2.qw_scale"].dtype == torch.float32 and p["LE.HR_conv2.qx_scale"].dtype == torch.float32
    qa = p["LE.HR_conv2.__qargs"]
    assert isinstance(qa, QArgs) and isinstance(qa.scale, float) and qa.zero is None and qa.pad == 0
    assert qa.w.dtype == torch.int8 and qa.w.shape == (128, 9 * 128)
    assert qa.yscale.dtype == qa.bias.dtype == torch.float32
    assert qa.scale == float(ckpt["LE.HR_conv2.x_scale"])
    quantized = sorted(k[: -len(".__qargs")] for k in p if k.endswith(".__qargs"))
    stride2 = ["LE.CondNet2.0", "LE.CondNet3.0", "LE.CondNet3.2", "LE.CondNet4.0", "LE.CondNet4.2",
               "LE.__cond_down", "LE.down_conv1", "LE.down_conv2"]
    assert len(quantized) == 12 + len(stride2) and "LE.up_conv3.0" in quantized
    assert set(stride2) <= set(quantized)
    assert "LE.CondNet1.0.qweight" in p and "LE.CondNet1.0.__qargs" not in p
    branches = p["LE.__cond_down.__qargs"]
    assert "LE.__cond_down.qx_scales" in p and len(branches) == 3
    assert [qa.scale for qa in branches] == [float(ckpt[f"LE.CondNet{i}.0.x_scale"]) for i in (2, 3, 4)]
    assert all(qa.co == 256 and qa.c == 256 and qa.taps == 9 for qa in branches)


# The eager W8A8 program (predequantize off) in fp32 against JAX's, PSNR floor in dB: 3 dB
# under the 123.14 dB seen on the 24×40 smooth frame (fp32: a code flips rarely, and moves
# its output by one u16 code). The int8 frame against the float program sits near 23 dB.
EAGER_FP32_PSNR = 120.1


@pytest.mark.parametrize("case", ["predequantize_arg", "predequantize_env", "odd_size"])
def test_uncovered_int8_options_raise(monkeypatch, tmp_path, ckpt, case):
    """What raised until the natural-layout program was ported now runs as
    in JAX: ``predequantize=False`` (or ``HDRTVNET_PREDEQUANTIZE=0``) keeps
    the int8 layers and runs the eager W8A8 natural program on every frame
    (turbo off), in fp32 within a PSNR floor of JAX's; a frame whose sides
    are not multiples of 8 runs the natural program on the pre-dequantized
    weights, within the fp32 bound."""
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    kw = {}
    if case == "predequantize_arg":
        kw["predequantize"] = False
    elif case == "predequantize_env":
        monkeypatch.setenv("HDRTVNET_PREDEQUANTIZE", "0")
    h, w = (60, 100) if case == "odd_size" else (24, 40)
    frame = smooth_frame(h, w, 67)
    proc = HDRTVNetTorch(FIXTURE, precision="fp32", device="cpu", **kw)
    jproc = HDRTVNetTPU(FIXTURE, precision="fp32", persistent_cache=False, **kw)
    assert (proc.turbo, proc.predequantized) == (jproc.turbo, jproc.predequantized) == (case == "odd_size",) * 2
    assert proc.natural(h, w) and proc.native_int8 == jproc.native_int8 == (case == "odd_size")
    got = proc.process_rgb48(frame).astype(np.int64)
    want = jproc.process_rgb48(frame).astype(np.int64)
    if case == "odd_size":
        assert np.abs(got - want).max() <= 4
    else:
        assert "LE.HR_conv2.weight_int8" in proc.params and "LE.HR_conv2.x_scale" in proc.params
        p = _psnr(got, want)
        print(f"{case}: eager W8A8 fp32 {h}x{w} against JAX {p:.2f} dB")
        assert p >= EAGER_FP32_PSNR, p


if __name__ == "__main__":
    _write_checkpoint(FIXTURE, make_w8a8_checkpoint())
    print("wrote", FIXTURE)
