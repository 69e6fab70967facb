"""The rest of native int8 (W8A8) in hdrtv_tpu_torch on the CPU, against
hdrtv_tpu: the int8 body of ``fused_down2`` (``HDRTV_INT8_DOWN2=1``), the
int8 steps of ``fused_cond_chain``, the ``pool_out`` form of
``fused_block_conv3``, int8 composite (HG) checkpoints, and the runtime's
``HDRTVNET_TPU_TURBO`` and ``HDRTV_PAIRS_BOUNDARY`` switches.

The same numpy-seeded inputs go through the Pallas kernel in interpret mode
and the port's plain version (what its CUDA kernel is held to on the card):
the codes are equal, and the outputs are within the epilogue's rounding
(XLA on the CPU contracts the body's ``acc·yscale + b`` into one fused
multiply-add, the port keeps the two ops, so fp32 results may sit one ulp
apart, bf16 ones one step apart where that ulp crosses a rounding). Whole
int8 frames are compared statistically, as ``tests/test_torch_int8.py``
``_cascade_note`` explains: one flipped code moves every int8 layer after it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_int8 import FIXTURE, WEIGHTS, _both, _psnr, _ulps, smooth_frame

f32 = np.float32
THRESHOLD = 0.775  # the HG mask's threshold on the base output's max RGB


def _step(a: np.ndarray) -> np.ndarray:
    """One bf16 step of values of magnitude |a| (at least that of 1.0)."""
    return 2.0 ** -7 * np.maximum(1.0, np.abs(a))


def _qnat(rng, ci, co, scale=0.05):
    """A natural (3, 3, ci, co) weight quantized per output channel."""
    from hdrtv_tpu_torch.quant.int8 import quantize_weight

    return quantize_weight(rng.randn(3, 3, ci, co).astype(f32) * scale)


def _calib(lo, hi, asym):
    """Activation scale and zero (None when symmetric) for values in [lo, hi]."""
    if asym:
        return f32((hi - lo) / 255.0), f32(lo)
    return f32(max(abs(lo), abs(hi)) / 127.0), None


# Share of an int8 body's outputs that may differ from the Pallas body's at all:
# fp32, by one ulp where XLA's fused multiply-add rounds once (seen up to 27.8% in
# down2 and 21.4% in the pooled block_conv3); bf16, by a step where that ulp crosses a
# rounding (seen up to 2.0e-5). Twice the fp32 share; 1e-3 in bf16.
SHARE = {"f32": 0.56, "bf16": 1e-3}


def _close(got, want, dtype):
    """Within one fp32 ulp of the epilogue (of magnitude ≤ 2 before the
    activation) or one bf16 step, on at most SHARE of the values."""
    g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    err = np.abs(g - w)
    bound = _ulps(w) if dtype == "f32" else _step(w)
    assert (err <= bound).all(), float(err.max())
    assert float((err > 0).mean()) <= SHARE[dtype], float((err > 0).mean())


# ---------------------------------------------------------------------------
# down2's int8 body
# ---------------------------------------------------------------------------

# (case, Hb, Wb, cf, cin, ch0, natural co per branch, branches, asym, act)
DOWN2_CASES = {
    "sym": (24, 32, 128, None, 0, 64, 1, False, "relu"),
    "asym": (24, 32, 128, None, 0, 64, 1, True, "lrelu"),
    "branches": (24, 32, 256, None, 0, 64, 3, True, "lrelu"),
    "window": (24, 32, 768, 256, 512, 64, 1, False, "lrelu"),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(DOWN2_CASES))
def test_down2_int8_plain_matches_pallas(dtype, case):
    """The plain int8 down2 (``fused_down2_q_ref``, through the wrapper)
    against the Pallas body in interpret mode, on s2d stride-2 weights (the
    Pallas body skips their structurally zero row taps, the port sums them
    densely: exact either way in int32): per tensor symmetric and with a zero
    point (``a_sub`` 1), the consolidated three-branch form with per-branch
    ``x_scales``/``x_zeros`` (``a_sub`` 3), and a ``cin``/``ch0`` window of a
    wider input. Each branch's codes equal JAX's ``_quantize_act``; the
    outputs within one fp32 ulp of the epilogue or one bf16 step, on at
    most SHARE of the values."""
    from hdrtv_tpu.ops.megakernel import _quantize_act as jax_quantize
    from hdrtv_tpu.ops.megakernel import fused_down2 as jax_down2
    from hdrtv_tpu_torch.models.s2d import b_s2d, w_s2d_s2
    from hdrtv_tpu_torch.ops.megakernel import fused_down2
    from hdrtv_tpu_torch.ops.w8a8 import _quantize_act, pack_qargs

    hb, wb, cf, cin, ch0, co_nat, nb, asym, act = DOWN2_CASES[case]
    rng = np.random.RandomState(90 + list(DOWN2_CASES).index(case))
    c = cin or cf
    xj, xt = _both(rng.rand(hb, wb, cf) * 1.4 - 0.3, dtype)
    wqs, wss = zip(*[_qnat(rng, c // 4, co_nat) for _ in range(nb)])
    tq = np.concatenate([w_s2d_s2(w) for w in wqs], axis=-1)
    tsc = np.concatenate([b_s2d(s) for s in wss])
    co = tq.shape[-1]
    b = (rng.randn(co) * 0.1).astype(f32)
    xw = xt[..., ch0 : ch0 + c].float()
    cal = [_calib(float(xw.min()) - 0.05 * i, float(xw.max()) + 0.1 * i, asym) for i in range(nb)]
    qj = {"w_int8": jnp.asarray(tq), "w_scale": jnp.asarray(tsc)}
    if nb > 1:
        qj["x_scales"] = jnp.asarray([s for s, _ in cal], jnp.float32)
        if asym:
            qj["x_zeros"] = jnp.asarray([z for _, z in cal], jnp.float32)
    else:
        qj["x_scale"] = jnp.float32(cal[0][0])
        if asym:
            qj["x_zero"] = jnp.float32(cal[0][1])
    # JAX folds the zero-point term per call, its 9·C products summed in fp32 in
    # XLA's order: hold the bodies to the same bias (as test_torch_int8 _same_bias).
    xs = jnp.repeat(jnp.asarray([s for s, _ in cal], jnp.float32), co // nb)
    bj = jnp.asarray(b)
    if asym:
        wsum = (jnp.asarray(tq).astype(jnp.float32) * jnp.asarray(tsc)).sum(axis=(0, 1, 2))
        bj = bj + (jnp.repeat(jnp.asarray([z for _, z in cal], jnp.float32), co // nb) + 128.0 * xs) * wsum
    bj = np.asarray(bj)
    m = co // nb
    qt = [dataclasses.replace(
        pack_qargs(tq[..., i * m:(i + 1) * m], tsc[i * m:(i + 1) * m], *cal[i], b[i * m:(i + 1) * m]),
        bias=torch.from_numpy(bj[i * m:(i + 1) * m].copy())) for i in range(nb)]
    for i, qa in enumerate(qt):
        want_codes, want_pad = jax_quantize(jnp.asarray(xw.numpy()), cal[i][0], cal[i][1], wb)
        assert np.array_equal(_quantize_act(xw, qa).numpy(), np.asarray(want_codes))
        assert qa.pad == int(want_pad) and (qa.pad != 0) == asym
    wt = torch.zeros((3, 3, c, co), dtype=xt.dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_down2(xj, jnp.zeros((3, 3, c, co), xj.dtype), jnp.asarray(b), act=act, qargs=qj,
                         a_sub=3 if nb > 1 else 1, cin=cin, ch0=ch0)
    got = fused_down2(xt, wt, torch.from_numpy(b), act=act, cin=cin, ch0=ch0,
                      qargs=qt if nb > 1 else qt[0], a_sub=3 if nb > 1 else 1)
    assert got.shape == (hb // 2, wb // 2, co) and got.dtype == xt.dtype
    _close(got, want, dtype)


def test_down2_int8_wrapper_checks_branches():
    from hdrtv_tpu_torch.ops.megakernel import fused_down2
    from hdrtv_tpu_torch.ops.w8a8 import pack_qargs_branches

    rng = np.random.RandomState(3)
    wq = rng.randint(-127, 128, size=(3, 3, 64, 768)).astype(np.int8)
    qas = pack_qargs_branches(wq, np.full(768, 0.01, f32), [0.01, 0.02, 0.03], None, np.zeros(768, f32))
    assert [(q.c, q.co, q.scale) for q in qas] == [(64, 256, f32(0.01)), (64, 256, f32(0.02)), (64, 256, f32(0.03))]
    x, w, b = torch.zeros(8, 8, 64), torch.zeros(3, 3, 64, 768), torch.zeros(768)
    with pytest.raises(ValueError, match="branches"):
        fused_down2(x, w, b, qargs=qas[:2], a_sub=3)
    with pytest.raises(ValueError, match="channels"):
        fused_down2(x, w, b, qargs=qas[0])
    with pytest.raises(ValueError, match="branch scales"):
        pack_qargs_branches(wq, np.full(768, 0.01, f32), [0.01, 0.02, 0.03, 0.04, 0.05], None, np.zeros(768, f32))


# ---------------------------------------------------------------------------
# cond_chain's int8 steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("flags", [(1, 0, 2, 0, 1), (0, 2, 1, 2, 0)], ids=["10201", "02120"])
def test_cond_chain_int8_plain_matches_pallas(dtype, flags):
    """Five 1×1 steps (128 → 128 ×4 → 32, block-diagonal s2d weights as the
    model has them), int8 where ``flags`` is 1 (symmetric) or 2 (zero
    point), each calibrated on the range of the float chain's value there.
    The running value is quantized from fp32 in both; a float step sums in
    another order than XLA, and the int8 step's epilogue is one FMA there,
    so the value may differ in its last bit and, on a rounding boundary,
    flip a code of the next int8 step: seen up to 0.8% of the outputs
    differing beyond the epilogue's rounding (fp32: two ulps; bf16: a step),
    each by at most 3 flipped codes' worth of the last int8 step; bounds 2%
    and 6 flips."""
    from hdrtv_tpu.ops.megakernel import fused_cond_chain as jax_chain
    from hdrtv_tpu_torch.models.s2d import b_s2d, w_s2d_1x1
    from hdrtv_tpu_torch.ops.megakernel import fused_cond_chain, fused_cond_chain_ref
    from hdrtv_tpu_torch.ops.w8a8 import pack_qargs
    from hdrtv_tpu_torch.quant.int8 import quantize_weight

    rng = np.random.RandomState(100 + 10 * flags[0] + flags[1])
    hb, wb = 16, 16
    widths = [(32, 32), (32, 32), (32, 32), (32, 32), (32, 8)]
    xj, xt = _both(rng.rand(hb, wb, 128) * 1.2 - 0.2, dtype)
    nat = [quantize_weight(rng.randn(1, 1, ci, co).astype(f32) * 0.25) for ci, co in widths]
    tq = [w_s2d_1x1(w) for w, _ in nat]
    tsc = [b_s2d(s) for _, s in nat]
    bs = [(rng.randn(4 * co) * 0.1).astype(f32) for _, co in widths]
    wf = [(q[0, 0].astype(f32) * s).astype(f32) for q, s in zip(tq, tsc)]
    pairs_t = [(torch.from_numpy(w).to(xt.dtype), torch.from_numpy(b)) for w, b in zip(wf, bs)]
    # the float chain's value entering each step: its calibration range
    v, ranges = xt.float(), []
    for i, (w, b) in enumerate(pairs_t):
        ranges.append((float(v.min()), float(v.max())))
        v = v @ w.float() + b
        v = torch.where(v >= 0, v, v * 0.1) if i != 4 else v
    qj, qt = [], []
    for i, fl in enumerate(flags):
        if not fl:
            qj.append(None)
            qt.append(None)
            continue
        s, z = _calib(*ranges[i], fl == 2)
        d = {"w_int8": jnp.asarray(tq[i][0, 0]), "w_scale": jnp.asarray(tsc[i]), "x_scale": jnp.float32(s)}
        if z is not None:
            d["x_zero"] = jnp.float32(z)
        qj.append(d)
        bj = jnp.asarray(bs[i])
        if z is not None:  # JAX's fp32 sum of the zero-point term, as the Pallas wrapper folds it
            wsum = (jnp.asarray(tq[i][0, 0]).astype(jnp.float32) * jnp.asarray(tsc[i])).sum(axis=0)
            bj = bj + (jnp.float32(z) + 128.0 * jnp.float32(s)) * wsum
        qt.append(dataclasses.replace(pack_qargs(tq[i], tsc[i], s, z, bs[i]), bias=torch.from_numpy(np.asarray(bj))))
    with pltpu.force_tpu_interpret_mode():
        want = jax_chain(xj, [(jnp.asarray(w).astype(xj.dtype), jnp.asarray(b)) for w, b in zip(wf, bs)], qargs=qj)
    got = fused_cond_chain(xt, pairs_t, qargs=qt)
    assert [tuple(g.shape) for g in got] == [(hb, wb, 128), (hb, wb, 32)]
    last_q = max(i for i, q in enumerate(qt) if q is not None)
    flip = 127.0 * float(qt[last_q].yscale.max())
    for g, w_ in zip(got, want):
        g, w_ = g.float().numpy(), np.asarray(w_.astype(jnp.float32))
        err = np.abs(g - w_)
        exact = _ulps(w_, 2) if dtype == "f32" else _step(w_)
        differ = float((err > exact).mean())
        assert (err <= 6 * flip + _step(w_) * (dtype == "bf16") + exact).all(), float(err.max())
        assert differ <= 0.02, differ
    # every step float: the int8 form off gives the float chain exactly
    plain = fused_cond_chain_ref(xt, pairs_t)
    assert all(torch.equal(a, b) for a, b in zip(fused_cond_chain(xt, pairs_t, qargs=[None] * 5), plain))


def test_cond_chain_int8_wrapper_checks_qargs():
    from hdrtv_tpu_torch.ops.megakernel import fused_cond_chain
    from hdrtv_tpu_torch.ops.w8a8 import pack_qargs

    w = [(torch.zeros(64, 64), torch.zeros(64))] * 4 + [(torch.zeros(64, 16), torch.zeros(16))]
    q3 = pack_qargs(np.zeros((3, 3, 64, 64), np.int8), np.ones(64, f32), 0.1, None, np.zeros(64, f32))
    q1 = pack_qargs(np.zeros((1, 1, 64, 16), np.int8), np.ones(16, f32), 0.1, None, np.zeros(16, f32))
    assert q1.taps == 1 and (q1.c, q1.co) == (64, 16)
    with pytest.raises(ValueError, match="1×1"):
        fused_cond_chain(torch.zeros(4, 4, 64), w, qargs=[q3, None, None, None, None])
    with pytest.raises(ValueError, match="channels"):
        fused_cond_chain(torch.zeros(4, 4, 64), w, qargs=[q1, None, None, None, None])
    with pytest.raises(ValueError, match="five qargs"):
        fused_cond_chain(torch.zeros(4, 4, 64), w, qargs=[None] * 4)


# ---------------------------------------------------------------------------
# block_conv3's pool_out form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["f32", "bf16", "int8_f32", "int8_bf16", "skip_f32"])
def test_block_conv3_pool_out_plain_matches_pallas(form):
    """pool_out: the 2×2 max pool after the ReLU (Hb = Wb = 16, one Pallas
    tile). Float: against the Pallas kernel in interpret mode within 3e-5
    in fp32 (the JAX package's own bound, tests/test_megakernel.py) and one
    step in bf16; int8 (symmetric, Co = 128): within one fp32 ulp of the
    epilogue or one bf16 step, the codes being the same. Also the plain
    version equals the pool of its own full-resolution result, rounded once."""
    from hdrtv_tpu.ops.conv_kernels import fused_block_conv3 as jax_conv
    from hdrtv_tpu_torch.models.s2d import b_s2d, w_s2d_s1
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3
    from hdrtv_tpu_torch.ops.w8a8 import pack_qargs

    dtype = "bf16" if form.endswith("bf16") else "f32"
    rng = np.random.RandomState(110 + len(form))
    hb, wb, c, co = 16, 16, 128, 128
    xj, xt = _both(rng.rand(hb, wb, c) * 1.2 - 0.1, dtype)
    wq, ws = _qnat(rng, c // 4, co // 4)
    tq, tsc = w_s2d_s1(wq), b_s2d(ws)
    wf = (tq.astype(f32) * tsc).astype(f32)
    b = (rng.randn(co) * 0.1).astype(f32)
    sj, st = _both(rng.rand(hb, wb, co) - 0.5, dtype) if form == "skip_f32" else (None, None)
    qj = qt = None
    if form.startswith("int8"):
        s, _ = _calib(-0.1, 1.1, False)
        qj = {"w_int8": jnp.asarray(tq), "w_scale": jnp.asarray(tsc), "x_scale": jnp.float32(s)}
        qt = pack_qargs(tq, tsc, s, None, b)
    wj, wt = jnp.asarray(wf).astype(xj.dtype), torch.from_numpy(wf).to(xt.dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_conv(xj, wj, jnp.asarray(b), relu=True, skip=sj, pool_out=True, qargs=qj)
    got = fused_block_conv3(xt, wt, torch.from_numpy(b), relu=True, skip=st, qargs=qt, pool_out=True)
    assert got.shape == (hb // 2, wb // 2, co) and got.dtype == xt.dtype
    full = fused_block_conv3(xt, wt, torch.from_numpy(b), relu=True, skip=st, qargs=qt)
    assert torch.equal(got, full.reshape(hb // 2, 2, wb // 2, 2, co).amax(dim=(1, 3)))
    if form in ("f32", "skip_f32"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)
    elif form == "bf16":
        err = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
        assert (err <= _step(np.asarray(want.astype(jnp.float32)))).all()
    else:
        _close(got, want, dtype)


def test_block_conv3_pool_out_needs_even_dims():
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3

    with pytest.raises(ValueError, match="even"):
        fused_block_conv3(torch.zeros(6, 5, 128), torch.zeros(3, 3, 128, 128), torch.zeros(128), pool_out=True)


# ---------------------------------------------------------------------------
# HDRTV_INT8_DOWN2=1: the three int8 base programs
# ---------------------------------------------------------------------------


def _count_down2(monkeypatch):
    """fused_down2 calls of both packages, split by whether they pass qargs."""
    from hdrtv_tpu.ops import megakernel as jax_mk
    from hdrtv_tpu_torch.models import s2d as port_s2d

    calls = {"jax": [], "port": []}
    for side, mod in (("jax", jax_mk), ("port", port_s2d)):
        def counted(*a, _fn=mod.fused_down2, _side=side, **k):
            calls[_side].append(k.get("qargs") is not None)
            return _fn(*a, **k)
        monkeypatch.setattr(mod, "fused_down2", counted)
    return calls


# path: (precision, HDRTV_MEGAKERNEL, PSNR floor against JAX in dB). Seen at 120×256
# on the BGR noise frame: 37.51 (mega), 37.39 (no mega), 45.46 dB (fp32); floors
# 3 dB under (twice the mean squared difference), as _cascade_note explains.
DOWN2_PATHS = {
    "int8_bf16_mega": ("fp16", "1", 34.51),
    "int8_bf16_nomega": ("fp16", "0", 34.39),
    "int8_fp32": ("fp32", "1", 42.46),
}


@pytest.mark.parametrize("path", list(DOWN2_PATHS))
def test_int8_down2_programs_match_jax(monkeypatch, path):
    """``HDRTV_INT8_DOWN2=1`` on the W8A8 checkpoint: at 120×256 the JAX
    routing (``conv_s2``: its fused kernel, (Wb/2) % 8, ``pick_rows(Hb/2, 8)
    <= 16``, and Co / (2·a_sub) ≥ 128) quantizes the consolidated CondNet
    down conv and CondNet3.2/4.2 and leaves down_conv1/2 float, in both
    packages (counted on each side); ``HDRTVNetTorch(device="cpu")`` against
    ``HDRTVNetTPU`` with its kernels in interpret mode, per base program, to
    the PSNR floor of DOWN2_PATHS; and the int8 down convs change the frame
    (it differs from the same program without the flag)."""
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    precision, mega, floor = DOWN2_PATHS[path]
    h, w = 120, 256
    frame = (np.random.RandomState(121).rand(h, w, 3) * 255).astype(np.uint8)
    calls = _count_down2(monkeypatch)
    monkeypatch.setenv("HDRTV_MEGAKERNEL", mega)
    monkeypatch.setenv("HDRTV_INT8_DOWN2", "1")
    proc = HDRTVNetTorch(FIXTURE, precision=precision, device="cpu")
    got = proc.process_rgb48(frame)
    assert calls["port"] == [True, True, True, False, False]
    monkeypatch.setenv("HDRTV_FORCE_FUSED_TRACE", "1")
    monkeypatch.setenv("HDRTV_MEGAKERNEL_INTERPRET", "1")
    jproc = HDRTVNetTPU(FIXTURE, precision=precision, persistent_cache=False)
    assert jproc.native_int8 and jproc.turbo
    with pltpu.force_tpu_interpret_mode():
        want = jproc.process_rgb48(frame)
    assert calls["jax"] == [True, True, True, False, False]
    p = _psnr(got, want)
    print(f"{path}: PSNR against JAX {p:.2f} dB")
    assert got.shape == want.shape == (h, w, 3) and p >= floor, p
    monkeypatch.setenv("HDRTV_INT8_DOWN2", "0")
    assert not np.array_equal(proc.process_rgb48(frame), got)


# ---------------------------------------------------------------------------
# int8 composite (HG) checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def int8_composite(tmp_path_factory):
    """An int8 composite on disk: the W8A8 base (the fixture's keys under
    ``base.``) and a synthetic hg_nf = 16 generator (tools/synth_hg.py), its
    layers quantized too (W8A8 weights, placeholder activation scales), so
    that both packages must expand ``hg.*`` int8 keys before the HG's
    BatchNorms fold."""
    from hdrtv_tpu_torch.models.import_npz import load_npz_meta, npz_arch_dict, save_npz
    from hdrtv_tpu_torch.quant.int8 import quantize_params
    from hdrtv_tpu_torch.tools.synth_hg import synth_hg_params

    params = synth_hg_params(16, seed=4, base_path=FIXTURE)
    hg = [k[: -len(".weight")] for k in params if k.startswith("hg.") and k.endswith(".weight")
          and params[k].ndim == 4]
    params = quantize_params(params, hg, mode="w8a8")
    assert sum(k.startswith("hg.") and k.endswith(".weight_int8") for k in params) == 21
    arch = dict(npz_arch_dict(load_npz_meta(FIXTURE)))
    arch.update({"use_hg": True, "hg_nf": 16})
    path = str(tmp_path_factory.mktemp("hg8") / "int8_composite.npz")
    save_npz(path, params, {"architecture": arch})
    return path


def test_int8_composite_loads_like_jax(int8_composite):
    """The load: pre-dequantized (hg.* included), s2d-transformed with the
    HG's BatchNorms folded, the base's W8A8 layers attached: the port's
    parameters equal the JAX runtime's, key for key, in fp32."""
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    proc = HDRTVNetTorch(int8_composite, precision="fp32", device="cpu")
    jproc = HDRTVNetTPU(int8_composite, precision="fp32", persistent_cache=False)
    assert proc.cfg.use_hg and proc.predequantized and proc.native_int8 and not proc.wants_pairs(64, 96)
    assert jproc.turbo and jproc.predequantized and jproc.native_int8
    want = {k: np.asarray(v) for k, v in jproc.params.items()}
    got = {k: v for k, v in proc.params.items() if isinstance(v, torch.Tensor) and not k.startswith(("AGCM.__", "LE.__head", "LE.__trunk3"))}
    assert set(got) <= set(want) and any(k.startswith("hg.") for k in got)
    assert "LE.HR_conv2.qweight" in got and "LE.__cond_down.qx_scales" in got
    for k, v in got.items():  # (a scale the port holds as shape (1,) is a JAX scalar)
        assert np.array_equal(v.numpy().reshape(want[k].shape), want[k]), k


def _base_max_rgb(path, frame, precision):
    """Max RGB of the int8 base program's output for ``frame`` (the port's own
    no-HG int8 program), which the HG mask thresholds."""
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    base = HDRTVNetTorch(path, precision=precision, device="cpu", use_hg=False).process_rgb48(frame)
    return base.astype(np.float32).max(axis=-1) / 65535.0


@pytest.mark.parametrize("precision", ["fp32", "fp16"], ids=["fp32", "bf16"])
def test_int8_composite_matches_jax(monkeypatch, int8_composite, precision):
    """``HDRTVNetTorch(device="cpu")`` on the int8 composite against
    ``HDRTVNetTPU`` with its kernels in interpret mode (what a TPU runs: the
    int8 base bodies, the HG in float, the hg_tail kernel), at 64×96 on the
    smooth frame. The port runs the int8 tail kernel unpacked under the mega
    base (bf16) and hg_tail once. Pixels whose base max-RGB lies within a
    margin of the mask's threshold (2e-3 in fp32, 0.02 in bf16: the int8
    bases of the two packages differ by a flipped code there, not a last
    bit) are counted apart, as in tests/test_torch_hg.py, seen 0.98% / 11.6%
    of the pixels (bounds twice that); the rest to a PSNR floor 3 dB under
    what was seen (123.03 dB fp32: the two int8 fp32 programs agree almost
    exactly on this frame; 45.20 dB bf16)."""
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.models import hg_s2d as port_hg
    from hdrtv_tpu_torch.models import s2d as port_s2d
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    h, w = 64, 96
    frame = smooth_frame(h, w, 66)
    calls = {}
    for mod, name in ((port_s2d, "fused_tail"), (port_hg, "fused_hg_tail"), (port_s2d, "fused_block_conv3")):
        def counted(*a, _fn=getattr(mod, name), _name=name, **k):
            key = _name + ("_q" if k.get("qargs") is not None or k.get("qargs_hr") is not None else "")
            key += "_unpacked" if _name == "fused_tail" and not k.get("pack", True) else ""
            calls[key] = calls.get(key, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    monkeypatch.delenv("HDRTV_HG_TAIL", raising=False)
    proc = HDRTVNetTorch(int8_composite, precision=precision, device="cpu")
    got = proc.process_rgb48(frame).astype(np.int64)
    if precision == "fp16":
        # up_conv3 int8; up_conv2's L2 level is 12 blocks wide here, so float (Wb % 8)
        assert calls == {"fused_tail_q_unpacked": 1, "fused_hg_tail": 1, "fused_block_conv3_q": 1,
                         "fused_block_conv3": 1}
    else:
        assert calls == {"fused_hg_tail": 1, "fused_block_conv3_q": 7, "fused_block_conv3": 5}
    monkeypatch.setenv("HDRTV_FORCE_FUSED_TRACE", "1")
    monkeypatch.setenv("HDRTV_MEGAKERNEL_INTERPRET", "1")
    with pltpu.force_tpu_interpret_mode():
        want = HDRTVNetTPU(int8_composite, precision=precision, persistent_cache=False).process_rgb48(frame)
    want = want.astype(np.int64)
    m = _base_max_rgb(int8_composite, frame, precision)
    near = np.abs(m - THRESHOLD) <= (2e-3 if precision == "fp32" else 0.02)
    d = (got - want)[~near]
    p = 10 * np.log10(1.0 / max(float(np.mean((d / 65535.0) ** 2)), 1e-20))
    print(f"int8 composite {precision}: {near.mean():.4f} of the pixels near the threshold, PSNR {p:.2f} dB")
    seen_share, seen_psnr = {"fp32": (0.0098, 123.03), "fp16": (0.1159, 45.20)}[precision]
    assert near.mean() <= 2 * seen_share, float(near.mean())
    assert p >= seen_psnr - 3.0, p
    assert 0.1 < (m > THRESHOLD).mean() < 0.9  # the mask is set on a share of the frame


# ---------------------------------------------------------------------------
# The runtime's two switches (ROADMAP Queue 3)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("how", ["env", "arg"])
def test_turbo_off_raises_like_jax_leaves_s2d(monkeypatch, how):
    """``HDRTVNET_TPU_TURBO=0`` (or ``turbo=False``): the JAX runtime leaves
    the s2d programs (``turbo`` False: ``model_apply``, the natural layout,
    on every frame), and so does the port: a 32×48 frame, whose sides the
    s2d programs take, runs the natural program, in fp32 within 4 codes of
    JAX's, with pair planes off."""
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    kw = {"precision": "fp32"}
    if how == "env":
        monkeypatch.setenv("HDRTVNET_TPU_TURBO", "0")
    else:
        kw["turbo"] = False
    jproc = HDRTVNetTPU(WEIGHTS, persistent_cache=False, **kw)
    proc = HDRTVNetTorch(WEIGHTS, device="cpu", **kw)
    assert not jproc.turbo and not proc.turbo and proc.natural(32, 48)
    assert not proc.wants_pairs(32, 48) and not jproc.wants_pairs(32, 48)
    frame = smooth_frame(32, 48, 33)
    got = proc.process_rgb48(frame).astype(np.int64)
    assert np.abs(got - jproc.process_rgb48(frame).astype(np.int64)).max() <= 4
    monkeypatch.setenv("HDRTVNET_TPU_TURBO", "1")
    assert HDRTVNetTorch(WEIGHTS, device="cpu", turbo=True).wants_pairs(64, 96)


def test_pairs_boundary_off_ships_flat_rows(monkeypatch):
    """``HDRTV_PAIRS_BOUNDARY=0``, read at each call: ``wants_pairs`` is False
    as in the JAX runtime (at every size, where it was True), ``put_frame``
    ships (H, 3W) rows, the flat program runs, and the u16 frame is the same
    as through the pair planes, bit for bit (the megakernel program reads the
    rows as pair planes by a reshape)."""
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.runtime import processor as port_proc
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    proc = HDRTVNetTorch(WEIGHTS, device="cpu")
    jproc = HDRTVNetTPU(WEIGHTS, persistent_cache=False)
    sizes = [(64, 96), (120, 256), (1080, 1920), (60, 100)]
    frame = smooth_frame(64, 96, 7)
    flat = frame.reshape(64, 3 * 96)
    monkeypatch.delenv("HDRTV_PAIRS_BOUNDARY", raising=False)
    assert [proc.wants_pairs(*s) for s in sizes] == [jproc.wants_pairs(*s) for s in sizes] == [True] * 3 + [False]
    x = proc.put_frame(flat)
    assert x.shape == (32, 2, 48, 6)
    pairs = proc.process_rgb48_device(x).numpy().reshape(64, 96, 3)

    calls = []
    monkeypatch.setattr(port_proc, "ensemble_s2d_rgb48_pairs", lambda *a, **k: calls.append(1))
    monkeypatch.setenv("HDRTV_PAIRS_BOUNDARY", "0")
    assert [proc.wants_pairs(*s) for s in sizes] == [jproc.wants_pairs(*s) for s in sizes] == [False] * 4
    x = proc.put_frame(flat)
    assert x.shape == (64, 3 * 96)
    rows = proc.process_rgb48_device(x).numpy()
    assert rows.shape == (64, 3 * 96) and not calls
    assert np.array_equal(rows.reshape(64, 96, 3), pairs)
    assert np.array_equal(proc.process_rgb48(frame), pairs)
