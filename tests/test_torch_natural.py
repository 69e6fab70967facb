"""The natural-layout frame program of hdrtv_tpu_torch on the CPU, against
hdrtv_tpu: the program ``HDRTVNetTPU`` runs on frames whose sides are not
multiples of 8 (the 540p preset among them), on every frame with turbo off,
and on int8 checkpoints kept int8 (eager W8A8).

Held here, on the same numpy-seeded inputs: the layers the program adds
(``linear``, ``avg_pool``, ``align_to``, ``bilinear_resize``, the int8
branches) against the JAX functions; ``agcm_apply`` and ``ensemble_agcm_le``
against the torch-reference golden at the tolerances of
``tests/test_model_golden.py`` (2e-5, 5e-5) and against JAX; ``le_apply``
with the leaky ReLU and the weighting network; the natural HG composite;
and ``HDRTVNetTorch.process_rgb48`` against ``HDRTVNetTPU.process_rgb48``
with the routing (which frames take the natural program, and that it ends
in ``pack_rgb48`` alone).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import load_fixture

ROOT = os.path.join(os.path.dirname(__file__), "..")
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "hr_w8a8.npz")
CODES = 4  # u16 codes: the 5e-5 golden tolerance × 65535, rounded up
f32 = np.float32


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def nat_params():
    """(jax, torch fp32, torch bf16) natural parameters of the release weights."""
    from hdrtv_tpu.models.import_torch import load_npz
    from hdrtv_tpu_torch.models.hdrtvnet import natural_params_to_torch
    from hdrtv_tpu_torch.models.layers import BF16, F32

    raw = load_npz(WEIGHTS)
    return ({k: jnp.asarray(v) for k, v in raw.items()}, natural_params_to_torch(raw, "cpu", F32),
            natural_params_to_torch(raw, "cpu", BF16))


def _policies(dtype):
    from hdrtv_tpu.models import layers as jl
    from hdrtv_tpu_torch.models import layers as tl

    return (jl.F32, tl.F32) if dtype == "f32" else (jl.BF16, tl.BF16)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _int8_layer(rng, shape, *, asym=False, w8=False):
    """A layer's int8 triplet (numpy) with weights of ``shape`` (HWIO or (in, out))."""
    from hdrtv_tpu_torch.quant.int8 import quantize_weight

    q, sc = quantize_weight(rng.randn(*shape).astype(f32) * 0.2)
    p = {"l.weight_int8": q, "l.bias": (rng.randn(shape[-1]) * 0.1).astype(f32)}
    if w8:
        p["l.scale"] = sc
        return p
    p["l.w_scale"] = sc
    p["l.x_scale"] = f32(1.3 / 127.0 if not asym else 1.6 / 255.0)
    if asym:
        p["l.x_zero"] = f32(-0.3)
    return p


LAYER_CASES = ["linear", "linear_int8", "linear_w8", "conv_int8", "conv_int8_asym", "conv_int8_stride2",
               "conv_gate_on", "conv_gate_off", "avg_pool2", "avg_pool4", "align_crop", "align_pad",
               "bilinear_up"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", LAYER_CASES)
def test_layer_matches_jax(case, dtype):
    from hdrtv_tpu.models import layers as jl
    from hdrtv_tpu_torch.models import layers as tl

    jpol, tpol = _policies(dtype)
    rng = np.random.RandomState(LAYER_CASES.index(case))
    x = (rng.rand(1, 11, 14, 6).astype(f32) * 1.4 - 0.3)
    if case.startswith("linear"):
        x = x[:, 0, 0]  # (1, 6)
        if case == "linear":
            p = {"l.weight": (rng.randn(6, 16) * 0.3).astype(f32), "l.bias": (rng.randn(16) * 0.1).astype(f32)}
        else:
            p = _int8_layer(rng, (6, 16), w8=case == "linear_w8")
    elif case.startswith("conv"):
        if case.startswith("conv_gate"):
            p = {"l.weight": (rng.randn(3, 3, 6, 8) * 0.2).astype(f32), "l.bias": (rng.randn(8) * 0.1).astype(f32),
                 "l.x_scale": f32(1.1 / 127.0), "l.x_on": f32(case == "conv_gate_on")}
        else:
            p = _int8_layer(rng, (3, 3, 6, 8), asym=case == "conv_int8_asym")
    xj = jpol.cast(jnp.asarray(x))
    xt = tpol.cast(torch.from_numpy(x))
    pj = {k: jnp.asarray(v) for k, v in p.items()} if case[:4] in ("line", "conv") else None
    pt = {k: torch.from_numpy(np.array(v)) for k, v in p.items()} if pj is not None else None
    if case.startswith("linear"):
        want, got = jl.linear(pj, "l", xj, policy=jpol), tl.linear(pt, "l", xt, policy=tpol)
    elif case.startswith("conv"):
        stride = 2 if case.endswith("stride2") else 1
        want = jl.conv2d(pj, "l", xj, stride=stride, padding=1, policy=jpol)
        got = tl.conv2d(pt, "l", xt, stride=stride, padding=1, policy=tpol)
    elif case.startswith("avg_pool"):
        k = int(case[-1])
        want, got = jl.avg_pool(xj, k), tl.avg_pool(xt, k)
    elif case == "align_crop":
        want, got = jl.align_to(xj, 8, 9), tl.align_to(xt, 8, 9)
    elif case == "align_pad":
        want, got = jl.align_to(xj, 16, 13), tl.align_to(xt, 16, 13)
    else:
        want, got = jl.bilinear_resize(xj, 25, 31), tl.bilinear_resize(xt, 25, 31)
    assert got.dtype == tpol.compute_dtype and tuple(got.shape) == tuple(want.shape)
    g, w = _np(got), _np(want)
    if case.startswith(("align", "avg_pool")) or (dtype == "f32" and case.startswith(("conv", "linear"))):
        tol = 0.0 if case.startswith("align") else 2e-6
        np.testing.assert_allclose(g, w, atol=tol, rtol=0)
    else:  # bf16 sums in another order, bilinear's weights in another form: one bf16 step
        step = 2.0 ** -7 * np.maximum(1.0, np.abs(w))
        assert (np.abs(g - w) <= step + (1e-6 if dtype == "f32" else 0)).all(), float(np.abs(g - w).max())


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
def test_fake_quant_codes_equal_jax(asym):
    """The fake-quant alone, in fp32: IEEE division, round half to even,
    clip; the same values bit for bit (ties included)."""
    from hdrtv_tpu.models import layers as jl
    from hdrtv_tpu_torch.models import layers as tl

    s = f32(0.5 / 127.0)
    x = np.concatenate([np.random.RandomState(3).randn(2000).astype(f32),
                        (np.arange(-300, 300) + 0.5).astype(f32) * s])  # exact ties of x / s
    p = {"l.x_scale": s}
    if asym:
        p["l.x_zero"] = f32(-0.2)
    want = jl._maybe_fake_quant_act({k: jnp.asarray(v) for k, v in p.items()}, "l", jnp.asarray(x), jl.F32)
    got = tl._maybe_fake_quant_act({k: torch.tensor(v) for k, v in p.items()}, "l", torch.from_numpy(x), tl.F32)
    assert np.array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def test_agcm_apply_matches_golden_and_jax(nat_params):
    from hdrtv_tpu.models.agcm import agcm_apply as jax_agcm
    from hdrtv_tpu_torch.models.agcm import agcm_apply

    pj, pt, _ = nat_params
    fx = load_fixture("ensemble_fp32.npz")
    got = agcm_apply(pt, torch.from_numpy(fx["img"]), torch.from_numpy(fx["cond"])).numpy()
    np.testing.assert_allclose(got, fx["agcm_out"], atol=2e-5, rtol=0)
    want = np.asarray(jax.jit(jax_agcm)(pj, jnp.asarray(fx["img"]), jnp.asarray(fx["cond"])))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_ensemble_agcm_le_matches_golden_and_jax(nat_params):
    from hdrtv_tpu.models.hdrtvnet import ensemble_agcm_le as jax_ensemble
    from hdrtv_tpu_torch.models.hdrtvnet import ensemble_agcm_le

    pj, pt, _ = nat_params
    fx = load_fixture("ensemble_fp32.npz")
    with torch.inference_mode():
        got = ensemble_agcm_le(pt, torch.from_numpy(fx["img"]), torch.from_numpy(fx["cond"])).numpy()
    np.testing.assert_allclose(got, fx["out"], atol=5e-5, rtol=0)
    want = np.asarray(jax.jit(jax_ensemble)(pj, jnp.asarray(fx["img"]), jnp.asarray(fx["cond"])))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_uncovered_agcm_modes_raise(nat_params):
    """The AGCM modes that raised until their port (plain, affine, spatial,
    lowrank) now run: each on seeded parameters (lowrank on the release
    AGCM's HRconv factored at rank 8 by the checkpoint remap) against JAX at
    fp32, 1e-5 (``tests/test_torch_variants.py`` holds every mode in both
    types and against the goldens)."""
    from hdrtv_tpu.models.agcm import agcm_apply as jax_agcm
    from hdrtv_tpu.models.import_torch import convert_state as jax_convert
    from hdrtv_tpu_torch.models.agcm import agcm_apply, agcm_mode
    from hdrtv_tpu_torch.models.import_torch import remap_condition_state
    from hdrtv_tpu_torch.tools.synth_variants import to_torch_layout

    assert agcm_mode("color_condition") == "dynamic" and agcm_mode("lite8") == "lite"
    assert agcm_mode("spatial_mix") == "spatial_mix" and agcm_mode("lowrank") == "lowrank"
    pj, _, _ = nat_params
    rng = np.random.RandomState(183)
    x = rng.rand(1, 24, 32, 3).astype(f32)
    cond = rng.rand(1, 6, 8, 3).astype(f32)

    def conv(shapes):
        return {f"AGCM.{n}.{leaf}": (rng.randn(k, k, ci, co) / np.sqrt(k * k * ci) if leaf == "weight"
                                     else rng.randn(co) * 0.05).astype(f32)
                for n, (k, ci, co) in shapes.items() for leaf in ("weight", "bias")}

    release = {k: np.asarray(v) for k, v in pj.items() if k.startswith("AGCM.")}
    cases = {
        "plain": conv({"conv_first": (1, 3, 16), "HRconv": (1, 16, 16), "conv_last": (1, 16, 3)}),
        "affine": conv({"affine.0": (1, 3, 16), "affine.2": (1, 16, 6)}),
        "spatial": conv({"spatial_in": (1, 3, 32), **{f"spatial_trunk.{2 * i}": (3, 32, 32) for i in range(4)},
                         "spatial_out": (1, 32, 6)}),
        "lowrank8": jax_convert(remap_condition_state(to_torch_layout(release), prefix="AGCM.",
                                                      classifier="lowrank8")),
    }
    for name, p in cases.items():
        want = np.asarray(jax.jit(lambda q, a, c: jax_agcm(q, a, c, classifier=name))(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jnp.asarray(cond)))
        got = agcm_apply({k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}, torch.from_numpy(x),
                         torch.from_numpy(cond), classifier=name).numpy()
        assert np.abs(got - x).max() > 0.01, name
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=name)


def test_le_apply_leakyrelu_weighting_network_matches_jax(nat_params):
    """``act_type="leakyrelu"`` and ``weighting_network=True`` (the mask_est
    head, seeded weights) on a 22×30 input, whose levels 11×15, 6×8, 3×4 make
    every up level crop (``align_to``); fp32 (the bf16 layers are held by the
    frame tests below)."""
    from hdrtv_tpu.models.le_unet import le_apply as jax_le
    from hdrtv_tpu_torch.models.le_unet import le_apply

    pj, pt, _ = nat_params
    rng = np.random.RandomState(22)
    extra = {}
    for i, (k, ci, co) in enumerate(((3, 3, 32), (3, 32, 32), (1, 32, 32), (1, 32, 3))):
        extra[f"LE.mask_est.{2 * i}.weight"] = (rng.randn(k, k, ci, co) * (1.0 / np.sqrt(k * k * ci))).astype(f32)
        extra[f"LE.mask_est.{2 * i}.bias"] = (rng.randn(co) * 0.05 + (0.5 if i == 3 else 0)).astype(f32)
    pj = {**pj, **{k: jnp.asarray(v) for k, v in extra.items()}}
    pt = {**pt, **{k: torch.from_numpy(v) for k, v in extra.items()}}
    img = rng.rand(1, 22, 30, 3).astype(f32)
    kw = {"act_type": "leakyrelu", "weighting_network": True}
    want = np.asarray(jax.jit(lambda p, x: jax_le(p, x, x, **kw))(pj, jnp.asarray(img)))
    with torch.inference_mode():
        got = le_apply(pt, torch.from_numpy(img), torch.from_numpy(img), **kw).numpy()
        base = le_apply(pt, torch.from_numpy(img), torch.from_numpy(img)).numpy()
    assert got.shape == (1, 22, 30, 3)
    assert np.abs(got - base).max() > 0.05  # the two options change the output
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_uncovered_le_archs_raise(nat_params):
    """The LE archs that raised until their port (the clean trunk, the plain
    bottleneck, the cond-direct island, a flat trunk) now run at 24 × 40
    against JAX at fp32, 1e-5: the clean and flat trunks on the release LE
    (its condition branch and SFT layers; a seeded flat trunk3), the other
    two on seeded weights (``tests/test_torch_variants.py`` holds every arch
    of the goldens)."""
    from hdrtv_tpu.models.le_unet import le_apply as jax_le
    from hdrtv_tpu_torch.models.le_unet import le_apply, parse_le_arch

    assert parse_le_arch("sft").kind == "unet" and parse_le_arch("plainbottleneckh8wide64x4").kind == "plain_bottleneck"
    rng = np.random.RandomState(221)
    x = rng.rand(1, 24, 40, 3).astype(f32)
    nf = 8
    release = {k: np.asarray(v) for k, v in nat_params[0].items() if k.startswith("LE.")}

    def conv(k, ci, co):
        return (rng.randn(k, k, ci, co) / np.sqrt(k * k * ci)).astype(f32), (rng.randn(co) * 0.05).astype(f32)

    bottleneck = {"conv_first": (3, 3, nf), "HR_conv1": (3, nf, nf), "down_conv1": (3, nf, nf),
                  "down_conv2": (3, nf, nf), "down_conv3": (3, nf, nf), "up_conv1.0": (3, nf, 4 * nf),
                  "up_conv2.0": (3, nf, 4 * nf), "up_conv3.0": (3, nf, 4 * nf), "HR_conv2": (3, nf, nf),
                  "conv_last": (3, nf, 3), "recon_trunk3.layers.0": (1, nf, 16), "recon_trunk3.layers.2": (3, 16, 16),
                  "recon_trunk3.layers.4": (1, 16, nf)}
    direct = {"low_in": (1, 6, 16), "recon_trunk3.0": (3, 16, 16), "recon_trunk3.2": (3, 16, 16),
              "low_out": (1, 16, 3 * 64)}
    flat = {f"recon_trunk3.layers.{2 * i}": (3, 32, 32) for i in range(4)}
    cases = {"cleantrunk": ({}, release), "plainbottleneckh8wide16x1": (bottleneck, {}),
             "conddirecth8wide16x2": (direct, {}), "flat4": (flat, release)}
    for arch, (shapes, given) in cases.items():
        p = dict(given)
        for n, (k, ci, co) in shapes.items():
            p[f"LE.{n}.weight"], p[f"LE.{n}.bias"] = conv(k, ci, co)
        want = np.asarray(jax.jit(lambda q, a: jax_le(q, a, a, le_arch=arch))(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
        with torch.inference_mode():
            got = le_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                           torch.from_numpy(x), le_arch=arch).numpy()
        assert got.shape == x.shape and np.abs(got - x).max() > 0.01, arch
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=arch)


# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------


def _count_packs(monkeypatch) -> list:
    """Record the shape of each pack_rgb48 call of the runtime, and fail on
    any call of an s2d program."""
    from hdrtv_tpu_torch.ops.pack import pack_rgb48
    from hdrtv_tpu_torch.runtime import processor as port_proc

    packs = []
    monkeypatch.setattr(port_proc, "pack_rgb48", lambda x: packs.append(tuple(x.shape)) or pack_rgb48(x))
    for name in ("ensemble_s2d_rgb48_flat", "ensemble_s2d_rgb48_pairs", "ensemble_s2d_base_flat"):
        monkeypatch.setattr(port_proc, name, lambda *a, **k: pytest.fail("an s2d program ran"))
    return packs


@pytest.fixture(scope="module")
def jax_procs():
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU

    return {
        "fp32": HDRTVNetTPU(WEIGHTS, precision="fp32", persistent_cache=False),
        "bf16": HDRTVNetTPU(WEIGHTS, persistent_cache=False),
        "turbo_off": HDRTVNetTPU(WEIGHTS, persistent_cache=False, turbo=False),
    }


# bf16, port against JAX, u16 codes (max, mean): twice the most seen (256 / 7.51 at 99×131,
# 256 / 7.17 at 60×100; turbo off 256 / 7.60 at 64×96, 256 / 7.21 at 48×64; the W8A8
# checkpoint pre-dequantized 256 / 6.86 at 60×100). Per-op bf16 roundings in another sum
# order: one flipped rounding near full scale is 256 codes, and spreads through the later
# layers (768 / 15.41 seen at 120×136 with turbo off: the bound is per size).
BF16_CODES = (512, 15.2)


@pytest.mark.parametrize("route", ["fp32", "bf16", "turbo_off"])
@pytest.mark.parametrize("h,w", [(99, 131), (60, 100)])
def test_process_rgb48_matches_jax(monkeypatch, jax_procs, h, w, route):
    """The natural program through the runtime: odd sides (99×131: every
    level's ``align_to`` crops), a side not a multiple of 8 (60×100), and
    turbo off (the natural program at sizes the s2d programs take, 64×96 and
    48×64).
    It ends in pack_rgb48 and runs nothing of the s2d programs."""
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    if route == "turbo_off":
        h, w = (64, 96) if h == 99 else (48, 64)
    proc = HDRTVNetTorch(WEIGHTS, precision="fp32" if route == "fp32" else "fp16", device="cpu",
                         turbo=route != "turbo_off")
    assert proc.turbo == jax_procs[route].turbo == (route != "turbo_off")
    assert proc.natural(h, w) and not proc.wants_pairs(h, w) and not jax_procs[route].wants_pairs(h, w)
    packs = _count_packs(monkeypatch)
    frame = (np.random.RandomState(h + w).rand(h, w, 3) * 255).astype(np.uint8)
    got = proc.process_rgb48(frame).astype(np.int64)
    assert packs == [(h, w, 3)]
    want = jax_procs[route].process_rgb48(frame).astype(np.int64)
    assert got.shape == want.shape == (h, w, 3)
    d = np.abs(got - want)
    print(f"{route} {h}x{w}: max {int(d.max())} codes, mean {float(d.mean()):.3f}")
    if route == "fp32":
        assert d.max() <= CODES
    else:
        assert d.max() <= BF16_CODES[0] and d.mean() <= BF16_CODES[1], (int(d.max()), float(d.mean()))


def test_turbo_and_routing_follow_jax(monkeypatch):
    """``turbo`` after the load, the natural program's frames and the pair
    planes, as the JAX runtime decides them: an int8 checkpoint kept int8
    (``predequantize=False``, or ``HDRTVNET_PREDEQUANTIZE=0``) turns turbo
    off; pre-dequantized it keeps it. Pair planes whose sides are not
    multiples of 8 raise (``wants_pairs`` is False there, so no feeder sends
    them); at a /8 size with turbo off they run the natural program."""
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    sizes = [(540, 960), (1080, 1920), (99, 131), (64, 96)]
    for kw in ({}, {"predequantize": False}, {"turbo": False}):
        proc = HDRTVNetTorch(FIXTURE, device="cpu", **kw)
        jproc = HDRTVNetTPU(FIXTURE, persistent_cache=False, **kw)
        assert (proc.turbo, proc.predequantized) == (jproc.turbo, jproc.predequantized), kw
        assert [proc.wants_pairs(*hw) for hw in sizes] == [jproc.wants_pairs(*hw) for hw in sizes], kw
        assert proc.native_int8 == jproc.native_int8, kw
    monkeypatch.setenv("HDRTVNET_PREDEQUANTIZE", "0")
    proc = HDRTVNetTorch(FIXTURE, device="cpu")
    assert not proc.turbo and not proc.predequantized and "LE.HR_conv2.weight_int8" in proc.params
    assert [proc.natural(*hw) for hw in sizes] == [True] * 4
    monkeypatch.delenv("HDRTVNET_PREDEQUANTIZE")
    proc = HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu")
    assert [proc.natural(*hw) for hw in sizes] == [True, False, True, False]
    with pytest.raises(ValueError, match="multiples of 8"):
        proc.process_rgb48_device(torch.zeros((30, 2, 50, 6), dtype=torch.uint8))
    off = HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu", turbo=False)
    frame = (np.random.RandomState(5).rand(32, 48, 3) * 255).astype(np.uint8)
    pairs = off.process_rgb48_device(torch.from_numpy(frame.reshape(16, 2, 24, 6).copy()))
    assert pairs.shape == (16, 2, 24, 6)
    assert np.array_equal(pairs.numpy().reshape(32, 48, 3), off.process_rgb48(frame))


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean(((a.astype(np.float64) - b.astype(np.float64)) / 65535.0) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-20))


def _smooth_frame(h, w, seed):
    from tests.test_torch_int8 import smooth_frame

    return smooth_frame(h, w, seed)


@pytest.mark.parametrize("precision", ["fp16", "fp32"])
def test_eager_w8a8_matches_jax(monkeypatch, precision):
    """``predequantize=False`` on the W8A8 checkpoint: every frame runs the
    natural program with the int8 layers eager (weights dequantized at each
    use, activations fake-quantized), in both packages. Whole int8 frames of
    two implementations drift by whole codes (one flipped code moves every
    int8 layer after it), so the two are held to a PSNR floor that lies above
    the int8 frame's PSNR against the float program on the same weights: a
    program that skipped the fake-quant fails it."""
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    frame = _smooth_frame(60, 100, 61)
    proc = HDRTVNetTorch(FIXTURE, precision=precision, device="cpu", predequantize=False)
    packs = _count_packs(monkeypatch)
    got = proc.process_rgb48(frame)
    assert packs == [(60, 100, 3)]
    want = HDRTVNetTPU(FIXTURE, precision=precision, persistent_cache=False, predequantize=False).process_rgb48(frame)
    # pre-dequantized: the same weights without the fake-quant
    flt = HDRTVNetTorch(FIXTURE, precision=precision, device="cpu").process_rgb48(frame)
    p_jax, p_float = _psnr(got, want), _psnr(got, flt)
    print(f"eager W8A8 {precision} 60x100: PSNR against JAX {p_jax:.2f} dB, against the float program "
          f"{p_float:.2f} dB")
    assert p_float < EAGER_W8A8_PSNR[precision] <= p_jax, (p_jax, p_float)


# The eager W8A8 frame against JAX, PSNR floor in dB: 3 dB under what was seen at 60×100
# (bf16 40.32 dB; fp32 123.57, one code on 0.19% of the values). The int8 frame against
# the float program on the same weights sits at 22.78 dB (bf16), far under either floor.
EAGER_W8A8_PSNR = {"fp16": 37.3, "fp32": 120.5}


def test_predequantized_w8a8_at_odd_size_matches_jax():
    """A W8A8 checkpoint pre-dequantized (the default) at 60×100 runs the
    natural program on the float weights, without fake-quant
    (``predequantize_params`` drops the activation scales), as in JAX, in
    the default precision: the float program's bounds."""
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    frame = _smooth_frame(60, 100, 62)
    proc = HDRTVNetTorch(FIXTURE, device="cpu")
    assert proc.predequantized and proc.turbo and proc.natural(60, 100)
    assert not any(k.endswith((".x_scale", ".weight_int8")) for k in proc._nat_params)
    got = proc.process_rgb48(frame).astype(np.int64)
    want = HDRTVNetTPU(FIXTURE, persistent_cache=False).process_rgb48(frame)
    d = np.abs(got - want.astype(np.int64))
    print(f"pre-dequantized W8A8 bf16 60x100: max {int(d.max())} codes, mean {float(d.mean()):.3f}")
    assert d.max() <= BF16_CODES[0] and d.mean() <= BF16_CODES[1], (int(d.max()), float(d.mean()))


@pytest.fixture(scope="module")
def composite(tmp_path_factory):
    """A composite checkpoint: the release base model under a synthetic
    generator at hg_nf = 16 (``hdrtv_tpu_torch/tools/synth_hg.py``, BatchNorms
    kept)."""
    from hdrtv_tpu_torch.tools.synth_hg import write_synth_hg

    return write_synth_hg(str(tmp_path_factory.mktemp("nat_hg") / "synth16.npz"), nf=16, seed=3)


def test_hg_composite_matches_jax(composite):
    """The natural HG composite (``models/hdrtvnet.py hg_composite``: base,
    mask, /32 reflect pad, ``hg_apply`` with the BatchNorms unfolded, crop)
    against JAX's on the same inputs, in fp32, at 50×70."""
    from hdrtv_tpu.models.hdrtvnet import ModelConfig as JaxCfg
    from hdrtv_tpu.models.hdrtvnet import hg_composite as jax_composite
    from hdrtv_tpu.models.import_torch import load_npz
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig, hg_composite, natural_params_to_torch

    raw = load_npz(composite)
    assert "hg.conv1.1.running_mean" in raw
    img = _smooth_frame(50, 70, 9)[None].astype(f32) / f32(255)
    cond = img[:, ::4, ::4][:, :12, :17].copy()
    cfg = JaxCfg(use_hg=True, hg_nf=16)
    want = np.asarray(jax.jit(lambda p, x, c: jax_composite(p, x, c, cfg))(
        {k: jnp.asarray(v) for k, v in raw.items()}, jnp.asarray(img), jnp.asarray(cond)))
    with torch.inference_mode():
        got = hg_composite(natural_params_to_torch(raw, "cpu"), torch.from_numpy(img), torch.from_numpy(cond),
                           ModelConfig(use_hg=True, hg_nf=16)).numpy()
    assert got.shape == want.shape == (1, 50, 70, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
