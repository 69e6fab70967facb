"""The frame programs of hdrtv_tpu_torch on the CPU against hdrtv_tpu.

fp32: the condition image, the classifier, the s2d ensemble (also against
the torch-reference golden), and HDRTVNetTorch.process_rgb48 against
HDRTVNetTPU.process_rgb48 on the same frames, and the megakernel program's
structure in fp32 against the JAX ``_ensemble_mega``. bf16: the default
(megakernel) program against the JAX program a TPU runs by default, with its
Pallas kernels in interpret mode; the program without the megakernels
(HDRTV_MEGAKERNEL=0) against its JAX counterpart and against the JAX lax
program. Plus the gates: ``_mega_ok`` routes as the JAX predicate does, what
the port does not cover raises, and importing the port imports no JAX."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import load_fixture

ROOT = os.path.join(os.path.dirname(__file__), "..")
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
CODES = 4  # u16 codes: the 5e-5 golden tolerance × 65535, rounded up


@pytest.fixture(scope="module")
def params():
    from hdrtv_tpu.models.import_torch import load_npz
    from hdrtv_tpu.models.s2d import s2d_transform_params
    from hdrtv_tpu_torch.models.s2d import params_to_torch

    sp = s2d_transform_params(load_npz(WEIGHTS))
    return {k: jnp.asarray(v) for k, v in sp.items()}, params_to_torch(sp, "cpu")


@pytest.fixture(scope="module")
def processors():
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    return (
        HDRTVNetTPU(WEIGHTS, precision="fp32", persistent_cache=False),
        HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu"),
    )


def test_quarter_aa_matches_torch_golden():
    from hdrtv_tpu_torch.ops.resize import downsample_quarter_aa

    fx = load_fixture("cond_resize.npz")
    out = downsample_quarter_aa(torch.from_numpy(fx["frame"]))
    np.testing.assert_allclose(out.numpy(), fx["quarter_bicubic_aa"], atol=2e-6, rtol=0)


@pytest.mark.parametrize("bgr", [False, True])
def test_quarter_aa_flat_matches_jax(bgr):
    from hdrtv_tpu.ops.resize import downsample_quarter_aa_flat as jax_flat
    from hdrtv_tpu_torch.ops.resize import downsample_quarter_aa, downsample_quarter_aa_flat

    frame = (np.random.RandomState(4).rand(48, 80, 3) * 255).astype(np.uint8)
    flat = frame.reshape(48, 240)
    got = downsample_quarter_aa_flat(torch.from_numpy(flat), bgr=bgr).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_flat(jnp.asarray(flat), bgr=bgr)), atol=2e-6, rtol=0)
    img = (frame[..., ::-1] if bgr else frame).astype(np.float32)[None] / np.float32(255)
    nat = downsample_quarter_aa(torch.from_numpy(np.ascontiguousarray(img))).numpy()
    np.testing.assert_allclose(got, nat, atol=2e-6, rtol=0)


def test_classifier_matches_jax(params):
    from hdrtv_tpu.models.agcm import classifier_apply as jax_cls
    from hdrtv_tpu_torch.models.agcm import classifier_apply

    pj, pt = params
    cond = np.random.RandomState(6).rand(1, 24, 40, 3).astype(np.float32)
    want = np.asarray(jax_cls(pj, "AGCM.classifier.", "color_condition", jnp.asarray(cond)))
    got = classifier_apply(pt, "AGCM.classifier.", "color_condition", torch.from_numpy(cond)).numpy()
    assert got.shape == want.shape == (1, 6)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_ensemble_s2d_matches_golden_and_jax(params):
    from hdrtv_tpu.models.s2d import ensemble_s2d as jax_ensemble
    from hdrtv_tpu_torch.models.s2d import ensemble_s2d

    pj, pt = params
    fx = load_fixture("ensemble_fp32.npz")
    with torch.inference_mode():
        got = ensemble_s2d(pt, torch.from_numpy(fx["img"]), torch.from_numpy(fx["cond"])).numpy()
    np.testing.assert_allclose(got, fx["out"], atol=5e-5, rtol=0)
    want = np.asarray(jax_ensemble(pj, jnp.asarray(fx["img"]), jnp.asarray(fx["cond"])))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("h,w", [(64, 96), (128, 192)])
def test_process_rgb48_matches_jax(processors, h, w):
    jax_proc, proc = processors
    frame = (np.random.RandomState(h).rand(h, w, 3) * 255).astype(np.uint8)
    want = jax_proc.process_rgb48(frame).astype(np.int64)
    got = proc.process_rgb48(frame)
    assert got.shape == (h, w, 3) and got.dtype == np.uint16
    assert np.abs(got.astype(np.int64) - want).max() <= CODES

    # the device entries: (Hb, 2, Wb, 6) pair planes and (H, 3W) flat rows
    flat = frame.reshape(h, 3 * w)
    pairs = proc.process_rgb48_device(proc.put_frame(flat))
    assert pairs.shape == (h // 2, 2, w // 2, 6) and pairs.dtype == torch.uint16
    rows = proc.process_rgb48_device(torch.from_numpy(flat.copy()))
    assert rows.shape == (h, 3 * w)
    assert np.array_equal(pairs.numpy().reshape(h, w, 3), got)
    assert np.array_equal(rows.numpy().reshape(h, w, 3), got)


def test_default_device_needs_cuda(monkeypatch):
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        HDRTVNetTorch(WEIGHTS, precision="fp32")


def test_bf16_slice_matches_jax_kernel_path(monkeypatch):
    """The bf16 program without the megakernels (HDRTV_MEGAKERNEL=0) on a
    120×256 frame, the smallest size that routes like 1080p, against
    ``ensemble_s2d_rgb48_flat`` with every Pallas kernel of the non-mega path
    executed in interpret mode.

    Tolerance: the JAX package's own all-lax bf16 program differs from that
    kernel path by max 256 and mean 22.1 codes on this frame (one bf16 step
    near 1.0 is 256 codes). The port, whose plain versions round where the
    kernel bodies round, shows max 256 and mean 6.6; the bounds are twice
    that: the remaining differences are fp32 sums taken in another order
    flipping a rounding, which then spreads through the later layers."""
    from jax.experimental.pallas import tpu as pltpu

    from hdrtv_tpu.models.import_torch import load_npz
    from hdrtv_tpu.models.layers import BF16
    from hdrtv_tpu.models.s2d import ensemble_s2d_rgb48_flat, s2d_transform_params
    from hdrtv_tpu_torch.models import s2d as port_s2d
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    h, w = 120, 256
    frame = (np.random.RandomState(120).rand(h, w, 3) * 255).astype(np.uint8)

    calls = {}
    for name in ("fused_sft_conv3_v2", "fused_resblock", "fused_mix_chain", "fused_down2",
                 "fused_block_conv3", "fused_trunk3"):
        def counted(*a, _fn=getattr(port_s2d, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(port_s2d, name, counted)
    monkeypatch.setenv("HDRTV_MEGAKERNEL", "0")
    proc = HDRTVNetTorch(WEIGHTS, device="cpu")
    assert proc.policy.compute_dtype == torch.bfloat16
    got = proc.process_rgb48(frame).astype(np.int64)
    assert calls == {"fused_sft_conv3_v2": 6, "fused_resblock": 2, "fused_mix_chain": 1,
                     "fused_down2": 5, "fused_block_conv3": 2, "fused_trunk3": 1}

    sp = {k: jnp.asarray(v) for k, v in s2d_transform_params(load_npz(WEIGHTS)).items()}
    monkeypatch.setenv("HDRTV_FORCE_FUSED_TRACE", "1")
    monkeypatch.setenv("HDRTV_MEGAKERNEL_INTERPRET", "1")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ensemble_s2d_rgb48_flat(
            sp, jnp.asarray(frame.reshape(h, 3 * w)), None, policy=BF16, bgr=True))
    d = np.abs(got - want.reshape(h, w, 3).astype(np.int64))
    assert d.max() <= 512 and d.mean() <= 13.2, (int(d.max()), float(d.mean()))


def test_bf16_slice_matches_jax_lax_program(monkeypatch):
    """bf16 without the megakernels against ``HDRTVNetTPU(precision="fp16")``,
    which off the TPU runs the all-lax program: within 3e-2 of full scale, the
    bound the JAX tests put between two bf16 programs that round at different
    places."""
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    monkeypatch.setenv("HDRTV_MEGAKERNEL", "0")
    frame = (np.random.RandomState(64).rand(64, 96, 3) * 255).astype(np.uint8)
    want = HDRTVNetTPU(WEIGHTS, precision="fp16", persistent_cache=False).process_rgb48(frame)
    got = HDRTVNetTorch(WEIGHTS, precision="fp16", device="cpu").process_rgb48(frame)
    assert got.shape == (64, 96, 3) and got.dtype == np.uint16
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 3e-2 * 65535


def _jax_params():
    from hdrtv_tpu.models.import_torch import load_npz
    from hdrtv_tpu.models.s2d import s2d_transform_params

    return {k: jnp.asarray(v) for k, v in s2d_transform_params(load_npz(WEIGHTS)).items()}


def test_ensemble_mega_fp32_matches_jax(params, monkeypatch):
    """The megakernel program's structure, in fp32 where rounding does not
    blur it: the port's ``_ensemble_mega`` with ``F32`` against the JAX
    ``_ensemble_mega`` (its three megakernels in interpret mode, which admits
    fp32) on 64×96 u8 pair planes read as BGR, packed: ≤ 4 u16 codes, the
    fp32 frame bound."""
    from jax.experimental.pallas import tpu as pltpu

    from hdrtv_tpu.models.layers import F32 as JAX_F32
    from hdrtv_tpu.models.s2d import _ensemble_mega as jax_mega
    from hdrtv_tpu.ops.resize import downsample_quarter_aa_pairs as jax_cond
    from hdrtv_tpu_torch.models.layers import F32
    from hdrtv_tpu_torch.models.s2d import _ensemble_mega
    from hdrtv_tpu_torch.ops.resize import downsample_quarter_aa_pairs

    pj, pt = params
    h, w = 64, 96
    xr = (np.random.RandomState(96).rand(h // 2, 2, w // 2, 6) * 255).astype(np.uint8)
    monkeypatch.setenv("HDRTV_MEGAKERNEL_INTERPRET", "1")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_mega(pj, jnp.asarray(xr), jax_cond(jnp.asarray(xr), bgr=True),
                                   policy=JAX_F32, pack=True, scale=1.0 / 255.0, bgr=True))
    xt = torch.from_numpy(xr.copy())
    with torch.inference_mode():
        got = _ensemble_mega(pt, xt, downsample_quarter_aa_pairs(xt, bgr=True),
                             policy=F32, pack=True, scale=1.0 / 255.0, bgr=True)
    assert got.shape == (h // 2, 2, w // 2, 6) and got.dtype == torch.uint16
    d = np.abs(got.numpy().astype(np.int64) - want.astype(np.int64))
    assert want.max() > want.min() and d.max() <= CODES, int(d.max())
    # unpacked, from a float s2d frame: the same values before the pack
    xs = torch.cat([xt[:, 0], xt[:, 1]], dim=-1).float() * (1.0 / 255.0)
    with torch.inference_mode():
        y = _ensemble_mega(pt, xs, downsample_quarter_aa_pairs(xt, bgr=True), policy=F32, pack=False, bgr=True)
    assert y.shape == (h // 2, w // 2, 12) and y.dtype == torch.float32
    u = (y.clamp(0, 1) * 65535.0 + 0.5).to(torch.int32).numpy()
    u = np.stack([u[..., :6], u[..., 6:]], axis=1)
    assert np.abs(u - got.numpy().astype(np.int64)).max() <= 1


def test_bf16_mega_slice_matches_jax_mega_program(monkeypatch):
    """The default program: ``HDRTVNetTorch(device="cpu").process_rgb48`` on a
    120×256 BGR frame against the JAX ``ensemble_s2d_rgb48_pairs`` with
    ``BF16``, ``bgr=True`` and every Pallas kernel (the three megakernels and
    the others) in interpret mode: the program a TPU runs by default.

    Seen: max 96, mean 6.53 codes (94% of the values differ: the tail packs an
    fp32 sum, so an upstream bf16 flip shows as a few codes everywhere). The
    bounds are twice that. For scale: the JAX package's own all-lax bf16
    program differs from this kernel program by max 743 / mean 112.6 codes on
    this frame, and so does the program without the megakernels (743 / 111.4),
    which rounds the AGCM modulation in bf16 where the head kernel keeps it in
    fp32: the two programs differ by design."""
    from jax.experimental.pallas import tpu as pltpu

    from hdrtv_tpu.models.layers import BF16
    from hdrtv_tpu.models.s2d import ensemble_s2d_rgb48_pairs
    from hdrtv_tpu_torch.models import s2d as port_s2d
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    h, w = 120, 256
    frame = (np.random.RandomState(120).rand(h, w, 3) * 255).astype(np.uint8)
    calls = {}
    for name in ("fused_agcm_head", "fused_cond_chain", "fused_tail", "fused_sft_conv3_v2", "fused_resblock",
                 "fused_mix_chain", "fused_down2", "fused_block_conv3", "fused_trunk3", "pack_rgb48"):
        def counted(*a, _fn=getattr(port_s2d, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(port_s2d, name, counted)
    monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    got = HDRTVNetTorch(WEIGHTS, device="cpu").process_rgb48(frame).astype(np.int64)
    assert calls == {"fused_agcm_head": 1, "fused_cond_chain": 1, "fused_tail": 1, "fused_sft_conv3_v2": 5,
                     "fused_resblock": 2, "fused_mix_chain": 1, "fused_down2": 5, "fused_block_conv3": 2,
                     "fused_trunk3": 1}

    monkeypatch.setenv("HDRTV_FORCE_FUSED_TRACE", "1")
    monkeypatch.setenv("HDRTV_MEGAKERNEL_INTERPRET", "1")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ensemble_s2d_rgb48_pairs(
            _jax_params(), jnp.asarray(frame.reshape(h // 2, 2, w // 2, 6)), None, policy=BF16, bgr=True))
    d = np.abs(got - want.reshape(h, w, 3).astype(np.int64))
    assert d.max() <= 192 and d.mean() <= 13.1, (int(d.max()), float(d.mean()))


@pytest.mark.parametrize("mega", ["1", "0"], ids=["mega", "HDRTV_MEGAKERNEL=0"])
def test_bf16_entries_give_the_same_bytes(monkeypatch, mega):
    """Pair planes, flat rows and (H, W, 3) are three views of one frame: the
    three entries return the same bytes, in either bf16 program."""
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    monkeypatch.setenv("HDRTV_MEGAKERNEL", mega)
    h, w = 64, 96
    frame = (np.random.RandomState(7).rand(h, w, 3) * 255).astype(np.uint8)
    proc = HDRTVNetTorch(WEIGHTS, device="cpu")
    got = proc.process_rgb48(frame)
    flat = frame.reshape(h, 3 * w)
    pairs = proc.process_rgb48_device(proc.put_frame(flat))
    assert pairs.shape == (h // 2, 2, w // 2, 6) and pairs.dtype == torch.uint16
    rows = proc.process_rgb48_device(torch.from_numpy(flat.copy()))
    hwc = proc.process_rgb48_device(torch.from_numpy(frame.copy()))
    assert rows.shape == (h, 3 * w) and hwc.shape == (h, w, 3)
    for other in (pairs, rows, hwc):
        assert np.array_equal(other.numpy().reshape(h, w, 3), got)


def test_bf16_rgb_entries_take_the_mega_program(monkeypatch):
    """``ensemble_s2d_rgb48`` ((H, W, 3) RGB u8 and a given condition image)
    returns the flat entry's bytes, and ``ensemble_s2d`` (a float image, no
    pack) the same frame before the pack: its bf16 result, packed, is within
    one bf16 step (256 codes at the top of the range) of the tail's own pack
    of the unrounded sum. Each goes through the tail wrapper once (packing or
    not); ``mega=False`` does not."""
    from hdrtv_tpu_torch.models import s2d as port_s2d
    from hdrtv_tpu_torch.models.layers import BF16
    from hdrtv_tpu_torch.ops.pack import pack_rgb48
    from hdrtv_tpu_torch.ops.resize import downsample_quarter_aa
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    calls = []
    monkeypatch.setattr(port_s2d, "fused_tail",
                        lambda *a, _fn=port_s2d.fused_tail, **k: (calls.append(k["pack"]), _fn(*a, **k))[1])
    h, w = 64, 96
    frame = torch.from_numpy((np.random.RandomState(8).rand(h, w, 3) * 255).astype(np.uint8))
    p = HDRTVNetTorch(WEIGHTS, device="cpu").params
    img = frame[None].float() * (1.0 / 255.0)
    cond = downsample_quarter_aa(img)
    with torch.inference_mode():
        packed = port_s2d.ensemble_s2d_rgb48(p, frame, cond, policy=BF16)
        flat = port_s2d.ensemble_s2d_rgb48_flat(p, frame.reshape(h, 3 * w), cond, policy=BF16)
        y = port_s2d.ensemble_s2d(p, img, cond, policy=BF16)
        assert calls == [True, True, False]
        lax = port_s2d.ensemble_s2d(p, img, cond, policy=BF16, mega=False)
        assert calls == [True, True, False]
    assert packed.shape == (h, w, 3) and packed.dtype == torch.uint16
    assert torch.equal(packed.reshape(h, 3 * w), flat)
    assert y.shape == lax.shape == (1, h, w, 3) and y.dtype == torch.bfloat16
    d = (pack_rgb48(y[0]).to(torch.int32) - packed.to(torch.int32)).abs()
    assert int(d.max()) <= 256


def test_mega_ok_routes_like_jax(params, monkeypatch):
    """Both packages send a frame size down the same program: the port's
    ``_mega_ok`` equals the JAX predicate (asked with its interpret switch on,
    which lifts its backend gate and nothing else for bf16) over sizes on
    either side of each shape rule, and HDRTV_MEGAKERNEL=0 turns both off."""
    from hdrtv_tpu.models.layers import BF16 as JAX_BF16
    from hdrtv_tpu.models.s2d import _mega_ok as jax_ok
    from hdrtv_tpu_torch.models.layers import BF16, F32
    from hdrtv_tpu_torch.models.s2d import _mega_ok

    pj, pt = params
    monkeypatch.setenv("HDRTV_MEGAKERNEL_INTERPRET", "1")
    monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    sizes = [(1080, 1920), (720, 1280), (2160, 3840), (360, 640), (120, 256), (64, 96), (128, 192),
             (16, 24), (12, 32), (16, 32), (14, 32), (68, 64), (74, 64), (106, 64), (64, 40), (64, 72)]
    routed = {}
    for h, w in sizes:
        shape = (1, h // 2, w // 2, 12)
        routed[(h, w)] = _mega_ok(pt, shape, BF16)
        assert routed[(h, w)] == jax_ok(pj, shape, JAX_BF16), (h, w)
    assert routed[(1080, 1920)] and routed[(120, 256)] and routed[(64, 96)] and routed[(360, 640)]
    assert not routed[(16, 24)] and not routed[(12, 32)] and not routed[(14, 32)] and not routed[(74, 64)]
    assert not _mega_ok(pt, (2, 60, 128, 12), BF16) and not _mega_ok(pt, (1, 60, 128, 16), BF16)
    assert not _mega_ok(pt, (1, 60, 128, 12), F32)
    assert not _mega_ok({k: v for k, v in pt.items() if k != "LE.__in_fused.weight"}, (1, 60, 128, 12), BF16)
    monkeypatch.setenv("HDRTV_MEGAKERNEL", "0")
    assert not _mega_ok(pt, (1, 60, 128, 12), BF16) and not jax_ok(pj, (1, 60, 128, 12), JAX_BF16)


def test_params_are_cast_once_at_load():
    """Under bf16 the processor holds weights in bf16 and, in fp32, exactly
    the biases the kernels take and the norm parameters; a frame then casts
    no parameter again (``Policy.cast`` returns a tensor of the right dtype
    as it is, and the kernels refuse a bias that is not fp32)."""
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    p = HDRTVNetTorch(WEIGHTS, device="cpu").params
    assert p["LE.HR_conv1.weight"].dtype == torch.bfloat16
    assert p["LE.HR_conv1.bias"].dtype == torch.float32  # block conv kernel
    assert p["LE.SFT_layer1.SFT_scale_conv0.bias"].dtype == torch.float32  # sft_conv3 kernel
    assert p["LE.CondNet2.4.bias"].dtype == torch.float32  # mix_chain kernel
    assert p["LE.recon_trunk3.0.sft1.SFT_shift_conv1.bias"].dtype == torch.float32  # trunk3 kernel
    assert p["LE.conv_last.bias"].dtype == torch.float32  # tail kernel
    assert p["LE.CondNet1.4.bias"].dtype == torch.float32  # cond_chain kernel
    assert p["AGCM.HRconv.bias"].dtype == torch.float32  # agcm_head kernel
    assert p["AGCM.cond_scale_first.bias"].dtype == torch.bfloat16  # torch linear (the modulation vectors)
    # the head's bf16 s2d kernels read agcm_head_pack_s2d's blocks (aw1's for BGR too), not the dense pack
    assert p["AGCM.__head_s2d_w1_bgr"].dtype == torch.bfloat16 and p["AGCM.__head_s2d_w1_bgr"].shape == (16, 64)
    assert p["LE.__head_s2d_win"].dtype == torch.bfloat16 and p["LE.__head_s2d_win"].shape == (4, 32, 96)
    assert p["LE.__head_s2d_bin"].dtype == torch.float32
    assert p["LE.CondNet3.4.bias"].dtype == torch.bfloat16  # torch 1×1 (Co = 64)
    assert p["AGCM.classifier.model.3.weight"].dtype == torch.float32  # instance norm
    # trunk3's bf16 instance reads its bf16 pack: weights bf16, biases fp32
    assert p["LE.__trunk3_packed_bf16_w"].dtype == torch.bfloat16
    assert p["LE.__trunk3_packed_bf16_b"].dtype == torch.float32
    assert "LE.__trunk3_packed" not in p and "LE.__head_wcat" not in p
    fp32 = HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu").params
    assert all(v.dtype == torch.float32 for v in fp32.values() if v.is_floating_point())
    # the fp32 instances read the fp32 block and the dense head's padded matrices
    assert fp32["LE.__trunk3_packed"].dtype == torch.float32 and fp32["LE.__head_wcat"].shape == (112, 384)
    assert fp32["AGCM.__head_aw1_bgr"].shape == (16, 256) and "LE.__head_s2d_win" not in fp32


def test_default_precision_constructs_on_cpu():
    from hdrtv_tpu_torch.models.layers import BF16
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    proc = HDRTVNetTorch(WEIGHTS, device="cpu")
    assert proc.precision == "fp16" and proc.policy is BF16
    out = proc.process_rgb48(np.zeros((16, 24, 3), np.uint8))
    assert out.shape == (16, 24, 3) and out.dtype == np.uint16


@pytest.mark.parametrize("kwargs", [
    {"precision": "fp16", "mesh": object()},
    {"precision": "fp32", "use_hg": True},
    {"precision": "fp32", "hg_path": "hg.pt"},
])
def test_uncovered_options_raise(kwargs):
    """What the port does not run raises at construction, naming its ROADMAP
    item; ``use_hg`` on a checkpoint without ``base.*`` and ``hg.*`` keys
    raises a ValueError naming them (the JAX package fails at the first
    frame, with a KeyError). ``hg_path`` runs since its port, with a ``.pt``
    HR file (``tests/test_torch_import.py``); beside a ``.npz``, which
    carries its own ``hg.*`` keys, it raises a ValueError."""
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    if kwargs.get("use_hg"):
        with pytest.raises(ValueError, match=r"no base\.\* and no hg\.\* keys"):
            HDRTVNetTorch(WEIGHTS, device="cpu", **kwargs)
        return
    if "hg_path" in kwargs:
        with pytest.raises(ValueError, match=r"hg_path goes with a \.pt model"):
            HDRTVNetTorch(WEIGHTS, device="cpu", **kwargs)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        HDRTVNetTorch(WEIGHTS, device="cpu", **kwargs)


def test_frame_not_divisible_by_8_raises(processors):
    """A frame whose sides are not multiples of 8 no longer raises: it runs
    the natural-layout program, as in the JAX runtime, within the fp32
    bound of ``test_process_rgb48_matches_jax``."""
    jax_proc, proc = processors
    frame = (np.random.RandomState(99).rand(99, 131, 3) * 255).astype(np.uint8)
    assert proc.natural(99, 131) and not proc.wants_pairs(99, 131)
    got = proc.process_rgb48(frame).astype(np.int64)
    want = jax_proc.process_rgb48(frame).astype(np.int64)
    assert got.shape == (99, 131, 3) and np.abs(got - want).max() <= CODES


def test_import_leaves_jax_out():
    code = (
        "import sys, pkgutil, importlib, hdrtv_tpu_torch\n"
        "for m in pkgutil.walk_packages(hdrtv_tpu_torch.__path__, 'hdrtv_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'hdrtv_tpu' or k.startswith('hdrtv_tpu.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
