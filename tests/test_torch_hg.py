"""The HG composite of hdrtv_tpu_torch on the CPU against hdrtv_tpu, and the
colorimetric pack.

The same numpy-seeded inputs go through the JAX function and its counterpart
in the port (JAX on the CPU, the port's kernels as their plain versions):
the host transforms exactly; the s2d helpers bit for bit in fp32 and bf16;
the natural and the s2d generator against JAX and the torch goldens of the
fixtures; the plain hg_tail and colorimetric versions against the Pallas
kernels in interpret mode; and the frame program as a whole,
``HDRTVNetTorch`` against ``HDRTVNetTPU`` on a composite checkpoint (the real
base model + the ``hg_mid`` generator).

The highlight mask is a threshold on the base model's output (max RGB >
0.775), so two runs whose base outputs differ by one rounding flip the mask
on pixels that sit at the threshold, and there the output jumps by the whole
HG residual. Whole-frame comparisons therefore count the pixels whose base
max-RGB lies within a stated margin of the threshold separately (their share
is bounded) and bound the rest in u16 codes.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.conftest import load_fixture

ROOT = os.path.join(os.path.dirname(__file__), "..")
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
THRESHOLD = 0.775  # max RGB at which (m − 0.75) / 0.25 crosses 0.1
CODES = 4  # u16 codes: the 5e-5 golden tolerance × 65535, rounded up

TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _t(a, dtype="f32"):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(TDT[dtype])


def _j(a, dtype="f32"):
    return jnp.asarray(np.asarray(a, np.float32)).astype(JDT[dtype])


def _np(x):
    """A torch or jax array as float32 numpy (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x.astype(jnp.float32)) if jnp.issubdtype(x.dtype, jnp.floating) else np.asarray(x)


def _hg_raw(name="hg_mid.npz"):
    fx = load_fixture(name)
    return {k: v for k, v in fx.items() if k.startswith("hg.")}, fx


@pytest.fixture(scope="module")
def hg_params():
    """(jax natural, torch natural, jax s2d, torch s2d) fp32 parameters of the
    ``hg_mid`` generator."""
    from hdrtv_tpu.models.hg_s2d import hg_s2d_transform as jax_transform
    from hdrtv_tpu.models.import_torch import convert_state as jax_convert
    from hdrtv_tpu_torch.models.hg_s2d import hg_s2d_transform
    from hdrtv_tpu_torch.models.import_npz import convert_state
    from hdrtv_tpu_torch.models.s2d import params_to_torch

    raw, _ = _hg_raw()
    nat = convert_state(raw)
    return (
        {k: jnp.asarray(v) for k, v in jax_convert(raw).items()},
        {k: torch.from_numpy(v) for k, v in nat.items()},
        {k: jnp.asarray(v) for k, v in jax_transform(jax_convert(raw)).items()},
        params_to_torch(hg_s2d_transform(nat), "cpu"),
    )


@pytest.fixture(scope="module")
def composite_path(tmp_path_factory):
    """A composite checkpoint on disk: the real base model + the ``hg_mid``
    generator (nf = 16), with its sidecar, written by the port's own
    ``convert_state`` / ``save_npz``."""
    from hdrtv_tpu_torch.models.import_npz import convert_state, load_npz, save_npz

    raw, _ = _hg_raw()
    params = {f"base.{k}": v for k, v in load_npz(WEIGHTS).items()}
    params.update(convert_state(raw))
    with open(WEIGHTS[:-4] + ".json") as f:
        arch = json.load(f)
    arch.update({"use_hg": True, "hg_nf": 16})
    path = str(tmp_path_factory.mktemp("hg") / "composite.npz")
    save_npz(path, params, {"architecture": arch})
    return path


# ---------------------------------------------------------------------------
# Host side: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["hg_mid.npz", "hg_tiny.npz"])
def test_convert_state_and_hg_transform_equal_exactly(name):
    from hdrtv_tpu.models.hg_s2d import hg_s2d_transform as jax_transform
    from hdrtv_tpu.models.import_torch import convert_state as jax_convert
    from hdrtv_tpu_torch.models.hg_s2d import hg_s2d_transform
    from hdrtv_tpu_torch.models.import_npz import convert_state

    raw, _ = _hg_raw(name)
    want, got = jax_convert(raw), convert_state(raw)
    assert got.keys() == want.keys() and not any(k.endswith("num_batches_tracked") for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    want_t, got_t = jax_transform(want), hg_s2d_transform(got)
    assert got_t.keys() == want_t.keys() and "hg.conv1.1.running_mean" not in got_t
    for k in want_t:
        assert got_t[k].dtype == want_t[k].dtype and np.array_equal(got_t[k], want_t[k]), k


def test_synthetic_checkpoint_transforms_like_jax(tmp_path):
    """The synthetic nf = 64 generator of ``tools/synth_hg.py`` (reduced here
    to nf = 8: the same layer list) transforms, as a composite with the base
    model, exactly as the JAX package transforms it; the file round-trips
    through ``save_npz`` / ``load_npz`` with ``use_hg`` in its sidecar."""
    from hdrtv_tpu.models.hdrtvnet import ModelConfig as JaxCfg
    from hdrtv_tpu.models.s2d import s2d_transform_params as jax_transform
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig
    from hdrtv_tpu_torch.models.import_npz import load_npz, load_npz_meta, npz_arch_dict
    from hdrtv_tpu_torch.models.s2d import s2d_transform_params
    from hdrtv_tpu_torch.tools.synth_hg import synth_hg_params, write_synth_hg

    path = write_synth_hg(str(tmp_path / "synth.npz"), nf=8, seed=3)
    arch = npz_arch_dict(load_npz_meta(path))
    assert arch["use_hg"] is True and arch["hg_nf"] == 8 and arch["nf"] == 32
    params = load_npz(path)
    direct = synth_hg_params(nf=8, seed=3)
    assert params.keys() == direct.keys() and all(np.array_equal(params[k], direct[k]) for k in direct)
    assert params["hg.Up_conv1.0.weight"].shape == (3, 3, 64, 256) and params["hg.conv10.weight"].shape == (1, 1, 16, 3)
    # every conv at gain / sqrt(fan_in): no layer amplifies
    w = params["hg.conv5_1.0.weight"]
    assert abs(float(w.std()) * np.sqrt(9 * 64) - 1.0) < 0.1
    want = jax_transform(params, JaxCfg(use_hg=True))
    got = s2d_transform_params(params, ModelConfig(use_hg=True))
    assert got.keys() == want.keys() and "LE.__in_fused.weight" in got and "hg.conv1.0.weight" in got
    for k in want:
        assert np.array_equal(got[k], np.asarray(want[k])), k


@pytest.mark.parametrize("parts", [(4, 4), (3, 3), (5, 2, 1)])
def test_permute_cat_rows_equal(parts):
    from hdrtv_tpu.models.hg_s2d import _permute_cat_rows as jax_fn
    from hdrtv_tpu_torch.models.hg_s2d import _permute_cat_rows

    w = np.random.RandomState(sum(parts)).randn(1, 1, 4 * sum(parts), 12).astype(np.float32)
    assert np.array_equal(_permute_cat_rows(w, parts), jax_fn(w, parts))


# ---------------------------------------------------------------------------
# The s2d helpers and the layers: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pgh,pgw", [(3, 0), (0, 4), (5, 2), (0, 0)])
def test_pad_reflect_s2d_bit_equal(dtype, pgh, pgw):
    from hdrtv_tpu.models.hg_s2d import pad_reflect_s2d as jax_fn
    from hdrtv_tpu_torch.models.hg_s2d import pad_reflect_s2d
    from hdrtv_tpu_torch.models.layers import pad_reflect
    from hdrtv_tpu_torch.models.s2d import d2s, s2d

    x = np.random.RandomState(0).rand(1, 10, 14, 12).astype(np.float32)
    xt = _t(x, dtype)
    got = pad_reflect_s2d(xt, pgh, pgw)
    assert got.dtype == TDT[dtype]
    assert np.array_equal(_np(got), _np(jax_fn(_j(x, dtype), pgh, pgw)))
    assert torch.equal(got, s2d(pad_reflect(d2s(xt), 2 * pgh, 2 * pgw)))
    if (pgh, pgw) == (0, 0):
        assert got is xt


def test_pad_reflect_s2d_too_small_raises():
    from hdrtv_tpu_torch.models.hg_s2d import pad_reflect_s2d

    with pytest.raises(ValueError, match="too small"):
        pad_reflect_s2d(torch.zeros(1, 4, 20, 12), 4, 0)
    with pytest.raises(ValueError, match="too small"):
        pad_reflect_s2d(torch.zeros(1, 20, 3, 12), 0, 3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layers_bit_equal(dtype):
    """max_pool2, pixel_shuffle, upsample_nearest, pad_reflect and subpos_max
    move or select values and round nothing."""
    from hdrtv_tpu.models import layers as jl
    from hdrtv_tpu.models.hg_s2d import subpos_max as jax_subpos_max
    from hdrtv_tpu.models.s2d import s2d as jax_s2d
    from hdrtv_tpu_torch.models import layers as tl
    from hdrtv_tpu_torch.models.hg_s2d import subpos_max

    x = np.random.RandomState(1).randn(2, 12, 16, 8).astype(np.float32)
    xt, xj = _t(x, dtype), _j(x, dtype)
    assert np.array_equal(_np(tl.max_pool2(xt)), _np(jl.max_pool2(xj)))
    assert np.array_equal(_np(tl.pixel_shuffle(xt, 2)), _np(jl.pixel_shuffle(xj, 2)))
    assert np.array_equal(_np(tl.upsample_nearest(xt, 2)), _np(jl.upsample_nearest(xj, 2)))
    for ph, pw in ((4, 0), (0, 6), (3, 5), (0, 0)):
        assert np.array_equal(_np(tl.pad_reflect(xt, ph, pw)), _np(jl.pad_reflect(xj, ph, pw)))
    assert np.array_equal(_np(subpos_max(xt)), _np(jax_subpos_max(xj)))
    # the 2×2 natural max pool is the sub-position max of the s2d tensor
    assert np.array_equal(_np(subpos_max(_t(_np(jax_s2d(xj)), dtype))), _np(jl.max_pool2(xj)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_masks_bit_equal(dtype):
    """make_mask and mask_s2d against JAX, on values that crowd the threshold
    (every bf16 value between 0.7 and 0.85 among them), and against each
    other through s2d."""
    from hdrtv_tpu.models.hdrtvnet import make_mask as jax_make_mask
    from hdrtv_tpu.models.hg_s2d import mask_s2d as jax_mask_s2d
    from hdrtv_tpu_torch.models.hdrtvnet import make_mask
    from hdrtv_tpu_torch.models.hg_s2d import mask_s2d
    from hdrtv_tpu_torch.models.s2d import s2d

    rng = np.random.RandomState(2)
    x = rng.rand(1, 16, 24, 3).astype(np.float32)
    near = (0.7 + 0.15 * np.arange(16 * 24) / (16 * 24)).astype(np.float32).reshape(16, 24)
    x[0, :, :, 0] = np.where(rng.rand(16, 24) < 0.5, near, x[0, :, :, 0] * 0.7)
    x[0, :, :, 1:] *= 0.7
    xt, xj = _t(x, dtype), _j(x, dtype)
    m = make_mask(xt)
    assert m.shape == (1, 16, 24, 1) and m.dtype == TDT[dtype] and 0.1 < float(m.float().mean()) < 0.9
    assert np.array_equal(_np(m), _np(jax_make_mask(xj)))
    m4 = mask_s2d(s2d(xt))
    assert m4.shape == (1, 8, 12, 4)
    assert np.array_equal(_np(m4), _np(jax_mask_s2d(_j(_np(s2d(xt)), dtype))))
    assert torch.equal(m4, s2d(m))
    assert np.array_equal(_np(make_mask(xt, r=0.6, thresh=0.3)), _np(jax_make_mask(xj, r=0.6, thresh=0.3)))


# ---------------------------------------------------------------------------
# The generator: natural and s2d, against JAX and the torch goldens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["hg_mid.npz", "hg_tiny.npz"])
def test_hg_apply_matches_jax_and_torch_golden(name):
    """The natural generator, BatchNorm applied from the running statistics:
    within 2e-4 of the torch reference output stored in the fixture (the JAX
    test's tolerance) and 5e-5 of JAX ``hg_apply`` (fp32 sums in another
    order through some twenty convs)."""
    from hdrtv_tpu.models.hg import hg_apply as jax_hg_apply
    from hdrtv_tpu.models.import_torch import convert_state as jax_convert
    from hdrtv_tpu_torch.models.hg import hg_apply
    from hdrtv_tpu_torch.models.import_npz import convert_state

    raw, fx = _hg_raw(name)
    pt = {k: torch.from_numpy(v) for k, v in convert_state(raw).items()}
    assert "hg.conv1.1.running_mean" in pt
    with torch.inference_mode():
        got = hg_apply(pt, torch.from_numpy(fx["img"]), torch.from_numpy(fx["mask"])).numpy()
    np.testing.assert_allclose(got, fx["out"], atol=2e-4, rtol=0)
    pj = {k: jnp.asarray(v) for k, v in jax_convert(raw).items()}
    want = np.asarray(jax_hg_apply(pj, jnp.asarray(fx["img"]), jnp.asarray(fx["mask"])))
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)


def test_hg_apply_resizeconv_layout_and_direct_arch(hg_params):
    """The resize-conv up block (a checkpoint with ``Up_convN.1.weight``)
    against JAX, and an ``hg_arch`` of the ``direct`` family dispatching to
    the direct generator (scale 8, depth 8) as JAX ``hg_apply`` does, on
    seeded weights, fp32 within 1e-5."""
    from hdrtv_tpu.models.hg import _up_block as jax_up_block
    from hdrtv_tpu_torch.models.hg import _up_block, hg_apply

    rng = np.random.RandomState(5)
    w = rng.randn(3, 3, 8, 6).astype(np.float32) * 0.1
    b = rng.randn(6).astype(np.float32) * 0.1
    x = rng.rand(1, 6, 10, 8).astype(np.float32)
    got = _up_block({"u.1.weight": _t(w), "u.1.bias": _t(b)}, "u", _t(x), policy=_policy("f32")).numpy()
    want = np.asarray(jax_up_block({"u.1.weight": jnp.asarray(w), "u.1.bias": jnp.asarray(b)}, "u", jnp.asarray(x),
                                   policy=_jax_policy("f32")))
    assert got.shape == (1, 12, 20, 6)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    from hdrtv_tpu.models.hg import hg_apply as jax_hg_apply
    from hdrtv_tpu_torch.models.import_npz import convert_state
    from hdrtv_tpu_torch.tools.synth_variants import hg_direct_state

    direct = convert_state(hg_direct_state(nf=8, seed=5))
    img, mask = rng.rand(1, 32, 64, 3).astype(np.float32), (rng.rand(1, 32, 64, 1) > 0.5).astype(np.float32)
    got = hg_apply({k: _t(v) for k, v in direct.items()}, _t(img), _t(mask), hg_arch="direct_v1").numpy()
    want = np.asarray(jax_hg_apply({k: jnp.asarray(v) for k, v in direct.items()}, jnp.asarray(img),
                                   jnp.asarray(mask), hg_arch="direct_v1"))
    assert np.abs(got - img).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _policy(dtype):
    from hdrtv_tpu_torch.models.layers import BF16, F32

    return F32 if dtype == "f32" else BF16


def _jax_policy(dtype):
    from hdrtv_tpu.models.layers import BF16, F32

    return F32 if dtype == "f32" else BF16


def test_hg_s2d_apply_matches_natural_jax_and_golden(hg_params):
    """The s2d generator on s2d tensors equals the natural one on natural
    tensors (5e-5, the JAX test's tolerance), equals JAX ``hg_s2d_apply``
    (2e-5) and reproduces the torch golden of the fixture (2e-4)."""
    from hdrtv_tpu.models.hg_s2d import hg_s2d_apply as jax_apply
    from hdrtv_tpu.models.s2d import s2d as jax_s2d
    from hdrtv_tpu_torch.models.hg import hg_apply
    from hdrtv_tpu_torch.models.hg_s2d import hg_s2d_apply
    from hdrtv_tpu_torch.models.s2d import d2s, s2d

    pj_nat, pt_nat, pj, pt = hg_params
    _, fx = _hg_raw()
    img, mask = torch.from_numpy(fx["img"]), torch.from_numpy(fx["mask"])
    with torch.inference_mode():
        got = d2s(hg_s2d_apply(pt, s2d(img), s2d(mask))).numpy()
        nat = hg_apply(pt_nat, img, mask).numpy()
    np.testing.assert_allclose(got, fx["out"], atol=2e-4, rtol=0)
    np.testing.assert_allclose(got, nat, atol=5e-5, rtol=0)
    want = np.asarray(jax_apply(pj, jax_s2d(jnp.asarray(fx["img"])), jax_s2d(jnp.asarray(fx["mask"]))))
    np.testing.assert_allclose(s2d(torch.from_numpy(got)).numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("h,w", [(64, 96), (56, 80)], ids=["no-pad", "pads-both"])
def test_hg_composite_s2d_fp32_matches_jax(hg_params, monkeypatch, h, w):
    """``hg_composite_s2d`` on the same base tensor (so the masks agree): the
    unpacked composite within 5e-5 of JAX's; packed within one u16 code, with
    the hg_tail path (``tail_on`` or ``HDRTV_HG_TAIL=1``; JAX with its Pallas
    tail in interpret mode) and with the torch-op tail (``HDRTV_HG_TAIL=0``).
    56×80 reflect-pads to 64×96 and crops the packed rows."""
    from hdrtv_tpu.models.hdrtvnet import ModelConfig as JaxCfg
    from hdrtv_tpu.models.hg_s2d import hg_composite_s2d as jax_composite
    from hdrtv_tpu.models.s2d import s2d as jax_s2d
    from hdrtv_tpu_torch.models import hg_s2d as port
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig
    from hdrtv_tpu_torch.models.s2d import s2d

    _, _, pj, pt = hg_params
    base = np.random.RandomState(h).rand(1, h, w, 3).astype(np.float32)
    bj, bt = jax_s2d(jnp.asarray(base)), s2d(torch.from_numpy(base))
    cfg, jcfg = ModelConfig(use_hg=True), JaxCfg(use_hg=True)
    calls = []
    monkeypatch.setattr(port, "fused_hg_tail",
                        lambda *a, _fn=port.fused_hg_tail: (calls.append(a[0].shape), _fn(*a))[1])
    monkeypatch.delenv("HDRTV_HG_TAIL", raising=False)
    with torch.inference_mode():
        got = port.hg_composite_s2d(pt, bt, cfg).numpy()
        assert calls == []
        packed_tail = port.hg_composite_s2d(pt, bt, cfg, pack=True, tail_on=True).numpy()
        assert calls == [(64 // 2, 96 // 2, 64)]
        packed_ops = port.hg_composite_s2d(pt, bt, cfg, pack=True).numpy()
        monkeypatch.setenv("HDRTV_HG_TAIL", "0")
        packed_off = port.hg_composite_s2d(pt, bt, cfg, pack=True, tail_on=True).numpy()
        assert len(calls) == 1
        monkeypatch.setenv("HDRTV_HG_TAIL", "1")
        packed_env = port.hg_composite_s2d(pt, bt, cfg, pack=True).numpy()
        assert len(calls) == 2
    want = np.asarray(jax_composite(pj, bj, jcfg))
    assert got.shape == want.shape == (1, h // 2, w // 2, 12)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
    assert (got != base.reshape(1, h // 2, 2, w // 2, 2, 3).transpose(0, 1, 3, 2, 4, 5).reshape(got.shape)).mean() > 0.2

    monkeypatch.setenv("HDRTV_HG_TAIL", "0")
    want_ops = np.asarray(jax_composite(pj, bj, jcfg, pack=True)).astype(np.int64)
    monkeypatch.setenv("HDRTV_HG_TAIL", "1")
    monkeypatch.setenv("HDRTV_MEGAKERNEL_INTERPRET", "1")
    with pltpu.force_tpu_interpret_mode():
        want_tail = np.asarray(jax_composite(pj, bj, jcfg, pack=True)).astype(np.int64)
    assert want_ops.shape == (h, 3 * w) and want_ops.max() > want_ops.min()
    for mine in (packed_tail, packed_ops, packed_off, packed_env):
        assert mine.shape == (h, 3 * w) and mine.dtype == np.uint16
        for theirs in (want_ops, want_tail):
            assert np.abs(mine.astype(np.int64) - theirs).max() <= 1
    assert np.array_equal(packed_tail, packed_env) and np.array_equal(packed_ops, packed_off)


def test_hg_composite_s2d_bf16_matches_jax(hg_params, monkeypatch):
    """bf16 on the same bf16 base tensor at 56×80 (pads both ways). Unpacked:
    both sides round every conv to bf16 at the same places; seen equal bit for
    bit. A sum taken in another order may flip a rounding, which the later
    layers spread: the bound is one bf16 step of the result (2^-8 at values
    in [0.5, 1)) on at most 0.5% of the values. Packed through the hg_tail
    path (JAX with its Pallas tail in interpret mode): the tail packs an fp32
    composite; seen max 1 code on 0.13% of the values; bounds 64 codes (one
    flipped u10) and a mean of 0.5."""
    from hdrtv_tpu.models.hdrtvnet import ModelConfig as JaxCfg
    from hdrtv_tpu.models.hg_s2d import hg_composite_s2d as jax_composite
    from hdrtv_tpu.models.hg_s2d import hg_s2d_transform as jax_transform
    from hdrtv_tpu.models.import_torch import convert_state as jax_convert
    from hdrtv_tpu.models.s2d import s2d as jax_s2d
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig
    from hdrtv_tpu_torch.models.hg_s2d import hg_composite_s2d, hg_s2d_transform
    from hdrtv_tpu_torch.models.import_npz import convert_state
    from hdrtv_tpu_torch.models.s2d import params_to_torch, s2d

    raw, _ = _hg_raw()
    pj = {k: jnp.asarray(v) for k, v in jax_transform(jax_convert(raw)).items()}
    pt = params_to_torch(hg_s2d_transform(convert_state(raw)), "cpu", _policy("bf16"))
    assert pt["hg.conv3_1.0.weight"].dtype == torch.bfloat16 and pt["hg.conv3_1.0.bias"].dtype == torch.bfloat16
    assert pt["hg.conv10.bias"].dtype == torch.float32 and pt["hg.conv_last.bias"].dtype == torch.float32
    h, w = 56, 80
    base = np.random.RandomState(11).rand(1, h, w, 3).astype(np.float32)
    bj, bt = jax_s2d(_j(base, "bf16")), s2d(_t(base, "bf16"))
    monkeypatch.delenv("HDRTV_HG_TAIL", raising=False)
    with torch.inference_mode():
        got = hg_composite_s2d(pt, bt, ModelConfig(use_hg=True), policy=_policy("bf16"))
        packed = hg_composite_s2d(pt, bt, ModelConfig(use_hg=True), policy=_policy("bf16"), pack=True, tail_on=True)
    want = jax_composite(pj, bj, JaxCfg(use_hg=True), policy=_jax_policy("bf16"))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    g, wnt = _np(got), _np(want)
    steps = np.abs(g - wnt) / (2.0 ** -8 * np.maximum(np.abs(wnt), 0.5) * 2)
    assert steps.max() <= 1 and (g != wnt).mean() <= 0.005, (float(steps.max()), float((g != wnt).mean()))
    monkeypatch.setenv("HDRTV_HG_TAIL", "1")
    monkeypatch.setenv("HDRTV_MEGAKERNEL_INTERPRET", "1")
    with pltpu.force_tpu_interpret_mode():
        want_packed = np.asarray(jax_composite(pj, bj, JaxCfg(use_hg=True), policy=_jax_policy("bf16"), pack=True))
    d = np.abs(packed.numpy().astype(np.int64) - want_packed.astype(np.int64))
    assert d.max() <= 64 and d.mean() <= 0.5, (int(d.max()), float(d.mean()))


# ---------------------------------------------------------------------------
# The two kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _tail_inputs(dtype, hb=8, wb=16, cn=16, seed=7):
    """Inputs of the HG tail as the model makes them: relu'd up5 and c1, a
    base image around [0, 1], a 0/1 mask, concat-permuted block-diagonal
    weights."""
    from hdrtv_tpu_torch.models.hg_s2d import _permute_cat_rows
    from hdrtv_tpu_torch.models.s2d import b_s2d, w_s2d_1x1

    rng = np.random.RandomState(seed)
    up5 = np.maximum(rng.randn(hb, wb, 4 * cn), 0).astype(np.float32)
    c1 = np.maximum(rng.randn(hb, wb, 4 * cn), 0).astype(np.float32)
    img = (rng.rand(hb, wb, 12) * 1.1 - 0.05).astype(np.float32)
    mask = (rng.rand(hb, wb, 4) > 0.4).astype(np.float32)
    w10 = _permute_cat_rows(w_s2d_1x1(rng.randn(1, 1, 2 * cn, 3).astype(np.float32) * 0.1), (cn, cn))[0, 0]
    wlast = _permute_cat_rows(w_s2d_1x1(rng.randn(1, 1, 6, 3).astype(np.float32) * 0.3), (3, 3))[0, 0]
    b10 = b_s2d(rng.randn(3).astype(np.float32) * 0.1)
    blast = b_s2d(rng.randn(3).astype(np.float32) * 0.05)
    acts = (up5, c1, img, mask)
    return ([_t(a, dtype) for a in acts] + [_t(w10, dtype), _t(b10), _t(wlast, dtype), _t(blast)],
            [_j(a, dtype) for a in acts] + [jnp.asarray(w10), jnp.asarray(b10), jnp.asarray(wlast), jnp.asarray(blast)])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_hg_tail_plain_matches_pallas_interpret(dtype):
    """The plain ``fused_hg_tail`` against the Pallas kernel in interpret
    mode, in u16 codes. fp32: ≤ 1 code (the sum order at the +0.5 boundary).
    bf16: both round u10 to bf16 before conv_last, and the composite is packed
    from fp32, so a u10 whose rounding flips (another sum order) moves its
    outputs by |wlast| · step(u10) · 65535 codes; the bound is computed from
    the inputs, doubled for two flips feeding one output, and at most 2% of
    the values may differ at all (seen: none does)."""
    from hdrtv_tpu.ops.megakernel import fused_hg_tail as jax_tail
    from hdrtv_tpu_torch.ops.megakernel import fused_hg_tail, fused_hg_tail_ref

    args_t, args_j = _tail_inputs(dtype)
    got = fused_hg_tail(*args_t)
    assert got.shape == (8, 2, 16, 6) and got.dtype == torch.uint16
    assert torch.equal(got, fused_hg_tail_ref(*args_t))  # on the CPU the wrapper is the plain version
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_tail(*args_j)).astype(np.int64)
    d = np.abs(got.numpy().astype(np.int64) - want)
    assert 0 < (want == 0).mean() < 0.5 and 0 < (want == 65535).mean() < 0.5
    if dtype == "f32":
        assert d.max() <= 1, int(d.max())
        return
    up5, c1, _, _, w10, b10, wlast, _ = args_t
    u10 = torch.cat([up5, c1], dim=-1).float() @ w10.float() + b10
    step = 2.0 ** (int(np.floor(np.log2(float(u10.abs().max())))) - 7)
    tol = int(2 * float(wlast[:12].float().abs().max()) * step * 65535) + 1
    assert d.max() <= tol and (d > 0).mean() <= 0.02, (int(d.max()), tol, float((d > 0).mean()))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_hg_tail_plain_matches_torch_op_tail(dtype):
    """The kernel's function against the torch-op tail of ``hg_s2d_apply``
    (two 1×1 convs over concats, the mask composite, the pack) on the same
    tensors. fp32: ≤ 1 code. bf16: the torch-op tail rounds u10, out and the
    composite to bf16 and adds its biases in bf16, the kernel keeps them in
    fp32, so the two differ by up to a bf16 step of the composite (256 codes
    in [0.5, 1)) plus a step of out: seen max 437, mean 26.2 codes; bounds
    640 and 55."""
    from hdrtv_tpu_torch.models.layers import conv_nhwc
    from hdrtv_tpu_torch.models.s2d import _pack_rgb48_s2d_flat
    from hdrtv_tpu_torch.ops.megakernel import fused_hg_tail

    up5, c1, img, mask, w10, b10, wlast, blast = _tail_inputs(dtype, seed=9)[0]
    dt = up5.dtype
    got = fused_hg_tail(up5, c1, img, mask, w10, b10, wlast, blast).to(torch.int32)
    u10 = conv_nhwc(torch.cat([up5, c1], dim=-1)[None], w10[None, None], b10.to(dt))
    out = conv_nhwc(torch.cat([u10, img[None]], dim=-1), wlast[None, None], blast.to(dt))
    comp = mask.repeat_interleave(3, dim=-1)[None] * out + img[None]
    want = _pack_rgb48_s2d_flat(comp[0]).reshape(8, 2, 16, 6).to(torch.int32)
    d = (got - want).abs()
    if dtype == "f32":
        assert int(d.max()) <= 1
    else:
        assert int(d.max()) <= 640 and float(d.float().mean()) < 55, (int(d.max()), float(d.float().mean()))


def test_hg_tail_wrapper_checks_its_arguments():
    from hdrtv_tpu_torch.ops.megakernel import fused_hg_tail

    args = _tail_inputs("f32")[0]
    with pytest.raises(ValueError, match="mask4"):
        fused_hg_tail(*args[:3], args[3][..., :3], *args[4:])
    with pytest.raises(ValueError, match="w10"):
        fused_hg_tail(*args[:4], args[4][:-4], *args[5:])
    with pytest.raises(ValueError, match="float32"):
        fused_hg_tail(*args[:5], args[5].bfloat16(), *args[6:])
    with pytest.raises(ValueError):
        fused_hg_tail(args[0].bfloat16(), *args[1:])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_colorimetric_plain_matches_jax(dtype, monkeypatch):
    """``colorimetric_pq_pack`` (on the CPU: its plain version) against the
    JAX ``colorimetric_pq_pack_ref`` and against the Pallas kernel in
    interpret mode, at a width with 3W % 128 == 0, on values beyond [0, 1]
    too. ``pow`` differs in the last bits between torch and XLA and the PQ
    exponent 78.84 multiplies that: ≤ 2 u16 codes, and equal at 0 and 1."""
    from hdrtv_tpu.ops import pack as jax_pack
    from hdrtv_tpu_torch.ops.pack import colorimetric_pq_pack, colorimetric_pq_pack_ref

    x = (np.random.RandomState(3).rand(2, 8, 128, 3) * 1.2 - 0.1).astype(np.float32)
    x[0, 0, :4] = [[0, 0, 0], [1, 1, 1], [1, 0, 0], [0, 0, 1]]
    xt, xj = _t(x, dtype), _j(x, dtype)
    got = colorimetric_pq_pack(xt)
    assert got.shape == x.shape and got.dtype == torch.uint16
    assert torch.equal(got, colorimetric_pq_pack_ref(xt))
    want = np.asarray(jax_pack.colorimetric_pq_pack_ref(xj)).astype(np.int64)
    g = got.numpy().astype(np.int64)
    assert np.abs(g - want).max() <= 2
    assert np.array_equal(g[0, 0, :2], want[0, 0, :2]) and g[0, 0, 0].tolist() == [0, 0, 0]
    monkeypatch.setattr(jax_pack, "_on_tpu", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(jax_pack.colorimetric_pq_pack(xj)).astype(np.int64)
    assert np.abs(g - kernel).max() <= 2
    other = colorimetric_pq_pack(xt, peak_nits=600.0, gamma=2.2).numpy().astype(np.int64)
    want_other = np.asarray(jax_pack.colorimetric_pq_pack_ref(xj, peak_nits=600.0, gamma=2.2)).astype(np.int64)
    assert np.abs(other - want_other).max() <= 2 and (other != g).mean() > 0.5


def test_colorimetric_white_maps_to_peak():
    """SDR white at 1000 nits lands on the PQ code of 1000 cd/m² (the JAX
    test's check), and the constants are the JAX package's."""
    from hdrtv_tpu.ops import color as jax_color
    from hdrtv_tpu_torch.ops import color
    from hdrtv_tpu_torch.ops.pack import colorimetric_pq_pack

    for name in ("PQ_M1", "PQ_M2", "PQ_C1", "PQ_C2", "PQ_C3"):
        assert getattr(color, name) == getattr(jax_color, name)
    assert np.array_equal(color.BT709_TO_BT2020, jax_color.BT709_TO_BT2020)
    out = colorimetric_pq_pack(torch.ones(1, 4, 4, 3))
    expect = int(round(float(jax_color.pq_oetf(jnp.asarray(1000.0))) * 65535.0 + 0.5))
    assert abs(int(out[0, 0, 0, 0]) - expect) <= 1
    with pytest.raises(ValueError, match="triplets"):
        colorimetric_pq_pack(torch.ones(4, 4, 4))


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------


def _highlight_frame(h, w, seed):
    """A u8 frame about a third of whose pixels the base model lifts over the
    mask's threshold: uniform noise with half of the pixels replaced by black
    or white (noise alone stays below the threshold almost everywhere)."""
    rng = np.random.RandomState(seed)
    noise = rng.rand(h, w, 3) * 255
    gray = np.repeat(rng.choice([0.0, 255.0], size=(h, w, 1)), 3, axis=-1)
    return np.where(rng.rand(h, w, 1) < 0.5, gray, noise).astype(np.uint8)


def _smooth_frame(h, w, seed):
    """A gentler frame for bf16: 8×8 blocks of one grey level, a third of them
    clipped to white, under mild noise. The base model's bf16 programs agree
    on it as they do on noise (black-and-white pixel noise drives its
    activations, and with them the bf16 steps, ten times higher)."""
    rng = np.random.RandomState(seed)
    blocks = np.kron(rng.rand(h // 8, w // 8, 1), np.ones((8, 8, 3))) * 420
    return np.clip(blocks + rng.randn(h, w, 3) * 10, 0, 255).astype(np.uint8)


def _base_max_rgb(frame):
    """Max RGB of the base model's output for ``frame`` (the port's own no-HG
    fp32 program), which the highlight mask thresholds."""
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    base = HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu").process_rgb48(frame)
    return base.astype(np.float32).max(axis=-1) / 65535.0


@pytest.mark.parametrize("h,w", [(64, 96), (56, 80)], ids=["no-pad", "pads-both"])
def test_process_rgb48_hg_fp32_matches_jax(composite_path, h, w):
    """``HDRTVNetTorch`` (``use_hg`` from the sidecar, ``device="cpu"``)
    against ``HDRTVNetTPU`` on the same composite checkpoint and frame, fp32.
    Away from the mask's threshold (base max-RGB more than 2e-4 from 0.775,
    three times the 4-code bound of the base model) ≤ 4 u16 codes; at most
    0.5% of the pixels lie that close. The three device entries return the
    same bytes, and frames ship as flat rows."""
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    frame = _highlight_frame(h, w, h + w)
    proc = HDRTVNetTorch(composite_path, precision="fp32", device="cpu")
    assert proc.cfg.use_hg and proc.cfg.hg_nf == 16 and not proc.wants_pairs(h, w)
    got = proc.process_rgb48(frame)
    assert got.shape == (h, w, 3) and got.dtype == np.uint16
    want = HDRTVNetTPU(composite_path, precision="fp32", persistent_cache=False).process_rgb48(frame)
    m = _base_max_rgb(frame)
    near = np.abs(m - THRESHOLD) <= 2e-4
    d = np.abs(got.astype(np.int64) - want.astype(np.int64)).max(axis=-1)
    assert near.mean() <= 0.005 and d[~near].max() <= CODES, (float(near.mean()), int(d[~near].max()))
    # the HG really ran: the masked pixels differ from the base model's output
    base = HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu").process_rgb48(frame)
    changed = (got != base).any(axis=-1)
    masked = m > THRESHOLD
    assert 0.2 < masked.mean() < 0.5 and changed[masked & ~near].mean() > 0.5
    assert not changed[~masked & ~near].any()  # mask 0: the composite is the base output, bit for bit

    flat = frame.reshape(h, 3 * w)
    x = proc.put_frame(flat)
    assert x.shape == (h, 3 * w)
    rows = proc.process_rgb48_device(x)
    hwc = proc.process_rgb48_device(torch.from_numpy(frame.copy()))
    pairs = proc.process_rgb48_device(torch.from_numpy(flat.reshape(h // 2, 2, w // 2, 6).copy()))
    assert rows.shape == (h, 3 * w) and hwc.shape == (h, w, 3) and pairs.shape == (h // 2, 2, w // 2, 6)
    for other in (rows, hwc, pairs):
        assert other.dtype == torch.uint16 and np.array_equal(other.numpy().reshape(h, w, 3), got)


def test_process_rgb48_hg_tail_switch(composite_path, monkeypatch):
    """The runtime chooses the hg_tail kernel by default (``tail_on=True``),
    ``HDRTV_HG_TAIL=0`` gives the torch-op tail, and in fp32 the two agree
    within one code."""
    from hdrtv_tpu_torch.models import hg_s2d as port
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    calls = []
    monkeypatch.setattr(port, "fused_hg_tail", lambda *a, _fn=port.fused_hg_tail: (calls.append(1), _fn(*a))[1])
    frame = _highlight_frame(64, 96, 12)
    proc = HDRTVNetTorch(composite_path, precision="fp32", device="cpu")
    monkeypatch.delenv("HDRTV_HG_TAIL", raising=False)
    on = proc.process_rgb48(frame)
    assert calls == [1]
    monkeypatch.setenv("HDRTV_HG_TAIL", "0")
    off = proc.process_rgb48(frame)
    assert calls == [1]
    assert np.abs(on.astype(np.int64) - off.astype(np.int64)).max() <= 1


def test_process_rgb48_hg_bf16_matches_jax_kernel_program(composite_path, monkeypatch):
    """The default precision at 64×96: ``HDRTVNetTorch(device="cpu")`` against
    the JAX two-stage program (``ensemble_s2d_base_flat`` then
    ``hg_composite_s2d(..., pack=True, tail_on=True)``) with ``BF16`` and every
    Pallas kernel, the HG tail included, in interpret mode: what a TPU runs.

    The base outputs of the two packages differ by one bf16 step on 5% of
    the values of this frame (one step near 0.775 is 0.0039, 256 codes), so
    pixels whose base max-RGB lies within 0.02 of the threshold are counted
    apart (seen 6.0% of the pixels; bound 10%). The rest, seen: max 286, mean
    26.1 codes (unmasked pixels, where the output is the base model's: max 256
    / mean 13.1; masked ones, through the generator: 286 / 45.2; on the same
    base tensor the generator stage agrees within 2 codes); bounds 600 and
    55."""
    from hdrtv_tpu.models.hdrtvnet import ModelConfig as JaxCfg
    from hdrtv_tpu.models.hg_s2d import hg_composite_s2d as jax_composite
    from hdrtv_tpu.models.import_torch import load_npz
    from hdrtv_tpu.models.layers import BF16
    from hdrtv_tpu.models.s2d import ensemble_s2d_base_flat, s2d_transform_params
    from hdrtv_tpu_torch.models import hg_s2d as port_hg
    from hdrtv_tpu_torch.models import s2d as port_s2d
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    h, w = 64, 96
    frame = _smooth_frame(h, w, 21)
    calls = {}
    for mod, name in ((port_s2d, "fused_agcm_head"), (port_s2d, "fused_tail"), (port_s2d, "pack_rgb48"),
                      (port_hg, "fused_hg_tail")):
        def counted(*a, _fn=getattr(mod, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    monkeypatch.delenv("HDRTV_HG_TAIL", raising=False)
    proc = HDRTVNetTorch(composite_path, device="cpu")
    assert proc.policy.compute_dtype == torch.bfloat16 and proc.cfg.use_hg
    got = proc.process_rgb48(frame).astype(np.int64)
    assert calls == {"fused_agcm_head": 1, "fused_tail": 1, "fused_hg_tail": 1}

    cfg = JaxCfg(use_hg=True, hg_nf=16)
    sp = {k: jnp.asarray(v) for k, v in s2d_transform_params(load_npz(composite_path), cfg).items()}
    monkeypatch.setenv("HDRTV_FORCE_FUSED_TRACE", "1")
    monkeypatch.setenv("HDRTV_MEGAKERNEL_INTERPRET", "1")
    monkeypatch.setenv("HDRTV_HG_TAIL", "1")
    with pltpu.force_tpu_interpret_mode():
        base = ensemble_s2d_base_flat(sp, jnp.asarray(frame.reshape(h, 3 * w)), policy=BF16, bgr=True)
        want = np.asarray(jax_composite(sp, base, cfg, policy=BF16, pack=True, tail_on=True))
    assert base.dtype == jnp.bfloat16 and want.shape == (h, 3 * w)
    m = _np(base).reshape(h // 2, w // 2, 2, 2, 3).max(axis=-1).transpose(0, 2, 1, 3).reshape(h, w)
    near = np.abs(m - THRESHOLD) <= 0.02
    d = np.abs(got - want.reshape(h, w, 3).astype(np.int64)).max(axis=-1)
    assert near.mean() <= 0.10, float(near.mean())
    assert d[~near].max() <= 600 and d[~near].mean() <= 55, (int(d[~near].max()), float(d[~near].mean()))


@pytest.mark.parametrize("kwargs,match", [
    ({"use_hg": True}, r"no base\.\* and no hg\.\* keys"),
    ({}, None),
])
def test_hg_on_a_checkpoint_without_hg_weights(kwargs, match):
    """``use_hg=True`` on the base checkpoint raises a ValueError naming the
    missing ``base.*`` and ``hg.*`` keys (the JAX package fails at the first
    frame, with a KeyError); without it the base checkpoint runs as before."""
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    if match is None:
        assert not HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu", **kwargs).cfg.use_hg
        return
    with pytest.raises(ValueError, match=match):
        HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu", **kwargs)


def test_hg_uncovered_cases_raise(composite_path, tmp_path):
    """A ``direct`` generator named over a pixel-shuffle checkpoint loads
    with turbo off, as in JAX, and its first frame lacks the direct layers
    in both packages (KeyError); a frame too small to reflect-pad raises the
    generator's own ``ValueError``. An
    HG frame whose sides are not multiples of 8 (99×131) now runs the
    natural HG composite, as in JAX: within 4 codes of ``HDRTVNetTPU`` away
    from the mask's threshold, with at most 0.5% of the pixels near it."""
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.models.import_npz import load_npz, save_npz
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    proc = HDRTVNetTorch(composite_path, precision="fp32", device="cpu")
    frame = _highlight_frame(99, 131, 99)
    assert proc.natural(99, 131) and not proc.wants_pairs(99, 131)
    got = proc.process_rgb48(frame).astype(np.int64)
    want = HDRTVNetTPU(composite_path, precision="fp32", persistent_cache=False).process_rgb48(frame)
    m = _base_max_rgb(frame)
    near = np.abs(m - THRESHOLD) <= 2e-4
    d = np.abs(got - want.astype(np.int64)).max(axis=-1)
    assert near.mean() <= 0.005 and d[~near].max() <= CODES, (float(near.mean()), int(d[~near].max()))
    assert 0.2 < (m > THRESHOLD).mean() < 0.5  # the mask is set on a share of the frame
    with pytest.raises(ValueError, match="too small"):
        proc.process_rgb48(np.zeros((16, 64, 3), np.uint8))
    direct = str(tmp_path / "direct.npz")
    save_npz(direct, load_npz(composite_path), {"architecture": {"use_hg": True, "hg_arch": "direct_lowres"}})
    tp = HDRTVNetTorch(direct, precision="fp32", device="cpu")
    jp = HDRTVNetTPU(direct, precision="fp32", persistent_cache=False)
    assert not tp.turbo and not jp.turbo and tp.cfg.hg_arch == jp.cfg.hg_arch == "direct_lowres"
    for p in (tp, jp):
        with pytest.raises(KeyError, match="low_in"):
            p.process_rgb48(frame[:32, :32])
