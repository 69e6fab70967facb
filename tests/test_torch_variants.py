"""The model variants of hdrtv_tpu_torch on the CPU, against hdrtv_tpu: the
AGCM classifier modes, the LE archs, the direct HG generator and the
post-correction heads, in the natural layout.

Held here: every golden of ``tests/test_model_variants.py`` with its
tolerance (2e-5, 1e-4, 2e-4); each AGCM mode and each post-correction mode
on seeded parameters against the JAX function, fp32 within 1e-5 and bf16
within one bf16 step; and each variant checkpoint of
``hdrtv_tpu_torch/tools/synth_variants.py``, written as a ``.pt``, through
``HDRTVNetTorch`` against ``HDRTVNetTPU`` on the same file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import load_fixture

f32 = np.float32
CODES = 4  # fp32 frames, u16 codes (1 seen)


def _params_from(fx: dict, prefix: str) -> tuple[dict, dict]:
    """(jax, torch) converted parameters of the fixture keys under prefix."""
    from hdrtv_tpu_torch.models.import_npz import convert_state

    conv = convert_state({k[len(prefix):]: v for k, v in fx.items() if k.startswith(prefix)})
    return {k: jnp.asarray(v) for k, v in conv.items()}, {k: torch.from_numpy(v) for k, v in conv.items()}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _within_one_step(got, want, steps: int = 1):
    """bf16: each value within ``steps`` bf16 steps of the JAX value's
    magnitude."""
    g, w = _np(got), _np(want)
    step = steps * 2.0 ** -7 * np.maximum(1.0, np.abs(w))
    assert (np.abs(g - w) <= step).all(), float(np.abs(g - w).max())


# ---------------------------------------------------------------------------
# The goldens of tests/test_model_variants.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag,classifier", [
    ("plain", "agcm_plain"), ("affine", "agcm_affine"), ("lite8", "agcm_lite_8"),
    ("spatial", "spatial_h4_wide8_x2"), ("spatialmix", "spatial_mix_h4_wide8_x2"),
])
def test_agcm_variant_matches_golden(tag, classifier):
    from hdrtv_tpu_torch.models.agcm import agcm_apply

    fx = load_fixture("agcm_variants.npz")
    _, pt = _params_from(fx, f"{tag}__sd__")
    out = agcm_apply(pt, torch.from_numpy(fx["img"]), torch.from_numpy(fx["cond"]), prefix="", classifier=classifier)
    np.testing.assert_allclose(out.numpy(), fx[f"{tag}__out"], atol=2e-5, rtol=0)


def test_agcm_mode_detection():
    from hdrtv_tpu_torch.models.agcm import agcm_lite_width, agcm_lowrank_rank, agcm_mode, agcm_spatial_config

    assert agcm_mode("plain") == "plain"
    assert agcm_mode("adaptive_affine") == "affine"
    assert agcm_mode("lite_16") == "lite"
    assert agcm_mode("lowrank8") == "lowrank"
    assert agcm_mode("spatial_mix_h16") == "spatial_mix"
    assert agcm_mode("spatialh8wide16x2") == "spatial_affine"
    assert agcm_mode("color_condition") == "dynamic"
    assert agcm_lite_width("lite_2") == 4 and agcm_lowrank_rank("lowrank_99") == 64
    assert agcm_spatial_config("spatial_mix_global_cnn_h1_wide300_x40") == (2, 128, 16)


@pytest.mark.parametrize("tag,le_arch", [
    ("cleantrunk", "cleantrunk"), ("cleantrunk_deep8", "cleantrunk_deep8"), ("wide64x4", "cleantrunk_wide64x4"),
    ("selectsft23", "selectsft23"), ("bottleneck_heavy", "bottleneck_heavy"), ("flatall8", "cleantrunk_flatall8"),
    ("plainflatlinear8", "plainflatlinear8"), ("plainbottleneck", "plainbottleneckh8wide24x2"),
    ("conddirect", "conddirecth4wide24x2"), ("condgatedirect", "condgatedirecth4wide24x2"),
])
def test_le_arch_matches_golden(tag, le_arch):
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig, ensemble_agcm_le

    fx = load_fixture("ensemble_variants.npz")
    _, pt = _params_from(fx, f"{tag}__sd__")
    with torch.inference_mode():
        out = ensemble_agcm_le(pt, torch.from_numpy(fx["img"]), torch.from_numpy(fx["cond"]),
                               ModelConfig(le_arch=le_arch, nf=16))
    np.testing.assert_allclose(out.numpy(), fx[f"{tag}__out"], atol=1e-4, rtol=0)


def test_lowrank_svd_remap_matches_golden():
    """The full-rank HRconv factored by SVD into reduce / expand, then the
    ensemble, against the golden; the remapped weights equal JAX's bit for
    bit (numpy's SVD in both)."""
    from hdrtv_tpu.models.import_torch import remap_condition_state as jax_remap
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig, ensemble_agcm_le
    from hdrtv_tpu_torch.models.import_npz import convert_state
    from hdrtv_tpu_torch.models.import_torch import remap_condition_state

    fx = load_fixture("ensemble_variants.npz")
    raw = {k[len("lowrank4__sd__"):]: v for k, v in fx.items() if k.startswith("lowrank4__sd__")}
    got, want = remap_condition_state(raw, prefix="AGCM.", classifier="lowrank_4"), jax_remap(
        raw, prefix="AGCM.", classifier="lowrank_4")
    assert sorted(got) == sorted(want) and "AGCM.HRconv_reduce.weight" in got and "AGCM.HRconv.weight" not in got
    assert all(got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in got)
    params = {k: torch.from_numpy(v) for k, v in convert_state(got).items()}
    with torch.inference_mode():
        out = ensemble_agcm_le(params, torch.from_numpy(fx["img"]), torch.from_numpy(fx["cond"]),
                               ModelConfig(classifier="agcm_lowrank4", nf=16))
    np.testing.assert_allclose(out.numpy(), fx["lowrank4__out"], atol=2e-4, rtol=0)


def test_hg_direct_matches_golden():
    from hdrtv_tpu_torch.models.hg import hg_direct_apply

    fx = load_fixture("hg_direct.npz")
    _, pt = _params_from(fx, "sd__")
    out = hg_direct_apply(pt, torch.from_numpy(fx["img"]), torch.from_numpy(fx["mask"]), prefix="",
                          bottleneck_scale=4, trunk_depth=2)
    np.testing.assert_allclose(out.numpy(), fx["out"], atol=2e-5, rtol=0)


def test_arch_env_overrides(monkeypatch):
    """The environment fills the fields the architecture dict is silent on,
    as in the JAX package."""
    from hdrtv_tpu.models.hdrtvnet import ModelConfig as JaxConfig
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig

    monkeypatch.setenv("HDRTVNET_CLASSIFIER", "lite_8")
    monkeypatch.setenv("HDRTVNET_POST_CORRECTION", "residualh4wide16x2")
    monkeypatch.setenv("HDRTVNET_LE_ARCH", "cleantrunk")
    for arch in ({}, {"le_arch": "sft"}):
        got, want = ModelConfig.from_arch_dict(arch), JaxConfig.from_arch_dict(arch)
        assert repr(got) == repr(want)
    assert ModelConfig.from_arch_dict({}).classifier == "agcm_lite8"


# ---------------------------------------------------------------------------
# Seeded parameters against JAX
# ---------------------------------------------------------------------------


def _seeded(rng, shapes: dict) -> dict:
    """HWIO weights at 1/√fan_in and small biases, numpy fp32."""
    p = {}
    for name, (k, ci, co) in shapes.items():
        p[f"{name}.weight"] = (rng.randn(k, k, ci, co) / np.sqrt(k * k * ci)).astype(f32)
        p[f"{name}.bias"] = (rng.randn(co) * 0.05).astype(f32)
    return p


def _agcm_params(rng, classifier: str) -> dict:
    from hdrtv_tpu_torch.models.agcm import agcm_mode, agcm_spatial_config

    mode = agcm_mode(classifier)
    if mode == "plain":
        return _seeded(rng, {"conv_first": (1, 3, 16), "HRconv": (1, 16, 16), "conv_last": (1, 16, 3)})
    if mode == "affine":
        return _seeded(rng, {"affine.0": (1, 3, 16), "affine.2": (1, 16, 6)})
    _, wide, depth = agcm_spatial_config(classifier)
    out_c = 12 if mode == "spatial_mix" else 6
    shapes = {"spatial_in": (1, 3, wide), "spatial_out": (1, wide, out_c)}
    shapes.update({f"spatial_trunk.{2 * i}": (3, wide, wide) for i in range(depth)})
    if "global_cnn" in classifier:
        shapes.update({"global_net.0": (1, 3, wide), "global_net.2": (3, wide, wide), "global_net.4": (3, wide, wide),
                       "global_net.7": (1, wide, out_c)})
    elif "global" in classifier:
        shapes.update({"global_in": (1, 3, wide), "global_out": (1, wide, out_c)})
    return _seeded(rng, shapes)


AGCM_MODES = ["plain", "affine", "spatial_h4_wide8_x2", "spatial_mix_h4_wide8_x2", "spatial_mix_global_h4_wide8_x2",
              "spatial_mix_global_cnn_h4_wide8_x2"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("classifier", AGCM_MODES)
def test_agcm_mode_matches_jax(classifier, dtype):
    """The frame-driven AGCM modes on seeded (non-zero) parameters at 30 × 44
    (the spatial pool leaves a ragged edge, the bilinear upsample covers it).
    bf16: one step, two for the spatial modes, whose per-pixel parameters
    the port upsamples in fp32 and rounds once, where ``jax.image.resize``
    on bf16 rounds its weights and each axis's pass to bf16: a one-step
    difference in a scale moves ``content · (scale + 1)`` by up to two."""
    from hdrtv_tpu.models import layers as jl
    from hdrtv_tpu.models.agcm import agcm_apply as jax_agcm
    from hdrtv_tpu_torch.models import layers as tl
    from hdrtv_tpu_torch.models.agcm import agcm_apply

    rng = np.random.RandomState(sum(map(ord, classifier)))
    p = _agcm_params(rng, classifier)
    img = rng.rand(1, 30, 44, 3).astype(f32)
    jpol, tpol = (jl.F32, tl.F32) if dtype == "f32" else (jl.BF16, tl.BF16)
    want = jax.jit(lambda q, x: jax_agcm(q, x, x[:, ::4, ::4], prefix="", classifier=classifier, policy=jpol))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(img))
    pt = {k: torch.from_numpy(v).to(tpol.compute_dtype) for k, v in p.items()}
    x = torch.from_numpy(img)
    got = agcm_apply(pt, x, x[:, ::4, ::4], prefix="", classifier=classifier, policy=tpol)
    assert np.abs(_np(got) - img).max() > 0.01  # the mapping is not the identity
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    else:
        _within_one_step(got, want, 2 if classifier.startswith("spatial") else 1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["global", "global_spatial", "global_residual", "residual", "affine", "spatial"])
def test_post_correction_matches_jax(mode, dtype):
    """Each of the six heads on seeded parameters (``synth_variants``) over
    a seeded (img, hdr) pair at 30 × 44 (the pools leave ragged edges),
    against JAX ``post_correction_apply``: fp32 within 1e-5, bf16 within one
    step; the head moves hdr."""
    from hdrtv_tpu.models import layers as jl
    from hdrtv_tpu.models.hdrtvnet import post_correction_apply as jax_pc
    from hdrtv_tpu_torch.models import layers as tl
    from hdrtv_tpu_torch.models.hdrtvnet import natural_params_to_torch, post_correction_apply
    from hdrtv_tpu_torch.models.import_npz import convert_state
    from hdrtv_tpu_torch.tools.synth_variants import POST_CORRECTIONS, post_correction_state

    spec = POST_CORRECTIONS[mode]
    p = convert_state(post_correction_state(spec, seed=5))
    rng = np.random.RandomState(30)
    img, hdr = rng.rand(1, 30, 44, 3).astype(f32), rng.rand(1, 30, 44, 3).astype(f32)
    jpol, tpol = (jl.F32, tl.F32) if dtype == "f32" else (jl.BF16, tl.BF16)
    want = jax.jit(lambda q, a, b: jax_pc(q, spec, jpol.cast(a), jpol.cast(b), policy=jpol))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(img), jnp.asarray(hdr))
    pt = natural_params_to_torch(p, "cpu", tpol)
    with torch.inference_mode():
        got = post_correction_apply(pt, spec, tpol.cast(torch.from_numpy(img)), tpol.cast(torch.from_numpy(hdr)),
                                    policy=tpol)
    assert got.dtype == tpol.compute_dtype and np.abs(_np(got) - hdr).mean() > 1e-3
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    else:
        _within_one_step(got, want)


def test_parse_post_correction_matches_jax():
    from hdrtv_tpu.models.hdrtvnet import parse_post_correction as jax_parse
    from hdrtv_tpu_torch.models.hdrtvnet import parse_post_correction

    for spec in ("", "none", "globalwide16x2", "post_global_color_correction_wide8x3", "corrh8wide32x4",
                 "global-wide16x2-res-h2-wide8x1", "globalwide16x2correcth16wide8x2", "affineh4wide16x2"):
        assert parse_post_correction(spec) == jax_parse(spec), spec
    with pytest.raises(ValueError, match="Unsupported post_correction"):
        parse_post_correction("sharpen")


# ---------------------------------------------------------------------------
# Each variant checkpoint through the runtime, against HDRTVNetTPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def variant_pts(tmp_path_factory):
    from hdrtv_tpu_torch.tools.synth_variants import write_variants

    return write_variants(str(tmp_path_factory.mktemp("variants")))


def _frame(h: int, w: int, seed: int) -> np.ndarray:
    """Blocks of grey, a third of them clipped to white, under mild noise:
    the release base lifts the white ones over the HG mask's threshold."""
    rng = np.random.RandomState(seed)
    blocks = np.kron(rng.rand(-(-h // 8), -(-w // 8), 1), np.ones((8, 8, 3)))[:h, :w] * 420
    return np.clip(blocks + rng.randn(h, w, 3) * 10, 0, 255).astype(np.uint8)


VARIANTS = ["agcm_plain", "agcm_affine", "agcm_lite8", "agcm_spatial", "agcm_spatialmix", "le_cleantrunk",
            "le_cleantrunk_deep8", "le_wide64x4", "le_selectsft23", "le_bottleneck_heavy", "le_flatall8",
            "le_plainflatlinear8", "le_plainbottleneck", "le_conddirect", "le_condgatedirect", "lowrank4",
            "hg_direct", "pc_global", "pc_global_spatial", "pc_global_residual", "pc_residual", "pc_affine",
            "pc_spatial"]
BF16_VARIANTS = {"agcm_spatialmix", "le_condgatedirect", "hg_direct", "pc_residual"}


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_processor_matches_jax(name, variant_pts):
    """The variant's ``.pt`` through both runtimes at 32 × 48: the same
    configuration, turbo off by the JAX rule (every variant runs the natural
    program), equal fingerprints, fp32 frames within CODES; for the bf16
    cases the default precision within one bf16 step (256 codes)."""
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    path = variant_pts[name]
    frame = _frame(32, 48, 3)
    outs = {}
    for precision in ("fp32", "fp16") if name in BF16_VARIANTS else ("fp32",):
        jp = HDRTVNetTPU(path, precision=precision, persistent_cache=False)
        tp = HDRTVNetTorch(path, precision=precision, device="cpu")
        assert repr(tp.cfg) == repr(jp.cfg) and not tp.turbo and not jp.turbo
        assert tp.model_hash == jp.model_hash
        got, want = tp.process_rgb48(frame).astype(np.int64), jp.process_rgb48(frame).astype(np.int64)
        assert got.shape == (32, 48, 3)
        assert np.abs(got - want).max() <= (CODES if precision == "fp32" else 256), np.abs(got - want).max()
        outs[precision] = got
    if name == "hg_direct":  # the generator changed the frame where the mask is set
        base = HDRTVNetTorch(path, precision="fp32", device="cpu", use_hg=False).process_rgb48(frame)
        assert (np.abs(outs["fp32"] - base) > 300).any(axis=-1).mean() > 0.05
