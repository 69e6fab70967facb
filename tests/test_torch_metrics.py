"""The port's metrics and colour science (``ops/metrics.py``,
``ops/color.py``) on the CPU, against hdrtv_tpu on the same seeded numpy
pairs, and against the reference's golden (``metrics_golden.npz``) at the
tolerances of ``tests/test_ops.py TestMetricsGoldenParity``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import load_fixture

f32 = np.float32


def _golden_pair():
    fx = load_fixture("metrics_golden.npz")
    pred = fx["pred_bgr"][..., ::-1].astype(f32) / 65535.0
    ref = fx["ref_bgr"][..., ::-1].astype(f32) / 65535.0
    return fx, torch.from_numpy(pred.copy()), torch.from_numpy(ref.copy())


def test_golden_psnr():
    from hdrtv_tpu_torch.ops.metrics import psnr

    fx, pred, ref = _golden_pair()
    assert abs(float(psnr(pred, ref)) - float(fx["psnr"])) < 1e-3


def test_golden_ssim():
    from hdrtv_tpu_torch.ops.metrics import ssim

    fx, pred, ref = _golden_pair()
    assert abs(float(ssim(pred, ref)) - float(fx["ssim"])) < 1e-4


def test_golden_delta_e_itp():
    from hdrtv_tpu_torch.ops.metrics import delta_e_itp_unit

    fx, pred, ref = _golden_pair()
    expect = float(fx["delta_e_itp"])
    assert abs(float(delta_e_itp_unit(pred, ref, peak_nits=1000.0)) - expect) < max(5e-3, expect * 1e-3)


def _pair(seed: int, h: int = 40, w: int = 56):
    """A seeded linear pair: smooth content, the prediction a noisy, graded
    copy, both spilling a little past [0, 1]."""
    rng = np.random.RandomState(seed)
    ref = np.kron(rng.rand(h // 8, w // 8, 3), np.ones((8, 8, 1))) * 1.1 - 0.05 + rng.randn(h, w, 3) * 0.02
    pred = ref * 0.9 + 0.03 + rng.randn(h, w, 3) * 0.03
    return pred.astype(f32), ref.astype(f32)


@pytest.mark.parametrize("seed", [0, 1])
def test_functions_match_jax(seed):
    """psnr, ssim_single, ssim, delta_e_itp_unit (two peaks), grade_normalize
    and full_reference_metrics against the JAX functions: fp32 sums in
    another order, so within 1e-4 dB, 1e-6 SSIM, 1e-4 relative ΔEITP, 1e-6
    on the normalized pixels."""
    from hdrtv_tpu.ops import metrics as jm
    from hdrtv_tpu_torch.ops import metrics as tm

    p, r = _pair(seed)
    jp, jr, tp, tr = jnp.asarray(p), jnp.asarray(r), torch.from_numpy(p), torch.from_numpy(r)
    assert abs(float(tm.psnr(tp, tr)) - float(jm.psnr(jp, jr))) < 1e-4
    assert abs(float(tm.ssim_single(tp[..., 1], tr[..., 1])) - float(jm.ssim_single(jp[..., 1], jr[..., 1]))) < 1e-6
    assert abs(float(tm.ssim(tp, tr)) - float(jm.ssim(jp, jr))) < 1e-6
    for peak in (1000.0, 203.0):
        want = float(jm.delta_e_itp_unit(jp, jr, peak_nits=peak))
        assert abs(float(tm.delta_e_itp_unit(tp, tr, peak_nits=peak)) - want) <= 1e-4 * want
    np.testing.assert_allclose(tm.grade_normalize(tp, tr).numpy(), np.asarray(jm.grade_normalize(jp, jr)),
                               atol=1e-6, rtol=0)
    got, want = tm.full_reference_metrics(tp, tr), jm.full_reference_metrics(jp, jr)
    assert sorted(got) == sorted(want)
    for k in want:
        w = float(want[k])
        assert abs(float(got[k]) - w) <= max(1e-6, 1e-4 * abs(w)), (k, float(got[k]), w)


def test_identical_pair_and_constant_channel_match_jax():
    """PSNR's 99 cap on an identical pair; grade_normalize with a constant
    prediction channel (gain 1, the mean moved) against JAX. The constant
    is 0.375, whose fp32 sums are exact: XLA's sequential fp32 mean of a
    value like 0.4 drifts by 2e-6, over the 1e-6 std floor, and JAX then
    takes the channel for a graded one."""
    from hdrtv_tpu.ops import metrics as jm
    from hdrtv_tpu_torch.ops import metrics as tm

    p, r = _pair(3)
    assert float(tm.psnr(torch.from_numpy(r), torch.from_numpy(r))) == 99.0
    p[..., 2] = 0.375
    got = tm.grade_normalize(torch.from_numpy(p), torch.from_numpy(r)).numpy()
    want = np.asarray(jm.grade_normalize(jnp.asarray(p), jnp.asarray(r)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert np.allclose(got[..., 2], np.clip(r[..., 2].mean(), 0, 1), atol=1e-6)


def _bordered(seed: int, top: int, bottom: int, left: int, right: int, dtype):
    rng = np.random.RandomState(seed)
    img = np.zeros((60, 90, 3), f32)
    img[top:60 - bottom, left:90 - right] = rng.rand(60 - top - bottom, 90 - left - right, 3) * 0.9 + 0.05
    if dtype == np.uint16:
        return (img * 65535).astype(np.uint16)
    return img


@pytest.mark.parametrize("case", ["shared", "pred_only", "none", "thin", "u16", "all_black", "shape"])
def test_crop_shared_black_borders_matches_jax(case):
    from hdrtv_tpu.ops.metrics import crop_shared_black_borders as jax_crop
    from hdrtv_tpu_torch.ops.metrics import crop_shared_black_borders

    dtype = np.uint16 if case == "u16" else f32
    borders = {"shared": ((10, 12, 9, 9), (11, 10, 9, 10)), "pred_only": ((10, 10, 0, 0), (0, 0, 0, 0)),
               "none": ((0, 0, 0, 0), (0, 0, 0, 0)), "thin": ((3, 3, 2, 2), (3, 3, 2, 2)),
               "u16": ((12, 12, 0, 0), (12, 12, 0, 0)), "all_black": ((0, 0, 0, 0), (0, 0, 0, 0)),
               "shape": ((10, 10, 0, 0), (10, 10, 0, 0))}[case]
    pred, ref = _bordered(1, *borders[0], dtype), _bordered(2, *borders[1], dtype)
    if case == "all_black":
        pred, ref = np.zeros_like(pred), np.zeros_like(ref)
    if case == "shape":
        ref = ref[:50]
    got, want = crop_shared_black_borders(pred, ref), jax_crop(pred, ref)
    assert got[2] == want[2]
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[2] == (case in ("shared", "pred_only", "u16"))


def test_color_functions_match_jax():
    """pq_oetf, pq_eotf, bt709_oetf_inverse, srgb_to_linear, apply_matrix
    (both primaries matrices), linear_rgb_to_itp and delta_e_itp against JAX,
    fp32: 1e-4 relative on the PQ pair (XLA's fp32 pow under PQ's exponents,
    78.84 and 6.28, is off by up to ~5e-5 where the EOTF's numerator
    cancels), 2e-6 on the linearisations, 5e-5 on I, T, P (that difference
    times the LMS-to-ITP coefficients, up to 4.4)."""
    from hdrtv_tpu.ops import color as jc
    from hdrtv_tpu_torch.ops import color as tc

    rng = np.random.RandomState(7)
    v = np.concatenate([rng.rand(4000), [0.0, 1.0, -0.1, 1.1, 0.04045, 0.5]]).astype(f32)
    nits = (v * 11000.0).astype(f32)
    for fj, ft, x, rtol in ((jc.pq_oetf, tc.pq_oetf, nits, 1e-4), (jc.pq_eotf, tc.pq_eotf, v, 1e-4),
                            (jc.bt709_oetf_inverse, tc.bt709_oetf_inverse, v, 2e-6),
                            (jc.srgb_to_linear, tc.srgb_to_linear, v, 2e-6)):
        got, want = ft(torch.from_numpy(x)).numpy(), np.asarray(fj(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7 * max(1.0, float(np.abs(want).max())))
    rgb = (rng.rand(30, 20, 3) * 1000).astype(f32)
    for m in (tc.BT709_TO_BT2020, tc.BT2020_TO_BT709):
        np.testing.assert_allclose(tc.apply_matrix(torch.from_numpy(rgb), m).numpy(),
                                   np.asarray(jc.apply_matrix(jnp.asarray(rgb), jnp.asarray(m))), rtol=1e-6, atol=1e-3)
    assert np.array_equal(tc.BT2020_TO_BT709, jc.BT2020_TO_BT709) and np.array_equal(tc.BT709_TO_BT2020,
                                                                                    jc.BT709_TO_BT2020)
    for got, want in zip(tc.linear_rgb_to_itp(torch.from_numpy(rgb)), jc.linear_rgb_to_itp(jnp.asarray(rgb))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)
    rgb2 = (rgb * 0.9 + 5.0).astype(f32)
    want = float(jc.delta_e_itp(jnp.asarray(rgb2), jnp.asarray(rgb)))
    assert abs(float(tc.delta_e_itp(torch.from_numpy(rgb2), torch.from_numpy(rgb))) - want) <= 1e-4 * want
