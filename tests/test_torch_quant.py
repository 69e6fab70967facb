"""The port's quantization (``hdrtv_tpu_torch/quant``) on the CPU, against
the JAX package's on the same numpy inputs.

Held here: max calibration of ``weights/hr_fp32.npz`` on the fixture's three
frames reproduces ``tests/fixtures/hr_w8a8.npz`` (codes and ``w_scale`` bit
for bit, ``x_scale`` within a relative X_RTOL); ``calibrate`` against JAX's
for the max, percentile and kl methods, symmetric and asymmetric, at 32 × 48
on two frames (scales within a relative X_RTOL where both read the same
statistic, PCT_RTOL where JAX takes the percentile's position in fp32, kl
within one histogram bin); ``kl_threshold`` and the histogram capture equal
JAX's, values on bin edges and at the range's end included; the percentile
helper equals ``np.percentile`` above 2^24 elements; ``fake_quant_ste``
equals JAX's forward bit for bit with an identity gradient; the activation
capture records each watched layer's input and leaves the forward as it is;
``load_mixed_layout`` equals JAX's.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "hr_w8a8.npz")
f32 = np.float32
X_RTOL = 1e-5  # fp32 statistics of the same forward: the sum order of XLA's and torch's convs
PCT_RTOL = 1e-4  # jnp.percentile's fp32 position moves the value within the gap of two order statistics


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU programs on one intra-op thread: the suite runs in several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fixture_frames():
    """The three smooth frames the fixture was calibrated on
    (tests/test_torch_int8.py make_w8a8_checkpoint)."""
    yy, xx = np.mgrid[0:32, 0:48].astype(f32)
    return [np.stack([xx / 48 * s, yy / 32 * s, np.full_like(xx, 0.2 + 0.2 * s)], -1) for s in (0.6, 0.9, 1.0)]


def seeded_frames(n=2, h=32, w=48, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.rand(h, w, 3).astype(f32) for _ in range(n)]


@pytest.fixture(scope="module")
def fp32():
    from hdrtv_tpu_torch.models.import_npz import load_npz

    return load_npz(WEIGHTS)


def test_max_calibration_reproduces_the_fixture(fp32):
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig
    from hdrtv_tpu_torch.quant.calibrate import calibrate
    from hdrtv_tpu_torch.quant.int8 import quantize_params

    got = calibrate(quantize_params(fp32, mode="w8a8"), fixture_frames(), ModelConfig(), device="cpu")
    with np.load(FIXTURE) as z:
        want = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    worst = 0.0
    for k, v in want.items():
        if k.endswith(".x_scale"):
            worst = max(worst, abs(float(got[k]) / float(v) - 1.0))
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    assert worst <= X_RTOL, worst


def _jax_calibrate(q, frames, method):
    from hdrtv_tpu.models.hdrtvnet import ModelConfig
    from hdrtv_tpu.quant.calibrate import calibrate

    return calibrate(q, frames, ModelConfig(), method=method)


# The kl cases quantize a few layers of each kind: the JAX package's threshold
# search runs a Python loop of 128 groups for each of ~150 candidate bins a layer.
KL_LAYERS = ["AGCM.conv_first", "AGCM.cond_scale_first", "LE.cond_first.0", "LE.CondNet2.2", "LE.HR_conv1",
             "LE.recon_trunk3.1.conv2", "LE.SFT_layer2.SFT_shift_conv1", "LE.up_conv3.0"]


@pytest.fixture(scope="module")
def quantized(fp32):
    from hdrtv_tpu_torch.quant.int8 import quantize_params

    return {(asym, kl): quantize_params(fp32, KL_LAYERS if kl else None, mode="w8a8", asymmetric=asym)
            for asym in (False, True) for kl in (False, True)}


@pytest.mark.parametrize("method,asym", [("max", True), ("percentile", False), ("percentile", True),
                                         ("kl", False), ("kl", True)])
def test_calibrate_matches_jax(quantized, method, asym):
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig
    from hdrtv_tpu_torch.quant.calibrate import KL_BINS, calibrate

    q = quantized[asym, method == "kl"]
    frames = seeded_frames()
    got = calibrate(q, frames, ModelConfig(), method=method, device="cpu")
    want = _jax_calibrate(q, frames, method)
    if method == "kl" and not asym:  # each layer's histogram range: its abs-max, the max method's scale × 127
        ranges = calibrate(q, frames, ModelConfig(), method="max", device="cpu")
    assert sorted(got) == sorted(want)
    rtol = PCT_RTOL if method == "percentile" else X_RTOL
    apart = []
    for k in want:
        if not k.endswith((".x_scale", ".x_zero")):
            continue
        g, w = float(got[k]), float(want[k])
        layer = k.rsplit(".", 1)[0]
        if method == "kl" and not asym:
            # the threshold bin from each scale, on the layer's range: (bin + 0.5) · width / 127
            bin_w = float(ranges[k]) * 127 / KL_BINS
            fg, fw = g * 127 / bin_w - 0.5, w * 127 / bin_w - 0.5
            assert abs(fg - round(fg)) < 1e-2 and abs(fw - round(fw)) < 1e-2, (k, fg, fw)
            apart.append(abs(round(fg) - round(fw)))
            continue
        assert abs(g - w) <= rtol * max(abs(w), 1e-12), (k, g, w)
    if method == "kl" and not asym:
        assert max(apart) <= 1, apart


def test_abs_histogram_matches_jax_on_edges():
    """Values on every kind of edge: 0, interior edges, the range's end, and
    past it (dropped), plus random values."""
    from hdrtv_tpu_torch.quant.calibrate import abs_histogram

    rng = 1.7
    edges = np.asarray(jnp.linspace(0.0, jnp.float32(rng), 2049, dtype=jnp.float32))
    rs = np.random.RandomState(3)
    x = np.concatenate([edges, -edges[::7], np.nextafter(edges, np.float32(0)), [rng * 1.5, -2 * rng, 0.0],
                        (rs.randn(5000) * 0.6).astype(f32)]).astype(f32)
    got = abs_histogram(torch.from_numpy(x), rng).numpy()
    want = np.asarray(jnp.histogram(jnp.abs(jnp.asarray(x)), bins=2048, range=(0.0, rng))[0])
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got[-1] >= 2 and got.sum() < x.size


def test_kl_threshold_matches_jax():
    from hdrtv_tpu.quant.calibrate import kl_threshold as jax_kl
    from hdrtv_tpu_torch.quant.calibrate import kl_threshold

    rs = np.random.RandomState(5)
    hists = [np.histogram(np.abs(rs.randn(20000)) ** p, bins=2048)[0] for p in (1.0, 2.0, 0.5)]
    hists += [np.zeros(2048), np.r_[np.ones(100), np.zeros(1948)]]
    for h in hists:
        assert kl_threshold(h) == jax_kl(h)


def test_percentile_matches_numpy_above_2_24():
    """torch.quantile refuses this size; the helper equals np.percentile on
    the float64 values (the exact position)."""
    from hdrtv_tpu_torch.quant.calibrate import percentile

    n = (1 << 24) + 1001
    x = torch.from_numpy(np.random.RandomState(11).randn(n).astype(f32))
    with pytest.raises(RuntimeError):
        torch.quantile(x, 0.999)
    x64 = x.numpy().astype(np.float64)
    for q in (0.1, 50.0, 99.9, 100.0):
        assert float(percentile(x, q)) == float(np.percentile(x64, q)), q


def test_percentile_matches_jax_at_calibration_sizes():
    from hdrtv_tpu_torch.quant.calibrate import percentile

    for n, seed in ((1537, 0), (49152, 1)):
        x = np.random.RandomState(seed).randn(n).astype(f32)
        for q in (0.1, 99.9):
            w = float(jnp.percentile(jnp.asarray(x), q))
            assert abs(float(percentile(torch.from_numpy(x), q)) - w) <= PCT_RTOL * abs(w)


@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (1, 1, 32, 6), (24, 10), (16,)],
                         ids=["hwio3x3", "hwio1x1", "dense", "vector"])
def test_fake_quant_ste_matches_jax(shape):
    from hdrtv_tpu.quant.qat import fake_quant_ste as jax_fq
    from hdrtv_tpu_torch.quant.qat import fake_quant_ste

    w = (np.random.RandomState(len(shape)).randn(*shape) * 0.2).astype(f32)
    w[..., 0] = 0.0  # an all-zero output channel: the 1e-8 floor
    t = torch.from_numpy(w).requires_grad_(True)
    y = fake_quant_ste(t)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jax_fq(jnp.asarray(w))))
    g = torch.from_numpy(np.random.RandomState(9).randn(*shape).astype(f32))
    y.backward(g)
    np.testing.assert_array_equal(t.grad.numpy(), g.numpy())
    jg = jax.grad(lambda v: jnp.sum(jax_fq(v) * jnp.asarray(g.numpy())))(jnp.asarray(w))
    np.testing.assert_array_equal(np.asarray(jg), g.numpy())


def test_capture_records_inputs_and_leaves_the_forward(fp32):
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig, model_apply, natural_params_to_torch
    from hdrtv_tpu_torch.models.layers import _ACTIVE_CAPTURE, ActivationCapture
    from hdrtv_tpu_torch.quant.calibrate import frame_inputs
    from hdrtv_tpu_torch.quant.int8 import quantizable_layers

    p = natural_params_to_torch(fp32, "cpu")
    img, cond = frame_inputs(seeded_frames(1)[0], "cpu")
    with torch.inference_mode():
        plain = model_apply(p, img, cond, ModelConfig())
        watch = ["LE.conv_first", "AGCM.cond_scale_first"]
        with ActivationCapture(watch) as cap:
            again = model_apply(p, img, cond, ModelConfig())
        with ActivationCapture() as every:
            model_apply(p, img, cond, ModelConfig())
    assert not _ACTIVE_CAPTURE
    assert torch.equal(plain, again)
    assert sorted(cap.stats) == sorted(watch)
    assert set(every.stats) == set(quantizable_layers(fp32))
    first = cap.stats["LE.conv_first"]
    assert float(first["abs_max"]) == max(float(first["max"]), -float(first["min"])) > 0


def test_load_mixed_layout_matches_jax(tmp_path):
    from hdrtv_tpu.quant.int8 import load_mixed_layout as jax_load
    from hdrtv_tpu_torch.quant.int8 import load_mixed_layout

    path = tmp_path / "layout.txt"
    path.write_text("# header\nLE.conv_first\n\n  LE.HR_conv1  \n# --- rejected\n# LE.conv_last\nAGCM.cond_scale1\n")
    assert load_mixed_layout(str(path)) == jax_load(str(path)) == ["LE.conv_first", "LE.HR_conv1",
                                                                   "AGCM.cond_scale1"]


@pytest.mark.parametrize("argv", [["pool"], ["vjp", "--size", "64x128"],
                                  ["calib", FIXTURE, "--calib-size", "32x48", "--calib-frames", "2",
                                   "--frame-size", "64x96", "--zero", "LE.HR_conv2=-0.5"],
                                  ["calib", "--qat-steps", "1", "--calib-size", "32x64", "--calib-frames", "2",
                                   "--frame-size", "64x96"]],
                         ids=["pool", "vjp", "calib", "calib_qat"])
def test_qat_probe_runs_on_the_cpu(argv, capsys):
    """tools/qat_probe.py on the CPU: the pool's two forms agree with
    themselves, the VJP with itself, and the calibration report reads every
    W8A8 layer, of the fixture (symmetric: the moved zero point makes
    LE.HR_conv2 asymmetric) and of a checkpoint run_qat makes."""
    import json

    from hdrtv_tpu_torch.tools import qat_probe

    assert qat_probe.main(["--device", "cpu"] + argv) == 0
    out = json.loads(capsys.readouterr().out)[argv[0]]
    if argv[0] == "pool":
        assert all(r[f]["forward_equal"] and r[f]["backward_apart"] == 0.0 for r in out.values() for f in r)
    elif argv[0] == "vjp":
        assert out[0]["loss_rel"] == 0.0 and out[0]["median"] == 0.0 and out[0]["leaves"] > 200
    else:
        assert out["layers"] == 127 and math.isfinite(out["int8_vs_float_psnr"])
        assert out["zeros_moved"] == ({"LE.HR_conv2": -0.5} if FIXTURE in argv else {})
