"""The port's sensitivity probe, precision sweep and data tooling
(``hdrtv_tpu_torch/quant/mixed.py``, ``bench/sweep.py``,
``data/curate.py``) on the CPU, against the JAX package's on the same numpy
frames and files.

Held here: ``probe_layer_sensitivity`` on a three-layer subset (each score
within PROBE_RTOL of JAX's relative to the largest such score, the GFLOPs
equal) and ``generate_mixed_layout``'s choice (the same layers, in the same
order, where JAX's ranking keys lie more than PROBE_RTOL apart);
``precision_sweep`` with given fp32, bf16 and int8 presets (PSNR, SSIM and
ΔEITP within SWEEP_TOL, the layer mix equal); the synthetic frames equal;
``score_hard_pair``, ``repeat_for_rank`` and ``mine_hard_frames`` equal on
images the test writes; ``make_teacher_pairs`` on a clip the test writes: SDR PNGs equal, teacher PNGs equal to the port's
``process_rgb48`` of the same frame and within CODES of JAX's.
"""

import json
import os

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "hr_w8a8.npz")
f32 = np.float32
PROBE_RTOL = 1e-3  # of the largest score: MAEs of int8 outputs, fp32 sums in two orders
# Sweep rows, port against JAX: (PSNR dB, SSIM, ΔEITP relative). The float
# rows differ by the two programs' sum orders and bf16 roundings; the int8
# rows also by the activation codes a last-bit difference flips, each moving
# every int8 layer after it (twice the 0.147 dB, 1.7e-4 SSIM and 1.4% ΔEITP
# seen in bf16; 0.044 dB, 1.5e-4, 0.8% in fp32).
SWEEP_TOL = {"float": (0.05, 1e-4, 0.02), "int8": (0.3, 4e-4, 0.03)}
CODES = 4  # fp32 u16 codes: the 5e-5 golden tolerance × 65535, rounded up (tests/test_torch_slice.py)
PROBE_LAYERS = ["LE.conv_first", "LE.recon_trunk3.1.conv2", "AGCM.cond_scale_first"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU programs on one intra-op thread: the suite runs in several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fp32():
    from hdrtv_tpu_torch.models.import_npz import load_npz

    return load_npz(WEIGHTS)


def probe_frames(n=2, h=32, w=48):
    """Seeded noise with a near-white block: the highlight mask non-empty."""
    rng = np.random.RandomState(13)
    out = []
    for _ in range(n):
        f = rng.rand(h, w, 3).astype(f32)
        f[4:12, 6:20] = 0.93
        out.append(f)
    return out


def test_probe_layer_sensitivity_matches_jax(fp32):
    from hdrtv_tpu.models.hdrtvnet import ModelConfig as JCfg
    from hdrtv_tpu.quant.mixed import probe_layer_sensitivity as jax_probe
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig
    from hdrtv_tpu_torch.quant.mixed import probe_layer_sensitivity

    fs = probe_frames()
    got = probe_layer_sensitivity(fp32, fs, ModelConfig(), layers=PROBE_LAYERS, device="cpu")
    want = jax_probe(fp32, fs, JCfg(), layers=PROBE_LAYERS)
    assert [s.layer for s in got] == [s.layer for s in want] == PROBE_LAYERS
    for field in ("mae", "highlight_mae", "delta_e_itp"):
        top = max(getattr(s, field) for s in want)
        assert top > 0, field
        for g, w in zip(got, want):
            assert abs(getattr(g, field) - getattr(w, field)) <= PROBE_RTOL * top, (field, g, w)
    assert [s.gflops for s in got] == [s.gflops for s in want]
    assert all(s.gflops > 0 for s in got)


def test_generate_mixed_layout_matches_jax(fp32, tmp_path):
    from hdrtv_tpu.models.hdrtvnet import ModelConfig as JCfg
    from hdrtv_tpu.quant.int8 import load_mixed_layout
    from hdrtv_tpu.quant.mixed import generate_mixed_layout as jax_gen, probe_layer_sensitivity as jax_probe
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig
    from hdrtv_tpu_torch.quant.mixed import generate_mixed_layout

    fs = probe_frames(1, 24, 32)
    count = 12
    got = generate_mixed_layout(fp32, fs, ModelConfig(), count=count, out_path=str(tmp_path / "port.txt"),
                                device="cpu")
    want = jax_gen(fp32, fs, JCfg(), count=count, out_path=str(tmp_path / "jax.txt"))
    assert load_mixed_layout(str(tmp_path / "port.txt")) == got and len(got) == count
    # Where JAX's ranking keys of neighbours lie within PROBE_RTOL, their order may swap.
    keys = sorted(s.cost_per_gflop for s in jax_probe(fp32, fs, JCfg()))
    close = {i for i in range(len(keys) - 1) if keys[i + 1] - keys[i] <= PROBE_RTOL * keys[i + 1]}
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w or i in close or i - 1 in close, (i, got, want)
    assert set(got) == set(want) or count - 1 in close or count - 2 in close


def test_precision_sweep_matches_jax(fp32):
    from hdrtv_tpu.bench.sweep import precision_sweep as jax_sweep
    from hdrtv_tpu.models.hdrtvnet import ModelConfig as JCfg
    from hdrtv_tpu_torch.bench.sweep import precision_sweep
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig

    with np.load(FIXTURE) as z:
        w8a8 = {k: z[k] for k in z.files}
    presets = {"fp32": {"params": fp32, "precision": "fp32"}, "bf16": {"params": fp32, "precision": "bf16"},
               "int8-full fp32": {"params": w8a8, "precision": "fp32"},
               "int8-full": {"params": w8a8, "precision": "bf16"}}
    fs = probe_frames(2, 32, 48)
    got = precision_sweep(fp32, ModelConfig(), presets=presets, frames=fs, device="cpu")
    want = jax_sweep(fp32, JCfg(), presets=presets, frames=fs)
    assert [e.preset for e in got] == [e.preset for e in want] == list(presets)
    for g, w in zip(got, want):
        db, ssim, de = SWEEP_TOL["int8" if g.preset.startswith("int8") else "float"]
        assert g.layer_mix == w.layer_mix
        assert abs(g.psnr - w.psnr) <= db, (g, w)
        assert abs(g.ssim - w.ssim) <= ssim, (g, w)
        assert abs(g.delta_e_itp - w.delta_e_itp) <= de * max(w.delta_e_itp, 1e-3), (g, w)
        assert g.ms_per_frame > 0
    assert got[0].psnr > got[1].psnr > got[3].psnr  # fp32 against itself, then bf16, then int8


def test_synthetic_frames_match_jax():
    from hdrtv_tpu.bench import sweep as js
    from hdrtv_tpu_torch.bench import sweep as ts

    for a, b in zip(ts._frames(2, (24, 40)), js._frames(2, (24, 40))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ts.natural_frames(3, (48, 64)), js.natural_frames(3, (48, 64))):
        np.testing.assert_array_equal(a, b)


def test_score_hard_pair_and_repeats_match_jax():
    from hdrtv_tpu.data import curate as jc
    from hdrtv_tpu_torch.data import curate as tc

    rng = np.random.RandomState(4)
    for k in range(3):
        sdr = rng.rand(40, 56, 3).astype(f32)
        hdr = np.clip(sdr * (0.8 + 0.3 * k) + rng.rand(40, 56, 3).astype(f32) * 0.1, 0, 1)
        hdr[:10, :10] = 1.0
        assert tc.score_hard_pair(sdr, hdr) == jc.score_hard_pair(sdr, hdr)
    for total in (1, 7, 40):
        for mr in (1, 2, 4):
            assert [tc.repeat_for_rank(r, total, mr) for r in range(total)] == \
                [jc.repeat_for_rank(r, total, mr) for r in range(total)]


def _write_pairs(root, n=5):
    import cv2

    sdr_dir, hdr_dir = root / "sdr", root / "hdr"
    sdr_dir.mkdir()
    hdr_dir.mkdir()
    rng = np.random.RandomState(6)
    for i in range(n):
        s = (rng.rand(48, 80, 3) * 255 * (0.3 + 0.15 * i)).clip(0, 255).astype(np.uint8)
        h = (rng.rand(48, 80, 3) * 65535 * (0.2 + 0.2 * i)).clip(0, 65535).astype(np.uint16)
        cv2.imwrite(str(sdr_dir / f"f{i:02d}.png"), s)
        cv2.imwrite(str(hdr_dir / (f"f{i:02d}.png" if i % 2 else f"f{i:02d}.tif")), h)
    return str(sdr_dir), str(hdr_dir)


def test_mine_hard_frames_matches_jax(tmp_path):
    from hdrtv_tpu.data import curate as jc
    from hdrtv_tpu_torch.data import curate as tc

    sdr_dir, hdr_dir = _write_pairs(tmp_path)
    got = tc.mine_hard_frames(sdr_dir, hdr_dir, str(tmp_path / "port"), top=3, max_long_edge=64)
    want = jc.mine_hard_frames(sdr_dir, hdr_dir, str(tmp_path / "jax"), top=3, max_long_edge=64)
    assert {k: v for k, v in got.items() if k != "csv"} == {k: v for k, v in want.items() if k != "csv"}
    assert got["hard_count"] == 3 and got["total_pairs"] == 5
    with open(got["csv"]) as a, open(want["csv"]) as b:
        assert a.read() == b.read()
    with open(tmp_path / "port" / "manifest.json") as f:
        assert json.load(f)["replay"] == got["replay"]


def test_make_teacher_pairs_matches_jax(tmp_path):
    import cv2

    from hdrtv_tpu.data.curate import make_teacher_pairs as jax_pairs
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.data.curate import make_teacher_pairs
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    h, w = 64, 96
    clip = str(tmp_path / "clip.avi")
    wr = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), 24, (w, h))
    rng = np.random.RandomState(2)
    for _ in range(4):
        wr.write((rng.rand(h, w, 3) * 255).astype(np.uint8))
    wr.release()
    proc = HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu", persistent_cache=False)
    got = make_teacher_pairs(clip, proc, str(tmp_path / "port"), num_frames=2, start_frame=1)
    want = jax_pairs(clip, HDRTVNetTPU(WEIGHTS, precision="fp32"), str(tmp_path / "jax"), num_frames=2,
                     start_frame=1)
    assert got["count"] == want["count"] == 2
    assert [p["frame"] for p in got["pairs"]] == [p["frame"] for p in want["pairs"]] == [1, 3]
    for g, j in zip(got["pairs"], want["pairs"]):
        sdr = cv2.imread(g["sdr"], cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(sdr, cv2.imread(j["sdr"], cv2.IMREAD_UNCHANGED))
        teacher = cv2.imread(g["teacher"], cv2.IMREAD_UNCHANGED)
        assert teacher.dtype == np.uint16 and teacher.shape == (h, w, 3)
        np.testing.assert_array_equal(teacher[..., ::-1], proc.process_rgb48(sdr))
        jt = cv2.imread(j["teacher"], cv2.IMREAD_UNCHANGED).astype(np.int64)
        assert np.abs(teacher.astype(np.int64) - jt).max() <= CODES
