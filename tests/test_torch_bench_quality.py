"""The port's quality benchmark and its host modules on the CPU, held against
``hdrtv_tpu`` on the same numpy inputs made from a seed: ``evaluate_pair``
(at ``tests/test_torch_metrics.py``'s tolerances: 1e-4 dB PSNR, 1e-6 SSIM,
1e-4 relative ΔEITP), ``run_quality_benchmark`` and ``run_quality_queue``
with the same numpy fake processor in both packages (the same frame ids,
offsets, ``verify_reasons``, files and metrics), one run through
``HDRTVNetTorch(device="cpu")`` on the shipped weights held against the JAX
``evaluate_pair`` on the port's own output, ``frame_select``, ``gt_sync``,
``gt_validate``, ``hdr_io``, ``compare_frame``, ``validate_checkpoint`` on
the W8A8 fixture, ``tone_map_pq`` and ``pq_encode_u16``, and a subprocess
import of every new module with ``jax`` and ``hdrtv_tpu`` blocked."""

import csv
import json
import os
import subprocess
import sys

import cv2
import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the port's torch)
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
W8A8 = os.path.join(ROOT, "tests", "fixtures", "hr_w8a8.npz")
METRIC_TOL = {"psnr": 1e-4, "psnr_gn": 1e-4, "ssim": 1e-6, "delta_e_itp": 1e-4, "delta_e_itp_gn": 1e-4}
ROUND = {"psnr": 1e-4, "psnr_gn": 1e-4, "ssim": 1e-5, "delta_e_itp": 1e-4, "delta_e_itp_gn": 1e-4}
NEW_MODULES = ("bench.hdr_io", "bench.frame_select", "bench.gt_sync", "bench.quality", "pipeline.compare",
               "bench.gt_validate", "bench.playback", "bench.wrapper", "bench.validate", "bench.hdrvdp3",
               "bench.figures", "runtime.doctor", "cli")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU programs on one intra-op thread: the suite runs in several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got: dict, want: dict, *, rounded: bool = False) -> dict:
    """Keys of METRIC_TOL whose values differ beyond it (ΔEITP relative, or
    1e-3 absolute: an identical pair reads 720·√1e-12 = 7.2e-4, which XLA's
    fp32 grade normalization moves by 1.6e-4); a rounded summary's values
    also by their rounding unit."""
    bad = {}
    for k, tol in METRIC_TOL.items():
        allowed = max(tol * abs(want[k]), 1e-3) if k.startswith("delta") else tol
        if abs(got[k] - want[k]) > allowed + (ROUND[k] if rounded else 0.0):
            bad[k] = (got[k], want[k])
    return bad


def _frame(i, h=48, w=64):
    return (np.random.RandomState(1000 + i).rand(h, w, 3) * 255).astype(np.uint8)


class _Source:
    """SDR frames by index (each its own seeded noise), the benchmark's
    seek / read_with_meta."""

    fps = 30.0
    frame_count = 0  # unknown length: selection scans from frame 0

    def __init__(self, n=120, make=_frame):
        self.n, self.make, self.i = n, make, 0

    def read_with_meta(self, timeout=0.0):
        if self.i >= self.n:
            return None
        i = self.i
        self.i += 1
        return self.make(i), i, i / self.fps

    def seek(self, i):
        self.i = int(i)


class _Identity:
    """The numpy fake processor of both packages: the SDR frame as RGB48."""

    device = "cpu"
    model_path = ""

    def process_rgb48(self, frame_bgr):
        return frame_bgr[..., ::-1].astype(np.uint16) * 257


def _gt_lagging(idx):
    """A GT stream whose index j holds SDR frame j + 1: SDR frame i is at
    GT i - 1 (offset -1)."""
    if not 0 <= idx + 1 < 130:
        return None
    return _frame(idx + 1)[..., ::-1].astype(np.float32) / 255.0


@pytest.mark.parametrize("case", ["same", "mismatched", "letterbox", "large"])
def test_evaluate_pair_matches_jax(case):
    from hdrtv_tpu.bench.quality import evaluate_pair as jax_eval
    from hdrtv_tpu_torch.bench.quality import evaluate_pair

    rng = np.random.RandomState(3)
    pred = rng.rand(48, 64, 3).astype(np.float32)
    gt = np.clip(pred + rng.randn(48, 64, 3).astype(np.float32) * 0.03, 0, 1)
    if case == "mismatched":  # a full-resolution GT: resized to the prediction's grid first
        gt = np.repeat(np.repeat(gt, 2, axis=0), 3, axis=1)
    elif case == "letterbox":  # shared black bars: cropped before the metrics
        pred[:10], gt[:10], pred[-10:], gt[-10:] = 0, 0, 0, 0
    elif case == "large":  # over max_side: the area resize
        pred = rng.rand(300, 700, 3).astype(np.float32)
        gt = np.clip(pred + rng.randn(300, 700, 3).astype(np.float32) * 0.02, 0, 1)
    got, want = evaluate_pair(pred, gt, device="cpu"), jax_eval(pred, gt)
    assert set(got) == set(want) and not _close(got, want)


def test_evaluate_pair_needs_a_card_unless_asked(monkeypatch):
    from hdrtv_tpu_torch.bench.quality import evaluate_pair
    from hdrtv_tpu_torch.utils.device import compute_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((8, 8, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_pair(x, x)
    assert compute_device("cpu") == torch.device("cpu")


def test_run_quality_benchmark_matches_jax(tmp_path):
    """The same fake processor, source and lagging GT through both
    packages: the same rows (frame ids, GT frames, offsets, reasons),
    metrics, files and summary keys."""
    from hdrtv_tpu.bench import quality as jq
    from hdrtv_tpu_torch.bench import quality as tq

    runs = {}
    for name, mod in (("jax", jq), ("torch", tq)):
        runs[name] = mod.run_quality_benchmark(
            mod.QualityRunConfig(frame_count=3), _Identity(), _Source(), _gt_lagging, str(tmp_path / name),
            source_name="synthetic", post_verify=True, verify_window=2)
    got, want = runs["torch"], runs["jax"]
    assert set(got) == set(want) and got["frames"] and len(got["frames"]) == len(want["frames"])
    for k in ("source", "precision", "resolution", "use_hg", "frame_selection", "gt_decode", "post_verify"):
        assert got[k] == want[k]
    for g, w in zip(got["frames"], want["frames"]):
        assert {k: g[k] for k in ("frame", "gt_frame", "gt_alignment_offset_frames", "verify_reasons")} == \
            {k: w[k] for k in ("frame", "gt_frame", "gt_alignment_offset_frames", "verify_reasons")}
        assert g["gt_alignment_offset_frames"] == -1 and abs(g["gt_alignment_score"] - w["gt_alignment_score"]) <= 1e-5
        assert not _close(g, w, rounded=True)
    assert os.path.basename(got["session_dir"]).split("__", 1)[1] == \
        os.path.basename(want["session_dir"]).split("__", 1)[1]
    with open(os.path.join(got["session_dir"], "results.csv")) as f1, \
            open(os.path.join(want["session_dir"], "results.csv")) as f2:
        r1, r2 = list(csv.reader(f1)), list(csv.reader(f2))
    assert r1[0] == r2[0] and [r[0:2] + r[7:] for r in r1] == [r[0:2] + r[7:] for r in r2]
    with open(os.path.join(got["session_dir"], "summary.json")) as f:
        assert set(json.load(f)) == set(want) - {"session_dir"}
    for fidx in (r["frame"] for r in got["frames"]):
        d1 = os.path.join(got["session_dir"], "frames", f"{fidx:06d}")
        d2 = os.path.join(want["session_dir"], "frames", f"{fidx:06d}")
        assert sorted(os.listdir(d1)) == sorted(os.listdir(d2)) == ["hdr_convert.tiff", "hdr_gt.tiff", "sdr.png"]
        for name in os.listdir(d1):
            a = cv2.imread(os.path.join(d1, name), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(os.path.join(d2, name), cv2.IMREAD_UNCHANGED)
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_run_quality_queue_matches_jax(tmp_path):
    """The queue over two presets: the same frame pool (QC-gated selection,
    cv2), the alignment searched once and shared, the same rows; the port
    also takes the frame ids and post_verify given."""
    from hdrtv_tpu.bench import quality as jq
    from hdrtv_tpu_torch.bench import quality as tq

    out = {}
    for name, mod in (("jax", jq), ("torch", tq)):
        reads = []

        def gt_read(idx, _r=reads):
            _r.append(idx)
            return _gt_lagging(idx)

        ran = []
        sums = mod.run_quality_queue(mod.QualityRunConfig(frame_count=3), ["FP16", "FP32"], lambda k: _Identity(),
                                     _Source(), gt_read, str(tmp_path / name), save_artifacts=False,
                                     progress=ran.append)
        out[name] = (sums, reads, ran)
    (got, got_reads, ran), (want, want_reads, _) = out["torch"], out["jax"]
    assert ran == ["FP16", "FP32"] and got_reads == want_reads
    n = len(got[0]["frames"])
    assert n and len(got_reads) == 6 * n + n  # the ±2 search once, then one read a row and run
    for g, w in zip(got, want):
        assert [r["frame"] for r in g["frames"]] == [r["frame"] for r in w["frames"]]
        assert [r["gt_frame"] for r in g["frames"]] == [r["gt_frame"] for r in w["frames"]]
        assert all(not _close(a, b, rounded=True) for a, b in zip(g["frames"], w["frames"]))

    ids = [r["frame"] for r in got[0]["frames"]]
    given = tq.run_quality_queue(tq.QualityRunConfig(frame_count=3), ["FP16"], lambda k: _Identity(), _Source(),
                                 _gt_lagging, str(tmp_path / "given"), save_artifacts=False, frame_ids=ids[::-1],
                                 post_verify=False)
    assert [r["frame"] for r in given[0]["frames"]] == ids[::-1]
    assert all(r["gt_alignment_offset_frames"] == 0 and r["psnr"] < 20 for r in given[0]["frames"])


def test_quality_through_the_port_processor(tmp_path):
    """HDRTVNetTorch on the CPU at 64 × 96 (fp32, the shipped weights): each
    row's hdr_convert is process_rgb48's frame and its metrics are the JAX
    evaluate_pair's on the port's own output against the GT frame."""
    from hdrtv_tpu.bench.quality import evaluate_pair as jax_eval
    from hdrtv_tpu_torch.bench.quality import QualityRunConfig, run_quality_benchmark
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    proc = HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu")
    frames = {i: _frame(i, 64, 96) for i in range(4)}
    gt = {i + 1: proc.process_rgb48(f).astype(np.float32) / 65535.0 for i, f in frames.items()}
    s = run_quality_benchmark(QualityRunConfig(precision_key="FP32", frame_count=3), proc,
                              _Source(4, lambda i: frames[i]), gt.get, str(tmp_path), frame_ids=[0, 1, 2, 3],
                              save_artifacts=True)
    assert [r["frame"] for r in s["frames"]] == [0, 1, 2, 3]
    for r in s["frames"]:
        assert r["gt_frame"] == r["frame"] + 1 and r["psnr"] == 99.0
        tiff = os.path.join(s["session_dir"], "frames", f"{r['frame']:06d}", "hdr_convert.tiff")
        out = cv2.imread(tiff, cv2.IMREAD_UNCHANGED)[..., ::-1]
        assert np.array_equal(out, proc.process_rgb48(frames[r["frame"]]))
        assert not _close(r, jax_eval(out.astype(np.float32) / 65535.0, gt[r["gt_frame"]]), rounded=True)
    # against a GT of the next frame's output: real metrics, still the JAX ones
    s2 = run_quality_benchmark(QualityRunConfig(frame_count=2), proc, _Source(4, lambda i: frames[i]),
                               lambda i: gt.get(i + 2), str(tmp_path), frame_ids=[0, 1], post_verify=False,
                               save_artifacts=False)
    for r in s2["frames"]:
        want = jax_eval(proc.process_rgb48(frames[r["frame"]]).astype(np.float32) / 65535.0, gt[r["frame"] + 2])
        assert r["psnr"] < 40 and not _close(r, want, rounded=True)


def _credits_card():
    img = np.zeros((360, 640, 3), np.uint8)
    for row in range(40, 320, 18):
        for col in range(120, 520, 9):
            if (row * 7 + col * 3) % 5:
                img[row:row + 8, col:col + 5] = 235
    return img


def test_frame_select_matches_jax():
    from hdrtv_tpu.bench import frame_select as jf
    from hdrtv_tpu_torch.bench import frame_select as tf

    rng = np.random.RandomState(11)
    frames = [
        (rng.rand(120, 200, 3) * 255).astype(np.uint8),  # textured
        np.full((120, 200, 3), 3, np.uint8),  # black
        np.full((120, 200, 3), 252, np.uint8),  # white
        np.full((120, 200, 3), 128, np.uint8),  # flat grey
        _credits_card(),
        np.pad((rng.rand(80, 200, 3) * 255).astype(np.uint8), ((20, 20), (0, 0), (0, 0))),  # letterboxed
    ]
    for f in frames:
        assert tf.frame_qc(f) == jf.frame_qc(f)
        assert tf.looks_like_logo_or_credits(f) == jf.looks_like_logo_or_credits(f)
        assert tf.visual_interest(f) == jf.visual_interest(f)
    assert [tf.frame_qc(f)[1] for f in frames[:5]] == ["ok", "too_dark", "too_bright", "flat", "logo_or_credits"]
    for total, fps in ((0, None), (100, 24.0), (6000, 24.0), (200000, 23.976), (200000, None)):
        assert tf.movie_frame_bounds(total, fps) == jf.movie_frame_bounds(total, fps)


def _write_y4m(path, frames_rgb01, ctag="444p10"):
    from hdrtv_tpu_torch.bench.y4m import Y4MWriter

    h, w = frames_rgb01[0].shape[:2]
    with Y4MWriter(path, w, h, fps=25.0, ctag=ctag) as wr:
        for f in frames_rgb01:
            wr.write_rgb_unit(f)


def test_gt_sync_matches_jax(tmp_path):
    """A 10-bit y4m ground truth read exactly by both readers; the offset
    search finds the same shift and score, and the disk cache serves it."""
    from hdrtv_tpu.bench import gt_sync as jg
    from hdrtv_tpu_torch.bench import gt_sync as tg

    frames = [np.random.RandomState(50 + i).rand(48, 64, 3).astype(np.float32) for i in range(12)]
    path = str(tmp_path / "gt.y4m")
    _write_y4m(path, frames)
    tr, jr = tg.HDRGroundTruthReader(path), jg.HDRGroundTruthReader(path)
    try:
        assert (tr.decode_method, tr.fps, tr.frame_count) == (jr.decode_method, jr.fps, jr.frame_count)
        assert tr.decode_method == "y4m-native-exact-10bit"
        for i in (0, 5, 11):
            assert np.array_equal(tr.read_unit_rgb(i), jr.read_unit_rgb(i))
        assert tr.read_unit_rgb(12) is None and tr.read_unit_rgb(-1) is None
        sdr = {i: frames[i + 2] for i in (0, 3, 6)}  # GT leads by two frames
        fmap = tg.make_frame_map(25.0, tr.fps)
        cache = str(tmp_path / "cache.json")
        got = tg.find_sync_offset(sdr, tr, fmap, window_frames=3, cache_path=cache, cache_key="k")
        want = jg.find_sync_offset(sdr, jr, jg.make_frame_map(25.0, jr.fps), window_frames=3)
        assert got[0] == want[0] == 2 and abs(got[1] - want[1]) < 1e-9
        with open(cache) as f:
            assert list(json.load(f)) == ["k|w3|g0.06"]
        assert tg.find_sync_offset({}, None, fmap, window_frames=3, cache_path=cache, cache_key="k") == got
    finally:
        tr.close()
        jr.close()
    assert tg.make_frame_map(24.0, 48.0, 3)(10) == jg.make_frame_map(24.0, 48.0, 3)(10) == 23
    assert np.array_equal(tg._signature(frames[0]), jg._signature(frames[0]))
    assert tg.file_token(path) == jg.file_token(path)


def test_gt_reader_y4m_needs_no_cv2(tmp_path):
    """The y4m branch decodes without cv2 (the JAX reader imports it first)."""
    path = str(tmp_path / "gt.y4m")
    frame = np.random.RandomState(5).rand(16, 24, 3).astype(np.float32)
    _write_y4m(path, [frame])
    code = (
        "import sys; sys.modules['cv2'] = None\n"
        "from hdrtv_tpu_torch.bench.gt_sync import HDRGroundTruthReader\n"
        "from hdrtv_tpu_torch.bench.y4m import Y4MReader\n"
        f"r = HDRGroundTruthReader({path!r}); import numpy as np\n"
        f"assert np.array_equal(r.read_unit_rgb(0), Y4MReader({path!r}).read_rgb_unit(0))\n"
        "assert 'cv2' not in [k for k, v in sys.modules.items() if v is not None]\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_hdr_io_matches_jax(tmp_path, monkeypatch):
    from hdrtv_tpu.bench import hdr_io as jh
    from hdrtv_tpu_torch.bench import hdr_io as th

    assert th.build_exact_decode_cmd("v.mkv", [9, 3, 3]) == jh.build_exact_decode_cmd("v.mkv", [9, 3, 3])
    assert th.build_preview_decode_cmd("v.mkv", [1, 2], 160, 90) == jh.build_preview_decode_cmd("v.mkv", [1, 2], 160, 90)
    assert th.build_fast_decode_cmd("v.mkv", 240, 23.976) == jh.build_fast_decode_cmd("v.mkv", 240, 23.976)
    assert th.preview_dims(3840, 1600) == jh.preview_dims(3840, 1600)
    stderr = "\n".join(
        f"[Parsed_showinfo_0 @ 0x5] n:{i} pts:{i * 1001} pts_time:{i / 23.976:.6f} duration:1001" for i in range(6)
    ) + "\nframe=6 fps=0.0\n[Parsed_showinfo_0 @ 0x5] n: 7 pts:x pts_time:0.5"
    assert th.parse_showinfo(stderr) == jh.parse_showinfo(stderr)
    infos = th.parse_showinfo(stderr)
    monkeypatch.setenv("HDRTVNET_HDR_FAST_SEEK_PTS_TOL_FRAMES", "0.3")
    for t in (0.0, 3 / 23.976, 3.4 / 23.976, 9.0):
        assert th.match_pts_frame(infos, t, 23.976) == jh.match_pts_frame(infos, t, 23.976)
    path = str(tmp_path / "gt.y4m")
    _write_y4m(path, [np.zeros((16, 24, 3), np.float32)] * 2)
    assert th.probe_video(path) == jh.probe_video(path)
    u16 = (np.random.RandomState(1).rand(16, 24, 3) * 65535).astype(np.uint16)
    for name, fn in (("a.tiff", "write_tiff16"), ("a.png", "write_png16")):
        getattr(th, fn)(str(tmp_path / f"t_{name}"), u16)
        getattr(jh, fn)(str(tmp_path / f"j_{name}"), u16)
        assert np.array_equal(cv2.imread(str(tmp_path / f"t_{name}"), cv2.IMREAD_UNCHANGED),
                              cv2.imread(str(tmp_path / f"j_{name}"), cv2.IMREAD_UNCHANGED))
    x = np.random.RandomState(2).rand(4, 5, 3).astype(np.float32) * 1.2 - 0.1
    assert np.array_equal(th.float01_to_u16(x), jh.float01_to_u16(x))


def test_compare_frame_matches_jax(tmp_path):
    from hdrtv_tpu.pipeline.compare import compare_frame as jax_compare
    from hdrtv_tpu_torch.pipeline.compare import compare_frame, write_compare_sheet

    frame, gt = _frame(4), _gt_lagging(3)
    got, want = compare_frame(_Identity(), frame, frame_idx=4, gt_rgb01=gt), jax_compare(_Identity(), frame,
                                                                                          frame_idx=4, gt_rgb01=gt)
    assert np.array_equal(got.hdr_convert_rgb01, want.hdr_convert_rgb01) and np.array_equal(got.sdr_rgb01,
                                                                                            want.sdr_rgb01)
    assert not _close(got.metrics, want.metrics)
    path = write_compare_sheet(got, str(tmp_path))
    assert os.path.basename(path) == "compare_000004.png" and sorted(os.listdir(tmp_path)) == [
        "compare_000004.json", "compare_000004.png", "hdr_convert_000004.png", "hdr_gt_000004.png",
        "sdr_000004.png"]
    assert compare_frame(_Identity(), frame).metrics == {}


def test_gt_validate_matches_jax(tmp_path):
    """validate_gt_pair on an MJPG clip against a 10-bit y4m ground truth
    (with the PQ sidecar) two frames ahead: the same verdict, offset and
    score in both packages; the worker's cancel."""
    from hdrtv_tpu.bench.gt_validate import validate_gt_pair as jax_validate
    from hdrtv_tpu.pipeline.export import _y4m_sidecar
    from hdrtv_tpu_torch.bench.gt_validate import GTValidationWorker, ValidationCanceled, validate_gt_pair

    rng = np.random.RandomState(7)
    frames = rng.randint(0, 255, (24, 32, 64, 3), np.uint8)
    sdr = str(tmp_path / "clip.avi")
    vw = cv2.VideoWriter(sdr, cv2.VideoWriter_fourcc(*"MJPG"), 25.0, (64, 32))
    for f in frames:
        vw.write(f)
    vw.release()
    gt = str(tmp_path / "gt.y4m")
    _write_y4m(gt, [np.zeros((32, 64, 3), np.float32)] * 2 + [f[..., ::-1].astype(np.float32) / 255.0
                                                               for f in frames])
    with open(gt + ".json", "w") as f:
        json.dump(_y4m_sidecar(gt), f)
    cwd = os.getcwd()
    os.chdir(tmp_path)  # the sync cache goes to logs/ under the working directory
    try:
        got, want = validate_gt_pair(gt, sdr), jax_validate(gt, sdr)
        assert (got.ok, got.message, got.offset_frames, got.notes) == (want.ok, want.message, want.offset_frames,
                                                                       want.notes)
        assert got.ok and got.offset_frames == 2 and abs(got.content_score - want.content_score) < 1e-9
        assert validate_gt_pair(str(tmp_path / "none.y4m"), sdr).message == "HDR GT file not found."
        with pytest.raises(ValidationCanceled):
            validate_gt_pair(gt, sdr, cancel_check=lambda: True)
        w = GTValidationWorker(gt, sdr)
        w.cancel()
        res = w.start().join(timeout=60)
        assert w.canceled and res.message == "Validation canceled."
    finally:
        os.chdir(cwd)


def test_validate_checkpoint_matches_jax():
    """The W8A8 fixture against the shipped fp32 weights at 48 × 64 (eager
    W8A8 activations, fp32 on the CPU): the same report as the JAX package's,
    within a flipped code's worth."""
    from hdrtv_tpu.bench.validate import temporal_stability_probe as jax_temporal
    from hdrtv_tpu.bench.validate import validate_checkpoint as jax_validate
    from hdrtv_tpu_torch.bench.validate import temporal_stability_probe, validate_checkpoint
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig
    from hdrtv_tpu_torch.models.import_npz import load_npz

    student, teacher = load_npz(W8A8), load_npz(WEIGHTS)
    got = validate_checkpoint(student, teacher, ModelConfig(), frame_count=1, size=(48, 64), device="cpu")
    want = jax_validate(student, teacher, ModelConfig(), frame_count=1, size=(48, 64))
    assert got.layer_mix == want.layer_mix == {"w8a8": 127, "fp": 1} and got.frames == want.frames == 1
    assert abs(got.psnr - want.psnr) <= 0.05 and abs(got.mae - want.mae) <= 2e-4
    with pytest.raises(AssertionError, match="layer contract violated"):
        validate_checkpoint(student, teacher, ModelConfig(), frame_count=1, size=(16, 16), device="cpu",
                            expected_mix={"w8a8": 29})
    t = temporal_stability_probe(teacher, ModelConfig(), frame_count=2, size=(48, 64), device="cpu")
    tj = jax_temporal(teacher, ModelConfig(), frame_count=2, size=(48, 64))
    assert set(t) == set(tj) and all(abs(t[k] - tj[k]) <= 1e-5 * max(1.0, abs(tj[k])) for k in t)


def test_tone_map_and_pq_encode_match_jax():
    """tone_map_pq (the BT.2390 EETF as torch ops) within 1e-3: each fp32
    implementation is up to 3.6e-4 from a float64 one on dark pixels, where
    the 1/2.4 power is steep. pq_encode_u16 within one code (XLA's fp32 pow
    under PQ's exponents). cas_sharpen and the resample equal."""
    from hdrtv_tpu.bench import figures as jf
    from hdrtv_tpu.bench.hdrvdp3 import hdrvdp3_score as jax_score
    from hdrtv_tpu.bench.hdrvdp3 import pq_encode_u16 as jax_pq
    from hdrtv_tpu_torch.bench import figures as tf
    from hdrtv_tpu_torch.bench.hdrvdp3 import hdrvdp3_score, pq_encode_u16

    x = np.random.RandomState(0).rand(40, 60, 3).astype(np.float32)
    x[0, 0], x[0, 1] = 0.0, 1.0
    for kw in ({}, {"target_nits": 100.0, "source_peak_nits": 4000.0}):
        assert np.abs(tf.tone_map_pq(x, device="cpu", **kw) - jf.tone_map_pq(x, **kw)).max() <= 1e-3
    y = x.copy()
    y[0, 2], y[0, 3] = -0.5, 1.5
    assert np.abs(pq_encode_u16(y).astype(np.int64) - jax_pq(y).astype(np.int64)).max() <= 1
    assert pq_encode_u16(y).dtype == np.uint16
    assert hdrvdp3_score(x, x) == jax_score(x, x)
    assert np.array_equal(tf.cas_sharpen(x, 0.6), jf.cas_sharpen(x, 0.6))
    for size in ((90, 70), (30, 17)):
        assert np.abs(tf.resize_rgb01(x, *size, device="cpu") - jf.resize_rgb01(x, *size)).max() <= 1e-6


def test_new_modules_leave_jax_out():
    """Every module of this slice imports with ``jax`` and ``hdrtv_tpu``
    blocked, and imports neither."""
    mods = ", ".join(f"'hdrtv_tpu_torch.{m}'" for m in NEW_MODULES)
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'hdrtv_tpu'): sys.modules[name] = None\n"
        f"for m in ({mods}): importlib.import_module(m)\n"
        "bad = sorted(k for k, v in sys.modules.items() if v is not None and k.split('.')[0] in "
        "('jax', 'jaxlib', 'hdrtv_tpu'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
