"""Live capture in hdrtv_tpu_torch on the CPU against hdrtv_tpu:
``pipeline/live.py`` (the rate split, ``LiveSource``, the synthetic grabber),
``pipeline/capture.py`` (window match scoring, the pixel conversions, the
grabber ladder) and the CLI's ``live`` as a whole.

The same seeded numpy inputs go through both packages. The grabber's frames
and the conversions must be equal bit for bit. The ``live`` CLI's written
frames (fp32, processed at 64 × 96 from the 640 × 360 capture) are the port's
processor's frames of the captures each was served from, bit for bit. The
port's letterbox of a capture parts from JAX's only on ties of the INTER_AREA
mean, by one code (the two fp32 sums round a k + 1/2 to either side); the
port's frame is within CODES, the tolerance of
``tests/test_torch_runtime.py``'s letterboxed cases, of
``HDRTVNetTPU.process_rgb48`` of the capture where the letterboxes agree,
and of the port's letterboxed capture where they part. Run as a script
(``python tests/test_torch_live.py``), it prints those partings' readings.
"""

import dataclasses
import os
import re
import threading

import numpy as np
import pytest
import torch

from hdrtv_tpu.pipeline import capture as jax_capture
from hdrtv_tpu.pipeline import live as jax_live
from hdrtv_tpu_torch.pipeline import capture, live

ROOT = os.path.join(os.path.dirname(__file__), "..")
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
CODES = 4
H, W = 64, 96
LETTERBOX_CAPTURES = 6  # captures held to JAX's letterbox, at least


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU programs on one intra-op thread: the suite runs in several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Window targets and match scoring
# ---------------------------------------------------------------------------

TITLES = ["Daredevil - Netflix", "daredevil  -  NETFLIX", "Netflix", "Editor", "", "Player", "play", "YouTube"]
CLASSES = ["", "firefox", "Firefox", "chromium"]


def _targets(mod, rng, n):
    return [mod.WindowTarget(title=TITLES[rng.randint(len(TITLES))], wid=int(rng.randint(0, 4)),
                             pid=int(rng.randint(0, 3)), wm_class=CLASSES[rng.randint(len(CLASSES))],
                             width=int(rng.choice([0, 640, 1920])), height=int(rng.choice([0, 360, 1080])))
            for _ in range(n)]


@pytest.mark.parametrize("seed", range(4))
def test_match_scoring_matches_jax(seed):
    """target_match_score on every pair of a seeded window list, and
    find_best_matching_target of each as the reference: the same scores and
    the same winner's index."""
    ours, theirs = _targets(capture, np.random.RandomState(seed), 12), _targets(
        jax_capture, np.random.RandomState(seed), 12)
    for a, ja in zip(ours, theirs):
        for b, jb in zip(ours, theirs):
            assert capture.target_match_score(a, b) == jax_capture.target_match_score(ja, jb)
        got = capture.find_best_matching_target(ours, a)
        want = jax_capture.find_best_matching_target(theirs, ja)
        assert (got is None) == (want is None)
        if got is not None:
            assert ours.index(got) == theirs.index(want)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert capture.target_match_score(None, ours[0]) == jax_capture.target_match_score(None, theirs[0]) == -1
    assert capture.find_best_matching_target(ours, None) is None
    assert capture.find_best_matching_target([], ours[0]) is None


# ---------------------------------------------------------------------------
# Pixel conversions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(4, 6), (37, 64), (360, 640)])
def test_pixel_conversions_match_jax(h, w):
    """bgra_to_bgr and yuyv_to_bgr on seeded buffers, as bytes and as
    arrays: bit-equal."""
    rng = np.random.RandomState(h * w)
    bgra = rng.randint(0, 256, size=(h, w, 4), dtype=np.uint8)
    yuyv = rng.randint(0, 256, size=(h, w * 2), dtype=np.uint8)
    for buf in (bgra, bgra.tobytes()):
        got, want = capture.bgra_to_bgr(buf, w, h), jax_capture.bgra_to_bgr(buf, w, h)
        assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want)
    for buf in (yuyv, yuyv.tobytes()):
        got, want = capture.yuyv_to_bgr(buf, w, h), jax_capture.yuyv_to_bgr(buf, w, h)
        assert got.shape == want.shape == (h, w, 3) and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# The synthetic grabber and the rate split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(64, 96), (360, 640), (1080, 1920), (40, 50)])
def test_synthetic_grabber_matches_jax(h, w):
    """The first 40 frames, bit for bit (the port paints the bar in u8 on a
    u8 gradient computed once; JAX scales a float32 frame each grab); each
    grab a fresh array."""
    ours, theirs = live.synthetic_grabber(w, h), jax_live.synthetic_grabber(w, h)
    prev = None
    for _ in range(40):
        got, want = ours(), theirs()
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (h, w, 3)
        assert np.array_equal(got, want)
        assert prev is None or not np.shares_memory(got, prev)
        prev = got


def test_synthetic_grabber_defaults_match_jax():
    got, want = live.synthetic_grabber()(), jax_live.synthetic_grabber()()
    assert got.shape == (360, 640, 3) and np.array_equal(got, want)


@pytest.mark.parametrize("env", [{}, {"HDRTVNET_LIVE_CAPTURE_OBSERVE_FPS": "200"},
                                 {"HDRTVNET_LIVE_CAPTURE_OBSERVE_FPS": "999"},
                                 {"HDRTVNET_LIVE_CAPTURE_DISPLAY_FPS": "12"},
                                 {"HDRTVNET_LIVE_CAPTURE_DISPLAY_FPS": "0.2",
                                  "HDRTVNET_LIVE_CAPTURE_OBSERVE_FPS": "junk"}],
                         ids=["defaults", "observe", "observe-clamped", "display", "display-clamped"])
def test_rate_split_matches_jax(env, monkeypatch):
    for k in ("HDRTVNET_LIVE_CAPTURE_OBSERVE_FPS", "HDRTVNET_LIVE_CAPTURE_DISPLAY_FPS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for fps in (None, 0, 0.5, 1, 24, 30, 59.94, 60, 120, 500):
        assert live.observe_fps_for(fps) == jax_live.observe_fps_for(fps)
        assert live.display_fps_for(fps) == jax_live.display_fps_for(fps)


def _scripted(frames, gate=None):
    """A grabber that hands out the given frames, then None (the target
    lost); ``gate`` (an Event) holds the loss back until it is set."""
    it = iter(frames)

    def grab():
        f = next(it, None)
        if f is None and gate is not None:
            gate.wait(5.0)
        return f

    return grab


@pytest.mark.parametrize("mod", [live, jax_live], ids=["port", "jax"])
def test_live_source_drop_to_latest_and_stop(mod):
    """Both packages' LiveSource over the same scripted grabber: the rates,
    frame_count 0, seek a no-op; what it serves is the newest observation,
    served indices count up from 0 with pts = idx / fps; when the grabber
    returns None it serves None and stops."""
    frames = [np.full((2, 3, 3), i, np.uint8) for i in range(6)]
    gate = threading.Event()
    src = mod.LiveSource(_scripted(frames, gate), process_fps=30.0, observe_fps=240.0)
    try:
        assert src.frame_count == 0 and src.fps == 30.0 and src.display_fps == 30.0
        assert src.observe_fps == 240.0
        src.seek(3)
        import time

        deadline = time.monotonic() + 5.0
        while src.frames_observed < 6 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert src.frames_observed == 6
        served = [src.read_with_meta() for _ in range(3)]
        assert [m[1] for m in served] == [0, 1, 2]
        assert [m[2] for m in served] == [0.0, 1 / 30.0, 2 / 30.0]
        assert all(m[0] is frames[5] for m in served)  # drop-to-latest: the newest, as grabbed
        assert src.frames_served == 3
        gate.set()
        src._thread.join(5.0)  # the observe thread saw the loss and ended
        assert src.read_with_meta(timeout=5.0) is None and src.read() is None
    finally:
        src.close()


def test_live_source_timeout_without_frames():
    """Nothing observed within the timeout: None, nothing served."""
    gate = threading.Event()

    def grab():
        gate.wait(5.0)
        return None

    src = live.LiveSource(grab, process_fps=24.0)
    try:
        assert src.observe_fps == jax_live.observe_fps_for(24.0)
        assert src.read_with_meta(timeout=0.05) is None and src.frames_served == 0
    finally:
        gate.set()
        src.close()


# ---------------------------------------------------------------------------
# The grabber ladder
# ---------------------------------------------------------------------------


def _outcome(fn):
    try:
        g = fn()
    except Exception as exc:  # noqa: BLE001 - the type and message are the result
        return ("raises", type(exc).__name__, str(exc))
    frame = g()
    return ("grabber", getattr(g, "__qualname__", type(g).__qualname__), frame.shape, frame.tobytes())


@pytest.mark.parametrize("spec,kw", [
    ("auto", {}), (None, {}), ("synthetic", {}), ("synthetic", {"width": 96, "height": 64}),
    ("x11", {}), ("x11:Some Title", {}), ("v4l2:/dev/video99", {}), ("auto:/dev/video99", {}),
    ("webcam", {}), ("", {}),
], ids=lambda v: repr(v))
def test_make_grabber_matches_jax(spec, kw, monkeypatch):
    """DISPLAY unset: each spec resolves in both packages to the same kind
    of grabber (the synthetic one, whose first frame is equal) or the same
    exception; a v4l2 device that does not exist raises, an unknown spec
    raises ValueError."""
    monkeypatch.delenv("DISPLAY", raising=False)
    assert not os.path.exists("/dev/video99")
    got = _outcome(lambda: capture.make_grabber(spec, **kw))
    want = _outcome(lambda: jax_capture.make_grabber(spec, **kw))
    assert got == want
    if spec in ("v4l2:/dev/video99",):
        assert got[:2] == ("raises", "RuntimeError") and "does not exist" in got[2]
    if spec == "webcam":
        assert got[:2] == ("raises", "ValueError")


# ---------------------------------------------------------------------------
# The slice as a whole: the CLI's live on the CPU against HDRTVNetTPU
# ---------------------------------------------------------------------------


@pytest.fixture
def cpu_cli(monkeypatch, tmp_path):
    """The CLI on the CPU at 64 × 96 (the presets cut), prefs and the engine
    registry in tmp_path."""
    from hdrtv_tpu_torch import config

    monkeypatch.setenv("HDRTV_CLI_PLATFORM", "cpu")
    monkeypatch.setenv("HDRTVNET_PREFS_PATH", str(tmp_path / "prefs.json"))
    monkeypatch.setenv("HDRTVNET_ENGINE_CACHE_DIR", str(tmp_path / "engines"))
    monkeypatch.setenv("HDRTVNET_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("DISPLAY", raising=False)
    for key in ("540p", "1080p"):
        monkeypatch.setitem(config.RESOLUTION_SCALES, key, (W, H))
    return tmp_path


def test_live_cli_frames_match_jax(cpu_cli, capsys):
    """live --capture synthetic --display file, fp32 at 64 × 96, 4 frames
    at 10 fps: the summary line; each written frame is the port's own frame
    of one synthetic capture (bit for bit), held to the JAX package as the
    comment below says; the captures come in non-decreasing order."""
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch import cli
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    out = str(cpu_cli / "live.rgb48")
    n = 4
    assert cli.main(["live", "--capture", "synthetic", "--display", "file", "--output", out,
                     "--resolution", "540p", "--precision", "FP32", "--fps", "10", "--frames", str(n)]) == 0
    text = capsys.readouterr().out
    assert "capture synthetic: synthetic" in text
    summary = re.search(r"frames=(\d+) observed=(\d+) dropped=(\d+) fps=\S+ model=\S+ms "
                        r"audio_delay_target=(\d+)ms", text)
    assert summary, text
    frames, observed = int(summary.group(1)), int(summary.group(2))
    assert frames == n and observed >= 1
    got = np.fromfile(out, np.uint16)
    assert got.size % (H * W * 3) == 0
    got = got.reshape(-1, H, W, 3)
    assert 1 <= len(got) <= n
    proc = HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu", persistent_cache=False, proc_resolution=(W, H))
    grab = live.synthetic_grabber()
    captures = [grab() for _ in range(observed)]
    candidates = [proc.process_rgb48(c) for c in captures]
    served = []
    for f in got:
        idx = [i for i, c in enumerate(candidates) if np.array_equal(c, f)]
        assert idx, "a written frame is none of the observed captures' frames"
        served.append(idx[0])
    assert served == sorted(served)
    # The two letterboxes (INTER_AREA, 640 x 360 to 96 x 54 between bars) part only on
    # ties: where the exact area mean is k + 1/2, the port's fp32 sums and XLA's, taken in
    # other orders, land a few ulps to either side of it and round one u8 code apart
    # (ROADMAP Queue 3); the network moves such a flip by up to ~170 output codes. So over
    # the first captures (the written frames are the port's frames of such captures): each
    # parting is a tie and one code; where none parts, the port's frame is held to
    # HDRTVNetTPU.process_rgb48 of the capture (JAX's whole path: its letterbox and its
    # network) within CODES; where one does, to JAX's network on the port's letterbox.
    from hdrtv_tpu.ops.resize import letterbox_u8 as jax_letterbox_u8
    from hdrtv_tpu_torch.ops.resize import letterbox_plan, letterbox_u8

    jax_net = HDRTVNetTPU(WEIGHTS, precision="fp32", persistent_cache=False)
    jax_whole = HDRTVNetTPU(WEIGHTS, precision="fp32", persistent_cache=False, proc_resolution=(W, H))
    captures += [grab() for _ in range(LETTERBOX_CAPTURES - len(captures))]
    candidates += [proc.process_rgb48(c) for c in captures[len(candidates):]]
    whole = 0
    for i, (capture, mine) in enumerate(zip(captures, candidates)):
        nh, nw, top, left, _ = letterbox_plan(*capture.shape[:2], H, W)
        boxed = letterbox_u8(torch.from_numpy(capture), H, W).numpy()
        jax_boxed = np.asarray(jax_letterbox_u8(capture, H, W))
        d = boxed.astype(np.int64) - jax_boxed
        parted = d[top:top + nh, left:left + nw] != 0
        assert np.abs(d).max() <= 1 and not d[~_inside(top, left, nh, nw)].any()
        assert _area_ties(capture, nh, nw)[parted].all(), f"capture {i}: the letterboxes part off a tie"
        if parted.any():
            want = np.asarray(jax_net.process_rgb48(boxed))
        else:
            want, whole = np.asarray(jax_whole.process_rgb48(capture)), whole + 1
        assert want.shape == mine.shape
        assert np.abs(mine.astype(np.int64) - want).max() <= CODES, f"capture {i}"
    assert whole, "no capture held to JAX's whole path"


def _inside(top, left, nh, nw):
    """The letterbox's picture (not its bars) at the processing size."""
    mask = np.zeros((H, W, 3), bool)
    mask[top:top + nh, left:left + nw] = True
    return mask


def _area_mean(frame, nh, nw):
    """The exact INTER_AREA mean of ``frame`` to (nh, nw) as integers
    (num (nh, nw, 3), den): an output's box covers input j by
    ``min((i + 1) n, (j + 1) m) - max(i n, j m)`` m-ths of it, n inputs to
    m outputs, and each box's weights sum to n."""
    def weights(n, m):
        i, j = np.arange(m)[:, None], np.arange(n)[None, :]
        return np.clip(np.minimum((i + 1) * n, (j + 1) * m) - np.maximum(i * n, j * m), 0, None)

    h, w = frame.shape[:2]
    rows = np.einsum("oh,hwc->owc", weights(h, nh), frame.astype(np.int64))
    return np.einsum("pw,owc->opc", weights(w, nw), rows), h * w


def _area_ties(frame, nh, nw):
    """(nh, nw, 3): where the exact INTER_AREA mean is k + 1/2."""
    num, den = _area_mean(frame, nh, nw)
    return (2 * num) % (2 * den) == den


def test_live_cli_bad_v4l2_spec(cpu_cli, capsys):
    from hdrtv_tpu_torch import cli

    rc = cli.main(["live", "--capture", "v4l2:/dev/video99", "--display", "null", "--resolution", "540p",
                   "--frames", "1"])
    assert rc == 2 and "unavailable" in capsys.readouterr().out


def letterbox_readings(n: int = LETTERBOX_CAPTURES) -> None:
    """Print, for the first n synthetic captures cut to (W, H) as the live
    CLI test runs them: the ties of the INTER_AREA mean, the values where
    the two letterboxes part, the first such value's exact mean and the two
    packages' fp32 sums of it before rounding, and the port's fp32 frame
    against HDRTVNetTPU.process_rgb48 of the capture (max, mean codes).
    Run: ``python tests/test_torch_live.py`` from the repository's root."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from hdrtv_tpu.ops.resize import letterbox_rgb as jax_letterbox_rgb
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.ops.resize import letterbox_plan, letterbox_rgb
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    proc = HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu", persistent_cache=False, proc_resolution=(W, H))
    jax_whole = HDRTVNetTPU(WEIGHTS, precision="fp32", persistent_cache=False, proc_resolution=(W, H))
    grab = live.synthetic_grabber()
    for i in range(n):
        capture = grab()
        nh, nw, top, left, _ = letterbox_plan(*capture.shape[:2], H, W)
        mine = letterbox_rgb(torch.from_numpy(capture)[None].float(), H, W)[0].numpy()
        theirs = np.asarray(jax_letterbox_rgb(capture[None].astype(np.float32), H, W))[0]
        parted = np.round(mine) != np.round(theirs)
        ties = _area_ties(capture, nh, nw)
        line = {"capture": i, "ties": int(ties.sum()), "values": int(ties.size), "parted": int(parted.sum()),
                "parted_on_ties": bool(ties[parted[top:top + nh, left:left + nw]].all())}
        if parted.any():
            y, x, c = (int(v) for v in np.argwhere(parted)[0])
            num, den = _area_mean(capture, nh, nw)
            line["first"] = {"exact": float(num[y - top, x - left, c] / den), "port_fp32": float(mine[y, x, c]),
                             "jax_fp32": float(theirs[y, x, c])}
        d = np.abs(proc.process_rgb48(capture).astype(np.int64) - np.asarray(jax_whole.process_rgb48(capture)))
        line["frame_vs_jax"] = {"max_codes": int(d.max()), "mean_codes": round(float(d.mean()), 3)}
        print(line, flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)
    letterbox_readings()
