"""HDR ground-truth access and SDR↔GT alignment (the port's copy of
``hdrtv_tpu/bench/gt_sync.py``, host code).

The reference's GT machinery (gui_media_probe.py, gui_hdr_io.py,
gui_hdr_gt_fast_path.py):

- frame-rate-aware SDR↔GT frame mapping (gui_media_probe.py:1137);
- a content-similarity sync-offset search over a ±2 s window with a minimum
  gain threshold, cached per file signature (:809-1121);
- exact HDR frame decode with PTS verification (gui_hdr_io.py:205-487).

Here: ``HDRGroundTruthReader`` decodes GT frames exactly via ffmpeg rgb48le
when present, natively at full bit depth for ``*.y4m`` sources (bench/y4m.py
— the binary-free 10-bit path), and via cv2 otherwise (which flattens
10-bit sources to 8); ``make_frame_map`` handles fps ratios, and ``find_sync_offset``
implements the alignment search on downsampled luminance with the reference's
min-gain acceptance rule.
"""

from __future__ import annotations

import json
import os

import numpy as np

_SYNC_CACHE_MAX = 64  # disk sync-offset cache entries (FIFO-trimmed)


class HDRGroundTruthReader:
    """Random-access GT frame reader returning [0,1] RGB float frames.

    With FFmpeg present, frames decode *exactly* as rgb48le (u16 precision,
    gui_hdr_io.py:205-487 via bench/hdr_io.py); otherwise cv2 decodes —
    which flattens 10-bit sources to 8-bit — and ``decode_method`` records
    the degradation so benchmark sessions are honest about GT precision.
    """

    def __init__(self, path: str, *, exact: bool | None = None):
        from hdrtv_tpu_torch.bench import hdr_io

        self._hdr_io = hdr_io
        self.path = path
        self._y4m = None
        if path.lower().endswith(".y4m"):
            # Binary-free exact path: numpy random access at full container
            # bit depth (bench/y4m.py) — 10-bit GT stays 10-bit where the
            # reference's ffmpeg rgb48le decode (gui_hdr_io.py:205-487) has
            # no binary to run and cv2 would flatten to 8-bit. It needs no
            # cv2 either (the JAX reader imports cv2 before this branch).
            from hdrtv_tpu_torch.bench import y4m

            self._y4m = y4m.Y4MReader(path)
            self.exact = True
            self.decode_method = f"y4m-native-exact-{self._y4m.fmt.bits}bit"
            self.fps = self._y4m.fps or 30.0
            self.frame_count = self._y4m.frame_count
            self.cap = None
            self._pos = 0
            self._exact_cache = {}
            return
        if exact is None:
            # GT decode mode: auto = exact when ffmpeg exists, else fast
            # (HDRTVNET_BENCHMARK_HDR_GT_MODE, gui_benchmark.py:175-180)
            from hdrtv_tpu_torch.utils.env import env_str

            mode = env_str("HDRTVNET_BENCHMARK_HDR_GT_MODE", "auto").strip().lower()
            if mode not in ("auto", "fast", "exact"):
                mode = "auto"
            if mode == "exact":
                exact = True
            elif mode == "fast":
                exact = False
            else:
                exact = hdr_io.ffmpeg_available()
        import cv2

        self._cv2 = cv2
        self.exact = exact
        self.decode_method = "ffmpeg-rgb48le-exact" if self.exact else "cv2-8bit"
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"cannot open GT video: {path}")
        self.fps = float(self.cap.get(cv2.CAP_PROP_FPS) or 0.0) or 30.0
        self.frame_count = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
        self._pos = 0
        self._exact_cache: dict[int, np.ndarray] = {}
        # decoded-frame cache caps: frame count AND megabytes, FIFO eviction
        # (HDRTVNET_BENCHMARK_POST_VERIFY_CACHE_MAX_FRAMES/_MAX_MB,
        # gui_benchmark.py:251-270; the SDR_FRAME_CACHE_MAX name is the
        # earlier-round alias and still honored)
        from hdrtv_tpu_torch.utils.env import env_bool, env_int

        self._cache_max = env_int(
            "HDRTVNET_BENCHMARK_POST_VERIFY_CACHE_MAX_FRAMES",
            env_int("HDRTVNET_SDR_FRAME_CACHE_MAX", 64, lo=1),
            lo=1,
        )
        self._cache_max_bytes = env_int(
            "HDRTVNET_BENCHMARK_POST_VERIFY_CACHE_MAX_MB", 768, lo=1
        ) * (1 << 20)
        self._fast_seek = env_bool("HDRTVNET_SDR_FRAME_FAST_SEEK", True)

    def _cache_put(self, items: dict[int, np.ndarray]) -> None:
        self._exact_cache.update(items)
        while len(self._exact_cache) > self._cache_max or (
            len(self._exact_cache) > 1
            and sum(v.nbytes for v in self._exact_cache.values()) > self._cache_max_bytes
        ):
            self._exact_cache.pop(next(iter(self._exact_cache)))

    def prefetch_exact(self, indices) -> None:
        """Batched exact decode of upcoming frames (one FFmpeg pass —
        gui_hdr_io.py:416 select=eq(n,..) batching)."""
        if self._y4m is not None or not self.exact:
            return  # y4m reads are O(1) — nothing to batch
        missing = [i for i in indices if i >= 0 and i not in self._exact_cache]
        if missing:
            self._cache_put(self._hdr_io.read_frames_exact(self.path, missing))

    def read_unit_rgb(self, frame_idx: int) -> np.ndarray | None:
        if self._y4m is not None:
            try:
                return self._y4m.read_rgb_unit(frame_idx)
            except (IndexError, ValueError):
                return None
        if self.exact:
            if frame_idx not in self._exact_cache:
                if self._fast_seek:
                    # single-miss fast path: seek-near + PTS-guarded pick
                    # (gui_hdr_gt_fast_path.py role; exact pass on fallback)
                    fast = self._hdr_io.read_frame_fast(self.path, frame_idx)
                    if fast is not None:
                        self._cache_put({frame_idx: fast})
                if frame_idx not in self._exact_cache:
                    self.prefetch_exact([frame_idx])
            u16 = self._exact_cache.get(frame_idx)
            if u16 is not None:
                return u16.astype(np.float32) / 65535.0
            return None
        return self.read_unit_rgb_fast(frame_idx)

    def read_unit_rgb_fast(self, frame_idx: int) -> np.ndarray | None:
        """cv2 decode regardless of the exact mode — the benchmark's fast
        first-pass read whose output post-verify compares against the exact
        decode (gui_benchmark.py fast/strict GT split)."""
        if self._y4m is not None:
            return self.read_unit_rgb(frame_idx)
        cv2 = self._cv2
        if frame_idx != self._pos:
            self.cap.set(cv2.CAP_PROP_POS_FRAMES, frame_idx)
        ok, frame = self.cap.read()
        if not ok:
            # The capture position moved (failed seek+read) but no frame was
            # produced — invalidate the sequential-read cursor so the next
            # request re-seeks instead of decoding whatever frame the capture
            # happens to sit on.
            self._pos = -1
            return None
        self._pos = frame_idx + 1
        peak = 65535.0 if frame.dtype == np.uint16 else 255.0
        return frame[..., ::-1].astype(np.float32) / peak

    def close(self):
        if self._y4m is not None:
            self._y4m.close()
            return
        self.cap.release()


def make_frame_map(sdr_fps: float, gt_fps: float, offset_frames: int = 0):
    """SDR frame index → GT frame index (rate-aware + sync offset)."""
    ratio = gt_fps / max(1e-6, sdr_fps)

    def fmap(sdr_idx: int) -> int:
        return max(0, int(round(sdr_idx * ratio)) + offset_frames)

    return fmap


def _signature(frame_rgb01: np.ndarray, side: int = 32) -> np.ndarray:
    """Tiny luminance signature for content similarity."""
    h, w = frame_rgb01.shape[:2]
    ys, xs = max(1, h // side), max(1, w // side)
    small = frame_rgb01[::ys, ::xs].mean(axis=-1)
    small = small[:side, :side]
    s = small - small.mean()
    n = np.linalg.norm(s)
    return s / n if n > 1e-8 else s


def find_sync_offset(
    sdr_frames: dict[int, np.ndarray],
    gt_reader,
    frame_map,
    *,
    window_frames: int | None = None,
    min_gain: float | None = None,
    cache_path: str | None = None,
    cache_key: str | None = None,
) -> tuple[int, float]:
    """Search a ±window offset maximizing mean content similarity.

    ``sdr_frames``: {sdr_idx: [0,1] RGB frame} probe set. Returns
    (offset_frames, score). The offset is accepted only if it beats offset 0
    by ``min_gain`` (the reference's min-gain 0.06 rule,
    gui_media_probe.py:809-1121); otherwise 0 is returned.

    Defaults come from the reference's env knobs:
    ``HDRTVNET_GT_SYNC_OFFSET_SEARCH_S`` (±seconds, × GT fps → frames) and
    ``HDRTVNET_GT_SYNC_OFFSET_MIN_GAIN``.
    """
    from hdrtv_tpu_torch.utils.env import env_float

    if window_frames is None:
        fps = float(getattr(gt_reader, "fps", 30.0) or 30.0)
        window_frames = max(1, int(round(env_float("HDRTVNET_GT_SYNC_OFFSET_SEARCH_S", 2.0) * fps)))
    if min_gain is None:
        min_gain = env_float("HDRTVNET_GT_SYNC_OFFSET_MIN_GAIN", 0.06)
    if cache_key is not None:
        # a narrow-window result must not be served to wider-window callers
        cache_key = f"{cache_key}|w{window_frames}|g{min_gain}"
    if cache_path and cache_key and os.path.isfile(cache_path):
        try:
            with open(cache_path) as f:
                cache = json.load(f)
            if cache_key in cache:
                e = cache[cache_key]
                return int(e["offset"]), float(e["score"])
        except (json.JSONDecodeError, KeyError, ValueError):
            pass

    sdr_sigs = {i: _signature(f) for i, f in sdr_frames.items()}

    def score_at(offset: int) -> float:
        scores = []
        for i, sig in sdr_sigs.items():
            gt_idx = frame_map(i) + offset
            gt = gt_reader.read_unit_rgb(gt_idx)
            if gt is None:
                continue
            scores.append(float(np.sum(sig * _signature(gt))))
        return float(np.mean(scores)) if scores else -1.0

    base = score_at(0)
    best_offset, best_score = 0, base
    for off in range(-window_frames, window_frames + 1):
        if off == 0:
            continue
        s = score_at(off)
        if s > best_score:
            best_offset, best_score = off, s

    if best_offset != 0 and best_score - base < min_gain:
        best_offset, best_score = 0, base

    # Persist only real measurements: the -1.0 "no GT frames decoded"
    # sentinel would turn a transient decode failure into a permanent
    # cached mismatch for this file pair. The write itself is best-effort
    # (read-only checkouts must not fail an otherwise-correct search).
    if cache_path and cache_key and best_score >= 0.0:
        try:
            cache = {}
            if os.path.isfile(cache_path):
                try:
                    with open(cache_path) as f:
                        cache = json.load(f)
                except json.JSONDecodeError:
                    cache = {}
            cache.pop(cache_key, None)
            cache[cache_key] = {"offset": best_offset, "score": best_score}
            while len(cache) > _SYNC_CACHE_MAX:  # FIFO: mtime-keyed entries
                cache.pop(next(iter(cache)))  # of re-exported files never hit
            os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
            with open(cache_path, "w") as f:
                json.dump(cache, f)
        except OSError:
            pass
    return best_offset, best_score


def file_token(path: str) -> str:
    """Cache key token: path + mtime + size (gui_objective_metrics.py:101-107)."""
    try:
        st = os.stat(path)
        return f"{os.path.abspath(path)}|{st.st_mtime_ns}|{st.st_size}"
    except OSError:
        return os.path.abspath(path)
