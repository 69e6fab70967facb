"""Video ingest: decode with prefetch thread and seek-safe generation queue
(the port's copy of ``hdrtv_tpu/pipeline/source.py``).

Semantics of the reference's video_source.py: a decode thread prefetches
frames into a bounded queue; every queued item carries a *generation* tag so
a seek can flush stale frames without racing the decoder (video_source.py:
21,130-162); exact seeking backtracks and decodes forward to the target
(:41-??). Also provides a synthetic pattern source for headless benchmarks
(the reference's synthetic TensorRT calibration source role,
hdrtvnet_torch.py:7981-8017).
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class VideoSource:
    """cv2-decoded video file with prefetch. ``read()`` returns BGR uint8 HWC
    or None at EOF; ``read_with_meta()`` adds (frame_idx, pts_seconds)."""

    def __init__(self, path: str, prefetch: int = 4):
        import cv2

        self._cv2 = cv2
        self.path = path
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        self.fps = float(self.cap.get(cv2.CAP_PROP_FPS) or 0.0) or 30.0
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.frame_count = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)

        self._generation = 0
        self._next_idx = 0
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._seek_target: int | None = None
        self._seek_event = threading.Event()
        self._thread = threading.Thread(target=self._decode_loop, daemon=True, name="video-decode")
        self._thread.start()

    # -- decode thread --------------------------------------------------

    def _decode_loop(self):
        while not self._stop.is_set():
            with self._lock:
                if self._seek_target is not None:
                    target = self._seek_target
                    self._seek_target = None
                    gen = self._generation
                    # Exact seek: position then decode forward; cv2 set() lands
                    # on/before the keyframe, so grab until the target index.
                    self.cap.set(self._cv2.CAP_PROP_POS_FRAMES, max(0, target))
                    pos = int(self.cap.get(self._cv2.CAP_PROP_POS_FRAMES))
                    while pos < target and self.cap.grab():
                        pos += 1
                    self._next_idx = target
                    self._drain()
                    self._seek_event.set()
                gen = self._generation
                idx = self._next_idx
            ok, frame = self.cap.read()
            if not ok:
                try:
                    self._queue.put((gen, None, idx, None), timeout=0.1)
                except queue.Full:
                    pass
                # EOF: idle until seek or stop.
                self._seek_event.clear()
                while not self._stop.is_set():
                    with self._lock:
                        if self._seek_target is not None:
                            break
                    if self._seek_event.wait(0.05):
                        break
                continue
            pts = idx / self.fps
            with self._lock:
                self._next_idx = idx + 1
            while not self._stop.is_set():
                try:
                    self._queue.put((gen, frame, idx, pts), timeout=0.1)
                    break
                except queue.Full:
                    with self._lock:
                        if self._generation != gen or self._seek_target is not None:
                            break  # stale frame; drop

    def _drain(self):
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    # -- consumer API ----------------------------------------------------

    def read(self) -> np.ndarray | None:
        meta = self.read_with_meta()
        return meta[0] if meta else None

    def read_with_meta(self, timeout: float = 5.0):
        """(frame, idx, pts) of the current generation, or None at EOF."""
        deadline = timeout
        while True:
            try:
                gen, frame, idx, pts = self._queue.get(timeout=deadline)
            except queue.Empty:
                return None
            with self._lock:
                if gen != self._generation:
                    continue  # flushed by a seek
            if frame is None:
                return None
            return frame, idx, pts

    def seek(self, frame_idx: int) -> None:
        """Flush queued frames and resume decoding at frame_idx."""
        with self._lock:
            self._generation += 1
            self._seek_target = int(frame_idx)
            self._drain()
        self._seek_event.set()

    def close(self):
        self._stop.set()
        self._drain()
        self._thread.join(timeout=1.0)
        self.cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SyntheticSource:
    """Deterministic moving test pattern — headless benchmarking without media.

    Gradient + sweeping highlight bar; content varies per frame so realtime
    paths (catch-up, metrics) behave like real video.
    """

    def __init__(self, width: int = 1920, height: int = 1080, fps: float = 30.0, frames: int = 300):
        self.width, self.height, self.fps = width, height, fps
        self.frame_count = frames
        self._idx = 0
        # The JAX source builds each frame in float32 and scales it by 255;
        # every pixel is scaled on its own, so the u8 gradient is computed
        # once and the bar written as its u8 value: the same bytes, without
        # tens of ms of float work a 1080p frame that would pace playback.
        yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
        base = np.stack([xx / width, yy / height, (xx + yy) / (width + height)], axis=-1)
        self._base = (base * 255).astype(np.uint8)
        self._bar = np.uint8(np.float32(0.97) * 255)

    def read_with_meta(self, timeout: float = 0.0):
        if self._idx >= self.frame_count:
            return None
        i = self._idx
        self._idx += 1
        frame = self._base.copy()
        x0 = int((i * 23) % max(1, self.width - 200))
        frame[:, x0 : x0 + 200] = self._bar
        return frame, i, i / self.fps

    def read(self):
        meta = self.read_with_meta()
        return meta[0] if meta else None

    def seek(self, frame_idx: int):
        self._idx = int(frame_idx)

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
