"""Live capture source — window/screen capture abstraction (the port's copy
of ``hdrtv_tpu/pipeline/live.py``).

The reference captures browser windows via WinRT Graphics Capture with an
*observe/process/display* FPS split: the compositor is polled faster than the
model budget so inference usually sees a recent frame, and the display feed
runs at a steady cadence with drop-to-latest (window_capture_source.py:1132,
gui_config.py:330-400).

This ports the rate architecture to a platform-neutral design: a
``FrameGrabber`` callable supplies frames (X11/v4l2/synthetic backends can
plug in), an observe thread polls it at observe-FPS into a latest-frame
slot, and ``read_with_meta`` serves the process-FPS loop with drop-to-latest
semantics. No Windows dependency anywhere.

Every frame a grabber returns is a fresh array that nothing writes after: the
runner's ``put_frame`` copies it into a pinned slot without a lock.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np

from hdrtv_tpu_torch.utils.env import env_float


def observe_fps_for(process_fps: float) -> float:
    """Poll the source moderately faster than the model budget
    (gui_config.py:344-352 policy, same env override)."""
    process_fps = max(1.0, float(process_fps or 24.0))
    return env_float("HDRTVNET_LIVE_CAPTURE_OBSERVE_FPS", max(process_fps, process_fps * 1.5), lo=1.0, hi=240.0)


def display_fps_for(process_fps: float) -> float:
    """Display cadence never exceeds the process rate (gui_config.py:355-363)."""
    process_fps = max(1.0, float(process_fps or 24.0))
    return min(process_fps, env_float("HDRTVNET_LIVE_CAPTURE_DISPLAY_FPS", process_fps, lo=1.0, hi=240.0))


class LiveSource:
    """Live source with observe/process FPS split and drop-to-latest.

    ``grabber() -> np.ndarray | None`` returns the newest frame (BGR uint8
    HWC) or None if the target is gone (triggers clean stop — the reference's
    capture-loss restart policy, README.md:333).
    """

    def __init__(
        self,
        grabber: Callable[[], np.ndarray | None],
        *,
        process_fps: float = 24.0,
        observe_fps: float | None = None,
        width: int | None = None,
        height: int | None = None,
    ):
        self.grabber = grabber
        self.fps = float(process_fps)
        self.observe_fps = observe_fps or observe_fps_for(process_fps)
        self.display_fps = display_fps_for(process_fps)
        self.width, self.height = width, height
        self.frame_count = 0  # unbounded

        self._latest: tuple[int, np.ndarray] | None = None
        self._latest_lock = threading.Lock()
        self._observed = 0
        self._served = 0
        self._lost = threading.Event()
        self._stop = threading.Event()
        self._new_frame = threading.Condition()
        self._thread = threading.Thread(target=self._observe_loop, daemon=True, name="live-observe")
        self._thread.start()

    def _observe_loop(self):
        interval = 1.0 / self.observe_fps
        next_t = time.monotonic()
        while not self._stop.is_set():
            frame = self.grabber()
            if frame is None:
                self._lost.set()
                with self._new_frame:
                    self._new_frame.notify_all()
                return
            self._observed += 1
            with self._latest_lock:
                self._latest = (self._observed, frame)
            with self._new_frame:
                self._new_frame.notify_all()
            next_t += interval
            delay = next_t - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            else:
                next_t = time.monotonic()

    def read_with_meta(self, timeout: float = 2.0):
        """Newest observed frame (drop-to-latest); None when the source is lost."""
        deadline = time.monotonic() + timeout
        while not self._lost.is_set():
            with self._latest_lock:
                latest = self._latest
            if latest is not None:
                self._served += 1
                idx = self._served - 1
                return latest[1], idx, idx / self.fps
            with self._new_frame:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._new_frame.wait(min(0.05, remaining))
        return None

    def read(self):
        meta = self.read_with_meta()
        return meta[0] if meta else None

    def seek(self, frame_idx: int):  # live sources cannot seek
        pass

    @property
    def frames_observed(self) -> int:
        return self._observed

    @property
    def frames_served(self) -> int:
        return self._served

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def synthetic_grabber(width: int = 640, height: int = 360):
    """Deterministic moving-pattern grabber for tests/headless runs.

    The JAX grabber builds each frame in float32 and scales it by 255; every
    pixel is scaled on its own, so the u8 gradient is computed once and the
    bar written as its u8 value: the same bytes, without a float copy,
    multiply and cast of the whole frame on every grab (25 MB at 1080p)."""
    state = {"i": 0}
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    base = np.stack([xx / width, yy / height, 0.5 * np.ones_like(xx)], axis=-1)
    base_u8 = (base * 255).astype(np.uint8)
    bar = np.uint8(np.float32(0.95) * 255)

    def grab():
        i = state["i"]
        state["i"] += 1
        frame = base_u8.copy()
        x0 = (i * 13) % max(1, width - 60)
        frame[:, x0 : x0 + 60] = bar
        return frame

    return grab
