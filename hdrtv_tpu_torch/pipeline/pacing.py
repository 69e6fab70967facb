"""Presentation pacing: monotonic high-res sleep + catch-up policy (the
port's copy of ``hdrtv_tpu/pipeline/pacing.py``).

The reference paces playback with a source-FPS presentation clock
``next_frame_t += 1/fps`` and a Windows waitable-timer ``sleep_until``
(gui_pipeline_worker.py:858-873, timer.py:92), skipping up to 6 frames when
more than 1.1 frame intervals behind (catch-up drops,
gui_pipeline_worker.py:899-936). This ports the *policy*, not the Windows
timer: coarse ``time.sleep`` to within 2 ms, then a short spin.
"""

from __future__ import annotations

import dataclasses
import time


def sleep_until(deadline: float, *, spin_threshold: float = 0.002) -> None:
    """Sleep until time.monotonic() >= deadline; coarse sleep then spin."""
    while True:
        now = time.monotonic()
        remaining = deadline - now
        if remaining <= 0:
            return
        if remaining > spin_threshold:
            time.sleep(remaining - spin_threshold)
        else:
            # Short spin for sub-ms accuracy (MMCSS/waitable-timer analog).
            while time.monotonic() < deadline:
                pass
            return


@dataclasses.dataclass
class PresentationClock:
    """Source-FPS clock with the reference catch-up skip policy."""

    fps: float
    lag_threshold_frames: float = 1.1
    max_skip: int = 6

    def __post_init__(self):
        self.interval = 1.0 / max(1e-6, self.fps)
        self.next_frame_t: float | None = None
        self.dropped = 0

    def start(self, now: float | None = None) -> None:
        self.next_frame_t = (now if now is not None else time.monotonic()) + self.interval

    def wait_for_slot(self) -> int:
        """Block until the next presentation slot; returns the number of
        source frames to SKIP to catch up (0 when on schedule)."""
        if self.next_frame_t is None:
            self.start()
            return 0
        sleep_until(self.next_frame_t)
        now = time.monotonic()
        lag = now - self.next_frame_t
        skip = 0
        if lag > self.lag_threshold_frames * self.interval:
            skip = min(self.max_skip, int(lag / self.interval))
            self.next_frame_t += skip * self.interval
            self.dropped += skip
        self.next_frame_t += self.interval
        return skip

    def reset(self) -> None:
        self.next_frame_t = None
