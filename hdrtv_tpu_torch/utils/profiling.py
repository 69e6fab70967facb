"""Profiling & observability: stage timers, torch.profiler traces, reports
(the port's copy of ``hdrtv_tpu/utils/profiling.py``).

The reference has no external profiler; it reports per-stage wall timing
(decode/resize/pre/infer/post/render with 1%-low, main.py:282-331) and CUDA
event latencies (SURVEY.md §5). Here: a StageTimers aggregator for the host
pipeline (as in the JAX package), and a torch.profiler trace of the CPU and
the card in place of the JAX package's jax.profiler capture.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class StageStats:
    mean_ms: float
    p50_ms: float
    p99_ms: float
    one_pct_low_ms: float
    count: int


class StageTimers:
    """Accumulates per-stage wall timings; reports the reference CLI format."""

    def __init__(self):
        self._samples: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)

    def add(self, name: str, ms: float) -> None:
        self._samples.setdefault(name, []).append(ms)

    def stats(self, name: str) -> StageStats | None:
        s = self._samples.get(name)
        if not s:
            return None
        arr = np.asarray(s)
        worst = np.sort(arr)[-max(1, len(arr) // 100):]
        return StageStats(
            mean_ms=float(arr.mean()),
            p50_ms=float(np.percentile(arr, 50)),
            p99_ms=float(np.percentile(arr, 99)),
            one_pct_low_ms=float(worst.mean()),
            count=len(arr),
        )

    def report(self) -> str:
        """Stage timing table (decode/resize/pre/run/post/render style)."""
        lines = [f"{'stage':<12} {'mean':>8} {'p50':>8} {'p99':>8} {'1%low':>8} {'n':>6}"]
        for name in self._samples:
            st = self.stats(name)
            lines.append(
                f"{name:<12} {st.mean_ms:8.2f} {st.p50_ms:8.2f} {st.p99_ms:8.2f} "
                f"{st.one_pct_low_ms:8.2f} {st.count:6d}"
            )
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {name: dataclasses.asdict(self.stats(name)) for name in self._samples}

    def timing_line(
        self, frames: int, fps: float, fps_1p_low: float,
        *, target_fps: float = 0.0, late_frames: int = 0,
    ) -> str:
        """One-line periodic `[timing]` report — the reference CLI's
        interval report format (main.py:282-331 build_timing_report)."""
        parts = [f"[timing] frames={frames}"]
        for name in self._samples:
            st = self.stats(name)
            if st is not None:
                parts.append(f"{name}={st.mean_ms:.2f}ms")
        parts.append(f"fps={fps:.2f}")
        parts.append(f"fps_1p_low={fps_1p_low:.2f}")
        if target_fps > 0 and frames > 0:
            late_pct = 100.0 * late_frames / frames
            parts.append(f"target={target_fps:.2f} late={late_frames}/{frames}({late_pct:.1f}%)")
        return " ".join(parts)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace of the host and, when there is one, the CUDA
    device: a Chrome trace (``trace.json``) written to ``log_dir`` when the
    block ends, the kernel and copy timeline for offline inspection (the
    engine-inspector role). Yields the profiler."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
