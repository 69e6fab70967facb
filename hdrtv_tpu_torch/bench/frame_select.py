"""Benchmark frame QC — rejecting low-information frames before selection
(the port's copy of ``hdrtv_tpu/bench/frame_select.py``).

The reference's quality benchmark refuses to score frames that would make
the metric run meaningless: black/white transitions, flat cards, and
text-heavy logo/credit frames, plus whole head/tail regions of a movie
where credits live (gui_benchmark.py:746-1060). All thresholds carry the
reference's ``HDRTVNET_BENCHMARK_FRAME_QC_*`` env names and defaults
(gui_benchmark.py:305-347).

Everything here is host-side numpy/cv2 — the QC runs once per probe frame
during selection, never on the card's hot path.
"""

from __future__ import annotations

import numpy as np

from hdrtv_tpu_torch.utils.env import env_float


def _crop_active(frame_bgr: np.ndarray) -> np.ndarray:
    """Single-frame letterbox crop (the _crop_frame_to_active_area role)."""
    from hdrtv_tpu_torch.runtime.probe import detect_active_picture

    try:
        top, bottom, left, right = detect_active_picture([frame_bgr])
    except (ValueError, IndexError):
        return frame_bgr
    if bottom - top < 8 or right - left < 8:
        return frame_bgr
    return frame_bgr[top:bottom, left:right]


def _gray_small(frame_bgr: np.ndarray, max_side: int) -> np.ndarray:
    import cv2

    frame = frame_bgr
    h, w = frame.shape[:2]
    longest = max(h, w)
    if longest > max_side:
        s = max_side / float(longest)
        frame = cv2.resize(
            frame, (max(1, round(w * s)), max(1, round(h * s))), interpolation=cv2.INTER_AREA
        )
    if frame.ndim == 3:
        return cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    return frame


def looks_like_logo_or_credits(frame_bgr: np.ndarray) -> bool:
    """Text-heavy dark title/credit frame detector — no OCR, just structure
    (gui_benchmark.py:746-830 decision contract: dark credit card /
    text-heavy card / sparse logo card over brightness stats, saturation,
    small bright connected components, and edge density)."""
    import cv2

    if not isinstance(frame_bgr, np.ndarray) or frame_bgr.ndim < 2 or frame_bgr.size == 0:
        return False
    frame = _crop_active(frame_bgr)
    if frame.size == 0:
        return False
    if frame.ndim == 2:
        frame = cv2.cvtColor(frame, cv2.COLOR_GRAY2BGR)
    gray = _gray_small(frame, 360)
    g = gray.astype(np.float32)
    hsv = cv2.cvtColor(
        cv2.resize(frame, gray.shape[::-1], interpolation=cv2.INTER_AREA)
        if frame.shape[:2] != gray.shape else frame,
        cv2.COLOR_BGR2HSV,
    )
    sat_mean = float(hsv[:, :, 1].astype(np.float32).mean()) / 255.0
    mean, p50 = float(g.mean()), float(np.percentile(g, 50))
    p95, p99 = float(np.percentile(g, 95)), float(np.percentile(g, 99))
    dark_ratio = float((g < 40.0).mean())
    bright_ratio = float((g > 172.0).mean())
    if p99 < 155.0 or bright_ratio < 0.002:
        return False  # nothing bright enough to be text on dark

    # count small bright blobs with text-plausible aspect ratios
    bright_mask = (gray > max(150.0, min(205.0, p95))).astype(np.uint8)
    n_labels, _lab, stats, _cent = cv2.connectedComponentsWithStats(bright_mask, 8)
    area_total = max(1, gray.shape[0] * gray.shape[1])
    text_blobs, text_area = 0, 0
    for i in range(1, int(n_labels)):
        x, y, bw, bh, area = stats[i]
        if area < 6 or area > area_total * 0.08:
            continue
        if 0.08 <= bw / max(1, bh) <= 18.0:
            text_blobs += 1
            text_area += int(area)
    edge_ratio = float((cv2.Canny(gray, 48, 128) > 0).mean())
    text_area_ratio = text_area / area_total

    dark_credit = (
        dark_ratio > 0.48 and p50 < 70.0 and sat_mean < 0.22
        and text_blobs >= 12 and text_area_ratio < 0.32 and edge_ratio > 0.012
    )
    text_heavy = (
        mean < 115.0 and sat_mean < 0.18 and text_blobs >= 24
        and 0.006 <= text_area_ratio <= 0.28 and edge_ratio > 0.018
    )
    sparse_logo = (
        dark_ratio > 0.62 and mean < 55.0 and p50 < 28.0 and sat_mean < 0.12
        and p99 > 190.0 and 0.003 <= bright_ratio <= 0.18
        and 4 <= text_blobs <= 28 and text_area_ratio < 0.20 and edge_ratio < 0.08
    )
    return bool(dark_credit or text_heavy or sparse_logo)


def frame_qc(frame_bgr: np.ndarray | None) -> tuple[bool, str]:
    """(passes, reason) — too_dark / too_bright / flat / logo_or_credits
    gates with the reference thresholds (gui_benchmark.py:831-919)."""
    import cv2

    if not isinstance(frame_bgr, np.ndarray) or frame_bgr.ndim < 2 or frame_bgr.size == 0:
        return False, "unreadable"
    frame = _crop_active(frame_bgr)
    if frame.size == 0:
        return False, "empty"
    gray = frame if frame.ndim == 2 else cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    g = gray.astype(np.float32)
    mean, std = float(g.mean()), float(g.std())
    p05, p95 = float(np.percentile(g, 5)), float(np.percentile(g, 95))
    dark_ratio = float((g <= 8.0).mean())
    bright_ratio = float((g >= 247.0).mean())

    if (
        mean < env_float("HDRTVNET_BENCHMARK_FRAME_QC_MIN_MEAN", 8.0)
        or p95 < env_float("HDRTVNET_BENCHMARK_FRAME_QC_MIN_P95", 22.0)
        or dark_ratio > env_float("HDRTVNET_BENCHMARK_FRAME_QC_MAX_DARK_RATIO", 0.80)
    ):
        return False, "too_dark"
    if (
        mean > env_float("HDRTVNET_BENCHMARK_FRAME_QC_MAX_MEAN", 242.0)
        or p05 > env_float("HDRTVNET_BENCHMARK_FRAME_QC_MAX_P05", 232.0)
        or bright_ratio > env_float("HDRTVNET_BENCHMARK_FRAME_QC_MAX_BRIGHT_RATIO", 0.75)
    ):
        return False, "too_bright"
    if std < env_float("HDRTVNET_BENCHMARK_FRAME_QC_MIN_STD", 3.0):
        return False, "flat"
    if looks_like_logo_or_credits(frame_bgr):
        return False, "logo_or_credits"
    return True, "ok"


def movie_frame_bounds(total_frames: int, fps: float | None = None) -> tuple[int, int]:
    """Inclusive frame bounds after skipping likely logo/credit regions
    (gui_benchmark.py:1006-1034): head/tail skip is the max of a ratio of
    the runtime and a seconds-based window, capped by MAX_*_SKIP_RATIO; the
    whole policy only engages for sources longer than SKIP_MIN_FRAMES."""
    total = max(0, int(total_frames or 0))
    min_frames = int(max(0.0, env_float("HDRTVNET_BENCHMARK_FRAME_QC_SKIP_MIN_FRAMES", 6000.0)))
    if total <= 1 or total < min_frames:
        return 0, max(0, total - 1)
    fps_f = float(fps or 0.0)
    if not np.isfinite(fps_f) or fps_f <= 0.0:
        fps_f = 0.0
    head = max(
        round(total * max(0.0, env_float("HDRTVNET_BENCHMARK_FRAME_QC_SKIP_HEAD_RATIO", 0.025))),
        round(fps_f * max(0.0, env_float("HDRTVNET_BENCHMARK_FRAME_QC_SKIP_HEAD_SECONDS", 120.0))),
    )
    tail = max(
        round(total * max(0.0, env_float("HDRTVNET_BENCHMARK_FRAME_QC_SKIP_TAIL_RATIO", 0.08))),
        round(fps_f * max(0.0, env_float("HDRTVNET_BENCHMARK_FRAME_QC_SKIP_TAIL_SECONDS", 600.0))),
    )
    head_cap = round(total * max(0.0, env_float("HDRTVNET_BENCHMARK_FRAME_QC_MAX_HEAD_SKIP_RATIO", 0.08)))
    tail_cap = round(total * max(0.0, env_float("HDRTVNET_BENCHMARK_FRAME_QC_MAX_TAIL_SKIP_RATIO", 0.18)))
    if head_cap > 0:
        head = min(head, head_cap)
    if tail_cap > 0:
        tail = min(tail, tail_cap)
    if head + tail >= total - 2:
        return 0, max(0, total - 1)
    return max(0, int(head)), max(0, total - int(tail) - 1)


def visual_interest(frame_bgr: np.ndarray) -> float:
    """Deterministic iconic-frame proxy: contrast + texture + exposure +
    saturation + edge density (gui_benchmark.py:920-1004 role). Downscaled
    to HDRTVNET_BENCHMARK_FRAME_INTEREST_MAX_SIDE (default 320) first."""
    import cv2

    if not isinstance(frame_bgr, np.ndarray) or frame_bgr.ndim < 2 or frame_bgr.size == 0:
        return 0.0
    frame = _crop_active(frame_bgr)
    if frame.size == 0:
        return 0.0
    if frame.ndim == 2:
        frame = cv2.cvtColor(frame, cv2.COLOR_GRAY2BGR)
    max_side = int(max(96, min(640, env_float("HDRTVNET_BENCHMARK_FRAME_INTEREST_MAX_SIDE", 320.0))))
    h, w = frame.shape[:2]
    if max(h, w) > max_side:
        s = max_side / float(max(h, w))
        frame = cv2.resize(frame, (max(1, round(w * s)), max(1, round(h * s))),
                           interpolation=cv2.INTER_AREA)
    gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    g = gray.astype(np.float32)
    mean, std = float(g.mean()), float(g.std())
    p05, p95 = float(np.percentile(g, 5)), float(np.percentile(g, 95))
    contrast = float(np.clip((p95 - p05) / 128.0, 0.0, 1.35))
    texture = float(np.clip(std / 64.0, 0.0, 1.35))
    exposure = float(np.clip(1.0 - abs(mean - 116.0) / 116.0, 0.0, 1.0))
    sat = cv2.cvtColor(frame, cv2.COLOR_BGR2HSV)[:, :, 1].astype(np.float32) / 255.0
    sat_score = float(np.clip(
        0.55 * (float(sat.mean()) / 0.32) + 0.45 * (float(np.percentile(sat, 90)) / 0.62),
        0.0, 1.35,
    ))
    edge_ratio = float((cv2.Canny(gray, 56, 144) > 0).mean())
    edges = float(np.clip(edge_ratio / 0.075, 0.0, 1.45))
    if edge_ratio > 0.30:  # noise-like over-edged frames score down
        edges *= float(np.clip((0.42 - edge_ratio) / 0.12, 0.25, 1.0))
    return contrast + texture + exposure + sat_score + edges
