"""HDR ground-truth pair validation — the GT validation worker (the port's
copy of ``hdrtv_tpu/bench/gt_validate.py``, host code).

The reference validates a user-selected HDR GT against the open SDR source
before enabling objective metrics (gui_ground_truth.py:36-158, run on a
worker thread with cancellation): the GT must be real HDR, timing-compatible
(gui_media_probe.py:103-176), aspect-compatible (with an active-picture
black-bar-crop rescue), and content-matched (sampled similarity ≥ 0.38),
reporting the sync offset as a note.

``validate_gt_pair`` reproduces that decision procedure headlessly, and
``GTValidationWorker`` wraps it in the cancelable-thread shape the GUI used.
"""

from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np

__all__ = ["GTValidationResult", "validate_gt_pair", "GTValidationWorker", "ValidationCanceled"]

_CONTENT_MATCH_MIN = 0.38  # gui_ground_truth.py:139 similarity floor
_ASPECT_TOLERANCE = 0.01
_ACTIVE_ASPECT_TOLERANCE = 0.04


class ValidationCanceled(RuntimeError):
    pass


@dataclasses.dataclass
class GTValidationResult:
    ok: bool
    message: str
    offset_frames: int = 0
    content_score: float = 0.0
    notes: tuple = ()


def _check_cancel(cancel_check) -> None:
    if callable(cancel_check) and cancel_check():
        raise ValidationCanceled()


def _sample_bgr_frames(path: str, count: int) -> list[np.ndarray]:
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            return []
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
        idxs = np.linspace(0, max(0, total - 1), count).astype(int) if total else range(count)
        out = []
        for i in idxs:
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
            okf, frame = cap.read()
            if okf:
                out.append(frame)
        return out
    finally:
        cap.release()


def validate_gt_pair(
    gt_path: str,
    source_path: str | None,
    *,
    cancel_check=None,
    require_hdr: bool = True,
    sample_count: int = 3,
) -> GTValidationResult:
    """Full GT pair validation (gui_ground_truth.py:36-158 decision order)."""
    from hdrtv_tpu_torch.bench.gt_sync import HDRGroundTruthReader, find_sync_offset, make_frame_map
    from hdrtv_tpu_torch.runtime.probe import (
        detect_active_picture,
        probe_media,
        validate_timing_compatibility,
    )

    if not gt_path or not os.path.isfile(gt_path):
        return GTValidationResult(False, "HDR GT file not found.")
    if not source_path or not os.path.isfile(source_path):
        return GTValidationResult(False, "Open the SDR input video first, then select HDR GT.")

    _check_cancel(cancel_check)
    gt_info = probe_media(gt_path)
    if require_hdr and not gt_info.is_hdr:
        return GTValidationResult(
            False, "HDR GT must be an actual HDR video (HDR metadata not detected)."
        )

    _check_cancel(cancel_check)
    src_info = probe_media(source_path)
    ok, err, notes = validate_timing_compatibility(
        src_info, gt_info, enforce_sync_tolerance=False
    )
    if not ok:
        return GTValidationResult(False, err or "Unable to read video metadata.")

    # Aspect gate with the active-picture rescue: mismatched container
    # aspects pass if the *active* pictures match after black-bar crop.
    if min(src_info.width, src_info.height, gt_info.width, gt_info.height) > 0:
        src_ar = src_info.width / src_info.height
        gt_ar = gt_info.width / gt_info.height
        if abs(src_ar - gt_ar) > _ASPECT_TOLERANCE:
            _check_cancel(cancel_check)
            src_frames = _sample_bgr_frames(source_path, 5)
            gt_frames = _sample_bgr_frames(gt_path, 5)
            if not src_frames or not gt_frames:
                return GTValidationResult(
                    False,
                    f"Aspect-ratio mismatch: source {src_info.width}x{src_info.height} "
                    f"vs GT {gt_info.width}x{gt_info.height}.",
                )
            st, sb, sl, sr = detect_active_picture(src_frames)
            gt_, gb, gl, gr = detect_active_picture(gt_frames)
            src_active_ar = (sr - sl) / max(1, sb - st)
            gt_active_ar = (gr - gl) / max(1, gb - gt_)
            if abs(src_active_ar - gt_active_ar) <= _ACTIVE_ASPECT_TOLERANCE:
                notes.append(
                    "active picture aspect matches after black-bar crop "
                    f"({sr - sl}x{sb - st} vs {gr - gl}x{gb - gt_})"
                )
            else:
                return GTValidationResult(
                    False,
                    f"Aspect-ratio mismatch: source {src_info.width}x{src_info.height} "
                    f"vs GT {gt_info.width}x{gt_info.height}.",
                )

    # Content-similarity + sync offset over sampled frames.
    _check_cancel(cancel_check)
    probe_bgr = _sample_bgr_frames(source_path, sample_count)
    if len(probe_bgr) < sample_count:
        return GTValidationResult(False, "Could not verify content match from sampled frames.")
    total = max(1, src_info.frame_count)
    probe_idx = np.linspace(0, max(0, total - 1), sample_count).astype(int)
    sdr_frames = {
        int(i): f[..., ::-1].astype(np.float32) / 255.0 for i, f in zip(probe_idx, probe_bgr)
    }
    reader = HDRGroundTruthReader(gt_path, exact=False)
    try:
        from hdrtv_tpu_torch.bench.gt_sync import file_token

        fmap = make_frame_map(src_info.fps or 30.0, reader.fps)
        # window defaults to ±HDRTVNET_GT_SYNC_OFFSET_SEARCH_S seconds.
        # The search is cached per (file signature pair, probe count) — the
        # reference's 'cached per file signature' sync behavior
        # (gui_objective_metrics.py:101-107 file-token role): repeated
        # benchmark sessions over the same pair skip the frame-decode sweep.
        offset, score = find_sync_offset(
            sdr_frames, reader, fmap,
            cache_path=os.path.join("logs", "gt_sync_cache.json"),
            cache_key=f"{file_token(source_path)}||{file_token(gt_path)}|n{sample_count}",
        )
    finally:
        reader.close()
    _check_cancel(cancel_check)
    if score < _CONTENT_MATCH_MIN:
        return GTValidationResult(
            False,
            "Content mismatch: GT does not look like the same video "
            f"(similarity {score:.2f}).",
            offset_frames=offset,
            content_score=score,
        )
    if offset:
        notes.append(f"GT sync offset {offset:+d} frames ({offset / max(1.0, reader.fps):+.3f}s)")
    suffix = "; " + "; ".join(notes) if notes else ""
    return GTValidationResult(
        True,
        f"Validated (same-content similarity {score:.2f}{suffix}).",
        offset_frames=offset,
        content_score=score,
        notes=tuple(notes),
    )


class GTValidationWorker:
    """Cancelable background validation (the QThread worker shape,
    gui_ground_truth.py:159-202): start() → result via ``join()`` or the
    ``on_done`` callback; ``cancel()`` aborts between probe steps."""

    def __init__(self, gt_path: str, source_path: str, *, require_hdr: bool = True, on_done=None):
        self.gt_path = gt_path
        self.source_path = source_path
        self.require_hdr = require_hdr
        self.on_done = on_done
        self.result: GTValidationResult | None = None
        self.canceled = False
        self._cancel = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="gt-validate")

    def start(self) -> "GTValidationWorker":
        self._thread.start()
        return self

    def cancel(self) -> None:
        self._cancel.set()

    def join(self, timeout: float | None = None) -> GTValidationResult | None:
        self._thread.join(timeout)
        return self.result

    def _run(self) -> None:
        try:
            self.result = validate_gt_pair(
                self.gt_path,
                self.source_path,
                cancel_check=self._cancel.is_set,
                require_hdr=self.require_hdr,
            )
        except ValidationCanceled:
            self.canceled = True
            self.result = GTValidationResult(False, "Validation canceled.")
        if self.on_done is not None:
            self.on_done(self.result)
