"""Media probing: HDR-input detection, active-picture (letterbox) detection
(the port's copy of ``hdrtv_tpu/runtime/probe.py``).

The reference probes sources with ffprobe (gui_media_probe.py:178: reject or
bypass HDR input; :377-633: active-picture detection feeding the stable GT
crop). Without ffprobe on PATH, HDR detection falls back to
container/bit-depth heuristics via cv2, with the ffprobe field contract kept
for when it exists.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess

import numpy as np


@dataclasses.dataclass
class MediaInfo:
    width: int
    height: int
    fps: float
    frame_count: int
    is_hdr: bool
    color_transfer: str = ""
    color_primaries: str = ""
    pix_fmt: str = ""


_HDR_TRANSFERS = {"smpte2084", "arib-std-b67"}
_HDR_PRIMARIES = {"bt2020"}


def probe_media(path: str) -> MediaInfo:
    """ffprobe when available (authoritative), cv2 fallback otherwise.

    ``.y4m`` masters are parsed natively (bench/y4m.py) — Y4M headers cannot
    carry transfer/primaries tags, so the export path's ``<path>.json`` color
    sidecar (pipeline/export.py _y4m_sidecar) is consulted for HDR detection;
    ffprobe would report them untagged too."""
    if path.lower().endswith(".y4m"):
        try:
            from hdrtv_tpu_torch.bench.y4m import probe_y4m

            pv = probe_y4m(path)
            transfer = primaries = ""
            try:
                with open(path + ".json") as f:
                    color = json.load(f).get("color", {})
                transfer = str(color.get("transfer") or "")
                primaries = str(color.get("primaries") or "")
            except (OSError, ValueError, AttributeError):
                pass  # sidecar is optional: corrupt/absent degrades HDR detect
            return MediaInfo(
                width=pv["width"],
                height=pv["height"],
                fps=pv["fps"],
                frame_count=pv["frames"],
                is_hdr=transfer in _HDR_TRANSFERS or primaries in _HDR_PRIMARIES,
                color_transfer=transfer,
                color_primaries=primaries,
                pix_fmt=pv["pix_fmt"],
            )
        except (OSError, ValueError):
            pass  # unreadable/foreign y4m: fall through to ffprobe/cv2
    if shutil.which("ffprobe"):
        try:
            out = subprocess.run(
                [
                    "ffprobe", "-v", "quiet", "-select_streams", "v:0",
                    "-show_entries",
                    "stream=width,height,avg_frame_rate,nb_frames,color_transfer,color_primaries,pix_fmt",
                    "-of", "json", path,
                ],
                capture_output=True, check=True, timeout=15,
            )
            stream = json.loads(out.stdout)["streams"][0]
            num, _, den = (stream.get("avg_frame_rate") or "30/1").partition("/")
            fps = float(num) / max(1.0, float(den or 1))
            transfer = str(stream.get("color_transfer") or "")
            primaries = str(stream.get("color_primaries") or "")
            return MediaInfo(
                width=int(stream.get("width") or 0),
                height=int(stream.get("height") or 0),
                fps=fps,
                frame_count=int(stream.get("nb_frames") or 0),
                is_hdr=transfer in _HDR_TRANSFERS or primaries in _HDR_PRIMARIES,
                color_transfer=transfer,
                color_primaries=primaries,
                pix_fmt=str(stream.get("pix_fmt") or ""),
            )
        except (subprocess.SubprocessError, KeyError, ValueError, json.JSONDecodeError):
            pass

    import cv2

    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise IOError(f"cannot probe: {path}")
        info = MediaInfo(
            width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            fps=float(cap.get(cv2.CAP_PROP_FPS) or 30.0),
            frame_count=int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0),
            is_hdr=False,  # cv2 decodes to 8-bit; no transfer metadata
        )
        return info
    finally:
        cap.release()


def detect_active_picture(
    frames: list[np.ndarray], *, black_level_ratio: float = 0.02, min_signal_ratio: float = 0.01
) -> tuple[int, int, int, int]:
    """Stable letterbox crop over several frames: (top, bottom, left, right)
    bounds of the active picture (gui_media_probe.py:377-633 role).

    Uses the intersection-of-signal rule: a row/column is active if it has
    signal in ANY probe frame — the crop is the union of per-frame actives,
    so scene changes don't flicker the crop.
    """
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    row_active = np.zeros(h, bool)
    col_active = np.zeros(w, bool)
    for frame in frames:
        peak = 255.0 if frame.dtype == np.uint8 else float(frame.max() or 1.0)
        lum = frame.astype(np.float32).max(axis=2)
        mask = lum > peak * black_level_ratio
        row_active |= mask.mean(axis=1) > min_signal_ratio
        col_active |= mask.mean(axis=0) > min_signal_ratio
    if not row_active.any() or not col_active.any():
        return 0, h, 0, w
    top = int(np.argmax(row_active))
    bottom = h - int(np.argmax(row_active[::-1]))
    left = int(np.argmax(col_active))
    right = w - int(np.argmax(col_active[::-1]))
    return top, bottom, left, right


def should_bypass_processing(info: MediaInfo) -> bool:
    """HDR input → bypass the SDR→HDR model (HDR-input bypass path,
    gui_pipeline_worker frame_processing HDR-input handling)."""
    return bool(info.is_hdr)


def probe_audio_streams(path: str) -> list[dict]:
    """Detected audio streams with metadata — the track-selection source for
    audio attach (gui_media_probe.py:249-291 field contract: ordinal, index,
    language, title, codec, channels, default)."""
    if not shutil.which("ffprobe"):
        return []
    try:
        out = subprocess.run(
            [
                "ffprobe", "-v", "error", "-select_streams", "a",
                "-show_entries",
                "stream=index,codec_name,channels:stream_tags=language,title:stream_disposition=default",
                "-of", "json", path,
            ],
            capture_output=True, check=True, timeout=15,
        )
        streams = json.loads(out.stdout or "{}").get("streams") or []
    except (subprocess.SubprocessError, ValueError, json.JSONDecodeError):
        return []
    result = []
    for i, s in enumerate(streams):
        tags = s.get("tags") or {}
        disp = s.get("disposition") or {}
        try:
            channels = int(s.get("channels"))
        except (TypeError, ValueError):
            channels = None
        result.append(
            {
                "ordinal": i,
                "index": s.get("index", i),
                "language": str(tags.get("language") or "und").strip().lower(),
                "title": str(tags.get("title") or "").strip(),
                "codec": str(s.get("codec_name") or "audio").strip().lower(),
                "channels": channels,
                "default": bool(disp.get("default", 0)),
            }
        )
    return result


# GT timing-compat thresholds (gui_media_probe.py module constants).
_GT_EXACT_FRAME_TOLERANCE = 2
_GT_SYNC_TOLERANCE_S = 2.0
_FPS_TOLERANCE = 0.25
_DURATION_TOLERANCE_S = 0.25


def duration_delta_s(src: MediaInfo, gt: MediaInfo) -> float:
    """Best-effort |duration difference| from duration or frame counts
    (gui_media_probe.py:81-100 `_metadata_duration_delta_s`)."""
    src_d = src.frame_count / src.fps if src.frame_count > 0 and src.fps > 0 else 0.0
    gt_d = gt.frame_count / gt.fps if gt.frame_count > 0 and gt.fps > 0 else 0.0
    if src_d > 0 and gt_d > 0:
        return abs(src_d - gt_d)
    if src.frame_count > 0 and gt.frame_count > 0:
        fps = src.fps if src.fps > 0 else gt.fps
        if fps > 0:
            return abs(src.frame_count - gt.frame_count) / fps
    return 0.0


def validate_timing_compatibility(
    src: MediaInfo | None,
    gt: MediaInfo | None,
    *,
    source_label: str = "source",
    gt_label: str = "GT",
    enforce_sync_tolerance: bool = True,
) -> tuple[bool, str | None, list[str]]:
    """SDR/GT pair timing-compat gate (gui_media_probe.py:103-176 semantics):

    - FPS must match within 0.25.
    - Frame counts within 2 frames, else duration delta within the sync
      tolerance (2 s) → note "overlap sync"; beyond it, fail — or, with
      ``enforce_sync_tolerance=False``, note "content sync" and proceed
      (the content-similarity search takes over).
    Returns (ok, error, notes).
    """
    if src is None or gt is None:
        return False, "Could not read video metadata.", []
    if src.fps > 0 and gt.fps > 0 and abs(src.fps - gt.fps) > _FPS_TOLERANCE:
        return False, f"FPS mismatch: {source_label} {src.fps:.3f} vs {gt_label} {gt.fps:.3f}.", []

    notes: list[str] = []
    from hdrtv_tpu_torch.utils.env import env_float

    sync_tol_s = env_float("HDRTVNET_GT_SYNC_TOLERANCE_S", _GT_SYNC_TOLERANCE_S)
    delta = duration_delta_s(src, gt)
    if (
        src.frame_count > 0
        and gt.frame_count > 0
        and abs(src.frame_count - gt.frame_count) > _GT_EXACT_FRAME_TOLERANCE
    ):
        if delta <= 0.0 or delta > sync_tol_s:
            if not enforce_sync_tolerance and delta > 0.0:
                notes.append(f"length differs by {delta:.2f}s; using content sync")
            elif not enforce_sync_tolerance:
                notes.append(
                    f"frame count differs ({source_label} {src.frame_count} vs "
                    f"{gt_label} {gt.frame_count}); using content sync"
                )
            else:
                return (
                    False,
                    f"Frame-count mismatch: {source_label} {src.frame_count} vs "
                    f"{gt_label} {gt.frame_count}.",
                    [],
                )
        else:
            notes.append(f"length differs by {delta:.2f}s; using overlap sync")

    src_d = src.frame_count / src.fps if src.frame_count > 0 and src.fps > 0 else 0.0
    gt_d = gt.frame_count / gt.fps if gt.frame_count > 0 and gt.fps > 0 else 0.0
    if src_d > 0 and gt_d > 0 and abs(src_d - gt_d) > _DURATION_TOLERANCE_S:
        if delta > sync_tol_s:
            if enforce_sync_tolerance:
                return (
                    False,
                    f"Duration mismatch: {source_label} {src_d:.2f}s vs {gt_label} {gt_d:.2f}s.",
                    [],
                )
            note = f"length differs by {delta:.2f}s; using content sync"
        else:
            note = f"length differs by {delta:.2f}s; using overlap sync"
        if note not in notes:
            notes.append(note)
    return True, None, notes
