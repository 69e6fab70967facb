"""Exact HDR frame I/O — gui_hdr_io.py:205-487 equivalent (the port's copy of
``hdrtv_tpu/bench/hdr_io.py``: host code, the same commands byte for byte).

Ground-truth HDR sources are 10-bit (PQ/BT.2020); decoding them through
OpenCV flattens to 8-bit and quietly quantizes every metric computed against
them. This module decodes frames *exactly* through FFmpeg:

- ``read_frames_exact``: one pass with ``select='eq(n,a)+eq(n,b)+…'``
  emitting rawvideo rgb48le — the reference's batched exact decode
  (gui_hdr_io.py:416-487).
- ``read_frame_fast``: fast input seek (``-ss`` before ``-i``) then decode
  forward with a *PTS guard*: ``showinfo`` lines on stderr are matched
  against the requested frame's timestamp so a keyframe-snapped seek can
  never silently return the wrong frame (gui_hdr_io.py:205-415).
- 16-bit TIFF/PNG writers for benchmark artifacts (gui_hdr_io.py:507-577).

When FFmpeg is absent callers fall back to the cv2 reader in
bench/gt_sync.py and record the degraded decode method in their session
metadata; a ``*.y4m`` ground truth decodes exactly without either.
"""

from __future__ import annotations

import re
import shutil
import subprocess

import numpy as np


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def probe_video(path: str) -> dict:
    """Width/height/fps/frames via ffprobe, falling back to cv2.

    ``*.y4m`` probes natively from the container header (bench/y4m.py) —
    no binary needed and exact frame counts from the fixed stride."""
    if path.lower().endswith(".y4m"):
        from hdrtv_tpu_torch.bench.y4m import probe_y4m

        return probe_y4m(path)
    if shutil.which("ffprobe"):
        out = subprocess.run(
            [
                "ffprobe", "-v", "error", "-select_streams", "v:0",
                "-show_entries", "stream=width,height,r_frame_rate,nb_frames",
                "-of", "csv=p=0", path,
            ],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
        w, h, rate, nb = (out.split(",") + ["", "", "", ""])[:4]
        # Audio-only / broken streams yield empty or "N/A" fields — fall
        # through to the cv2 probe instead of crashing on int().
        if w.isdigit() and h.isdigit():
            num, _, den = rate.partition("/")
            try:
                fps = float(num) / float(den or 1)
            except ValueError:
                fps = 30.0
            return {
                "width": int(w), "height": int(h), "fps": fps,
                "frames": int(nb) if nb.isdigit() else None,
            }
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        return {
            "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            "fps": float(cap.get(cv2.CAP_PROP_FPS) or 30.0),
            "frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0) or None,
        }
    finally:
        cap.release()


def build_exact_decode_cmd(path: str, indices: list[int]) -> list[str]:
    """FFmpeg command decoding exactly the given frame numbers as rgb48le.

    ``select=eq(n,a)+eq(n,b)`` + ``-vsync 0`` emits only the selected frames
    in index order — the batched exact path (gui_hdr_io.py:416)."""
    sel = "+".join(f"eq(n\\,{int(i)})" for i in sorted(set(indices)))
    return [
        "ffmpeg", "-v", "error", "-nostdin",
        "-i", path,
        "-vf", f"select='{sel}'",
        "-vsync", "0",
        "-frames:v", str(len(set(indices))),
        "-f", "rawvideo", "-pix_fmt", "rgb48le", "-",
    ]


def preview_dims(w: int, h: int, max_side: int = 160) -> tuple[int, int]:
    """Even preview dims fitting max_side (aspect preserved, never upscaled)."""
    s = min(1.0, max_side / max(1, max(w, h)))
    pw = max(2, int(round(w * s / 2)) * 2)
    ph = max(2, int(round(h * s / 2)) * 2)
    return pw, ph


def build_preview_decode_cmd(
    path: str, indices: list[int], pw: int, ph: int
) -> list[str]:
    """FFmpeg command decoding small rgb24 previews of exact frame numbers —
    the benchmark's candidate-scan decode (gui_benchmark.py:1310-1468: exact
    select + downscale so scanning a movie costs KB per probe, not full
    frames). Output size is fixed host-side so parsing is deterministic."""
    sel = "+".join(f"eq(n\\,{int(i)})" for i in sorted(set(indices)))
    return [
        "ffmpeg", "-v", "error", "-nostdin",
        "-i", path,
        "-vf", f"select='{sel}',scale={int(pw)}:{int(ph)}",
        "-vsync", "0",
        "-frames:v", str(len(set(indices))),
        "-f", "rawvideo", "-pix_fmt", "rgb24", "-",
    ]


def read_preview_frames(
    path: str, indices: list[int], *, max_side: int = 160, timeout: float = 600.0
) -> dict[int, np.ndarray]:
    """Small u8 RGB previews of exact frames (one FFmpeg pass per batch)."""
    from hdrtv_tpu_torch.utils.env import env_int

    info = probe_video(path)
    pw, ph = preview_dims(info["width"], info["height"], max_side)
    uniq = sorted(set(int(i) for i in indices))
    batch_max = env_int("HDRTVNET_HDR_EXACT_BATCH_MAX_FRAMES", 20, lo=1, hi=64)
    frame_bytes = pw * ph * 3
    out: dict[int, np.ndarray] = {}
    for b in range(0, len(uniq), batch_max):
        batch = uniq[b : b + batch_max]
        proc = subprocess.run(
            build_preview_decode_cmd(path, batch, pw, ph), capture_output=True, timeout=timeout
        )
        data = proc.stdout
        for k, idx in enumerate(batch):
            chunk = data[k * frame_bytes : (k + 1) * frame_bytes]
            if len(chunk) < frame_bytes:
                break
            out[idx] = np.frombuffer(chunk, np.uint8).reshape(ph, pw, 3).copy()
    return out


def build_fast_decode_cmd(path: str, frame_idx: int, fps: float, *, preroll: int = 8) -> list[str]:
    """Fast input seek ``preroll`` frames early, then decode forward with
    showinfo on stderr for PTS verification (gui_hdr_io.py:205-415)."""
    t0 = max(0.0, (frame_idx - preroll) / max(fps, 1e-6))
    return [
        "ffmpeg", "-v", "info", "-nostdin",
        "-ss", f"{t0:.6f}",
        "-i", path,
        "-vf", "showinfo",
        "-frames:v", str(2 * preroll + 2),
        "-f", "rawvideo", "-pix_fmt", "rgb48le", "-",
    ]


_SHOWINFO_RE = re.compile(r"n:\s*(\d+).*?pts_time:([0-9.]+)")


def parse_showinfo(stderr_text: str) -> list[tuple[int, float]]:
    """(output_index, pts_time) per decoded frame from showinfo stderr."""
    out = []
    for line in stderr_text.splitlines():
        if "showinfo" not in line:
            continue
        m = _SHOWINFO_RE.search(line)
        if m:
            out.append((int(m.group(1)), float(m.group(2))))
    return out


def match_pts_frame(infos: list[tuple[int, float]], target_time: float, fps: float) -> int | None:
    """Output index whose pts_time matches the target within the tolerance —
    the PTS guard that rejects keyframe-snapped misseeks. Tolerance is
    ``HDRTVNET_HDR_FAST_SEEK_PTS_TOL_FRAMES`` frame periods (default 0.60,
    gui_hdr_io.py:29-34)."""
    from hdrtv_tpu_torch.utils.env import env_float

    tol = env_float("HDRTVNET_HDR_FAST_SEEK_PTS_TOL_FRAMES", 0.60, lo=0.05) / max(fps, 1e-6)
    best, best_err = None, tol
    for n, pts in infos:
        err = abs(pts - target_time)
        if err <= best_err:
            best, best_err = n, err
    return best


def read_frames_exact(path: str, indices: list[int], *, timeout: float = 600.0) -> dict[int, np.ndarray]:
    """Decode exact frame numbers to u16 RGB arrays. Requests are split into
    batches of ``HDRTVNET_HDR_EXACT_BATCH_MAX_FRAMES`` (default 20, max 64)
    per FFmpeg pass to bound decoder memory (gui_hdr_io.py:36-41)."""
    from hdrtv_tpu_torch.utils.env import env_int

    info = probe_video(path)
    w, h = info["width"], info["height"]
    uniq = sorted(set(int(i) for i in indices))
    batch_max = env_int("HDRTVNET_HDR_EXACT_BATCH_MAX_FRAMES", 20, lo=1, hi=64)
    frame_bytes = w * h * 6
    out: dict[int, np.ndarray] = {}
    for b in range(0, len(uniq), batch_max):
        batch = uniq[b : b + batch_max]
        proc = subprocess.run(
            build_exact_decode_cmd(path, batch), capture_output=True, timeout=timeout
        )
        data = proc.stdout
        for k, idx in enumerate(batch):
            chunk = data[k * frame_bytes : (k + 1) * frame_bytes]
            if len(chunk) < frame_bytes:
                break
            out[idx] = np.frombuffer(chunk, np.uint16).reshape(h, w, 3).copy()
    return out


def read_frame_fast(path: str, frame_idx: int, *, timeout: float = 120.0) -> np.ndarray | None:
    """Fast-seek decode of one frame with PTS verification; None if the
    guard cannot confirm the requested frame (or fast seeking is disabled
    via ``HDRTVNET_HDR_FAST_SEEK=0`` — callers then fall back to the exact
    batched decode, gui_hdr_io.py:22-24)."""
    from hdrtv_tpu_torch.utils.env import env_bool

    if not env_bool("HDRTVNET_HDR_FAST_SEEK", True):
        return None
    info = probe_video(path)
    w, h, fps = info["width"], info["height"], info["fps"]
    proc = subprocess.run(
        build_fast_decode_cmd(path, frame_idx, fps), capture_output=True, timeout=timeout
    )
    infos = parse_showinfo(proc.stderr.decode(errors="replace"))
    # Both guard names accepted: the reference keeps separate HDR/SDR knobs
    # (gui_hdr_io.py:25-28; the SDR variant mirrors it for the GT-sync path)
    if env_bool("HDRTVNET_HDR_FAST_SEEK_PTS_GUARD", True) and env_bool(
        "HDRTVNET_SDR_FRAME_FAST_SEEK_PTS_GUARD", True
    ):
        pick = match_pts_frame(infos, frame_idx / max(fps, 1e-6), fps)
    else:  # guard off: trust the seek, take the first decoded frame
        pick = 0 if infos or proc.stdout else None
    if pick is None:
        return None
    frame_bytes = w * h * 6
    chunk = proc.stdout[pick * frame_bytes : (pick + 1) * frame_bytes]
    if len(chunk) < frame_bytes:
        return None
    return np.frombuffer(chunk, np.uint16).reshape(h, w, 3).copy()


# ---------------------------------------------------------------------------
# 16-bit artifact writers (gui_hdr_io.py:507-577)
# ---------------------------------------------------------------------------


def write_tiff16(path: str, rgb_u16: np.ndarray) -> None:
    import cv2

    cv2.imwrite(path, rgb_u16[..., ::-1])  # cv2 writes BGR order


def write_png16(path: str, rgb_u16: np.ndarray) -> None:
    import cv2

    cv2.imwrite(path, rgb_u16[..., ::-1])


def write_png8(path: str, rgb_u8: np.ndarray) -> None:
    import cv2

    cv2.imwrite(path, rgb_u8[..., ::-1])


def float01_to_u16(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, 0.0, 1.0) * 65535.0 + 0.5).astype(np.uint16)


def write_exr(path: str, rgb_f32: np.ndarray) -> bool:
    """float32 linear EXR (gui_hdr_io.py EXR writer role). OpenCV's OpenEXR
    codec is often compiled out or env-gated; returns False when unavailable
    so callers can fall back to write_tiff16."""
    import os

    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    import cv2

    try:
        return bool(cv2.imwrite(path, rgb_f32[..., ::-1].astype(np.float32)))
    except cv2.error:
        return False


def write_hdr_image(path: str, rgb01: np.ndarray) -> str:
    """Write an HDR artifact by extension (.exr float, .tiff/.png u16),
    falling back to 16-bit TIFF when EXR isn't supported. Returns the path
    actually written."""
    if path.lower().endswith(".exr"):
        if write_exr(path, np.asarray(rgb01, np.float32)):
            return path
        path = path[:-4] + ".tiff"
    write_tiff16(path, float01_to_u16(np.asarray(rgb01, np.float32)))
    return path
