"""Dataset curation: hard-frame mining + teacher-pair generation (the port's
copy of ``hdrtv_tpu/data/curate.py``; numpy and cv2).

The reference's offline data tooling (SURVEY.md §2.7 dataset curation):

- ``mine_hdrtv1k_hard_frames.py`` ranks HDRTV1K SDR/HDR *image pairs* by a
  "hardness" score targeting bright/flat/clipped/saturated content (the
  failure modes of int8 highlight rolloff) and emits a replay manifest with
  rank-weighted repeat counts (scripts/models/mine_hdrtv1k_hard_frames.py:78-147).
- ``make_movie_teacher_pairs.py`` runs the FP32 teacher over movie frames and
  writes SDR PNG / teacher-output 16-bit PNG training pairs for Film QAT
  (scripts/models/make_movie_teacher_pairs.py).

Same scoring features and manifest roles, computed with numpy; the teacher
here is the port's processor (``HDRTVNetTorch``, whose ``process_rgb48``
runs the frame program on the CUDA card, or on the CPU where it was built
there).
"""

from __future__ import annotations

import csv
import json
import math
import os
from pathlib import Path

import numpy as np

__all__ = [
    "score_hard_pair",
    "repeat_for_rank",
    "mine_hard_frames",
    "make_teacher_pairs",
    "paired_image_paths",
]

_IMG_SUFFIXES = {".png", ".jpg", ".jpeg"}


def paired_image_paths(sdr_dir: str, hdr_dir: str) -> list[tuple[Path, Path]]:
    """SDR/HDR pairs matched by filename (stem fallback across extensions)."""
    sdr_dir, hdr_dir = Path(sdr_dir), Path(hdr_dir)
    pairs = []
    for sdr in sorted(p for p in sdr_dir.iterdir() if p.suffix.lower() in _IMG_SUFFIXES):
        hdr = hdr_dir / sdr.name
        if not hdr.is_file():
            matches = sorted(hdr_dir.glob(f"{sdr.stem}.*"))
            hdr = matches[0] if matches else hdr
        if hdr.is_file():
            pairs.append((sdr, hdr))
    if not pairs:
        raise FileNotFoundError(f"no SDR/HDR image pairs in {sdr_dir} + {hdr_dir}")
    return pairs


def _read_unit_rgb(path: Path, max_long_edge: int = 384) -> np.ndarray:
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    img = img[..., :3]
    h, w = img.shape[:2]
    if max_long_edge > 0 and max(h, w) > max_long_edge:
        s = max_long_edge / max(h, w)
        img = cv2.resize(img, (max(32, int(w * s)), max(32, int(h * s))), interpolation=cv2.INTER_AREA)
    peak = 65535.0 if img.dtype == np.uint16 else 255.0
    return img[..., ::-1].astype(np.float32) / peak  # BGR→RGB, [0,1]


def _luma(rgb: np.ndarray) -> np.ndarray:
    return 0.2627 * rgb[..., 0] + 0.678 * rgb[..., 1] + 0.0593 * rgb[..., 2]


def _grad_mag(y: np.ndarray) -> np.ndarray:
    gy, gx = np.gradient(y)
    return np.sqrt(gx * gx + gy * gy)


def _pct(mask: np.ndarray) -> float:
    return float(np.mean(mask))


def score_hard_pair(sdr_rgb01: np.ndarray, hdr_rgb01: np.ndarray) -> dict:
    """Hardness score for one SDR/HDR pair — the bright/flat/clipped/
    saturated feature mix of the reference miner
    (mine_hdrtv1k_hard_frames.py:78-136, same thresholds and weights)."""
    y, ys = _luma(hdr_rgb01), _luma(sdr_rgb01)
    grad = _grad_mag(y)
    maxc, minc = hdr_rgb01.max(axis=2), hdr_rgb01.min(axis=2)
    sat = maxc - minc

    bright = y >= 0.70
    very_bright = y >= 0.86
    clipped = maxc >= 0.975
    near_black = y <= 0.06
    flat = grad <= 0.035
    hard_edge = grad >= 0.20
    saturated = (sat >= 0.42) & (maxc >= 0.48)
    saturated_red = saturated & (hdr_rgb01[..., 0] >= maxc - 1e-5)
    saturated_blue = saturated & (hdr_rgb01[..., 2] >= maxc - 1e-5)
    source_bright = ys >= 0.70

    feats = {
        "flat_bright_pct": _pct(bright & flat),
        "very_bright_flat_pct": _pct(very_bright & flat),
        "clipped_pct": _pct(clipped),
        "saturated_pct": _pct(saturated),
        "saturated_red_blue_pct": _pct(saturated_red | saturated_blue),
        "bright_edge_pct": _pct(bright & hard_edge),
        "dark_bright_contrast": math.sqrt(max(_pct(near_black), 0.0) * max(_pct(very_bright), 0.0)),
        "source_target_bright_pct": _pct(source_bright & bright),
    }
    score = (
        230.0 * feats["flat_bright_pct"]
        + 320.0 * feats["very_bright_flat_pct"]
        + 180.0 * feats["clipped_pct"]
        + 105.0 * feats["saturated_pct"]
        + 90.0 * feats["saturated_red_blue_pct"]
        + 80.0 * feats["bright_edge_pct"]
        + 28.0 * feats["dark_bright_contrast"]
        + 30.0 * feats["source_target_bright_pct"]
    )
    return {
        "score": float(score),
        **feats,
        "mean_luma": float(np.mean(y)),
        "p95_luma": float(np.percentile(y, 95)),
    }


def repeat_for_rank(rank: int, total_hard: int, max_repeat: int = 4) -> int:
    """Replay weight by rank quantile: top 15% get max_repeat, next 25%
    max_repeat−1, the rest 2 (mine_hdrtv1k_hard_frames.py:138-147)."""
    if max_repeat <= 1 or total_hard <= 0:
        return 1
    q = rank / max(total_hard - 1, 1)
    if q < 0.15:
        return max_repeat
    if q < 0.40:
        return max(2, max_repeat - 1)
    return 2


def mine_hard_frames(
    sdr_dir: str,
    hdr_dir: str,
    out_root: str,
    *,
    top: int = 256,
    max_repeat: int = 4,
    max_long_edge: int = 384,
) -> dict:
    """Score all pairs, rank, write ``ranked.csv`` + ``manifest.json`` with
    repeat-weighted hard-frame replay entries. Returns the manifest."""
    rows = []
    for sdr_p, hdr_p in paired_image_paths(sdr_dir, hdr_dir):
        entry = score_hard_pair(
            _read_unit_rgb(sdr_p, max_long_edge), _read_unit_rgb(hdr_p, max_long_edge)
        )
        entry.update({"sdr": str(sdr_p), "hdr": str(hdr_p), "name": sdr_p.name})
        rows.append(entry)
    rows.sort(key=lambda r: -r["score"])
    hard = rows[:top]

    os.makedirs(out_root, exist_ok=True)
    csv_path = os.path.join(out_root, "ranked.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)

    replay = []
    for rank, row in enumerate(hard):
        replay.append({
            "sdr": row["sdr"], "hdr": row["hdr"], "name": row["name"],
            "score": row["score"], "rank": rank,
            "repeat": repeat_for_rank(rank, len(hard), max_repeat),
        })
    manifest = {
        "total_pairs": len(rows),
        "hard_count": len(hard),
        "max_repeat": max_repeat,
        "replay": replay,
        "csv": csv_path,
    }
    with open(os.path.join(out_root, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def make_teacher_pairs(
    video: str,
    processor,
    out_root: str,
    *,
    num_frames: int = 160,
    start_frame: int = 0,
    end_frame: int = 0,
    frames: list[int] | None = None,
    name_prefix: str = "",
    max_long_edge: int = 0,
) -> dict:
    """FP32-teacher pair generation: per selected movie frame, write
    ``<stem>_sdr.png`` (u8) and ``<stem>_teacher.png`` (16-bit, the teacher's
    [0,1] output × 65535 — the u16 BGR convention of
    make_movie_teacher_pairs.py:_tensor_to_bgr_u16). ``processor`` is an
    HDRTVNetTorch (or anything exposing ``process_rgb48(bgr_u8) -> u16 RGB``).
    """
    import cv2

    cap = cv2.VideoCapture(video)
    if not cap.isOpened():
        raise IOError(f"cannot open {video}")
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
        if frames is None:
            hi = total - 1 if end_frame <= 0 else min(total - 1, end_frame)
            lo = max(0, start_frame)
            sel = sorted({int(v) for v in np.linspace(lo, max(lo, hi), num=max(1, num_frames))})
        else:
            sel = sorted({int(f) for f in frames if 0 <= int(f) < max(total, 1 << 30)})
        os.makedirs(out_root, exist_ok=True)
        prefix = name_prefix or Path(video).stem
        written = []
        for idx in sel:
            cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
            ok, bgr = cap.read()
            if not ok:
                continue
            if max_long_edge > 0 and max(bgr.shape[:2]) > max_long_edge:
                s = max_long_edge / max(bgr.shape[:2])
                bgr = cv2.resize(
                    bgr, (int(bgr.shape[1] * s), int(bgr.shape[0] * s)), interpolation=cv2.INTER_AREA
                )
            # Even dims for the s2d fast path.
            bgr = bgr[: bgr.shape[0] // 2 * 2, : bgr.shape[1] // 2 * 2]
            out_u16_rgb = processor.process_rgb48(bgr)  # u16 RGB PQ code values
            stem = f"{prefix}_{idx:06d}"
            sdr_path = os.path.join(out_root, f"{stem}_sdr.png")
            teacher_path = os.path.join(out_root, f"{stem}_teacher.png")
            cv2.imwrite(sdr_path, bgr)
            cv2.imwrite(teacher_path, np.ascontiguousarray(out_u16_rgb[..., ::-1]))  # BGR u16
            written.append({"frame": idx, "sdr": sdr_path, "teacher": teacher_path})
        manifest = {"video": video, "pairs": written, "count": len(written)}
        with open(os.path.join(out_root, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        return manifest
    finally:
        cap.release()
