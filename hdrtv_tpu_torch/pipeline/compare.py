"""3-way compare snapshots: SDR | HDR ground truth | HDR conversion (the port
of ``hdrtv_tpu/pipeline/compare.py``: the metrics on the processor's device).

The reference's modal compare (gui_compare.py + gui_pipeline_worker_compare)
captures the current frame three ways and presents them side by side with
per-pair metrics. Here: ``compare_frame`` produces the triple + full metric
set, and ``write_compare_sheet`` saves a contact sheet (PNG) + JSON — the
benchmark result-viewer artifact style (gui_benchmark.py per-frame dirs).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np


@dataclasses.dataclass
class CompareResult:
    frame_idx: int
    sdr_rgb01: np.ndarray
    hdr_convert_rgb01: np.ndarray
    hdr_gt_rgb01: np.ndarray | None
    metrics: dict[str, float]


def compare_frame(
    processor,
    sdr_bgr_u8: np.ndarray,
    *,
    frame_idx: int = 0,
    gt_rgb01: np.ndarray | None = None,
    peak_nits: float = 1000.0,
) -> CompareResult:
    from hdrtv_tpu_torch.bench.quality import evaluate_pair

    conv = processor.process_rgb48(sdr_bgr_u8).astype(np.float32) / 65535.0
    sdr01 = sdr_bgr_u8[..., ::-1].astype(np.float32) / 255.0
    metrics: dict[str, float] = {}
    if gt_rgb01 is not None:
        metrics = evaluate_pair(conv, gt_rgb01, peak_nits=peak_nits, device=getattr(processor, "device", None))
    return CompareResult(frame_idx, sdr01, conv, gt_rgb01, metrics)


def write_compare_sheet(result: CompareResult, out_dir: str, *, gap: int = 8) -> str:
    """Side-by-side contact sheet (SDR | convert | GT) + metrics JSON."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    panels = [result.sdr_rgb01, result.hdr_convert_rgb01]
    labels = ["sdr", "hdr_convert"]
    if result.hdr_gt_rgb01 is not None:
        panels.append(result.hdr_gt_rgb01)
        labels.append("hdr_gt")
    h = max(p.shape[0] for p in panels)
    w = sum(p.shape[1] for p in panels) + gap * (len(panels) - 1)
    sheet = np.zeros((h, w, 3), np.float32)
    x = 0
    for p in panels:
        sheet[: p.shape[0], x : x + p.shape[1]] = p
        x += p.shape[1] + gap
    path = os.path.join(out_dir, f"compare_{result.frame_idx:06d}.png")
    cv2.imwrite(path, (np.clip(sheet[..., ::-1], 0, 1) * 65535).astype(np.uint16))
    # individual panels, reference naming (sdr.png / hdr_convert.tiff style)
    for label, p in zip(labels, panels):
        cv2.imwrite(
            os.path.join(out_dir, f"{label}_{result.frame_idx:06d}.png"),
            (np.clip(p[..., ::-1], 0, 1) * 65535).astype(np.uint16),
        )
    with open(os.path.join(out_dir, f"compare_{result.frame_idx:06d}.json"), "w") as f:
        json.dump({"frame": result.frame_idx, "metrics": result.metrics}, f, indent=2)
    return path
