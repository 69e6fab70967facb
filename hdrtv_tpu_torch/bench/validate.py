"""Checkpoint validation: parity metrics, contract checks, temporal stability
(the port of ``hdrtv_tpu/bench/validate.py``: the models run as torch ops on
the CUDA card, or on the CPU when ``device="cpu"`` is passed).

The reference's QA tooling (SURVEY.md §4):
- scripts/validate_tensorrt_sources.py — per checkpoint: rebuild the model,
  count quantizable layers vs contract, run inference parity (PSNR/MAE),
  write contact sheets + a report;
- scripts/models/smoke_video_trt_vs_teacher.py — student vs FP32 teacher on
  frames: PSNR/MAE + ×8 diff images;
- scripts/models/probe_trt_temporal_stability.py — frame-pair temporal delta
  MAE + highlight MAE (the flicker gate that drove the mixed recipe).

Same roles here, for int8/turbo/s2d paths vs the fp32 teacher.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch


@dataclasses.dataclass
class ParityReport:
    psnr: float
    mae: float
    max_err: float
    highlight_mae: float
    dark_mae: float
    layer_mix: dict
    frames: int

    def as_dict(self):
        return dataclasses.asdict(self)


def _metrics(pred: np.ndarray, ref: np.ndarray) -> tuple[float, float, float, float, float]:
    pred = pred.astype(np.float32)
    ref = ref.astype(np.float32)
    err = np.abs(pred - ref)
    mse = float(np.mean(err**2))
    psnr = 99.0 if mse <= 1e-12 else float(10.0 * np.log10(1.0 / mse))
    lum = ref.max(axis=-1, keepdims=True)
    hl = lum > 0.75
    dk = lum < 0.15
    hl_mae = float(err[np.broadcast_to(hl, err.shape)].mean()) if hl.any() else 0.0
    dk_mae = float(err[np.broadcast_to(dk, err.shape)].mean()) if dk.any() else 0.0
    return psnr, float(err.mean()), float(err.max()), hl_mae, dk_mae


def _frames_for_validation(frames, count, size):
    if frames is not None:
        return frames
    h, w = size
    out = []
    for i in range(count):
        rng = np.random.RandomState(100 + i)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.stack([(xx + i * 7) % w / w, yy / h, rng.rand(h, w).astype(np.float32)], -1)
        img[h // 4 : h // 2, w // 4 : w // 2] = 0.97  # highlight patch
        out.append(img)
    return out


def validate_checkpoint(
    student_params: dict,
    teacher_params: dict,
    cfg,
    *,
    frames: list[np.ndarray] | None = None,
    frame_count: int = 4,
    size: tuple[int, int] = (192, 256),
    expected_mix: dict | None = None,
    out_dir: str | None = None,
    student_apply=None,
    teacher_apply=None,
    device=None,
) -> ParityReport:
    """Run student vs teacher on validation frames; optional contract check.

    ``expected_mix`` e.g. {"w8a8": 29} asserts the quantized-layer contract
    (Full-INT8: zero fallback layers — README.md:69). The models run in
    fp32 on ``device`` (``utils/device.py compute_device``: the card unless
    the caller names another).
    """
    from hdrtv_tpu_torch.utils.device import compute_device
    from hdrtv_tpu_torch.models.hdrtvnet import ensemble_agcm_le, natural_params_to_torch
    from hdrtv_tpu_torch.models.layers import fp32_math
    from hdrtv_tpu_torch.ops.resize import downsample_quarter_aa
    from hdrtv_tpu_torch.quant.int8 import quantized_layer_summary

    student_apply = student_apply or ensemble_agcm_le
    teacher_apply = teacher_apply or ensemble_agcm_le

    mix_counts: dict[str, int] = {}
    for v in quantized_layer_summary(student_params).values():
        mix_counts[v] = mix_counts.get(v, 0) + 1
    if expected_mix:
        for kind, count in expected_mix.items():
            actual = mix_counts.get(kind, 0)
            if actual != count:
                raise AssertionError(f"layer contract violated: {kind}={actual}, expected {count}")

    dev = compute_device(device)
    sp = natural_params_to_torch(student_params, dev)
    tp = natural_params_to_torch(teacher_params, dev)

    frames = _frames_for_validation(frames, frame_count, size)
    psnrs, maes, maxes, hls, dks = [], [], [], [], []
    sheets = []
    for img in frames:
        with torch.inference_mode(), fp32_math():
            x = torch.from_numpy(np.asarray(img, np.float32)[None]).to(dev)
            cond = downsample_quarter_aa(x)
            s = np.clip(student_apply(sp, x, cond, cfg).float().cpu().numpy(), 0, 1)[0]
            t = np.clip(teacher_apply(tp, x, cond, cfg).float().cpu().numpy(), 0, 1)[0]
        p, m, mx, hl, dk = _metrics(s, t)
        psnrs.append(p)
        maes.append(m)
        maxes.append(mx)
        hls.append(hl)
        dks.append(dk)
        if out_dir:
            diff = np.clip(np.abs(s - t) * 8.0, 0, 1)  # ×8 diff sheet
            sheets.append(np.concatenate((t, s, diff), axis=1))

    report = ParityReport(
        psnr=round(float(np.mean(psnrs)), 3),
        mae=round(float(np.mean(maes)), 6),
        max_err=round(float(np.max(maxes)), 5),
        highlight_mae=round(float(np.mean(hls)), 6),
        dark_mae=round(float(np.mean(dks)), 6),
        layer_mix=mix_counts,
        frames=len(frames),
    )
    if out_dir:
        import cv2

        os.makedirs(out_dir, exist_ok=True)
        for i, sheet in enumerate(sheets):
            cv2.imwrite(
                os.path.join(out_dir, f"parity_{i:03d}.png"),
                (sheet[..., ::-1] * 65535).astype(np.uint16),
            )
        with open(os.path.join(out_dir, "report.json"), "w") as f:
            json.dump(report.as_dict(), f, indent=2)
    return report


def temporal_stability_probe(
    params: dict,
    cfg,
    *,
    frame_count: int = 6,
    size: tuple[int, int] = (192, 256),
    motion_px: int = 3,
    device=None,
) -> dict:
    """Temporal delta MAE + highlight delta on a slowly-panning sequence.

    A stable converter should produce output deltas commensurate with input
    deltas; quantization flicker shows up as output-delta ≫ input-delta in
    highlights (probe_trt_temporal_stability.py role). The model runs in
    fp32 on ``device``, as in ``validate_checkpoint``.
    """
    from hdrtv_tpu_torch.utils.device import compute_device
    from hdrtv_tpu_torch.models.hdrtvnet import ensemble_agcm_le, natural_params_to_torch
    from hdrtv_tpu_torch.models.layers import fp32_math
    from hdrtv_tpu_torch.ops.resize import downsample_quarter_aa

    dev = compute_device(device)
    pj = natural_params_to_torch(params, dev)
    h, w = size
    rng = np.random.RandomState(7)
    base = rng.rand(h, w + motion_px * frame_count, 3).astype(np.float32)
    base[h // 3 : h // 2, :] = 0.95  # highlight band

    outs, ins = [], []
    for i in range(frame_count):
        img = base[:, i * motion_px : i * motion_px + w]
        with torch.inference_mode(), fp32_math():
            x = torch.from_numpy(np.ascontiguousarray(img)[None]).to(dev)
            cond = downsample_quarter_aa(x)
            outs.append(np.clip(ensemble_agcm_le(pj, x, cond, cfg).float().cpu().numpy(), 0, 1)[0])
        ins.append(img)

    in_deltas = [np.abs(ins[i + 1] - ins[i]).mean() for i in range(frame_count - 1)]
    out_deltas = [np.abs(outs[i + 1] - outs[i]).mean() for i in range(frame_count - 1)]
    lum = [o.max(axis=-1) for o in outs]
    hl_deltas = []
    for i in range(frame_count - 1):
        mask = lum[i] > 0.75
        if mask.any():
            hl_deltas.append(float(np.abs(outs[i + 1] - outs[i])[mask].mean()))
    return {
        "input_delta_mae": round(float(np.mean(in_deltas)), 6),
        "output_delta_mae": round(float(np.mean(out_deltas)), 6),
        "amplification": round(float(np.mean(out_deltas) / max(1e-9, np.mean(in_deltas))), 3),
        "highlight_delta_mae": round(float(np.mean(hl_deltas)) if hl_deltas else 0.0, 6),
    }
