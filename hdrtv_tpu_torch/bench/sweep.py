"""Precision sweep with ΔEITP quality bench (port of
``hdrtv_tpu/bench/sweep.py``).

Runs the same frames through every requested precision path — fp32, bf16,
int8 mixed/full (PTQ or the shipped QAT checkpoints) — on the
natural-layout program and reports PSNR / SSIM / ΔEITP vs the fp32
reference output plus per-preset frame time. The quality side mirrors the
reference's per-preset ΔEITP benching (SURVEY.md §7 stage 4); the models
and the metrics (ops/metrics.py) run on the CUDA card unless the caller
names another device.

The default ladder adds an "int8-mixed (PTQ)" row only where the
reference's mixed layout exists: ``configs/qat_layouts/
original_nohg_mixed_w8a8.txt`` under the weights root (``config.py
weights_root``; the JAX package reads a fixed path of the reference tree).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np


@dataclasses.dataclass
class SweepEntry:
    preset: str
    psnr: float
    ssim: float
    delta_e_itp: float
    ms_per_frame: float
    layer_mix: dict


def _frames(count: int, size: tuple[int, int]) -> list[np.ndarray]:
    h, w = size
    out = []
    for i in range(count):
        rng = np.random.RandomState(40 + i)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        img = np.stack([(xx + 31 * i) % w / w, yy / h, rng.rand(h, w).astype(np.float32)], -1)
        img[h // 5 : h // 3, w // 5 : w // 2] = 0.96
        out.append(img)
    return out


def _smooth2d(n: np.ndarray, passes: int = 3) -> np.ndarray:
    for _ in range(passes):
        n = (np.roll(n, 1, 0) + n + np.roll(n, -1, 0)) * (1.0 / 3.0)
        n = (np.roll(n, 1, 1) + n + np.roll(n, -1, 1)) * (1.0 / 3.0)
    return n


def natural_frames(count: int, size: tuple[int, int]) -> list[np.ndarray]:
    """Deterministic synthetic frames with *natural image statistics* —
    the content classes the reference's quality validation leans on
    (validate_tensorrt_sources.py sample frames; the QAT recipe's highlight/
    dark/skin tone-protection masks, quantize_int8_mixed_qat.py):

    - low-frequency scene luminance (sky gradient + smoothed structure)
    - a skin-tone region (the ΔEITP-critical hue band)
    - specular highlights near clip (maxRGB > 0.85 — trips the HG mask and
      the int8 highlight-rolloff failure mode)
    - deep shadow band (dark-banding / dequant-step visibility)
    - film grain correlated with luminance (flicker amplification probe)
    - a slow pan between frames (temporal continuity)

    Replaces the 4-frame 192×256 gradient/noise set for QUALITY.md
    (VERDICT r4 item 5): gradients+noise under-exercise exactly the spots
    where quantization fails — skin, speculars, and grain.
    """
    h, w = size
    out = []
    for i in range(count):
        rng = np.random.RandomState(1000 + i)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        u, v = xx * (1.0 / w), yy * (1.0 / h)
        t = i / max(count - 1, 1)

        # Sky/ambient gradient, panning slowly across the sequence.
        base = 0.22 + 0.45 * (1.0 - v) ** 1.5 + 0.06 * np.sin(2 * np.pi * (u * 1.3 + 0.7 * t))
        # Low-frequency structure: blocky noise smoothed into soft shapes.
        coarse = rng.rand(h // 8 + 2, w // 8 + 2).astype(np.float32)
        n = np.kron(coarse, np.ones((8, 8), np.float32))[:h, :w]
        n = _smooth2d(n, 4)
        luma = np.clip(base * (0.55 + 0.9 * n), 0.0, 1.0)

        # Mild color cast: warm top-left, cool shadows.
        img = np.stack(
            [
                luma * (1.0 + 0.12 * np.cos(2 * np.pi * (u + 0.3 * t))),
                luma,
                luma * (1.0 + 0.18 * (v - 0.5)),
            ],
            -1,
        )

        # Skin-tone ellipse with soft shading.
        cy, cx = 0.42 + 0.05 * np.sin(2.1 * i), 0.30 + 0.35 * t
        d2 = ((v - cy) / 0.16) ** 2 + ((u - cx) / 0.10) ** 2
        skin_a = np.clip(1.0 - d2, 0.0, 1.0) ** 1.5
        shade = 0.75 + 0.25 * (1.0 - (u - cx) * 3.0).clip(0.4, 1.0)
        for c, tone in enumerate((0.80, 0.58, 0.47)):
            img[..., c] = img[..., c] * (1 - skin_a) + (tone * shade) * skin_a

        # Specular highlights: a few near-clip gaussian peaks (HG mask zone).
        for k in range(4):
            py, px = rng.rand(2) * 0.8 + 0.1
            sig = 0.004 + 0.01 * rng.rand()
            peak = np.exp(-(((v - py) ** 2 + (u - px) ** 2) / (2 * sig**2)))
            img += peak[..., None] * np.array(
                [0.98, 0.96, 0.92], np.float32
            ) * (0.8 + 0.2 * rng.rand())

        # Deep shadow band along the bottom.
        shadow = np.clip((v - 0.82) * 8.0, 0.0, 1.0)
        img *= (1.0 - 0.92 * shadow)[..., None]

        # Film grain, stronger in the midtones (luma-correlated).
        g_sigma = 0.004 + 0.010 * (luma * (1.0 - luma) * 4.0)
        img += (rng.randn(h, w, 3).astype(np.float32)) * g_sigma[..., None]

        out.append(np.clip(img, 0.0, 1.0).astype(np.float32))
    return out


def mixed_layout_path() -> str:
    """Where the default ladder looks for the reference's mixed layout."""
    from hdrtv_tpu_torch.config import weights_root

    return os.path.join(weights_root(), "configs", "qat_layouts", "original_nohg_mixed_w8a8.txt")


def precision_sweep(
    fp32_params: dict,
    cfg,
    *,
    presets: dict[str, dict] | None = None,
    frames: list[np.ndarray] | None = None,
    frame_count: int = 3,
    size: tuple[int, int] = (192, 256),
    peak_nits: float = 1000.0,
    device=None,
) -> list[SweepEntry]:
    """``presets``: name → {"params": already-quantized checkpoint,
    "precision": "bf16" or "fp32"}, or None to derive the standard ladder
    (bf16, int8-mixed, int8-full) from fp32 via PTQ. The programs and
    metrics run on ``device`` (the CUDA card unless the caller names
    another); ms_per_frame is the host's wall time of a preset's frames,
    their metrics included, over the frame count.
    """
    import torch

    from hdrtv_tpu_torch.utils.device import compute_device
    from hdrtv_tpu_torch.models.hdrtvnet import model_apply, natural_params_to_torch
    from hdrtv_tpu_torch.models.layers import BF16, F32, fp32_math
    from hdrtv_tpu_torch.ops.metrics import full_reference_metrics
    from hdrtv_tpu_torch.quant.calibrate import calibrate, frame_inputs
    from hdrtv_tpu_torch.quant.int8 import (
        DEFAULT_EXCLUDE_SUFFIXES,
        load_mixed_layout,
        quantizable_layers,
        quantize_params,
        quantized_layer_summary,
    )

    dev = compute_device(device)
    frames = frames if frames is not None else _frames(frame_count, size)

    if presets is None:
        presets = {"bf16": ("bf16", fp32_params)}
        mixed_layout = mixed_layout_path()
        if os.path.isfile(mixed_layout):
            qp = quantize_params(fp32_params, load_mixed_layout(mixed_layout), mode="w8a8", asymmetric=True)
            presets["int8-mixed (PTQ)"] = ("bf16", calibrate(qp, frames, cfg, device=dev))
        full_layers = [l for l in quantizable_layers(fp32_params) if not l.endswith(DEFAULT_EXCLUDE_SUFFIXES)]
        qp = quantize_params(fp32_params, full_layers, mode="w8a8", asymmetric=True)
        presets["int8-full (PTQ)"] = ("bf16", calibrate(qp, frames, cfg, device=dev))
    else:
        presets = {k: (v.get("precision", "bf16"), v["params"]) for k, v in presets.items()}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    entries: list[SweepEntry] = []
    with torch.inference_mode():
        with fp32_math():
            fp = natural_params_to_torch(fp32_params, dev, F32)
            inputs = [frame_inputs(frame, dev) for frame in frames]
            refs = [model_apply(fp, img, cond, cfg, policy=F32).clamp(0, 1) for img, cond in inputs]
        for name, (precision, params) in presets.items():
            policy = F32 if precision == "fp32" else BF16
            with policy.math():
                pj = natural_params_to_torch(params, dev, policy)
                sync()
                t0 = time.perf_counter()
                rows = []
                for (img, cond), ref in zip(inputs, refs):
                    out = model_apply(pj, img, cond, cfg, policy=policy).clamp(0, 1)
                    m = full_reference_metrics(out[0], ref[0], peak_nits=peak_nits)
                    rows.append(torch.stack([m["psnr"], m["ssim"], m["delta_e_itp"]]).double())
                host = torch.stack(rows).cpu().numpy()
                dt = (time.perf_counter() - t0) / len(inputs) * 1e3
            mix: dict[str, int] = {}
            for v in quantized_layer_summary(params).values():
                mix[v] = mix.get(v, 0) + 1
            entries.append(
                SweepEntry(
                    preset=name,
                    psnr=round(float(np.mean(host[:, 0])), 3),
                    ssim=round(float(np.mean(host[:, 1])), 5),
                    delta_e_itp=round(float(np.mean(host[:, 2])), 4),
                    ms_per_frame=round(dt, 2),
                    layer_mix=mix,
                )
            )
    return entries
