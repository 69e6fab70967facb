"""Colour science (the port of ``hdrtv_tpu/ops/color.py``): SMPTE ST 2084
(PQ), the BT.709 ↔ BT.2020 primaries conversion (linear light, D65), the SDR
linearisations, and ITP (BT.2124) with its ΔEITP. ``ops/pack.py
colorimetric_pq_pack`` hands the constants to its kernel as arguments; the
functions are torch ops on fp32 tensors (NHWC or any (..., 3) layout) and
serve the metric path (``ops/metrics.py``).
"""

from __future__ import annotations

import numpy as np
import torch

PQ_M1 = 2610.0 / 16384.0
PQ_M2 = 2523.0 / 32.0
PQ_C1 = 3424.0 / 4096.0
PQ_C2 = 2413.0 / 128.0
PQ_C3 = 2392.0 / 128.0

BT709_TO_BT2020 = np.array(
    [
        [0.6274039, 0.3292830, 0.0433131],
        [0.0690973, 0.9195404, 0.0113623],
        [0.0163914, 0.0880133, 0.8955953],
    ],
    dtype=np.float32,
)
BT2020_TO_BT709 = np.array(
    [
        [1.6604910, -0.5876411, -0.0728499],
        [-0.1245505, 1.1328999, -0.0083494],
        [-0.0181508, -0.1005789, 1.1187297],
    ],
    dtype=np.float32,
)


def pq_oetf(luminance: torch.Tensor) -> torch.Tensor:
    """Absolute luminance (cd/m², 0..10000) → PQ code value [0, 1], with the
    reference's denominator epsilon."""
    y = (luminance.float() / 10000.0).clamp(0.0, 1.0)
    y_m1 = torch.pow(y, PQ_M1)
    num = PQ_C1 + PQ_C2 * y_m1
    den = 1.0 + PQ_C3 * y_m1
    return torch.pow(num / den.clamp_min(1e-12), PQ_M2)


def pq_eotf(code: torch.Tensor) -> torch.Tensor:
    """PQ code value [0, 1] → absolute luminance (cd/m²)."""
    e = code.float().clamp(0.0, 1.0)
    e_1m2 = torch.pow(e, 1.0 / PQ_M2)
    num = (e_1m2 - PQ_C1).clamp_min(0.0)
    den = PQ_C2 - PQ_C3 * e_1m2
    return 10000.0 * torch.pow(num / den.clamp_min(1e-12), 1.0 / PQ_M1)


def bt709_oetf_inverse(v: torch.Tensor) -> torch.Tensor:
    """BT.1886-style SDR EOTF (gamma 2.4): display-referred linearisation."""
    return torch.pow(v.clamp(0.0, 1.0), 2.4)


def srgb_to_linear(v: torch.Tensor) -> torch.Tensor:
    v = v.clamp(0.0, 1.0)
    return torch.where(v <= 0.04045, v / 12.92, torch.pow((v + 0.055) / 1.055, 2.4))


def apply_matrix(rgb: torch.Tensor, m) -> torch.Tensor:
    """A 3×3 colour matrix (numpy or tensor, rows = outputs) on (..., 3) RGB."""
    m = torch.as_tensor(m, dtype=rgb.dtype, device=rgb.device)
    return torch.einsum("...c,rc->...r", rgb, m)


def linear_rgb_to_itp(rgb_abs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BT.2124 Annex 1: display-referred linear BT.2020 RGB (cd/m²) → I, T,
    P, with the /4096 rational LMS and T = 0.5·Ct."""
    r, g, b = rgb_abs[..., 0], rgb_abs[..., 1], rgb_abs[..., 2]
    l = (1688.0 * r + 2146.0 * g + 262.0 * b) / 4096.0
    m = (683.0 * r + 2951.0 * g + 462.0 * b) / 4096.0
    s = (99.0 * r + 309.0 * g + 3688.0 * b) / 4096.0
    l_p, m_p, s_p = pq_oetf(l), pq_oetf(m), pq_oetf(s)
    i = 0.5 * l_p + 0.5 * m_p
    ct = (6610.0 * l_p - 13613.0 * m_p + 7003.0 * s_p) / 4096.0
    cp = (17933.0 * l_p - 17390.0 * m_p - 543.0 * s_p) / 4096.0
    return i, 0.5 * ct, cp


def delta_e_itp(pred_rgb_abs: torch.Tensor, ref_rgb_abs: torch.Tensor) -> torch.Tensor:
    """Mean ΔEITP (BT.2124) of two display-referred linear RGB images:
    720·√(ΔI² + ΔT² + ΔP² + 1e-12), averaged in fp32."""
    i1, t1, p1 = linear_rgb_to_itp(pred_rgb_abs)
    i2, t2, p2 = linear_rgb_to_itp(ref_rgb_abs)
    de = 720.0 * torch.sqrt((i1 - i2) ** 2 + (t1 - t2) ** 2 + (p1 - p2) ** 2 + 1e-12)
    return de.mean()
