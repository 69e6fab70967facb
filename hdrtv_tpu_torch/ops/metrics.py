"""Full-reference quality metrics (the port of ``hdrtv_tpu/ops/metrics.py``):
PSNR and SSIM on linear pairs, ΔEITP (BT.2124) from display-referred nits at
a 1000-nit peak, grade normalization, and the shared-black-border crop.

The metrics are torch ops on fp32 tensors, HWC (or NHWC), and run on the
tensors' device. SSIM reproduces ``cv2.GaussianBlur(11, σ = 1.5)`` with
REFLECT_101 borders; its separable blur is written as eleven shifted
multiply-adds a direction, in true fp32 on every device (a convolution on the
card would run in TF32 by default, ≈ 1e-3 on SSIM). The border crop is host
numpy: its sizes depend on the data.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from hdrtv_tpu_torch.ops.color import delta_e_itp
from hdrtv_tpu_torch.utils.env import env_float

OBJECTIVE_HDR_PEAK_NITS = env_float("HDRTVNET_OBJECTIVE_HDR_PEAK_NITS", 1000.0, lo=1e-6)


def psnr(pred: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """PSNR of unit-range inputs; 99.0 for identical frames (MSE ≤ 1e-12)."""
    mse = (pred.float() - ref.float()).square().mean()
    val = 10.0 * torch.log10(1.0 / mse.clamp_min(1e-30))
    return torch.where(mse <= 1e-12, torch.full_like(val, 99.0), val)


@functools.lru_cache(maxsize=4)
def _gaussian_kernel_11(sigma: float = 1.5) -> np.ndarray:
    """cv2.getGaussianKernel(11, 1.5): exp(−x²/2σ²) normalized (float64,
    then fp32)."""
    x = np.arange(11, dtype=np.float64) - 5.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _gauss_blur(img: torch.Tensor) -> torch.Tensor:
    """Separable 11 × 11 Gaussian with REFLECT_101 borders (torch's
    ``reflect``) over (..., H, W) single-channel images, in fp32: along W,
    then along H, each as eleven shifted multiply-adds."""
    k = [float(v) for v in _gaussian_kernel_11()]
    lead = img.shape[:-2]
    h, w = img.shape[-2], img.shape[-1]
    x = F.pad(img.reshape((-1, 1, h, w)).float(), (5, 5, 5, 5), mode="reflect")[:, 0]
    acc = x[..., 0:w] * k[0]
    for i in range(1, 11):
        acc = acc + x[..., i:i + w] * k[i]
    out = acc[:, 0:h] * k[0]
    for i in range(1, 11):
        out = out + acc[:, i:i + h] * k[i]
    return out.reshape(lead + (h, w))


def ssim_single(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Gaussian-window SSIM map mean of one channel pair: c1 = 0.01²,
    c2 = 0.03², 1e-12 on the denominator."""
    return _ssim_maps(a.float()[None], b.float()[None]).mean()


def _ssim_maps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The SSIM maps of a stack of (C, H, W) channel pairs, the five blurs of
    every channel in one pass."""
    c1, c2 = 0.01**2, 0.03**2
    blurred = _gauss_blur(torch.stack((a, b, a * a, b * b, a * b)))
    mu_a, mu_b = blurred[0], blurred[1]
    mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sigma_a2 = blurred[2] - mu_a2
    sigma_b2 = blurred[3] - mu_b2
    sigma_ab = blurred[4] - mu_ab
    num = (2.0 * mu_ab + c1) * (2.0 * sigma_ab + c2)
    den = (mu_a2 + mu_b2 + c1) * (sigma_a2 + sigma_b2 + c2)
    return num / (den + 1e-12)


def ssim(pred: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Mean of the per-channel SSIM over the last (channel) axis of HWC
    inputs."""
    a = pred.float().movedim(-1, 0)
    b = ref.float().movedim(-1, 0)
    return _ssim_maps(a, b).mean(dim=(-2, -1)).mean()


def delta_e_itp_unit(pred_rgb: torch.Tensor, ref_rgb: torch.Tensor, *, peak_nits: float | None = None) -> torch.Tensor:
    """ΔEITP of unit-range linear RGB signals clipped to [0, 1] and scaled
    to display nits (``peak_nits``, default OBJECTIVE_HDR_PEAK_NITS)."""
    peak = float(peak_nits if peak_nits is not None else OBJECTIVE_HDR_PEAK_NITS)
    p = pred_rgb.float().clamp(0.0, 1.0) * peak
    r = ref_rgb.float().clamp(0.0, 1.0) * peak
    return delta_e_itp(p, r)


def grade_normalize(pred: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """pred with its per-channel mean and (population) std matched to ref's
    over the spatial axes, clipped to [0, 1]; a channel of pred whose std is
    under 1e-6 keeps gain 1."""
    p = pred.float()
    r = ref.float()
    dims = (-3, -2)
    mp = p.mean(dim=dims, keepdim=True)
    mr = r.mean(dim=dims, keepdim=True)
    sp = p.std(dim=dims, keepdim=True, correction=0)
    sr = r.std(dim=dims, keepdim=True, correction=0)
    gain = torch.where(sp < 1e-6, torch.ones_like(sp), sr / sp.clamp_min(1e-12))
    bias = mr - gain * mp
    return (p * gain + bias).clamp(0.0, 1.0)


def crop_shared_black_borders(
    pred: np.ndarray,
    ref: np.ndarray,
    *,
    min_border_px: int = 8,
    black_level_ratio: float = 0.002,
) -> tuple[np.ndarray, np.ndarray, bool]:
    """Crop shared near-black letterbox borders of two HWC frames (unit-range
    float or integer), host numpy: (pred, ref, cropped)."""
    if pred.shape[:2] != ref.shape[:2] or pred.ndim < 3:
        return pred, ref, False
    peak = 1.0 if np.issubdtype(pred.dtype, np.floating) else float(np.iinfo(pred.dtype).max)
    thresh = max(2.0 / 255.0 * (255.0 if peak == 1.0 else 1.0), peak * black_level_ratio)
    if peak == 1.0:
        thresh = max(2.0 / 255.0, black_level_ratio)
    h, w = pred.shape[:2]
    min_row = max(4, int(round(w * 0.01)))
    min_col = max(4, int(round(h * 0.01)))

    def bounds(frame):
        fmax = frame.astype(np.float32).max(axis=2)
        mask = fmax > thresh
        if not mask.any():
            return None
        rows = np.count_nonzero(mask, axis=1) >= min_row
        cols = np.count_nonzero(mask, axis=0) >= min_col
        if not rows.any() or not cols.any():
            return None
        top = int(np.argmax(rows))
        bottom = h - int(np.argmax(rows[::-1]))
        left = int(np.argmax(cols))
        right = w - int(np.argmax(cols[::-1]))
        if bottom - top < 2 or right - left < 2:
            return None
        return top, bottom, left, right

    pb, rb = bounds(pred), bounds(ref)
    if pb is None and rb is None:
        return pred, ref, False
    if pb is None:
        top, bottom, left, right = rb
    elif rb is None:
        top, bottom, left, right = pb
    else:
        top, bottom = max(pb[0], rb[0]), min(pb[1], rb[1])
        left, right = max(pb[2], rb[2]), min(pb[3], rb[3])
    if max(top, h - bottom, left, w - right) < max(1, min_border_px):
        return pred, ref, False
    if bottom - top < 2 or right - left < 2:
        return pred, ref, False
    return (
        np.ascontiguousarray(pred[top:bottom, left:right]),
        np.ascontiguousarray(ref[top:bottom, left:right]),
        True,
    )


def full_reference_metrics(pred_rgb: torch.Tensor, ref_rgb: torch.Tensor, *,
                           peak_nits: float = 1000.0) -> dict[str, torch.Tensor]:
    """PSNR and SSIM of the linear pair clipped to [0, 1], ΔEITP, and PSNR
    and ΔEITP after grade normalization: 0-d fp32 tensors on the inputs'
    device, nothing copied to the host."""
    pred = pred_rgb.float().clamp(0.0, 1.0)
    ref = ref_rgb.float().clamp(0.0, 1.0)
    norm = grade_normalize(pred, ref)
    return {
        "psnr": psnr(pred, ref),
        "ssim": ssim(pred, ref),
        "delta_e_itp": delta_e_itp_unit(pred, ref, peak_nits=peak_nits),
        "psnr_gn": psnr(norm, ref),
        "delta_e_itp_gn": delta_e_itp_unit(norm, ref, peak_nits=peak_nits),
    }
