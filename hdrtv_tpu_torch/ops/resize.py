"""Separable antialiased ¼-res resampling as matrix products (port of the
AGCM condition-image part of ``hdrtv_tpu/ops/resize.py``).

The per-axis weight matrices are computed on the host in float64 with the
torch/PIL antialias semantics and applied as two fp32 matmuls, on an NHWC
image, on flat (H, 3W) byte rows or on (Hb, 2, Wb, 6) row-pair planes. These
are plain ``torch.matmul``/``tensordot`` calls, as the JAX package leaves
them to XLA.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _bicubic_aa(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Bicubic kernel with a=-0.5 (the torch/PIL antialias variant)."""
    ax = np.abs(x)
    r = np.zeros_like(ax)
    m1 = ax <= 1.0
    m2 = (ax > 1.0) & (ax < 2.0)
    r[m1] = ((a + 2.0) * ax[m1] - (a + 3.0)) * ax[m1] * ax[m1] + 1.0
    r[m2] = a * (((ax[m2] - 5.0) * ax[m2] + 8.0) * ax[m2] - 4.0)
    return r


def _bilinear(x: np.ndarray) -> np.ndarray:
    return np.clip(1.0 - np.abs(x), 0.0, None)


@functools.lru_cache(maxsize=64)
def resample_matrix(
    in_size: int, out_size: int, scale: float, *, kernel: str = "bicubic_aa", antialias: bool = True
) -> np.ndarray:
    """(out_size, in_size) resampling matrix (the torch UpSampleAntialias /
    PIL weight computation, clipped windows renormalised at the borders)."""
    if kernel == "bicubic_aa":
        filt, half = _bicubic_aa, 2.0
    elif kernel == "bilinear":
        filt, half = _bilinear, 1.0
    else:
        raise ValueError(f"unknown kernel '{kernel}'")
    widen = antialias and scale >= 1.0
    support = half * scale if widen else half
    invscale = 1.0 / scale if widen else 1.0

    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = scale * (i + 0.5)
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        j = np.arange(xmin, xmax, dtype=np.float64)
        w = filt((j - center + 0.5) * invscale)
        total = w.sum()
        if total != 0.0:
            w = w / total
        mat[i, xmin:xmax] = w
    return mat.astype(np.float32)


def _apply_separable(x: torch.Tensor, wh: np.ndarray, ww: np.ndarray) -> torch.Tensor:
    """x: (N, H, W, C) → (N, out_h, out_w, C) via two fp32 matmuls."""
    wh_t = torch.as_tensor(wh, device=x.device)
    ww_t = torch.as_tensor(ww, device=x.device)
    y = torch.einsum("oh,nhwc->nowc", wh_t, x.float())
    y = torch.einsum("pw,nowc->nopc", ww_t, y)
    return y.to(x.dtype)


def downsample_quarter_aa(x: torch.Tensor) -> torch.Tensor:
    """Antialiased bicubic ¼-res downsample of an NHWC float image — the AGCM
    condition input (F.interpolate(scale_factor=0.25, mode='bicubic',
    antialias=True) semantics, out = floor(in/4))."""
    _, h, w, _ = x.shape
    return _apply_separable(x, resample_matrix(h, h // 4, 4.0), resample_matrix(w, w // 4, 4.0))


@functools.lru_cache(maxsize=8)
def _kron_i3(w: int, out_w: int, bgr: bool) -> np.ndarray:
    """(3w, 3·out_w) expansion of the W resample matrix over interleaved RGB
    byte rows: K[3wi+ci, 3jo+co] = ww[jo, wi]·δ(ci = flip(co))."""
    ww = resample_matrix(w, out_w, 4.0)
    k = np.zeros((3 * w, 3 * out_w), np.float32)
    for co in range(3):
        ci = 2 - co if bgr else co
        k[ci::3, co::3] = ww.T
    return k


@functools.lru_cache(maxsize=8)
def _flat_matrices(h: int, w: int, bgr: bool, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The two matrices of :func:`downsample_quarter_aa_flat`, resident on
    ``device`` (the W one is 33 MB at 1080p: built and copied once per size)."""
    wh = torch.as_tensor(resample_matrix(h, h // 4, 4.0), device=device)
    k = torch.as_tensor(_kron_i3(w, w // 4, bgr), device=device)
    return wh, k


@functools.lru_cache(maxsize=8)
def _pairs_matrices(hb: int, wb: int, bgr: bool, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The matrices of :func:`_flat_matrices` viewed over row-pair planes:
    (H/4, Hb·2) and (Wb·6, 3·W/4), the same values in the same order."""
    wh, k = _flat_matrices(2 * hb, 2 * wb, bgr, device)
    return wh.reshape(hb // 2, hb, 2), k.reshape(wb, 6, 3 * (wb // 2))


def downsample_quarter_aa_flat(frame2d: torch.Tensor, *, bgr: bool = False) -> torch.Tensor:
    """(H, 3W) uint8 byte rows → (1, H/4, W/4, 3) f32 [0,1]: the AGCM
    condition image computed on the flat layout, with the BGR flip folded
    into the W matrix. Same math as reshape + :func:`downsample_quarter_aa`."""
    h, w3 = frame2d.shape
    w = w3 // 3
    wh, k = _flat_matrices(h, w, bgr, str(frame2d.device))
    x = frame2d.float() * (1.0 / 255.0)
    y = torch.matmul(wh, x)
    y = torch.matmul(y, k)
    return y.reshape(1, h // 4, w // 4, 3)


def downsample_quarter_aa_pairs(xr: torch.Tensor, *, bgr: bool = False) -> torch.Tensor:
    """(Hb, 2, Wb, 6) uint8 row-pair planes → (1, H/4, W/4, 3) f32 [0,1].

    ``xr[i, a, j, m]`` is row ``2i+a``, byte column ``6j+m`` of the flat
    frame, so the matrices of :func:`downsample_quarter_aa_flat` apply as
    they are, reshaped: first the H matrix over (Hb, 2), then the kron-expanded
    W matrix over (Wb, 6), in that order, in fp32."""
    hb, _, wb, _ = xr.shape
    wh, k = _pairs_matrices(hb, wb, bgr, str(xr.device))
    x = xr.float() * (1.0 / 255.0)
    y = torch.tensordot(wh, x, dims=([1, 2], [0, 1]))  # (H/4, Wb, 6)
    y = torch.tensordot(y, k, dims=([1, 2], [0, 1]))  # (H/4, 3·W/4)
    return y.reshape(1, hb // 2, wb // 2, 3)
