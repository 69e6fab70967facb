"""Separable resampling as matrix products (port of
``hdrtv_tpu/ops/resize.py``): the AGCM condition image (the antialiased
bicubic ¼-res downsample, and the bilinear one of the fast-condition
shortcut), the cv2.INTER_AREA-style and general bicubic resizes, and the
aspect-preserving letterbox of the runtime's ``proc_resolution``.

The per-axis weight matrices are computed on the host in float64 with the
torch/PIL antialias semantics, copied to the device once per (sizes, kind,
device) and kept there, and applied as two fp32 matmuls, on an NHWC image,
on flat (H, 3W) byte rows or on (Hb, 2, Wb, 6) row-pair planes. A frame
therefore makes no host-to-device copy here after its size's first call
(which a CUDA graph capture could not record). These are plain
``torch.matmul``/``tensordot`` calls, as the JAX package leaves them to XLA.

The device caches are bounded, and a CUDA graph records the raw addresses
of the matrices its capture read: a matrix evicted and freed would leave a
replay reading whatever the allocator put there next. A capture therefore
runs inside :func:`hold_matrices`, and its graph keeps the matrices that
collects (``runtime/engine.py``).
"""

from __future__ import annotations

import contextlib
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


# The lists of the hold_matrices blocks that are open.
_holders: list[list[torch.Tensor]] = []


@contextlib.contextmanager
def hold_matrices():
    """Collect, into the list this yields, every cached device matrix that
    the calls inside the block read, so that what they launched (a CUDA
    graph's capture) can keep the matrices alive after their cache drops
    them."""
    held: list[torch.Tensor] = []
    _holders.append(held)
    try:
        yield held
    finally:
        _holders.remove(held)


def _held(*mats: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``mats``, added to every open :func:`hold_matrices` list."""
    for held in _holders:
        held.extend(mats)
    return mats


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


@functools.lru_cache(maxsize=64)
def area_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) box-filter matrix matching cv2.INTER_AREA for downscale."""
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    for i in range(out_size):
        lo, hi = i * scale, (i + 1) * scale
        j0, j1 = int(np.floor(lo)), int(np.ceil(hi))
        for j in range(j0, min(j1, in_size)):
            cover = min(hi, j + 1) - max(lo, j)
            if cover > 0:
                mat[i, j] = cover
        mat[i] /= mat[i].sum()
    return mat.astype(np.float32)


def _axis_matrix(kind: str, in_size: int, out_size: int) -> np.ndarray:
    """One axis's (out, in) matrix of a resize ``kind``: ``quarter_aa`` (the
    AGCM condition, scale exactly 4), ``quarter_bilinear`` (its fast
    shortcut, no antialias), ``area`` (INTER_AREA), ``bicubic_aa`` (any
    scale, antialiased) or ``bicubic`` (any scale, not antialiased: the
    letterbox's upscale)."""
    if kind == "quarter_aa":
        return resample_matrix(in_size, out_size, 4.0)
    if kind == "quarter_bilinear":
        return resample_matrix(in_size, out_size, 4.0, kernel="bilinear", antialias=False)
    if kind == "area":
        return area_matrix(in_size, out_size)
    if kind == "bicubic_aa":
        return resample_matrix(in_size, out_size, in_size / out_size)
    if kind == "bicubic":
        return resample_matrix(in_size, out_size, in_size / out_size, antialias=False)
    raise ValueError(f"unknown resize kind '{kind}'")


@functools.lru_cache(maxsize=32)
def _device_matrices(kind: str, h: int, out_h: int, w: int, out_w: int,
                     device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The H and W matrices of a separable resize, resident on ``device``."""
    return (torch.as_tensor(_axis_matrix(kind, h, out_h), device=device),
            torch.as_tensor(_axis_matrix(kind, w, out_w), device=device))


def _apply_separable(x: torch.Tensor, kind: str, out_h: int, out_w: int) -> torch.Tensor:
    """x: (N, H, W, C) → (N, out_h, out_w, C) via two fp32 matmuls with the
    cached device matrices of ``kind``."""
    _, h, w, _ = x.shape
    wh, ww = _held(*_device_matrices(kind, h, out_h, w, out_w, str(x.device)))
    y = torch.einsum("oh,nhwc->nowc", wh, x.float())
    y = torch.einsum("pw,nowc->nopc", ww, y)
    return y.to(x.dtype)


def downsample_quarter_aa(x: torch.Tensor) -> torch.Tensor:
    """Antialiased bicubic ¼-res downsample of an NHWC float image — the AGCM
    condition input (F.interpolate(scale_factor=0.25, mode='bicubic',
    antialias=True) semantics, out = floor(in/4))."""
    _, h, w, _ = x.shape
    return _apply_separable(x, "quarter_aa", h // 4, w // 4)


def downsample_quarter_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Non-antialiased bilinear ¼-res downsample: the condition image of the
    ``fast_condition_resize`` shortcut."""
    _, h, w, _ = x.shape
    return _apply_separable(x, "quarter_bilinear", h // 4, w // 4)


def resize_area(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.INTER_AREA-equivalent downscale of an NHWC image."""
    return _apply_separable(x, "area", out_h, out_w)


def resize_bicubic_aa(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """General antialiased bicubic resize (any scale) of an NHWC image."""
    return _apply_separable(x, "bicubic_aa", out_h, out_w)


def letterbox_plan(h: int, w: int, out_h: int, out_w: int):
    """Aspect-preserving fit: (new_h, new_w, pad_top, pad_left, scale), the
    content centred between black bars."""
    scale = min(out_w / max(w, 1), out_h / max(h, 1))
    new_w = max(1, int(round(w * scale)))
    new_h = max(1, int(round(h * scale)))
    return new_h, new_w, (out_h - new_h) // 2, (out_w - new_w) // 2, scale


def letterbox_rgb(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(N, H, W, C) float → (N, out_h, out_w, C): the aspect-preserving resize
    (INTER_AREA down, bicubic up) with centred zero padding."""
    _, h, w, _ = x.shape
    if (h, w) == (out_h, out_w):
        return x
    new_h, new_w, top, left, scale = letterbox_plan(h, w, out_h, out_w)
    y = _apply_separable(x, "area" if scale < 1.0 else "bicubic", new_h, new_w)
    return torch.nn.functional.pad(y, (0, 0, left, out_w - new_w - left, top, out_h - new_h - top))


def letterbox_u8(frame: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(H, W, 3) uint8 → (out_h, out_w, 3) uint8 letterbox, on the frame's
    device."""
    if tuple(frame.shape[:2]) == (out_h, out_w):
        return frame
    y = letterbox_rgb(frame[None].float(), out_h, out_w)[0]
    return torch.round(y).clamp(0.0, 255.0).to(torch.uint8)


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
    wh, k = _held(*_flat_matrices(h, w, bgr, str(frame2d.device)))
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
    wh, k = _held(*_pairs_matrices(hb, wb, bgr, str(xr.device)))
    x = xr.float() * (1.0 / 255.0)
    y = torch.tensordot(wh, x, dims=([1, 2], [0, 1]))  # (H/4, Wb, 6)
    y = torch.tensordot(y, k, dims=([1, 2], [0, 1]))  # (H/4, 3·W/4)
    return y.reshape(1, hb // 2, wb // 2, 3)
