"""The two layout probes of the JAX package's ``tools/`` (port of the
Pallas kernels of ``tools/proto_d2s_kernel.py`` and
``tools/proto_rowmajor_head.py``), bf16 only, as the probes are.

``d2s_add``: depth-to-space of a coarse (hbc, wbc, 4C) tensor into fine
(2·hbc, 2·wbc, C) rows plus a fine tensor, summed in fp32 and rounded once
(the up path's d2s + add, which the resblock and tail kernels fold into
their reads). ``rowmajor_head_raw`` / ``rowmajor_head_pre``: the AGCM first
conv's shape on raw frame bytes, ·(1/255), a K = 12 bf16 product to Co
channels, read from (H, 3W) byte rows or from (Hb, 2, Wb, 6) row-pair planes
(the same bytes).

On a CUDA tensor each launches its kernel (``csrc/d2s_add.cu``,
``csrc/rowmajor_head.cu``) and counts it in ``native.launch_counts`` under
``d2s_add`` or ``rowmajor_head``; on a CPU tensor it runs the plain version
beside it. No frame program calls them: ``hdrtv_tpu_torch/tools/
proto_d2s_kernel.py`` and ``proto_rowmajor_head.py`` drive them.
"""

from __future__ import annotations

import torch

from hdrtv_tpu_torch.ops import native

_INV255 = torch.tensor(1.0 / 255.0, dtype=torch.float32)  # f32(1/255): a multiply, as the probe


def _check_bf16(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} takes bfloat16 tensors, got {t.dtype}")


def d2s_add_ref(coarse: torch.Tensor, fine: torch.Tensor) -> torch.Tensor:
    """Plain version: ``out[2r+i, 2x+j, c] = bf16(f32(coarse[r, x, (2i+j)·C + c])
    + f32(fine[2r+i, 2x+j, c]))``, the probe's reshape/transpose parity form."""
    hbc, wbc, c4 = coarse.shape
    c = c4 // 4
    up = coarse.reshape(hbc, wbc, 2, 2, c).permute(0, 2, 1, 3, 4).reshape(2 * hbc, 2 * wbc, c)
    return (up.float() + fine.float()).to(torch.bfloat16)


def d2s_add(coarse: torch.Tensor, fine: torch.Tensor) -> torch.Tensor:
    """coarse (hbc, wbc, 4C) bf16 + fine (2·hbc, 2·wbc, C) bf16 → (2·hbc,
    2·wbc, C) bf16, C a multiple of 8; equal to :func:`d2s_add_ref` bit for
    bit (one rounding)."""
    _check_bf16("d2s_add", coarse, fine)
    if coarse.ndim != 3 or coarse.shape[2] % 32:
        raise ValueError(f"d2s_add: coarse must be (hbc, wbc, 4C) with C a multiple of 8, got {tuple(coarse.shape)}")
    hbc, wbc, c4 = coarse.shape
    c = c4 // 4
    if tuple(fine.shape) != (2 * hbc, 2 * wbc, c):
        raise ValueError(f"d2s_add: fine must be {(2 * hbc, 2 * wbc, c)}, got {tuple(fine.shape)}")
    if native.on_cpu(coarse, fine):
        return d2s_add_ref(coarse, fine)
    native.check_cuda("d2s_add coarse", coarse, torch.bfloat16)
    native.check_cuda("d2s_add fine", fine, torch.bfloat16)
    out = torch.empty_like(fine)
    native.launch("d2s_add", torch.bfloat16, coarse.data_ptr(), fine.data_ptr(), out.data_ptr(),
                  hbc, wbc, c, native.stream_of(coarse))
    return out


def _head_ref(x12: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., 12) u8 → (..., Co) bf16: ·f32(1/255) rounded to bf16, then the
    exact bf16 products summed in fp32, rounded once."""
    v = (x12.to(torch.float32) * _INV255.to(x12.device)).to(torch.bfloat16)
    return torch.matmul(v.float(), w.float()).to(torch.bfloat16)


def rowmajor_head_pre_ref(xr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version on (Hb, 2, Wb, 6) u8 pair planes: each pixel's twelve
    bytes are its row pair's six each, even row first."""
    return _head_ref(torch.cat([xr[:, 0], xr[:, 1]], dim=-1), w)


def rowmajor_head_raw_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version on (H, 3W) u8 byte rows: regroup in place, then as
    :func:`rowmajor_head_pre_ref`."""
    h, w3 = x.shape
    return rowmajor_head_pre_ref(x.reshape(h // 2, 2, w3 // 6, 6), w)


def _check_head(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype != torch.uint8:
        raise ValueError(f"rowmajor_head takes uint8 frame bytes, got {x.dtype}")
    _check_bf16("rowmajor_head weight", w)
    if w.ndim != 2 or w.shape[0] != 12 or w.shape[1] % 8 or not 0 < w.shape[1] <= 2048:
        raise ValueError(f"rowmajor_head: w must be (12, Co), Co a multiple of 8 up to 2048, got {tuple(w.shape)}")


def rowmajor_head_raw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(H, 3W) u8 BGR-or-RGB byte rows (H and W even) and w (12, Co) bf16 →
    (H/2, W/2, Co) bf16."""
    _check_head(x, w)
    if x.ndim != 2 or x.shape[0] % 2 or x.shape[1] % 6:
        raise ValueError(f"rowmajor_head_raw: x must be (H, 3W) with H and W even, got {tuple(x.shape)}")
    if native.on_cpu(x, w):
        return rowmajor_head_raw_ref(x, w)
    h, w3 = x.shape
    co = w.shape[1]
    native.check_cuda("rowmajor_head x", x, torch.uint8)
    native.check_cuda("rowmajor_head w", w, torch.bfloat16)
    out = torch.empty((h // 2, w3 // 6, co), dtype=torch.bfloat16, device=x.device)
    native.launch("rowmajor_head_raw", torch.bfloat16, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                  h, w3, co, native.stream_of(x), counter="rowmajor_head")
    return out


def rowmajor_head_pre(xr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(Hb, 2, Wb, 6) u8 row-pair planes and w (12, Co) bf16 → (Hb, Wb, Co)
    bf16; the same kernel body as :func:`rowmajor_head_raw`."""
    _check_head(xr, w)
    if xr.ndim != 4 or xr.shape[1] != 2 or xr.shape[3] != 6:
        raise ValueError(f"rowmajor_head_pre: xr must be (Hb, 2, Wb, 6), got {tuple(xr.shape)}")
    if native.on_cpu(xr, w):
        return rowmajor_head_pre_ref(xr, w)
    hb, _, wb, _ = xr.shape
    co = w.shape[1]
    native.check_cuda("rowmajor_head xr", xr, torch.uint8)
    native.check_cuda("rowmajor_head w", w, torch.bfloat16)
    out = torch.empty((hb, wb, co), dtype=torch.bfloat16, device=xr.device)
    native.launch("rowmajor_head_pre", torch.bfloat16, xr.data_ptr(), w.data_ptr(), out.data_ptr(),
                  hb, wb, co, native.stream_of(xr), counter="rowmajor_head")
    return out
