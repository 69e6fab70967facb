"""Benchmark-frame figure renderer — presentation PNGs + contact sheets (the
port of ``hdrtv_tpu/bench/figures.py``).

The reference ships ``scripts/render_mpv_preview_figures.py``: it walks a
benchmark session for per-frame artifact dirs (``sdr.png`` /
``hdr_gt.tiff`` / ``hdr_convert.tiff``), replays each through the embedded
libmpv HDR display path at a chosen render size/scaler, and saves
thesis-friendly PNGs plus a labeled side-by-side contact sheet and a
manifest (render_mpv_preview_figures.py:85-104 discovery, :236-294 render,
:334-370 sheet, :373 manifest). There is no mpv window here, so the display
path is reproduced numerically on the device (the card, or the CPU when
``device="cpu"`` is passed; torch ops): the PQ signal is decoded with the
same ST-2084 math the metric path uses (ops/color.py), tone-mapped to the
target display with the BT.2390 EETF (mpv's default ``tone-mapping``),
converted BT.2020→BT.709, gamma-encoded, and upscaled with the scale
policy's kernel/CAS tiers (pipeline/scaling.py — the gui_scaling.py rules).

``png_depth=16`` keeps the tone-mapped output at 16-bit (mpv's
``--screenshot-png-depth=16`` role); 8 writes thesis/PDF-friendly PNGs.
"""

from __future__ import annotations

import json
import os

import numpy as np

FRAME_FILES = {
    "sdr": "sdr.png",
    "hdr_gt": "hdr_gt.tiff",
    "hdr_convert": "hdr_convert.tiff",
}
DEFAULT_KINDS = ("sdr", "hdr_convert", "hdr_gt")

# mpv defaults for the HDR→SDR window path: target-peak follows the SDR
# reference white (203 cd/m², BT.2408); source peak defaults to the HDR10
# mastering nominal when no per-frame measurement exists.
TARGET_NITS = 203.0
SOURCE_PEAK_NITS = 1000.0


def discover_frame_dirs(input_path: str, kinds=DEFAULT_KINDS) -> tuple[list[str], str]:
    """Find benchmark frame dirs containing all requested artifact kinds.

    A file input selects its parent dir; a dir that itself holds the frames
    is returned alone; otherwise the tree is walked recursively (the
    reference's rglob discovery, render_mpv_preview_figures.py:85-104).
    Returns (sorted dirs, resolved root).
    """
    root = os.path.abspath(input_path)
    names = [FRAME_FILES[k] for k in kinds]

    def has_all(d: str) -> bool:
        return all(os.path.isfile(os.path.join(d, n)) for n in names)

    if os.path.isfile(root):
        parent = os.path.dirname(root)
        return ([parent] if has_all(parent) else []), parent
    if not os.path.isdir(root):
        return [], root
    if has_all(root):
        return [root], root
    found = set()
    for dirpath, _dirs, files in os.walk(root):
        if all(n in files for n in names):
            found.add(dirpath)
    return sorted(found), root


def _eetf_2390(l_nits, target_nits: float, source_peak_nits: float):
    """BT.2390 EETF: compress [0, source peak] → [0, target] in the PQ
    domain (hermite knee above KS = 1.5·maxLum − 0.5)."""
    import torch

    from hdrtv_tpu_torch.ops.color import pq_eotf, pq_oetf

    src_pq = pq_oetf(torch.tensor(source_peak_nits, dtype=torch.float32, device=l_nits.device))
    e1 = pq_oetf(l_nits) / src_pq
    max_lum = pq_oetf(torch.tensor(target_nits, dtype=torch.float32, device=l_nits.device)) / src_pq
    ks = 1.5 * max_lum - 0.5
    t = (e1 - ks) / torch.clamp(1.0 - ks, min=1e-6)
    t2, t3 = t * t, t * t * t
    p = (
        (2.0 * t3 - 3.0 * t2 + 1.0) * ks
        + (t3 - 2.0 * t2 + t) * (1.0 - ks)
        + (-2.0 * t3 + 3.0 * t2) * max_lum
    )
    e2 = torch.where(e1 < ks, e1, p)
    return pq_eotf(torch.clamp(e2, 0.0, 1.0) * src_pq)


def tone_map_pq(code01: np.ndarray, *, target_nits: float = TARGET_NITS,
                source_peak_nits: float = SOURCE_PEAK_NITS, device=None) -> np.ndarray:
    """HDR PQ code values (H,W,3 RGB, [0,1]) → display-referred [0,1] BT.709
    (gamma 2.4), computed on ``device`` (``utils/device.py compute_device``)."""
    import torch

    from hdrtv_tpu_torch.utils.device import compute_device
    from hdrtv_tpu_torch.ops.color import BT2020_TO_BT709, apply_matrix, pq_eotf

    x = torch.from_numpy(np.ascontiguousarray(code01, np.float32)).to(compute_device(device))
    nits = pq_eotf(x)
    # maxRGB tone-mapping (mpv --tone-mapping-mode default luminance
    # scaling preserves hue by scaling all channels together)
    lum = torch.amax(nits, dim=-1, keepdim=True)
    scale = _eetf_2390(lum, float(target_nits), float(source_peak_nits)) / torch.clamp(lum, min=1e-6)
    mapped = nits * scale / float(target_nits)
    rgb709 = torch.clamp(apply_matrix(mapped, BT2020_TO_BT709), 0.0, 1.0)
    return torch.pow(rgb709, 1.0 / 2.4).cpu().numpy()  # BT.1886 inverse (ops/color.py)


def cas_sharpen(rgb01: np.ndarray, strength: float) -> np.ndarray:
    """Contrast-adaptive sharpening (AMD FidelityFX CAS) — the display
    path's HDR-upscale sharpener tier (pipeline/scaling.py
    select_cas_strength; the reference attaches CAS via mpv GLSL)."""
    if strength <= 0.0:
        return rgb01
    x = np.asarray(rgb01, np.float32)
    p = np.pad(x, ((1, 1), (1, 1), (0, 0)), mode="edge")
    n = p[:-2, 1:-1]
    s = p[2:, 1:-1]
    w = p[1:-1, :-2]
    e = p[1:-1, 2:]
    cross = np.stack([x, n, s, w, e])
    mn, mx = cross.min(axis=0), cross.max(axis=0)
    amp = np.sqrt(np.clip(np.minimum(mn, 1.0 - mx) / np.maximum(mx, 1e-5), 0.0, 1.0))
    peak = -1.0 / (8.0 - 3.0 * float(np.clip(strength, 0.0, 1.0)))
    wgt = amp * peak
    out = (wgt * (n + s + w + e) + x) / (4.0 * wgt + 1.0)
    return np.clip(out, 0.0, 1.0)


def resize_rgb01(rgb01: np.ndarray, out_w: int, out_h: int, *, device=None) -> np.ndarray:
    """Antialiased-bicubic resample via the device matmul path (ops/resize)
    on ``device``."""
    import torch

    from hdrtv_tpu_torch.utils.device import compute_device
    from hdrtv_tpu_torch.models.layers import fp32_math
    from hdrtv_tpu_torch.ops.resize import resize_bicubic_aa

    h, w = rgb01.shape[:2]
    if (w, h) == (out_w, out_h):
        return np.asarray(rgb01, np.float32)
    x = torch.from_numpy(np.ascontiguousarray(rgb01, np.float32)).to(compute_device(device))
    with fp32_math():
        y = resize_bicubic_aa(x[None], out_h, out_w)[0]
    return np.clip(y.cpu().numpy(), 0.0, 1.0)


def _read_rgb01(path: str, kind: str) -> np.ndarray:
    import cv2

    if kind == "sdr":
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return img[..., ::-1].astype(np.float32) / 255.0
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.dtype == np.uint8:
        img = img.astype(np.uint16) * 257
    return img[..., ::-1].astype(np.float32) / 65535.0


def render_frame(
    frame_dir: str,
    kind: str,
    *,
    render_size: tuple[int, int] | None = None,
    scale: str | None = None,
    png_depth: int = 8,
    target_nits: float = TARGET_NITS,
    source_peak_nits: float = SOURCE_PEAK_NITS,
    device=None,
) -> np.ndarray:
    """Render one artifact to display-referred [0,1] RGB at render_size,
    the tone map and the resample on ``device``."""
    from hdrtv_tpu_torch.pipeline.scaling import select_cas_strength, select_scale_kernel

    rgb = _read_rgb01(os.path.join(frame_dir, FRAME_FILES[kind]), kind)
    if kind != "sdr":
        rgb = tone_map_pq(
            rgb, target_nits=target_nits, source_peak_nits=source_peak_nits, device=device
        )
    h, w = rgb.shape[:2]
    if render_size:
        out_w, out_h = render_size
        kernel = select_scale_kernel(w, h, out_w, out_h, scale)
        rgb = resize_rgb01(rgb, out_w, out_h, device=device)
        if kind != "sdr":
            rgb = cas_sharpen(
                rgb,
                select_cas_strength(
                    w, h, out_w, out_h,
                    using_fsr=(kernel == "fsr"), scale_kernel=kernel,
                ),
            )
    del png_depth  # depth applies at write time
    return rgb


def _to_png_array(rgb01: np.ndarray, png_depth: int) -> np.ndarray:
    if int(png_depth) == 16:
        return (np.clip(rgb01, 0.0, 1.0) * 65535.0 + 0.5).astype(np.uint16)
    return (np.clip(rgb01, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _label_bar(width: int, label: str, dtype) -> np.ndarray:
    import cv2

    white = 65535 if dtype == np.uint16 else 255
    bar = np.zeros((28, width, 3), dtype)
    cv2.putText(
        bar, label, (8, 20), cv2.FONT_HERSHEY_SIMPLEX, 0.55,
        (white, white, white), 1, cv2.LINE_AA,
    )
    return bar


def write_contact_sheet(rendered: dict[str, np.ndarray], out_path: str) -> None:
    """Labeled side-by-side sheet (reference :318-370: label bar per column,
    4-px separator)."""
    import cv2

    cols = []
    dtype = next(iter(rendered.values())).dtype
    max_h = max(a.shape[0] for a in rendered.values())
    for kind, arr in rendered.items():
        pad = max_h - arr.shape[0]
        if pad:
            arr = np.pad(arr, ((0, pad), (0, 0), (0, 0)))
        cols.append(np.vstack([_label_bar(arr.shape[1], kind, dtype), arr]))
    sep = np.zeros((cols[0].shape[0], 4, 3), dtype)
    sheet = cols[0]
    for col in cols[1:]:
        sheet = np.hstack([sheet, sep, col])
    cv2.imwrite(out_path, sheet[..., ::-1])


def render_session(
    input_path: str,
    out_dir: str,
    *,
    kinds=DEFAULT_KINDS,
    render_size: tuple[int, int] | None = None,
    scale: str | None = None,
    png_depth: int = 8,
    sheet: bool = True,
    target_nits: float = TARGET_NITS,
    source_peak_nits: float = SOURCE_PEAK_NITS,
    device=None,
) -> dict:
    """Render every discovered frame dir on ``device``; returns the
    manifest dict."""
    import cv2

    kinds = [k for k in kinds if k in FRAME_FILES]
    frame_dirs, root = discover_frame_dirs(input_path, kinds)
    os.makedirs(out_dir, exist_ok=True)
    entries = []
    for fdir in frame_dirs:
        rel = os.path.relpath(fdir, root)
        name = "frame" if rel == "." else rel.replace(os.sep, "__")
        fout = os.path.join(out_dir, name)
        os.makedirs(fout, exist_ok=True)
        rendered, files = {}, {}
        for kind in kinds:
            rgb = render_frame(
                fdir, kind, render_size=render_size, scale=scale,
                png_depth=png_depth, target_nits=target_nits,
                source_peak_nits=source_peak_nits, device=device,
            )
            arr = _to_png_array(rgb, png_depth)
            path = os.path.join(fout, f"{kind}.png")
            cv2.imwrite(path, arr[..., ::-1])
            rendered[kind] = arr
            files[kind] = path
        if sheet and len(rendered) > 1:
            sheet_path = os.path.join(fout, "contact_sheet.png")
            write_contact_sheet(rendered, sheet_path)
            files["contact_sheet"] = sheet_path
        entries.append({"source_dir": fdir, "outputs": files})
    manifest = {
        "input": os.path.abspath(input_path),
        "kinds": list(kinds),
        "render_size": list(render_size) if render_size else None,
        "scale": scale,
        "png_depth": int(png_depth),
        "target_nits": target_nits,
        "source_peak_nits": source_peak_nits,
        "frames": entries,
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest
