"""Display scaling policy — upscale kernel/antiring/sharpen selection (the
port's copy of ``hdrtv_tpu/pipeline/scaling.py``).

The reference picks the mpv scale kernel, antiring strength and CAS
sharpening per (processing → output) resolution pair and upscaler choice
(gui_scaling.py:69-157), letterboxes frames to the processing resolution
(:228) and fits outputs into bounding boxes (:47-60). Those decisions are
pure functions, reproduced here and consumed by the mpv sinks; the GLSL
shader chain (FSR/SSimSuperRes) maps to mpv ``--glsl-shaders`` when shader
files are present locally (no network downloads here).
"""

from __future__ import annotations

import numpy as np

BEST_MPV_SCALE = "ewa_lanczossharp"
UPSCALER_CHOICES = ("ewa_lanczossharp", "fsr", "ssim_superres")
DEFAULT_UPSCALER = "fsr"


def fit_with_aspect(src_w: int, src_h: int, max_w: int, max_h: int) -> tuple[int, int]:
    """Fit into a bounding box preserving aspect; never upscale; even dims
    (gui_scaling.py:47-60)."""
    src_w, src_h = max(1, int(src_w)), max(1, int(src_h))
    scale = min(max(1, int(max_w)) / src_w, max(1, int(max_h)) / src_h, 1.0)
    out_w = max(2, int(round(src_w * scale)))
    out_h = max(2, int(round(src_h * scale)))
    return max(2, out_w - out_w % 2), max(2, out_h - out_h % 2)


def is_upscale_required(proc_w: int, proc_h: int, target_w: int, target_h: int) -> bool:
    """True when the processing frame grows on the target (gui_scaling.py:150)."""
    return proc_w > 0 and proc_h > 0 and target_w > proc_w and target_h > proc_h


def normalize_upscale_choice(choice: str | None) -> str:
    c = str(choice or "").strip().lower()
    if "fsr" in c:
        return "fsr"
    if "ssim" in c:
        return "ssim_superres"
    return BEST_MPV_SCALE


def select_scale_kernel(
    proc_w: int, proc_h: int, out_w: int, out_h: int, upscale_choice: str | None = None
) -> str:
    """mpv scale kernel: bicubic when no upscale, else the chosen upscaler
    (gui_scaling.py:69-80)."""
    if not is_upscale_required(proc_w, proc_h, out_w, out_h):
        return "bicubic"
    return normalize_upscale_choice(upscale_choice) if upscale_choice else BEST_MPV_SCALE


def select_scale_antiring(
    proc_w: int, proc_h: int, out_w: int, out_h: int, scale_kernel: str | None = None
) -> float:
    """Antiring strength by processing resolution and kernel
    (gui_scaling.py:83-111 exact tiers)."""
    if not is_upscale_required(proc_w, proc_h, out_w, out_h):
        return 0.0
    k = str(scale_kernel or "").strip().lower()
    if k == "fsr":
        max_ratio = max(out_w / max(1, proc_w), out_h / max(1, proc_h))
        if max_ratio > 2.01:
            return 0.16 if (proc_h <= 720 or proc_w <= 1280) else 0.10
        return 0.0
    if "ssim" in k:
        return 0.0
    if proc_h <= 540 or proc_w <= 960:
        base = 0.30
    elif proc_h <= 720 or proc_w <= 1280:
        base = 0.22
    else:
        base = 0.10
    if "lanczossharp" in k or k == "ewa_lanczos":
        return max(0.0, base - 0.05)
    return base


def select_cas_strength(
    proc_w: int, proc_h: int, out_w: int, out_h: int,
    *, using_fsr: bool = False, scale_kernel: str | None = None,
) -> float:
    """CAS sharpening strength for HDR upscale (gui_scaling.py:113-138)."""
    if not is_upscale_required(proc_w, proc_h, out_w, out_h):
        return 0.0
    if using_fsr:
        return 0.0
    k = str(scale_kernel or "").strip().lower()
    if "ssim" in k:
        return 0.0
    if proc_h <= 540 or proc_w <= 960:
        base = 0.22
    elif proc_h <= 720 or proc_w <= 1280:
        base = 0.20
    else:
        base = 0.16
    if "lanczossharp" in k or k == "ewa_lanczos":
        return base + 0.02
    return base


_SHADER_FILES = {
    "fsr": "FSR.glsl",
    "ssim_superres": "SSimSuperRes.glsl",
    "ssim_downscaler": "SSimDownscaler.glsl",
    "filmgrain": "filmgrain.glsl",
}


def shader_path(kernel: str, shader_dir: str | None = None) -> str | None:
    """Local GLSL shader for a shader-based upscaler, if present.

    The reference downloads FSR/SSimSuperRes on demand (gui_scaling.py
    `_ensure_*_shader`); the package downloads nothing, so shaders are
    user-provided under ``assets/shaders/`` (HDRTVNET_SHADER_DIR overrides).
    """
    import os

    from hdrtv_tpu_torch.utils.env import env_str

    name = _SHADER_FILES.get(kernel)
    if not name:
        return None
    base = shader_dir or env_str("HDRTVNET_SHADER_DIR", "") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "assets", "shaders",
    )
    path = os.path.join(base, name)
    return path if os.path.isfile(path) else None


def downscale_kernel(*, hdr: bool = True) -> str:
    """mpv dscale kernel policy (gui_mpv_widget.py:205-212): mitchell by
    default; ``HDRTVNET_MPV_DSCALE`` tunes the HDR pane,
    ``HDRTVNET_MPV_SDR_DSCALE`` the SDR pane (no cross-inheritance);
    none/off disables."""
    import os

    fallback = os.environ.get("HDRTVNET_MPV_DSCALE", "mitchell")
    name = "HDRTVNET_MPV_DSCALE" if hdr else "HDRTVNET_MPV_SDR_DSCALE"
    value = str(os.environ.get(name, fallback if hdr else "mitchell"))
    value = value.strip().lower().replace("-", "_")
    if value in {"", "none", "no", "off"}:
        return ""
    return value


def downscale_antiring(*, hdr: bool = True) -> float:
    """dscale antiring (gui_mpv_widget.py:215-228): 0.20 default."""
    from hdrtv_tpu_torch.utils.env import env_float

    name = "HDRTVNET_MPV_DSCALE_ANTIRING" if hdr else "HDRTVNET_MPV_SDR_DSCALE_ANTIRING"
    return env_float(name, 0.20, lo=0.0, hi=1.0)


def shader_chain(
    kernel: str, *, film_grain: bool = False, shader_dir: str | None = None,
) -> list[str]:
    """GLSL shader paths in the reference's chain order
    (gui_mpv_widget.py:371-388 ``_build_shader_paths``): SSimDownscaler →
    upscaler shader (FSR / SSimSuperRes) → film grain. Each entry is included
    only when the local file exists (the reference downloads on demand;
    the package does not), and SSimDownscaler obeys ``HDRTVNET_MPV_SSIM_DOWNSCALER``
    (default on, gui_mpv_widget.py:940-943)."""
    from hdrtv_tpu_torch.utils.env import env_bool

    chain: list[str] = []
    if env_bool("HDRTVNET_MPV_SSIM_DOWNSCALER", True):
        p = shader_path("ssim_downscaler", shader_dir)
        if p:
            chain.append(p)
    if kernel in ("fsr", "ssim_superres"):
        p = shader_path(kernel, shader_dir)
        if p:
            chain.append(p)
    if film_grain:
        p = shader_path("filmgrain", shader_dir)
        if p:
            chain.append(p)
    return chain


def mpv_scale_args(
    proc_w: int, proc_h: int, out_w: int, out_h: int, upscale_choice: str | None = None,
    *, shader_dir: str | None = None, film_grain: bool = False, hdr: bool = True,
) -> list[str]:
    """The mpv flag set implementing the policy above. FSR/SSimSuperRes are
    shader-based: with a local GLSL file the shader chain is applied
    (``--glsl-shaders``, the reference's shader path); without one the EWA
    kernel is the honest substitute. The chain also carries SSimDownscaler
    and the optional film-grain shader (gui_mpv_widget.py:371-388), and the
    dscale kernel/antiring pair rides along unconditionally
    (gui_mpv_widget.py:571-574)."""
    kernel = select_scale_kernel(proc_w, proc_h, out_w, out_h, upscale_choice)
    upscale_shader = kernel in ("fsr", "ssim_superres")
    chain = shader_chain(kernel, film_grain=film_grain, shader_dir=shader_dir)
    has_upscale_shader = any(
        c.endswith(_SHADER_FILES[kernel]) for c in chain
    ) if upscale_shader else False
    if upscale_shader and not has_upscale_shader:
        mpv_kernel = BEST_MPV_SCALE  # shader absent → best built-in kernel
    elif kernel == "fsr":
        # residual scale after FSR's EASU pass (gui_mpv_widget.py:595-600)
        mpv_kernel = BEST_MPV_SCALE
    elif upscale_shader:
        # SSimSuperRes pairs with spline36 (gui_mpv_widget.py:588-590)
        mpv_kernel = "spline36"
    else:
        mpv_kernel = kernel
    antiring = select_scale_antiring(proc_w, proc_h, out_w, out_h, kernel)
    args = [f"--scale={mpv_kernel}"]
    for p in chain:
        args.append(f"--glsl-shader={p}")  # singular form appends to the chain
    if antiring > 0:
        args.append(f"--scale-antiring={antiring:.2f}")
    dscale = downscale_kernel(hdr=hdr)
    if dscale:
        args.append(f"--dscale={dscale}")
        args.append(f"--dscale-antiring={downscale_antiring(hdr=hdr):.2f}")
    return args


def letterbox_bgr(frame: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Host-side aspect-preserving resize + black pad to exact output size
    (gui_scaling.py:228 `_letterbox_bgr`; the device-side equivalent lives in
    ops/resize.py and is used on the hot path)."""
    import cv2

    h, w = frame.shape[:2]
    if w == out_w and h == out_h:
        return frame
    scale = min(out_w / max(w, 1), out_h / max(h, 1))
    new_w, new_h = max(1, int(round(w * scale))), max(1, int(round(h * scale)))
    interp = cv2.INTER_AREA if scale < 1.0 else cv2.INTER_CUBIC
    resized = cv2.resize(frame, (new_w, new_h), interpolation=interp)
    canvas = np.zeros((out_h, out_w, 3), dtype=frame.dtype)
    x, y = (out_w - new_w) // 2, (out_h - new_h) // 2
    canvas[y : y + new_h, x : x + new_w] = resized
    return canvas
