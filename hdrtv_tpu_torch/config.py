"""Typed configuration: precision + resolution presets, env overrides (the
port's copy of ``hdrtv_tpu/config.py``).

Consolidates the reference's three config tiers (static preset tables in
gui_config.py, ~90 ``HDRTVNET_*`` env vars, argparse CLIs — SURVEY.md §5)
into one module. Preset names, precision tokens and env names are the JAX
package's, so the CLI resolves the same checkpoints; weight paths resolve
against ``HDRTVNET_WEIGHTS_ROOT``, else ``~/.cache/hdrtv_tpu/weights`` (the
reference tree's layout below it, gui_config.py:19-160). The JAX package
first tries a fixed path of the reference tree; the port does not.

Additions over the reference: a ``4K`` processing preset (the reference tops
out at 1080p, gui_config.py:300) and bf16 as the fp16-analog compute dtype.
"""

from __future__ import annotations

import dataclasses
import os

from hdrtv_tpu_torch.utils.env import env_bool, env_int, env_str


def weights_root() -> str:
    root = env_str("HDRTVNET_WEIGHTS_ROOT")
    if root:
        return root
    return os.path.join(os.path.expanduser("~"), ".cache", "hdrtv_tpu", "weights")


def _weight(name: str) -> str:
    return os.path.join(weights_root(), name)


@dataclasses.dataclass(frozen=True)
class PrecisionPreset:
    """One row of the reference PRECISIONS table (gui_config.py:19-160)."""

    key: str
    precision: str  # fp32 | fp16 | int8-mixed | int8-full | fp8-mixed | fp8-full
    model: str  # HG-composite source checkpoint
    model_nohg: str
    hg_weights: str | None = None
    requires_fp8: bool = False


def _int8(kind: str, name: str) -> tuple[str, str]:
    # HG-composite base weights: the reference's eager path points at
    # pytorch_int8/hg/… which ships in neither repo; its TensorRT source
    # checkpoints (gui_config.py trt_model, original/tensorrt/hr_hg/…) DO
    # ship and carry the same AGCM+LE base contract — prefer whichever
    # exists (PTQ variants are named *_ptq there for the non-QAT rows).
    eager_hg = _weight(f"original/pytorch_int8/hg/HR_HG_original_int8_{name}.pt")
    trt_name = name if name.endswith(("qat", "qat_film")) else f"{name}_ptq"
    trt_hg = _weight(f"original/tensorrt/hr_hg/HR_HG_original_int8_{trt_name}.pt")
    hg = eager_hg if os.path.isfile(eager_hg) else trt_hg
    return (
        hg,
        _weight(f"original/pytorch_int8/hr/HR_original_int8_{name}.pt"),
    )


PRECISIONS: dict[str, PrecisionPreset] = {}


def _add(key, precision, model, model_nohg, hg=None, fp8=False):
    PRECISIONS[key] = PrecisionPreset(key, precision, model, model_nohg, hg, fp8)


_add("FP16", "fp16", _weight("original/HR.pt"), _weight("original/HR.pt"), _weight("original/HG.pt"))
_add("FP32", "fp32", _weight("original/HR.pt"), _weight("original/HR.pt"), _weight("original/HG.pt"))
for label, name in [
    ("INT8 Mixed (PTQ)", "mixed"),
    ("INT8 Mixed (QAT)", "mixed_qat"),
    ("INT8 Mixed (QAT) (Film)", "mixed_qat_film"),
    ("INT8 Full (PTQ)", "full"),
    ("INT8 Full (QAT)", "full_qat"),
    ("INT8 Full (QAT) (Film)", "full_qat_film"),
]:
    hg_model, nohg_model = _int8("hg", name)
    _add(label, "int8-mixed" if "Mixed" in label else "int8-full", hg_model, nohg_model)

# FP8 presets: the reference ships 12 FP8 source checkpoints carrying FP32
# tensors + the matching INT8 composition; ModelOpt emits FP8 Q/DQ at engine
# build (gui_config.py:94-160, fp8_source_note). The JAX importer reproduces
# the FP8 numerics at load (float8_e4m3 weight roundtrip) and computes in bf16,
# and so does the port (models/import_torch.py, torch.float8_e4m3fn).
for label, name in [
    ("FP8 Mixed (PTQ)", "mixed_ptq"),
    ("FP8 Mixed (QAT)", "mixed_qat"),
    ("FP8 Mixed (QAT) (Film)", "mixed_qat_film"),
    ("FP8 Full (PTQ)", "full_ptq"),
    ("FP8 Full (QAT)", "full_qat"),
    ("FP8 Full (QAT) (Film)", "full_qat_film"),
]:
    _add(
        label,
        "fp8-mixed" if "Mixed" in label else "fp8-full",
        _weight(f"original/tensorrt_fp8/hr_hg/HR_HG_original_fp8_{name}.pt"),
        _weight(f"original/tensorrt_fp8/hr/HR_original_fp8_{name}.pt"),
        fp8=True,
    )

DEFAULT_PRECISION_KEY = "INT8 Mixed (QAT)"
DEFAULT_RESOLUTION_KEY = "1080p"
DEFAULT_USE_HG = False

# Processing resolution presets. 4K is an extension beyond the reference's
# 1080p ceiling (BASELINE.md north star: 4K60 on one accelerator).
RESOLUTION_SCALES: dict[str, tuple[int, int] | None] = {
    "4K": (3840, 2160),
    "1080p": (1920, 1080),
    "720p": (1280, 720),
    "540p": (960, 540),
}

MAX_W, MAX_H = 3840, 2160


def processing_dims(resolution_key: str) -> tuple[int, int]:
    dims = RESOLUTION_SCALES.get(str(resolution_key or "")) or (1920, 1080)
    return int(dims[0]), int(dims[1])


def max_processing_preset_for_source(src_w: int, src_h: int) -> str:
    """Smallest preset that contains the source (gui_config.py:441-452)."""
    order = ("540p", "720p", "1080p", "4K")
    for key in order:
        pw, ph = processing_dims(key)
        if src_w <= pw and src_h <= ph:
            return key
    return "4K"


def select_model_path(precision_key: str, use_hg: bool) -> str:
    cfg = PRECISIONS.get(precision_key)
    if cfg is None:
        raise KeyError(f"unknown precision preset '{precision_key}'")
    return cfg.model if use_hg else (cfg.model_nohg or cfg.model)


def select_hg_weights_path(precision_key: str) -> str | None:
    cfg = PRECISIONS.get(precision_key)
    return cfg.hg_weights if cfg else None


def _norm_key(s: str) -> str:
    import re

    return re.sub(r"[^a-z0-9]+", "-", str(s).lower()).strip("-")


def resolve_precision_key(name: str | None) -> str | None:
    """Accept GUI labels AND the reference CLI's short run names
    (cli_playback_benchmark.py:72-260 `_RUN_PRESETS`: fp16, int8-mixed-qat,
    fp8-full-qat-film, …). Returns the canonical PRECISIONS key, or the
    input unchanged when nothing matches (callers handle unknown keys)."""
    if name is None or name in PRECISIONS:
        return name
    want = _norm_key(name)
    for key in PRECISIONS:
        if _norm_key(key) == want:
            return key
    # short forms drop the parentheses order: "int8-mixed-qat" ≡
    # "INT8 Mixed (QAT)"; film variants append "-film"
    for key in PRECISIONS:
        if _norm_key(key).replace("-", "") == want.replace("-", ""):
            return key
    return name


def show_fp8() -> bool:
    """FP8 preset visibility (HDRTVNET_SHOW_FP8). The reference hides FP8
    behind the flag + an RTX 40/50 check (gui_config.py:255-262); here FP8
    executes everywhere via e4m3 weight emulation, so the default is ON and
    the flag only hides the rows."""
    return env_bool("HDRTVNET_SHOW_FP8", True)


def precision_is_available(precision_key: str) -> bool:
    """Preset availability: FP8 visibility gate + at least one weight file
    present (gui_config.py:260-278 `_precision_is_available`)."""
    cfg = PRECISIONS.get(precision_key)
    if cfg is None:
        return False
    if cfg.requires_fp8 and not show_fp8():
        return False
    return any(
        p and os.path.isfile(p) for p in (cfg.model, cfg.model_nohg)
    )


def available_precisions() -> list[str]:
    return [k for k in PRECISIONS if precision_is_available(k)]


# Host-pipeline knobs (names preserved from gui_config.py:380-400).
VIDEO_PLAYBACK_BUFFER_FRAMES = env_int("HDRTVNET_VIDEO_PLAYBACK_BUFFER_FRAMES", 3, lo=1, hi=24)
LIVE_CAPTURE_PROCESS_FPS = env_int("HDRTVNET_LIVE_CAPTURE_PROCESS_FPS", 24, lo=1, hi=120)
