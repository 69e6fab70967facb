"""INT8 weight/activation quantization over flat parameter dicts (the
port's copy of ``hdrtv_tpu/quant/int8.py``: numpy only, same numerics).

Numerics mirror the reference eager-INT8 modules exactly
(hdrtvnet_torch.py:233-445):

- weights: per-output-channel symmetric, scale = amax/127, round+clamp
  (W8Conv2d/W8A8Conv2d constructor math);
- activations: per-tensor symmetric (scale = amax/127) or asymmetric
  (zero-point + range/255), scales held fp32;
- pre-dequantize: int8 storage expanded to float once at load — compressed
  checkpoints, full-speed compute (hdrtvnet_torch.py:444-512).

Because the JAX package routes quantization *by checkpoint content* (its
models/layers.py conv2d), "quantizing a model" is a dict transform: replace
``{l}.weight`` with ``{l}.weight_int8`` (+ scales) for the selected layers.
"""

from __future__ import annotations

import numpy as np

# Layers never quantized (I/O heads). The reference excludes LE.conv_last /
# hg.low_out in its ModelOpt include/exclude policy (SURVEY.md §2.2) and its
# mixed recipes keep AGCM heads in fp16.
DEFAULT_EXCLUDE_SUFFIXES = ("LE.conv_last", "hg.low_out", "hg.conv_last")


def quantizable_layers(params: dict) -> list[str]:
    """Conv/Linear layer names present in a param pytree (fp or int8)."""
    names = set()
    for k in params:
        if k.endswith(".weight") and params[k].ndim in (2, 4):
            names.add(k[: -len(".weight")])
        elif k.endswith(".weight_int8"):
            names.add(k[: -len(".weight_int8")])
    return sorted(names)


def quantize_weight(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-out-channel symmetric int8: HWIO/(in,out) layout, O = last axis.

    scale = amax/127 over all non-output axes (clamp 1e-8); int8 = round+clamp.
    """
    w = np.asarray(w, dtype=np.float32)
    axes = tuple(range(w.ndim - 1))
    scale = np.maximum(np.abs(w).max(axis=axes), 1e-8) / 127.0
    q = np.clip(np.round(w / scale), -128, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_params(
    params: dict,
    layers: list[str] | None = None,
    *,
    mode: str = "w8a8",
    asymmetric: bool = False,
    exclude: tuple[str, ...] = DEFAULT_EXCLUDE_SUFFIXES,
) -> dict:
    """Return a new pytree with the selected layers int8-quantized.

    ``mode``: "w8" (weight-only) or "w8a8" (adds x_scale placeholders — run
    quant.calibrate afterwards to set them).
    """
    if layers is None:
        layers = [l for l in quantizable_layers(params) if not l.endswith(exclude)]
    out = dict(params)
    for layer in layers:
        wk = f"{layer}.weight"
        if wk not in out:
            continue  # already quantized or missing
        q, scale = quantize_weight(out.pop(wk))
        out[f"{layer}.weight_int8"] = q
        if mode == "w8":
            out[f"{layer}.scale"] = scale
        else:
            out[f"{layer}.w_scale"] = scale
            out[f"{layer}.x_scale"] = np.float32(1.0)
            if asymmetric:
                out[f"{layer}.x_zero"] = np.float32(0.0)
    return out


def predequantize_params(params: dict) -> dict:
    """Expand every int8 layer back to float weights (pre-dequantize mode)."""
    out = dict(params)
    for k in list(out):
        if not k.endswith(".weight_int8"):
            continue
        layer = k[: -len(".weight_int8")]
        scale = out.pop(f"{layer}.w_scale", None)
        if scale is None:
            scale = out.pop(f"{layer}.scale")
        q = out.pop(k)
        out[f"{layer}.weight"] = q.astype(np.float32) * np.asarray(scale, np.float32)
        out.pop(f"{layer}.x_scale", None)
        out.pop(f"{layer}.x_zero", None)
    return out


def quantized_layer_summary(params: dict) -> dict[str, str]:
    """layer → 'w8a8' | 'w8a8-asym' | 'w8' | 'fp' (checkpoint contract checks,
    e.g. Full-INT8 'no fallback layers', README.md:69)."""
    summary = {}
    for layer in quantizable_layers(params):
        if f"{layer}.weight_int8" in params:
            if f"{layer}.x_zero" in params:
                summary[layer] = "w8a8-asym"
            elif f"{layer}.x_scale" in params:
                summary[layer] = "w8a8"
            else:
                summary[layer] = "w8"
        else:
            summary[layer] = "fp"
    return summary


def load_mixed_layout(path: str) -> list[str]:
    """Parse a configs/qat_layouts/*.txt layer list (one name per line,
    '#' comments — original_nohg_mixed_w8a8.txt:1-32)."""
    layers = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                layers.append(line)
    return layers
