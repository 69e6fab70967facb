"""Reference checkpoint import (port of ``hdrtv_tpu/models/import_torch.py``):
torch ``.pt`` state dicts → the flat NHWC parameter dicts the port runs.

Reads the reference's fp32 ``HR.pt`` layouts, its composite HR + HG
checkpoints (or an HR file with the HG generator's own file beside it), and
its FP8 source checkpoints, and converts them as the JAX package does:

- the classifier variants' key remaps (woIN's Sequential renumbering, lite's
  width slices, lowrank's SVD factorisation of HRconv), on the torch layout;
- the HG generator's eval-mode BatchNorms folded into the preceding convs;
- the FP8 sources' quantized layers rounded through float8 e4m3 numerics;
- conv weights OIHW → HWIO, linear weights (out, in) → (in, out), fp16
  buffers upcast to fp32 (``models/import_npz.py convert_state``).

Every step runs in numpy (fp32, or float64 for the SVD) in the JAX package's
order, so the parameters equal its ``load_checkpoint``'s byte for byte; torch
serves as the deserializer and, for the FP8 rounding, as the float8 type
(``torch.float8_e4m3fn``, where the JAX package uses ``ml_dtypes``). The
``.npz`` helpers live in ``models/import_npz.py``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from hdrtv_tpu_torch.models.agcm import agcm_lite_width, agcm_lowrank_rank, normalize_classifier_name
from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig
from hdrtv_tpu_torch.models.import_npz import convert_state, load_npz, load_npz_meta, save_npz

_META_KEYS = (
    "compute_dtype",
    "quantization",
    "qat_strategy",
    "channel_threshold",
    "qat_epochs",
    "qat_lr",
    "qat_recipe",
    "architecture",
    "w8a8_layers",
    "selection_mode",
    "auto_selection",
    "fp16_layers",
    "activation_quant",
    "checkpoint_format",
    "state_format",
    "backend_neutral",
    "target_backend",
    "tensorrt_source_checkpoint",
    "tensorrt_source_schema",
    "tensorrt_source_signature",
    "fp8_source_schema",
    "fp8_source_note",
    "calibration_method",
)


def _to_numpy(t: Any) -> np.ndarray:
    """A tensor (or array) as a host numpy array, fp16 upcast to fp32."""
    arr = t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)
    if arr.dtype == np.float16:
        arr = arr.astype(np.float32)
    return arr


def load_torch_file(path: str) -> tuple[dict[str, np.ndarray], dict[str, Any]]:
    """Load a reference checkpoint: (raw torch-layout state, metadata).

    A container (a dict with ``state_dict``) gives its ``_META_KEYS`` as the
    metadata, and the names of its ``weight_qparams`` as
    ``quantized_layers`` (the FP8 sources' quantized layer set; the qparams
    tensors stay behind); a bare state dict gives none. ``weights_only``
    loading is tried first, as in the JAX package."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        obj = torch.load(path, map_location="cpu", weights_only=False)

    meta: dict[str, Any] = {}
    if isinstance(obj, dict) and "state_dict" in obj:
        state = obj["state_dict"]
        for k in _META_KEYS:
            if k in obj:
                meta[k] = obj[k]
        if isinstance(obj.get("weight_qparams"), dict):
            meta["quantized_layers"] = [str(k) for k in obj["weight_qparams"]]
    else:
        state = obj
    return {str(k): _to_numpy(v) for k, v in state.items() if hasattr(v, "shape")}, meta


def remap_condition_state(state: dict[str, np.ndarray], prefix: str = "",
                          classifier: str = "color_condition") -> dict[str, np.ndarray]:
    """The key remaps of the woIN, lite and lowrank classifier variants, on
    the torch-layout state (before ``convert_state``):

    - lowrank r: a full-rank 1×1 ``HRconv`` factored by numpy's SVD (float64)
      into ``HRconv_reduce`` (√s·Vᴴ, zero bias) and ``HRconv_expand`` (U·√s,
      HRconv's bias);
    - lite w: the AGCM's convs and cond heads sliced to their first w
      channels;
    - woIN: the classifier's Sequential indices renumbered with the
      InstanceNorms (3, 7, 11, 15) dropped.
    Any other classifier's state comes back as it is (a copy of the dict)."""
    classifier = normalize_classifier_name(classifier)

    rank = agcm_lowrank_rank(classifier)
    if rank is not None:
        mapped = dict(state)
        w_key, b_key = f"{prefix}HRconv.weight", f"{prefix}HRconv.bias"
        if w_key in mapped and f"{prefix}HRconv_reduce.weight" not in mapped:
            weight = mapped.pop(w_key).astype(np.float64)
            bias = mapped.pop(b_key, None)
            matrix = weight.reshape(weight.shape[0], weight.shape[1])
            u, s, vh = np.linalg.svd(matrix, full_matrices=False)
            r = min(int(rank), int(s.size))
            sqrt_s = np.sqrt(np.clip(s[:r], 0.0, None))
            mapped[f"{prefix}HRconv_reduce.weight"] = (
                (sqrt_s[:, None] * vh[:r, :]).reshape(r, weight.shape[1], 1, 1).astype(np.float32)
            )
            mapped[f"{prefix}HRconv_reduce.bias"] = np.zeros(r, np.float32)
            mapped[f"{prefix}HRconv_expand.weight"] = (
                (u[:, :r] * sqrt_s[None, :]).reshape(weight.shape[0], r, 1, 1).astype(np.float32)
            )
            mapped[f"{prefix}HRconv_expand.bias"] = (
                np.zeros(weight.shape[0], np.float32) if bias is None else bias.astype(np.float32)
            )
        return mapped

    lite = agcm_lite_width(classifier)
    if lite is not None:
        mapped = dict(state)

        def _slice(key, *slices):
            full = f"{prefix}{key}"
            if full in mapped and hasattr(mapped[full], "ndim"):
                mapped[full] = np.ascontiguousarray(mapped[full][tuple(slices)])

        for name in ("cond_scale_first.weight", "cond_scale_HR.weight", "cond_shift_first.weight",
                     "cond_shift_HR.weight"):
            _slice(name, slice(0, lite), slice(None))
        for name in ("cond_scale_first.bias", "cond_scale_HR.bias", "cond_shift_first.bias", "cond_shift_HR.bias",
                     "conv_first.weight", "conv_first.bias", "HRconv.bias"):
            _slice(name, slice(0, lite))
        _slice("HRconv.weight", slice(0, lite), slice(0, lite), slice(None), slice(None))
        _slice("conv_last.weight", slice(None), slice(0, lite), slice(None), slice(None))
        return mapped

    if classifier != "color_condition_woin":
        return dict(state)

    mapped = dict(state)
    root = f"{prefix}classifier.model."
    if not any(k.startswith(f"{root}20.") for k in mapped):
        return mapped
    drop = tuple(f"{root}{i}." for i in (3, 7, 11, 15))
    index_map = {"4": "3", "8": "6", "12": "9", "16": "12", "20": "16"}
    for key in list(mapped):
        if key.startswith(drop):
            mapped.pop(key, None)
            continue
        for old, new in index_map.items():
            op = f"{root}{old}."
            if key.startswith(op):
                mapped[f"{root}{new}.{key[len(op):]}"] = mapped.pop(key)
                break
    return mapped


HG_BN_BLOCKS = ("conv1", "conv2", "conv3_1", "conv3_2", "conv4_1", "conv4_2", "conv5_1", "conv5_2",
                "conv_code1", "conv_code2")


def fold_hg_batchnorm(state: dict[str, np.ndarray], prefix: str = "hg.", eps: float = 1e-5) -> dict[str, np.ndarray]:
    """Fold the HG encoder's eval-mode BatchNorms into the preceding convs
    (the reference's fusedbn), on the torch-layout (OIHW) state, in numpy
    fp32: ``w · γ/√(var + ε)`` and ``(b − mean) · γ/√(var + ε) + β``. A block
    without all four statistics is left as it is."""
    mapped = dict(state)
    for block in HG_BN_BLOCKS:
        base = f"{prefix}{block}"
        keys = {s: f"{base}.1.{s}" for s in ("weight", "bias", "running_mean", "running_var")}
        if not all(k in mapped for k in keys.values()):
            continue
        conv_w = mapped[f"{base}.0.weight"].astype(np.float32)
        conv_b = mapped.get(f"{base}.0.bias")
        conv_b = np.zeros(conv_w.shape[0], np.float32) if conv_b is None else conv_b.astype(np.float32)
        inv_std = 1.0 / np.sqrt(mapped[keys["running_var"]].astype(np.float32) + eps)
        scale = mapped[keys["weight"]].astype(np.float32) * inv_std
        mapped[f"{base}.0.weight"] = conv_w * scale.reshape(-1, 1, 1, 1)
        mapped[f"{base}.0.bias"] = (conv_b - mapped[keys["running_mean"]].astype(np.float32)) * scale + mapped[
            keys["bias"]
        ].astype(np.float32)
        for s in ("weight", "bias", "running_mean", "running_var", "num_batches_tracked"):
            mapped.pop(f"{base}.1.{s}", None)
    return mapped


E4M3_MAX = 448.0  # the largest finite float8 e4m3fn value


def fp8_e4m3_roundtrip(w: np.ndarray) -> np.ndarray:
    """ModelOpt-style FP8 weight quantization emulated in numerics: the
    tensor scaled by amax/448 into float8 e4m3fn (round to nearest even,
    subnormals kept) and back, in fp32. The division and the product run in
    numpy, as in the JAX package; only the rounding to e4m3 is torch's."""
    amax = float(np.abs(w).max())
    if amax <= 0.0:
        return np.asarray(w, np.float32)
    scale = amax / E4M3_MAX
    q = torch.from_numpy(np.ascontiguousarray(np.asarray(w, np.float32) / scale)).to(torch.float8_e4m3fn)
    return q.to(torch.float32).numpy() * scale


def emulate_fp8_weights(state: dict[str, np.ndarray], layers) -> int:
    """Round the named layers' weights (``{layer}.weight``, or under
    ``base.`` or ``hg.``, the first found) through e4m3, in place; returns
    the number of layers rounded."""
    n = 0
    for layer in layers:
        for cand in (f"{layer}.weight", f"base.{layer}.weight", f"hg.{layer}.weight"):
            if cand in state:
                state[cand] = fp8_e4m3_roundtrip(state[cand])
                n += 1
                break
    return n


def load_checkpoint(
    path: str,
    *,
    hg_path: str | None = None,
    use_hg: bool | None = None,
    fold_bn: bool = True,
    fp8_emulate: bool | None = None,
    **cfg_overrides,
) -> tuple[dict[str, np.ndarray], ModelConfig]:
    """Load an HR (and optional HG) reference checkpoint into (params, config).

    ``use_hg`` (``None``: the ``architecture`` dict's, else whether
    ``hg_path`` is given) makes the composite: HR keys under ``base.``, HG
    keys (those of ``path`` and of ``hg_path``) under ``hg.``, and with
    ``fold_bn`` the HG BatchNorms folded. An FP8 source container
    (``fp8_source_schema`` in its metadata) has its quantized layers rounded
    through e4m3 (``fp8_emulate=False`` keeps the fp32 tensors). ``cfg_overrides``
    replace fields of the architecture dict."""
    raw, meta = load_torch_file(path)
    arch = dict(meta.get("architecture") or {})
    if use_hg is None:
        use_hg = bool(arch.get("use_hg", hg_path is not None))
    cfg = ModelConfig.from_arch_dict(arch, use_hg=use_hg, **cfg_overrides)

    raw = remap_condition_state(raw, prefix="AGCM." if any(k.startswith("AGCM.") for k in raw) else "base.AGCM.",
                                classifier=cfg.classifier)

    if use_hg:
        state: dict[str, np.ndarray] = {}
        for k, v in raw.items():
            state[k if k.startswith(("base.", "hg.")) else f"base.{k}"] = v
        if hg_path:
            hg_raw, _ = load_torch_file(hg_path)
            for k, v in hg_raw.items():
                state[k if k.startswith("hg.") else f"hg.{k}"] = v
        if fold_bn:
            state = fold_hg_batchnorm(state, prefix="hg.")
    else:
        state = {k[len("base."):] if k.startswith("base.") else k: v for k, v in raw.items() if not k.startswith("hg.")}

    if fp8_emulate is None:
        fp8_emulate = "fp8_source_schema" in meta
    if fp8_emulate and meta.get("quantized_layers"):
        emulate_fp8_weights(state, meta["quantized_layers"])

    return convert_state(state), cfg


def split_source_checkpoint(path: str, out_hr: str, out_hg: str) -> tuple[list[str], list[str]]:
    """Split a composite HR + HG checkpoint (``.pt``, or a converted ``.npz``
    with its sidecar) into HR and HG ``.npz`` checkpoints with sidecars.

    HR keeps every key that is not ``hg.*``, ``base.`` stripped; HG keeps the
    ``hg.*`` keys, stripped. The ``w8a8_layers`` / ``fp16_layers`` lists are
    filtered by the same rule, the HG architecture keeps its ``hg*`` and
    ``act_type`` fields, the HR one gets ``use_hg`` false. The tensors are
    written as they are (no layout conversion). Returns (HR keys, HG keys),
    sorted; a file without ``hg.*`` keys raises ValueError."""
    if path.endswith(".npz"):
        raw, meta = load_npz(path), load_npz_meta(path)
    else:
        raw, meta = load_torch_file(path)
    hr_state, hg_state = {}, {}
    for k, v in raw.items():
        if k.startswith("hg."):
            hg_state[k[3:]] = v
        else:
            hr_state[k[5:] if k.startswith("base.") else k] = v
    if not hg_state:
        raise ValueError(f"{path} carries no hg.* keys — not a composite checkpoint")

    def _filter_list(values, *, hg: bool) -> list[str]:
        out = []
        for layer in values or []:
            text = str(layer)
            if hg:
                if text.startswith("hg."):
                    out.append(text[3:])
            elif not text.startswith("hg."):
                out.append(text[5:] if text.startswith("base.") else text)
        return out

    arch = dict(meta.get("architecture") or {})
    common = {k: v for k, v in meta.items() if k not in ("architecture", "w8a8_layers", "fp16_layers")}
    hr_meta = dict(common)
    hr_meta["architecture"] = {**arch, "use_hg": False}
    hg_meta = dict(common)
    hg_meta["architecture"] = {k: v for k, v in arch.items() if k.startswith("hg") or k == "act_type"}
    for key in ("w8a8_layers", "fp16_layers"):
        if key in meta:
            hr_meta[key] = _filter_list(meta.get(key), hg=False)
            hg_meta[key] = _filter_list(meta.get(key), hg=True)
    save_npz(out_hr, hr_state, hr_meta)
    save_npz(out_hg, hg_state, hg_meta)
    return sorted(hr_state), sorted(hg_state)
