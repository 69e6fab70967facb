"""Converted-checkpoint loading and writing (port of the npz branch of
``hdrtv_tpu/models/import_torch.py``, with ``convert_state`` and
``save_npz`` so that a composite base + HG checkpoint can be written from a
torch-layout state dict). Arrays stay numpy: the s2d weight transform runs on
the host, and ``models/s2d.py params_to_torch`` moves the result to the
device."""

from __future__ import annotations

import json
import os
from collections.abc import Mapping

import numpy as np


def convert_state(raw: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Torch layout → NHWC/HWIO flat params: conv weights OIHW → HWIO, linear
    weights (out, in) → (in, out), ``module.`` prefixes stripped and
    ``num_batches_tracked`` dropped."""
    out: dict[str, np.ndarray] = {}
    for key, arr in raw.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if key.endswith("num_batches_tracked"):
            continue
        if key.endswith(("weight", "weight_int8")):
            if arr.ndim == 4:
                arr = np.transpose(arr, (2, 3, 1, 0))
            elif arr.ndim == 2:
                arr = np.transpose(arr, (1, 0))
        out[key] = np.ascontiguousarray(arr)
    return out


def save_npz(path: str, params: Mapping[str, np.ndarray], meta: dict | None = None) -> None:
    """Write an npz checkpoint; ``meta`` (the architecture dict) goes into a
    ``<stem>.json`` sidecar, which :func:`load_npz_meta` reads back."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in params.items()})
    if meta:
        with open(_sidecar_path(path), "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True, default=str)


def _sidecar_path(npz_path: str) -> str:
    base = npz_path[:-4] if npz_path.endswith(".npz") else npz_path
    return base + ".json"


def load_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_npz_meta(path: str) -> dict:
    """Sidecar metadata for an npz checkpoint ({} when absent/unreadable).
    A flat dict of ModelConfig fields is accepted as a bare arch dict."""
    try:
        with open(_sidecar_path(path)) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def npz_arch_dict(meta: dict) -> dict:
    """Arch dict from sidecar meta: nested under ``architecture`` (portable
    schema) or the whole flat dict (golden-fixture convention)."""
    arch = meta.get("architecture")
    if isinstance(arch, dict):
        return arch
    return {k: v for k, v in meta.items() if not isinstance(v, (list, dict))}
