"""Architecture selection (port of ``hdrtv_tpu/models/hdrtvnet.py``
``ModelConfig`` and ``make_mask``; the model forwards live in
``models/s2d.py`` and ``models/hg_s2d.py``)."""

from __future__ import annotations

import dataclasses
import os

import torch

from hdrtv_tpu_torch.models.agcm import normalize_classifier_name


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Mirrors the reference checkpoint's ``architecture`` dict."""

    classifier: str = "color_condition"
    cond_c: int = 6
    in_nc: int = 3
    out_nc: int = 3
    nf: int = 32
    act_type: str = "relu"
    weighting_network: bool = False
    use_hg: bool = False
    hg_nf: int = 64
    mask_r: float = 0.75
    le_arch: str = "sft"
    hg_arch: str = "pixelshuffle"
    post_correction: str = ""

    # Env-var arch overrides consulted when neither the checkpoint's
    # ``architecture`` dict nor an explicit override names the field.
    _ENV_FIELDS = {
        "classifier": "HDRTVNET_CLASSIFIER",
        "le_arch": "HDRTVNET_LE_ARCH",
        "hg_arch": "HDRTVNET_HG_ARCH",
        "post_correction": "HDRTVNET_POST_CORRECTION",
    }

    @classmethod
    def from_arch_dict(cls, arch: dict | None, **overrides) -> "ModelConfig":
        arch = dict(arch or {})
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in arch.items() if k in known}
        kwargs.update(overrides)
        for field, var in cls._ENV_FIELDS.items():
            if field not in kwargs:
                v = os.environ.get(var, "").strip()
                if v:
                    kwargs[field] = v
        if "classifier" in kwargs:
            kwargs["classifier"] = normalize_classifier_name(kwargs["classifier"])
        return cls(**kwargs)


def mask_of_max(m: torch.Tensor, r: float, thresh: float) -> torch.Tensor:
    """The binarised normalised highlight level of a max-over-RGB tensor. The
    scalars are rounded to the tensor's dtype first, as JAX's weakly typed
    Python floats are (0.1 in bf16 is 0.10009765625)."""
    def q(v):
        return float(torch.tensor(v, dtype=m.dtype))

    level = ((m - q(r)) / q(1.0 - r)).clamp(0.0, 1.0)
    return (level > q(thresh)).to(m.dtype)


def make_mask(img: torch.Tensor, r: float = 0.75, thresh: float = 0.1) -> torch.Tensor:
    """Highlight mask of the HG composite: the normalised max over RGB,
    binarised. (N, H, W, 3) → (N, H, W, 1) in ``img``'s dtype."""
    return mask_of_max(img.amax(dim=-1, keepdim=True), r, thresh)
