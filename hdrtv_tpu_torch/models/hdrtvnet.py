"""HDRTVNet++ top level (port of ``hdrtv_tpu/models/hdrtvnet.py``):
``ModelConfig``, the highlight mask, and the natural-layout forwards
``ensemble_agcm_le`` (AGCM → LE), ``hg_composite`` (base ensemble → mask →
/32 reflect pad → HG generator → crop) and ``model_apply``, the program the
runtime runs on frames the s2d programs do not take. The s2d forwards live in
``models/s2d.py`` and ``models/hg_s2d.py``. The post-correction heads are
not ported (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from hdrtv_tpu_torch.models.agcm import agcm_apply, normalize_classifier_name
from hdrtv_tpu_torch.models.hg import hg_apply
from hdrtv_tpu_torch.models.layers import F32, Params, Policy, pad_reflect
from hdrtv_tpu_torch.models.le_unet import le_apply


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


def ensemble_agcm_le(p: Params, img: torch.Tensor, cond: torch.Tensor, cfg: ModelConfig = ModelConfig(), *,
                     prefix: str = "", policy: Policy = F32) -> torch.Tensor:
    """Ensemble_AGCM_LE.forward: AGCM colour-maps the frame, LE refines it
    with itself as the condition. (N, H, W, 3) [0, 1] RGB and its ¼-res
    condition image → (N, H, W, 3) in the compute dtype."""
    if cfg.post_correction:
        raise NotImplementedError(
            "the post-correction heads are not ported to hdrtv_tpu_torch yet: ROADMAP.md "
            "Slice 8 (model variants: Queue 1 item 9)"
        )
    cond_out = agcm_apply(p, img, cond, prefix=f"{prefix}AGCM.", classifier=cfg.classifier, policy=policy)
    return le_apply(p, cond_out, cond_out, prefix=f"{prefix}LE.", le_arch=cfg.le_arch, act_type=cfg.act_type,
                    weighting_network=cfg.weighting_network, policy=policy)


def hg_composite(p: Params, img: torch.Tensor, cond: torch.Tensor, cfg: ModelConfig = ModelConfig(use_hg=True), *,
                 policy: Policy = F32) -> torch.Tensor:
    """HG_Composite.forward in the natural layout: the base ensemble
    (``base.*``), its highlight mask, both reflect-padded at the bottom and
    right to multiples of 32, the HG generator (``hg.*``, BatchNorms as the
    checkpoint has them), cropped back."""
    base_out = ensemble_agcm_le(p, img, cond, cfg, prefix="base.", policy=policy)
    mask = make_mask(base_out, r=cfg.mask_r)
    h, w = base_out.shape[1], base_out.shape[2]
    pad_h, pad_w = (32 - h % 32) % 32, (32 - w % 32) % 32
    hg_out = hg_apply(p, pad_reflect(base_out, pad_h, pad_w), pad_reflect(mask, pad_h, pad_w), prefix="hg.",
                      hg_arch=cfg.hg_arch, policy=policy)
    return hg_out[:, :h, :w] if pad_h or pad_w else hg_out


def model_apply(p: Params, img: torch.Tensor, cond: torch.Tensor, cfg: ModelConfig, *,
                policy: Policy = F32) -> torch.Tensor:
    """The natural-layout model: the HG composite with ``cfg.use_hg``, else
    the ensemble."""
    if cfg.use_hg:
        return hg_composite(p, img, cond, cfg, policy=policy)
    return ensemble_agcm_le(p, img, cond, cfg, policy=policy)


def natural_params_to_torch(params_np: dict, device, policy: Policy = F32) -> Params:
    """Carry untransformed numpy parameters to ``device`` for the natural
    program. The conv and dense weights and biases are cast once to the
    compute dtype (the JAX layers cast them at each use, to the same
    values); what those layers read in fp32 stays fp32 (the norms' scales,
    shifts and running statistics, the int8 scales and zero points, the
    ``x_on`` gates), and the int8 codes stay int8."""
    def is_layer(name):
        w = params_np.get(f"{name}.weight")
        return f"{name}.weight_int8" in params_np or (w is not None and np.ndim(w) in (2, 4))

    out = {}
    for k, v in params_np.items():
        t = torch.from_numpy(np.array(v))
        layer, _, leaf = k.rpartition(".")
        if t.is_floating_point():
            cast = leaf in ("weight", "bias") and is_layer(layer)
            t = t.to(policy.compute_dtype if cast else torch.float32)
        out[k] = t.to(device).contiguous()
    return out
