"""HDRTVNet++ top level (port of ``hdrtv_tpu/models/hdrtvnet.py``):
``ModelConfig``, the post-correction heads, the highlight mask, and the
natural-layout forwards ``ensemble_agcm_le`` (AGCM → LE → optional
post-correction), ``hg_composite`` (base ensemble → mask → /32 reflect pad →
HG generator → crop) and ``model_apply``, the program the runtime runs on
frames the s2d programs do not take, and on every frame of a model variant.
The s2d forwards live in ``models/s2d.py`` and ``models/hg_s2d.py``.
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import torch

from hdrtv_tpu_torch.models.agcm import agcm_apply, color_matrix_apply, normalize_classifier_name
from hdrtv_tpu_torch.models.hg import hg_apply
from hdrtv_tpu_torch.models.layers import (
    F32,
    Params,
    Policy,
    avg_pool,
    bilinear_resize,
    conv2d,
    global_avg_pool,
    pad_reflect,
    pixel_shuffle,
    relu,
    scalar_of,
)
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


# ---------------------------------------------------------------------------
# Post-correction heads
# ---------------------------------------------------------------------------


def parse_post_correction(spec: str | None):
    """A post-correction name → None (off), ("global", 1, width, depth),
    ("spatial" | "residual" | "affine", scale, width, depth), or
    ("global_spatial" | "global_residual", global width, global depth,
    scale, width, depth); an unknown name raises ValueError."""
    spec = str(spec or "").strip().lower()
    if not spec or spec in {"none", "off", "0", "false"}:
        return None
    canonical = spec.replace("-", "").replace("_", "")
    m = re.fullmatch(
        r"(?:post)?global(?:color)?(?:correct|correction|corr)?wide([0-9]+)x([0-9]+)"
        r"(?:post)?(?:color)?(?:correct|correction|corr)h(4|8|16)wide([0-9]+)x([0-9]+)",
        canonical,
    )
    if m:
        return ("global_spatial", int(m.group(1)), int(m.group(2)), int(m.group(3)), int(m.group(4)), int(m.group(5)))
    m = re.fullmatch(
        r"(?:post)?global(?:color)?(?:correct|correction|corr)?wide([0-9]+)x([0-9]+)"
        r"(?:post)?res(?:idual)?h(2|4|8|16)wide([0-9]+)x([0-9]+)",
        canonical,
    )
    if m:
        return ("global_residual", int(m.group(1)), int(m.group(2)), int(m.group(3)), int(m.group(4)), int(m.group(5)))
    m = re.fullmatch(r"(?:post)?res(?:idual)?h(2|4|8|16)wide([0-9]+)x([0-9]+)", canonical)
    if m:
        return ("residual", int(m.group(1)), int(m.group(2)), int(m.group(3)))
    m = re.fullmatch(r"(?:post)?global(?:color)?(?:correct|correction|corr)?wide([0-9]+)x([0-9]+)", canonical)
    if m:
        return ("global", 1, int(m.group(1)), int(m.group(2)))
    m = re.fullmatch(r"(?:post)?affineh(4|8|16)wide([0-9]+)x([0-9]+)", canonical)
    if m:
        return ("affine", int(m.group(1)), int(m.group(2)), int(m.group(3)))
    m = re.fullmatch(r"(?:post)?(?:color)?(?:correct|correction|corr)h(4|8|16)wide([0-9]+)x([0-9]+)", canonical)
    if not m:
        raise ValueError(f"Unsupported post_correction '{spec}'")
    return ("spatial", int(m.group(1)), int(m.group(2)), int(m.group(3)))


def _tanh_limit(v: torch.Tensor, limit: float) -> torch.Tensor:
    return torch.tanh(v) * scalar_of(limit, v.dtype)


def _pc_trunk(p: Params, prefix: str, low: torch.Tensor, depth: int, *, policy: Policy) -> torch.Tensor:
    x = relu(conv2d(p, f"{prefix}trunk.0", low, policy=policy))
    for i in range(depth):
        x = relu(conv2d(p, f"{prefix}trunk.{2 * (i + 1)}", x, padding=1, policy=policy))
    return x


def _has_layer(p: Params, name: str) -> bool:
    return f"{name}.weight" in p or f"{name}.weight_int8" in p


def post_correction_apply(p: Params, spec: str, img: torch.Tensor, hdr: torch.Tensor, *,
                          prefix: str = "post_correction.", policy: Policy = F32) -> torch.Tensor:
    """A post-correction head on the ensemble's output ``hdr`` given the
    input frame ``img`` (both NHWC in the compute dtype): the global mode
    maps ``hdr`` by one 3×3 matrix and shift from the pooled pair; the
    spatial, affine and residual modes by per-pixel parameters (or a
    residual) from an avg-pooled trunk; the global_spatial and
    global_residual modes apply the global head first, then the other one
    (under ``spatial.`` or ``residual.``). Every parameter passes through
    tanh times its limit (0.25; 0.20 for the residual)."""
    cfg = parse_post_correction(spec)
    if cfg is None:
        return hdr

    def global_head():
        params = relu(conv2d(p, f"{prefix}net.1", global_avg_pool(torch.cat((img, hdr), dim=-1)), policy=policy))
        # net.1 is the first conv, net.3, net.5, … the hidden ones, the last the 12-out conv
        idx = 3
        while _has_layer(p, f"{prefix}net.{idx + 2}"):
            params = relu(conv2d(p, f"{prefix}net.{idx}", params, policy=policy))
            idx += 2
        params = _tanh_limit(conv2d(p, f"{prefix}net.{idx}", params, policy=policy), 0.25)
        return color_matrix_apply(hdr, params[..., :9], params[..., 9:])

    mode = cfg[0]
    if mode == "global":
        return global_head()
    if mode in ("global_spatial", "global_residual"):
        inner = mode.split("_")[1]
        return _post_spatial_like(p, f"{prefix}{inner}.", (inner, *cfg[3:]), img, global_head(), policy=policy)
    return _post_spatial_like(p, prefix, cfg, img, hdr, policy=policy)


def _post_spatial_like(p, prefix, cfg, img, hdr, *, policy):
    """The spatial, affine and residual heads: the (img, hdr) pair
    avg-pooled by ``scale``, the trunk, the out conv; per-pixel parameters
    bilinearly upsampled to the frame (the residual pixel-shuffled first)."""
    mode, scale, _, depth = cfg[0], cfg[1], cfg[2], cfg[3]
    h, w = hdr.shape[1], hdr.shape[2]
    x = _pc_trunk(p, prefix, avg_pool(torch.cat((img, hdr), dim=-1), scale), depth, policy=policy)
    if mode == "residual":
        delta = _tanh_limit(pixel_shuffle(conv2d(p, f"{prefix}out", x, policy=policy), scale), 0.20)
        if (delta.shape[1], delta.shape[2]) != (h, w):
            delta = bilinear_resize(delta, h, w)
        return hdr + delta
    params = conv2d(p, f"{prefix}out", x, policy=policy)
    if (params.shape[1], params.shape[2]) != (h, w):
        params = bilinear_resize(params, h, w)
    params = _tanh_limit(params, 0.25)
    if mode == "affine":
        return hdr * (1.0 + params[..., :3]) + params[..., 3:]
    return color_matrix_apply(hdr, params[..., :9], params[..., 9:])


# ---------------------------------------------------------------------------
# Ensemble + composite forwards
# ---------------------------------------------------------------------------


def mask_of_max(m: torch.Tensor, r: float, thresh: float) -> torch.Tensor:
    """The binarised normalised highlight level of a max-over-RGB tensor. The
    scalars are rounded to the tensor's dtype first, as JAX's weakly typed
    Python floats are."""
    level = ((m - scalar_of(r, m.dtype)) / scalar_of(1.0 - r, m.dtype)).clamp(0.0, 1.0)
    return (level > scalar_of(thresh, m.dtype)).to(m.dtype)


def make_mask(img: torch.Tensor, r: float = 0.75, thresh: float = 0.1) -> torch.Tensor:
    """Highlight mask of the HG composite: the normalised max over RGB,
    binarised. (N, H, W, 3) → (N, H, W, 1) in ``img``'s dtype."""
    return mask_of_max(img.amax(dim=-1, keepdim=True), r, thresh)


def ensemble_agcm_le(p: Params, img: torch.Tensor, cond: torch.Tensor, cfg: ModelConfig = ModelConfig(), *,
                     prefix: str = "", policy: Policy = F32) -> torch.Tensor:
    """Ensemble_AGCM_LE.forward: AGCM colour-maps the frame, LE refines it
    with itself as the condition, and a post-correction head (when
    ``cfg.post_correction`` names one) corrects LE's output given the input
    frame. (N, H, W, 3) [0, 1] RGB and its ¼-res condition image →
    (N, H, W, 3) in the compute dtype."""
    cond_out = agcm_apply(p, img, cond, prefix=f"{prefix}AGCM.", classifier=cfg.classifier, policy=policy)
    out = le_apply(p, cond_out, cond_out, prefix=f"{prefix}LE.", le_arch=cfg.le_arch, act_type=cfg.act_type,
                   weighting_network=cfg.weighting_network, policy=policy)
    if cfg.post_correction:
        out = post_correction_apply(p, cfg.post_correction, policy.cast(img), out,
                                    prefix=f"{prefix}post_correction.", policy=policy)
    return out


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
