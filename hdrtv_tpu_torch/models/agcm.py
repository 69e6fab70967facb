"""AGCM (port of ``hdrtv_tpu/models/agcm.py``: the classifier name
normalisation, ``classifier_apply`` for the Color_Condition family, and the
natural-layout ``agcm_apply`` of the classifier-modulated modes).

The classifier runs on the ¼-resolution condition image and yields the
global colour vector that modulates the AGCM 1×1 convs (``models/s2d.py
agcm_s2d`` in the s2d programs, :func:`agcm_apply` in the natural one). It
is small plain torch: the JAX package leaves it to XLA.
"""

from __future__ import annotations

import re

import torch

from hdrtv_tpu_torch.models.layers import (
    F32,
    Params,
    Policy,
    avg_pool_3s2p1,
    conv2d,
    global_avg_pool,
    instance_norm,
    leaky_relu,
    linear,
    relu,
)


def normalize_classifier_name(classifier: str | None) -> str:
    name = str(classifier or "color_condition").strip().lower().replace("-", "_")
    m = re.fullmatch(
        r"(?:agcm_)?spatial(?:_?mix_?global_?cnn|_?mixgcnn|_?global_?mix_?cnn)_?h?([0-9]+)?(?:_?wide_?([0-9]+))?(?:_?x_?([0-9]+))?",
        name,
    )
    if m:
        return f"agcm_spatialmixglobalcnnh{m.group(1) or 16}wide{m.group(2) or 32}x{m.group(3) or 4}"
    m = re.fullmatch(
        r"(?:agcm_)?spatial(?:_?mix_?global|_?mixg|_?global_?mix)_?h?([0-9]+)?(?:_?wide_?([0-9]+))?(?:_?x_?([0-9]+))?",
        name,
    )
    if m:
        return f"agcm_spatialmixglobalh{m.group(1) or 16}wide{m.group(2) or 32}x{m.group(3) or 4}"
    m = re.fullmatch(
        r"(?:agcm_)?spatial(?:_?mix|_?matrix|_?mat)_?h?([0-9]+)?(?:_?wide_?([0-9]+))?(?:_?x_?([0-9]+))?",
        name,
    )
    if m:
        return f"agcm_spatialmixh{m.group(1) or 16}wide{m.group(2) or 32}x{m.group(3) or 4}"
    m = re.fullmatch(
        r"(?:agcm_)?spatial(?:_?affine)?_?h?([0-9]+)?(?:_?wide_?([0-9]+))?(?:_?x_?([0-9]+))?",
        name,
    )
    if m:
        return f"agcm_spatialh{m.group(1) or 16}wide{m.group(2) or 32}x{m.group(3) or 4}"
    m = re.fullmatch(r"(?:agcm_)?lite(?:_?agcm)?_?([0-9]+)?", name)
    if m:
        return f"agcm_lite{m.group(1) or 16}"
    m = re.fullmatch(r"(?:agcm_)?lowrank_?([0-9]+)?", name)
    if m:
        return f"agcm_lowrank{m.group(1) or 16}"
    aliases = {
        "color": "color_condition",
        "default": "color_condition",
        "color_condition_noin": "color_condition_woin",
        "color_condition_wo_in": "color_condition_woin",
        "color_condition_no_in": "color_condition_woin",
        "base": "agcm_plain",
        "base3": "agcm_plain",
        "plain": "agcm_plain",
        "plain3": "agcm_plain",
        "plain_agcm": "agcm_plain",
        "plain_agcm3": "agcm_plain",
        "agcm_base": "agcm_plain",
        "agcm_base3": "agcm_plain",
        "affine": "agcm_affine",
        "adaptive_affine": "agcm_affine",
    }
    return aliases.get(name, name)


def agcm_mode(classifier: str) -> str:
    """The forward a classifier name selects (the JAX ``agcm_mode``): plain,
    affine, spatial_mix, spatial_affine, lite, lowrank, or dynamic (the
    Color_Condition family)."""
    name = normalize_classifier_name(classifier)
    if name == "agcm_plain":
        return "plain"
    if name == "agcm_affine":
        return "affine"
    if re.fullmatch(r"agcm_spatial(?:mixglobalcnn|mixgcnn|mixglobal|mixg|mix)?h[0-9]+wide[0-9]+x[0-9]+", name):
        return "spatial_mix" if name.startswith("agcm_spatialmix") else "spatial_affine"
    if re.fullmatch(r"agcm_lite[0-9]+", name):
        return "lite"
    if re.fullmatch(r"agcm_lowrank[0-9]+", name):
        return "lowrank"
    return "dynamic"


# Sequential-index layouts: list of (conv_idx, instancenorm_idx|None) blocks,
# plus the trailing 1x1 conv index (nn.Sequential numbering of color_block).
_CLASSIFIER_LAYOUTS = {
    "color_condition": ([(0, 3), (4, 7), (8, 11), (12, 15), (16, None)], 20),
    "color_condition_wodropout": ([(0, 3), (4, 7), (8, 11), (12, 15), (16, None)], 19),
    "color_condition_woin": ([(0, None), (3, None), (6, None), (9, None), (12, None)], 16),
    "color_condition_3layer": ([(0, 3), (4, 7), (8, None)], 12),
    "color_condition_4layer": ([(0, 3), (4, 7), (8, 11), (12, None)], 16),
    "color_condition_6layer": ([(0, 3), (4, 7), (8, 11), (12, 15), (16, 19), (20, None)], 24),
}


def classifier_apply(
    p: Params, prefix: str, classifier: str, cond: torch.Tensor, *, policy: Policy = F32
) -> torch.Tensor:
    """Color_Condition classifier: returns the (N, cond_c) global colour vector.

    Each block: 1×1 conv → AvgPool(3,2,1,count_include_pad) → LeakyReLU(0.2)
    [→ InstanceNorm]; then Dropout (eval no-op) → 1×1 conv → global avg pool.
    """
    layout, final_conv = _CLASSIFIER_LAYOUTS[normalize_classifier_name(classifier)]
    x = policy.cast(cond)
    for conv_idx, in_idx in layout:
        x = conv2d(p, f"{prefix}model.{conv_idx}", x, policy=policy)
        x = avg_pool_3s2p1(x)
        x = leaky_relu(x, 0.2)
        if in_idx is not None:
            x = instance_norm(p, f"{prefix}model.{in_idx}", x, policy=policy)
    x = conv2d(p, f"{prefix}model.{final_conv}", x, policy=policy)
    return global_avg_pool(x, keepdims=False)  # (N, cond_c)


def _modulate(out: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``out * scale + shift + out`` with (N, C) vectors, three ops rounded
    in the element type as written (not the agcm_head kernel's folded form)."""
    n, c = scale.shape
    return out * scale.reshape(n, 1, 1, c) + shift.reshape(n, 1, 1, c) + out


def agcm_apply(p: Params, content: torch.Tensor, cond: torch.Tensor, *, prefix: str = "AGCM.",
               classifier: str = "color_condition", policy: Policy = F32) -> torch.Tensor:
    """ConditionNet.forward in the natural layout: the colour-mapped frame
    (NHWC). ``content`` is the full-resolution [0, 1] RGB frame, ``cond`` the
    ¼-resolution condition image: the classifier's vector modulates the
    three 1×1 convs (conv_first, HRconv, conv_last) by per-layer scale and
    shift. Only the classifier-modulated modes (dynamic, lite) are ported."""
    mode = agcm_mode(classifier)
    if mode not in ("dynamic", "lite"):
        raise NotImplementedError(
            f"the {mode} AGCM is not ported to hdrtv_tpu_torch yet: ROADMAP.md "
            "Slice 8 (model variants: Queue 1 item 9)"
        )
    content = policy.cast(content)
    fea = classifier_apply(p, f"{prefix}classifier.", "color_condition", cond, policy=policy)

    def lin(name):
        return linear(p, f"{prefix}{name}", fea, policy=policy)

    out = conv2d(p, f"{prefix}conv_first", content, policy=policy)
    out = relu(_modulate(out, lin("cond_scale_first"), lin("cond_shift_first")))
    out = conv2d(p, f"{prefix}HRconv", out, policy=policy)
    out = relu(_modulate(out, lin("cond_scale_HR"), lin("cond_shift_HR")))
    out = conv2d(p, f"{prefix}conv_last", out, policy=policy)
    return _modulate(out, lin("cond_scale_last"), lin("cond_shift_last"))
