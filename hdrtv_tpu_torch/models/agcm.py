"""AGCM (port of ``hdrtv_tpu/models/agcm.py``: the classifier name
normalisation and its width, rank and spatial parsers, ``classifier_apply``
for the Color_Condition family, and the natural-layout ``agcm_apply`` of
every mode: the classifier-modulated ones (dynamic, lite, lowrank) and the
plain, affine, spatial-affine and spatial-mix ones, which work off the frame
itself).

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
    avg_pool,
    avg_pool_3s2p1,
    bilinear_resize,
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


def agcm_lite_width(classifier: str) -> int | None:
    m = re.fullmatch(r"agcm_lite([0-9]+)", normalize_classifier_name(classifier))
    return None if not m else max(4, min(64, int(m.group(1))))


def agcm_lowrank_rank(classifier: str) -> int | None:
    m = re.fullmatch(r"agcm_lowrank([0-9]+)", normalize_classifier_name(classifier))
    return None if not m else max(1, min(64, int(m.group(1))))


def agcm_spatial_config(classifier: str) -> tuple[int, int, int] | None:
    """(pool scale, width, trunk depth) of a spatial classifier name, each
    clamped as in the JAX package; None for the other names."""
    m = re.fullmatch(
        r"agcm_spatial(?:mixglobalcnn|mixgcnn|mixglobal|mixg|mix)?h([0-9]+)wide([0-9]+)x([0-9]+)",
        normalize_classifier_name(classifier),
    )
    if not m:
        return None
    return (
        max(2, min(32, int(m.group(1)))),
        max(4, min(128, int(m.group(2)))),
        max(1, min(16, int(m.group(3)))),
    )


def agcm_mode(classifier: str) -> str:
    """The forward a classifier name selects (the JAX ``agcm_mode``): plain,
    affine, spatial_mix, spatial_affine, lite, lowrank, or dynamic (the
    Color_Condition family)."""
    name = normalize_classifier_name(classifier)
    if name == "agcm_plain":
        return "plain"
    if name == "agcm_affine":
        return "affine"
    if agcm_spatial_config(name) is not None:
        return "spatial_mix" if name.startswith("agcm_spatialmix") else "spatial_affine"
    if agcm_lite_width(name) is not None:
        return "lite"
    if agcm_lowrank_rank(name) is not None:
        return "lowrank"
    return "dynamic"


def is_plain_agcm_classifier(classifier: str) -> bool:
    return agcm_mode(classifier) in {"plain", "affine", "spatial_mix", "spatial_affine"}


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


def _spatial_params(p: Params, prefix: str, classifier: str, content: torch.Tensor, *,
                    policy: Policy) -> torch.Tensor:
    """The spatial variants' low-resolution trunk (avg-pooled by the name's
    scale), plus the global term of the ``spatialmixglobal[cnn]`` heads,
    bilinearly upsampled to the frame: the per-pixel parameters (NHWC)."""
    scale_k, _, depth = agcm_spatial_config(classifier)
    name = normalize_classifier_name(classifier)
    low = avg_pool(policy.cast(content), scale_k)

    def conv(layer, x, **kw):
        return conv2d(p, f"{prefix}{layer}", x, policy=policy, **kw)

    params = relu(conv("spatial_in", low))
    for i in range(depth):
        params = relu(conv(f"spatial_trunk.{2 * i}", params, padding=1))
    params = conv("spatial_out", params)
    if name.startswith(("agcm_spatialmixglobal", "agcm_spatialmixg")):
        if name.startswith(("agcm_spatialmixglobalcnn", "agcm_spatialmixgcnn")):
            g = relu(conv("global_net.0", low))
            g = relu(conv("global_net.2", g, stride=2, padding=1))
            g = relu(conv("global_net.4", g, stride=2, padding=1))
            g = conv("global_net.7", global_avg_pool(g))
        else:
            g = relu(conv("global_in", global_avg_pool(policy.cast(content))))
            g = conv("global_out", g)
        params = params + g
    h, w = content.shape[1], content.shape[2]
    if (params.shape[1], params.shape[2]) != (h, w):
        params = bilinear_resize(params, h, w)
    return params


def color_matrix_apply(x: torch.Tensor, delta: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``out_c = x · (row_c + e_c) + shift_c``: a per-pixel 3×3 matrix (the
    identity plus ``delta``, 9 channels row by row) and an RGB shift, each
    product and sum rounded in the element type in the JAX package's order."""
    r, g, b = x[..., 0:1], x[..., 1:2], x[..., 2:3]
    d = [delta[..., i:i + 1] for i in range(9)]
    out_r = r * (d[0] + 1.0) + g * d[1] + b * d[2] + shift[..., 0:1]
    out_g = r * d[3] + g * (d[4] + 1.0) + b * d[5] + shift[..., 1:2]
    out_b = r * d[6] + g * d[7] + b * (d[8] + 1.0) + shift[..., 2:3]
    return torch.cat((out_r, out_g, out_b), dim=-1)


def agcm_apply(p: Params, content: torch.Tensor, cond: torch.Tensor, *, prefix: str = "AGCM.",
               classifier: str = "color_condition", policy: Policy = F32) -> torch.Tensor:
    """ConditionNet.forward in the natural layout: the colour-mapped frame
    (NHWC). ``content`` is the full-resolution [0, 1] RGB frame, ``cond`` the
    ¼-resolution condition image. In the dynamic, lite and lowrank modes the
    classifier's vector modulates the three 1×1 convs (conv_first, HRconv or
    its rank-r factors HRconv_reduce → HRconv_expand, conv_last) by per-layer
    scale and shift; the plain mode is the three convs alone; the affine and
    spatial modes map the frame by parameters computed from the frame itself
    (a global or a per-pixel scale and shift, or a per-pixel 3×3 matrix), and
    ignore ``cond``."""
    mode = agcm_mode(classifier)
    content = policy.cast(content)

    def conv(name, x):
        return conv2d(p, f"{prefix}{name}", x, policy=policy)

    if mode == "plain":
        return conv("conv_last", relu(conv("HRconv", relu(conv("conv_first", content)))))
    if mode == "affine":
        params = conv("affine.2", relu(conv("affine.0", global_avg_pool(content))))  # (N, 1, 1, 6)
        return content * (params[..., :3] + 1.0) + params[..., 3:]
    if mode == "spatial_affine":
        params = _spatial_params(p, prefix, classifier, content, policy=policy)
        return content * (params[..., :3] + 1.0) + params[..., 3:]
    if mode == "spatial_mix":
        params = _spatial_params(p, prefix, classifier, content, policy=policy)
        return color_matrix_apply(content, params[..., :9], params[..., 9:])

    fea = classifier_apply(p, f"{prefix}classifier.", "color_condition", cond, policy=policy)

    def lin(name):
        return linear(p, f"{prefix}{name}", fea, policy=policy)

    out = conv("conv_first", content)
    out = relu(_modulate(out, lin("cond_scale_first"), lin("cond_shift_first")))
    out = conv("HRconv_expand", conv("HRconv_reduce", out)) if mode == "lowrank" else conv("HRconv", out)
    out = relu(_modulate(out, lin("cond_scale_HR"), lin("cond_shift_HR")))
    out = conv("conv_last", out)
    return _modulate(out, lin("cond_scale_last"), lin("cond_shift_last"))
