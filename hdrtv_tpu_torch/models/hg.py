"""HG (highlight generation): the hallucination generator in the natural
layout (port of ``hdrtv_tpu/models/hg.py`` ``hg_apply``).

A six-level conv UNet with BatchNorm in eval mode (applied from the
checkpoint's running statistics, or absent when folded into the convs) and
pixel-shuffle or resize-conv upsampling; the output is composited as
``mask · out + img``. The frame programs run its s2d form
(``models/hg_s2d.py``), which reuses the blocks here where a checkpoint keeps
its BatchNorm or the resize-conv layout; the tests hold the two forms
against each other. The ``direct`` generator family (one avg-pooled
masked residual island, :func:`hg_direct_apply`) runs in the natural layout
alone.
"""

from __future__ import annotations

import torch

from hdrtv_tpu_torch.models.layers import (
    F32,
    Params,
    Policy,
    align_to,
    avg_pool,
    conv2d,
    max_pool2,
    pixel_shuffle,
    relu,
    upsample_nearest,
)


def _batch_norm(p: Params, name: str, x: torch.Tensor, *, eps: float = 1e-5,
                policy: Policy = F32) -> torch.Tensor:
    """Eval-mode BatchNorm from the running statistics, computed in fp32 and
    cast to the compute dtype."""
    mean = p[f"{name}.running_mean"].float()
    var = p[f"{name}.running_var"].float()
    scale = p[f"{name}.weight"].float() * torch.rsqrt(var + eps)
    shift = p[f"{name}.bias"].float() - mean * scale
    return (x.float() * scale + shift).to(policy.compute_dtype)


def _conv_block(p: Params, name: str, x: torch.Tensor, *, policy: Policy) -> torch.Tensor:
    """conv_block: 3×3 conv → [BatchNorm] → ReLU. Without the BatchNorm keys
    (folded at import) it is conv + ReLU."""
    x = conv2d(p, f"{name}.0", x, padding=1, policy=policy)
    if f"{name}.1.running_mean" in p:
        x = _batch_norm(p, f"{name}.1", x, policy=policy)
    return relu(x)


def _up_block(p: Params, name: str, x: torch.Tensor, *, policy: Policy) -> torch.Tensor:
    """up_block: conv → PixelShuffle(2) → ReLU, or, when the checkpoint
    carries ``{name}.1.weight`` (the resize-conv layout), nearest upsample →
    conv → ReLU."""
    if f"{name}.1.weight" in p:
        x = upsample_nearest(x, 2)
        return relu(conv2d(p, f"{name}.1", x, padding=1, policy=policy))
    x = conv2d(p, f"{name}.0", x, padding=1, policy=policy)
    return relu(pixel_shuffle(x, 2))


def hg_apply(
    p: Params, img: torch.Tensor, mask: torch.Tensor, *, prefix: str = "hg.",
    hg_arch: str = "pixelshuffle", policy: Policy = F32,
) -> torch.Tensor:
    """Hallucination_Generator.forward on natural NHWC tensors. ``img`` and
    ``mask`` are already padded to a multiple of 32."""
    if hg_arch.startswith("direct"):
        return hg_direct_apply(p, img, mask, prefix=prefix, policy=policy)
    img = policy.cast(img)
    mask = policy.cast(mask)

    def blk(name, x):
        return _conv_block(p, f"{prefix}{name}", x, policy=policy)

    def up(name, x):
        return _up_block(p, f"{prefix}{name}", x, policy=policy)

    def mix(name, x):
        return conv2d(p, f"{prefix}{name}", x, policy=policy)

    c1 = blk("conv1", img)
    c2 = blk("conv2", max_pool2(c1))
    c3 = blk("conv3_2", max_pool2(blk("conv3_1", c2)))
    c4 = blk("conv4_2", max_pool2(blk("conv4_1", c3)))
    c5 = blk("conv5_2", max_pool2(blk("conv5_1", c4)))
    code = blk("conv_code2", max_pool2(blk("conv_code1", c5)))

    u = mix("conv6", torch.cat((up("Up_conv1", code), c5), dim=-1))
    u = mix("conv7", torch.cat((up("Up_conv2", u), c4), dim=-1))
    u = mix("conv8", torch.cat((up("Up_conv3", u), c3), dim=-1))
    u = mix("conv9", torch.cat((up("Up_conv4", u), c2), dim=-1))
    u = mix("conv10", torch.cat((up("Up_conv5", u), c1), dim=-1))
    out = mix("conv_last", torch.cat((u, img), dim=-1))
    return mask * out + img


def hg_direct_apply(
    p: Params, img: torch.Tensor, mask: torch.Tensor, *, prefix: str = "hg.", bottleneck_scale: int = 8,
    trunk_depth: int = 8, policy: Policy = F32,
) -> torch.Tensor:
    """Hallucination_Generator_Direct: (img, mask) avg-pooled by
    ``bottleneck_scale``, a 1×1 in, ``trunk_depth`` 3×3 convs, a 1×1 out,
    pixel shuffle back (re-aligned to the frame), composited as
    ``mask · out + img``."""
    img = policy.cast(img)
    mask = policy.cast(mask)
    low = avg_pool(torch.cat((img, mask), dim=-1), bottleneck_scale)
    out = relu(conv2d(p, f"{prefix}low_in", low, policy=policy))
    for i in range(trunk_depth):
        out = relu(conv2d(p, f"{prefix}trunk.{2 * i}", out, padding=1, policy=policy))
    out = pixel_shuffle(conv2d(p, f"{prefix}low_out", out, policy=policy), bottleneck_scale)
    out = align_to(out, img.shape[1], img.shape[2])
    return mask * out + img
