"""Fused 3×3 block convolution (port of ``hdrtv_tpu/ops/conv_kernels.py``
``fused_block_conv3``).

A 3×3 'same' conv over an s2d block tensor (Hb, Wb, C) → (Hb, Wb, Co), HWIO
weights, with bias, optional residual skip and optional ReLU fused:
``relu(conv(x) + b + skip)``. On CUDA tensors it launches
``csrc/block_conv3.cu``; on CPU tensors it runs the plain version.
Activations, weights and skip are float32 or bfloat16 (one type per call),
the bias float32; the sum is fp32 either way and rounds once, on store. The
JAX kernel's ``a_sub`` zero-tap skip, ``pool_out`` and int8 ``qargs`` forms
are not ported (ROADMAP.md): the dense product equals the ``a_sub`` form on
s2d-transformed weights.
"""

from __future__ import annotations

import torch

from hdrtv_tpu_torch.models.layers import conv_nhwc
from hdrtv_tpu_torch.ops import native


def fused_block_conv3_ref(x, w, b, *, relu=False, skip=None):
    """Plain version: conv + b, then + skip, then relu, in fp32; one
    rounding to ``x.dtype`` at the end."""
    y = conv_nhwc(x[None].float(), w.float(), b.float(), padding=1)[0]
    if skip is not None:
        y = y + skip.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


def fused_block_conv3(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    relu: bool = False,
    skip: torch.Tensor | None = None,
) -> torch.Tensor:
    """3×3 'same' conv over (Hb, Wb, C) with fused bias/ReLU/skip; ``w`` is
    (3, 3, C, Co). The kernel takes C a multiple of 16 and Co of 4 (the s2d
    callers route C, Co multiples of 128 here)."""
    hb, wb, c = x.shape
    co = w.shape[-1]
    dt = native.element_type("block_conv3 x", x)
    native.check_params("block_conv3", dt, [w], [b])
    tensors = (x, w, b) if skip is None else (x, w, b, skip)
    if native.on_cpu(*tensors):
        return fused_block_conv3_ref(x, w, b, relu=relu, skip=skip)
    if c % 16 or co % 4:
        raise ValueError(f"block_conv3 needs C % 16 == 0 and Co % 4 == 0, got C={c} Co={co}")
    native.check_cuda("block_conv3 x", x, dt)
    native.check_cuda("block_conv3 w", w, dt, (3, 3, c, co))
    native.check_cuda("block_conv3 b", b, torch.float32, (co,))
    if skip is not None:
        native.check_cuda("block_conv3 skip", skip, dt, (hb, wb, co))
    out = torch.empty((hb, wb, co), dtype=dt, device=x.device)
    native.launch(
        "block_conv3", dt,
        x.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if skip is None else skip.data_ptr(), out.data_ptr(),
        hb, wb, c, co, int(relu), native.stream_of(x),
    )
    return out
