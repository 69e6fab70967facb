"""Fused 3×3 block convolution (port of ``hdrtv_tpu/ops/conv_kernels.py``
``fused_block_conv3``).

A 3×3 'same' conv over an s2d block tensor (Hb, Wb, C) → (Hb, Wb, Co), HWIO
weights, with bias, optional residual skip and optional ReLU fused:
``relu(conv(x) + b + skip)``. On CUDA tensors it launches
``csrc/block_conv3.cu``; on CPU tensors it runs the plain version.
Activations, weights and skip are float32 or bfloat16 (one type per call),
the bias float32; the sum is fp32 either way and rounds once, on store.
With ``qargs`` (an ``ops/w8a8.py`` ``QArgs``) it is the native-int8 (W8A8)
body: x quantized per tensor, int8 × int8 → int32 tap sums rescaled per
output channel (``csrc/block_conv3.cu`` ``block_conv3_w8a8``). The JAX
kernel's ``a_sub`` zero-tap skip and ``pool_out`` forms are not ported
(ROADMAP.md): the dense product equals the ``a_sub`` form on s2d-transformed
weights, in int8 exactly.
"""

from __future__ import annotations

import torch

from hdrtv_tpu_torch.models.layers import conv_nhwc
from hdrtv_tpu_torch.ops import native
from hdrtv_tpu_torch.ops.w8a8 import QArgs, _taps_conv_q, check_qargs


def fused_block_conv3_ref(x, w, b, *, relu=False, skip=None):
    """Plain version: conv + b, then + skip, then relu, in fp32; one
    rounding to ``x.dtype`` at the end."""
    y = conv_nhwc(x[None].float(), w.float(), b.float(), padding=1)[0]
    if skip is not None:
        y = y + skip.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


def fused_block_conv3_q_ref(x, qa: QArgs, *, relu=False, skip=None):
    """Plain version of the int8 body (conv_kernels.py:180-227): x widened
    to fp32 and quantized (out-of-image taps carry the pad code), the exact
    int32 sum scaled, + the folded bias, + skip, relu, one rounding."""
    y = _taps_conv_q(x.float(), qa)
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
    qargs: QArgs | None = None,
) -> torch.Tensor:
    """3×3 'same' conv over (Hb, Wb, C) with fused bias/ReLU/skip; ``w`` is
    (3, 3, C, Co). The kernel takes C a multiple of 16 and Co of 4 (the s2d
    callers route C, Co multiples of 128 here). ``qargs``: the layer's int8
    parameters, prepared at load from this ``w`` and ``b``; the int8 body
    reads them in place of ``w`` and ``b`` (C % 64, Co % 8 on the card)."""
    hb, wb, c = x.shape
    co = w.shape[-1]
    dt = native.element_type("block_conv3 x", x)
    native.check_params("block_conv3", dt, [w], [b])
    tensors = (x, w, b) if skip is None else (x, w, b, skip)
    cpu = native.on_cpu(*tensors)
    if qargs is not None:
        check_qargs("block_conv3", qargs, c, co, not cpu)
    if cpu:
        if qargs is not None:
            return fused_block_conv3_q_ref(x, qargs, relu=relu, skip=skip)
        return fused_block_conv3_ref(x, w, b, relu=relu, skip=skip)
    if c % 16 or co % 4 or (qargs is not None and (c % 64 or co % 8)):
        raise ValueError(f"block_conv3 needs C % 16 == 0 and Co % 4 == 0 (int8: C % 64 and Co % 8), "
                         f"got C={c} Co={co}")
    native.check_cuda("block_conv3 x", x, dt)
    native.check_cuda("block_conv3 w", w, dt, (3, 3, c, co))
    native.check_cuda("block_conv3 b", b, torch.float32, (co,))
    if skip is not None:
        native.check_cuda("block_conv3 skip", skip, dt, (hb, wb, co))
    out = torch.empty((hb, wb, co), dtype=dt, device=x.device)
    # the int8 form's scratch: x's codes
    codes = None if qargs is None else torch.empty((hb, wb, c), dtype=torch.int8, device=x.device)
    native.launch(
        "block_conv3", dt,
        x.data_ptr(), w.data_ptr(), b.data_ptr(), native.quant_params(qargs),
        None if skip is None else skip.data_ptr(), out.data_ptr(),
        None if codes is None else codes.data_ptr(),
        hb, wb, c, co, int(relu), native.stream_of(x),
        counter=None if qargs is None else "block_conv3_w8a8",
    )
    return out
