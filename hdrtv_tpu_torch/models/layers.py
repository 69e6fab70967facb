"""Functional NHWC layers over flat parameter dicts (port of
``hdrtv_tpu/models/layers.py``: the conv and dense layers with their int8
(eager W8 / W8A8) branches, the activations, norms and poolings, pixel
shuffle, nearest and bilinear resizes, the reflect, replicate and crop
alignments of the natural-layout program and the HG generator, and the
activation capture that calibration reads).

Parameters are a flat ``dict[str, torch.Tensor]`` keyed by the reference
checkpoint's state-dict names; activations are NHWC and conv weights HWIO,
as in the JAX package. The torch convolutions run NCHW views of the same
memory (an NHWC tensor permuted to NCHW is channels-last, which cuDNN and
the CPU backend take without a copy).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

Params = dict  # flat: str -> torch.Tensor (and "{layer}.__qargs" -> ops/w8a8.py QArgs)

# ---------------------------------------------------------------------------
# Activation capture (calibration hook point)
# ---------------------------------------------------------------------------
# Under a capture context, conv2d and linear record statistics of their
# *input* as tensors on its device. Nothing is copied to the host here: the
# caller copies all of a frame's statistics at once (quant/calibrate.py).
# With no capture active the layers pay one test of an empty list.

_ACTIVE_CAPTURE: list = []


class ActivationCapture:
    """Collects per-layer input statistics during a forward pass: for each
    watched layer (``names``; None watches every layer) ``abs_max``,
    ``min`` and ``max`` of its input in fp32, 0-d tensors on its device."""

    def __init__(self, names=None):
        self.names = None if names is None else set(names)
        self.stats: dict[str, dict] = {}

    def watches(self, name: str) -> bool:
        return self.names is None or name in self.names

    def _record(self, name: str, x: torch.Tensor) -> None:
        if not self.watches(name):
            return
        lo, hi = torch.aminmax(x.detach().float())
        self.stats[name] = {"abs_max": torch.maximum(hi, -lo), "min": lo, "max": hi}

    def __enter__(self):
        _ACTIVE_CAPTURE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE_CAPTURE.remove(self)


def _maybe_capture(name: str, x: torch.Tensor) -> None:
    for cap in _ACTIVE_CAPTURE:
        cap._record(name, x)


@dataclasses.dataclass(frozen=True)
class Policy:
    """Precision policy: compute happens in ``compute_dtype``. Parameters are
    cast once at load (``models/s2d.py params_to_torch``,
    ``models/hdrtvnet.py natural_params_to_torch``); ``cast`` on a tensor
    that already has the dtype returns it as it is.

    Under ``BF16`` every torch op rounds its result to bf16, as the JAX
    package's lax ops do with ``preferred_element_type=bf16``: a convolution
    or matmul sums in fp32 and rounds, and its bias is then added in bf16.

    ``exact_fp32`` is the counterpart of the JAX F32 preset's
    ``Precision.HIGHEST``: torch convolutions and matmuls on the card run in
    true fp32, with TF32 off (see :func:`fp32_math`).
    """

    compute_dtype: torch.dtype = torch.float32
    exact_fp32: bool = False

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != self.compute_dtype:
            return x.to(self.compute_dtype)
        return x

    def math(self):
        """Context in which this policy's torch ops run."""
        if self.exact_fp32:
            return fp32_math()
        if self.compute_dtype == torch.bfloat16:
            return bf16_math()
        return contextlib.nullcontext()


F32 = Policy(torch.float32, exact_fp32=True)
BF16 = Policy(torch.bfloat16)


def policy_for(precision: str) -> Policy:
    """Map reference precision tokens to policies: fp32/float32 → F32, every
    other token (fp16, the int8 presets) → bf16, as in the JAX package."""
    token = str(precision or "fp16").strip().lower()
    if token in {"fp32", "float32"}:
        return F32
    return BF16


@contextlib.contextmanager
def fp32_math():
    """Run torch convolutions and matmuls in true fp32.

    cuDNN convolutions default to TF32 on Hopper, which keeps ~10 mantissa
    bits (≈1e-3 relative error, tens of u16 output codes). Both switches are
    set off for the duration and restored after.
    """
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


@contextlib.contextmanager
def bf16_math():
    """Run bf16 matmuls with fp32 sums throughout.

    cuBLAS may otherwise reduce the partial sums of a split matmul in bf16
    (``allow_bf16_reduced_precision_reduction``, on by default); the bf16
    policy's contract is an fp32 sum rounded once. Restored after.
    """
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
              stride: int = 1, padding=0) -> torch.Tensor:
    """NHWC x (N,H,W,C), HWIO w → NHWC y. ``padding``: an int, or
    ((top, bottom), (left, right)) as in ``lax.conv_general_dilated``.

    The bias is added to the conv's result in the element type, as
    ``lax.conv + b`` does: in fp32 that is ``F.conv2d``'s own bias; below fp32
    the conv rounds first and the add is a separate op (``F.conv2d`` would add
    the bias to the fp32 sum before rounding)."""
    after = b if b is not None and x.dtype != torch.float32 else None
    if after is not None:
        b = None
    if isinstance(padding, int):
        pad = (padding, padding, padding, padding)
    else:
        (pt, pb), (pl, pr) = padding
        pad = (pl, pr, pt, pb)
    xn = x.permute(0, 3, 1, 2)
    if pad[0] == pad[1] == pad[2] == pad[3]:
        y = F.conv2d(xn, w.permute(3, 2, 0, 1), b, stride=stride, padding=pad[0])
    else:
        y = F.conv2d(F.pad(xn, pad), w.permute(3, 2, 0, 1), b, stride=stride)
    y = y.permute(0, 2, 3, 1).contiguous()
    return y if after is None else y + after


def _dequant_weight(p: Params, name: str, policy: Policy) -> torch.Tensor:
    """Per-output-channel int8 weight (HWIO or (in, out)) in the compute
    dtype: ``w_q`` and its scale (``w_scale``, or ``scale`` for a W8 layer)
    each cast to it, their product rounded in it."""
    w_q = p[f"{name}.weight_int8"]
    scale = p.get(f"{name}.w_scale")
    if scale is None:
        scale = p[f"{name}.scale"]
    return w_q.to(policy.compute_dtype) * scale.to(policy.compute_dtype)


def _maybe_fake_quant_act(p: Params, name: str, x: torch.Tensor, policy: Policy) -> torch.Tensor:
    """Static activation fake-quant of a W8A8 layer, in fp32 (the scales may
    lie below bf16's normal range): symmetric ``clip(round(x / s), −128, 127)
    · s``, asymmetric ``clip(round((x − z) / s), 0, 255) · s + z``; IEEE
    division, round half to even; the result cast to the compute dtype.
    Without ``{name}.x_scale`` (a W8 layer) ``x`` is returned as it is."""
    x_scale = p.get(f"{name}.x_scale")
    if x_scale is None:
        return x
    x_f = x.float()
    s = x_scale.float()
    x_zero = p.get(f"{name}.x_zero")
    if x_zero is not None:
        z = x_zero.float()
        q = torch.round((x_f - z) / s).clamp(0.0, 255.0)
        return (q * s + z).to(policy.compute_dtype)
    q = torch.round(x_f / s).clamp(-128.0, 127.0)
    return (q * s).to(policy.compute_dtype)


def _maybe_gated_quant(p: Params, name: str, x: torch.Tensor, policy: Policy) -> torch.Tensor:
    """The fake-quant switched by the value of ``{name}.x_on`` (a 0/1
    scalar), where the layer has one; else ``x`` as it is."""
    x_on = p.get(f"{name}.x_on")
    if x_on is None:
        return x
    return torch.where(x_on > 0, _maybe_fake_quant_act(p, name, x, policy), x)


def _layer_input(p: Params, name: str, x: torch.Tensor, policy: Policy) -> tuple[torch.Tensor, torch.Tensor]:
    """A conv or dense layer's weight and input in the compute dtype: the
    dequantized int8 weight and the fake-quantized input of an int8 layer,
    else the float weight and the input through the ``x_on`` gate."""
    if f"{name}.weight_int8" in p:
        return _dequant_weight(p, name, policy), policy.cast(_maybe_fake_quant_act(p, name, x, policy))
    return policy.cast(p[f"{name}.weight"]), _maybe_gated_quant(p, name, policy.cast(x), policy)


def conv2d(p: Params, name: str, x: torch.Tensor, *, stride: int = 1, padding=0,
           policy: Policy = F32) -> torch.Tensor:
    """2D convolution reading ``{name}.weight`` (HWIO) / ``{name}.bias``, or
    the int8 triplet ``{name}.weight_int8`` / ``w_scale`` (``scale``) /
    ``x_scale`` (+ ``x_zero``) of an eager W8 / W8A8 layer."""
    if _ACTIVE_CAPTURE:
        _maybe_capture(name, x)
    w, x = _layer_input(p, name, x, policy)
    b = p.get(f"{name}.bias")
    return conv_nhwc(x, w, None if b is None else policy.cast(b), stride=stride, padding=padding)


def linear(p: Params, name: str, x: torch.Tensor, *, policy: Policy = F32) -> torch.Tensor:
    """Dense layer, weights stored (in, out); the int8 branches as
    :func:`conv2d`. The product sums in fp32 and rounds to the compute dtype,
    then the bias is added in it."""
    if _ACTIVE_CAPTURE:
        _maybe_capture(name, x)
    w, x = _layer_input(p, name, x, policy)
    y = torch.matmul(x, w)
    b = p.get(f"{name}.bias")
    return y if b is None else y + policy.cast(b)


def scalar_of(v: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX's weak typing applies it to a tensor of
    ``dtype``: rounded to that dtype first (0.1 in bf16 is 0.10009765625).
    torch applies a Python scalar to a bf16 tensor at fp32 precision."""
    if dtype == torch.float32:
        return v
    return float(torch.tensor(v, dtype=dtype))


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """The slope is rounded to ``x``'s dtype before the multiply, as
    ``jnp.asarray(slope, x.dtype)`` is (0.1 in bf16 is 0.10009765625)."""
    return F.leaky_relu(x, scalar_of(slope, x.dtype))  # where(x >= 0, x, x·slope) in one pass


def avg_pool_3s2p1(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=True) in NHWC
    (the divisor is always 9).

    Below fp32 the nine taps are summed one by one in the element type, in
    window order, and the sum divided by 9 in it: what ``lax.reduce_window``
    with an add over bf16 computes (``F.avg_pool2d`` would sum in fp32 and
    round once, which differs in most elements).

    In fp32 the pool reads a contiguous NCHW copy: on a channels-last view
    the CUDA kernels' forward is the same, but their backward is wrong
    (0.79–0.96 of the largest input gradient apart from the CPU's and the
    contiguous tensor's; torch 2.11.0+cu128 on an NVIDIA H100)."""
    if x.dtype == torch.float32:
        y = F.avg_pool2d(x.permute(0, 3, 1, 2).contiguous(), 3, stride=2, padding=1, count_include_pad=True)
        return y.permute(0, 2, 3, 1).contiguous()
    n, h, w, c = x.shape
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((n, ho, wo, c), dtype=x.dtype, device=x.device)
    for di in range(3):
        for dj in range(3):
            acc = acc + xp[:, di : di + 2 * ho - 1 : 2, dj : dj + 2 * wo - 1 : 2]
    return acc / 9


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """AvgPool2d(k, stride=k) in NHWC ('VALID': a ragged edge is dropped).
    The k² taps are summed one by one in the element type, in window order,
    and the sum divided by k² in it, as ``lax.reduce_window`` does."""
    n, h, w, c = x.shape
    ho, wo = h // k, w // k
    acc = torch.zeros((n, ho, wo, c), dtype=x.dtype, device=x.device)
    for di in range(k):
        for dj in range(k):
            acc = acc + x[:, di : di + k * ho : k, dj : dj + k * wo : k]
    return acc / (k * k)


def instance_norm(p: Params, name: str, x: torch.Tensor, *, eps: float = 1e-5,
                  policy: Policy = F32) -> torch.Tensor:
    """InstanceNorm2d(affine=True): per-sample, per-channel over H,W (biased
    variance), statistics in fp32."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 2), keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    gamma = p[f"{name}.weight"].float()
    beta = p[f"{name}.bias"].float()
    return (y * gamma + beta).to(policy.compute_dtype)


def global_avg_pool(x: torch.Tensor, *, keepdims: bool = True) -> torch.Tensor:
    """AdaptiveAvgPool2d(1)."""
    return x.mean(dim=(1, 2), keepdim=keepdims)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(2) in NHWC (the HG encoder's downsampling); exact in any
    dtype. An odd trailing row or column is dropped, as a 'VALID' window does."""
    n, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """torch.nn.PixelShuffle(r) in NHWC: input channel c_out·r² + i·r + j goes
    to the pixel at intra-block offset (i, j). This channel order is what
    ``models/s2d.py w_ps_permute`` undoes."""
    n, h, w, c = x.shape
    c_out = c // (r * r)
    x = x.reshape(n, h, w, c_out, r, r)
    x = x.permute(0, 1, 4, 2, 5, 3)  # N, H, i, W, j, C
    return x.reshape(n, h * r, w * r, c_out)


def upsample_nearest(x: torch.Tensor, r: int) -> torch.Tensor:
    """nn.Upsample(scale_factor=r, mode='nearest') in NHWC."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, r, w, r, c)
    return x.reshape(n, h * r, w * r, c)


def pad_reflect(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """F.pad(..., mode='reflect') on the bottom and right edges of an NHWC
    tensor (the HG's /32 padding); by index, so exact in any dtype."""
    if pad_h == 0 and pad_w == 0:
        return x
    _, h, w, _ = x.shape
    if pad_h > h - 1 or pad_w > w - 1:
        raise ValueError(f"cannot reflect-pad {h}x{w} by ({pad_h},{pad_w})")
    if pad_h:
        x = torch.cat([x, x[:, h - 1 - pad_h : h - 1].flip(1)], dim=1)
    if pad_w:
        x = torch.cat([x, x[:, :, w - 1 - pad_w : w - 1].flip(2)], dim=2)
    return x


def _edge_index(n: int, before: int, after: int, device) -> torch.Tensor:
    return torch.arange(-before, n + after, device=device).clamp(0, n - 1)


def align_to(x: torch.Tensor, ref_h: int, ref_w: int) -> torch.Tensor:
    """Center-crop, then replicate-pad (the edge value), the spatial sides of
    an NHWC tensor to (ref_h, ref_w); by index, so exact in any dtype."""
    _, xh, xw, _ = x.shape
    if xh > ref_h:
        top = (xh - ref_h) // 2
        x = x[:, top : top + ref_h]
    if xw > ref_w:
        left = (xw - ref_w) // 2
        x = x[:, :, left : left + ref_w]
    _, xh, xw, _ = x.shape
    ph, pw = ref_h - xh, ref_w - xw
    if ph > 0:
        x = x.index_select(1, _edge_index(xh, ph // 2, ph - ph // 2, x.device))
    if pw > 0:
        x = x.index_select(2, _edge_index(xw, pw // 2, pw - pw // 2, x.device))
    return x


def bilinear_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """F.interpolate(mode='bilinear', align_corners=False) of an NHWC
    tensor to (h, w), half-pixel centres, computed in fp32 and cast back.
    Upsampling only: there ``jax.image.resize``, which antialiases, takes
    the same samples (a smaller side raises, as no caller shrinks)."""
    if h < x.shape[1] or w < x.shape[2]:
        raise ValueError(f"bilinear_resize upsamples only: {tuple(x.shape[1:3])} -> {(h, w)}")
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)
