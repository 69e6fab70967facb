"""Native int8 (W8A8) convolution: a layer's int8 parameters prepared once at
load (:class:`QArgs`, the work of the JAX ``ops/megakernel.py _pack_qargs``)
and the plain PyTorch versions of the quantized 3×3 conv the Pallas kernels'
``quant`` bodies run (``_quantize_act``, ``_tap_views_q``, ``_taps_conv_q``,
``hdrtv_tpu/ops/megakernel.py:1325-1376``), in its stride-1 'same' form,
its stride-2 (1,0)-padded form (``_down2_kernel``'s ``quant`` body) and its
1×1 form (the ``qflags`` steps of ``_cond_chain_kernel``). The kernel
wrappers of ``conv_kernels.py`` and ``megakernel.py`` take a :class:`QArgs`
as their ``qargs`` (``fused_down2`` one per branch); on CUDA tensors they
launch the int8 kernels of ``csrc/`` (``conv3x3_s8.cuh``, ``chain.cuh``),
on CPU tensors they run these plain versions.

The arithmetic, W8A8Conv2d's:

    symmetric:  code = clamp(round(t / s), −128, 127)
    asymmetric: code = clamp(round((t − z) / s), 0, 255) − 128
    y = float(Σ_taps code · w_int8) · (s · w_scale) + (b + (z + 128·s) · Σ w_int8·w_scale)

with IEEE division and round-half-to-even; the int32 sum is exact; the
rescale and the bias add are each rounded (the Pallas body's two jnp ops;
the CUDA kernels use ``__fmul_rn`` and ``__fadd_rn``, which nvcc does not
contract). An out-of-image tap carries the pad code, the code of t = 0 (0
when symmetric).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from hdrtv_tpu_torch.ops import native


@dataclasses.dataclass(frozen=True)
class QArgs:
    """One native-int8 conv layer, ready for its kernel.

    ``w``: (Co, taps·C) int8 codes, row n holding the taps (dI, dJ) row-major
    then the input channel (K-contiguous per output channel: the layout the
    int8 tensor-core tiles read); ``taps`` is 9 for a 3×3 conv, 1 for a 1×1.
    ``yscale``: (Co,) fp32 ``x_scale·w_scale``. ``bias``: (Co,) fp32, the
    layer's bias with the asymmetric zero-point term folded in. ``scale``,
    ``zero`` (None when symmetric) and ``pad`` (the code of an out-of-image
    tap) are Python numbers, read on the host with no device sync."""

    w: torch.Tensor
    yscale: torch.Tensor
    bias: torch.Tensor
    scale: float
    zero: float | None
    pad: int
    taps: int = 9

    @property
    def c(self) -> int:
        return self.w.shape[1] // self.taps

    @property
    def co(self) -> int:
        return self.w.shape[0]


def pack_qargs(w_int8, w_scale, x_scale, x_zero, bias, device="cpu") -> QArgs:
    """A :class:`QArgs` from a layer's (3, 3, C, Co) HWIO int8 weight (or a
    1×1's (1, 1, C, Co)), its (Co,) weight scales, activation
    scale and zero point (None when symmetric) and (Co,) bias, in fp32 as the
    JAX ``_pack_qargs`` / ``_pack_qargs_1x1`` compute them:
    ``yscale = s·w_scale``; the asymmetric correction
    ``(z + 128·s)·Σ w_int8·w_scale`` (the sum taken exactly, then rounded)
    added to the bias; the pad code ``clip(round(−z/s), 0, 255) − 128``."""
    wq = np.asarray(w_int8)
    if wq.dtype != np.int8 or wq.ndim != 4 or wq.shape[:2] not in ((3, 3), (1, 1)):
        raise ValueError(f"w_int8 must be (3, 3, C, Co) or (1, 1, C, Co) int8, got {wq.shape} {wq.dtype}")
    taps, c, co = wq.shape[0] * wq.shape[1], wq.shape[2], wq.shape[3]
    ws = np.asarray(w_scale, np.float32).reshape(co)
    s = np.float32(np.asarray(x_scale, np.float32).reshape(()))
    b = np.asarray(bias, np.float32).reshape(co)
    yscale = (s * ws).astype(np.float32)
    zero, pad = None, 0
    if x_zero is not None:
        z = np.float32(np.asarray(x_zero, np.float32).reshape(()))
        wsum = (wq.astype(np.float64) * ws.astype(np.float64)).sum(axis=(0, 1, 2)).astype(np.float32)
        b = (b + (z + np.float32(128.0) * s) * wsum).astype(np.float32)
        zero = float(z)
        pad = int(np.clip(np.round(-z / s), 0.0, 255.0)) - 128
    w = np.ascontiguousarray(wq.reshape(taps * c, co).T)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return QArgs(dev(w), dev(yscale), dev(b), float(s), zero, pad, taps)


def pack_qargs_branches(w_int8, w_scale, x_scales, x_zeros, bias, device="cpu") -> tuple[QArgs, ...]:
    """The consolidated multi-branch layer (``LE.__cond_down``: its
    ``qx_scales``/``qx_zeros``, one activation calibration per branch over
    the shared input) as one :class:`QArgs` per branch, branch ``bi`` owning
    output channels ``[bi·m, bi·m + m)``, m = Co / branches: what the JAX
    ``fused_down2`` computes per output channel from the branch's scale and
    zero repeated over its channels."""
    wq = np.asarray(w_int8)
    xs = np.asarray(x_scales, np.float32).reshape(-1)
    xz = None if x_zeros is None else np.asarray(x_zeros, np.float32).reshape(-1)
    nb, co = xs.shape[0], wq.shape[-1]
    if co % nb or (xz is not None and xz.shape[0] != nb):
        raise ValueError(f"{nb} branch scales for {co} output channels, zeros {None if xz is None else xz.shape}")
    m = co // nb
    ws, b = np.asarray(w_scale, np.float32).reshape(co), np.asarray(bias, np.float32).reshape(co)
    return tuple(
        pack_qargs(wq[..., i * m:(i + 1) * m], ws[i * m:(i + 1) * m], xs[i], None if xz is None else xz[i],
                   b[i * m:(i + 1) * m], device)
        for i in range(nb))


def _div(v: torch.Tensor, s: float) -> torch.Tensor:
    """fp32 ``v / s`` rounded once, as IEEE division does: the quotient of
    two fp32 values taken in fp64 and rounded to fp32 is the correctly
    rounded fp32 quotient (a division by a scalar may otherwise become a
    multiplication by its reciprocal)."""
    return (v.double() / s).float()


def _quantize_act(t: torch.Tensor, qa: QArgs) -> torch.Tensor:
    """fp32 activations → int8 codes of the same shape."""
    if qa.zero is None:
        return torch.round(_div(t, qa.scale)).clamp_(-128.0, 127.0).to(torch.int8)
    return (torch.round(_div(t - qa.zero, qa.scale)).clamp_(0.0, 255.0) - 128.0).to(torch.int8)


def _tap_views_q(q: torch.Tensor, pad: int, stride: int = 1) -> list[torch.Tensor]:
    """The nine shifted tap views of codes (H, W, C), taps (dI, dJ) row-major;
    a tap outside the image carries ``pad``. Stride 1: 'same' padding, (H, W)
    views. Stride 2: the (1,0) padding of the s2d down convs, (H/2, W/2)
    views, output (i, j) reading input (2i + dI − 1, 2j + dJ − 1)."""
    h, w, _ = q.shape
    if stride == 1:
        qp = F.pad(q.permute(2, 0, 1), (1, 1, 1, 1), value=pad).permute(1, 2, 0)
        return [qp[di : di + h, dj : dj + w] for di in range(3) for dj in range(3)]
    ho, wo = h // 2, w // 2
    qp = F.pad(q.permute(2, 0, 1), (1, 0, 1, 0), value=pad).permute(1, 2, 0)
    return [qp[di : di + 2 * ho : 2, dj : dj + 2 * wo : 2] for di in range(3) for dj in range(3)]


def _rescale(acc: torch.Tensor, qa: QArgs) -> torch.Tensor:
    """The exact int32 sums (as fp64) → fp32, times yscale, plus the folded
    bias: two rounded ops, per output channel."""
    return acc.float() * qa.yscale + qa.bias


def _taps_conv_q(t: torch.Tensor, qa: QArgs, stride: int = 1) -> torch.Tensor:
    """Quantized 3×3 conv of fp32 ``t`` (H, W, C) with its bias ('same' for
    ``stride`` 1, the (1,0)-padded stride-2 s2d down conv for 2): the exact
    int32 tap sum (taken in fp64, exact for these magnitudes, on any
    device), rounded to fp32, times yscale, plus the folded bias, per output
    channel, (Ho, Wo, Co) fp32."""
    h, w, c = t.shape
    if c != qa.c or qa.taps != 9:
        raise ValueError(f"int8 3×3 conv: input has {c} channels, the weight {qa.c} ({qa.taps} taps)")
    ho, wo = (h, w) if stride == 1 else (h // 2, w // 2)
    w9 = qa.w.reshape(qa.co, 9, c).double()
    acc = torch.zeros((ho * wo, qa.co), dtype=torch.float64, device=t.device)
    for i, v in enumerate(_tap_views_q(_quantize_act(t, qa), qa.pad, stride)):
        acc += v.reshape(ho * wo, c).double() @ w9[:, i].T
    return _rescale(acc, qa).reshape(ho, wo, qa.co)


def _dense_q(v: torch.Tensor, qa: QArgs) -> torch.Tensor:
    """Quantized 1×1 conv of fp32 ``v`` (…, C): codes, the exact int32 sum,
    rescaled, + the folded bias, (…, Co) fp32."""
    if v.shape[-1] != qa.c or qa.taps != 1:
        raise ValueError(f"int8 1×1 conv: input has {v.shape[-1]} channels, the weight {qa.c} ({qa.taps} taps)")
    q = _quantize_act(v, qa).reshape(-1, qa.c)
    return _rescale(q.double() @ qa.w.double().T, qa).reshape(*v.shape[:-1], qa.co)


def check_qargs(name: str, qa: QArgs, c: int, co: int, cuda: bool) -> None:
    """What the int8 forms take: a :class:`QArgs` for C → Co, on the CPU
    for the plain version and, as every kernel's tensors, contiguous and
    aligned on the card when the call launches a kernel."""
    if not isinstance(qa, QArgs):
        raise TypeError(f"{name}: qargs must be an ops.w8a8.QArgs (prepared at load), got {type(qa).__name__}")
    if (qa.c, qa.co) != (c, co):
        raise ValueError(f"{name}: qargs for {qa.c} → {qa.co} channels, the conv is {c} → {co}")
    if not cuda:
        if {t.device.type for t in (qa.w, qa.yscale, qa.bias)} != {"cpu"}:
            raise ValueError(f"{name}: qargs on {qa.w.device}, the activations on the CPU")
        return
    native.check_cuda(f"{name} qargs w", qa.w, torch.int8, (co, qa.taps * c))
    native.check_cuda(f"{name} qargs yscale", qa.yscale, torch.float32, (co,))
    native.check_cuda(f"{name} qargs bias", qa.bias, torch.float32, (co,))
