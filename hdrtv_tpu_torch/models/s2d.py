"""Space-to-depth execution mode (port of ``hdrtv_tpu/models/s2d.py``: the
host-side weight transforms and the frame programs: fp32, bf16 without the
megakernels, and the bf16 megakernel program, the default; each with or
without the HG composite of ``models/hg_s2d.py`` after the base model).

Every activation is stored as (N, H/2, W/2, 4C) blocks in block-major
channel order, and the weights are rewritten once at load so the block-
domain convolutions compute exactly the reference layers (see the JAX
module's docstring). The port keeps this layout as its parity contract with
the JAX package.

Routing: 3×3 stride-1 and stride-2 convs whose input and output channels
are multiples of 128 go to the block_conv3 and down2 kernels, and the
natural /8 stage to trunk3 — the channel conditions of the JAX
``_use_fused_kernel``; its TPU tiling gates (widths % 8, row pickers) size
VMEM and are not part of the contract. Under the bf16 policy, as in the JAX
package with ``HDRTV_MEGAKERNEL=0``, an SFT and the 3×3 conv after it go to
the sft_conv3 kernel, a whole SFT resblock to the resblock kernel, and the
CondNet 1×1 tails to the mix_chain kernel. One tiling gate is kept there:
a resblock takes the resblock kernel only where the TPU program does (an
even row divisor ≥ 4 of its height), because the two forms round the first
conv's result differently and bf16 parity is held rounding point for
rounding point. Each kernel wrapper runs its plain version on CPU tensors.
Everything the JAX package leaves to XLA (the other 1×1 convs, the
12-channel input conv, conv_last, the 2×2 natural convs, the classifier) is
plain torch.

The megakernel program (``_ensemble_mega``) is what bf16 runs where
``_mega_ok`` holds, as in the JAX package: the L0 section of the program
above becomes three kernels, agcm_head (AGCM + the LE input conv), cond_chain
(the five L0 1×1s) and tail (SFT_layer2 + HR_conv2 + conv_last + long skip +
u16 pack), and u8 row-pair planes are consumed and produced directly.
``HDRTV_MEGAKERNEL=0`` in the environment gives the program above back.

Native int8 (W8A8): :func:`attach_native_int8` adds s2d-transformed int8
weights and scales to the (pre-dequantized) float parameters for the layers
the JAX package quantizes, :func:`params_to_torch` prepares each such layer
once (``ops/w8a8.py QArgs``), and the conv kernels take it as ``qargs``
where the JAX code passes ``_qargs_for``: ``conv_s1`` (block_conv3),
``_sft_conv`` (sft_conv3), ``_resblock`` (both convs or neither) and the
mega program's tail (HR_conv2). The stride-2 convs stay float, as in the
JAX package, unless ``HDRTV_INT8_DOWN2=1`` (read at each call): then
``conv_s2`` passes the layer's int8 parameters to down2 (the consolidated
CondNet down conv one per branch) under the JAX routing rule
(:func:`_down2_qargs`), and a layer that rule leaves out runs its float
down2 on the pre-dequantized weight, as the JAX package's lax conv does.
"""

from __future__ import annotations

import numpy as np
import torch

from hdrtv_tpu_torch.models.agcm import classifier_apply
from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig
from hdrtv_tpu_torch.models.hg_s2d import hg_composite_s2d, hg_s2d_transform
from hdrtv_tpu_torch.models.layers import F32, Params, Policy, conv_nhwc, leaky_relu, relu
from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3
from hdrtv_tpu_torch.ops.megakernel import (
    agcm_head_pack,
    agcm_head_pack_s2d,
    fused_agcm_head,
    fused_cond_chain,
    fused_down2,
    fused_mix_chain,
    fused_resblock,
    fused_sft_conv3_v2,
    fused_tail,
    fused_trunk3,
    pick_rows,
    pick_rows_even,
    trunk3_pack,
    trunk3_pack_bf16,
)
from hdrtv_tpu_torch.ops.pack import pack_rgb48
from hdrtv_tpu_torch.ops.resize import (
    downsample_quarter_aa,
    downsample_quarter_aa_flat,
    downsample_quarter_aa_pairs,
)
from hdrtv_tpu_torch.ops.w8a8 import QArgs, pack_qargs, pack_qargs_branches
from hdrtv_tpu_torch.parallel import halo as _halo
from hdrtv_tpu_torch.utils.env import env_bool

# ---------------------------------------------------------------------------
# Data movement: s2d / d2s (block-major channels)
# ---------------------------------------------------------------------------


def s2d(x: torch.Tensor) -> torch.Tensor:
    """(N,H,W,C) → (N,H/2,W/2,4C); channel index = (a*2+b)*C + c."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # N, Hb, Wb, a, b, C
    return x.reshape(n, h // 2, w // 2, 4 * c)


def d2s(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`s2d`."""
    n, hb, wb, c4 = x.shape
    c = c4 // 4
    x = x.reshape(n, hb, wb, 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, hb * 2, wb * 2, c)


def d2s_blocks(x: torch.Tensor) -> torch.Tensor:
    """d2s over the *outer* sub-position factor: (N,Hb,Wb,4K) → (N,2Hb,2Wb,K).
    Used after the PS-folded up-convs: the inner K channels are already in
    s2d order for the finer level."""
    return d2s(x)


# ---------------------------------------------------------------------------
# Weight transforms (host numpy, applied once at load)
# ---------------------------------------------------------------------------


def _blk(ci: int, i: int) -> slice:
    return slice(i * ci, (i + 1) * ci)


def _s2d_taps(stride: int):
    """The populated slots of the s2d form of a 3×3 conv at ``stride``, the
    index rule both transforms and :func:`s2d_slots` read: block tap
    (δI, δJ), input sub-position si = 2·a_in + b_in and output sub-position
    so = 2·a_out + b_out map to the natural offset di = 2δI + a_in −
    stride·a_out (dj likewise), populated where |di|, |dj| ≤ 1. Yields
    (δI, δJ, si, so, di, dj) in (δI, δJ, si) order."""
    for dI in (-1, 0, 1):
        for dJ in (-1, 0, 1):
            for ai in range(2):
                for bi in range(2):
                    for ao in range(2):
                        for bo in range(2):
                            di = 2 * dI + ai - stride * ao
                            dj = 2 * dJ + bi - stride * bo
                            if -1 <= di <= 1 and -1 <= dj <= 1:
                                yield dI, dJ, ai * 2 + bi, ao * 2 + bo, di, dj


def s2d_slots(stride: int) -> tuple[tuple[tuple[int, int], ...], ...]:
    """The non-zero (tap, input sub-position) slots of a :func:`w_s2d_s1`
    (also :func:`w_s2d_s1_ps`, whose PS fold permutes channels only inside a
    sub-position block) or :func:`w_s2d_s2` weight, one tuple per output
    sub-position so = 2·a_out + b_out: the 9 (tap = 3·(δI + 1) + δJ + 1, si)
    of :func:`_s2d_taps`, in (tap, si) order. Every other slot is an exact
    zero. The conv kernels walk K over these slots (``ops/conv_kernels.py
    conv_chunks``)."""
    if stride not in (1, 2):
        raise ValueError(f"s2d slots exist for stride 1 or 2, got {stride}")
    slots: list[list[tuple[int, int]]] = [[] for _ in range(4)]
    for dI, dJ, si, so, _, _ in _s2d_taps(stride):
        slots[so].append((3 * (dI + 1) + dJ + 1, si))
    return tuple(tuple(s) for s in slots)


def w_s2d_s1(w: np.ndarray) -> np.ndarray:
    """(3,3,Ci,Co) stride-1 'same' → (3,3,4Ci,4Co) 'same' over plain s2d.
    Block tap δ with input sub-position a maps to natural offset
    di = 2δ + a_in − a_out; only |di| ≤ 1 slots are populated."""
    kh, kw, ci, co = w.shape
    assert (kh, kw) == (3, 3)
    out = np.zeros((3, 3, 4 * ci, 4 * co), w.dtype)
    for dI, dJ, si, so, di, dj in _s2d_taps(1):
        out[dI + 1, dJ + 1, _blk(ci, si), _blk(co, so)] = w[di + 1, dj + 1]
    return out


def w_s2d_s2(w: np.ndarray) -> np.ndarray:
    """(3,3,Ci,Co) stride-2 'same' → (3,3,4Ci,4Co), stride-2 with (1,0) pad
    over plain s2d; output lands in the next level's s2d layout.
    di = 2δ + a_in − 2·a_out."""
    kh, kw, ci, co = w.shape
    out = np.zeros((3, 3, 4 * ci, 4 * co), w.dtype)
    for dI, dJ, si, so, di, dj in _s2d_taps(2):
        out[dI + 1, dJ + 1, _blk(ci, si), _blk(co, so)] = w[di + 1, dj + 1]
    return out


def w_s2d_s2_nat(w: np.ndarray) -> np.ndarray:
    """(3,3,Ci,Co) stride-2 'same' → (2,2,4Ci,Co) stride-1 with (1,0) pad
    over plain s2d; output in the natural layout of the next level.
    di = 2δ + a_in, δ ∈ {−1, 0}."""
    kh, kw, ci, co = w.shape
    out = np.zeros((2, 2, 4 * ci, co), w.dtype)
    for dI in (-1, 0):
        for dJ in (-1, 0):
            for ai in range(2):
                for bi in range(2):
                    di = 2 * dI + ai
                    dj = 2 * dJ + bi
                    if -1 <= di <= 1 and -1 <= dj <= 1:
                        out[dI + 1, dJ + 1, _blk(ci, ai * 2 + bi), :] = w[di + 1, dj + 1]
    return out


def w_s2d_1x1(w: np.ndarray) -> np.ndarray:
    """(1,1,Ci,Co) → (1,1,4Ci,4Co) block-diagonal."""
    _, _, ci, co = w.shape
    out = np.zeros((1, 1, 4 * ci, 4 * co), w.dtype)
    for s in range(4):
        out[0, 0, _blk(ci, s), _blk(co, s)] = w[0, 0]
    return out


def b_s2d(b: np.ndarray) -> np.ndarray:
    """Bias tiled over the 4 sub-positions (block-major)."""
    return np.tile(b, 4)


def w_ps_permute(w: np.ndarray, r: int = 2) -> np.ndarray:
    """Fold PixelShuffle(r) + s2d into the conv's output channels: output
    channel c*r² + i*r + j (torch PS order) → (i*2+j)*C + c (block-major)."""
    kh, kw, ci, co4 = w.shape
    c = co4 // (r * r)
    perm = np.empty(co4, np.int64)
    for cc in range(c):
        for i in range(r):
            for j in range(r):
                perm[(i * 2 + j) * c + cc] = cc * r * r + i * r + j
    return w[..., perm]


def w_s2d_s1_ps(w: np.ndarray) -> np.ndarray:
    """Stride-1 conv whose (4C) output feeds PixelShuffle: s2d-transform the
    conv, then fold PS ordering so the runtime d2s over sub-positions yields
    the next (finer) level's s2d tensor directly."""
    t = w_s2d_s1(w)  # (3,3,4Ci, 4*(4C))
    kh, kw, ci4, co4 = t.shape
    co = co4 // 4
    out = np.empty_like(t)
    for s in range(4):
        out[..., _blk(co, s)] = w_ps_permute(t[..., _blk(co, s)])
    return out


# ---------------------------------------------------------------------------
# Parameter transform
# ---------------------------------------------------------------------------

_S1 = "s1"
_S2 = "s2"  # stride-2, s2d output
_S2N = "s2nat"  # stride-2, natural output
_P11 = "1x1"
_NAT = "nat"
_PSL = "ps"  # stride-1 conv feeding PixelShuffle (s2d domain)
_NATPS = "natps"  # natural conv feeding PixelShuffle whose output enters s2d


def _le_layer_roles(prefix: str = "LE.") -> dict[str, str]:
    r: dict[str, str] = {}
    r[f"{prefix}conv_first"] = _S1
    r[f"{prefix}HR_conv1"] = _S1
    r[f"{prefix}HR_conv2"] = _S1
    r[f"{prefix}conv_last"] = _S1
    for sft in ("SFT_layer1", "SFT_layer2"):
        for cv in ("SFT_scale_conv0", "SFT_scale_conv1", "SFT_shift_conv0", "SFT_shift_conv1"):
            r[f"{prefix}{sft}.{cv}"] = _P11
    r[f"{prefix}cond_first.0"] = _S1
    r[f"{prefix}cond_first.2"] = _P11
    r[f"{prefix}cond_first.4"] = _P11
    for i in (0, 2, 4):
        r[f"{prefix}CondNet1.{i}"] = _P11
    r[f"{prefix}CondNet2.0"] = _S2
    r[f"{prefix}CondNet2.2"] = _P11
    r[f"{prefix}CondNet2.4"] = _P11
    r[f"{prefix}CondNet3.0"] = _S2
    r[f"{prefix}CondNet3.2"] = _S2
    r[f"{prefix}CondNet3.4"] = _P11
    r[f"{prefix}CondNet4.0"] = _S2
    r[f"{prefix}CondNet4.2"] = _S2
    r[f"{prefix}CondNet4.4"] = _S2N
    r[f"{prefix}down_conv1"] = _S2
    r[f"{prefix}down_conv2"] = _S2
    r[f"{prefix}down_conv3"] = _S2N
    # trunks 1/2/4/5 live in s2d levels; trunk3 stays natural (odd /8 dims).
    for trunk in ("recon_trunk1", "recon_trunk2", "recon_trunk4", "recon_trunk5"):
        r[f"{prefix}{trunk}.0.conv1"] = _S1
        r[f"{prefix}{trunk}.0.conv2"] = _S1
        for sft in ("sft1", "sft2"):
            for cv in ("SFT_scale_conv0", "SFT_scale_conv1", "SFT_shift_conv0", "SFT_shift_conv1"):
                r[f"{prefix}{trunk}.0.{sft}.{cv}"] = _P11
    for i in range(4):
        r[f"{prefix}recon_trunk3.{i}.conv1"] = _NAT
        r[f"{prefix}recon_trunk3.{i}.conv2"] = _NAT
        for sft in ("sft1", "sft2"):
            for cv in ("SFT_scale_conv0", "SFT_scale_conv1", "SFT_shift_conv0", "SFT_shift_conv1"):
                r[f"{prefix}recon_trunk3.{i}.{sft}.{cv}"] = _NAT
    r[f"{prefix}up_conv1.0"] = _NATPS
    r[f"{prefix}up_conv2.0"] = _PSL
    r[f"{prefix}up_conv3.0"] = _PSL
    return r


def _agcm_layer_roles(prefix: str = "AGCM.") -> dict[str, str]:
    return {
        f"{prefix}conv_first": _P11,
        f"{prefix}HRconv": _P11,
        f"{prefix}conv_last": _P11,
    }


def s2d_transform_params(params: dict, cfg: ModelConfig | None = None) -> dict:
    """Host-side weight rewrite for s2d execution (fp32 numpy). Composite (HG)
    checkpoints arrive with ``base.``-prefixed ensemble keys plus ``hg.*``:
    the base transforms with the standard roles (prefix stripped, the s2d
    forward uses unprefixed names), the HG level-1 layers through
    ``models/hg_s2d.py hg_s2d_transform``."""
    if any(k.startswith("base.") for k in params):
        base = {k[len("base."):]: v for k, v in params.items() if k.startswith("base.")}
        rest = {k: v for k, v in params.items() if not k.startswith("base.")}
        out = s2d_transform_params(base, cfg)
        out.update(hg_s2d_transform(rest))
        return out
    roles = {**_le_layer_roles(), **_agcm_layer_roles()}
    out: dict[str, np.ndarray] = {}
    handled: set[str] = set()
    for layer, role in roles.items():
        wk, bk = f"{layer}.weight", f"{layer}.bias"
        if wk not in params:
            continue
        w = np.asarray(params[wk], np.float32)
        b = params.get(bk)
        b = None if b is None else np.asarray(b, np.float32)
        if role == _NAT:
            out[wk] = w
            if b is not None:
                out[bk] = b
        elif role == _S1:
            out[wk] = w_s2d_s1(w)
            if b is not None:
                out[bk] = b_s2d(b)
        elif role == _S2:
            out[wk] = w_s2d_s2(w)
            if b is not None:
                out[bk] = b_s2d(b)
        elif role == _S2N:
            out[wk] = w_s2d_s2_nat(w)
            if b is not None:
                out[bk] = b
        elif role == _P11:
            out[wk] = w_s2d_1x1(w)
            if b is not None:
                out[bk] = b_s2d(b)
        elif role == _NATPS:
            out[wk] = w_ps_permute(w)
            if b is not None:
                out[bk] = w_ps_permute(b.reshape(1, 1, 1, -1))[0, 0, 0]
        elif role == _PSL:
            out[wk] = w_s2d_s1_ps(w)
            if b is not None:
                bb = w_ps_permute(b.reshape(1, 1, 1, -1))[0, 0, 0]
                out[bk] = np.tile(bb, 4)
        handled.add(wk)
        handled.add(bk)
    # pass through everything else (classifier, linears, scales, ...)
    for k, v in params.items():
        if k not in handled and k not in out:
            out[k] = np.asarray(v)

    # Exact consolidations: convs sharing one input fuse into a single wider
    # conv (one pass over the input instead of N) — outputs split afterwards.
    if "LE.conv_first.weight" in out and "LE.cond_first.0.weight" in out:
        out["LE.__in_fused.weight"] = np.concatenate(
            (out["LE.conv_first.weight"], out["LE.cond_first.0.weight"]), axis=-1
        )
        out["LE.__in_fused.bias"] = np.concatenate(
            (out["LE.conv_first.bias"], out["LE.cond_first.0.bias"])
        )
    down_keys = [f"LE.CondNet{i}.0" for i in (2, 3, 4)]
    if all(f"{k}.weight" in out for k in down_keys):
        out["LE.__cond_down.weight"] = np.concatenate(
            [out[f"{k}.weight"] for k in down_keys], axis=-1
        )
        out["LE.__cond_down.bias"] = np.concatenate([out[f"{k}.bias"] for k in down_keys])
    return out


def attach_native_int8(sp: dict, raw: dict) -> dict:
    """Attach s2d-transformed int8 weights and scales for the quantized
    layers (the JAX ``attach_native_int8``). ``sp`` is the float
    (pre-dequantized) s2d parameter dict; ``raw`` the original checkpoint
    with ``.weight_int8`` / ``.w_scale`` / ``.x_scale`` (/ ``.x_zero``). The
    s2d weight transforms only insert zeros and permute, so they are exact on
    the int8 codes; per-output-channel scales tile like biases. Only layers
    of the roles the kernels quantize (stride-1, stride-2, PixelShuffle-folded
    3×3s and the 1×1s) whose s2d channels are multiples of 128 attach;
    everything else keeps its pre-dequantized float weight. The three CondNet
    down convs also attach as the consolidated ``LE.__cond_down`` when their
    calibration style is uniform (all symmetric or all asymmetric); otherwise
    its float weight goes and the program takes the split form."""
    if any(k.startswith("base.") for k in raw):
        raw = {k[len("base."):] if k.startswith("base.") else k: v for k, v in raw.items()}
    out = dict(sp)
    for layer, role in _le_layer_roles().items():
        qk = f"{layer}.weight_int8"
        if qk not in raw or f"{layer}.x_scale" not in raw:
            continue
        if role not in (_S1, _S2, _PSL, _P11):
            continue
        wq = np.asarray(raw[qk])
        wsc = np.asarray(raw.get(f"{layer}.w_scale", raw.get(f"{layer}.scale")), np.float32)
        if role == _S1:
            tq, tsc = w_s2d_s1(wq), b_s2d(wsc)
        elif role == _PSL:
            tq = w_s2d_s1_ps(wq)
            tsc = np.tile(w_ps_permute(wsc.reshape(1, 1, 1, -1))[0, 0, 0], 4)
        elif role == _P11:
            tq, tsc = w_s2d_1x1(wq), b_s2d(wsc)
        else:
            tq, tsc = w_s2d_s2(wq), b_s2d(wsc)
        if tq.shape[2] % 128 or tq.shape[3] % 128:
            continue
        out[f"{layer}.qweight"] = tq
        out[f"{layer}.qw_scale"] = tsc
        out[f"{layer}.qx_scale"] = np.float32(raw[f"{layer}.x_scale"])
        if f"{layer}.x_zero" in raw:
            out[f"{layer}.qx_zero"] = np.float32(raw[f"{layer}.x_zero"])
    branches = [f"LE.CondNet{i}.0" for i in (2, 3, 4)]
    if all(f"{b}.qweight" in out for b in branches) and "LE.__cond_down.weight" in out:
        zeros = [f"{b}.qx_zero" in out for b in branches]
        if all(zeros) or not any(zeros):
            out["LE.__cond_down.qweight"] = np.concatenate([out[f"{b}.qweight"] for b in branches], axis=-1)
            out["LE.__cond_down.qw_scale"] = np.concatenate([out[f"{b}.qw_scale"] for b in branches])
            out["LE.__cond_down.qx_scales"] = np.asarray([out[f"{b}.qx_scale"] for b in branches], np.float32)
            if all(zeros):
                out["LE.__cond_down.qx_zeros"] = np.asarray([out[f"{b}.qx_zero"] for b in branches], np.float32)
        else:
            out.pop("LE.__cond_down.weight", None)
            out.pop("LE.__cond_down.bias", None)
    return out


_SFT_CONVS = ("SFT_scale_conv0", "SFT_scale_conv1", "SFT_shift_conv0", "SFT_shift_conv1")
_TRUNK3_PACKED = "LE.__trunk3_packed"
_TRUNK3_PACKED_BF16 = ("LE.__trunk3_packed_bf16_w", "LE.__trunk3_packed_bf16_b")
# What the megakernel program needs in the parameters, the layers whose
# biases its kernels take, and what params_to_torch prepares for the head
# kernel: AGCM.conv_first's (12, C) matrix with its rows permuted for a BGR
# frame, and agcm_head_pack's padded matrices (aw1 for RGB and for BGR;
# fp32 weights) or _HEAD_PACKED_S2D (bf16 weights).
_MEGA_KEYS = ("LE.__in_fused.weight", "AGCM.conv_first.weight", "LE.conv_last.weight")
_MEGA_BIASES = ("AGCM.conv_first", "AGCM.HRconv", "AGCM.conv_last", "LE.__in_fused", "LE.cond_first.2",
                "LE.cond_first.4", "LE.CondNet1.0", "LE.CondNet1.2", "LE.CondNet1.4", "LE.HR_conv2",
                "LE.conv_last")
_HEAD_AW1_BGR = "AGCM.__conv_first_bgr"
_HEAD_PACKED = ("AGCM.__head_aw1", "AGCM.__head_aw1_bgr", "AGCM.__head_aw3", "LE.__head_wcat")
# agcm_head_pack_s2d's blocks and gathered input conv (aw1's block for RGB and for BGR)
_HEAD_PACKED_S2D = ("AGCM.__head_s2d_w1", "AGCM.__head_s2d_w1_bgr", "AGCM.__head_s2d_w2", "AGCM.__head_s2d_w3",
                    "LE.__head_s2d_win", "LE.__head_s2d_bin")
_HG_KEY = "hg.conv1.0.weight"  # a checkpoint carries the s2d HG iff it has this
_HG_TAIL_BIASES = ("hg.conv10.bias", "hg.conv_last.bias")


def _fits_kernel(w) -> bool:
    """The channel condition of the conv kernels: C and Co multiples of 128."""
    return w.shape[2] % 128 == 0 and w.shape[3] % 128 == 0


def _fp32_param_names(params_np: dict) -> set[str]:
    """Parameters that stay fp32 under a narrower policy: the biases that go
    to a kernel (the kernels take fp32 biases, as the Pallas kernels do) and
    the norm scales and shifts (``instance_norm`` computes in fp32). A kernel
    takes a layer's bias where ``_use_fused_kernel`` routes it at batch 1. Of
    the HG, whose convs are plain torch ops, only the two biases the hg_tail
    kernel reads stay fp32 (the torch-op tail rounds them as it adds them)."""
    def fits(layer):
        w = params_np.get(f"{layer}.weight")
        return w is not None and w.ndim == 4 and _fits_kernel(w)

    keep = set()
    for k, v in params_np.items():
        if not k.endswith(".weight"):
            continue
        layer = k[: -len(".weight")]
        if k.startswith("hg."):
            continue
        if v.ndim == 1:  # a norm's scale, and its shift
            keep |= {k, f"{layer}.bias"}
        elif v.ndim == 4 and v.shape[:2] == (3, 3) and _fits_kernel(v):
            keep.add(f"{layer}.bias")
    sft_pairs = [("LE.SFT_layer1", "LE.HR_conv1"), ("LE.SFT_layer2", "LE.HR_conv2")]
    for trunk in (1, 2, 4, 5):
        sft_pairs += [(f"LE.recon_trunk{trunk}.0.sft{i}", f"LE.recon_trunk{trunk}.0.conv{i}") for i in (1, 2)]
    for sft, conv in sft_pairs:
        if fits(conv):
            keep |= {f"{sft}.{cv}.bias" for cv in _SFT_CONVS}
    if fits("LE.CondNet2.2"):  # the mix_chain tail
        keep |= {"LE.CondNet2.2.bias", "LE.CondNet2.4.bias"}
    if all(k in params_np for k in _MEGA_KEYS):  # agcm_head, cond_chain, tail
        # at every width: the JAX megakernel program hands these kernels the
        # biases as its parameters hold them, fp32
        keep |= {f"{layer}.bias" for layer in _MEGA_BIASES}
        keep |= {f"LE.SFT_layer2.{cv}.bias" for cv in _SFT_CONVS}
    keep |= {k for k in params_np if k.endswith(".bias")
             and (k.startswith("LE.recon_trunk3.") or k.startswith("LE.up_conv1."))}
    keep |= {k for k in _HG_TAIL_BIASES if k in params_np}
    return keep


_QSCALES = (".qw_scale", ".qx_scale", ".qx_zero", ".qx_scales", ".qx_zeros")
_QARGS = ".__qargs"  # the prepared ops/w8a8.py QArgs of a native-int8 layer


def params_to_torch(params_np: dict, device, policy: Policy = F32) -> Params:
    """Carry the (transformed) numpy parameters to ``device`` as
    :func:`cast_params` does, and prepare what depends on the parameters
    only: the BGR-permuted AGCM.conv_first, and the pack of the weights'
    element type for trunk3 (bf16 :func:`trunk3_pack_bf16`, fp32
    :func:`trunk3_pack`) and for the head (bf16 the s2d form's blocks, fp32
    the dense kernels' padded matrices)."""
    out = cast_params(params_np, device, policy)
    # Each kernel's pack is built for the element type that reads it: trunk3's
    # bf16 instance reads trunk3_pack_bf16, its fp32 one trunk3_pack; the
    # head's bf16 s2d kernels agcm_head_pack_s2d, its fp32 dense kernels
    # agcm_head_pack (the frame programs pass s2d=True to both).
    if "LE.recon_trunk3.0.conv1.weight" in out and "LE.up_conv1.0.weight" in out:
        if out["LE.up_conv1.0.weight"].dtype == torch.bfloat16:
            out.update(zip(_TRUNK3_PACKED_BF16, trunk3_pack_bf16(*_trunk3_params(out)), strict=True))
        else:
            out[_TRUNK3_PACKED] = trunk3_pack(*_trunk3_params(out))
    if all(k in out for k in _MEGA_KEYS):
        aw1 = out["AGCM.conv_first.weight"][0, 0]
        # Only AGCM.conv_first reads the source frame: a BGR frame permutes
        # its rows within each pixel's three, and nothing else.
        perm = torch.tensor([(k // 3) * 3 + 2 - (k % 3) for k in range(aw1.shape[0])], device=aw1.device)
        aw1_bgr = aw1[perm].contiguous()
        out[_HEAD_AW1_BGR] = aw1_bgr
        aw3, w_in = out["AGCM.conv_last.weight"][0, 0], out["LE.__in_fused.weight"]
        if aw1.dtype == torch.bfloat16:
            aw2, b_in = out["AGCM.HRconv.weight"][0, 0], out["LE.__in_fused.bias"]
            n_first = out["LE.conv_first.bias"].shape[-1]
            w1, w2, w3, win, bin_ = agcm_head_pack_s2d(aw1, aw2, aw3, w_in, b_in, n_first=n_first)
            w1_bgr = agcm_head_pack_s2d(aw1_bgr, aw2, aw3, w_in, b_in, n_first=n_first)[0]
            out.update(zip(_HEAD_PACKED_S2D, (w1, w1_bgr, w2, w3, win, bin_), strict=True))
        else:
            aw1p, aw3p, wcat = agcm_head_pack(aw1, aw3, w_in)
            aw1p_bgr = agcm_head_pack(aw1_bgr, aw3, w_in)[0]
            out.update(zip(_HEAD_PACKED, (aw1p, aw1p_bgr, aw3p, wcat), strict=True))
    return out


def cast_params(params_np: dict, device, policy: Policy = F32) -> Params:
    """The numpy parameters on ``device``, cast once to what ``policy``
    computes with: floating arrays as contiguous tensors of the compute
    dtype, except the fp32 set of :func:`_fp32_param_names` and the
    native-int8 scales; anything else (the int8 ``.qweight`` codes among it)
    with its dtype. For each native-int8 3×3 layer also its ``QArgs`` under
    ``{layer}.__qargs`` (what ``_qargs_for`` and :func:`_down2_qargs`
    return; for the consolidated CondNet down conv, with its per-branch
    ``qx_scales``, a tuple of one per branch). The int8 1×1s, which no frame
    program quantizes (cond_chain's int8 steps take ``QArgs`` from the
    caller), stay as their raw keys. No kernel pack: :func:`params_to_torch`
    adds those."""
    keep = _fp32_param_names(params_np)
    out = {}
    for k, v in params_np.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.is_floating_point():
            t = t.to(torch.float32 if k in keep or k.endswith(_QSCALES) else policy.compute_dtype)
        out[k] = t.to(device).contiguous()
    conv3 = {layer for layer, role in _le_layer_roles().items() if role in (_S1, _PSL, _S2)} | {"LE.__cond_down"}
    for k in params_np:
        layer = k[: -len(".qweight")]
        if not (k.endswith(".qweight") and layer in conv3):
            continue
        args = (params_np[k], params_np[f"{layer}.qw_scale"])
        if f"{layer}.qx_scales" in params_np:
            out[layer + _QARGS] = pack_qargs_branches(
                *args, params_np[f"{layer}.qx_scales"], params_np.get(f"{layer}.qx_zeros"),
                params_np[f"{layer}.bias"], device)
        elif f"{layer}.qx_scale" in params_np:
            out[layer + _QARGS] = pack_qargs(
                *args, params_np[f"{layer}.qx_scale"], params_np.get(f"{layer}.qx_zero"),
                params_np[f"{layer}.bias"], device)
    return out


# ---------------------------------------------------------------------------
# Block-domain conv helpers
# ---------------------------------------------------------------------------


def _conv(p: Params, name: str, x: torch.Tensor, *, stride=1, padding=0, policy: Policy) -> torch.Tensor:
    b = p.get(f"{name}.bias")
    return conv_nhwc(policy.cast(x), policy.cast(p[f"{name}.weight"]),
                     None if b is None else policy.cast(b), stride=stride, padding=padding)


def _use_fused_kernel(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Route to a conv kernel: batch 1, C and Co multiples of 128."""
    return x.shape[0] == 1 and _fits_kernel(w)


def _qargs_for(p: Params, layer: str, x: torch.Tensor) -> QArgs | None:
    """The native-int8 parameters of ``layer`` (prepared at load) when the
    JAX program quantizes it for this input, else None. The JAX package
    quantizes a layer inside its conv kernels only, and takes those where its
    ``_use_fused_kernel`` holds, whose width rule (Wb % 8 == 0) the port's
    kernels do not need: at a level whose width breaks it, both packages run
    the layer in float on the pre-dequantized weight."""
    qa = p.get(layer + _QARGS)
    return qa if qa is not None and x.shape[2] % 8 == 0 else None


def _down2_qargs(p: Params, layer: str, x: torch.Tensor, a_sub: int):
    """The int8 parameters ``conv_s2`` passes to down2 for ``layer`` (one
    ``QArgs``, or a tuple of one per branch), or None, by the JAX
    ``conv_s2``'s rule: only with ``HDRTV_INT8_DOWN2=1`` (read at each call),
    only where the JAX package takes its fused down2 kernel (the Wb % 8 of
    ``_use_fused_kernel``, (Wb/2) % 8 and ``pick_rows(Hb/2, limit=8) <= 16``;
    elsewhere it runs a lax conv on the pre-dequantized float weight), and
    only where each of the a_sub output halves holds at least 128 channels
    (at nf = 32 that leaves LE.down_conv1/2, Co = 128, in float)."""
    qa = p.get(layer + _QARGS)
    if qa is None or not env_bool("HDRTV_INT8_DOWN2", False):
        return None
    hb, wb = x.shape[1], x.shape[2]
    if wb % 8 or (wb // 2) % 8 or pick_rows(hb // 2, limit=8) > 16:
        return None
    if p[f"{layer}.weight"].shape[-1] // (2 * a_sub) < 128:
        return None
    return qa


def conv_s1(p, name, x, *, policy, relu_fused: bool = False, skip: torch.Tensor | None = None):
    """Stride-1 3×3 in block domain: 3×3 'same' over plain s2d; the
    block_conv3 kernel with bias/ReLU/skip fused when the channels fit, in
    its int8 form on a native-int8 layer. Every weight here is a w_s2d_s1
    transform or its PS fold, so the call declares it (``a_sub``, the JAX
    values) and the kernel skips its structural zeros. LE.__in_fused's 2
    reads two equal blocks, which its blocks (conv_first, cond_first.0) are
    not at nf = 32; its C = 12 never fits the kernels, as in JAX, whose gate
    turns such an ``a_sub`` off. On a sharded frame: one halo stage, radius 1."""
    if _halo.active():
        return _halo.run_stage(
            lambda xx, sk: conv_s1(p, name, xx, policy=policy, relu_fused=relu_fused, skip=sk),
            [x, skip], [2, 2], need=1, mod=8, out_axis=2,
        )
    w = p[f"{name}.weight"]
    if _use_fused_kernel(x, w):
        return fused_block_conv3(
            policy.cast(x[0]), policy.cast(w), p[f"{name}.bias"], relu=relu_fused,
            skip=None if skip is None else policy.cast(skip[0]), qargs=_qargs_for(p, name, x),
            a_sub=2 if name.endswith("__in_fused") else 1,
        )[None]
    y = _conv(p, name, x, padding=1, policy=policy)
    if skip is not None:
        y = y + policy.cast(skip)
    if relu_fused:
        y = relu(y)
    return y


def conv_s2(p, name, x, *, policy, relu_fused: bool = False, act: str | None = None, a_sub: int = 1,
            cin: int | None = None, ch0: int = 0):
    """Stride-2 3×3, s2d output: 3×3 stride-2, (1,0) pad over plain s2d; the
    down2 kernel with the activation fused, in its int8 form where
    :func:`_down2_qargs` gives the layer's parameters. ``a_sub``: the
    consolidated sub-blocks along Co (3 for LE.__cond_down). ``cin``/``ch0``:
    consume the ``[ch0:ch0+cin]`` channel window of a wider ``x`` (the kernel
    reads it in place; the torch path slices). On a sharded frame the window
    is sliced first, then one halo stage (mod 16 keeps the half width of
    the extended window a multiple of 8, as on one device)."""
    if relu_fused:
        act = "relu"
    if _halo.active():
        if cin is not None:
            x = x[..., ch0 : ch0 + cin]
        return _halo.run_stage(
            lambda xx: conv_s2(p, name, xx, policy=policy, act=act, a_sub=a_sub),
            [x], [2], need=2, mod=16, out_axis=2, out_stride=2,
        )
    w = p[f"{name}.weight"]
    hb, wb = x.shape[1], x.shape[2]
    if _use_fused_kernel(x, w) and hb % 2 == 0 and wb % 2 == 0:
        return fused_down2(
            policy.cast(x[0]), policy.cast(w), p[f"{name}.bias"], act=act, cin=cin, ch0=ch0,
            qargs=_down2_qargs(p, name, x, a_sub), a_sub=a_sub,
        )[None]
    if cin is not None:
        x = x[..., ch0 : ch0 + cin]
    y = _conv(p, name, x, stride=2, padding=((1, 0), (1, 0)), policy=policy)
    if act == "relu":
        return relu(y)
    if act == "lrelu":
        return leaky_relu(y, 0.1)
    return y


def conv_s2_nat(p, name, x, *, policy):
    """Stride-2 3×3, natural output: 2×2 stride-1, (1,0) pad over plain s2d."""
    if _halo.active():
        return _halo.run_stage(
            lambda xx: conv_s2_nat(p, name, xx, policy=policy), [x], [2], need=1, mod=2, out_axis=2,
        )
    return _conv(p, name, x, padding=((1, 0), (1, 0)), policy=policy)


def conv_1x1(p, name, x, *, policy):
    y = torch.matmul(policy.cast(x), policy.cast(p[f"{name}.weight"][0, 0]))
    return y + policy.cast(p[f"{name}.bias"])


# ---------------------------------------------------------------------------
# Forward (release arch: AGCM color_condition + LE sft, no HG)
# ---------------------------------------------------------------------------


def _sft(p, name, fea, cond, *, policy):
    def branch(kind):
        h = leaky_relu(conv_1x1(p, f"{name}.SFT_{kind}_conv0", cond, policy=policy), 0.1)
        return conv_1x1(p, f"{name}.SFT_{kind}_conv1", h, policy=policy)

    return fea * (branch("scale") + 1.0) + branch("shift")


def _sft4_bd(p, sft_name, policy):
    """The four SFT 1×1s as dense (C,C') matrices + fp32 biases."""
    return [(policy.cast(p[f"{sft_name}.{cv}.weight"][0, 0]), p[f"{sft_name}.{cv}.bias"])
            for cv in _SFT_CONVS]


def _sft_conv_ok(p, conv_name, x, cond, *, policy) -> bool:
    """The fused SFT kernels serve the bf16 policy only, as in the JAX package."""
    return (
        policy.compute_dtype == torch.bfloat16
        and _use_fused_kernel(x, p[f"{conv_name}.weight"])
        and cond.shape[-1] % 8 == 0
    )


def _sft_conv(p, sft_name, conv_name, x, cond, *, policy, relu_fused=False, skip=None):
    """SFT + 3×3 conv: the sft_conv3 kernel when eligible, SFT then conv
    otherwise. Every caller's weights come from :func:`s2d_transform_params`
    (the SFT 1×1s ``w_s2d_1x1``, their biases ``b_s2d``, the conv
    ``w_s2d_s1``): the kernel is told so (``s2d=True``) and skips their
    zeros. On a sharded frame: one halo stage for the pair (the SFT is
    pointwise)."""
    if _halo.active():
        return _halo.run_stage(
            lambda xx, cc, sk: _sft_conv(p, sft_name, conv_name, xx, cc, policy=policy, relu_fused=relu_fused,
                                         skip=sk),
            [x, cond, skip], [2, 2, 2], need=1, mod=8, out_axis=2,
        )
    if _sft_conv_ok(p, conv_name, x, cond, policy=policy):
        return fused_sft_conv3_v2(
            policy.cast(x[0]), policy.cast(cond[0]), _sft4_bd(p, sft_name, policy),
            policy.cast(p[f"{conv_name}.weight"]), p[f"{conv_name}.bias"],
            relu=relu_fused, skip=None if skip is None else policy.cast(skip[0]),
            qargs=_qargs_for(p, conv_name, x), s2d=True,
        )[None]
    out = _sft(p, sft_name, x, cond, policy=policy)
    return conv_s1(p, conv_name, out, policy=policy, relu_fused=relu_fused, skip=skip)


def _materialize_up(fea, up_coarse, x_add):
    """The up-path skip add: d2s(up_coarse) + fea, or x_add + fea."""
    if up_coarse is not None:
        return d2s_blocks(up_coarse) + fea
    if x_add is not None:
        return x_add + fea
    return fea


def _resblock(p, name, fea, cond, *, policy, up_coarse=None, x_add=None):
    """ResBlock_with_SFT in the block domain. ``up_coarse``/``x_add``: the
    optional up-path skip input, added to ``fea`` first — inside the resblock
    kernel when eligible (with the d2s un-fold for the coarse form),
    materialised otherwise. The kernel is taken under the JAX predicate,
    its even-row rule included (see the module docstring), and told that
    the weights are s2d transforms (``s2d=True``, as in :func:`_sft_conv`).
    On a sharded frame: one halo stage, radius 2 (two convs), ``up_coarse``
    at r/2 in its half-res domain."""
    if _halo.active():
        return _halo.run_stage(
            lambda f, c, uc, xa: _resblock(p, name, f, c, policy=policy, up_coarse=uc, x_add=xa),
            [fea, cond, up_coarse, x_add], [2, 2, 2, 2], need=2, mod=8, out_axis=2, coarse_idx=(2,),
        )
    if _sft_conv_ok(p, f"{name}.conv1", fea, cond, policy=policy):
        coarse_ok = up_coarse is None or (
            fea.shape[1] % 2 == 0
            and fea.shape[2] % 2 == 0
            and tuple(up_coarse.shape[1:]) == (fea.shape[1] // 2, fea.shape[2] // 2, 4 * fea.shape[3])
        )
        if pick_rows_even(fea.shape[1]) >= 4 and coarse_ok:
            q1 = _qargs_for(p, f"{name}.conv1", fea)
            q2 = _qargs_for(p, f"{name}.conv2", fea)
            both = q1 is not None and q2 is not None
            return fused_resblock(
                policy.cast(fea[0]), policy.cast(cond[0]),
                _sft4_bd(p, f"{name}.sft1", policy),
                policy.cast(p[f"{name}.conv1.weight"]), p[f"{name}.conv1.bias"],
                _sft4_bd(p, f"{name}.sft2", policy),
                policy.cast(p[f"{name}.conv2.weight"]), p[f"{name}.conv2.bias"],
                up_coarse=None if up_coarse is None else policy.cast(up_coarse[0]),
                x_add=None if x_add is None else policy.cast(x_add[0]),
                qargs1=q1 if both else None, qargs2=q2 if both else None, s2d=True,
            )[None]
    fea = _materialize_up(fea, up_coarse, x_add)
    out = _sft_conv(p, f"{name}.sft1", f"{name}.conv1", fea, cond, policy=policy, relu_fused=True)
    # conv2 + residual add fused into the same pass
    return _sft_conv(p, f"{name}.sft2", f"{name}.conv2", out, cond, policy=policy, skip=fea)


def _trunk3_params(p, policy: Policy | None = None):
    """(blocks, w_up, b_up) of the trunk3 stage, as ``fused_trunk3`` takes them."""
    def cast(w):
        return w if policy is None else policy.cast(w)

    def sft(name):
        return [(cast(p[f"{name}.{cv}.weight"][0, 0]), p[f"{name}.{cv}.bias"]) for cv in _SFT_CONVS]

    blocks = []
    for i in range(4):
        name = f"LE.recon_trunk3.{i}"
        blocks.append((
            sft(f"{name}.sft1"), cast(p[f"{name}.conv1.weight"]), p[f"{name}.conv1.bias"],
            sft(f"{name}.sft2"), cast(p[f"{name}.conv2.weight"]), p[f"{name}.conv2.bias"],
        ))
    return blocks, cast(p["LE.up_conv1.0.weight"]), p["LE.up_conv1.0.bias"]


def _trunk3_up_fused(p, fea3, cond4, *, policy):
    """Whole trunk3 stage + up_conv1 through the trunk3 kernel, with the
    parameter block ``params_to_torch`` packed (if it made one for this
    element type). On a sharded frame: one halo stage, radius 9 in the
    natural /8 domain (8 convs and up_conv1); shards narrower than 2r take
    the gather path."""
    if _halo.active():
        return _halo.run_stage(
            lambda f, c: _trunk3_up_fused(p, f, c, policy=policy), [fea3, cond4], [2, 2], need=9, mod=8,
            out_axis=2,
        )
    blocks, w_up, b_up = _trunk3_params(p, policy)
    dt = p["LE.up_conv1.0.weight"].dtype
    packed = None
    if dt == policy.compute_dtype:
        packed = p.get(_TRUNK3_PACKED) if dt == torch.float32 else tuple(p[k] for k in _TRUNK3_PACKED_BF16)
    return fused_trunk3(policy.cast(fea3[0]), policy.cast(cond4[0]), blocks, w_up, b_up,
                        packed=packed)[None]


def _tile4(v: torch.Tensor) -> torch.Tensor:
    """(N,C) modulation vector → (N,1,1,4C) for block-major s2d tensors."""
    n, c = v.shape
    return v.repeat(1, 4).reshape(n, 1, 1, 4 * c)


def agcm_s2d(p: Params, xs: torch.Tensor, cond_nat: torch.Tensor, *, policy: Policy) -> torch.Tensor:
    """AGCM (dynamic color_condition) on an s2d frame; the classifier runs on
    the natural ¼-res condition image."""
    fea = classifier_apply(p, "AGCM.classifier.", "color_condition", cond_nat, policy=policy)

    def lin(name):
        w = policy.cast(p[f"{name}.weight"])
        return torch.matmul(policy.cast(fea), w) + policy.cast(p[f"{name}.bias"])

    def mod(out, scale, shift):
        return out * _tile4(scale) + _tile4(shift) + out

    out = conv_1x1(p, "AGCM.conv_first", xs, policy=policy)
    out = relu(mod(out, lin("AGCM.cond_scale_first"), lin("AGCM.cond_shift_first")))
    out = conv_1x1(p, "AGCM.HRconv", out, policy=policy)
    out = relu(mod(out, lin("AGCM.cond_scale_HR"), lin("AGCM.cond_shift_HR")))
    out = conv_1x1(p, "AGCM.conv_last", out, policy=policy)
    return mod(out, lin("AGCM.cond_scale_last"), lin("AGCM.cond_shift_last"))


def _le_cond_downs(p: Params, c: torch.Tensor, *, policy: Policy):
    """CondNet2/3/4 down chains from the shared cond feature ``c``. With the
    consolidated LE.__cond_down conv, the three branch inputs are channel
    windows of its (…, 3·nch) output, read in place by the down2 kernel."""
    def mix_chain(x, steps, *, cin=None, ch0=0):
        """Short 1×1 chains: the mix_chain kernel when eligible (bf16). Every
        1×1 weight here is a w_s2d_1x1 transform, its bias b_s2d, so the
        call declares it (s2d=True) and the kernel multiplies the diagonal
        blocks only."""
        if policy.compute_dtype == torch.bfloat16 and _use_fused_kernel(x, p[f"{steps[0][0]}.weight"]):
            return fused_mix_chain(
                policy.cast(x[0]),
                [(policy.cast(p[f"{n}.weight"][0, 0]), p[f"{n}.bias"], act) for n, act in steps],
                cin=cin, ch0=ch0, s2d=True,
            )[None]
        if cin is not None:
            x = x[..., ch0 : ch0 + cin]
        for n, act in steps:
            x = conv_1x1(p, n, x, policy=policy)
            if act == "lrelu":
                x = leaky_relu(x, 0.1)
        return x

    if "LE.__cond_down.weight" in p:
        cd = conv_s2(p, "LE.__cond_down", c, policy=policy, act="lrelu", a_sub=3)
        nch = cd.shape[-1] // 3
        cond2 = mix_chain(
            cd, [("LE.CondNet2.2", "lrelu"), ("LE.CondNet2.4", None)], cin=nch, ch0=0
        )
        c3 = conv_s2(p, "LE.CondNet3.2", cd, policy=policy, act="lrelu", cin=nch, ch0=nch)
        c4 = conv_s2(p, "LE.CondNet4.2", cd, policy=policy, act="lrelu", cin=nch, ch0=2 * nch)
    else:
        c2 = conv_s2(p, "LE.CondNet2.0", c, policy=policy, act="lrelu")
        cond2 = mix_chain(c2, [("LE.CondNet2.2", "lrelu"), ("LE.CondNet2.4", None)])
        c3 = conv_s2(p, "LE.CondNet3.0", c, policy=policy, act="lrelu")
        c3 = conv_s2(p, "LE.CondNet3.2", c3, policy=policy, act="lrelu")
        c4 = conv_s2(p, "LE.CondNet4.0", c, policy=policy, act="lrelu")
        c4 = conv_s2(p, "LE.CondNet4.2", c4, policy=policy, act="lrelu")

    cond3 = mix_chain(c3, [("LE.CondNet3.4", None)])
    cond4 = conv_s2_nat(p, "LE.CondNet4.4", c4, policy=policy)  # natural /8
    return cond2, cond3, cond4


def _le_mid(p: Params, fea0, cond2, cond3, cond4, *, policy: Policy) -> torch.Tensor:
    """Down path + bottleneck + up path, fea0 (post HR_conv1) → trunk5 out at
    L1. On a sharded frame two merged halo stages take the place of four:
    down_conv1 + trunk1 (radius 6, cond2 at r/2) and up_conv2 + trunk5
    (radius ≥ 4, ``out`` at r/2 and its extended width kept a multiple of 8
    for up_conv2's own conv), as in the JAX package."""
    if _halo.active():
        fea1 = _halo.run_stage(
            lambda f, c: _resblock(p, "LE.recon_trunk1.0", conv_s2(p, "LE.down_conv1", f, policy=policy,
                                                                   relu_fused=True), c, policy=policy),
            [fea0, cond2], [2, 2], need=6, mod=16, out_axis=2, out_stride=2, coarse_idx=(1,),
        )
    else:
        fea1 = conv_s2(p, "LE.down_conv1", fea0, policy=policy, relu_fused=True)
        fea1 = _resblock(p, "LE.recon_trunk1.0", fea1, cond2, policy=policy)
    fea2 = conv_s2(p, "LE.down_conv2", fea1, policy=policy, relu_fused=True)
    fea2 = _resblock(p, "LE.recon_trunk2.0", fea2, cond3, policy=policy)
    fea3 = relu(conv_s2_nat(p, "LE.down_conv3", fea2, policy=policy))  # natural /8
    up = _trunk3_up_fused(p, fea3, cond4, policy=policy)
    out = _resblock(p, "LE.recon_trunk4.0", fea2, cond3, policy=policy, x_add=up)
    if _halo.active():
        return _halo.run_stage(
            lambda o, f1, c2: _resblock(p, "LE.recon_trunk5.0", f1, c2, policy=policy,
                                        up_coarse=conv_s1(p, "LE.up_conv2.0", o, policy=policy, relu_fused=True)),
            [out, fea1, cond2], [2, 2, 2], need=4, mod=8, out_axis=2, coarse_idx=(0,), coarse_conv=True,
        )
    upc = conv_s1(p, "LE.up_conv2.0", out, policy=policy, relu_fused=True)
    return _resblock(p, "LE.recon_trunk5.0", fea1, cond2, policy=policy, up_coarse=upc)


def le_s2d(p: Params, xs: torch.Tensor, conds: torch.Tensor, *, policy: Policy) -> torch.Tensor:
    """LE sft UNet in the block domain. ``xs``/``conds`` are s2d L0 tensors."""
    mask_out = xs  # weighting_network=False long skip

    # conv_first and cond_first.0 read the same tensor in the ensemble
    # (LE input = [agcm_out, agcm_out]); one consolidated conv when possible.
    fea0_pre = None
    if xs is conds and "LE.__in_fused.weight" in p:
        y = conv_s1(p, "LE.__in_fused", xs, policy=policy)
        n_first = p["LE.conv_first.bias"].shape[-1]
        fea0_pre = y[..., :n_first]
        c = leaky_relu(y[..., n_first:], 0.1)
    else:
        c = leaky_relu(conv_s1(p, "LE.cond_first.0", conds, policy=policy), 0.1)
    c = leaky_relu(conv_1x1(p, "LE.cond_first.2", c, policy=policy), 0.1)
    c = leaky_relu(conv_1x1(p, "LE.cond_first.4", c, policy=policy), 0.1)
    c1 = leaky_relu(conv_1x1(p, "LE.CondNet1.0", c, policy=policy), 0.1)
    c1 = leaky_relu(conv_1x1(p, "LE.CondNet1.2", c1, policy=policy), 0.1)
    cond1 = conv_1x1(p, "LE.CondNet1.4", c1, policy=policy)

    cond2, cond3, cond4 = _le_cond_downs(p, c, policy=policy)

    fea0 = relu(fea0_pre) if fea0_pre is not None else relu(conv_s1(p, "LE.conv_first", xs, policy=policy))
    fea0 = _sft_conv(p, "LE.SFT_layer1", "LE.HR_conv1", fea0, cond1, policy=policy, relu_fused=True)

    out = _le_mid(p, fea0, cond2, cond3, cond4, policy=policy)

    up = d2s_blocks(conv_s1(p, "LE.up_conv3.0", out, policy=policy, relu_fused=True))
    out = up + fea0
    out = _sft_conv(p, "LE.SFT_layer2", "LE.HR_conv2", out, cond1, policy=policy, relu_fused=True)
    return conv_s1(p, "LE.conv_last", out, policy=policy, skip=mask_out)


def _mega_ok(p: Params, xs_shape, policy: Policy) -> bool:
    """Whether a frame takes the megakernel program: the JAX predicate's
    rules (``HDRTV_MEGAKERNEL`` unset or on, bf16, batch 1, 12 s2d channels,
    its row and width rules, the three keys), so that both packages route a
    size the same way. Read at call time."""
    if not env_bool("HDRTV_MEGAKERNEL", True):
        return False
    if policy.compute_dtype != torch.bfloat16:
        return False
    if len(xs_shape) != 4 or xs_shape[0] != 1 or xs_shape[3] != 12:
        return False
    _, hb, wb, _ = xs_shape
    if wb % 8 != 0 or hb < 8 or pick_rows(hb) > 32 or not pick_rows_even(hb):
        return False
    return all(k in p for k in _MEGA_KEYS)


def _agcm_mods(p: Params, cond_nat: torch.Tensor, *, policy: Policy) -> torch.Tensor:
    """AGCM global modulation vectors, tiled for block-major s2d lanes:
    (6, 4·nf) fp32 rows = (scale, shift) × (first, HR, last), computed in the
    policy's type; the conv_last rows occupy the first 12 lanes."""
    fea = classifier_apply(p, "AGCM.classifier.", "color_condition", cond_nat, policy=policy)

    def lin(name):
        w = policy.cast(p[f"{name}.weight"])
        return (torch.matmul(policy.cast(fea), w) + policy.cast(p[f"{name}.bias"]))[0]

    rows = [lin(f"AGCM.cond_{kind}_{tag}").repeat(4).float()
            for tag in ("first", "HR", "last") for kind in ("scale", "shift")]
    width = max(v.shape[0] for v in rows)
    return torch.stack([torch.nn.functional.pad(v, (0, width - v.shape[0])) for v in rows])


def _ensemble_mega(
    p: Params, xs: torch.Tensor, cond_nat: torch.Tensor, *, policy: Policy, pack: bool,
    scale: float = 1.0, bgr: bool = False,
) -> torch.Tensor:
    """The megakernel frame program. ``xs``: the unbatched s2d L0 frame,
    (Hb, Wb, 12) float or u8, or (Hb, 2, Wb, 6) u8 row-pair planes (u8 with
    ``scale``) → (Hb, 2, Wb, 6) u16 (``pack``: a reshape of the RGB48 frame)
    or (Hb, Wb, 12) in the compute dtype. ``bgr`` reads the frame's bytes as
    BGR by permuting AGCM.conv_first's rows; the frame is never flipped.
    ``p`` comes from :func:`params_to_torch` with this policy."""
    def w11(name):
        return policy.cast(p[f"{name}.weight"][0, 0]), p[f"{name}.bias"]

    if xs.dtype != torch.uint8:
        xs = policy.cast(xs)
    mods = _agcm_mods(p, cond_nat, policy=policy)
    aw1 = p[_HEAD_AW1_BGR] if bgr else p["AGCM.conv_first.weight"][0, 0]
    # the packs params_to_torch built for the weights' element type (the other form's are None)
    aw1p, aw1p_bgr, aw3p, wcat = (p.get(k) for k in _HEAD_PACKED)
    w1, w1_bgr, *head_s2d = (p.get(k) for k in _HEAD_PACKED_S2D)
    # Every 1×1 weight here is a w_s2d_1x1 transform and every 3×3 one a
    # w_s2d_s1 one (s2d_transform_params; LE.__in_fused two of them side by
    # side): agcm_head, cond_chain, the tail, and sft_conv3 and resblock
    # (through _sft_conv and _resblock) skip their zeros.
    def head_sft(xs_in):
        """agcm_head → cond_chain → SFT_layer1 + HR_conv1 (unbatched)."""
        fea_pre, c0, agcm_i = fused_agcm_head(
            xs_in, mods, aw1, p["AGCM.conv_first.bias"], *w11("AGCM.HRconv"), *w11("AGCM.conv_last"),
            policy.cast(p["LE.__in_fused.weight"]), p["LE.__in_fused.bias"],
            n_first=p["LE.conv_first.bias"].shape[-1], scale=scale,
            packed=None if aw1p is None else (aw1p_bgr if bgr else aw1p, aw3p, wcat),
            packed_s2d=None if w1 is None else (w1_bgr if bgr else w1, *head_s2d), s2d=True,
        )
        c_feat_i, cond1_i = fused_cond_chain(c0, [
            w11("LE.cond_first.2"), w11("LE.cond_first.4"),
            w11("LE.CondNet1.0"), w11("LE.CondNet1.2"), w11("LE.CondNet1.4"),
        ], s2d=True)
        fea0_i = _sft_conv(p, "LE.SFT_layer1", "LE.HR_conv1", fea_pre[None], cond1_i[None],
                           policy=policy, relu_fused=True)
        return fea0_i[0], c_feat_i, cond1_i, agcm_i

    def up_tail(out_in, fea0_in, cond1_in, agcm_in):
        """up_conv3 and the tail (unbatched). up_conv3's output stays coarse
        where its shape allows: the tail un-folds the d2s and adds the fea0
        skip on read."""
        upc = conv_s1(p, "LE.up_conv3.0", out_in[None], policy=policy, relu_fused=True)
        hb0, wb0, c0f = fea0_in.shape
        if hb0 % 2 == 0 and wb0 % 2 == 0 and tuple(upc.shape[1:]) == (hb0 // 2, wb0 // 2, 4 * c0f):
            s, up_coarse = fea0_in, upc[0]
        else:
            s, up_coarse = (d2s_blocks(upc)[0] + fea0_in), None
        return fused_tail(
            s, cond1_in, agcm_in, _sft4_bd(p, "LE.SFT_layer2", policy),
            policy.cast(p["LE.HR_conv2.weight"]), p["LE.HR_conv2.bias"],
            policy.cast(p["LE.conv_last.weight"]), p["LE.conv_last.bias"],
            pack=pack, up_coarse=up_coarse, qargs_hr=_qargs_for(p, "LE.HR_conv2", s[None]), s2d=True,
        )

    if not _halo.active():
        fea0, c_feat, cond1, agcm = head_sft(xs)
        cond2, cond3, cond4 = _le_cond_downs(p, c_feat[None], policy=policy)
        out = _le_mid(p, fea0[None], cond2, cond3, cond4, policy=policy)
        return up_tail(out[0], fea0, cond1, agcm)
    # On a sharded frame two merged halo stages cover the L0 section, as in
    # the JAX package: the head through HR_conv1 (one 3×3, the cond chain
    # pointwise, one 3×3: radius 2; the frame's W axis is xs.ndim - 2), and
    # up_conv3 + the tail (radius ≥ 4, picked so that ``out``'s half-res
    # extended width stays a multiple of 8 for up_conv3's own conv; the tail
    # reads up_coarse no closer than one L2 column to the window's edge, so
    # up_conv3's contaminated edge column is never read).
    fea0, c_feat, cond1, agcm = _halo.run_stage(head_sft, [xs], [xs.ndim - 2], need=2, mod=8, out_axis=1)
    cond2, cond3, cond4 = _le_cond_downs(p, c_feat[None], policy=policy)
    out = _le_mid(p, fea0[None], cond2, cond3, cond4, policy=policy)
    return _halo.run_stage(
        up_tail, [out[0], fea0, cond1, agcm], [1, 1, 1, 1], need=4, mod=8, out_axis=2 if pack else 1,
        coarse_idx=(0,), coarse_conv=True,
    )


def ensemble_s2d(
    p: Params, img: torch.Tensor, cond: torch.Tensor, cfg: ModelConfig = ModelConfig(), *,
    policy: Policy = F32, mega: bool = True,
) -> torch.Tensor:
    """Full ensemble in s2d mode: natural NHWC in → natural NHWC out.
    ``img``: (N,H,W,3) [0,1] RGB (H,W even); ``cond``: natural ¼-res image.
    Takes the megakernel program where :func:`_mega_ok` holds, unless
    ``mega=False``; with ``cfg.use_hg`` and HG weights, the HG composite
    follows the base model."""
    xs = s2d(policy.cast(img))
    if mega and _mega_ok(p, xs.shape, policy):
        out = _ensemble_mega(p, xs[0], cond, policy=policy, pack=False)[None]
    else:
        agcm_out = agcm_s2d(p, xs, cond, policy=policy)
        out = le_s2d(p, agcm_out, agcm_out, policy=policy)
    if cfg.use_hg and _HG_KEY in p:
        out = hg_composite_s2d(p, out, cfg, policy=policy)
    return d2s(out)


def ensemble_s2d_rgb48(
    p: Params, frame_u8: torch.Tensor, cond: torch.Tensor, cfg: ModelConfig = ModelConfig(), *,
    policy: Policy = F32, mega: bool = True,
) -> torch.Tensor:
    """uint8 RGB frame (H,W,3) → uint16 RGB48 code values (H,W,3); ``cond``
    is the natural ¼-res condition image. On the megakernel program the pack
    happens inside the tail kernel."""
    h, w, _ = frame_u8.shape
    if mega and h % 2 == 0 and w % 2 == 0 and _mega_ok(p, (1, h // 2, w // 2, 12), policy):
        return ensemble_s2d_rgb48_flat(p, frame_u8.reshape(h, w * 3), cond, cfg, policy=policy).reshape(h, w, 3)
    x = frame_u8[None].float() * (1.0 / 255.0)
    return pack_rgb48(ensemble_s2d(p, x, cond, cfg, policy=policy, mega=mega)[0])


def _cond_quarter_flat(frame2d_u8: torch.Tensor, *, bgr: bool) -> torch.Tensor:
    """¼-res AA cond from flat byte rows (reshape form for widths not /4)."""
    h, w3 = frame2d_u8.shape
    w = w3 // 3
    if h % 4 == 0 and w % 4 == 0:
        return downsample_quarter_aa_flat(frame2d_u8, bgr=bgr)
    assert not _halo.active(), "a sharded frame needs /4-divisible shards"
    cframe = frame2d_u8.reshape(h, w, 3)
    if bgr:
        cframe = cframe.flip(-1)
    return downsample_quarter_aa(cframe[None].float() * (1.0 / 255.0))


def ensemble_s2d_rgb48_flat(
    p: Params,
    frame2d_u8: torch.Tensor,
    cond: torch.Tensor | None = None,
    cfg: ModelConfig = ModelConfig(),
    *,
    policy: Policy = F32,
    bgr: bool = False,
) -> torch.Tensor:
    """Flat byte-row contract: (H, 3W) uint8 rows in → (H, 3W) uint16 out.
    ``cond`` defaults to the ¼-res antialiased condition image of the same
    frame; ``bgr`` reads the bytes as BGR. The megakernel program reads the
    rows as (Hb, 2, Wb, 6) pair planes, a reshape. With HG, the megakernel
    program hands its unpacked s2d output to the HG composite, which packs
    (``HDRTV_HG_TAIL=1`` selects the hg_tail kernel there; the two-stage
    entry of the runtime, :func:`ensemble_s2d_base_flat` then
    ``hg_composite_s2d(..., tail_on=True)``, selects it by default)."""
    h, w3 = frame2d_u8.shape
    w = w3 // 3
    if cond is None:
        cond = _cond_quarter_flat(frame2d_u8, bgr=bgr)
    if h % 2 == 0 and w % 2 == 0 and _mega_ok(p, (1, h // 2, w // 2, 12), policy):
        xr = frame2d_u8.reshape(h // 2, 2, w // 2, 6)
        if cfg.use_hg and _HG_KEY in p:
            base = _ensemble_mega(p, xr, cond, policy=policy, pack=False, scale=1.0 / 255.0, bgr=bgr)
            return hg_composite_s2d(p, base[None], cfg, policy=policy, pack=True)
        packed = _ensemble_mega(p, xr, cond, policy=policy, pack=True, scale=1.0 / 255.0, bgr=bgr)
        return packed.reshape(h, w3)
    frame = frame2d_u8.reshape(h, w, 3)
    if bgr:
        frame = frame.flip(-1)
    x = frame[None].float() * (1.0 / 255.0)
    out = ensemble_s2d(p, x, cond, cfg, policy=policy)
    return pack_rgb48(out[0]).reshape(h, w3)


def ensemble_s2d_rgb48_pairs(
    p: Params,
    xr_u8: torch.Tensor,
    cond: torch.Tensor | None = None,
    cfg: ModelConfig = ModelConfig(),
    *,
    policy: Policy = F32,
    bgr: bool = False,
) -> torch.Tensor:
    """Row-pair-plane contract: (Hb, 2, Wb, 6) u8 in → (Hb, 2, Wb, 6) u16 out,
    the same bytes as the (H, 3W) flat contract. The megakernel program
    consumes and produces pair planes directly, the condition image included
    (``downsample_quarter_aa_pairs``); anything it does not take (HG among
    it) runs the flat program on the reshape."""
    hb, _, wb, _ = xr_u8.shape
    use_hg = cfg.use_hg and _HG_KEY in p
    if (not use_hg and not _halo.active() and hb % 2 == 0 and wb % 2 == 0
            and _mega_ok(p, (1, hb, wb, 12), policy)):
        if cond is None:
            cond = downsample_quarter_aa_pairs(xr_u8, bgr=bgr)
        return _ensemble_mega(p, xr_u8, cond, policy=policy, pack=True, scale=1.0 / 255.0, bgr=bgr)
    flat = ensemble_s2d_rgb48_flat(p, xr_u8.reshape(2 * hb, 6 * wb), cond, cfg, policy=policy, bgr=bgr)
    return flat.reshape(hb, 2, wb, 6)


def ensemble_s2d_base_flat(
    p: Params,
    frame2d_u8: torch.Tensor,
    cond: torch.Tensor | None = None,
    *,
    policy: Policy = F32,
    bgr: bool = False,
) -> torch.Tensor:
    """Stage 1 of the two-stage HG program: (H, 3W) uint8 rows → the base
    model's s2d output (1, Hb, Wb, 12) in the compute dtype, the same
    computation as the base part of :func:`ensemble_s2d_rgb48_flat` (the
    megakernel program where eligible, ``agcm_s2d`` + ``le_s2d`` otherwise).
    ``models/hg_s2d.py hg_composite_s2d`` is stage 2."""
    h, w3 = frame2d_u8.shape
    w = w3 // 3
    if cond is None:
        cond = _cond_quarter_flat(frame2d_u8, bgr=bgr)
    if h % 2 == 0 and w % 2 == 0 and _mega_ok(p, (1, h // 2, w // 2, 12), policy):
        xr = frame2d_u8.reshape(h // 2, 2, w // 2, 6)
        return _ensemble_mega(p, xr, cond, policy=policy, pack=False, scale=1.0 / 255.0, bgr=bgr)[None]
    frame = frame2d_u8.reshape(h, w, 3)
    if bgr:
        frame = frame.flip(-1)
    xs = s2d(policy.cast(frame[None].float() * (1.0 / 255.0)))
    agcm_out = agcm_s2d(p, xs, cond, policy=policy)
    return le_s2d(p, agcm_out, agcm_out, policy=policy)


def _pack_rgb48_s2d_flat(out: torch.Tensor) -> torch.Tensor:
    """s2d model output (Hb,Wb,12) in [0,1] → flat RGB48 byte rows (2Hb, 6Wb)
    u16, in torch ops: the pack of the HG composite's torch-op tail. The s2d
    channels of a block are its two row parities side by side, so the rows
    are the (Hb, 2, Wb, 6) stack of the two halves."""
    hb, wb, _ = out.shape
    v = out.float().clamp(0.0, 1.0) * 65535.0 + 0.5
    u = v.to(torch.int32).to(torch.uint16)
    return torch.stack([u[..., :6], u[..., 6:]], dim=1).reshape(2 * hb, 6 * wb)
