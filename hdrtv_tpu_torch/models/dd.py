"""Double space-to-depth (dd) execution mode (port of
``hdrtv_tpu/models/dd.py``): the L1 stage one s2d level further down.

The L1 stage (the full-resolution layers of the LE UNet and the AGCM) runs
at H/4 × W/4 with 16× the channels; the weights are rewritten once at load
so that every layer computes exactly the reference layer:

- ``w_dd_s1`` / ``w_dd_1x1``: the s2d stride-1 and 1×1 transforms compose;
  applied to the already transformed weights they give the dd weights, in
  the channel order of ``s2d(s2d(x))``;
- ``w_dd_s2``: a natural stride-2 3×3 'same' conv (down_conv1, the CondNet
  down heads) as a 2×2 stride-1 (1,0)-padded conv over the dd tensor, whose
  output lands in the next level's single-s2d layout: the dd grid is the
  L2-s2d grid, so the transition moves no data;
- up_conv3's PS-folded s2d weight needs nothing more: its output is the dd
  tensor, and the d2s after it vanishes.

Routing, as the JAX module's reaches the Pallas kernels on a TPU: the L2 and
deeper stages call ``models/s2d.py``'s ``conv_s2``, ``_resblock`` and
``conv_s1``, so down_conv2, CondNet3.2 and CondNet4.2 take the down2 kernel
(the two CondNet convs on their own inputs at ``a_sub = 1``: the dd tree has
no consolidated CondNet down conv), the resblocks of trunks 1, 2, 4 and 5
the resblock kernel in bf16 (or two sft_conv3 calls where its even-row rule
says so) and the block_conv3 kernel for each conv in fp32, and up_conv2 and
up_conv3 block_conv3. Everything the JAX module leaves to XLA is torch ops:
the L1 3×3 convs (the 48-channel input conv, HR_conv1, HR_conv2, conv_last),
the four 2×2 transitions, every 1×1 (the AGCM, the cond chain, the SFT
layers), down_conv3 and CondNet4.4, and trunk3 as four natural-domain
resblocks and up_conv1 (not the trunk3 kernel). The mode has no runtime
option or CLI flag in either package: :func:`ensemble_dd` is its entry.
Composite (HG) trees, a sharded frame and sides that are not multiples of 4
are refused.
"""

from __future__ import annotations

import numpy as np
import torch

from hdrtv_tpu_torch.models.agcm import classifier_apply
from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig
from hdrtv_tpu_torch.models.layers import F32, Params, Policy, leaky_relu, relu
from hdrtv_tpu_torch.models.le_unet import resblock_sft
from hdrtv_tpu_torch.models.s2d import (
    _blk,
    _conv,
    _resblock,
    _sft,
    b_s2d,
    cast_params,
    conv_1x1,
    conv_s1,
    conv_s2,
    conv_s2_nat,
    d2s,
    s2d,
    s2d_transform_params,
    w_s2d_1x1,
    w_s2d_s1,
)
from hdrtv_tpu_torch.parallel import halo as _halo
from hdrtv_tpu_torch.utils.device import compute_device

# ---------------------------------------------------------------------------
# Data movement
# ---------------------------------------------------------------------------


def s2d2(x: torch.Tensor) -> torch.Tensor:
    """(N,H,W,C) → (N,H/4,W/4,16C); ch = (a2·2+b2)·4C + (a1·2+b1)·C + c."""
    return s2d(s2d(x))


def d2s2(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`s2d2`."""
    return d2s(d2s(x))


def _tile16(v: torch.Tensor) -> torch.Tensor:
    """(N,C) modulation vector → (N,1,1,16C) for dd block-major tensors."""
    n, c = v.shape
    return v.repeat(1, 16).reshape(n, 1, 1, 16 * c)


def dd_quads_view(frame2d_u8: np.ndarray) -> np.ndarray:
    """(H, 3W) byte rows → (H/4, 4, W/4, 12) quad-row planes, a free view (a
    reshape) of a decoded frame buffer. Plane t = 2a2+a1 holds row
    sub-position (a2, a1); byte 3·(2b2+b1)+c holds column sub-position
    (b2, b1) channel c."""
    h, w3 = frame2d_u8.shape
    return frame2d_u8.reshape(h // 4, 4, w3 // 12, 12)


# dd channel k = (a2·2+b2)·12 + (a1·2+b1)·3 + c ← quad-plane flat index
# t·12 + u·3 + c with t = 2a2+a1, u = 2b2+b1.
_QUAD_PERM = np.empty(48, np.int64)
for _a2 in range(2):
    for _a1 in range(2):
        for _b2 in range(2):
            for _b1 in range(2):
                for _c in range(3):
                    _QUAD_PERM[(_a2 * 2 + _b2) * 12 + (_a1 * 2 + _b1) * 3 + _c] = (
                        (2 * _a2 + _a1) * 12 + (2 * _b2 + _b1) * 3 + _c
                    )
del _a2, _a1, _b2, _b1, _c


def dd_from_quads(xq: torch.Tensor) -> torch.Tensor:
    """(Hd, 4, Wd, 12) quad-row planes → (1, Hd, Wd, 48) dd tensor. The
    transpose and the lane permutation ``_QUAD_PERM`` are one axis
    permutation: (Hd, a2, a1, Wd, b2, b1, c) → (Hd, Wd, a2, b2, a1, b1, c),
    which takes any element type."""
    hd, _, wd, _ = xq.shape
    v = xq.reshape(hd, 2, 2, wd, 2, 2, 3).permute(0, 3, 1, 4, 2, 5, 6)
    return v.reshape(1, hd, wd, 48)


def quads_from_dd(x: torch.Tensor) -> torch.Tensor:
    """(1, Hd, Wd, 48) dd tensor → (Hd, 4, Wd, 12) quad-row planes, the
    inverse of :func:`dd_from_quads`; on u16 output it is the flat (H, 3W)
    RGB48 byte-row contract (a free view)."""
    _, hd, wd, _ = x.shape
    v = x[0].reshape(hd, wd, 2, 2, 2, 2, 3).permute(0, 2, 4, 1, 3, 5, 6)
    return v.reshape(hd, 4, wd, 12)


# ---------------------------------------------------------------------------
# Weight transforms (host numpy, applied once at load)
# ---------------------------------------------------------------------------


def w_dd_s1(w: np.ndarray) -> np.ndarray:
    """(3,3,Ci,Co) stride-1 'same' → (3,3,16Ci,16Co) 'same' over dd: the s2d
    stride-1 transform applied twice (its first application is an exact
    'same' 3×3 over the s2d grid, which the second transforms again)."""
    return w_s2d_s1(w_s2d_s1(w))


def w_dd_1x1(w: np.ndarray) -> np.ndarray:
    """(1,1,Ci,Co) → (1,1,16Ci,16Co) block-diagonal (composition)."""
    return w_s2d_1x1(w_s2d_1x1(w))


def b_dd(b: np.ndarray) -> np.ndarray:
    """Bias tiled over the 16 dd sub-positions."""
    return np.tile(b, 16)


def w_dd_s2(w: np.ndarray) -> np.ndarray:
    """(3,3,Ci,Co) natural stride-2 'same' → (2,2,16Ci,4Co) stride-1 with
    (1,0) pad over the dd tensor; output in the next level's single-s2d
    layout. Output L2-s2d sub-position (ao,bo) at dd-grid row B' reads
    natural rows n = 4B' + 2·ao + di, di ∈ {−1,0,1}; n = 4(B'+Δ)+s gives
    Δ ∈ {−1,0} (a 2-tap kernel) and dd row sub-position s = 2a2+a1, whose
    channel block is (a2·2+b2)·4Ci + (a1·2+b1)·Ci."""
    kh, kw, ci, co = w.shape
    assert (kh, kw) == (3, 3)
    out = np.zeros((2, 2, 16 * ci, 4 * co), w.dtype)
    for dI in (-1, 0, 1):
        for dJ in (-1, 0, 1):
            for ao in range(2):
                for bo in range(2):
                    dlt_i, s_i = divmod(2 * ao + dI, 4)
                    dlt_j, s_j = divmod(2 * bo + dJ, 4)
                    a2, a1 = divmod(s_i, 2)
                    b2, b1 = divmod(s_j, 2)
                    cin = (a2 * 2 + b2) * 4 * ci + (a1 * 2 + b1) * ci
                    out[dlt_i + 1, dlt_j + 1, cin : cin + ci, _blk(co, ao * 2 + bo)] = w[dI + 1, dJ + 1]
    return out


# L1-stage layers by dd role; everything else keeps its single-s2d form.
_DD_S1 = ("LE.conv_first", "LE.cond_first.0", "LE.HR_conv1", "LE.HR_conv2", "LE.conv_last")
_DD_11 = (
    "LE.cond_first.2", "LE.cond_first.4",
    "LE.CondNet1.0", "LE.CondNet1.2", "LE.CondNet1.4",
    "AGCM.conv_first", "AGCM.HRconv", "AGCM.conv_last",
) + tuple(
    f"LE.{sft}.{cv}"
    for sft in ("SFT_layer1", "SFT_layer2")
    for cv in ("SFT_scale_conv0", "SFT_scale_conv1", "SFT_shift_conv0", "SFT_shift_conv1")
)
_DD_S2 = ("LE.down_conv1", "LE.CondNet2.0", "LE.CondNet3.0", "LE.CondNet4.0")


def _refuse_composite(params) -> None:
    if any(k.startswith(("base.", "hg.")) for k in params):
        raise ValueError("dd mode takes no composite (HG) tree: the parameters hold base.* or hg.* keys")


def dd_transform_params(params: dict, cfg: ModelConfig | None = None) -> dict:
    """The dd parameter tree from an original (natural) checkpoint: the s2d
    tree (L2 and deeper keep that form), with the L1-stage layers one more
    s2d level down. up_conv3's PS-folded weight passes through. The single-s2d
    consolidated CondNet down conv does not apply in dd (the three branch
    heads are 2×2 dd convs) and is dropped, so that nothing fuses stale
    single-s2d weights with dd inputs."""
    _refuse_composite(params)
    sp = s2d_transform_params(params, cfg)
    out = dict(sp)
    for layer in _DD_S1:
        wk, bk = f"{layer}.weight", f"{layer}.bias"
        if wk in sp:
            out[wk] = w_s2d_s1(sp[wk])  # composition: the second s2d level
            if bk in sp:
                out[bk] = b_s2d(sp[bk])
    for layer in _DD_11:
        wk, bk = f"{layer}.weight", f"{layer}.bias"
        if wk in sp:
            out[wk] = w_s2d_1x1(sp[wk])
            if bk in sp:
                out[bk] = b_s2d(sp[bk])
    for layer in _DD_S2:
        wk, bk = f"{layer}.weight", f"{layer}.bias"
        if wk in params:  # built from the natural weight (stride semantics)
            out[wk] = w_dd_s2(np.asarray(params[wk], np.float32))
            if bk in params:
                out[bk] = b_s2d(np.asarray(params[bk], np.float32))
    # dd-domain input fusion (conv_first ∥ cond_first.0 share the LE input)
    out["LE.__in_fused.weight"] = np.concatenate(
        (out["LE.conv_first.weight"], out["LE.cond_first.0.weight"]), axis=-1
    )
    out["LE.__in_fused.bias"] = np.concatenate((out["LE.conv_first.bias"], out["LE.cond_first.0.bias"]))
    out.pop("LE.__cond_down.weight", None)
    out.pop("LE.__cond_down.bias", None)
    return out


def dd_params_to_torch(params_np: dict, device=None, policy: Policy = F32) -> Params:
    """Carry a :func:`dd_transform_params` tree to ``device`` (by default
    the card: ``utils/device.py compute_device``), cast as ``models/s2d.py
    cast_params`` casts: the biases a kernel reads stay fp32, and every
    other bias the fp32 rule keeps (the L1 3×3s now fit its 128-multiple
    rule: HR_conv1 is 512 × 512) is rounded by ``policy.cast`` where a torch
    op uses it, where JAX's ``policy.cast`` rounds it. It builds no kernel
    pack: the dd tree has the keys of the trunk3 and agcm_head packs with
    other shapes (``AGCM.conv_first`` (1,1,48,1024), ``LE.__in_fused``
    (3,3,48,1536)), and the dd program runs neither kernel."""
    _refuse_composite(params_np)
    return cast_params(params_np, compute_device(device), policy)


# ---------------------------------------------------------------------------
# Forward (release arch, no HG)
# ---------------------------------------------------------------------------


def _refuse_sharded() -> None:
    if _halo.active():
        raise ValueError("dd mode runs on one device: a sharded frame (parallel/halo.py) is active")


def _conv_dd_s2(p: Params, name: str, x: torch.Tensor, *, policy: Policy) -> torch.Tensor:
    """The 2×2 stride-1 (1,0)-padded dd→L2-s2d transition conv."""
    return _conv(p, name, x, padding=((1, 0), (1, 0)), policy=policy)


def agcm_dd(p: Params, xdd: torch.Tensor, cond_nat: torch.Tensor, *, policy: Policy) -> torch.Tensor:
    """AGCM (dynamic color_condition) on a dd frame; the classifier runs on
    the natural ¼-res condition image."""
    fea = classifier_apply(p, "AGCM.classifier.", "color_condition", cond_nat, policy=policy)

    def lin(name):
        w = policy.cast(p[f"{name}.weight"])
        return torch.matmul(policy.cast(fea), w) + policy.cast(p[f"{name}.bias"])

    def mod(out, scale, shift):
        return out * _tile16(scale) + _tile16(shift) + out

    out = conv_1x1(p, "AGCM.conv_first", xdd, policy=policy)
    out = relu(mod(out, lin("AGCM.cond_scale_first"), lin("AGCM.cond_shift_first")))
    out = conv_1x1(p, "AGCM.HRconv", out, policy=policy)
    out = relu(mod(out, lin("AGCM.cond_scale_HR"), lin("AGCM.cond_shift_HR")))
    out = conv_1x1(p, "AGCM.conv_last", out, policy=policy)
    return mod(out, lin("AGCM.cond_scale_last"), lin("AGCM.cond_shift_last"))


def le_dd(p: Params, xs: torch.Tensor, conds: torch.Tensor, *, policy: Policy) -> torch.Tensor:
    """The LE sft UNet with its L1 stage in the dd domain: L1 tensors are
    (H/4, W/4, 16C) and every L1↔L2 transition is a conv that moves no data;
    L2 and deeper run the single-s2d forms of ``models/s2d.py``."""
    _refuse_sharded()
    mask_out = xs  # weighting_network=False long skip

    if xs is conds and "LE.__in_fused.weight" in p:
        y = conv_s1(p, "LE.__in_fused", xs, policy=policy)
        n_first = p["LE.conv_first.bias"].shape[-1]
        fea0_pre = y[..., :n_first]
        c = leaky_relu(y[..., n_first:], 0.1)
    else:
        fea0_pre = _conv(p, "LE.conv_first", xs, padding=1, policy=policy)
        c = leaky_relu(_conv(p, "LE.cond_first.0", conds, padding=1, policy=policy), 0.1)
    c = leaky_relu(conv_1x1(p, "LE.cond_first.2", c, policy=policy), 0.1)
    c = leaky_relu(conv_1x1(p, "LE.cond_first.4", c, policy=policy), 0.1)
    c1 = leaky_relu(conv_1x1(p, "LE.CondNet1.0", c, policy=policy), 0.1)
    c1 = leaky_relu(conv_1x1(p, "LE.CondNet1.2", c1, policy=policy), 0.1)
    cond1 = conv_1x1(p, "LE.CondNet1.4", c1, policy=policy)

    # cond downs: one 2×2 dd conv per branch lands each on its L2-s2d grid;
    # the tails are the single-s2d layers (CondNet2's 1×1s as torch ops, as
    # the JAX module runs them: not the mix_chain kernel).
    c2 = leaky_relu(_conv_dd_s2(p, "LE.CondNet2.0", c, policy=policy), 0.1)
    c2 = leaky_relu(conv_1x1(p, "LE.CondNet2.2", c2, policy=policy), 0.1)
    cond2 = conv_1x1(p, "LE.CondNet2.4", c2, policy=policy)
    c3 = leaky_relu(_conv_dd_s2(p, "LE.CondNet3.0", c, policy=policy), 0.1)
    c3 = conv_s2(p, "LE.CondNet3.2", c3, policy=policy, act="lrelu")
    cond3 = conv_1x1(p, "LE.CondNet3.4", c3, policy=policy)
    c4 = leaky_relu(_conv_dd_s2(p, "LE.CondNet4.0", c, policy=policy), 0.1)
    c4 = conv_s2(p, "LE.CondNet4.2", c4, policy=policy, act="lrelu")
    cond4 = conv_s2_nat(p, "LE.CondNet4.4", c4, policy=policy)  # natural /8

    fea0 = relu(fea0_pre)
    fea0 = _sft(p, "LE.SFT_layer1", fea0, cond1, policy=policy)
    fea0 = relu(_conv(p, "LE.HR_conv1", fea0, padding=1, policy=policy))

    # ---- mid (the s2d program's _le_mid from fea1; L2+ domains identical) ----
    fea1 = relu(_conv_dd_s2(p, "LE.down_conv1", fea0, policy=policy))
    fea1 = _resblock(p, "LE.recon_trunk1.0", fea1, cond2, policy=policy)
    fea2 = conv_s2(p, "LE.down_conv2", fea1, policy=policy, relu_fused=True)
    fea2 = _resblock(p, "LE.recon_trunk2.0", fea2, cond3, policy=policy)
    fea3 = relu(conv_s2_nat(p, "LE.down_conv3", fea2, policy=policy))  # natural /8
    # trunk3 as the JAX module runs it: four natural resblocks (its _resblock
    # with natural 3×3 and 1×1 convs: SFT, conv, ReLU, SFT, conv, + fea) and up_conv1
    out = fea3
    for i in range(4):
        out = resblock_sft(p, f"LE.recon_trunk3.{i}", out, cond4, policy=policy)
    out = out + fea3
    up = relu(_conv(p, "LE.up_conv1.0", out, padding=1, policy=policy))
    out = _resblock(p, "LE.recon_trunk4.0", fea2, cond3, policy=policy, x_add=up)
    upc = conv_s1(p, "LE.up_conv2.0", out, policy=policy, relu_fused=True)
    out = _resblock(p, "LE.recon_trunk5.0", fea1, cond2, policy=policy, up_coarse=upc)

    # ---- up to L1: the PS-folded conv's output is the dd tensor ----
    up_dd = conv_s1(p, "LE.up_conv3.0", out, policy=policy, relu_fused=True)
    out = up_dd + fea0
    out = _sft(p, "LE.SFT_layer2", out, cond1, policy=policy)
    out = relu(_conv(p, "LE.HR_conv2", out, padding=1, policy=policy))
    return _conv(p, "LE.conv_last", out, padding=1, policy=policy) + mask_out


def ensemble_dd(
    p: Params, img: torch.Tensor, cond: torch.Tensor, cfg: ModelConfig = ModelConfig(), *,
    policy: Policy = F32,
) -> torch.Tensor:
    """Full ensemble in dd mode: natural NHWC in → natural NHWC out, in the
    compute dtype. ``img``: (N,H,W,3) [0,1] RGB with H and W multiples of 4;
    ``cond``: the natural ¼-res condition image; ``p`` from
    :func:`dd_params_to_torch`."""
    if cfg.use_hg:
        raise ValueError("dd mode runs no HG composite: cfg.use_hg is set")
    _refuse_composite(p)
    _refuse_sharded()
    h, w = img.shape[1], img.shape[2]
    if h % 4 or w % 4:
        raise ValueError(f"dd mode needs the frame's sides to be multiples of 4, got {h} x {w}")
    xdd = s2d2(policy.cast(img))
    agcm_out = agcm_dd(p, xdd, cond, policy=policy)
    out = le_dd(p, agcm_out, agcm_out, policy=policy)
    return d2s2(out)
