"""HG composite in the s2d (space-to-depth) execution domain (port of
``hdrtv_tpu/models/hg_s2d.py``).

The level-1 stages of the highlight generator run in the block domain of the
base model's s2d output, so nothing leaves the s2d layout at full resolution:

- highlight mask: a max over each sub-position's RGB triplet;
- /32 reflect pad: a gather of grid rows and columns (even sizes keep row
  parity under reflection);
- ``conv1``: ``w_s2d_s1``-transformed (12 → 4·nf), BatchNorm folded;
- ``maxpool1``: the 2×2 natural max is a max over the 4 sub-position groups;
- encoder levels 2–6 and the decoder through ``conv9``: natural tensors at
  grid resolution and below, plain torch convolutions (the JAX package leaves
  them to XLA too);
- ``Up_conv5``: PixelShuffle folded into the conv's output permutation, so
  its output is the full-resolution s2d tensor;
- ``conv10`` / ``conv_last``: 1×1s as block-diagonal s2d mixes with the
  concat row order rewired at transform time;
- composite ``mask·out + img`` and the RGB48 pack: the ``hg_tail`` kernel
  (``ops/megakernel.py fused_hg_tail``) where eligible, torch ops otherwise.

The JAX module's ``_stage`` wrappers (halo exchange under manual sharding)
are the identity on one device and are left out.
"""

from __future__ import annotations

import numpy as np
import torch

from hdrtv_tpu_torch.models.hdrtvnet import mask_of_max
from hdrtv_tpu_torch.models.hg import _conv_block, _up_block
from hdrtv_tpu_torch.models.layers import F32, Params, Policy, conv2d, max_pool2, pixel_shuffle, relu
from hdrtv_tpu_torch.ops.megakernel import fused_hg_tail
from hdrtv_tpu_torch.utils.env import env_bool

_BN_BLOCKS = (
    "hg.conv1", "hg.conv2", "hg.conv3_1", "hg.conv3_2", "hg.conv4_1",
    "hg.conv4_2", "hg.conv5_1", "hg.conv5_2", "hg.conv_code1", "hg.conv_code2",
)


def _permute_cat_rows(w_t: np.ndarray, parts: tuple[int, ...]) -> np.ndarray:
    """Reorder a ``w_s2d_1x1`` row axis from natural block-major
    (sub-position major over the concatenated natural channels) to the layout
    of concatenated s2d tensors (piece-major, then sub-position)."""
    total = sum(parts)
    perm = []
    for pi, cn in enumerate(parts):
        off = sum(parts[:pi])
        for s in range(4):
            perm.extend(s * total + off + c for c in range(cn))
    return w_t[:, :, np.asarray(perm), :]


def hg_s2d_transform(params: dict) -> dict:
    """Transform the ``hg.*`` weights for s2d execution (fp32 numpy); pass the
    rest through. BatchNorm is folded into the ten encoder convs (exact in
    eval mode); ``conv1``, ``Up_conv5``, ``conv10`` and ``conv_last`` get the
    s2d rewrites; deeper levels keep natural weights."""
    from hdrtv_tpu_torch.models.s2d import b_s2d, w_ps_permute, w_s2d_1x1, w_s2d_s1

    out: dict[str, np.ndarray] = {}
    handled: set[str] = set()

    def take(k):
        handled.add(k)
        return np.asarray(params[k], np.float32)

    def fold_bn(layer: str) -> tuple[np.ndarray, np.ndarray]:
        w, b = take(f"{layer}.0.weight"), take(f"{layer}.0.bias")
        if f"{layer}.1.running_mean" in params:
            mean = take(f"{layer}.1.running_mean")
            var = take(f"{layer}.1.running_var")
            gamma = take(f"{layer}.1.weight")
            beta = take(f"{layer}.1.bias")
            scale = gamma / np.sqrt(var + 1e-5)
            w = w * scale[None, None, None, :]
            b = b * scale + (beta - mean * scale)
        return w, b

    if "hg.conv1.0.weight" in params:
        for blk in _BN_BLOCKS:
            if f"{blk}.0.weight" not in params:
                continue
            w, b = fold_bn(blk)
            if blk == "hg.conv1":
                w, b = w_s2d_s1(w), b_s2d(b)
            out[f"{blk}.0.weight"] = w
            out[f"{blk}.0.bias"] = b
    if "hg.Up_conv5.0.weight" in params:
        out["hg.Up_conv5.0.weight"] = w_ps_permute(take("hg.Up_conv5.0.weight"))
        b = take("hg.Up_conv5.0.bias")
        out["hg.Up_conv5.0.bias"] = w_ps_permute(b.reshape(1, 1, 1, -1))[0, 0, 0]
    if "hg.conv10.weight" in params:
        w = take("hg.conv10.weight")  # (1,1,2·cn,3): concat(up5, c1)
        cn = w.shape[2] // 2
        out["hg.conv10.weight"] = _permute_cat_rows(w_s2d_1x1(w), (cn, cn))
        out["hg.conv10.bias"] = b_s2d(take("hg.conv10.bias"))
    if "hg.conv_last.weight" in params:
        w = take("hg.conv_last.weight")  # (1,1,6,3): concat(u, img)
        out["hg.conv_last.weight"] = _permute_cat_rows(w_s2d_1x1(w), (3, 3))
        out["hg.conv_last.bias"] = b_s2d(take("hg.conv_last.bias"))
    for k, v in params.items():
        if k not in handled:
            out[k] = np.asarray(v)
    return out


def subpos_max(x: torch.Tensor) -> torch.Tensor:
    """2×2 natural max pool of an s2d tensor = max over the 4 sub-position
    channel groups: (N,Hb,Wb,4C) → natural (N,Hb,Wb,C)."""
    n, h, w, c4 = x.shape
    return x.reshape(n, h, w, 4, c4 // 4).amax(dim=3)


def mask_s2d(base_s2d: torch.Tensor, r: float = 0.75, thresh: float = 0.1) -> torch.Tensor:
    """``make_mask`` on the s2d base output: (N,Hb,Wb,12) → (N,Hb,Wb,4), one
    mask lane per sub-position."""
    n, h, w, _ = base_s2d.shape
    return mask_of_max(base_s2d.reshape(n, h, w, 4, 3).amax(dim=-1), r, thresh)


def pad_reflect_s2d(x: torch.Tensor, pgh: int, pgw: int) -> torch.Tensor:
    """Bottom/right reflect pad by ``pgh``/``pgw`` *grid* rows/cols of an s2d
    tensor, equal to s2d(pad_reflect(d2s(x), 2·pgh, 2·pgw)): natural padded
    row 2(Hb+j)+a mirrors 2(Hb−1−j) for a=0 and 2(Hb−2−j)+1 for a=1, so each
    sub-position of a padded grid row is a reversed grid-row slice."""
    if pgh == 0 and pgw == 0:
        return x
    n, hb, wb, c4 = x.shape
    if pgh > hb - 1 or pgw > wb - 1:
        raise ValueError(
            f"frame too small for HG /32 reflect padding: s2d grid {hb}x{wb} "
            f"cannot reflect-pad by ({pgh},{pgw}) grid rows/cols"
        )
    cn = c4 // 4
    xa = x.reshape(n, hb, wb, 2, 2, cn)
    if pgh:
        a0 = xa[:, hb - pgh : hb].flip(1)[:, :, :, 0:1]
        a1 = xa[:, hb - 1 - pgh : hb - 1].flip(1)[:, :, :, 1:2]
        xa = torch.cat([xa, torch.cat([a0, a1], dim=3)], dim=1)
    if pgw:
        b0 = xa[:, :, wb - pgw : wb].flip(2)[:, :, :, :, 0:1]
        b1 = xa[:, :, wb - 1 - pgw : wb - 1].flip(2)[:, :, :, :, 1:2]
        xa = torch.cat([xa, torch.cat([b0, b1], dim=4)], dim=2)
    return xa.reshape(n, hb + pgh, wb + pgw, c4)


def _conv3_fused(p: Params, name: str, x: torch.Tensor, *, relu_after: bool, policy: Policy,
                 pool_out: bool = False) -> torch.Tensor:
    """3×3 natural conv block; BatchNorm is folded at transform time, so conv
    + ReLU is the whole block. ``pool_out`` applies the following 2×2 max
    pool. A plain torch convolution, as the JAX function is a plain lax one."""
    y = conv2d(p, name, x, padding=1, policy=policy)
    if relu_after:
        y = relu(y)
    return max_pool2(y) if pool_out else y


def _conv_block_f(p: Params, name: str, x: torch.Tensor, *, policy: Policy,
                  pool_out: bool = False) -> torch.Tensor:
    if f"{name}.1.running_mean" in p:  # un-folded checkpoint: BatchNorm between
        y = _conv_block(p, name, x, policy=policy)
        return max_pool2(y) if pool_out else y
    return _conv3_fused(p, f"{name}.0", x, relu_after=True, policy=policy, pool_out=pool_out)


def _up_block_f(p: Params, name: str, x: torch.Tensor, *, policy: Policy) -> torch.Tensor:
    if f"{name}.1.weight" in p:  # the resize-conv layout → the natural helper
        return _up_block(p, name, x, policy=policy)
    # ReLU commutes with PixelShuffle (elementwise against a permutation).
    return pixel_shuffle(_conv3_fused(p, f"{name}.0", x, relu_after=True, policy=policy), 2)


def hg_s2d_apply(
    p: Params, img_s2d: torch.Tensor, mask4: torch.Tensor, *, policy: Policy = F32,
    pack: bool = False, tail_on: bool | None = None,
) -> torch.Tensor:
    """Hallucination_Generator.forward over s2d level-1 tensors.

    ``img_s2d``: (N,Hbp,Wbp,12), the /16-grid-padded s2d base output;
    ``mask4``: (N,Hbp,Wbp,4). Returns the composited s2d output (…,12), or
    with ``pack`` packed u16 (N,Hbp,2,Wbp,6) RGB48 rows: from the ``hg_tail``
    kernel when ``HDRTV_HG_TAIL`` (default: ``tail_on``) selects it and the
    batch is 1 with Wbp % 8 == 0, from torch ops otherwise. Choosing the
    kernel is final: on the card it launches or raises.
    """
    img_s2d = policy.cast(img_s2d)

    def blk(name, x, pool=False):
        return _conv_block_f(p, name, x, policy=policy, pool_out=pool)

    def up(name, x):
        return _up_block_f(p, name, x, policy=policy)

    # Level 1 in s2d: conv1 (12 → 4·nf, BatchNorm folded) + relu, then maxpool1
    # as the sub-position max; the rest natural at grid resolution and below.
    c1 = relu(conv2d(p, "hg.conv1.0", img_s2d, padding=1, policy=policy))
    c2 = blk("hg.conv2", subpos_max(c1))
    c3 = blk("hg.conv3_2", blk("hg.conv3_1", c2, pool=True))
    c4 = blk("hg.conv4_2", blk("hg.conv4_1", c3, pool=True))
    c5 = blk("hg.conv5_2", blk("hg.conv5_1", c4, pool=True))
    code = blk("hg.conv_code2", blk("hg.conv_code1", c5, pool=True))

    u = conv2d(p, "hg.conv6", torch.cat((up("hg.Up_conv1", code), c5), dim=-1), policy=policy)
    del code, c5
    u = conv2d(p, "hg.conv7", torch.cat((up("hg.Up_conv2", u), c4), dim=-1), policy=policy)
    del c4
    u = conv2d(p, "hg.conv8", torch.cat((up("hg.Up_conv3", u), c3), dim=-1), policy=policy)
    del c3
    u = conv2d(p, "hg.conv9", torch.cat((up("hg.Up_conv4", u), c2), dim=-1), policy=policy)
    del c2
    # Up_conv5 with the PixelShuffle fold: its output is the full-res s2d tensor.
    up5 = relu(conv2d(p, "hg.Up_conv5.0", u, padding=1, policy=policy))
    del u

    tail_ok = (
        pack
        and env_bool("HDRTV_HG_TAIL", bool(tail_on))
        and up5.shape[0] == 1
        and up5.shape[2] % 8 == 0
    )
    if tail_ok:
        return fused_hg_tail(
            up5[0], c1[0], img_s2d[0], policy.cast(mask4[0]),
            policy.cast(p["hg.conv10.weight"][0, 0]), p["hg.conv10.bias"].float(),
            policy.cast(p["hg.conv_last.weight"][0, 0]), p["hg.conv_last.bias"].float(),
        )[None]

    # 1×1 mixes over concats (weights concat-permuted at transform time).
    u10 = conv2d(p, "hg.conv10", torch.cat((up5, c1), dim=-1), policy=policy)
    del up5, c1
    out = conv2d(p, "hg.conv_last", torch.cat((u10, img_s2d), dim=-1), policy=policy)
    comp = mask4.repeat_interleave(3, dim=-1).to(out.dtype) * out + img_s2d
    if pack:
        from hdrtv_tpu_torch.models.s2d import _pack_rgb48_s2d_flat

        _, hb, wb, _ = comp.shape
        return _pack_rgb48_s2d_flat(comp[0]).reshape(hb, 2, wb, 6)[None]
    return comp


def hg_composite_s2d(
    p: Params, base_s2d: torch.Tensor, cfg, *, policy: Policy = F32, pack: bool = False,
    tail_on: bool | None = None,
) -> torch.Tensor:
    """Mask → /16-grid reflect pad → HG → crop, over the s2d base output
    (N,Hb,Wb,12). With ``pack`` the result is the flat u16 RGB48 byte rows
    (2Hb, 6Wb), the crop then being a slice of the packed row-pair planes."""
    n, hb, wb, _ = base_s2d.shape
    mask4 = mask_s2d(base_s2d, r=cfg.mask_r)
    pgh = (16 - hb % 16) % 16
    pgw = (16 - wb % 16) % 16
    base_pad = pad_reflect_s2d(base_s2d, pgh, pgw)
    mask_pad = pad_reflect_s2d(mask4, pgh, pgw)
    out = hg_s2d_apply(p, base_pad, mask_pad, policy=policy, pack=pack, tail_on=tail_on)
    if pack:
        packed = out[0]  # (Hbp, 2, Wbp, 6)
        if pgh or pgw:
            packed = packed[:hb, :, :wb, :]
        return packed.reshape(2 * hb, wb * 6)
    if pgh or pgw:
        out = out[:, :hb, :wb, :]
    return out
