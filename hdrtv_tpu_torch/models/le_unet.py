"""LE (Local Enhancement), the HDRUNet3T1 family, in the natural layout
(port of ``hdrtv_tpu/models/le_unet.py``).

The architecture parser (``LEArchSpec``, ``parse_le_arch``) is the JAX
package's, copied whole: it is pure Python and names every member of the
family. Every forward is ported: the release arch ``sft`` (the
SFT-conditioned three-level UNet), the UNet over other trunk specs (SFT,
plain and wide residual blocks, flat conv chains; the ``plainflat`` archs
without the condition branch, with or without linear skips), the plain
bottleneck (one low-resolution island in the down/up scaffold) and the
direct archs (one avg-pooled residual island returned by pixel shuffle, with
the condition image and a tanh gate in the ``cond`` and ``condgate`` forms),
each with ``act_type`` and ``weighting_network`` honoured. The s2d programs
run the release arch as ``models/s2d.py le_s2d`` and the megakernels.
"""

from __future__ import annotations

import dataclasses
import re

import torch

from hdrtv_tpu_torch.models.layers import (
    F32,
    Params,
    Policy,
    align_to,
    avg_pool,
    conv2d,
    leaky_relu,
    pixel_shuffle,
    relu,
    scalar_of,
)

_DEFAULT_TRUNK_DEPTHS = {"recon_trunk1": 1, "recon_trunk2": 1, "recon_trunk3": 4, "recon_trunk4": 1, "recon_trunk5": 1}


@dataclasses.dataclass(frozen=True)
class LEArchSpec:
    kind: str = "unet"  # unet | plain_unet | plain_bottleneck | direct
    # per-trunk block lists for unet kind: "sft" | "plain" | "wide"
    trunks: tuple = tuple((n, ("sft",) * d) for n, d in _DEFAULT_TRUNK_DEPTHS.items())
    # per-trunk flat conv chain: name -> (depth, wide_nf | 0)
    flat_trunks: tuple = ()
    has_cond: bool = True  # SFT_layer1/2 + cond branch present
    linear_skips: bool = False
    bottleneck_scale: int = 0  # plain_bottleneck (8/16) or direct scale
    trunk3_wide: int = 0
    trunk3_depth: int = 4
    direct_cond: bool = False
    direct_gate: bool = False
    gate_limit: float = 0.75

    def trunk_blocks(self, name: str) -> tuple:
        for n, blocks in self.trunks:
            if n == name:
                return blocks
        return ()

    def flat_trunk(self, name: str):
        for n, cfg in self.flat_trunks:
            if n == name:
                return cfg
        return None


def _mk_trunks(kinds: dict[str, str], depths: dict[str, int] | None = None) -> tuple:
    depths = depths or _DEFAULT_TRUNK_DEPTHS
    return tuple((n, (kinds.get(n, "plain"),) * depths.get(n, 1)) for n in _DEFAULT_TRUNK_DEPTHS)


def parse_le_arch(le_arch: str | None) -> LEArchSpec:
    name = str(le_arch or "sft").strip().lower()
    canonical = name.replace("-", "").replace("_", "")

    m = re.fullmatch(r"plainbottleneckh(8|16)wide([0-9]+)x([0-9]+)", canonical)
    if m:
        return LEArchSpec(
            kind="plain_bottleneck",
            has_cond=False,
            linear_skips=True,
            bottleneck_scale=int(m.group(1)),
            trunk3_wide=int(m.group(2)),
            trunk3_depth=int(m.group(3)),
        )
    m = re.fullmatch(r"(plain|cond|condgate)directh(2|4|8|16|32)wide([0-9]+)x([0-9]+)", canonical)
    if m:
        which = m.group(1)
        return LEArchSpec(
            kind="direct",
            has_cond=False,
            bottleneck_scale=int(m.group(2)),
            trunk3_wide=int(m.group(3)),
            trunk3_depth=int(m.group(4)),
            direct_cond=which in ("cond", "condgate"),
            direct_gate=which == "condgate",
        )
    m = re.fullmatch(r"(?:select|selective)?sft([1-5]+)", canonical)
    if m and canonical != "sft":
        keep = {f"recon_trunk{d}" for d in dict.fromkeys(m.group(1))}
        return LEArchSpec(trunks=_mk_trunks({n: ("sft" if n in keep else "plain") for n in _DEFAULT_TRUNK_DEPTHS}))
    if name in {"bottleneck_sft", "bottleneck-sft", "trunk3_sft", "trunk3-sft"}:
        return LEArchSpec(trunks=_mk_trunks({"recon_trunk3": "sft"}))
    if name in {"lowres_sft", "lowres-sft"}:
        return LEArchSpec(trunks=_mk_trunks({n: "sft" for n in ("recon_trunk2", "recon_trunk3", "recon_trunk4")}))
    if name in {"downpath_sft", "downpath-sft"}:
        return LEArchSpec(trunks=_mk_trunks({n: "sft" for n in ("recon_trunk1", "recon_trunk2", "recon_trunk3")}))
    if name in {"bottleneck_heavy", "bottleneck-heavy", "heavy_bottleneck", "heavy-bottleneck"}:
        trunks = tuple(
            (n, ("plain",) * (8 if n == "recon_trunk3" else 0)) for n in _DEFAULT_TRUNK_DEPTHS
        )
        return LEArchSpec(trunks=trunks)

    m = re.fullmatch(r"(?:cleantrunk)?(?:plain)?flat(?:all|linear)?(?:wide([0-9]+)x)?([0-9]+)", canonical)
    plain = canonical.startswith("plainflat")
    if m and ("flat" in canonical):
        wide = int(m.group(1) or 0)
        depth = int(m.group(2))
        flatten_all = "flatall" in canonical or plain
        linear = "flatlinear" in canonical.replace("plainflat", "flat")
        flat = [("recon_trunk3", (depth, wide))]
        trunks_map = {}
        if flatten_all:
            for n in ("recon_trunk1", "recon_trunk2", "recon_trunk4", "recon_trunk5"):
                flat.append((n, (2, 0)))
        else:
            trunks_map = {n: "plain" for n in _DEFAULT_TRUNK_DEPTHS}
        trunks = _mk_trunks(trunks_map) if trunks_map else tuple(
            (n, ()) for n in _DEFAULT_TRUNK_DEPTHS
        )
        return LEArchSpec(
            kind="plain_unet" if plain else "unet",
            trunks=trunks,
            flat_trunks=tuple(flat),
            has_cond=not plain,
            linear_skips=linear,
            trunk3_depth=depth,
            trunk3_wide=wide,
        )

    m = re.fullmatch(r"cleantrunk(?:deep)?([0-9]+)?", canonical)
    if m and canonical.startswith("cleantrunk") and "wide" not in canonical:
        depth = int(m.group(1) or 4)
        depths = dict(_DEFAULT_TRUNK_DEPTHS, recon_trunk3=max(4, depth) if m.group(1) else 4)
        return LEArchSpec(trunks=_mk_trunks({}, depths), trunk3_depth=depths["recon_trunk3"])
    m = re.fullmatch(r"cleantrunkwide([0-9]+)x([0-9]+)", canonical) or re.fullmatch(
        r"wide([0-9]+)x([0-9]+)", canonical
    )
    if m:
        wide, extra = int(m.group(1)), int(m.group(2))
        trunks = list(_mk_trunks({}))
        t3 = ("plain",) * 4 + ("wide",) * extra
        trunks = tuple((n, t3 if n == "recon_trunk3" else b) for n, b in trunks)
        return LEArchSpec(trunks=trunks, trunk3_wide=wide, trunk3_depth=4 + extra)

    # default: full SFT
    return LEArchSpec()


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def sft(p: Params, name: str, fea: torch.Tensor, cond: torch.Tensor, *, policy: Policy = F32) -> torch.Tensor:
    """SFTLayer: ``fea * (scale + 1) + shift``, each op rounded in the
    element type."""
    def branch(kind):
        h = leaky_relu(conv2d(p, f"{name}.SFT_{kind}_conv0", cond, policy=policy), 0.1)
        return conv2d(p, f"{name}.SFT_{kind}_conv1", h, policy=policy)

    scale = branch("scale")
    shift = branch("shift")
    return fea * (scale + 1.0) + shift


def resblock_sft(p: Params, name: str, fea: torch.Tensor, cond: torch.Tensor, *, policy: Policy = F32):
    """ResBlock_with_SFT: SFT → 3×3 conv → ReLU → SFT → 3×3 conv, residual."""
    out = sft(p, f"{name}.sft1", fea, cond, policy=policy)
    out = relu(conv2d(p, f"{name}.conv1", out, padding=1, policy=policy))
    out = sft(p, f"{name}.sft2", out, cond, policy=policy)
    out = conv2d(p, f"{name}.conv2", out, padding=1, policy=policy)
    return fea + out


def resblock_plain(p: Params, name: str, fea: torch.Tensor, cond: torch.Tensor, *, policy: Policy = F32):
    """ResBlock_noSFT: 3×3 conv → ReLU → 3×3 conv, residual."""
    out = relu(conv2d(p, f"{name}.conv1", fea, padding=1, policy=policy))
    out = conv2d(p, f"{name}.conv2", out, padding=1, policy=policy)
    return fea + out


def resblock_wide(p: Params, name: str, fea: torch.Tensor, cond: torch.Tensor, *, policy: Policy = F32):
    """ResBlock_noSFTWide: 1×1 widen → 3×3 → 1×1 narrow, residual."""
    out = relu(conv2d(p, f"{name}.conv1", fea, policy=policy))
    out = relu(conv2d(p, f"{name}.conv2", out, padding=1, policy=policy))
    out = conv2d(p, f"{name}.conv3", out, policy=policy)
    return fea + out


_BLOCKS = {"sft": resblock_sft, "plain": resblock_plain, "wide": resblock_wide}


def _flat_chain(p, name, fea, depth, wide, *, policy):
    """A plain conv chain (TuplePlainConvTrunk): ``depth`` 3×3 convs with
    ReLU; with ``wide`` (TupleWidePlainConvTrunk) a 1×1 widen before them and
    a 1×1 narrow after, without a ReLU on the last."""
    if wide:
        fea = relu(conv2d(p, f"{name}.layers.0", fea, policy=policy))
        for i in range(depth):
            fea = relu(conv2d(p, f"{name}.layers.{2 * (i + 1)}", fea, padding=1, policy=policy))
        return conv2d(p, f"{name}.layers.{2 * (depth + 1)}", fea, policy=policy)
    for i in range(depth):
        fea = relu(conv2d(p, f"{name}.layers.{2 * i}", fea, padding=1, policy=policy))
    return fea


def _run_trunk(p, prefix, trunk_name, fea, cond, spec: LEArchSpec, *, policy):
    flat = spec.flat_trunk(trunk_name)
    name = f"{prefix}{trunk_name}"
    if flat is not None:
        depth, wide = flat
        return _flat_chain(p, name, fea, depth, wide, policy=policy)
    for i, kind in enumerate(spec.trunk_blocks(trunk_name)):
        fea = _BLOCKS[kind](p, f"{name}.{i}", fea, cond, policy=policy)
    return fea


def _act(act_type: str):
    if act_type == "leakyrelu":
        return lambda x: leaky_relu(x, 0.1)
    return relu


def _mask_out(p, prefix, img, weighting_network, *, policy):
    """The long skip: the input itself, or with ``weighting_network`` the
    input weighted by the mask_est head's per-pixel output."""
    if not weighting_network:
        return img
    m = relu(conv2d(p, f"{prefix}mask_est.0", img, padding=1, policy=policy))
    m = relu(conv2d(p, f"{prefix}mask_est.2", m, padding=1, policy=policy))
    m = relu(conv2d(p, f"{prefix}mask_est.4", m, policy=policy))
    mask = conv2d(p, f"{prefix}mask_est.6", m, policy=policy)
    return mask * img


def _cond_branch(p, prefix, cond_img, *, policy):
    def lrelu(x):
        return leaky_relu(x, 0.1)

    def conv(name, x, **kw):
        return conv2d(p, f"{prefix}{name}", x, policy=policy, **kw)

    c = lrelu(conv("cond_first.0", cond_img, padding=1))
    c = lrelu(conv("cond_first.2", c))
    c = lrelu(conv("cond_first.4", c))

    c1 = lrelu(conv("CondNet1.0", c))
    c1 = lrelu(conv("CondNet1.2", c1))
    cond1 = conv("CondNet1.4", c1)

    c2 = lrelu(conv("CondNet2.0", c, stride=2, padding=1))
    c2 = lrelu(conv("CondNet2.2", c2))
    cond2 = conv("CondNet2.4", c2)

    c3 = lrelu(conv("CondNet3.0", c, stride=2, padding=1))
    c3 = lrelu(conv("CondNet3.2", c3, stride=2, padding=1))
    cond3 = conv("CondNet3.4", c3)

    c4 = lrelu(conv("CondNet4.0", c, stride=2, padding=1))
    c4 = lrelu(conv("CondNet4.2", c4, stride=2, padding=1))
    cond4 = conv("CondNet4.4", c4, stride=2, padding=1)
    return cond1, cond2, cond3, cond4


def _up(p, prefix, layer, x, act, *, policy):
    return act(pixel_shuffle(conv2d(p, f"{prefix}{layer}.0", x, padding=1, policy=policy), 2))


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------


def _forward_unet(p, img, cond_img, spec, *, prefix, act, weighting_network, policy):
    """HDRUNet3T1's forward over a trunk spec: three stride-2 levels down,
    pixel-shuffle levels up with the skips re-aligned (``align_to``) to odd
    sides, SFT at full resolution, the long skip at the end."""
    mask_out = _mask_out(p, prefix, img, weighting_network, policy=policy)
    if spec.has_cond:
        cond1, cond2, cond3, cond4 = _cond_branch(p, prefix, cond_img, policy=policy)
    else:
        cond1 = cond2 = cond3 = cond4 = None

    fea0 = act(conv2d(p, f"{prefix}conv_first", img, padding=1, policy=policy))
    if spec.has_cond:
        fea0 = sft(p, f"{prefix}SFT_layer1", fea0, cond1, policy=policy)
    fea0 = act(conv2d(p, f"{prefix}HR_conv1", fea0, padding=1, policy=policy))

    fea1 = act(conv2d(p, f"{prefix}down_conv1", fea0, stride=2, padding=1, policy=policy))
    fea1 = _run_trunk(p, prefix, "recon_trunk1", fea1, cond2, spec, policy=policy)

    fea2 = act(conv2d(p, f"{prefix}down_conv2", fea1, stride=2, padding=1, policy=policy))
    fea2 = _run_trunk(p, prefix, "recon_trunk2", fea2, cond3, spec, policy=policy)

    fea3 = act(conv2d(p, f"{prefix}down_conv3", fea2, stride=2, padding=1, policy=policy))
    out = _run_trunk(p, prefix, "recon_trunk3", fea3, cond4, spec, policy=policy)
    if not spec.linear_skips:
        out = out + fea3

    up = _up(p, prefix, "up_conv1", out, act, policy=policy)
    up = align_to(up, fea2.shape[1], fea2.shape[2])
    out = up if spec.linear_skips else up + fea2
    out = _run_trunk(p, prefix, "recon_trunk4", out, cond3, spec, policy=policy)

    up = _up(p, prefix, "up_conv2", out, act, policy=policy)
    up = align_to(up, fea1.shape[1], fea1.shape[2])
    out = up if spec.linear_skips else up + fea1
    out = _run_trunk(p, prefix, "recon_trunk5", out, cond2, spec, policy=policy)

    up = _up(p, prefix, "up_conv3", out, act, policy=policy)
    up = align_to(up, fea0.shape[1], fea0.shape[2])
    out = up if spec.linear_skips else up + fea0
    if spec.has_cond:
        out = sft(p, f"{prefix}SFT_layer2", out, cond1, policy=policy)

    out = act(conv2d(p, f"{prefix}HR_conv2", out, padding=1, policy=policy))
    out = conv2d(p, f"{prefix}conv_last", out, padding=1, policy=policy)
    out = align_to(out, mask_out.shape[1], mask_out.shape[2])
    return mask_out + out


def _forward_plain_bottleneck(p, img, spec, *, prefix, act, weighting_network, policy):
    """HDRUNet3T1PlainBottleneck: the down path without SFT or skips, one
    flat (or wide) conv chain at /8 (at /16 after a fourth down conv, with
    ``up_conv0`` back), the up path re-aligned to each level, the long
    skip."""
    mask_out = _mask_out(p, prefix, img, weighting_network, policy=policy)

    def conv(name, x, **kw):
        return conv2d(p, f"{prefix}{name}", x, policy=policy, **kw)

    fea0 = act(conv("conv_first", img, padding=1))
    fea0 = act(conv("HR_conv1", fea0, padding=1))
    fea1 = act(conv("down_conv1", fea0, stride=2, padding=1))
    fea2 = act(conv("down_conv2", fea1, stride=2, padding=1))
    fea3 = act(conv("down_conv3", fea2, stride=2, padding=1))

    b = fea3
    if spec.bottleneck_scale >= 16:
        b = act(conv("down_conv4", b, stride=2, padding=1))
    out = _flat_chain(p, f"{prefix}recon_trunk3", b, spec.trunk3_depth, spec.trunk3_wide, policy=policy)
    if spec.bottleneck_scale >= 16:
        out = align_to(_up(p, prefix, "up_conv0", out, act, policy=policy), fea3.shape[1], fea3.shape[2])
    out = align_to(_up(p, prefix, "up_conv1", out, act, policy=policy), fea2.shape[1], fea2.shape[2])
    out = align_to(_up(p, prefix, "up_conv2", out, act, policy=policy), fea1.shape[1], fea1.shape[2])
    out = align_to(_up(p, prefix, "up_conv3", out, act, policy=policy), fea0.shape[1], fea0.shape[2])

    out = act(conv("HR_conv2", out, padding=1))
    out = conv("conv_last", out, padding=1)
    out = align_to(out, mask_out.shape[1], mask_out.shape[2])
    return mask_out + out


def _forward_direct(p, img, cond_img, spec, *, prefix, act, weighting_network, policy):
    """(Plain|Cond|CondGated)Direct: the frame avg-pooled by the arch's
    scale (with ``direct_cond`` the condition image pooled to the same grid
    beside it), a 1×1 in, with ``direct_gate`` a tanh self-gate, a 3×3 trunk,
    a 1×1 out, pixel shuffle back to full resolution, the long skip."""
    mask_out = _mask_out(p, prefix, img, weighting_network, policy=policy)
    s = spec.bottleneck_scale
    low = avg_pool(img, s)
    if spec.direct_cond:
        low_cond = avg_pool(policy.cast(cond_img), max(1, s // 4))
        low = torch.cat((low, align_to(low_cond, low.shape[1], low.shape[2])), dim=-1)
    out = act(conv2d(p, f"{prefix}low_in", low, policy=policy))
    if spec.direct_gate:
        g = relu(conv2d(p, f"{prefix}feature_gate.0", out, policy=policy))
        g = conv2d(p, f"{prefix}feature_gate.2", g, padding=1, policy=policy)
        out = out * (1.0 + torch.tanh(g) * scalar_of(spec.gate_limit, g.dtype))
    for i in range(max(1, spec.trunk3_depth)):
        out = relu(conv2d(p, f"{prefix}recon_trunk3.{2 * i}", out, padding=1, policy=policy))
    out = pixel_shuffle(conv2d(p, f"{prefix}low_out", out, policy=policy), s)
    out = align_to(out, mask_out.shape[1], mask_out.shape[2])
    return mask_out + out


def le_apply(
    p: Params,
    img: torch.Tensor,
    cond_img: torch.Tensor,
    *,
    prefix: str = "LE.",
    le_arch: str = "sft",
    act_type: str = "relu",
    weighting_network: bool = False,
    trunk3_depth: int | None = None,
    policy: Policy = F32,
) -> torch.Tensor:
    """HDRUNet3T1-family forward, NHWC. ``img`` and ``cond_img`` are both
    the AGCM output in the ensemble."""
    spec = parse_le_arch(le_arch)
    if trunk3_depth is not None and spec.kind == "unet":
        trunks = tuple(
            (n, (b[0] if b else "plain",) * (trunk3_depth if n == "recon_trunk3" else len(b)))
            for n, b in spec.trunks
        )
        spec = dataclasses.replace(spec, trunks=trunks)
    kw = {"prefix": prefix, "act": _act(act_type), "weighting_network": weighting_network, "policy": policy}
    img, cond_img = policy.cast(img), policy.cast(cond_img)
    if spec.kind == "direct":
        return _forward_direct(p, img, cond_img, spec, **kw)
    if spec.kind == "plain_bottleneck":
        return _forward_plain_bottleneck(p, img, spec, **kw)
    return _forward_unet(p, img, cond_img, spec, **kw)
