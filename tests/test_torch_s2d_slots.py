"""The s2d slot table (hdrtv_tpu_torch/models/s2d.py ``s2d_slots``) that the
Hopper conv tile (csrc/conv3x3_sm90.cuh) walks for block_conv3 and down2 with
``a_sub`` ≥ 1, on the CPU.

- The table against the transforms: every slot it leaves out of a
  ``w_s2d_s1``, ``w_s2d_s1_ps`` or ``w_s2d_s2`` weight is exactly zero, every
  slot it lists is not.
- The order of sums: a plain conv that sums only the listed chunks, in the
  tile's order (``ops/conv_kernels.py conv_chunks``), against the dense plain
  versions and the JAX kernels with ``a_sub`` in interpret mode. fp32 within
  3e-5 (the same products summed in another order); bf16 within one bf16 step
  on at most 0.5% of the elements (the same exact products, fp32 sums in
  another order, one rounding).
- The real weights: every weight the port's parameter transform routes to
  block_conv3 or down2 with ``a_sub`` ≥ 1 is zero in every skipped slot, for
  ``weights/hr_fp32.npz`` and the pre-dequantized ``tests/fixtures/hr_w8a8.npz``.
- Shapes that do not divide raise, on the CPU path too.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from hdrtv_tpu_torch.models.s2d import s2d_slots, s2d_transform_params, w_s2d_s1, w_s2d_s1_ps, w_s2d_s2
from hdrtv_tpu_torch.ops.conv_kernels import CHUNK, conv_chunks, fused_block_conv3, fused_block_conv3_ref, sm90_table
from hdrtv_tpu_torch.ops.megakernel import fused_down2, fused_down2_ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
f32 = np.float32
TRANSFORMS = {"s1": (w_s2d_s1, 1), "s1_ps": (w_s2d_s1_ps, 1), "s2": (w_s2d_s2, 2)}


def _blocks(w: np.ndarray, a_sub: int) -> np.ndarray:
    """An s2d weight (3, 3, 4·ci, a_sub·4·co) as |values| summed per
    (tap, input sub-position, output sub-position): shape (9, 4, 4)."""
    ci, co = w.shape[2] // 4, w.shape[3] // (4 * a_sub)
    a = np.abs(w.reshape(9, 4, ci, a_sub, 4, co))
    return a.sum(axis=(2, 3, 5))


def _listed(stride: int) -> np.ndarray:
    mask = np.zeros((9, 4, 4), bool)
    for so, slots in enumerate(s2d_slots(stride)):
        for tap, si in slots:
            mask[tap, si, so] = True
    return mask


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_slots_match_transforms(name):
    tf, stride = TRANSFORMS[name]
    w = tf(np.random.RandomState(3).randn(3, 3, 8, 12).astype(f32) + 0.01)
    blocks, mask = _blocks(w, 1), _listed(stride)
    assert (blocks[~mask] == 0).all()
    assert (blocks[mask] > 0).all()
    slots = s2d_slots(stride)
    assert [len(s) for s in slots] == [9, 9, 9, 9]
    assert len({slot for s in slots for slot in s}) == (16 if stride == 1 else 25)
    # the tile's K walk: a quarter of the dense product's chunks per output sub-position
    assert [len(c) for c in conv_chunks(stride, 1, 256)] == [9 * 64 // CHUNK] * 4
    assert len(conv_chunks(stride, 0, 256)[0]) == 9 * 256 // CHUNK


def _slot_conv(x, w, b, *, stride, a_sub, act=None, skip=None):
    """The conv as the Hopper tile sums it: for each output sub-position
    (each of the a_sub blocks' co_nat channels there), fp32 products of only
    its listed chunks, added chunk by chunk in conv_chunks order; then the
    bias, the skip, the activation and one rounding to x's dtype."""
    hb, wb, c = x.shape
    co = w.shape[-1]
    ho, wo = hb // stride, wb // stride
    pad = (0, 0, 1, 1, 1, 1) if stride == 1 else (0, 0, 1, 0, 1, 0)
    xp = F.pad(x.float(), pad)
    taps = [xp[dI: dI + stride * ho: stride, dJ: dJ + stride * wo: stride].reshape(ho * wo, c)
            for dI in range(3) for dJ in range(3)]
    w9 = w.float().reshape(9, c, co)
    co_blk, co_nat = co // a_sub, co // (4 * a_sub)
    y = torch.zeros(ho * wo, co)
    for so, chunks in enumerate(conv_chunks(stride, a_sub, c)):
        cols = torch.cat([torch.arange(blk * co_blk + so * co_nat, blk * co_blk + (so + 1) * co_nat)
                          for blk in range(a_sub)])
        acc = torch.zeros(ho * wo, len(cols))
        for tap, c0 in chunks:
            acc = acc + taps[tap][:, c0: c0 + CHUNK] @ w9[tap, c0: c0 + CHUNK][:, cols]
        y[:, cols] = acc
    y = y.reshape(ho, wo, co) + b
    if skip is not None:
        y = y + skip.float()
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    elif act == "lrelu":
        y = torch.where(y >= 0, y, y * 0.1)
    return y.to(x.dtype)


def _both(a, dtype):
    a = np.ascontiguousarray(a, f32)
    j, t = jnp.asarray(a), torch.from_numpy(a.copy())
    if dtype == "bf16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _close(got: torch.Tensor, want: np.ndarray, dtype: str):
    g, w = got.float().numpy(), np.asarray(want, f32)
    assert g.shape == w.shape
    err = np.abs(g - w)
    if dtype == "f32":
        assert float(err.max()) <= 3e-5, float(err.max())
    else:
        assert (err <= 2.0 ** -7 * np.maximum(1.0, np.abs(w))).all(), float(err.max())
        assert float((err > 0).mean()) <= 0.005, float((err > 0).mean())


def _weight(rng, tf, a_sub, ci, co_nat):
    return np.concatenate([tf(rng.randn(3, 3, ci, co_nat).astype(f32) * 0.05) for _ in range(a_sub)], axis=-1)


@pytest.mark.parametrize("dtype,transform,a_sub,ci,co_nat,relu,skip", [
    ("f32", "s1", 1, 32, 32, True, False),
    ("bf16", "s1_ps", 1, 32, 128, True, False),  # up_conv2/3: PS-folded, Co = 512
    ("f32", "s1", 2, 32, 64, False, True),  # LE.__in_fused: two s2d blocks side by side
], ids=["a_sub1", "ps-co512", "a_sub2-skip"])
def test_block_conv3_slot_order(dtype, transform, a_sub, ci, co_nat, relu, skip):
    from hdrtv_tpu.ops.conv_kernels import fused_block_conv3 as jax_conv

    rng = np.random.RandomState(ci + co_nat + a_sub)
    hb, wb = 16, 16
    w = _weight(rng, TRANSFORMS[transform][0], a_sub, ci, co_nat)
    c, co = w.shape[2], w.shape[3]
    xj, xt = _both(rng.rand(hb, wb, c) - 0.3, dtype)
    wj, wt = _both(w, dtype)
    bj, bt = _both(rng.randn(co) * 0.1, "f32")
    sj, st = _both(rng.rand(hb, wb, co), dtype) if skip else (None, None)
    got = _slot_conv(xt, wt, bt, stride=1, a_sub=a_sub, act="relu" if relu else None, skip=st)
    _close(got, fused_block_conv3_ref(xt, wt, bt, relu=relu, skip=st).float().numpy(), dtype)
    _close(fused_block_conv3(xt, wt, bt, relu=relu, skip=st, a_sub=a_sub),
           fused_block_conv3_ref(xt, wt, bt, relu=relu, skip=st).float().numpy(), dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_conv(xj, wj, bj, relu=relu, skip=sj, a_sub=a_sub)
    _close(got, want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype,a_sub,ci,co_nat,cf,ch0,act", [
    ("f32", 1, 32, 32, 128, 0, "relu"),  # down_conv1/2
    ("bf16", 3, 64, 64, 256, 0, "lrelu"),  # LE.__cond_down, the three CondNet down convs
    ("f32", 1, 64, 64, 768, 256, "lrelu"),  # CondNet3.2: the window [256, 512) of __cond_down's output
], ids=["a_sub1", "cond_down-a_sub3", "window-ch0"])
def test_down2_slot_order(dtype, a_sub, ci, co_nat, cf, ch0, act):
    from hdrtv_tpu.ops.megakernel import fused_down2 as jax_down2

    rng = np.random.RandomState(ci + co_nat + a_sub + ch0)
    hb, wb = 16, 16
    w = _weight(rng, w_s2d_s2, a_sub, ci, co_nat)
    c, co = w.shape[2], w.shape[3]
    xj, xt = _both(rng.rand(hb, wb, cf), dtype)
    wj, wt = _both(w, dtype)
    bj, bt = _both(rng.randn(co) * 0.1, "f32")
    win = xt[..., ch0: ch0 + c]
    got = _slot_conv(win, wt, bt, stride=2, a_sub=a_sub, act=act)
    _close(got, fused_down2_ref(win, wt, bt, act=act).float().numpy(), dtype)
    cin = None if c == cf else c
    _close(fused_down2(xt, wt, bt, act=act, cin=cin, ch0=ch0, a_sub=a_sub),
           fused_down2_ref(win, wt, bt, act=act).float().numpy(), dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_down2(xj, wj, bj, act=act, a_sub=a_sub, cin=cin, ch0=ch0)
    _close(got, want.astype(jnp.float32), dtype)


def _routed(sp: dict) -> dict:
    """The transformed weights that conv_s1 and conv_s2 hand block_conv3 and
    down2 with a_sub ≥ 1, by the roles of models/s2d.py and its channel rule
    (``_fits_kernel``): name → (stride, a_sub). LE.__in_fused (a_sub 2, C =
    12) never fits."""
    from hdrtv_tpu_torch.models import s2d

    layers = {layer: (2 if role == s2d._S2 else 1, 1) for layer, role in s2d._le_layer_roles().items()
              if role in (s2d._S1, s2d._PSL, s2d._S2)}
    layers.update({"LE.__in_fused": (1, 2), "LE.__cond_down": (2, 3)})
    return {layer: sa for layer, sa in layers.items()
            if f"{layer}.weight" in sp and s2d._fits_kernel(sp[f"{layer}.weight"])}


@pytest.mark.parametrize("path", ["weights/hr_fp32.npz", "tests/fixtures/hr_w8a8.npz"])
def test_real_weights_zero_in_skipped_slots(path):
    from hdrtv_tpu_torch.models.import_npz import load_npz
    from hdrtv_tpu_torch.quant.int8 import predequantize_params

    params = load_npz(os.path.join(ROOT, path))
    if any(k.endswith(".weight_int8") for k in params):
        params = predequantize_params(params)
    sp = s2d_transform_params(params)
    routed = _routed(sp)
    assert {"LE.__cond_down", "LE.up_conv2.0", "LE.up_conv3.0", "LE.down_conv1"} <= set(routed)
    for layer, (stride, a_sub) in routed.items():
        w = np.asarray(sp[f"{layer}.weight"])
        assert (_blocks(w, a_sub)[~_listed(stride)] == 0).all(), layer


def test_bad_a_sub_shapes_raise():
    x, b = torch.zeros(4, 4, 128), torch.zeros(132)
    with pytest.raises(ValueError, match="a_sub"):  # Co % (4·a_sub)
        fused_block_conv3(x, torch.zeros(3, 3, 128, 132), b, a_sub=2)
    with pytest.raises(ValueError, match="a_sub"):  # C % 4
        fused_block_conv3(torch.zeros(4, 4, 130), torch.zeros(3, 3, 130, 128), torch.zeros(128), a_sub=1)
    with pytest.raises(ValueError, match="a_sub"):
        fused_down2(torch.zeros(4, 4, 256), torch.zeros(3, 3, 256, 128), torch.zeros(128), a_sub=3)
    # what the tile refuses with a_sub ≥ 1 raises; the dense product takes the mma.sync tile
    with pytest.raises(ValueError, match="Hopper tile"):  # a 16-channel slot
        sm90_table("block_conv3", 1, 1, 64, 128, 64)
    with pytest.raises(ValueError, match="Hopper tile"):  # a 16-channel output sub-position
        sm90_table("down2", 2, 1, 128, 64, 128)
    assert sm90_table("block_conv3", 1, 0, 64, 128, 64)[0] is not None
    assert sm90_table("block_conv3", 1, 0, 48, 128, 48) == (None, 0)
    table, per = sm90_table("down2", 2, 3, 256, 768, 768, 256)
    # output sub-position 0 at stride 2 starts at tap 0, input sub-position 3: channels 192 and 224
    assert per == 18 and len(table) == 72 and list(table)[:2] == [192 << 4, 224 << 4]
