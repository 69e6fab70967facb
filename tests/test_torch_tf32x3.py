"""The arithmetic of the fp32 3×TF32 Hopper tile (csrc/conv3x3_tf32x3.cuh), on
the CPU, before the card holds it.

- The split: a torch emulation of ``cvt.rna.tf32.f32`` (round to nearest,
  ties away from zero, on the low 13 bits); big = tf32(x), small = tf32(x −
  big) reconstruct x to within 2^-21·|x| on seeded inputs over a wide range
  of magnitudes.
- The three-product conv: each chunk's small·big + big·small + big·big
  summed in fp32 and added to the running sum, walked over the very chunk
  table ``ops/conv_kernels.py sm90_table`` hands the card, at the fp32 programs' channel shapes at a small spatial size, against
  the JAX package's fp32 ``fused_block_conv3`` and ``fused_down2`` (Pallas in
  interpret mode) within 1e-4, the kernels' fp32 contract; and at least 16×
  closer to the port's plain fp32 version than one TF32 product is, which is
  why the tile takes three.
- The table: ``sm90_table`` gives a table for every fp32 call of block_conv3
  and down2 with ``a_sub`` ≥ 1 that the fp32 frame program makes (collected
  from a CPU frame), raises on a shape the tile refuses, and leaves the
  dense fp32 product (``a_sub`` = 0) to the FMA tile.

The emulation lives here, not on the main path: on the CPU the wrappers run
their plain versions.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from hdrtv_tpu_torch.models.s2d import w_s2d_s1, w_s2d_s1_ps, w_s2d_s2
from hdrtv_tpu_torch.ops.conv_kernels import CHUNK, TF32X3_LIST_MAX, fused_block_conv3_ref, sm90_table
from hdrtv_tpu_torch.ops.megakernel import fused_down2_ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
f32 = np.float32
ATOL = 1e-4  # the fp32 kernels' contract against their plain versions (chip_smoke.py ATOL)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: x rounded to 10 explicit mantissa bits, to
    nearest with ties away from zero (add half of the dropped 13 bits' unit
    to the magnitude, then clear them), as an fp32 value."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = ((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r)
    return r.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


@pytest.mark.parametrize("seed,lo,hi", [(0, -1, 1), (1, -30, 30), (2, -6, 3)], ids=["unit", "wide", "weights"])
def test_split_reconstructs(seed, lo, hi):
    rng = np.random.RandomState(seed)
    x64 = rng.randn(200_000) * 10.0 ** rng.uniform(lo, hi, 200_000)
    x = torch.from_numpy(x64.astype(f32))
    big, small = split(x)
    for part in (big, small):
        assert (part.view(torch.int32) & 0x1FFF == 0).all()  # tf32: the low 13 bits clear
    xd, bd, sd = x.double(), big.double(), small.double()
    assert ((xd - bd).abs() <= 2.0 ** -11 * xd.abs()).all()
    assert ((xd - (bd + sd)).abs() <= 2.0 ** -21 * xd.abs()).all()


def test_split_rounds_ties_away():
    one = 1.0 + 2.0 ** -11  # halfway between two tf32 values: away from zero
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -11], dtype=torch.float32)
    assert tf32_rna(x).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 1.0 + 2 * 2.0 ** -10]


def _walk(table, per_list: int) -> list[list[tuple[int, int]]]:
    """The card's table decoded: per list, (tap, c0) of each chunk."""
    entries = list(table)
    return [[(e & 15, e >> 4) for e in entries[i: i + per_list]] for i in range(0, len(entries), per_list)]


def _tile_conv(x, w, b, *, stride, a_sub, table, per_list, act=None, skip=None, products=3, skip2=None):
    """The conv as the 3×TF32 tile sums it: for each output sub-position
    (its channels in each of the a_sub blocks; a_sub = 0, the dense table:
    all channels, one list), over the chunks of its list in the table, each
    chunk's small·big + big·small + big·big (``products`` = 1: big·big
    alone, one TF32 product) summed in fp32 from zero and added to the
    running fp32 sum; then bias, skip, the second skip (trunk3's two-skip
    epilogue), the activation."""
    hb, wb, c = x.shape
    co = w.shape[-1]
    ho, wo = hb // stride, wb // stride
    pad = (0, 0, 1, 1, 1, 1) if stride == 1 else (0, 0, 1, 0, 1, 0)
    xp = F.pad(x, pad)
    taps = [xp[dI: dI + stride * ho: stride, dJ: dJ + stride * wo: stride].reshape(ho * wo, c)
            for dI in range(3) for dJ in range(3)]
    w9 = w.reshape(9, c, co)
    lists = _walk(table, per_list)
    if a_sub:
        co_blk, co_nat = co // a_sub, co // (4 * a_sub)
        col_sets = [torch.cat([torch.arange(blk * co_blk + so * co_nat, blk * co_blk + (so + 1) * co_nat)
                               for blk in range(a_sub)]) for so in range(len(lists))]
    else:
        col_sets = [torch.arange(co)]
    y = torch.zeros(ho * wo, co)
    for cols, chunks in zip(col_sets, lists, strict=True):
        acc = torch.zeros(ho * wo, len(cols))
        for tap, c0 in chunks:
            ab, asm = split(taps[tap][:, c0: c0 + CHUNK].contiguous())
            bb, bs = split(w9[tap, c0: c0 + CHUNK][:, cols].contiguous())
            part = asm @ bb + ab @ bs + ab @ bb if products == 3 else ab @ bb
            acc = acc + part
        y[:, cols] = acc
    y = y.reshape(ho, wo, co) + b
    if skip is not None:
        y = y + skip
    if skip2 is not None:
        y = y + skip2
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    elif act == "lrelu":
        y = torch.where(y >= 0, y, y * 0.1)
    return y


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _weight(rng, tf, a_sub, ci, co_nat):
    return np.concatenate([tf(rng.randn(3, 3, ci, co_nat).astype(f32) * 0.05) for _ in range(a_sub)], axis=-1)


# The fp32 programs' block_conv3 shapes: the 128 → 128 convs (HR_conv, the trunks; co_nat
# 32), with a skip (the trunks' second conv), and up_conv2/3's PS fold to Co = 512.
@pytest.mark.parametrize("transform,ci,co_nat,relu,skip", [
    ("s1", 32, 32, True, False), ("s1", 32, 32, False, True), ("s1_ps", 32, 128, True, False),
], ids=["co128", "co128-skip", "ps-co512"])
def test_block_conv3_tf32x3_matches_jax(transform, ci, co_nat, relu, skip):
    from hdrtv_tpu.ops.conv_kernels import fused_block_conv3 as jax_conv

    rng = np.random.RandomState(ci + co_nat + skip)
    hb, wb = 12, 16
    tf = w_s2d_s1_ps if transform == "s1_ps" else w_s2d_s1
    w = _weight(rng, tf, 1, ci, co_nat)
    c, co = w.shape[2], w.shape[3]
    x = (rng.rand(hb, wb, c) - 0.3).astype(f32)
    b = (rng.randn(co) * 0.1).astype(f32)
    sk = rng.rand(hb, wb, co).astype(f32) if skip else None
    xt, wt, bt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    st = None if sk is None else torch.from_numpy(sk)
    table, per_list = sm90_table("block_conv3", 1, 1, c, co, c, dtype=torch.float32)
    got = _tile_conv(xt, wt, bt, stride=1, a_sub=1, table=table, per_list=per_list,
                     act="relu" if relu else None, skip=st)
    with pltpu.force_tpu_interpret_mode():
        want = jax_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=relu,
                        skip=None if sk is None else jnp.asarray(sk), a_sub=1)
    assert _err(got, want) <= ATOL
    plain = fused_block_conv3_ref(xt, wt, bt, relu=relu, skip=st)
    one = _tile_conv(xt, wt, bt, stride=1, a_sub=1, table=table, per_list=per_list,
                     act="relu" if relu else None, skip=st, products=1)
    assert _err(got, plain) * 16 <= _err(one, plain)


# The fp32 programs' down2 shapes: the consolidated CondNet down conv (C = 256, a_sub = 3),
# CondNet3.2's window [256, 512) of its 768-channel output, down_conv1/2 (128 → 128).
@pytest.mark.parametrize("a_sub,ci,co_nat,cf,ch0,act", [
    (3, 64, 64, 256, 0, "lrelu"), (1, 64, 64, 768, 256, "lrelu"), (1, 32, 32, 128, 0, "relu"),
], ids=["cond_down-a_sub3", "window-ch0", "down_conv"])
def test_down2_tf32x3_matches_jax(a_sub, ci, co_nat, cf, ch0, act):
    from hdrtv_tpu.ops.megakernel import fused_down2 as jax_down2

    rng = np.random.RandomState(ci + co_nat + a_sub + ch0 + 7)
    hb, wb = 12, 16
    w = _weight(rng, w_s2d_s2, a_sub, ci, co_nat)
    c, co = w.shape[2], w.shape[3]
    x = rng.rand(hb, wb, cf).astype(f32)
    b = (rng.randn(co) * 0.1).astype(f32)
    xt, wt, bt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    win = xt[..., ch0: ch0 + c]
    table, per_list = sm90_table("down2", 2, a_sub, c, co, cf, ch0, dtype=torch.float32)
    got = _tile_conv(win, wt, bt, stride=2, a_sub=a_sub, table=table, per_list=per_list, act=act)
    cin = None if c == cf else c
    with pltpu.force_tpu_interpret_mode():
        want = jax_down2(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act=act, a_sub=a_sub, cin=cin, ch0=ch0)
    assert _err(got, want) <= ATOL
    plain = fused_down2_ref(win, wt, bt, act=act)
    one = _tile_conv(win, wt, bt, stride=2, a_sub=a_sub, table=table, per_list=per_list, act=act, products=1)
    assert _err(got, plain) * 16 <= _err(one, plain)


def _fp32_program_calls(monkeypatch) -> list[tuple]:
    """The (kernel, stride, a_sub, C, Co, pitch, ch0) of every block_conv3 and
    down2 call of the fp32 frame program, from one CPU frame."""
    from hdrtv_tpu_torch.models import s2d
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    calls = []
    conv, down = s2d.fused_block_conv3, s2d.fused_down2

    def rec_conv(x, w, b, **kw):
        calls.append(("block_conv3", 1, kw.get("a_sub", 0), x.shape[-1], w.shape[-1], x.shape[-1], 0,
                      kw.get("qargs") is not None))
        return conv(x, w, b, **kw)

    def rec_down(x, w, b, **kw):
        c = kw.get("cin") or x.shape[-1]
        calls.append(("down2", 2, kw.get("a_sub", 1), c, w.shape[-1], x.shape[-1], kw.get("ch0", 0),
                      kw.get("qargs") is not None))
        return down(x, w, b, **kw)

    monkeypatch.setattr(s2d, "fused_block_conv3", rec_conv)
    monkeypatch.setattr(s2d, "fused_down2", rec_down)
    proc = HDRTVNetTorch(os.path.join(ROOT, "weights", "hr_fp32.npz"), precision="fp32", device="cpu")
    frame = (np.random.RandomState(5).rand(64, 96, 3) * 255).astype(np.uint8)
    proc.process_rgb48(frame)
    return calls


def test_sm90_table_takes_every_fp32_program_call(monkeypatch):
    calls = _fp32_program_calls(monkeypatch)
    kinds = [k for k, *_ in calls]
    assert kinds.count("block_conv3") == 12 and kinds.count("down2") == 5
    for kernel, stride, a_sub, c, co, cf, ch0, int8 in calls:
        assert a_sub >= 1 and not int8
        table, per_list = sm90_table(kernel, stride, a_sub, c, co, cf, ch0, dtype=torch.float32)
        assert table is not None and per_list <= TF32X3_LIST_MAX
        assert len(table) == 4 * per_list == 9 * c // CHUNK


@pytest.mark.parametrize("name,stride,a_sub,c,co,cf,ch0", [
    ("block_conv3", 1, 1, 512, 512, 512, 0),  # 36 chunks a list: the split weights do not fit
    ("block_conv3", 1, 1, 64, 128, 64, 0),  # a 16-channel slot
    ("down2", 2, 1, 128, 64, 128, 0),  # a 16-channel output sub-position
    ("down2", 2, 1, 256, 256, 770, 256),  # a pixel pitch off the 16-byte groups
], ids=["c512", "slot16", "co_nat16", "pitch"])
def test_sm90_table_fp32_refusals_raise(name, stride, a_sub, c, co, cf, ch0):
    with pytest.raises(ValueError, match="3×TF32 Hopper tile"):
        sm90_table(name, stride, a_sub, c, co, cf, ch0, dtype=torch.float32)


def test_sm90_table_fp32_dense_stays_off_the_tile():
    # the dense fp32 product runs the FMA tile; the bf16 one the Hopper tile
    assert sm90_table("block_conv3", 1, 0, 128, 128, 128, dtype=torch.float32) == (None, 0)
    assert sm90_table("block_conv3", 1, 0, 128, 128, 128)[0] is not None
    # fp32 takes a window start on 16-byte groups that bf16 does not
    assert sm90_table("down2", 2, 1, 256, 256, 772, 260, dtype=torch.float32)[1] == 18
    with pytest.raises(ValueError, match="Hopper tile"):
        sm90_table("down2", 2, 1, 256, 256, 772, 260)
