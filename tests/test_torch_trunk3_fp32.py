"""trunk3's fp32 instance on the card's routes, emulated on the CPU before
the card holds it: its nine convs on the 3×TF32 tile (csrc/conv3x3_tf32x3.cuh)
over the dense 9-chunk table ``ops/conv_kernels.py sm90_table`` hands the
card for trunk3, its eight SFT passes as the coalesced fp32 pass of
csrc/trunk3.cu sums them.

- The table: trunk3's explicit request (``dense_tf32x3``) gives one list of
  the 9 taps of a 32-channel conv, and it holds every trunk3 call of the
  fp32 frame program (collected from a CPU frame); block_conv3's and
  down2's dense fp32 products stay off the tile
  (``test_torch_tf32x3.py::test_sm90_table_fp32_dense_stays_off_the_tile``).
- The chain: the tile's emulation (each operand split into TF32 big and
  small, each chunk's three products summed from zero in fp32 and added to
  the running fp32 sum; ``tests/test_torch_tf32x3.py _tile_conv``) walked
  over that table through all 17 stages, the fourth conv2 through the
  two-skip epilogue (x + conv2(t), then + fea3), against the JAX package's
  fp32 ``fused_trunk3`` (Pallas in interpret mode) within 5e-4, the fp32
  trunk3 check of ``chip_smoke.py``. 9 rows: odd, and the smallest the
  Pallas kernel tiles (its tile rows must be ≥ 9 and divide the rows); 20
  columns: a third of the tile's 64-column row.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hdrtv_tpu_torch.ops.conv_kernels import CHUNK, sm90_table
from tests.test_torch_tf32x3 import _tile_conv, _walk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
f32 = np.float32
ATOL = 5e-4  # trunk3's fp32 check against its plain version (chip_smoke.py)


def _dense_table():
    return sm90_table("trunk3", 1, 0, 32, 32, 32, dtype=torch.float32, dense_tf32x3=True)


def test_dense_tf32x3_table_is_one_list_of_nine_taps():
    table, per_list = _dense_table()
    assert per_list == 9 and len(table) == 9
    assert _walk(table, per_list) == [[(tap, 0) for tap in range(9)]]
    # the same list the bf16 tile takes for trunk3
    assert list(sm90_table("trunk3", 1, 0, 32, 32, 32)[0]) == list(table)


@pytest.mark.parametrize("c,co,cf", [(128, 128, 128), (32, 16, 32), (48, 32, 48)],
                         ids=["c128-list36", "co16", "c48"])
def test_dense_tf32x3_request_raises_where_the_tile_refuses(c, co, cf):
    with pytest.raises(ValueError, match="3×TF32 Hopper tile takes the dense product"):
        sm90_table("trunk3", 1, 0, c, co, cf, dtype=torch.float32, dense_tf32x3=True)


def test_fp32_program_trunk3_call_takes_the_dense_table(monkeypatch):
    """Every trunk3 call of the fp32 frame program (one, from a CPU frame)
    has the widths the card's route takes: C = 32, CC = 16, Co % 32, and
    the dense table for its C."""
    from hdrtv_tpu_torch.models import s2d
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    calls = []
    trunk3 = s2d.fused_trunk3

    def rec(fea3, cond4, blocks, w_up, b_up, **kw):
        calls.append((fea3.dtype, fea3.shape[-1], cond4.shape[-1], w_up.shape[-1], kw.get("packed") is not None))
        return trunk3(fea3, cond4, blocks, w_up, b_up, **kw)

    monkeypatch.setattr(s2d, "fused_trunk3", rec)
    proc = HDRTVNetTorch(os.path.join(ROOT, "weights", "hr_fp32.npz"), precision="fp32", device="cpu")
    proc.process_rgb48((np.random.RandomState(6).rand(64, 96, 3) * 255).astype(np.uint8))
    assert calls == [(torch.float32, 32, 16, 128, True)]
    table, per_list = sm90_table("trunk3", 1, 0, calls[0][1], calls[0][1], calls[0][1], dtype=torch.float32,
                                 dense_tf32x3=True)
    assert per_list == 9 * 32 // CHUNK


def _sft_rows(x, cond, sft4):
    """The coalesced fp32 SFT pass's sums: a lane's hidden unit from its bias
    over the 16 cond values in order, lrelu 0.1; a lane's channel of scale
    and of shift from its bias over the 16 hidden units in order; t = x ·
    (scale + 1) + shift."""
    rows = cond.reshape(-1, cond.shape[-1])

    def branch(p0, p1):
        (w0, b0), (w1, b1) = p0, p1
        h = b0.expand(rows.shape[0], -1)
        for i in range(w0.shape[0]):
            h = h + rows[:, i: i + 1] * w0[i]
        h = torch.where(h >= 0, h, h * 0.1)
        o = b1.expand(rows.shape[0], -1)
        for j in range(w1.shape[0]):
            o = o + h[:, j: j + 1] * w1[j]
        return o

    scale, shift = branch(sft4[0], sft4[1]), branch(sft4[2], sft4[3])
    return (x.reshape(rows.shape[0], -1) * (scale + 1.0) + shift).reshape(x.shape)


def _trunk3_on_card_routes(fea3, cond4, blocks, w_up, b_up):
    """The 17 stages as the fp32 instance runs them on the card."""
    table, per_list = _dense_table()

    def conv(x, w, b, **kw):
        return _tile_conv(x, w, b, stride=1, a_sub=0, table=table, per_list=per_list, **kw)

    x = fea3
    for i, (sft1, w1, b1, sft2, w2, b2) in enumerate(blocks):
        h = conv(_sft_rows(x, cond4, sft1), w1, b1, act="relu")
        x = conv(_sft_rows(h, cond4, sft2), w2, b2, skip=x, skip2=fea3 if i == 3 else None)
    return conv(x, w_up, b_up, act="relu")


@pytest.mark.parametrize("hb,wb,seed", [(9, 20, 18), (27, 16, 19)], ids=["9x20", "27x16"])
def test_trunk3_fp32_tile_routes_match_jax(hb, wb, seed):
    from hdrtv_tpu.ops.megakernel import fused_trunk3 as jax_trunk3

    from hdrtv_tpu_torch.ops.megakernel import fused_trunk3_ref

    rng = np.random.RandomState(seed)
    cin, cc, co = 32, 16, 128

    def arr(*shape, scale):
        return (rng.randn(*shape) * scale).astype(f32)

    fea3 = (rng.rand(hb, wb, cin) - 0.2).astype(f32)
    cond4 = (rng.rand(hb, wb, cc) - 0.3).astype(f32)

    def sft():
        return [(arr(ci, co_, scale=0.2), arr(co_, scale=0.1)) for ci, co_ in ((cc, cc), (cc, cin), (cc, cc), (cc, cin))]

    blocks = [(sft(), arr(3, 3, cin, cin, scale=0.1), arr(cin, scale=0.1),
               sft(), arr(3, 3, cin, cin, scale=0.1), arr(cin, scale=0.1)) for _ in range(4)]
    w_up, b_up = arr(3, 3, cin, co, scale=0.1), arr(co, scale=0.1)

    def as_blocks(fn):
        return [([(fn(w), fn(b)) for w, b in s1], fn(w1), fn(b1), [(fn(w), fn(b)) for w, b in s2], fn(w2), fn(b2))
                for s1, w1, b1, s2, w2, b2 in blocks]

    tt = torch.from_numpy
    got = _trunk3_on_card_routes(tt(fea3), tt(cond4), as_blocks(tt), tt(w_up), tt(b_up))
    with pltpu.force_tpu_interpret_mode():
        want = jax_trunk3(jnp.asarray(fea3), jnp.asarray(cond4), as_blocks(jnp.asarray), jnp.asarray(w_up),
                          jnp.asarray(b_up))
    want = np.asarray(want, f32)
    assert got.shape == want.shape == (hb, wb, co)
    err = float(np.abs(got.numpy().astype(np.float64) - want).max())
    assert err <= ATOL, err
    # and as close to the port's plain version, which the card is held against
    plain = fused_trunk3_ref(tt(fea3), tt(cond4), as_blocks(tt), tt(w_up), tt(b_up))
    assert float((got - plain).abs().max()) <= ATOL
