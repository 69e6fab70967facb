"""The two forms that run on the Hopper tiles with their structural skip
declared, on the CPU against hdrtv_tpu: block_conv3's ``pool_out`` with
``a_sub`` = 1 (the Hopper, 3×TF32 and wgmma s8 tiles' pooled epilogues) and
cond_chain's int8 steps with ``s2d=True`` (the row tile's int8 instance).

- The port's plain versions at these declarations against the Pallas kernels
  in interpret mode, on s2d weights (PS-folded ``w_s2d_s1`` for the pooled
  conv, ``w_s2d_1x1`` for the chain), with the tolerances of
  ``tests/test_torch_int8_rest.py``.
- Emulations of what the tiles compute, in torch: the int8 pooled conv
  walking the slot table the pooled call hands the s8 tile, and the row
  tile's int8 step reading its operands through the byte layouts and
  swizzles the kernel writes (the int8 block at the top left of the QArgs
  codes, the codes quantized in registers), each equal to the plain version
  bit for bit; the bf16 pooled epilogue's exchange of a rounded row.
- The wrapper's refusals on the CPU: a pooled ``a_sub`` shape that the tile
  refuses, and odd dims.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hdrtv_tpu_torch.models.s2d import b_s2d, w_ps_permute, w_s2d_1x1, w_s2d_s1_ps
from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3, fused_block_conv3_q_ref, s8_sm90_table
from hdrtv_tpu_torch.ops.megakernel import _rows_q, fused_cond_chain, fused_cond_chain_ref
from hdrtv_tpu_torch.ops.w8a8 import _dense_q, _quantize_act, _tap_views_q, pack_qargs
from hdrtv_tpu_torch.quant.int8 import quantize_weight
from tests.test_torch_int8 import _both, _ulps
from tests.test_torch_int8_rest import _calib, _close, _step

f32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU programs on one intra-op thread: the suite runs in several
    worker processes at once, and torch's thread pools, one a core in each,
    slow every one of them down many times over when they share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ps_layer(rng, c, co, asym, t_range=(-0.1, 1.1)):
    """A PS-folded s2d int8 conv layer, C → Co (Co/4 natural channels per
    sub-position, as up_conv3's): the float weight, its int8 codes and scales
    (HWIO), a bias, and the activation scale and zero calibrated on
    ``t_range``."""
    wq, ws = quantize_weight(rng.randn(3, 3, c // 4, co // 4).astype(f32) * 0.05)
    tq, tsc = w_s2d_s1_ps(wq), np.tile(w_ps_permute(ws.reshape(1, 1, 1, -1))[0, 0, 0], 4)
    b = (rng.randn(co) * 0.1).astype(f32)
    s, z = _calib(*t_range, asym)
    return (tq.astype(f32) * tsc).astype(f32), tq, tsc, b, s, z


# ---------------------------------------------------------------------------
# block_conv3 pool_out with a_sub = 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["f32", "bf16", "skip_f32", "int8_f32", "int8_bf16", "int8_zero_f32"])
def test_pool_out_a_sub_plain_matches_pallas(form):
    """The pooled conv on a PS-folded s2d weight (C = 128 → Co = 512, the L1
    up_conv3 widths, at which the Pallas kernel's a_sub is live), a_sub = 1
    in both: float within 3e-5 in fp32 (the JAX package's own bound) and
    one step in bf16; int8 (symmetric, or with a zero point and the Pallas
    wrapper's fp32 fold of its term into the bias) within one fp32 ulp of
    the epilogue or one bf16 step, the codes being the same. The pooled call
    equals the pool of the unpooled one, rounded once."""
    from hdrtv_tpu.ops.conv_kernels import fused_block_conv3 as jax_conv
    from hdrtv_tpu.ops.megakernel import _pack_qargs

    dtype = "bf16" if form.endswith("bf16") else "f32"
    rng = np.random.RandomState(260 + len(form))
    hb, wb, c, co = 16, 16, 128, 512
    xj, xt = _both(rng.rand(hb, wb, c) * 1.2 - 0.1, dtype)
    wf, tq, tsc, b, s, z = _ps_layer(rng, c, co, form == "int8_zero_f32")
    sj, st = _both(rng.rand(hb, wb, co) - 0.5, dtype) if form == "skip_f32" else (None, None)
    qj = qt = None
    if form.startswith("int8"):
        qj = {"w_int8": jnp.asarray(tq), "w_scale": jnp.asarray(tsc), "x_scale": jnp.float32(s)}
        if z is not None:
            qj["x_zero"] = jnp.float32(z)
        b_corr = np.asarray(_pack_qargs(qj, co)[-1])
        qt = dataclasses.replace(pack_qargs(tq, tsc, s, z, b), bias=torch.from_numpy((b + b_corr).astype(f32)))
    wj, wt = jnp.asarray(wf).astype(xj.dtype), torch.from_numpy(wf).to(xt.dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_conv(xj, wj, jnp.asarray(b), relu=True, skip=sj, pool_out=True, a_sub=1, qargs=qj)
    got = fused_block_conv3(xt, wt, torch.from_numpy(b), relu=True, skip=st, qargs=qt, pool_out=True, a_sub=1)
    assert got.shape == (hb // 2, wb // 2, co) and got.dtype == xt.dtype
    full = fused_block_conv3(xt, wt, torch.from_numpy(b), relu=True, skip=st, qargs=qt, a_sub=1)
    assert torch.equal(got, full.reshape(hb // 2, 2, wb // 2, 2, co).amax(dim=(1, 3)))
    if form in ("f32", "skip_f32"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)
    elif form == "bf16":
        err = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
        assert (err <= _step(np.asarray(want.astype(jnp.float32)))).all()
    else:
        _close(got, want, dtype)


def _s8_pool_emulation(x, qa, table, per_list, *, relu, skip):
    """The int8 pooled conv as the wgmma s8 tile computes it: x's codes (the
    pad code outside the image), for each output sub-position so only the
    chunks (tap, c0) of list so of the table, summed in int32 (every 32-code
    chunk a k32 product), then per channel float(acc)·yscale, + bias, + skip,
    the activation, the 2×2 max of the four conv pixels in fp32 and one
    rounding."""
    hb, wb, c = x.shape
    co = qa.co
    co_nat = co // 4  # a_sub = 1: output sub-position so owns channels [so·co_nat, (so + 1)·co_nat)
    views = [v.reshape(hb * wb, c).long() for v in _tap_views_q(_quantize_act(x.float(), qa), qa.pad)]
    w9 = qa.w.reshape(co, 9, c).long()
    acc = torch.zeros(hb * wb, co, dtype=torch.long)
    for so in range(4):
        cols = slice(so * co_nat, (so + 1) * co_nat)
        for e in table[so * per_list:(so + 1) * per_list]:
            tap, c0 = e & 15, e >> 4
            acc[:, cols] += views[tap][:, c0:c0 + 32] @ w9[cols, tap, c0:c0 + 32].T
    assert int(acc.abs().max()) < 2 ** 31
    y = acc.int().float() * qa.yscale + qa.bias
    if skip is not None:
        y = y + skip.float().reshape(hb * wb, co)
    if relu:
        y = torch.clamp_min(y, 0.0)
    y = y.reshape(hb // 2, 2, wb // 2, 2, co)
    return torch.maximum(torch.maximum(y[:, 0, :, 0], y[:, 0, :, 1]),
                         torch.maximum(y[:, 1, :, 0], y[:, 1, :, 1])).to(x.dtype)


@pytest.mark.parametrize("dtype,asym,skip", [("f32", False, True), ("bf16", True, False)])
def test_pool_out_s8_table_walk_matches_plain(dtype, asym, skip):
    """The table a pooled int8 call hands the s8 tile (s8_sm90_table, the
    unpooled call's): each output sub-position's 9 chunks of the PS-folded
    weight's slots, summed in int32, pooled in the epilogue, equal to the
    plain pooled version bit for bit (a skipped product is a zero code)."""
    rng = np.random.RandomState(11 + asym)
    hb, wb, c, co = 6, 10, 128, 512
    wf, tq, tsc, b, s, z = _ps_layer(rng, c, co, asym)
    qa = pack_qargs(tq, tsc, s, z, b)
    x = torch.from_numpy((rng.rand(hb, wb, c) * 1.2 - 0.1).astype(f32)).to(torch.bfloat16 if dtype == "bf16" else
                                                                          torch.float32)
    sk = torch.from_numpy((rng.rand(hb, wb, co) - 0.5).astype(f32)).to(x.dtype) if skip else None
    table, per_list = s8_sm90_table("block_conv3", 1, c, co)
    assert per_list == 9 and len(table) == 36
    got = _s8_pool_emulation(x, qa, list(table), per_list, relu=True, skip=sk)
    want = fused_block_conv3_q_ref(x, qa, relu=True, skip=sk, pool_out=True)
    assert torch.equal(got, want)
    assert torch.equal(fused_block_conv3(x, torch.from_numpy(wf).to(x.dtype), torch.from_numpy(b), relu=True,
                                         skip=sk, qargs=qa, pool_out=True, a_sub=1), want)


def test_pool_epilogue_exchange_rounds_once():
    """The bf16 tiles' pooled epilogue: lanes l and l ^ 4 leave the larger
    column in fp32, the two warpgroups' rows meet with one of them already
    rounded to bf16, and the max is rounded: the same bits as one rounding
    of the max of the four (rounding is monotonic), ties and negative values
    (no activation) included."""
    rng = np.random.RandomState(5)
    v = torch.from_numpy(rng.randn(64, 2, 64, 2, 32).astype(f32))
    v[::3] = v[::3].to(torch.bfloat16).float()  # exact bf16 values: ties between rows
    cols = v.amax(dim=3)
    row0, row1 = cols[:, 0], cols[:, 1].to(torch.bfloat16).float()
    got = torch.maximum(row0, row1).to(torch.bfloat16)
    want = v.amax(dim=(1, 3)).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_pool_out_a_sub_refusals():
    """A pooled a_sub call takes its tile's shapes on the CPU as on the card:
    the wgmma s8 tile's C = 128 (int8), the Hopper tile's C/4 a multiple of
    32 (bf16), the 3×TF32 tile's resident weights (fp32, C ≤ 256); even
    dims for any pool. The unpooled call at the same shapes runs its plain
    version on the CPU."""
    rng = np.random.RandomState(3)
    z8 = np.zeros((3, 3, 256, 128), np.int8)
    qa = pack_qargs(z8, np.ones(128, f32), 0.01, None, np.zeros(128, f32))
    x = torch.zeros(8, 8, 256)
    with pytest.raises(ValueError, match="wgmma s8 tile takes"):
        fused_block_conv3(x, torch.zeros(3, 3, 256, 128), torch.zeros(128), qargs=qa, pool_out=True, a_sub=1)
    with pytest.raises(ValueError, match="Hopper tile takes"):
        fused_block_conv3(torch.zeros(8, 8, 64, dtype=torch.bfloat16), torch.zeros(3, 3, 64, 128,
                          dtype=torch.bfloat16), torch.zeros(128), pool_out=True, a_sub=1)
    with pytest.raises(ValueError, match="3×TF32"):
        fused_block_conv3(torch.zeros(8, 8, 512), torch.zeros(3, 3, 512, 128), torch.zeros(128), pool_out=True,
                          a_sub=1)
    with pytest.raises(ValueError, match="even"):
        fused_block_conv3(torch.zeros(7, 8, 128), torch.zeros(3, 3, 128, 128), torch.zeros(128), pool_out=True,
                          a_sub=1)
    xr = torch.from_numpy(rng.rand(8, 8, 256).astype(f32))
    y = fused_block_conv3(xr, torch.zeros(3, 3, 256, 128), torch.zeros(128), qargs=qa, a_sub=1)
    assert y.shape == (8, 8, 128)


# ---------------------------------------------------------------------------
# cond_chain's int8 steps with s2d=True
# ---------------------------------------------------------------------------


def _chain(rng, flags, dtype, c0):
    """Five s2d 1×1 steps (natural 32 → 32 ×4 → 8) as the model has them
    (w_s2d_1x1 weights, b_s2d biases), int8
    where ``flags`` is 1 (symmetric) or 2 (zero point), each calibrated on
    the float chain's value entering it; JAX's dicts with its own fp32 fold
    of the zero-point term, and the port's QArgs carrying that bias."""
    widths = [(32, 32), (32, 32), (32, 32), (32, 32), (32, 8)]
    nat = [quantize_weight(rng.randn(1, 1, ci, co).astype(f32) * 0.25) for ci, co in widths]
    tq = [w_s2d_1x1(w) for w, _ in nat]
    tsc = [b_s2d(s) for _, s in nat]
    bs = [b_s2d((rng.randn(co) * 0.1).astype(f32)) for _, co in widths]
    wf = [(q[0, 0].astype(f32) * s).astype(f32) for q, s in zip(tq, tsc)]
    pairs = [(torch.from_numpy(w).to(c0.dtype), torch.from_numpy(b)) for w, b in zip(wf, bs)]
    v, ranges = c0.float(), []
    for i, (w, b) in enumerate(pairs):
        ranges.append((float(v.min()), float(v.max())))
        v = v @ w.float() + b
        v = torch.where(v >= 0, v, v * 0.1) if i != 4 else v
    qj, qt = [], []
    for i, fl in enumerate(flags):
        if not fl:
            qj.append(None)
            qt.append(None)
            continue
        s, z = _calib(*ranges[i], fl == 2)
        d = {"w_int8": jnp.asarray(tq[i][0, 0]), "w_scale": jnp.asarray(tsc[i]), "x_scale": jnp.float32(s)}
        bj = jnp.asarray(bs[i])
        if z is not None:
            d["x_zero"] = jnp.float32(z)
            wsum = (jnp.asarray(tq[i][0, 0]).astype(jnp.float32) * jnp.asarray(tsc[i])).sum(axis=0)
            bj = bj + (jnp.float32(z) + 128.0 * jnp.float32(s)) * wsum
        qj.append(d)
        qt.append(dataclasses.replace(pack_qargs(tq[i], tsc[i], s, z, bs[i]), bias=torch.from_numpy(np.array(bj))))
    return wf, bs, pairs, qj, qt


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("flags", [(1, 0, 2, 0, 1), (0, 2, 2, 1, 0)], ids=["10201", "02210"])
def test_cond_chain_s2d_int8_plain_matches_pallas(dtype, flags):
    """The port's plain s2d chain (each step the first diagonal block: float
    in rows of natural pixels, int8 as exact int32 sums of the block's
    codes) against the JAX kernel's dense chain on the same s2d weights:
    the skipped products are zero codes, so only the float steps' sum order
    and XLA's FMA in the int8 epilogue move the value, which may flip a code
    of a later int8 step; bounds as tests/test_torch_int8_rest.py's dense
    case (6 flipped codes, 2% of the outputs beyond the rounding)."""
    from hdrtv_tpu.ops.megakernel import fused_cond_chain as jax_chain

    rng = np.random.RandomState(300 + 10 * flags[1] + flags[2])
    hb, wb = 16, 16
    xj, xt = _both(rng.rand(hb, wb, 128) * 1.2 - 0.2, dtype)
    wf, bs, pairs, qj, qt = _chain(rng, flags, dtype, xt)
    with pltpu.force_tpu_interpret_mode():
        want = jax_chain(xj, [(jnp.asarray(w).astype(xj.dtype), jnp.asarray(b)) for w, b in zip(wf, bs)], qargs=qj)
    got = fused_cond_chain(xt, pairs, qargs=qt, s2d=True)
    assert [tuple(g.shape) for g in got] == [(hb, wb, 128), (hb, wb, 32)]
    assert all(torch.equal(a, b) for a, b in zip(got, fused_cond_chain_ref(xt, pairs, qt, s2d=True)))
    last_q = max(i for i, q in enumerate(qt) if q is not None)
    flip = 127.0 * float(qt[last_q].yscale.max())
    for g, w_ in zip(got, want):
        g, w_ = g.float().numpy(), np.asarray(w_.astype(jnp.float32))
        err = np.abs(g - w_)
        exact = _ulps(w_, 2) if dtype == "f32" else _step(w_)
        assert (err <= 6 * flip + _step(w_) * (dtype == "bf16") + exact).all(), float(err.max())
        assert float((err > exact).mean()) <= 0.02, float((err > exact).mean())


def _swizzle(addr: torch.Tensor, span: int) -> torch.Tensor:
    """Hopper's shared-memory swizzle of a span of 32, 64 or 128 bytes: the
    16-byte piece of byte ``addr`` XORed with address bits 7 and up (1, 2
    or 3 of them), as TMA writes and wgmma's descriptors read."""
    bits = {32: 1, 64: 3, 128: 7}[span]
    return addr ^ (((addr >> 7) & bits) << 4)


def _tile_int8_step(v, qa, rows: int = 64):
    """One int8 step of the row tile (csrc/chain_sm90.cuh), emulated byte for
    byte on the rows of natural pixels: the codes quantized from fp32 ``v``
    written into a code tile of 64-byte rows at put_codes' addresses; the int8
    block read at the top left of the QArgs codes with row pitch 4·K and
    staged at stage_b_s8's addresses; both read back as wgmma reads its
    K-major operands (64- and 32-byte swizzles); each k32 slice an exact
    int32 product; float(acc)·yscale, + bias (the first N of each)."""
    k, n = qa.c // 4, qa.co // 4
    codes = _quantize_act(v, qa).reshape(-1, k)
    flat_w = qa.w.reshape(-1)
    r = torch.arange(rows)[:, None]
    c = torch.arange(k)[None, :]
    put = r * 64 + ((((c >> 4) ^ ((r >> 1) & 3))) << 4) + (c & 15)  # put_codes
    nn = torch.arange(n)[:, None]
    kk, byte = c // 32, c % 32
    stage = kk * n * 32 + nn * 32 + ((((byte >> 4) ^ (nn >> 2)) & 1) << 4) + (byte & 15)  # stage_b_s8
    wsm = torch.zeros(n * k, dtype=torch.int8)
    wsm[stage.reshape(-1)] = flat_w[(nn * qa.c + c).reshape(-1)]  # the block, row pitch 4·K
    b_read = wsm[_swizzle(kk * n * 32 + nn * 32 + byte, 32).reshape(-1)].reshape(n, k).long()
    out = []
    for r0 in range(0, codes.shape[0], rows):
        tile = torch.zeros(rows, k, dtype=torch.int8)
        part = codes[r0:r0 + rows]
        tile[: part.shape[0]] = part
        csm = torch.zeros(rows * 64, dtype=torch.int8)
        csm[put.reshape(-1)] = tile.reshape(-1)
        a_read = csm[_swizzle(r * 64 + c, 64).reshape(-1)].reshape(rows, k).long()
        acc = sum(a_read[:, s * 32:(s + 1) * 32] @ b_read[:, s * 32:(s + 1) * 32].T for s in range(k // 32))
        out.append(acc[: part.shape[0]])
    acc = torch.cat(out)
    assert int(acc.abs().max()) < 2 ** 31
    return (acc.int().float() * qa.yscale[:n] + qa.bias[:n]).reshape(*v.shape[:-1], 4 * n), acc


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "zero"])
def test_row_tile_int8_step_emulation(asym):
    """The row tile's int8 step (natural 64 → 64 and 64 → 16, the widths it
    is built for) through its operands' byte layouts: equal to the plain s2d
    step (_rows_q) bit for bit, its int32 sums to the dense step's exact sums
    (the other blocks are zero codes), and the dense step's output too."""
    rng = np.random.RandomState(7 + asym)
    v = torch.from_numpy((rng.randn(5, 13, 256) * 0.8).astype(f32))
    for n in (64, 16):
        wq, ws = quantize_weight(rng.randn(1, 1, 64, n).astype(f32) * 0.2)
        s, z = _calib(float(v.min()), float(v.max()), asym)
        qa = pack_qargs(w_s2d_1x1(wq), b_s2d(ws), s, z, np.tile((rng.randn(n) * 0.1).astype(f32), 4))
        got, acc = _tile_int8_step(v, qa)
        assert torch.equal(got, _rows_q(v, qa))
        # the dense sums of an s2d pixel's 4·n channels are its four rows' sums
        dense_acc = _quantize_act(v, qa).reshape(-1, 256).double() @ qa.w.double().T
        assert torch.equal(acc.double(), dense_acc.reshape(-1, n))
        assert torch.equal(got, _dense_q(v, qa))
