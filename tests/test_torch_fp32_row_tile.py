"""Two redesigns for the card, on the CPU against their plain versions and
hdrtv_tpu:

- cond_chain's fp32 s2d form on the row tile's 3×TF32 instance
  (``csrc/chain_tf32x3.cuh``): its float step emulated in torch (the rna
  split to TF32, the three products summed per 32-channel chunk, the chunk
  sums added in fp32) against the plain s2d step and a float64 witness; the
  emulated chain, float and with int8 steps, against the Pallas kernel in
  interpret mode.
- colorimetric_pq_pack's design (``csrc/colorimetric.cu``), emulated in
  torch: the thresholds of the exact curve's codes (PQ in float64) found by
  bisection over the fp32 bit patterns, the bf16 gamma table, the value
  pq·65535 + 0.5 (atanh series in float64) and, near a code boundary, the
  threshold deciding: equal to the exact curve's codes and within 2 codes
  of the plain version over every bf16 value in [0, 1] on each channel and
  fp32 ramps across code thresholds, at two (peak_nits, gamma) pairs, also
  with the approximate powers' error magnified.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hdrtv_tpu_torch.models.s2d import b_s2d, w_s2d_1x1
from hdrtv_tpu_torch.ops.color import BT709_TO_BT2020, PQ_C1, PQ_C2, PQ_C3, PQ_M1, PQ_M2
from hdrtv_tpu_torch.ops.megakernel import (
    _rows_1x1, _rows_tf32x3, _tf32, cond_chain_tf32x3_emulation, fused_cond_chain, fused_cond_chain_ref,
)
from hdrtv_tpu_torch.ops.pack import COLOR_CODES, COLOR_GAMMA_ENTRIES, colorimetric_pq_pack_ref
from hdrtv_tpu_torch.ops.w8a8 import pack_qargs
from hdrtv_tpu_torch.quant.int8 import quantize_weight
from tests.test_torch_int8 import _both, _ulps
from tests.test_torch_int8_rest import _calib

f32 = np.float32
ATOL = 1e-4  # the fp32 chain's check on the card (chip_smoke.py ATOL)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# cond_chain fp32 s2d: the 3×TF32 row tile
# ---------------------------------------------------------------------------


def test_tf32_split_rounds_as_cvt_rna():
    """_tf32 rounds to 10 stored mantissa bits, ties away from zero, and big +
    small carries x to 2^-22 of its magnitude."""
    tie = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12, 3 * 2.0 ** -11 + 1], f32)
    got = _tf32(torch.from_numpy(tie)).numpy()
    assert got.tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 1 + 2.0 ** -9]
    x = torch.from_numpy((np.random.RandomState(1).randn(4096) * 10.0 ** np.random.RandomState(2).uniform(
        -6, 3, 4096)).astype(f32))
    big = _tf32(x)
    small = _tf32(x - big)
    assert torch.equal(big.view(torch.int32) & 0x1FFF, torch.zeros_like(big, dtype=torch.int32))
    rel = ((big.double() + small.double() - x.double()).abs() / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -22


@pytest.mark.parametrize("n", [64, 16])
def test_row_tile_f32_step_emulation(n):
    """One float step of the fp32 row tile (natural 64 → n, s2d weights): the
    emulated 3×TF32 step within ATOL of the plain s2d step, and as close to
    a float64 witness as the plain step is, with no drift of its mean; one
    TF32 product alone (the planted fault of chip_smoke.py) lies beyond
    ATOL."""
    rng = np.random.RandomState(11 + n)
    v = torch.from_numpy((rng.rand(6, 13, 256) * 1.3 - 0.3).astype(f32))
    w = torch.from_numpy(w_s2d_1x1(rng.randn(1, 1, 64, n).astype(f32) * 0.15)[0, 0])
    b = torch.from_numpy(b_s2d((rng.randn(n) * 0.1).astype(f32)))
    got = _rows_tf32x3(v, w, b)
    plain = _rows_1x1(v, w, b)
    witness = (v.double().reshape(-1, 64) @ w[:64, :n].double() + b[:n].double()).reshape(got.shape)
    assert got.shape == plain.shape == (6, 13, 4 * n)
    assert float((got - plain).abs().max()) < ATOL
    e_got, e_plain = (got.double() - witness), (plain.double() - witness)
    assert float(e_got.abs().max()) <= max(2 * float(e_plain.abs().max()), 2.0 ** -22)
    assert abs(float(e_got.mean())) <= 1e-8
    one = _rows_tf32x3(v, w, b, products=1)
    assert float((one - got).abs().max()) > ATOL


def _chain64(rng, flags, c0):
    """Five s2d 1×1 steps at the row tile's widths (natural 64 → 64 ×4 → 16),
    w_s2d_1x1 weights and b_s2d biases; int8 where ``flags`` is 1
    (symmetric) or 2 (zero point), calibrated on the float chain's value
    entering the step. Returns JAX's weights and qargs and the port's."""
    nat = [quantize_weight(rng.randn(1, 1, 64, co).astype(f32) * 0.15) for co in (64, 64, 64, 64, 16)]
    tq = [w_s2d_1x1(w) for w, _ in nat]
    tsc = [b_s2d(s) for _, s in nat]
    bs = [b_s2d((rng.randn(q.shape[-1] // 4) * 0.1).astype(f32)) for q in tq]
    wf = [(q[0, 0].astype(f32) * s).astype(f32) for q, s in zip(tq, tsc)]
    pairs = [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in zip(wf, bs)]
    v, ranges = c0.float(), []
    for i, (w, b) in enumerate(pairs):
        ranges.append((float(v.min()), float(v.max())))
        v = v @ w + b
        v = torch.where(v >= 0, v, v * 0.1) if i != 4 else v
    qj, qt = [], []
    for i, fl in enumerate(flags):
        if not fl:
            qj.append(None)
            qt.append(None)
            continue
        s, z = _calib(*ranges[i], fl == 2)
        d = {"w_int8": jnp.asarray(tq[i][0, 0]), "w_scale": jnp.asarray(tsc[i]), "x_scale": jnp.float32(s)}
        if z is not None:
            d["x_zero"] = jnp.float32(z)
        qj.append(d)
        qt.append(pack_qargs(tq[i], tsc[i], s, z, bs[i]))
    return [(jnp.asarray(w), jnp.asarray(b)) for w, b in zip(wf, bs)], qj, pairs, qt


@pytest.mark.parametrize("flags", [(0, 0, 0, 0, 0), (1, 0, 2, 0, 1), (0, 2, 2, 1, 0)],
                         ids=["float", "10201", "02210"])
def test_row_tile_f32_chain_matches_pallas(flags):
    """The fp32 row tile's chain, emulated, against the JAX kernel's dense
    chain on the same s2d weights in interpret mode: all float within ATOL;
    with int8 steps within test_cond_chain_s2d_int8_plain_matches_pallas's
    bounds (a float step's sum order may flip a code of a later int8 step:
    6 flipped codes, 2% of the outputs beyond two ulps). The plain s2d chain
    (what the card's check holds the kernel to) within the same bounds of
    the emulation."""
    from hdrtv_tpu.ops.megakernel import fused_cond_chain as jax_chain

    rng = np.random.RandomState(400 + 10 * flags[1] + flags[2])
    hb, wb = 16, 16
    xj, xt = _both(rng.rand(hb, wb, 256) * 1.2 - 0.2)
    wj, qj, pairs, qt = _chain64(rng, flags, xt)
    quant = any(flags)
    with pltpu.force_tpu_interpret_mode():
        want = jax_chain(xj, wj, qargs=qj if quant else None)
    got = cond_chain_tf32x3_emulation(xt, pairs, qt if quant else None)
    plain = fused_cond_chain(xt, pairs, qargs=qt if quant else None, s2d=True)
    assert all(torch.equal(a, b) for a, b in zip(plain, fused_cond_chain_ref(xt, pairs, qt, s2d=True)))
    assert [tuple(g.shape) for g in got] == [(hb, wb, 256), (hb, wb, 64)]
    for g, w_, p in zip(got, want, plain):
        g, w_, p = g.numpy(), np.asarray(w_), p.numpy()
        if not quant:
            assert float(np.abs(g - w_).max()) < ATOL and float(np.abs(g - p).max()) < ATOL
            continue
        last_q = max(i for i, q in enumerate(qt) if q is not None)
        flip = 127.0 * float(qt[last_q].yscale.max())
        for other in (w_, p):
            err = np.abs(g - other)
            exact = _ulps(other, 2)
            assert (err <= 6 * flip + exact).all(), float(err.max())
            assert float((err > exact).mean()) <= 0.02, float((err > exact).mean())


# ---------------------------------------------------------------------------
# colorimetric_pq_pack: thresholds, gamma table, corrected guess
# ---------------------------------------------------------------------------

_M = torch.from_numpy(BT709_TO_BT2020.astype(f32))


def _y(lin: torch.Tensor, peak_norm: float) -> torch.Tensor:
    """y = clip(lin2020·peak_nits / 10000, 0, 1), the product rounded to fp32."""
    return (lin.float() * torch.tensor(peak_norm, dtype=torch.float32)).clamp(0.0, 1.0)


def _pq_code(lin: torch.Tensor, peak_norm: float) -> torch.Tensor:
    """The code on the exact curve the thresholds are taken from
    (pq_code_exact: PQ in float64 of the fp32 y)."""
    ym = torch.pow(_y(lin, peak_norm).double(), PQ_M1)
    pq = torch.pow((PQ_C1 + PQ_C2 * ym) / (1.0 + PQ_C3 * ym), PQ_M2)
    return torch.floor(pq * 65535.0 + 0.5).to(torch.int32)


def _thresholds(peak_nits: float) -> torch.Tensor:
    """thr[k], 1 ≤ k < 65536: the least non-negative fp32 with code ≥ k, by
    bisection over the bit patterns 0 .. +inf (colorimetric_tables_kernel);
    thr[0] = −inf, thr[65536] = +inf."""
    k = torch.arange(1, COLOR_CODES, dtype=torch.int32)
    lo = torch.zeros_like(k, dtype=torch.int64)
    hi = torch.full_like(lo, 0x7F800000)
    while bool((hi - lo > 1).any()):
        mid = lo + (hi - lo) // 2
        up = _pq_code(mid.to(torch.int32).view(torch.float32), peak_nits / 10000.0) >= k
        hi, lo = torch.where(up, mid, hi), torch.where(up, lo, mid)
    thr = hi.to(torch.int32).view(torch.float32)
    return torch.cat([torch.tensor([-float("inf")]), thr, torch.tensor([float("inf")])])


def _gamma_table(gamma: float) -> torch.Tensor:
    """powf of the bf16 values in [0, 1] by their bit patterns 0 .. 0x3F80."""
    u = torch.arange(COLOR_GAMMA_ENTRIES, dtype=torch.int32) << 16
    return torch.pow(u.view(torch.float32), gamma)


MARGIN = 0.125  # csrc/colorimetric.cu kColorMargin


def _pq_value(y: torch.Tensor, ym_scale: float = 1.0) -> torch.Tensor:
    """pq_value: ym in fp32 (times ``ym_scale``: the approximate power's
    error), w and 2·atanh(w) in float64, 2^n · 2^f with f in fp32, then
    ·65535 + 0.5 in fp32."""
    ym = (torch.exp2(PQ_M1 * torch.log2(y)) * ym_scale).double()
    w = ((PQ_C1 - 1.0) + (PQ_C2 - PQ_C3) * ym) / ((PQ_C1 + 1.0) + (PQ_C2 + PQ_C3) * ym)
    w2 = w * w
    ath = w * (1 + w2 * (1 / 3 + w2 * (1 / 5 + w2 * (1 / 7 + w2 * (1 / 9 + w2 / 11)))))
    e = 2.0 / np.log(2.0) * PQ_M2 * ath
    n = torch.round(e)
    pq = torch.exp2((e - n).float()) * torch.exp2(n).float()
    return pq * 65535.0 + 0.5


def _codes(l2020: torch.Tensor, peak_nits: float, thr: torch.Tensor, ym_scale: float = 1.0) -> torch.Tensor:
    """color_values' code of each lin2020: the floor of pq_value, or near a
    boundary (within MARGIN) the side of its threshold."""
    pv = _pq_value(_y(l2020, peak_nits / 10000.0), ym_scale)
    c = torch.floor(pv).clamp(max=COLOR_CODES - 1).long()
    f = pv - c.float()
    low, high = f < MARGIN, f > 1.0 - MARGIN
    c = c - (low & (l2020 < thr[c])).long() + (high & (l2020 >= thr[c + 1])).long()
    return c.to(torch.int32)


def _lin2020(x: torch.Tensor, gamma: float, gam, lin_scale: float = 1.0) -> torch.Tensor:
    """The gamma from the table (bf16) or a power (fp32, times ``lin_scale``:
    the approximate power's error), then the matrix."""
    v = x.float().clamp(0.0, 1.0)
    if x.dtype == torch.bfloat16:
        lin = torch.where(v > 0, gam[(v.view(torch.int32) >> 16).clamp(0, COLOR_GAMMA_ENTRIES - 1).long()], 0.0)
    else:
        lin = torch.exp2(gamma * torch.log2(v)) * lin_scale
    return lin[..., 0:1] * _M[:, 0] + lin[..., 1:2] * _M[:, 1] + lin[..., 2:3] * _M[:, 2]


def _check_design(l2020: torch.Tensor, peak_nits: float, thr: torch.Tensor) -> torch.Tensor:
    """The design's codes equal the exact curve's (the thresholds decide near
    a boundary, the floor elsewhere: pq_value lies within MARGIN / 4 of the
    exact value), also with ym off by ±2^-20 (many times the approximate
    instructions' error); returns the codes."""
    got = _codes(l2020, peak_nits, thr)
    exact = _pq_code(l2020, peak_nits / 10000.0)
    assert torch.equal(got, exact)
    y = _y(l2020, peak_nits / 10000.0).double()
    ym = torch.pow(y, PQ_M1)
    real = torch.pow((PQ_C1 + PQ_C2 * ym) / (1.0 + PQ_C3 * ym), PQ_M2) * 65535.0 + 0.5
    assert float((_pq_value(y.float()).double() - real).abs().max()) < MARGIN / 4
    for scale in (1 + 2.0 ** -20, 1 - 2.0 ** -20):
        assert torch.equal(_codes(l2020, peak_nits, thr, ym_scale=scale), exact)
    return got


PARAMS = [(1000.0, 2.4), (600.0, 2.2)]


@pytest.fixture(scope="module")
def tables():
    return {p: (_thresholds(p[0]), _gamma_table(p[1])) for p in PARAMS}


@pytest.mark.parametrize("params", PARAMS, ids=["1000-2.4", "600-2.2"])
def test_colorimetric_thresholds(tables, params):
    """The thresholds rise with k, thr[0] = −inf and thr[65536] = +inf, and
    each is the first fp32 at its code: its code is ≥ k and the float just
    below it codes < k; SDR white's BT.2020 rows land on their codes."""
    thr, _ = tables[params]
    peak_norm = params[0] / 10000.0
    assert thr.shape == (COLOR_CODES + 1,) and float(thr[0]) == -float("inf") and float(thr[-1]) == float("inf")
    assert bool((thr[2:-1] >= thr[1:-2]).all()) and bool(torch.isfinite(thr[1:-1]).all())
    k = torch.arange(1, COLOR_CODES, 97)
    at = thr[k]
    below = (at.view(torch.int32) - 1).view(torch.float32)
    assert bool((_pq_code(at, peak_norm) >= k).all()) and bool((_pq_code(below, peak_norm) < k).all())
    lin = torch.ones(3) @ _M.T
    codes = torch.searchsorted(thr, lin, right=True) - 1
    assert torch.equal(codes.to(torch.int32), _pq_code(lin, peak_norm))


@pytest.mark.parametrize("params", PARAMS, ids=["1000-2.4", "600-2.2"])
def test_colorimetric_bf16_sweep_emulation(tables, params):
    """Every bf16 value in [0, 1] on each channel (the other two a fixed
    draw), and gray: the design's codes are the exact curve's and within 2
    codes of the plain version (1 seen), equal at 0 and 1; its gamma table is
    the plain version's power."""
    thr, gam = tables[params]
    u = torch.arange(COLOR_GAMMA_ENTRIES, dtype=torch.int32) << 16
    sweep = u.view(torch.float32)
    rest = torch.from_numpy(np.random.RandomState(5).rand(COLOR_GAMMA_ENTRIES, 3).astype(f32))
    rows = [sweep[:, None].expand(-1, 3)]
    for c in range(3):
        x = rest.clone()
        x[:, c] = sweep
        rows.append(x)
    x = torch.cat(rows).to(torch.bfloat16)
    x[:2] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]])
    got = _check_design(_lin2020(x, params[1], gam), params[0], thr)
    want = colorimetric_pq_pack_ref(x, peak_nits=params[0], gamma=params[1]).to(torch.int32)
    assert int((got - want).abs().max()) <= 2
    assert torch.equal(got[:2], want[:2]) and got[0].tolist() == [0, 0, 0]
    assert torch.equal(gam, torch.pow(sweep, params[1]))


@pytest.mark.parametrize("params", PARAMS, ids=["1000-2.4", "600-2.2"])
def test_colorimetric_f32_ramp_emulation(tables, params):
    """fp32 grays whose BT.2020 value lands on either side of every 5th code
    threshold (a few floats apart), and a fine ramp over [0, 1]: the design's
    codes are the exact curve's and within 2 codes of the plain version, with
    the power exact and with it off by ±2^-20 relative (many times the
    approximate instructions' error)."""
    thr, gam = tables[params]
    rowsum = float(_M.sum(dim=1).max())
    k = torch.arange(1, COLOR_CODES, 5)
    x0 = torch.pow(thr[k].double() / rowsum, 1.0 / params[1]).float()
    bits = x0.view(torch.int32)
    near = torch.cat([(bits + d).view(torch.float32) for d in (-3, -1, 0, 1, 3)])
    ramp = torch.linspace(0.0, 1.0, 1 << 16)
    g = torch.cat([near, ramp]).clamp(0.0, 1.0)
    x = torch.stack([g, g, g], dim=-1)
    x[:2] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]])
    want = colorimetric_pq_pack_ref(x, peak_nits=params[0], gamma=params[1]).to(torch.int32)
    for scale in (1.0, 1 + 2.0 ** -20, 1 - 2.0 ** -20):
        got = _check_design(_lin2020(x, params[1], gam, lin_scale=scale), params[0], thr)
        assert int((got - want).abs().max()) <= 2, scale
        assert got[0].tolist() == [0, 0, 0]
        if scale == 1.0:
            assert torch.equal(got[:2], want[:2])
