"""hdrtv_tpu_torch kernel modules on the CPU: each wrapper's plain version
(what it runs for a CPU tensor) against the JAX Pallas kernel in interpret
mode, on the same numpy inputs. In fp32 with the JAX tests' tolerances; in
bf16 within one bf16 step of the result: both sum the same exact products in
fp32, in another order, and round at the same places, so they differ only
where a rounding flips (``_assert_bf16_close``). The CUDA kernels themselves
are held against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hdrtv_tpu.models.s2d import w_s2d_s1, w_s2d_s2
from hdrtv_tpu_torch.ops import native

f32 = np.float32


def _both(a, dtype="f32"):
    """One numpy array as a JAX and a torch array; ``bf16`` rounds it once
    (the same round-to-nearest-even in both), so both sides hold equal values."""
    a = np.ascontiguousarray(a, f32)
    j, t = jnp.asarray(a), torch.from_numpy(a.copy())
    if dtype == "bf16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _assert_bf16_close(got: torch.Tensor, want, *, steps: int = 1, flips: float = 0.005):
    """bf16 results within ``steps`` bf16 steps of each other (a step is
    2^-8 relative to the larger power of two, so ``2^-7·max(1, |y|)`` bounds
    it), and equal but for a small share of flipped roundings (the single-conv
    kernels show at most 2e-3 of their elements flipped on these inputs)."""
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    assert g.shape == w.shape
    err = np.abs(g - w)
    assert (err <= steps * 2.0 ** -7 * np.maximum(1.0, np.abs(w))).all(), float(err.max())
    assert float((err > 0).mean()) <= flips, float((err > 0).mean())


def _sft4(rng, cc, c, dtype="f32", scale=0.05):
    """Four SFT (w, b) pairs for both sides; weights in ``dtype``, biases fp32."""
    pairs = [(_both(rng.randn(ci, co) * scale, dtype), _both(rng.randn(co) * 0.1))
             for ci, co in ((cc, cc), (cc, c), (cc, cc), (cc, c))]
    return [(w[0], b[0]) for w, b in pairs], [(w[1], b[1]) for w, b in pairs]


@pytest.mark.parametrize("c,co,relu,skip,transformed,port_a_sub", [
    (128, 128, True, False, False, 0),
    (128, 128, False, True, False, 0),
    (128, 512, True, False, True, 0),
    (128, 512, False, True, True, 1),
], ids=["relu", "skip", "co512-a_sub", "co512-a_sub-port"])
def test_block_conv3_plain_matches_pallas(c, co, relu, skip, transformed, port_a_sub):
    from hdrtv_tpu.ops.conv_kernels import fused_block_conv3 as jax_conv
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3

    rng = np.random.RandomState(co + relu)
    hb, wb = 16, 16
    xj, xt = _both(rng.rand(hb, wb, c))
    if transformed:
        w = w_s2d_s1(rng.randn(3, 3, c // 4, co // 4).astype(f32) * 0.05)
    else:
        w = rng.randn(3, 3, c, co).astype(f32) * 0.05
    wj, wt = _both(w)
    bj, bt = _both(rng.randn(co) * 0.1)
    sj, st = _both(rng.rand(hb, wb, co)) if skip else (None, None)
    with pltpu.force_tpu_interpret_mode():
        want = jax_conv(xj, wj, bj, relu=relu, skip=sj, a_sub=1 if transformed else 0)
    got = fused_block_conv3(xt, wt, bt, relu=relu, skip=st, a_sub=port_a_sub)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, f32), atol=3e-5)


@pytest.mark.parametrize("hb,wb,c,co,act,a_sub", [
    (24, 32, 128, 128, None, 1),
    (24, 32, 128, 128, "relu", 1),
    (24, 32, 128, 128, "lrelu", 1),
    (20, 16, 256, 768, "lrelu", 3),
])
def test_down2_plain_matches_pallas(hb, wb, c, co, act, a_sub):
    from hdrtv_tpu.ops.megakernel import fused_down2 as jax_down2
    from hdrtv_tpu_torch.ops.megakernel import fused_down2

    rng = np.random.RandomState(hb + co)
    xj, xt = _both(rng.rand(hb, wb, c))
    per = co // a_sub
    w = np.concatenate(
        [w_s2d_s2(rng.randn(3, 3, c // 4, per // 4).astype(f32) * 0.05) for _ in range(a_sub)], axis=-1
    )
    wj, wt = _both(w)
    bj, bt = _both(rng.randn(co) * 0.1)
    with pltpu.force_tpu_interpret_mode():
        want = jax_down2(xj, wj, bj, act=act, a_sub=a_sub)
    got = fused_down2(xt, wt, bt, act=act)
    assert got.shape == (hb // 2, wb // 2, co)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, f32), atol=3e-5)


@pytest.mark.parametrize("ch0", [256, 512])
def test_down2_channel_window_matches_pallas(ch0):
    from hdrtv_tpu.ops.megakernel import fused_down2 as jax_down2
    from hdrtv_tpu_torch.ops.megakernel import fused_down2

    rng = np.random.RandomState(ch0)
    hb, wb, cin, co = 16, 16, 256, 256
    xj, xt = _both(rng.rand(hb, wb, 3 * cin))
    wj, wt = _both(w_s2d_s2(rng.randn(3, 3, cin // 4, co // 4).astype(f32) * 0.05))
    bj, bt = _both(rng.randn(co) * 0.1)
    with pltpu.force_tpu_interpret_mode():
        want = jax_down2(xj, wj, bj, act="lrelu", cin=cin, ch0=ch0)
    got = fused_down2(xt, wt, bt, act="lrelu", cin=cin, ch0=ch0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, f32), atol=3e-5)


def test_trunk3_plain_matches_pallas():
    from hdrtv_tpu.ops.megakernel import fused_trunk3 as jax_trunk3
    from hdrtv_tpu_torch.ops.megakernel import fused_trunk3

    rng = np.random.RandomState(18)
    hb, wb, cin, cc4, co = 27, 16, 32, 16, 128
    fj, ft = _both(rng.rand(hb, wb, cin) - 0.2)
    cj, ct = _both(rng.rand(hb, wb, cc4) - 0.3)

    def pair(ci, co_):
        (wj, wt), (bj, bt) = _both(rng.randn(ci, co_) * 0.2), _both(rng.randn(co_) * 0.1)
        return (wj, bj), (wt, bt)

    def sft():
        pairs = [pair(cc4, cc4), pair(cc4, cin), pair(cc4, cc4), pair(cc4, cin)]
        return [p[0] for p in pairs], [p[1] for p in pairs]

    jblocks, tblocks = [], []
    for _ in range(4):
        s1j, s1t = sft()
        s2j, s2t = sft()
        w1j, w1t = _both(rng.randn(3, 3, cin, cin) * 0.1)
        b1j, b1t = _both(rng.randn(cin) * 0.1)
        w2j, w2t = _both(rng.randn(3, 3, cin, cin) * 0.1)
        b2j, b2t = _both(rng.randn(cin) * 0.1)
        jblocks.append((s1j, w1j, b1j, s2j, w2j, b2j))
        tblocks.append((s1t, w1t, b1t, s2t, w2t, b2t))
    wuj, wut = _both(rng.randn(3, 3, cin, co) * 0.1)
    buj, but = _both(rng.randn(co) * 0.1)
    with pltpu.force_tpu_interpret_mode():
        want = jax_trunk3(fj, cj, jblocks, wuj, buj)
    got = fused_trunk3(ft, ct, tblocks, wut, but)
    assert got.shape == (hb, wb, co)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, f32), atol=5e-4)


DTYPES = ["f32", "bf16"]


def _check(got, want, dtype, atol, **bf16):
    if dtype == "bf16":
        _assert_bf16_close(got, want, **bf16)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want, f32), atol=atol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("relu,skip", [(True, False), (False, True)], ids=["relu", "skip"])
def test_sft_conv3_plain_matches_pallas(dtype, relu, skip):
    from hdrtv_tpu.ops.megakernel import fused_sft_conv3_v2 as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_sft_conv3_v2

    rng = np.random.RandomState(7 + relu)
    hb, wb, c, cc = 24, 32, 128, 64
    xj, xt = _both(rng.rand(hb, wb, c), dtype)
    cj, ct = _both(rng.rand(hb, wb, cc), dtype)
    sj, st = _both(rng.rand(hb, wb, c), dtype) if skip else (None, None)
    sftj, sftt = _sft4(rng, cc, c, dtype)
    wj, wt = _both(rng.randn(3, 3, c, c) * 0.05, dtype)
    bj, bt = _both(rng.randn(c) * 0.1)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(xj, cj, sftj, wj, bj, relu=relu, skip=sj)
    got = fused_sft_conv3_v2(xt, ct, sftt, wt, bt, relu=relu, skip=st)
    _check(got, want, dtype, 3e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("second", [None, "up_coarse", "x_add"])
def test_resblock_plain_matches_pallas(dtype, second):
    """fp32: 5e-5 plain, 3e-5 with a second input, as tests/test_megakernel.py.
    bf16: t2 and the output are both rounded, so a flip in t2 can move the
    output by a second step (one step and 1.5% flipped seen here)."""
    from hdrtv_tpu.ops.megakernel import fused_resblock as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_resblock

    rng = np.random.RandomState(16)
    hb, wb, c, cc = (24, 32, 128, 64) if second is None else (16, 16, 128, 64)
    xj, xt = _both(rng.rand(hb, wb, c), dtype)
    cj, ct = _both(rng.rand(hb, wb, cc), dtype)
    kj, kt = {}, {}
    if second == "up_coarse":
        kj[second], kt[second] = _both(rng.rand(hb // 2, wb // 2, 4 * c), dtype)
    elif second == "x_add":
        kj[second], kt[second] = _both(rng.rand(hb, wb, c), dtype)
    s1j, s1t = _sft4(rng, cc, c, dtype)
    s2j, s2t = _sft4(rng, cc, c, dtype)
    w1j, w1t = _both(rng.randn(3, 3, c, c) * 0.05, dtype)
    b1j, b1t = _both(rng.randn(c) * 0.1)
    w2j, w2t = _both(rng.randn(3, 3, c, c) * 0.05, dtype)
    b2j, b2t = _both(rng.randn(c) * 0.1)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(xj, cj, s1j, w1j, b1j, s2j, w2j, b2j, **kj)
    got = fused_resblock(xt, ct, s1t, w1t, b1t, s2t, w2t, b2t, **kt)
    _check(got, want, dtype, 5e-5 if second is None else 3e-5, steps=2, flips=0.05)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kb", [0, 1, 2])
def test_mix_chain_window_plain_matches_pallas(dtype, kb):
    from hdrtv_tpu.ops.megakernel import fused_mix_chain as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_mix_chain

    rng = np.random.RandomState(3)
    hb, wb, nch = 16, 32, 128
    xj, xt = _both(rng.rand(hb, wb, 3 * nch), dtype)
    stepsj, stepst = [], []
    for ci, co, act in ((nch, nch, "lrelu"), (nch, 64, None)):
        (wj, wt), (bj, bt) = _both(rng.randn(ci, co) * 0.05, dtype), _both(rng.randn(co) * 0.1)
        stepsj.append((wj, bj, act))
        stepst.append((wt, bt, act))
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(xj, stepsj, cin=nch, ch0=kb * nch)
    got = fused_mix_chain(xt, stepst, cin=nch, ch0=kb * nch)
    assert got.shape == (hb, wb, 64)
    _check(got, want, dtype, 1e-5)


def test_mix_chain_rejects_misaligned_window():
    from hdrtv_tpu_torch.ops.megakernel import fused_mix_chain

    steps = [(torch.zeros(128, 64), torch.zeros(64), None)]
    with pytest.raises(ValueError):
        fused_mix_chain(torch.zeros(16, 32, 384), steps, cin=128, ch0=64)


@pytest.mark.parametrize("skip", [False, True], ids=["relu", "skip"])
def test_block_conv3_bf16_plain_matches_pallas(skip):
    from hdrtv_tpu.ops.conv_kernels import fused_block_conv3 as jax_conv
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3

    rng = np.random.RandomState(31 + skip)
    hb, wb, c, co = 16, 16, 128, 128
    xj, xt = _both(rng.rand(hb, wb, c), "bf16")
    wj, wt = _both(w_s2d_s1(rng.randn(3, 3, c // 4, co // 4).astype(f32) * 0.05), "bf16")
    bj, bt = _both(rng.randn(co) * 0.1)
    sj, st = _both(rng.rand(hb, wb, co), "bf16") if skip else (None, None)
    with pltpu.force_tpu_interpret_mode():
        want = jax_conv(xj, wj, bj, relu=not skip, skip=sj, a_sub=1)
    _assert_bf16_close(fused_block_conv3(xt, wt, bt, relu=not skip, skip=st), want)


@pytest.mark.parametrize("cin,ch0", [(None, 0), (256, 512)], ids=["whole", "window"])
def test_down2_bf16_plain_matches_pallas(cin, ch0):
    from hdrtv_tpu.ops.megakernel import fused_down2 as jax_down2
    from hdrtv_tpu_torch.ops.megakernel import fused_down2

    rng = np.random.RandomState(41 + ch0)
    hb, wb, c, co = 16, 16, 256, 256
    xj, xt = _both(rng.rand(hb, wb, 3 * c if cin else c), "bf16")
    wj, wt = _both(w_s2d_s2(rng.randn(3, 3, c // 4, co // 4).astype(f32) * 0.05), "bf16")
    bj, bt = _both(rng.randn(co) * 0.1)
    with pltpu.force_tpu_interpret_mode():
        want = jax_down2(xj, wj, bj, act="lrelu", cin=cin, ch0=ch0)
    _assert_bf16_close(fused_down2(xt, wt, bt, act="lrelu", cin=cin, ch0=ch0), want)


def test_trunk3_bf16_plain_matches_pallas():
    """Nine convs whose intermediates are each stored in bf16, as the Pallas
    kernel stores them: with the rounding points matched, the chain still
    ends within one step (7e-5 of the elements differ on this seed)."""
    from hdrtv_tpu.ops.megakernel import fused_trunk3 as jax_trunk3
    from hdrtv_tpu_torch.ops.megakernel import fused_trunk3

    rng = np.random.RandomState(18)
    hb, wb, cin, cc4, co = 27, 16, 32, 16, 128
    fj, ft = _both(rng.rand(hb, wb, cin) - 0.2, "bf16")
    cj, ct = _both(rng.rand(hb, wb, cc4) - 0.3, "bf16")
    jblocks, tblocks = [], []
    for _ in range(4):
        s1j, s1t = _sft4(rng, cc4, cin, "bf16", scale=0.2)
        s2j, s2t = _sft4(rng, cc4, cin, "bf16", scale=0.2)
        w1j, w1t = _both(rng.randn(3, 3, cin, cin) * 0.1, "bf16")
        b1j, b1t = _both(rng.randn(cin) * 0.1)
        w2j, w2t = _both(rng.randn(3, 3, cin, cin) * 0.1, "bf16")
        b2j, b2t = _both(rng.randn(cin) * 0.1)
        jblocks.append((s1j, w1j, b1j, s2j, w2j, b2j))
        tblocks.append((s1t, w1t, b1t, s2t, w2t, b2t))
    wuj, wut = _both(rng.randn(3, 3, cin, co) * 0.1, "bf16")
    buj, but = _both(rng.randn(co) * 0.1)
    with pltpu.force_tpu_interpret_mode():
        want = jax_trunk3(fj, cj, jblocks, wuj, buj)
    got = fused_trunk3(ft, ct, tblocks, wut, but)
    _assert_bf16_close(got, want)


def _head_args(rng, dtype):
    """mods and the eight parameters of the head for both sides (the JAX
    test's scales; the 256-wide hidden product scaled to contract)."""
    specs = [((6, 256), 0.1, "f32"), ((12, 256), 0.2, dtype), ((256,), 0.1, "f32"),
             ((256, 256), 0.05, dtype), ((256,), 0.1, "f32"), ((256, 12), 0.1, dtype),
             ((12,), 0.1, "f32"), ((3, 3, 12, 384), 0.1, dtype), ((384,), 0.1, "f32")]
    both = [_both(rng.randn(*shape) * scale, dt) for shape, scale, dt in specs]
    return [b[0] for b in both], [b[1] for b in both]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("frame", ["pairs_u8", "float"])
def test_agcm_head_plain_matches_pallas(dtype, frame):
    """Hb = 16 runs the Pallas kernel in two row tiles of 8, so the image's
    top and bottom edges, the tile seam and both column edges are all in the
    comparison. fp32: 2e-5, the JAX test's bound. bf16: one bf16 step on all
    three outputs; fea and c0 also move where a rounding of the AGCM result
    flipped, so more of their elements differ."""
    from hdrtv_tpu.ops.megakernel import fused_agcm_head as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_agcm_head

    rng = np.random.RandomState(21)
    hb, wb = 16, 16
    aj, at = _head_args(rng, dtype)
    if frame == "pairs_u8":
        x = (rng.rand(hb, 2, wb, 6) * 255).astype(np.uint8)
        xj, xt, scale = jnp.asarray(x), torch.from_numpy(x.copy()), 1.0 / 255.0
    else:
        (xj, xt), scale = _both(rng.rand(hb, wb, 12), dtype), 1.0
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(xj, *aj, n_first=128, scale=scale,
                      out_dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    got = fused_agcm_head(xt, *at, n_first=128, scale=scale)
    for g, w_, shape in zip(got, want, ((hb, wb, 128), (hb, wb, 256), (hb, wb, 12)), strict=True):
        assert g.shape == shape
        _check(g, w_, dtype, 2e-5, flips=0.02)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cond_chain_plain_matches_pallas(dtype):
    """fp32: 2e-5, the JAX test's bound. bf16: the running value is rounded
    at each of the five products in both, so one bf16 step; the JAX
    ``fused_cond_chain_ref`` never rounds between steps and is not the
    contract."""
    from hdrtv_tpu.ops.megakernel import fused_cond_chain as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_cond_chain

    rng = np.random.RandomState(22)
    hb, wb = 16, 16
    cj, ct = _both(rng.rand(hb, wb, 256), dtype)
    wj, wt = [], []
    for n in (256, 256, 256, 256, 64):
        (a, b), (c, d) = _both(rng.randn(256, n) * 0.04, dtype), _both(rng.randn(n) * 0.1)
        wj.append((a, c))
        wt.append((b, d))
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(cj, wj)
    got = fused_cond_chain(ct, wt)
    assert got[0].shape == (hb, wb, 256) and got[1].shape == (hb, wb, 64)
    for g, w_ in zip(got, want, strict=True):
        _check(g, w_, dtype, 2e-5, flips=0.02)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("coarse", [False, True], ids=["s", "up_coarse"])
@pytest.mark.parametrize("pack", [False, True], ids=["y", "packed"])
def test_tail_plain_matches_pallas(dtype, coarse, pack):
    """Hb = 16: two Pallas row tiles of 8 with their 2-row halos. fp32: 3e-5
    unpacked, ≤ 1 u16 code packed. bf16 unpacked: two bf16 steps, the rounded
    t and h feed further convs. bf16 packed: conv_last's fp32 sum goes to u16
    unrounded, so a flipped bf16 step of h (2^-9 to 2^-7 for |h| < 2) shows
    as |w_last| · step · 65535 codes, a few at these weights (|w| ≲ 0.04):
    max 2 and mean 0.014 codes seen, the bounds are twice that."""
    from hdrtv_tpu.ops.megakernel import fused_tail as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_tail

    rng = np.random.RandomState(23 + coarse)
    hb, wb, c, cc = 16, 16, 128, 64
    sj, st = _both(rng.rand(hb, wb, c), dtype)
    cj, ct = _both(rng.rand(hb, wb, cc), dtype)
    kj, kt = _both(rng.rand(hb, wb, 12), dtype)
    uj, ut = _both(rng.rand(hb // 2, wb // 2, 4 * c), dtype) if coarse else (None, None)
    sftj, sftt = _sft4(rng, cc, c, dtype)
    whj, wht = _both(rng.randn(3, 3, c, c) * 0.02, dtype)
    bhj, bht = _both(rng.randn(c) * 0.1)
    wlj, wlt = _both(rng.randn(3, 3, c, 12) * 0.01, dtype)
    blj, blt = _both(rng.randn(12) * 0.1)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(sj, cj, kj, sftj, whj, bhj, wlj, blj, pack=pack, up_coarse=uj)
    got = fused_tail(st, ct, kt, sftt, wht, bht, wlt, blt, pack=pack, up_coarse=ut)
    if not pack:
        assert got.shape == (hb, wb, 12)
        _check(got, want, dtype, 3e-5, steps=2, flips=0.05)
        return
    assert got.shape == (hb, 2, wb, 6) and got.dtype == torch.uint16
    w_ = np.asarray(want).astype(np.int64)
    d = np.abs(got.numpy().astype(np.int64) - w_)
    assert w_.max() > w_.min()
    if dtype == "f32":
        assert d.max() <= 1, int(d.max())
    else:
        assert d.max() <= 4 and d.mean() <= 0.03, (int(d.max()), float(d.mean()))


@pytest.mark.parametrize("dtype", DTYPES)
def test_agcm_mods_matches_jax(dtype):
    """The six modulation rows, computed in the policy's type and widened:
    fp32 to 1e-5 (the classifier's bound); bf16 within one bf16 step, on at
    most a tenth of the values (4% seen): the classifier's instance norms sum
    their fp32 statistics in another order, which flips a few roundings."""
    import os

    from hdrtv_tpu.models import layers as jax_layers
    from hdrtv_tpu.models.import_torch import load_npz
    from hdrtv_tpu.models.s2d import _agcm_mods as jax_mods, s2d_transform_params
    from hdrtv_tpu_torch.models import layers
    from hdrtv_tpu_torch.models.s2d import _agcm_mods, params_to_torch

    weights = os.path.join(os.path.dirname(__file__), "..", "weights", "hr_fp32.npz")
    sp = s2d_transform_params(load_npz(weights))
    jpol, tpol = (jax_layers.BF16, layers.BF16) if dtype == "bf16" else (jax_layers.F32, layers.F32)
    cond = np.random.RandomState(9).rand(1, 30, 64, 3).astype(f32)
    want = np.asarray(jax_mods({k: jnp.asarray(v) for k, v in sp.items()}, jnp.asarray(cond), policy=jpol))
    got = _agcm_mods(params_to_torch(sp, "cpu", tpol), torch.from_numpy(cond), policy=tpol)
    assert got.dtype == torch.float32 and got.shape == want.shape == (6, 256)
    assert not got[4:, 12:].any()
    if dtype == "bf16":
        err = np.abs(got.numpy() - want)
        assert (err <= 2.0 ** -7 * np.maximum(1.0, np.abs(want))).all(), float(err.max())
        assert (err > 0).mean() <= 0.1, float((err > 0).mean())
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("bgr", [False, True])
def test_quarter_aa_pairs_matches_jax_and_flat(bgr):
    """The pair-plane condition image against the JAX function (2e-6, the
    flat form's bound) and against the port's flat form on the same bytes:
    the same matrices contracted in the same order, so equal to the last
    bits (1e-6)."""
    from hdrtv_tpu.ops.resize import downsample_quarter_aa_pairs as jax_pairs
    from hdrtv_tpu_torch.ops.resize import downsample_quarter_aa_flat, downsample_quarter_aa_pairs

    frame = (np.random.RandomState(4).rand(48, 80, 3) * 255).astype(np.uint8)
    xr = frame.reshape(24, 2, 40, 6)
    got = downsample_quarter_aa_pairs(torch.from_numpy(xr.copy()), bgr=bgr).numpy()
    assert got.shape == (1, 12, 20, 3)
    np.testing.assert_allclose(got, np.asarray(jax_pairs(jnp.asarray(xr), bgr=bgr)), atol=2e-6, rtol=0)
    flat = downsample_quarter_aa_flat(torch.from_numpy(frame.reshape(48, 240).copy()), bgr=bgr).numpy()
    np.testing.assert_allclose(got, flat, atol=1e-6, rtol=0)


def test_megakernel_wrappers_reject_bad_inputs():
    from hdrtv_tpu_torch.ops.megakernel import fused_agcm_head, fused_cond_chain, fused_tail

    _, at = _head_args(np.random.RandomState(0), "f32")
    with pytest.raises(ValueError, match="pair planes"):
        fused_agcm_head(torch.zeros(8, 2, 16, 3, dtype=torch.uint8), *at, n_first=128)
    with pytest.raises(ValueError, match="uint8 or"):
        fused_agcm_head(torch.zeros(8, 16, 12, dtype=torch.bfloat16), *at, n_first=128)
    with pytest.raises(ValueError, match="five"):
        fused_cond_chain(torch.zeros(8, 16, 64), [(torch.zeros(64, 64), torch.zeros(64))] * 4)
    z = torch.zeros
    sft = [(z(64, 64), z(64)), (z(64, 128), z(128)), (z(64, 64), z(64)), (z(64, 128), z(128))]
    with pytest.raises(ValueError, match="up_coarse"):
        fused_tail(z(8, 16, 128), z(8, 16, 64), z(8, 16, 12), sft, z(3, 3, 128, 128), z(128),
                   z(3, 3, 128, 12), z(12), up_coarse=z(4, 8, 256))


@pytest.mark.parametrize("hb,want", [(540, 12), (60, 12), (32, 8), (14, 7), (26, 26), (7, 7), (2, 2)])
def test_pick_rows_matches_jax(hb, want):
    from hdrtv_tpu.ops.megakernel import pick_rows as jax_pick
    from hdrtv_tpu_torch.ops.megakernel import pick_rows

    assert pick_rows(hb) == jax_pick(hb) == want


def test_pack_bf16_plain_matches_reference_exactly():
    from hdrtv_tpu.ops.pack import pack_rgb48_ref as jax_pack
    from hdrtv_tpu_torch.ops.pack import pack_rgb48

    v = np.random.RandomState(6).uniform(-0.5, 1.5, (24, 40, 3)).astype(f32)
    vj, vt = _both(v, "bf16")
    got = pack_rgb48(vt)
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_pack(vj)))


def test_kernels_refuse_a_rounded_bias():
    """The kernels take fp32 biases: one rounded to bf16 is refused on the
    CPU as on the card, and so is a weight of another type than the input."""
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3

    x = torch.zeros(4, 4, 128, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 128, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="biases"):
        fused_block_conv3(x, w, torch.zeros(128, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="weights"):
        fused_block_conv3(x, w.float(), torch.zeros(128))


def test_trunk3_pack_layout_matches_kernel_count():
    """The parameter block packs 4·(2 sft + 2 conv) + up_conv1 floats, the
    count csrc/trunk3.cu computes for C=32, CC=16."""
    from hdrtv_tpu_torch.ops.megakernel import trunk3_pack

    c, cc, co = 32, 16, 128
    z = torch.zeros
    sft = [(z(cc, cc), z(cc)), (z(cc, c), z(c)), (z(cc, cc), z(cc)), (z(cc, c), z(c))]
    blocks = [(sft, z(3, 3, c, c), z(c), sft, z(3, 3, c, c), z(c))] * 4
    sft_n = 2 * (cc * cc + cc + cc * c + c)
    conv_n = 9 * c * c + c
    assert trunk3_pack(blocks, z(3, 3, c, co), z(co)).numel() == 4 * (2 * sft_n + 2 * conv_n) + 9 * c * co + co


def test_pack_plain_matches_reference_exactly():
    from hdrtv_tpu.ops.pack import pack_rgb48_ref as jax_pack
    from hdrtv_tpu_torch.ops.pack import pack_rgb48

    rng = np.random.RandomState(5)
    v = rng.uniform(-0.5, 1.5, (24, 40, 3)).astype(f32)
    flat = v.reshape(-1)
    k = np.arange(flat.size) % 65536
    flat[::5] = ((k[::5] + 0.5) / 65535.0).astype(f32)  # the +0.5 rounding boundary
    flat[1::5] = (k[1::5] / 65535.0).astype(f32)
    flat[:4] = [-1.0, 0.0, 1.0, 2.0]
    got = pack_rgb48(torch.from_numpy(v))
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_pack(jnp.asarray(v))))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3
    from hdrtv_tpu_torch.ops.pack import pack_rgb48

    before = dict(native.launch_counts)
    fused_block_conv3(torch.zeros(4, 4, 128), torch.zeros(3, 3, 128, 128), torch.zeros(128))
    pack_rgb48(torch.zeros(2, 4, 3))
    assert native.launch_counts == before


def test_mixed_devices_raise():
    from hdrtv_tpu_torch.ops.pack import pack_rgb48

    with pytest.raises(ValueError):
        pack_rgb48(torch.zeros(2, 4, 3, device="meta"))


def test_down2_rejects_misaligned_window():
    from hdrtv_tpu_torch.ops.megakernel import fused_down2

    with pytest.raises(ValueError):
        fused_down2(torch.zeros(4, 4, 768), torch.zeros(3, 3, 256, 256), torch.zeros(256), cin=256, ch0=100)
