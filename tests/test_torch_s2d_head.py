"""The ``s2d=True`` declaration of the port's ``fused_agcm_head``
(hdrtv_tpu_torch/ops/megakernel.py), on the CPU, and the packs the s2d head
and trunk3's bf16 instance read.

With it the three AGCM 1×1 weights are ``w_s2d_1x1(w)``, their biases
``b_s2d(b)``, and ``w_in`` is ``w_s2d_s1(conv_first) ‖ w_s2d_s1(cond_first.0)``
split at ``n_first``; the kernels (csrc/chain_sm90.cuh ``agcm_sm90``,
csrc/agcm_head.cu ``in_conv_sm90_kernel``) multiply only the 1×1s' diagonal
blocks and each part's populated slots, and so does the plain version here.

- On such weights the port equals the JAX kernel in interpret mode, for
  pair planes, u8 and float frames, with the tolerances of
  tests/test_torch_kernels.py's head test: fp32 2e-5, bf16 one step (the
  same exact products summed in fp32 in another order).
- A block or slot the declaration says is zero, in any of the three 1×1s or
  either part of ``w_in``, gives another result than the JAX kernel's: the
  skip is visible, not assumed. Masking ``w_in`` whole instead of each part
  would cut it at the wrong sub-position blocks.
- What the kernels read (the pack's blocks, the per-sub-position gathered
  input conv, the modulation lanes of each row's sub-position), emulated in
  torch, is the plain s2d form.
- The megakernel frame program passes ``s2d=True``, and both real
  checkpoints have the structure.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hdrtv_tpu.models.s2d import b_s2d, w_s2d_1x1, w_s2d_s1

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
INT8_WEIGHTS = os.path.join(ROOT, "tests", "fixtures", "hr_w8a8.npz")
f32 = np.float32
NF = 128  # n_first: conv_first's 32 natural channels, four sub-positions


def _both(a, dtype="f32"):
    """One numpy array as a JAX and a torch array, rounded once to bf16 for ``bf16``."""
    a = np.ascontiguousarray(a, f32)
    j, t = jnp.asarray(a), torch.from_numpy(a.copy())
    if dtype == "bf16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _check(got: torch.Tensor, want, dtype: str, atol: float, *, flips: float = 0.02):
    """fp32: absolute; bf16: one bf16 step (2^-7·max(1, |y|)) and equal but
    for a share ``flips`` of the values."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape
    err = np.abs(g - w)
    if dtype == "f32":
        assert float(err.max()) <= atol, float(err.max())
        return
    assert got.dtype == torch.bfloat16
    assert (err <= 2.0 ** -7 * np.maximum(1.0, np.abs(w))).all(), float(err.max())
    assert float((err > 0).mean()) <= flips, float((err > 0).mean())


def _head_np(rng):
    """The head's parameters in their s2d forms, numpy, at the JAX head
    test's scales (the 64-wide hidden product scaled to contract). ``mods``
    is drawn whole, not tiled: the s2d form reads each row's own lanes."""
    return [
        rng.randn(6, 256).astype(f32) * 0.1,
        w_s2d_1x1(rng.randn(1, 1, 3, 64).astype(f32) * 0.2)[0, 0], b_s2d(rng.randn(64).astype(f32) * 0.1),
        w_s2d_1x1(rng.randn(1, 1, 64, 64).astype(f32) * 0.1)[0, 0], b_s2d(rng.randn(64).astype(f32) * 0.1),
        w_s2d_1x1(rng.randn(1, 1, 64, 3).astype(f32) * 0.1)[0, 0], b_s2d(rng.randn(3).astype(f32) * 0.1),
        np.concatenate([w_s2d_s1(rng.randn(3, 3, 3, co).astype(f32) * 0.1) for co in (32, 64)], axis=-1),
        np.concatenate([b_s2d(rng.randn(co).astype(f32) * 0.1) for co in (32, 64)]),
    ]


_WEIGHT_ARGS = (1, 3, 5, 7)  # aw1, aw2, aw3, w_in: in the element type; the rest fp32


def _head_args(params, dtype):
    both = [_both(a, dtype if i in _WEIGHT_ARGS else "f32") for i, a in enumerate(params)]
    return [b[0] for b in both], [b[1] for b in both]


def _frame(rng, frame, hb, wb, dtype):
    """(JAX frame, torch frame, scale): u8 pair planes or u8 s2d with 1/255, or the element type."""
    if frame == "float":
        xj, xt = _both(rng.rand(hb, wb, 12), dtype)
        return xj, xt, 1.0
    x = (rng.rand(*((hb, 2, wb, 6) if frame == "pairs_u8" else (hb, wb, 12))) * 255).astype(np.uint8)
    return jnp.asarray(x), torch.from_numpy(x.copy()), 1.0 / 255.0


def _jax_head(xj, aj, dtype, scale):
    from hdrtv_tpu.ops.megakernel import fused_agcm_head as jax_fn

    with pltpu.force_tpu_interpret_mode():
        return jax_fn(xj, *aj, n_first=NF, scale=scale,
                      out_dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("frame", ["pairs_u8", "u8", "float"])
def test_agcm_head_s2d_matches_pallas(dtype, frame):
    """Hb = 16: two Pallas row tiles of 8, so the image's edges, the tile
    seam and both column edges are in the comparison; fea, c0 and agcm."""
    from hdrtv_tpu_torch.ops.megakernel import fused_agcm_head

    rng = np.random.RandomState(81 + len(frame))
    hb, wb = 16, 16
    aj, at = _head_args(_head_np(rng), dtype)
    xj, xt, scale = _frame(rng, frame, hb, wb, dtype)
    want = _jax_head(xj, aj, dtype, scale)
    got = fused_agcm_head(xt, *at, n_first=NF, scale=scale, s2d=True)
    for g, w_, shape in zip(got, want, ((hb, wb, 128), (hb, wb, 256), (hb, wb, 12)), strict=True):
        assert g.shape == shape
        _check(g, w_, dtype, 2e-5)


def _off_structure(params, what, rng):
    """``params`` with one block or slot the s2d declaration says is zero
    made non-zero: an off-diagonal block (sub-positions 0 → 1) of a 1×1, or
    tap (-1, -1) from input sub-position 0 into output sub-position 0 (not
    a slot) of w_in's fea or c0 part."""
    params = [p.copy() for p in params]
    if what in ("aw1", "aw2", "aw3"):
        i = {"aw1": 1, "aw2": 3, "aw3": 5}[what]
        w = params[i]
        k, n = w.shape[0] // 4, w.shape[1] // 4
        w[:k, n: 2 * n] = rng.randn(k, n) * 0.3
    else:
        c0, width = (0, 32) if what == "w_in_fea" else (NF, 64)
        params[7][0, 0, :3, c0: c0 + width] = rng.randn(3, width) * 0.3
    return params


@pytest.mark.parametrize("what", ["aw1", "aw2", "aw3", "w_in_fea", "w_in_c0"])
def test_agcm_head_s2d_skip_is_visible(what):
    """One weight with a block the declaration says is zero: with s2d=True
    the port ignores it and differs from the JAX kernel (which multiplies
    it); with s2d=False it takes it and agrees. fp32, 8 × 8 blocks."""
    from hdrtv_tpu_torch.ops.megakernel import fused_agcm_head

    rng = np.random.RandomState(91)
    aj, at = _head_args(_off_structure(_head_np(rng), what, rng), "f32")
    xj, xt, scale = _frame(rng, "pairs_u8", 8, 8, "f32")
    want = np.concatenate([np.asarray(o).reshape(-1) for o in _jax_head(xj, aj, "f32", scale)])
    skip, dense = (torch.cat([o.reshape(-1) for o in fused_agcm_head(xt, *at, n_first=NF, scale=scale, s2d=s2d)])
                   .numpy() for s2d in (True, False))
    np.testing.assert_allclose(dense, want, atol=2e-5)
    assert float(np.abs(skip - want).max()) > 1e-2


def test_w_in_is_masked_part_by_part():
    """``w_in``'s two parts are each a w_s2d_s1 weight, of 32 and 64
    natural outputs: masked part by part (the s2d form) it is unchanged, so
    the s2d head equals the dense one; masked whole, as one weight of 96
    natural outputs, the sub-position blocks fall elsewhere, real weights
    are zeroed and the head gives another result."""
    from hdrtv_tpu_torch.ops.megakernel import _s2d_slots_only, fused_agcm_head

    rng = np.random.RandomState(93)
    _, at = _head_args(_head_np(rng), "f32")
    _, xt, scale = _frame(rng, "pairs_u8", 8, 8, "f32")
    w_in = at[7]
    parts = torch.cat([_s2d_slots_only(w_in[..., :NF]), _s2d_slots_only(w_in[..., NF:])], dim=-1)
    assert torch.equal(parts, w_in)
    whole = _s2d_slots_only(w_in)
    assert not torch.equal(whole, w_in)
    s2d = fused_agcm_head(xt, *at, n_first=NF, scale=scale, s2d=True)
    dense = fused_agcm_head(xt, *at, n_first=NF, scale=scale)
    cut = fused_agcm_head(xt, *at[:7], whole, at[8], n_first=NF, scale=scale)
    for a, b, c in zip(s2d, dense, cut, strict=True):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=0)
    assert float((s2d[0] - cut[0]).abs().max()) > 1e-2


@pytest.mark.parametrize("frame", ["pairs_u8", "u8", "float"])
def test_s2d_kernels_arithmetic_is_the_plain_form(frame):
    """What the two s2d kernels compute, emulated in torch on what they
    read, equals the plain s2d form in fp32 (2e-5): the AGCM pass on the
    (4·npix, 3) natural rows of the frame (as each frame kind lays them out)
    times agcm_head_pack_s2d's padded blocks, modulated by the lanes of each
    row's own sub-position (so·64 + n, so·3 + n); the input conv, per output
    sub-position, the 9 slots' 3 channels of each pixel's zero-padded agcm
    neighbourhood (rows 3·k + c of so's gathered weight) times that weight,
    plus its gathered bias. Odd sizes (7 × 5): no tile is whole."""
    from hdrtv_tpu_torch.ops.megakernel import _head_slots, agcm_head_pack_s2d, fused_agcm_head_ref

    rng = np.random.RandomState(95)
    hb, wb = 7, 5
    _, at = _head_args(_head_np(rng), "f32")
    mods, aw1, ab1, aw2, ab2, aw3, ab3, w_in, b_in = at
    _, xt, scale = _frame(rng, frame, hb, wb, "f32")
    w1, w2, w3, win, bin_ = agcm_head_pack_s2d(aw1, aw2, aw3, w_in, b_in, n_first=NF)
    assert (w1.shape, w2.shape, w3.shape, win.shape, bin_.shape) == ((16, 64), (64, 64), (64, 16), (4, 32, 96),
                                                                      (4, 96))
    assert not w1[3:].any() and not w3[:, 3:].any() and not win[:, 27:].any()

    # the frame's natural rows, read as the kernel reads each kind
    rows = 4 * hb * wb
    r = torch.arange(rows)
    if frame == "pairs_u8":
        p, so = r // 4, r % 4
        i, j = p // wb, p % wb
        x = torch.stack([xt[i, so // 2, j, (so % 2) * 3 + c] for c in range(3)], dim=1).float()
    else:
        x = xt.reshape(rows, 3).float()
    so = (r % 4)[:, None]
    lanes = torch.arange(64)[None]
    v = torch.zeros(rows, 16)
    v[:, :3] = x * scale
    a = torch.clamp_min((v @ w1 + ab1[:64]) * (mods[0][so * 64 + lanes] + 1) + mods[1][so * 64 + lanes], 0)
    b = torch.clamp_min((a @ w2 + ab2[:64]) * (mods[2][so * 64 + lanes] + 1) + mods[3][so * 64 + lanes], 0)
    y = (b @ w3 + torch.cat([ab3[:3], torch.zeros(13)]))[:, :3]
    n3 = torch.arange(3)[None]
    agcm = (y * (mods[4][so * 3 + n3] + 1) + mods[5][so * 3 + n3]).reshape(hb, wb, 12)

    fea, c0, agcm_ref = fused_agcm_head_ref(xt, *at, n_first=NF, scale=scale, s2d=True)
    torch.testing.assert_close(agcm, agcm_ref, atol=2e-5, rtol=0)

    pad = torch.nn.functional.pad(agcm_ref, (0, 0, 1, 1, 1, 1))  # zero outside the image
    slots = _head_slots()
    acc = torch.zeros(hb, wb, 4, 96)
    for s in range(4):
        cols = []
        for e in slots[9 * s: 9 * s + 9]:
            tap, si = e & 15, e >> 4
            cols.append(pad[tap // 3: tap // 3 + hb, tap % 3: tap % 3 + wb, 3 * si: 3 * si + 3])
        acc[:, :, s] = torch.cat(cols, dim=-1) @ win[s, :27] + bin_[s]
    got_fea = torch.clamp_min(acc[..., :32], 0).reshape(hb, wb, 128)
    lre = acc[..., 32:]
    got_c0 = torch.where(lre >= 0, lre, lre * 0.1).reshape(hb, wb, 256)
    torch.testing.assert_close(got_fea, fea, atol=2e-5, rtol=0)
    torch.testing.assert_close(got_c0, c0, atol=2e-5, rtol=0)


@pytest.mark.parametrize("weights", [WEIGHTS, INT8_WEIGHTS], ids=["float", "int8"])
def test_mega_program_declares_s2d(weights, monkeypatch):
    """One 64 × 96 frame of the bf16 megakernel program (the float and the
    pre-dequantized W8A8 checkpoint): agcm_head is called once, with
    s2d=True and the s2d pack built at load."""
    from hdrtv_tpu_torch.models import s2d as port_s2d
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    calls = []

    def spy(*a, _fn=port_s2d.fused_agcm_head, **k):
        calls.append(k)
        return _fn(*a, **k)

    monkeypatch.setattr(port_s2d, "fused_agcm_head", spy)
    monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    proc = HDRTVNetTorch(weights, device="cpu")
    frame = (np.random.RandomState(97).rand(64, 96, 3) * 255).astype(np.uint8)
    out = proc.process_rgb48(frame)
    assert out.shape == (64, 96, 3) and out.dtype == np.uint16
    assert [k.get("s2d") for k in calls] == [True]
    pk = calls[0]["packed_s2d"]
    assert [tuple(t.shape) for t in pk] == [(16, 64), (64, 64), (64, 16), (4, 32, 96), (4, 96)]


@pytest.mark.parametrize("weights", [WEIGHTS, INT8_WEIGHTS], ids=["float", "int8"])
def test_checkpoints_have_the_declared_structure(weights):
    """The head's weights as the program hands them with s2d=True: each AGCM
    1×1 (and aw1's BGR permutation) four equal diagonal blocks and zeros
    elsewhere, each bias four equal quarters, and both parts of
    LE.__in_fused zero outside the populated slots."""
    from hdrtv_tpu_torch.models.s2d import _HEAD_AW1_BGR
    from hdrtv_tpu_torch.ops.megakernel import _s2d_slots_only
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    p = HDRTVNetTorch(weights, device="cpu").params
    pairs = [(p[f"{n}.weight"][0, 0], p[f"{n}.bias"]) for n in ("AGCM.conv_first", "AGCM.HRconv", "AGCM.conv_last")]
    pairs.append((p[_HEAD_AW1_BGR], p["AGCM.conv_first.bias"]))
    for w, b in pairs:
        k, n = w.shape[0] // 4, w.shape[1] // 4
        assert torch.equal(torch.block_diag(*[w[:k, :n]] * 4), w)
        assert torch.equal(b[:n].repeat(4), b)
    w_in, nf = p["LE.__in_fused.weight"], p["LE.conv_first.bias"].shape[-1]
    assert nf == NF and w_in.shape == (3, 3, 12, 384)
    for part in (w_in[..., :nf], w_in[..., nf:]):
        assert torch.equal(_s2d_slots_only(part), part)
        assert bool((part != 0).any())


def test_s2d_head_needs_four_blocks():
    """s2d=True with a 1×1 width that is not four sub-position blocks
    raises, on the CPU as on the card; the dense form takes it."""
    from hdrtv_tpu_torch.ops.megakernel import fused_agcm_head

    rng = np.random.RandomState(99)
    params = _head_np(rng)
    params[1], params[2] = params[1][:, :254], params[2][:254]
    params[3] = params[3][:254]
    _, at = _head_args(params, "f32")
    _, xt, scale = _frame(rng, "pairs_u8", 4, 4, "f32")
    fused_agcm_head(xt, *at, n_first=NF, scale=scale)
    with pytest.raises(ValueError, match="divisible by 4"):
        fused_agcm_head(xt, *at, n_first=NF, scale=scale, s2d=True)


def test_trunk3_bf16_pack_is_trunk3_pack_split():
    """trunk3_pack_bf16 holds trunk3_pack's values in its order, weights
    (rounded to bf16) apart from biases (fp32): the counts csrc/trunk3.cu's
    bf16 instance walks, and every value in its place."""
    from hdrtv_tpu_torch.ops.megakernel import trunk3_pack, trunk3_pack_bf16

    c, cc, co = 32, 16, 128
    g = torch.Generator().manual_seed(7)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    def sft():
        return [(r(cc, cc), r(cc)), (r(cc, c), r(c)), (r(cc, cc), r(cc)), (r(cc, c), r(c))]

    blocks = [(sft(), r(3, 3, c, c), r(c), sft(), r(3, 3, c, c), r(c)) for _ in range(4)]
    w_up, b_up = r(3, 3, c, co), r(co)
    ws, bs = trunk3_pack_bf16(blocks, w_up, b_up)
    assert ws.dtype == torch.bfloat16 and bs.dtype == torch.float32
    assert ws.numel() == 4 * (2 * 2 * (cc * cc + cc * c) + 2 * 9 * c * c) + 9 * c * co
    assert bs.numel() == 4 * (2 * 2 * (cc + c) + 2 * c) + co
    full = trunk3_pack(blocks, w_up, b_up)
    assert full.numel() == ws.numel() + bs.numel()
    # rebuild trunk3_pack's order from the two halves: each (w, b) pair in turn
    sizes = []
    for blk in blocks:
        for group in (blk[0], [blk[1:3]], blk[3], [blk[4:6]]):
            sizes += [(w.numel(), b.numel()) for w, b in group]
    sizes.append((w_up.numel(), b_up.numel()))
    parts, wi, bi = [], 0, 0
    for nw, nb in sizes:
        parts += [ws[wi: wi + nw].float(), bs[bi: bi + nb]]
        wi, bi = wi + nw, bi + nb
    ref = torch.cat(parts)
    expect = torch.cat([t.reshape(-1) for blk in blocks
                        for group in (blk[0], [blk[1:3]], blk[3], [blk[4:6]])
                        for w, b in group for t in (w.to(torch.bfloat16).float(), b)]
                       + [w_up.to(torch.bfloat16).float().reshape(-1), b_up])
    assert torch.equal(ref, expect)
