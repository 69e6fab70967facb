"""hdrtv_tpu_torch kernels on the card: each CUDA kernel against its plain
PyTorch version on the same CUDA inputs (TF32 off), at small shapes that
cover the ragged pixel tile, masked output channels and the channel window.

Marked ``cuda``: skipped without a CUDA device. This file imports neither
jax nor hdrtv_tpu, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance, fp32: 1e-4 absolute at these magnitudes (|y| ≲ 10): the kernels
and cuDNN sum the same fp32 products in different orders. bf16: the same
exact products summed in fp32 in another order and rounded at the same
places, so a result differs by one bf16 step where a rounding flips:
|err| ≤ 2^-7·max(1, |y|), doubled for the resblock and trunk3, whose rounded
intermediates feed further convs, and for the tail (its rounded t and h feed
HR_conv2 and conv_last). The pack is exact in both types; the packed tail is
within one u16 code in fp32, and in bf16 within the codes two bf16 steps of h
can move conv_last's sum. The HG tail and the colorimetric pack are compared
in u16 codes as their tests say.
"""

import numpy as np
import pytest
import torch

from hdrtv_tpu_torch.models.layers import fp32_math
from hdrtv_tpu_torch.models.s2d import w_s2d_s1, w_s2d_s2
from hdrtv_tpu_torch.ops import native

pytestmark = pytest.mark.cuda

ATOL = 1e-4


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    with fp32_math():
        yield torch.device("cuda")


DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _t(a, dev, dtype="f32"):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev).to(DTYPES[dtype])


def _close(y, y_ref, dtype, *, atol=ATOL, steps=1, flips=0.02):
    """fp32: absolute; bf16: within ``steps`` bf16 steps of the reference,
    and equal but for a share ``flips`` of the elements (at most 0.9% seen
    at these shapes)."""
    torch.cuda.synchronize()
    assert y.dtype == y_ref.dtype == DTYPES[dtype] and y.shape == y_ref.shape
    err = (y.float() - y_ref.float()).abs()
    if dtype == "f32":
        assert float(err.max()) < atol
    else:
        used = float((err / (2.0 ** -7 * y_ref.float().abs().clamp_min(1.0))).max())
        share = float((err > 0).float().mean())
        assert used <= steps and share <= flips, (used, share)


def _sft4(rng, cc, c, dev, dtype, scale=0.05):
    return [(_t(rng.randn(ci, co) * scale, dev, dtype), _t(rng.randn(co) * 0.1, dev))
            for ci, co in ((cc, cc), (cc, c), (cc, cc), (cc, c))]


def _max_err(a, b):
    torch.cuda.synchronize()
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("hb,wb,c,co,relu,skip", [
    (12, 20, 128, 128, True, False),
    (9, 14, 128, 128, False, True),
    (8, 16, 128, 512, True, False),
    (5, 7, 32, 32, False, True),
])
def test_block_conv3_matches_plain(dev, hb, wb, c, co, relu, skip):
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3, fused_block_conv3_ref

    rng = np.random.RandomState(hb * wb + co)
    x = _t(rng.rand(hb, wb, c) - 0.3, dev)
    if c % 4 == 0 and co % 4 == 0 and c >= 128:
        w = _t(w_s2d_s1(rng.randn(3, 3, c // 4, co // 4).astype(np.float32) * 0.05), dev)
    else:
        w = _t(rng.randn(3, 3, c, co) * 0.05, dev)
    b = _t(rng.randn(co) * 0.1, dev)
    sk = _t(rng.rand(hb, wb, co), dev) if skip else None
    before = native.launch_counts["block_conv3"]
    y = fused_block_conv3(x, w, b, relu=relu, skip=sk)
    assert native.launch_counts["block_conv3"] == before + 1
    y_r = fused_block_conv3_ref(x, w, b, relu=relu, skip=sk)
    assert y.shape == (hb, wb, co)
    assert _max_err(y, y_r) < ATOL


@pytest.mark.parametrize("hb,wb,cf,cin,ch0,co,act", [
    (12, 20, 128, None, 0, 128, "relu"),
    (10, 14, 256, None, 0, 384, "lrelu"),
    (8, 12, 768, 256, 256, 256, "lrelu"),
    (6, 10, 768, 256, 512, 256, None),
])
def test_down2_matches_plain(dev, hb, wb, cf, cin, ch0, co, act):
    from hdrtv_tpu_torch.ops.megakernel import fused_down2, fused_down2_ref

    rng = np.random.RandomState(hb + wb + cf + ch0)
    c = cin or cf
    x = _t(rng.rand(hb, wb, cf), dev)
    w = _t(w_s2d_s2(rng.randn(3, 3, c // 4, co // 4).astype(np.float32) * 0.05), dev)
    b = _t(rng.randn(co) * 0.1, dev)
    y = fused_down2(x, w, b, act=act, cin=cin, ch0=ch0)
    y_r = fused_down2_ref(x[..., ch0 : ch0 + c], w, b, act=act)
    assert y.shape == (hb // 2, wb // 2, co)
    assert _max_err(y, y_r) < ATOL


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_trunk3_matches_plain(dev, dtype):
    """In bf16 the weights are scaled so that the 9-conv chain does not
    amplify (gain < 1 per conv, as a trained trunk): with the fp32 case's
    weights (gain ≈ 1.7 per conv, ~300× over the chain) one flipped rounding
    early in the chain grows to tens of steps, which tests the weights and
    not the kernel."""
    from hdrtv_tpu_torch.ops.megakernel import fused_trunk3, fused_trunk3_ref, trunk3_pack

    rng = np.random.RandomState(18)
    hb, wb, cin, cc, co = 27, 16, 32, 16, 128
    ws, wc = (0.2, 0.1) if dtype == "f32" else (0.05, 0.03)
    fea3 = _t(rng.rand(hb, wb, cin) - 0.2, dev, dtype)
    cond4 = _t(rng.rand(hb, wb, cc) - 0.3, dev, dtype)
    blocks = []
    for _ in range(4):
        blocks.append((_sft4(rng, cc, cin, dev, dtype, ws),
                       _t(rng.randn(3, 3, cin, cin) * wc, dev, dtype), _t(rng.randn(cin) * 0.1, dev),
                       _sft4(rng, cc, cin, dev, dtype, ws),
                       _t(rng.randn(3, 3, cin, cin) * wc, dev, dtype), _t(rng.randn(cin) * 0.1, dev)))
    w_up = _t(rng.randn(3, 3, cin, co) * wc, dev, dtype)
    b_up = _t(rng.randn(co) * 0.1, dev)
    y = fused_trunk3(fea3, cond4, blocks, w_up, b_up)
    y_r = fused_trunk3_ref(fea3, cond4, blocks, w_up, b_up)
    assert y.shape == (hb, wb, co)
    _close(y, y_r, dtype, atol=5e-4, steps=2, flips=0.05)
    packed = trunk3_pack(blocks, w_up, b_up)
    assert torch.equal(fused_trunk3(fea3, cond4, blocks, w_up, b_up, packed=packed), y)


@pytest.mark.parametrize("hb,wb,c,co,relu,skip", [(12, 20, 128, 128, True, False), (9, 14, 128, 512, False, False),
                                               (9, 14, 128, 128, False, True)])
def test_block_conv3_bf16_matches_plain(dev, hb, wb, c, co, relu, skip):
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3, fused_block_conv3_ref

    rng = np.random.RandomState(hb * wb + co + 1)
    x = _t(rng.rand(hb, wb, c) - 0.3, dev, "bf16")
    w = _t(w_s2d_s1(rng.randn(3, 3, c // 4, co // 4).astype(np.float32) * 0.05), dev, "bf16")
    b = _t(rng.randn(co) * 0.1, dev)
    sk = _t(rng.rand(hb, wb, co), dev, "bf16") if skip else None
    _close(fused_block_conv3(x, w, b, relu=relu, skip=sk),
           fused_block_conv3_ref(x, w, b, relu=relu, skip=sk), "bf16")


@pytest.mark.parametrize("hb,wb,cf,cin,ch0,co,act", [
    (12, 20, 128, None, 0, 128, "relu"),
    (8, 12, 768, 256, 256, 256, "lrelu"),
])
def test_down2_bf16_matches_plain(dev, hb, wb, cf, cin, ch0, co, act):
    from hdrtv_tpu_torch.ops.megakernel import fused_down2, fused_down2_ref

    rng = np.random.RandomState(hb + wb + cf + ch0 + 1)
    c = cin or cf
    x = _t(rng.rand(hb, wb, cf), dev, "bf16")
    w = _t(w_s2d_s2(rng.randn(3, 3, c // 4, co // 4).astype(np.float32) * 0.05), dev, "bf16")
    b = _t(rng.randn(co) * 0.1, dev)
    _close(fused_down2(x, w, b, act=act, cin=cin, ch0=ch0),
           fused_down2_ref(x[..., ch0 : ch0 + c], w, b, act=act), "bf16")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hb,wb,relu,skip", [(12, 20, True, False), (9, 15, False, True)])
def test_sft_conv3_matches_plain(dev, dtype, hb, wb, relu, skip):
    from hdrtv_tpu_torch.ops.megakernel import fused_sft_conv3_v2, fused_sft_conv3_v2_ref

    rng = np.random.RandomState(hb * wb)
    c, cc = 128, 64
    x = _t(rng.rand(hb, wb, c) - 0.3, dev, dtype)
    cond = _t(rng.rand(hb, wb, cc) - 0.3, dev, dtype)
    sft = _sft4(rng, cc, c, dev, dtype)
    w = _t(rng.randn(3, 3, c, c) * 0.05, dev, dtype)
    b = _t(rng.randn(c) * 0.1, dev)
    sk = _t(rng.rand(hb, wb, c), dev, dtype) if skip else None
    before = native.launch_counts["sft_conv3"]
    y = fused_sft_conv3_v2(x, cond, sft, w, b, relu=relu, skip=sk)
    assert native.launch_counts["sft_conv3"] == before + 1
    _close(y, fused_sft_conv3_v2_ref(x, cond, sft, w, b, relu=relu, skip=sk), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hb,wb,second", [(12, 20, None), (9, 15, "x_add"), (10, 14, "up_coarse")])
def test_resblock_matches_plain(dev, dtype, hb, wb, second):
    from hdrtv_tpu_torch.ops.megakernel import fused_resblock, fused_resblock_ref

    rng = np.random.RandomState(hb * wb + 5)
    c, cc = 128, 64
    x = _t(rng.rand(hb, wb, c) - 0.3, dev, dtype)
    cond = _t(rng.rand(hb, wb, cc) - 0.3, dev, dtype)
    kw = {}
    if second == "x_add":
        kw[second] = _t(rng.rand(hb, wb, c), dev, dtype)
    elif second == "up_coarse":
        kw[second] = _t(rng.rand(hb // 2, wb // 2, 4 * c), dev, dtype)
    args = (_sft4(rng, cc, c, dev, dtype), _t(rng.randn(3, 3, c, c) * 0.05, dev, dtype), _t(rng.randn(c) * 0.1, dev),
            _sft4(rng, cc, c, dev, dtype), _t(rng.randn(3, 3, c, c) * 0.05, dev, dtype), _t(rng.randn(c) * 0.1, dev))
    before = native.launch_counts["resblock"]
    y = fused_resblock(x, cond, *args, **kw)
    assert native.launch_counts["resblock"] == before + 1
    _close(y, fused_resblock_ref(x, cond, *args, **kw), dtype, steps=2, flips=0.05)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hb,wb,cf,cin,ch0,widths", [
    (9, 15, 768, 256, 0, (256, 64)),
    (6, 10, 384, 128, 256, (128, 64)),
    (5, 7, 64, None, 0, (32,)),
    (5, 13, 128, None, 0, (256, 128, 12)),
])
def test_mix_chain_matches_plain(dev, dtype, hb, wb, cf, cin, ch0, widths):
    from hdrtv_tpu_torch.ops.megakernel import fused_mix_chain, fused_mix_chain_ref

    rng = np.random.RandomState(hb * wb + cf)
    c = cin or cf
    x = _t(rng.rand(hb, wb, cf) - 0.3, dev, dtype)
    steps, k = [], c
    for i, n in enumerate(widths):
        act = None if i + 1 == len(widths) else ("lrelu", "relu")[i % 2]
        steps.append((_t(rng.randn(k, n) * 0.05, dev, dtype), _t(rng.randn(n) * 0.1, dev), act))
        k = n
    before = native.launch_counts["mix_chain"]
    y = fused_mix_chain(x, steps, cin=cin, ch0=ch0)
    assert native.launch_counts["mix_chain"] == before + 1
    _close(y, fused_mix_chain_ref(x[..., ch0 : ch0 + c], steps), dtype)


def _head_args(rng, dev, dtype, c1=256, c2=256, co=384):
    return (_t(rng.randn(6, max(c1, c2)) * 0.1, dev),
            _t(rng.randn(12, c1) * 0.2, dev, dtype), _t(rng.randn(c1) * 0.1, dev),
            _t(rng.randn(c1, c2) * 0.05, dev, dtype), _t(rng.randn(c2) * 0.1, dev),
            _t(rng.randn(c2, 12) * 0.1, dev, dtype), _t(rng.randn(12) * 0.1, dev),
            _t(rng.randn(3, 3, 12, co) * 0.1, dev, dtype), _t(rng.randn(co) * 0.1, dev))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hb,wb,frame", [(12, 20, "pairs"), (9, 15, "u8"), (5, 7, "float"), (8, 16, "pairs")])
def test_agcm_head_matches_plain(dev, dtype, hb, wb, frame):
    """Frame edges in every tile direction (the 64-pixel tiles are ragged at
    9×15 and 5×7), u8 pair planes and u8 s2d with scale 1/255, and the frame
    in the element type with scale 1. Two steps on c0 and fea: a flipped
    rounding of the AGCM result moves the conv's sum."""
    from hdrtv_tpu_torch.ops.megakernel import agcm_head_pack, fused_agcm_head, fused_agcm_head_ref

    rng = np.random.RandomState(hb * wb + 3)
    args = _head_args(rng, dev, dtype)
    if frame == "float":
        xs, scale = _t(rng.rand(hb, wb, 12), dev, dtype), 1.0
    else:
        shape = (hb, 2, wb, 6) if frame == "pairs" else (hb, wb, 12)
        xs, scale = torch.as_tensor((rng.rand(*shape) * 255).astype(np.uint8), device=dev), 1.0 / 255.0
    before = native.launch_counts["agcm_head"]
    got = fused_agcm_head(xs, *args, n_first=128, scale=scale)
    assert native.launch_counts["agcm_head"] == before + 1
    want = fused_agcm_head_ref(xs, *args, n_first=128, scale=scale)
    for y, y_r, shape in zip(got, want, ((hb, wb, 128), (hb, wb, 256), (hb, wb, 12)), strict=True):
        assert y.shape == shape
        _close(y, y_r, dtype, steps=2, flips=0.05)
    packed = agcm_head_pack(args[1], args[5], args[7])
    again = fused_agcm_head(xs, *args, n_first=128, scale=scale, packed=packed)
    assert all(torch.equal(a, b) for a, b in zip(again, got, strict=True))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hb,wb", [(12, 20), (9, 15), (1, 64)])
def test_cond_chain_matches_plain(dev, dtype, hb, wb):
    from hdrtv_tpu_torch.ops.megakernel import fused_cond_chain, fused_cond_chain_ref

    rng = np.random.RandomState(hb * wb + 11)
    c0 = _t(rng.rand(hb, wb, 256) - 0.3, dev, dtype)
    weights = [(_t(rng.randn(256, n) * 0.05, dev, dtype), _t(rng.randn(n) * 0.1, dev))
               for n in (256, 256, 256, 256, 64)]
    before = native.launch_counts["cond_chain"]
    c, cond1 = fused_cond_chain(c0, weights)
    assert native.launch_counts["cond_chain"] == before + 1
    c_r, cond1_r = fused_cond_chain_ref(c0, weights)
    assert c.shape == (hb, wb, 256) and cond1.shape == (hb, wb, 64)
    _close(c, c_r, dtype, steps=2, flips=0.05)
    _close(cond1, cond1_r, dtype, steps=2, flips=0.05)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hb,wb,coarse,pack", [
    (12, 20, True, True), (9, 15, False, True), (10, 14, True, False), (5, 7, False, False), (8, 16, True, True),
])
def test_tail_matches_plain(dev, dtype, hb, wb, coarse, pack):
    """Tile edges of the SFT pass (64 pixels), the conv tile (128 pixels) and
    conv_last's 8 × 16 blocks; both forms of s; packed and not. Packed: ≤ 1
    code in fp32 (the sum order at the +0.5 boundary); in bf16 h differs by a
    bf16 step on a few elements (|h| < 4: a step is at most 2^-6), each moving
    conv_last's sum by at most |w| · 2^-6, so ≤ 64 codes bounds it with room
    (|w| ≲ 0.04 here) and the mean stays below 1 code."""
    from hdrtv_tpu_torch.ops.megakernel import fused_tail, fused_tail_ref

    rng = np.random.RandomState(hb * wb + 17)
    c, cc = 128, 64
    s = _t(rng.rand(hb, wb, c) - 0.3, dev, dtype)
    up = _t(rng.rand(hb // 2, wb // 2, 4 * c) - 0.3, dev, dtype) if coarse else None
    cond1 = _t(rng.rand(hb, wb, cc) - 0.3, dev, dtype)
    skip = _t(rng.rand(hb, wb, 12), dev, dtype)
    args = (_sft4(rng, cc, c, dev, dtype), _t(rng.randn(3, 3, c, c) * 0.02, dev, dtype), _t(rng.randn(c) * 0.1, dev),
            _t(rng.randn(3, 3, c, 12) * 0.01, dev, dtype), _t(rng.randn(12) * 0.1, dev))
    before = native.launch_counts["tail"]
    y = fused_tail(s, cond1, skip, *args, pack=pack, up_coarse=up)
    assert native.launch_counts["tail"] == before + 1
    y_r = fused_tail_ref(s, cond1, skip, *args, pack=pack, up_coarse=up)
    if not pack:
        assert y.shape == (hb, wb, 12)
        _close(y, y_r, dtype, steps=2, flips=0.05)
        return
    torch.cuda.synchronize()
    assert y.shape == (hb, 2, wb, 6) and y.dtype == torch.uint16
    d = (y.to(torch.int32) - y_r.to(torch.int32)).abs()
    assert int(y_r.to(torch.int32).max()) > int(y_r.to(torch.int32).min())
    if dtype == "f32":
        assert int(d.max()) <= 1, int(d.max())
    else:
        assert int(d.max()) <= 64 and float(d.float().mean()) < 1.0, (int(d.max()), float(d.float().mean()))


def test_mega_frame_matches_cpu(dev, monkeypatch):
    """The bf16 megakernel frame program on the card against the same
    processor on the CPU (the plain versions), one seeded 64×128 frame, and
    that it really is the megakernel program: the three kernels launch once
    each and pack_rgb48 not at all. Bounds as for the non-mega frame."""
    import os

    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    weights = os.path.join(os.path.dirname(__file__), "..", "weights", "hr_fp32.npz")
    frame = (np.random.RandomState(64).rand(64, 128, 3) * 255).astype(np.uint8)
    native.reset_launch_counts()
    gpu = HDRTVNetTorch(weights).process_rgb48(frame).astype(np.int64)
    counts = dict(native.launch_counts)
    assert (counts["agcm_head"], counts["cond_chain"], counts["tail"], counts["pack_rgb48"]) == (1, 1, 1, 0), counts
    cpu = HDRTVNetTorch(weights, device="cpu").process_rgb48(frame).astype(np.int64)
    d = np.abs(gpu - cpu)
    assert d.max() <= 512 and d.mean() <= 24, (int(d.max()), float(d.mean()))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hb,wb,cu,cc", [
    (8, 16, 64, 64), (5, 8, 256, 256), (7, 24, 32, 96), (6, 8, 16, 16), (3, 40, 20, 12),
])
def test_hg_tail_matches_plain(dev, dtype, hb, wb, cu, cc):
    """Whole and ragged 16-pixel tiles; in bf16 widths the tensor-core form
    takes (Cu, Cc multiples of 32) and widths it leaves to the FMA form. In
    u16 codes: fp32 ≤ 1 (the sum order at the +0.5 boundary); bf16 equal
    except where the rounding of u10 flipped, which moves an output by at most
    |wlast| · step(u10) · 65535 codes (|u10| < 4, a step ≤ 2^-6; |wlast| < 1.5
    here), on at most 2% of the values."""
    from hdrtv_tpu_torch.ops.megakernel import fused_hg_tail, fused_hg_tail_ref

    rng = np.random.RandomState(hb * wb + cu)
    up5 = _t(np.maximum(rng.randn(hb, wb, cu), 0), dev, dtype)
    c1 = _t(np.maximum(rng.randn(hb, wb, cc), 0), dev, dtype)
    img = _t(rng.rand(hb, wb, 12) * 1.1 - 0.05, dev, dtype)
    mask = _t(rng.rand(hb, wb, 4) > 0.4, dev, dtype)
    w10 = _t(rng.randn(cu + cc, 12) * (0.3 / np.sqrt(cu + cc)), dev, dtype)
    wlast = _t(rng.randn(24, 12) * 0.3, dev, dtype)
    b10, blast = _t(rng.randn(12) * 0.1, dev), _t(rng.randn(12) * 0.05, dev)
    before = native.launch_counts["hg_tail"]
    y = fused_hg_tail(up5, c1, img, mask, w10, b10, wlast, blast)
    assert native.launch_counts["hg_tail"] == before + 1
    y_r = fused_hg_tail_ref(up5, c1, img, mask, w10, b10, wlast, blast)
    torch.cuda.synchronize()
    assert y.shape == (hb, 2, wb, 6) and y.dtype == torch.uint16
    codes = y_r.to(torch.int32)
    d = (y.to(torch.int32) - codes).abs()
    assert int(codes.max()) == 65535 and int(codes.min()) == 0
    if dtype == "f32":
        assert int(d.max()) <= 1, int(d.max())
    else:
        tol = int(2 * float(wlast.float().abs().max()) * 2.0 ** -6 * 65535) + 1
        assert int(d.max()) <= tol and float((d > 1).float().mean()) <= 0.02, (int(d.max()), tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(36, 50, 3), (2, 7, 129, 3)])
def test_colorimetric_matches_plain(dev, dtype, shape):
    """The kernel's powf against torch.pow on the card: ≤ 2 u16 codes, equal
    at 0 and 1; another peak and gamma are arguments, not constants."""
    from hdrtv_tpu_torch.ops.pack import colorimetric_pq_pack, colorimetric_pq_pack_ref

    v = np.random.RandomState(len(shape)).uniform(-0.1, 1.1, shape).astype(np.float32)
    v.reshape(-1, 3)[:2] = [[0, 0, 0], [1, 1, 1]]
    x = _t(v, dev, dtype)
    for kwargs in ({}, {"peak_nits": 600.0, "gamma": 2.2}):
        before = native.launch_counts["colorimetric"]
        u = colorimetric_pq_pack(x, **kwargs)
        assert native.launch_counts["colorimetric"] == before + 1
        u_r = colorimetric_pq_pack_ref(x, **kwargs)
        torch.cuda.synchronize()
        assert u.shape == x.shape and u.dtype == torch.uint16
        d = (u.to(torch.int32) - u_r.to(torch.int32)).abs()
        assert int(d.max()) <= 2, int(d.max())
        assert torch.equal(u.reshape(-1, 3)[:2], u_r.reshape(-1, 3)[:2])
        assert int(u_r.to(torch.int32).max()) > 40000 and int(u.reshape(-1)[0]) == 0


@pytest.mark.parametrize("precision,h,w", [("fp32", 64, 96), ("fp16", 56, 80), ("fp16", 64, 128)])
def test_hg_frame_matches_cpu(dev, monkeypatch, tmp_path, precision, h, w):
    """One HG frame (a synthetic nf = 16 generator on the real base model) on
    the card against the same processor on the CPU, and that it is the
    two-stage HG program: hg_tail launches once and pack_rgb48 not at all.
    Pixels whose base max-RGB lies near the mask's threshold (0.775) may flip
    between the two and are counted apart; the rest is bounded in fp32 as the
    no-HG frames are (4 codes) and in bf16 by twice what was seen (max 455,
    mean 27.8 codes at 56×80: the generator's bf16 convs spread the base
    model's flipped roundings): max 1024, mean 56."""
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch
    from hdrtv_tpu_torch.tools.synth_hg import BASE_WEIGHTS, write_synth_hg

    monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    monkeypatch.delenv("HDRTV_HG_TAIL", raising=False)
    path = write_synth_hg(str(tmp_path / "hg16.npz"), nf=16, seed=1)
    rng = np.random.RandomState(h)
    blocks = np.kron(rng.rand(h // 8, w // 8, 1), np.ones((8, 8, 3))) * 420
    frame = np.clip(blocks + rng.randn(h, w, 3) * 10, 0, 255).astype(np.uint8)
    native.reset_launch_counts()
    gpu = HDRTVNetTorch(path, precision=precision).process_rgb48(frame).astype(np.int64)
    counts = dict(native.launch_counts)
    assert (counts["hg_tail"], counts["pack_rgb48"], counts["colorimetric"]) == (1, 0, 0), counts
    cpu = HDRTVNetTorch(path, precision=precision, device="cpu").process_rgb48(frame).astype(np.int64)
    base = HDRTVNetTorch(BASE_WEIGHTS, precision=precision, device="cpu").process_rgb48(frame)
    m = base.astype(np.float32).max(axis=-1) / 65535.0
    margin = 2e-4 if precision == "fp32" else 0.02
    near = np.abs(m - 0.775) <= margin
    d = np.abs(gpu - cpu).max(axis=-1)
    assert 0.1 < (m > 0.775).mean() < 0.9 and near.mean() <= 0.15
    assert (gpu != base).any(axis=-1).mean() > 0.05  # the generator changed the highlights
    if precision == "fp32":
        assert d[~near].max() <= 4, int(d[~near].max())
    else:
        assert d[~near].max() <= 1024 and d[~near].mean() <= 56, (int(d[~near].max()), float(d[~near].mean()))


def test_pack_rgb48_bf16_matches_plain_exactly(dev):
    from hdrtv_tpu_torch.ops.pack import pack_rgb48, pack_rgb48_ref

    v = np.random.RandomState(4).uniform(-0.5, 1.5, (36, 50, 3)).astype(np.float32)
    x = _t(v, dev, "bf16")
    u = pack_rgb48(x)
    assert u.dtype == torch.uint16 and u.shape == x.shape
    np.testing.assert_array_equal(u.cpu().numpy(), pack_rgb48_ref(x.cpu()).numpy())


def test_bf16_frame_matches_cpu(dev, monkeypatch):
    """The bf16 frame program without the megakernels (HDRTV_MEGAKERNEL=0) on
    the card against the same processor on the CPU (the plain versions), one
    seeded 64×128 frame: a flipped rounding is 256 codes near full scale, and
    flips spread through the network, so the bound is two steps at the top of
    the range and a small mean."""
    import os

    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    monkeypatch.setenv("HDRTV_MEGAKERNEL", "0")
    weights = os.path.join(os.path.dirname(__file__), "..", "weights", "hr_fp32.npz")
    frame = (np.random.RandomState(64).rand(64, 128, 3) * 255).astype(np.uint8)
    gpu = HDRTVNetTorch(weights).process_rgb48(frame).astype(np.int64)
    cpu = HDRTVNetTorch(weights, device="cpu").process_rgb48(frame).astype(np.int64)
    d = np.abs(gpu - cpu)
    assert d.max() <= 512 and d.mean() <= 24, (int(d.max()), float(d.mean()))


def test_pack_rgb48_matches_plain_exactly(dev):
    from hdrtv_tpu_torch.ops.pack import pack_rgb48, pack_rgb48_ref

    rng = np.random.RandomState(3)
    v = rng.uniform(-0.5, 1.5, (36, 50, 3)).astype(np.float32)
    # the +0.5 rounding boundary: k/65535 lands within an ulp of it
    k = np.arange(v.size, dtype=np.float64) % 65536
    v.reshape(-1)[::7] = ((k[::7] + 0.5) / 65535.0).astype(np.float32)
    x = _t(v, dev)
    u = pack_rgb48(x)
    assert u.dtype == torch.uint16 and u.shape == x.shape
    got = u.cpu().numpy()
    want = pack_rgb48_ref(x.cpu()).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrappers_reject_bad_cuda_inputs(dev):
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3

    x = torch.zeros(4, 4, 128, device=dev, dtype=torch.float64)
    w = torch.zeros(3, 3, 128, 128, device=dev)
    b = torch.zeros(128, device=dev)
    with pytest.raises(ValueError):
        fused_block_conv3(x, w, b)
    with pytest.raises(ValueError):
        fused_block_conv3(x.float().cpu(), w, b)


# ---------------------------------------------------------------------------
# Native int8 (W8A8) bodies: block_conv3_w8a8, sft_conv3_w8a8, resblock_w8a8,
# tail_w8a8 against their plain versions, symmetric and asymmetric.
# ---------------------------------------------------------------------------


def _qlayer(rng, dev, c, co, t_range, asym, ps=False):
    """A native-int8 s2d conv layer on the card: natural weights quantized per
    output channel and s2d-transformed; the activation scale (and zero, when
    ``asym``) calibrated on ``t_range``. Returns (float weight, bias, QArgs)."""
    from hdrtv_tpu_torch.models.s2d import b_s2d, w_ps_permute, w_s2d_s1_ps
    from hdrtv_tpu_torch.ops.w8a8 import pack_qargs
    from hdrtv_tpu_torch.quant.int8 import quantize_weight

    wq, ws = quantize_weight(rng.randn(3, 3, c // 4, co // 4).astype(np.float32) * 0.05)
    if ps:
        tq, tsc = w_s2d_s1_ps(wq), np.tile(w_ps_permute(ws.reshape(1, 1, 1, -1))[0, 0, 0], 4)
    else:
        tq, tsc = w_s2d_s1(wq), b_s2d(ws)
    lo, hi = t_range
    s, z = ((hi - lo) / 255.0, lo) if asym else (max(abs(lo), abs(hi)) / 127.0, None)
    b = (rng.randn(co) * 0.1).astype(np.float32)
    return _t(tq.astype(np.float32) * tsc, dev), _t(b, dev), pack_qargs(tq, tsc, s, z, b, dev)


def _q_close(y, y_ref, qa, dtype, *, share, flips=2):
    """Equal but where a code of t flipped (t's scale and shift are sums
    taken in another order than the plain version's, so t can differ in its
    last bit): each output within ``flips`` flipped codes' worth (127·yscale
    each) plus, in bf16, one step of its rounding; at most ``share`` of the
    outputs differ at all (sft_conv3 f32 at 9×15 showed 1.7%: at these
    shapes a flip is a large share)."""
    torch.cuda.synchronize()
    assert y.dtype == y_ref.dtype and y.shape == y_ref.shape
    err = (y.float() - y_ref.float()).abs()
    bound = flips * 127.0 * float(qa.yscale.max())
    if dtype == "bf16":
        bound = bound + 2.0 ** -7 * y_ref.float().abs().clamp_min(1.0)
    assert bool((err <= bound).all()), float(err.max())
    assert float((err > 0).float().mean()) <= share, float((err > 0).float().mean())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("hb,wb,co,relu,skip", [(12, 20, 128, True, False), (9, 14, 512, True, False),
                                               (9, 15, 128, False, True)])
def test_block_conv3_w8a8_matches_plain(dev, dtype, asym, hb, wb, co, relu, skip):
    """The same codes (IEEE division, round half to even) and the exact int32
    sum, rescaled and biased with separately rounded operations on both
    sides: bit for bit, ragged tiles and masked output rows included."""
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3, fused_block_conv3_q_ref

    rng = np.random.RandomState(hb * wb + co + asym)
    c = 128
    x = _t(rng.rand(hb, wb, c) * 1.2 - 0.1, dev, dtype)
    w, b, qa = _qlayer(rng, dev, c, co, (-0.1, 1.0), asym, ps=co == 512)
    sk = _t(rng.rand(hb, wb, co), dev, dtype) if skip else None
    before = native.launch_counts["block_conv3_w8a8"], native.launch_counts["block_conv3"]
    y = fused_block_conv3(x, w.to(x.dtype), b, relu=relu, skip=sk, qargs=qa)
    assert (native.launch_counts["block_conv3_w8a8"], native.launch_counts["block_conv3"]) == (before[0] + 1, before[1])
    y_r = fused_block_conv3_q_ref(x, qa, relu=relu, skip=sk)
    torch.cuda.synchronize()
    assert y.shape == (hb, wb, co) and torch.equal(y, y_r), _max_err(y, y_r)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("hb,wb,relu,skip", [(12, 20, True, False), (9, 15, False, True)])
def test_sft_conv3_w8a8_matches_plain(dev, dtype, asym, hb, wb, relu, skip):
    from hdrtv_tpu_torch.ops.megakernel import fused_sft_conv3_v2, fused_sft_conv3_v2_ref

    rng = np.random.RandomState(hb * wb + 2 * asym)
    c, cc = 128, 64
    x = _t(rng.rand(hb, wb, c) - 0.2, dev, dtype)
    cond = _t(rng.rand(hb, wb, cc), dev, dtype)
    sft = _sft4(rng, cc, c, dev, dtype)
    w, b, qa = _qlayer(rng, dev, c, c, (-0.6, 1.5), asym)
    sk = _t(rng.rand(hb, wb, c), dev, dtype) if skip else None
    before = native.launch_counts["sft_conv3_w8a8"]
    y = fused_sft_conv3_v2(x, cond, sft, w.to(x.dtype), b, relu=relu, skip=sk, qargs=qa)
    assert native.launch_counts["sft_conv3_w8a8"] == before + 1
    _q_close(y, fused_sft_conv3_v2_ref(x, cond, sft, w.to(x.dtype), b, relu=relu, skip=sk, qargs=qa), qa, dtype,
             share=0.04)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("hb,wb,second", [(12, 20, None), (9, 15, "x_add"), (10, 14, "up_coarse")])
def test_resblock_w8a8_matches_plain(dev, dtype, asym, hb, wb, second):
    """A flipped code of t1 moves h1 and so t2's codes around it: up to 8
    flipped codes' worth and 10% of the outputs."""
    from hdrtv_tpu_torch.ops.megakernel import fused_resblock, fused_resblock_ref

    rng = np.random.RandomState(hb * wb + 7 + asym)
    c, cc = 128, 64
    x = _t(rng.rand(hb, wb, c) - 0.2, dev, dtype)
    cond = _t(rng.rand(hb, wb, cc), dev, dtype)
    kw = {}
    if second == "x_add":
        kw[second] = _t(rng.rand(hb, wb, c) * 0.5, dev, dtype)
    elif second == "up_coarse":
        kw[second] = _t(rng.rand(hb // 2, wb // 2, 4 * c) * 0.5, dev, dtype)
    sft1, sft2 = _sft4(rng, cc, c, dev, dtype), _sft4(rng, cc, c, dev, dtype)
    w1, b1, q1 = _qlayer(rng, dev, c, c, (-0.6, 2.0), asym)
    w2, b2, q2 = _qlayer(rng, dev, c, c, (-0.2, 1.0), asym)
    args = (sft1, w1.to(x.dtype), b1, sft2, w2.to(x.dtype), b2)
    before = native.launch_counts["resblock_w8a8"]
    y = fused_resblock(x, cond, *args, qargs1=q1, qargs2=q2, **kw)
    assert native.launch_counts["resblock_w8a8"] == before + 1
    _q_close(y, fused_resblock_ref(x, cond, *args, qargs1=q1, qargs2=q2, **kw), q2, dtype, share=0.1, flips=8)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("hb,wb,coarse", [(12, 20, True), (9, 15, False), (8, 16, True)])
def test_tail_w8a8_matches_plain(dev, dtype, asym, hb, wb, coarse):
    """Packed: a flipped code of t moves h, and h's rounding, over a few
    outputs; conv_last (|w| ≲ 0.01) carries that into at most 16 codes, on
    at most 10% of them."""
    from hdrtv_tpu_torch.ops.megakernel import fused_tail, fused_tail_ref

    rng = np.random.RandomState(hb * wb + 19 + asym)
    c, cc = 128, 64
    s = _t(rng.rand(hb, wb, c) * 0.6, dev, dtype)
    up = _t(rng.rand(hb // 2, wb // 2, 4 * c) * 0.6, dev, dtype) if coarse else None
    cond1 = _t(rng.rand(hb, wb, cc), dev, dtype)
    skip = _t(rng.rand(hb, wb, 12), dev, dtype)
    w_hr, b_hr, qa = _qlayer(rng, dev, c, c, (-0.6, 2.0), asym)
    args = (_sft4(rng, cc, c, dev, dtype), w_hr.to(s.dtype), b_hr,
            _t(rng.randn(3, 3, c, 12) * 0.01, dev, dtype), _t(rng.randn(12) * 0.1, dev))
    before = native.launch_counts["tail_w8a8"], native.launch_counts["tail"]
    y = fused_tail(s, cond1, skip, *args, pack=True, up_coarse=up, qargs_hr=qa)
    assert (native.launch_counts["tail_w8a8"], native.launch_counts["tail"]) == (before[0] + 1, before[1])
    y_r = fused_tail_ref(s, cond1, skip, *args, pack=True, up_coarse=up, qargs_hr=qa)
    torch.cuda.synchronize()
    assert y.shape == (hb, 2, wb, 6) and y.dtype == torch.uint16
    d = (y.to(torch.int32) - y_r.to(torch.int32)).abs()
    assert int(d.max()) <= 16 and float((d > 0).float().mean()) <= 0.1, (int(d.max()), float((d > 0).float().mean()))


def test_int8_frame_matches_cpu(dev, monkeypatch):
    """The W8A8 checkpoint's default program on the card against the CPU
    (one seeded 64×128 frame): a code that flips on one side moves the
    cascade of int8 layers after it, so the bound is that of int8 against
    int8 on the CPU (tests/test_torch_int8.py), and the frames must differ
    from the float program's."""
    import os

    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    path = os.path.join(os.path.dirname(__file__), "fixtures", "hr_w8a8.npz")
    frame = (np.random.RandomState(64).rand(64, 128, 3) * 255).astype(np.uint8)
    native.reset_launch_counts()
    gpu = HDRTVNetTorch(path).process_rgb48(frame)
    assert native.launch_counts["tail_w8a8"] == 1 and native.launch_counts["tail"] == 0
    cpu = HDRTVNetTorch(path, device="cpu").process_rgb48(frame)
    d = np.abs(gpu.astype(np.int64) - cpu.astype(np.int64))
    mse = float(np.mean((d / 65535.0) ** 2))
    assert 10 * np.log10(1.0 / max(mse, 1e-20)) >= 36.9, float(d.mean())
