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
from hdrtv_tpu_torch.models.s2d import b_s2d, w_s2d_1x1, w_s2d_s1, w_s2d_s2
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


def _eager_frame(proc, frame):
    """One frame through the eager program, kernel by kernel, as (H, W, 3)
    u16 on the host: the launch counters see each of its launches once
    (process_rgb48 captures a CUDA graph at a signature's first frame, after
    an eager run, and replays it, which the counters do not see)."""
    h, w, _ = frame.shape
    return proc._hw3(proc._rgb48_eager(proc.put_frame(frame.reshape(h, w * 3))).cpu().numpy())


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
    from hdrtv_tpu_torch.ops.megakernel import fused_trunk3, fused_trunk3_ref, trunk3_pack, trunk3_pack_bf16

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
    packed = (trunk3_pack if dtype == "f32" else trunk3_pack_bf16)(blocks, w_up, b_up)
    assert torch.equal(fused_trunk3(fea3, cond4, blocks, w_up, b_up, packed=packed), y)


def _trunk3_bf16_args(rng, hb, wb, dev, conv2_zero=False):
    """trunk3's inputs at its natural widths (C 32, CC 16, Co 128) in bf16,
    contractive weights (see test_trunk3_matches_plain)."""
    cin, cc, co = 32, 16, 128
    fea3 = _t(rng.rand(hb, wb, cin) - 0.2, dev, "bf16")
    cond4 = _t(rng.rand(hb, wb, cc) - 0.3, dev, "bf16")
    blocks = []
    for _ in range(4):
        w2 = np.zeros((3, 3, cin, cin)) if conv2_zero else rng.randn(3, 3, cin, cin) * 0.03
        blocks.append((_sft4(rng, cc, cin, dev, "bf16", 0.05),
                       _t(rng.randn(3, 3, cin, cin) * 0.03, dev, "bf16"), _t(rng.randn(cin) * 0.1, dev),
                       _sft4(rng, cc, cin, dev, "bf16", 0.05),
                       _t(w2, dev, "bf16"), _t(rng.rand(cin) * 0.5 if conv2_zero else rng.randn(cin) * 0.1, dev)))
    return fea3, cond4, blocks, _t(rng.randn(3, 3, cin, co) * 0.03, dev, "bf16"), _t(rng.randn(co) * 0.1, dev)


# The share bound per shape, from hdrtv_tpu_torch/tools/trunk3_flips.py
# (--draws tiles --seeds test) on an H100 at each case's seed: the FMA
# instance this one replaced and this one put 2.7% and 1.4% of the values
# apart at 135 × 240, 5.8% and 5.8% at 5 × 7 (there the plain version's own
# distance from a float64-summed witness, from which this kernel is 0), 0
# and 0 at 1 × 3. A tile whose sums truncate reads 13.9% at 5 × 7.
@pytest.mark.parametrize("hb,wb,flips", [(135, 240, 0.05), (5, 7, 0.08), (1, 3, 0.02)])
def test_trunk3_bf16_on_hopper_tiles_matches_plain(dev, hb, wb, flips):
    """trunk3's bf16 instance on the Hopper tiles (SFT passes on the row
    tile over natural rows, convs on the conv tile with the dense table):
    the 1080p shape (135 odd rows, 240 columns: not multiples of the conv
    tile's 4 × 64), a ragged one and a tiny one, one launch counted (27 × 16
    is test_trunk3_matches_plain's). Every value within one bf16 step of
    the plain version (a rounding that flips moves a value by one step; the
    chain's gain < 1 keeps a flip from growing), and the share of values
    that differ at all within its bound: on a small frame one flip early in
    the 9-conv chain reaches every output, so the bound is set per shape
    from readings of the seed."""
    from hdrtv_tpu_torch.ops.megakernel import fused_trunk3, fused_trunk3_ref

    args = _trunk3_bf16_args(np.random.RandomState(hb * wb + 37), hb, wb, dev)
    before = native.launch_counts["trunk3"]
    y = fused_trunk3(*args)
    assert native.launch_counts["trunk3"] == before + 1
    assert y.shape == (hb, wb, 128)
    _close(y, fused_trunk3_ref(*args), "bf16", steps=1, flips=flips)


def test_conv_tile_chunk_sums_round_to_nearest(dev):
    """The conv tile's 32-wide instances (the convs of trunk3, sft_conv3 and
    resblock, whose rounded outputs feed further convs) add each chunk's
    tensor-core sum in fp32 registers: their bf16 outputs round apart from
    those of a float64-summed conv about as often as cuDNN's fp32 conv does
    (one tensor-core sum over the whole K, which truncates at each step, did
    so 1.4–2.2 times as often: hdrtv_tpu_torch/tools/trunk3_flips.py --conv
    on an H100, 104–158 values of 1036800 against cuDNN's 56–83 at this
    shape; chunk sums 64–70), and never by more than one step."""
    import torch.nn.functional as F

    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3, fused_block_conv3_ref

    rng = np.random.RandomState(7)
    hb, wb, c = 135, 240, 32
    x = _t(np.maximum(rng.rand(hb, wb, c) - 0.2, 0.0), dev, "bf16")
    w = _t(rng.randn(3, 3, c, c) * 0.03, dev, "bf16")
    b = _t(rng.randn(c) * 0.1, dev)
    y64 = F.conv2d(x.double().permute(2, 0, 1)[None], w.double().permute(3, 2, 0, 1), padding=1)[0]
    exact = (y64.permute(1, 2, 0) + b.double()).to(torch.bfloat16)
    y = fused_block_conv3(x, w, b, a_sub=0)
    plain = fused_block_conv3_ref(x, w, b)
    _close(y, exact, "bf16", steps=1, flips=1e-3)
    apart, apart_plain = int((y != exact).sum()), int((plain != exact).sum())
    assert apart <= 1.5 * apart_plain + 8, (apart, apart_plain)


@pytest.mark.parametrize("hb,wb", [(27, 16), (135, 240)])
def test_trunk3_bf16_stage_skip_rounds_twice(dev, hb, wb):
    """The fourth conv2 rounds x + conv2(t), then adds fea3 and rounds again
    (the TPU kernel stores x before the stage skip). With every conv2's
    weights zero the running x is round(x + b2) four times, and up_conv1 an
    identity on its first 32 channels (centre tap, bias 0, inputs ≥ 0) shows
    out = round(round(x + b2) + fea3) itself: bit for bit, and against one
    rounding of the three-way sum, which differs somewhere."""
    from hdrtv_tpu_torch.ops.megakernel import fused_trunk3, fused_trunk3_ref

    fea3, cond4, blocks, _, _ = _trunk3_bf16_args(np.random.RandomState(hb + wb), hb, wb, dev, conv2_zero=True)
    fea3 = (fea3.float().abs() * 4).to(torch.bfloat16)
    w_up = torch.zeros(3, 3, 32, 128, device=dev)
    w_up[1, 1, torch.arange(32), torch.arange(32)] = 1.0
    w_up, b_up = w_up.to(torch.bfloat16), torch.zeros(128, device=dev)
    y = fused_trunk3(fea3, cond4, blocks, w_up, b_up)
    x = fea3.float()
    for blk in blocks[:3]:
        x = (x + blk[5]).to(torch.bfloat16).float()
    x3 = x + blocks[3][5]
    want = (x3.to(torch.bfloat16).float() + fea3.float()).to(torch.bfloat16)
    once = (x3 + fea3.float()).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(y[..., :32], want)
    assert not torch.equal(once, want)
    assert torch.equal(y, fused_trunk3_ref(fea3, cond4, blocks, w_up, b_up))


def _s2d_weight(rng, tf, c, co, a_sub):
    """``a_sub`` s2d blocks (``tf`` of natural (c/4, co/(4·a_sub)) weights)
    side by side along Co; for a_sub = 0 a dense weight with no zeros, which
    only the dense product computes right."""
    if not a_sub:
        return rng.randn(3, 3, c, co).astype(np.float32) * 0.05 / 3
    return np.concatenate([tf(rng.randn(3, 3, c // 4, co // (4 * a_sub)).astype(np.float32) * 0.05)
                           for _ in range(a_sub)], axis=-1)


# The bf16 float form runs on the Hopper tile (csrc/conv3x3_sm90.cuh): dense
# (a_sub 0, here on s2d and on dense weights), and skipping the s2d zeros
# (a_sub 1, 2) with output sub-positions of 32, 64 and 128 channels (N tiles
# of 32, 64, 128), 64-channel slots, and pixel counts off the 128/256 tile.
@pytest.mark.parametrize("hb,wb,c,co,relu,skip,a_sub,weight", [
    (12, 20, 128, 128, True, False, 0, "s2d"), (9, 14, 128, 512, False, False, 0, "s2d"),
    (9, 14, 128, 128, False, True, 0, "s2d"), (7, 9, 128, 384, True, False, 0, "dense"),
    (12, 20, 128, 128, True, False, 1, "s2d"), (13, 21, 256, 256, False, True, 1, "s2d"),
    (9, 14, 128, 512, True, False, 1, "s2d"), (10, 12, 128, 512, False, False, 2, "s2d"),
])
def test_block_conv3_bf16_matches_plain(dev, hb, wb, c, co, relu, skip, a_sub, weight):
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3, fused_block_conv3_ref

    rng = np.random.RandomState(hb * wb + co + 1)
    x = _t(rng.rand(hb, wb, c) - 0.3, dev, "bf16")
    w = _t(_s2d_weight(rng, w_s2d_s1, c, co, a_sub) if weight == "dense" or a_sub else
           w_s2d_s1(rng.randn(3, 3, c // 4, co // 4).astype(np.float32) * 0.05), dev, "bf16")
    b = _t(rng.randn(co) * 0.1, dev)
    sk = _t(rng.rand(hb, wb, co), dev, "bf16") if skip else None
    before = native.launch_counts["block_conv3"]
    y = fused_block_conv3(x, w, b, relu=relu, skip=sk, a_sub=a_sub)
    assert native.launch_counts["block_conv3"] == before + 1
    _close(y, fused_block_conv3_ref(x, w, b, relu=relu, skip=sk), "bf16")


@pytest.mark.parametrize("hb,wb,cf,cin,ch0,co,act,a_sub,weight", [
    (12, 20, 128, None, 0, 128, "relu", 1, "s2d"), (8, 12, 768, 256, 256, 256, "lrelu", 1, "s2d"),
    (10, 14, 256, None, 0, 768, "lrelu", 3, "s2d"), (14, 26, 128, None, 0, 512, None, 1, "s2d"),
    (12, 20, 256, None, 0, 384, "relu", 0, "dense"), (6, 10, 768, 256, 512, 256, None, 0, "s2d"),
])
def test_down2_bf16_matches_plain(dev, hb, wb, cf, cin, ch0, co, act, a_sub, weight):
    from hdrtv_tpu_torch.ops.megakernel import fused_down2, fused_down2_ref

    rng = np.random.RandomState(hb + wb + cf + ch0 + 1)
    c = cin or cf
    x = _t(rng.rand(hb, wb, cf), dev, "bf16")
    w = _t(_s2d_weight(rng, w_s2d_s2, c, co, a_sub) if weight == "dense" or a_sub else
           w_s2d_s2(rng.randn(3, 3, c // 4, co // 4).astype(np.float32) * 0.05), dev, "bf16")
    b = _t(rng.randn(co) * 0.1, dev)
    _close(fused_down2(x, w, b, act=act, cin=cin, ch0=ch0, a_sub=a_sub),
           fused_down2_ref(x[..., ch0 : ch0 + c], w, b, act=act), "bf16")


# The fp32 float form with a_sub ≥ 1 runs the 3×TF32 tile (csrc/conv3x3_tf32x3.cuh):
# the bf16 cases' columns (co_nat 32, 64, 128: N tiles of 32 and 64; 32- and 64-channel
# slots; a_sub 1, 2; skip; ragged pixel counts), and pixel counts with more tiles than
# the card holds blocks, so that each block walks several and the ring wraps. a_sub = 0
# stays on the FMA tile of csrc/conv3x3.cuh: a dense weight, which only the dense
# product computes right. 1e-4, the fp32 contract: three TF32 products keep the
# operands to 2^-22.
@pytest.mark.parametrize("hb,wb,c,co,relu,skip,a_sub,weight", [
    (12, 20, 128, 128, True, False, 1, "s2d"), (13, 21, 256, 256, False, True, 1, "s2d"),
    (9, 14, 128, 512, True, False, 1, "s2d"), (10, 12, 128, 512, False, False, 2, "s2d"),
    (5, 7, 128, 128, False, True, 1, "s2d"), (150, 200, 128, 128, True, True, 1, "s2d"),
    (12, 20, 128, 128, True, False, 0, "dense"),
])
def test_block_conv3_tf32x3_matches_plain(dev, hb, wb, c, co, relu, skip, a_sub, weight):
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3, fused_block_conv3_ref, sm90_table

    rng = np.random.RandomState(hb * wb + co + 2)
    x = _t(rng.rand(hb, wb, c) - 0.3, dev)
    w = _t(_s2d_weight(rng, w_s2d_s1, c, co, a_sub), dev)
    b = _t(rng.randn(co) * 0.1, dev)
    sk = _t(rng.rand(hb, wb, co), dev) if skip else None
    assert (sm90_table("block_conv3", 1, a_sub, c, co, c, dtype=torch.float32)[0] is None) == (a_sub == 0)
    before = native.launch_counts["block_conv3"]
    y = fused_block_conv3(x, w, b, relu=relu, skip=sk, a_sub=a_sub)
    assert native.launch_counts["block_conv3"] == before + 1
    _close(y, fused_block_conv3_ref(x, w, b, relu=relu, skip=sk), "f32")


@pytest.mark.parametrize("hb,wb,cf,cin,ch0,co,act,a_sub,weight", [
    (12, 20, 128, None, 0, 128, "relu", 1, "s2d"), (8, 12, 768, 256, 256, 256, "lrelu", 1, "s2d"),
    (10, 14, 256, None, 0, 768, "lrelu", 3, "s2d"), (14, 26, 128, None, 0, 512, None, 1, "s2d"),
    (6, 10, 768, 256, 512, 256, None, 1, "s2d"), (180, 260, 256, None, 0, 768, "lrelu", 3, "s2d"),
    (12, 20, 256, None, 0, 384, "relu", 0, "dense"),
])
def test_down2_tf32x3_matches_plain(dev, hb, wb, cf, cin, ch0, co, act, a_sub, weight):
    from hdrtv_tpu_torch.ops.conv_kernels import sm90_table
    from hdrtv_tpu_torch.ops.megakernel import fused_down2, fused_down2_ref

    rng = np.random.RandomState(hb + wb + cf + ch0 + 2)
    c = cin or cf
    x = _t(rng.rand(hb, wb, cf), dev)
    w = _t(_s2d_weight(rng, w_s2d_s2, c, co, a_sub), dev)
    b = _t(rng.randn(co) * 0.1, dev)
    assert (sm90_table("down2", 2, a_sub, c, co, cf, ch0, dtype=torch.float32)[0] is None) == (a_sub == 0)
    before = native.launch_counts["down2"]
    y = fused_down2(x, w, b, act=act, cin=cin, ch0=ch0, a_sub=a_sub)
    assert native.launch_counts["down2"] == before + 1
    _close(y, fused_down2_ref(x[..., ch0 : ch0 + c], w, b, act=act), "f32")


def test_sm90_refusals_raise(dev):
    """With a_sub ≥ 1 a shape the Hopper tile (bf16) or its 3×TF32 sibling
    (fp32) refuses raises on the card; nothing falls back to the dense tile."""
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3
    from hdrtv_tpu_torch.ops.megakernel import fused_down2

    for dt in (torch.bfloat16, torch.float32):
        x = torch.zeros(4, 4, 64, device=dev, dtype=dt)  # 16-channel slots
        with pytest.raises(ValueError, match="Hopper tile"):
            fused_block_conv3(x, torch.zeros(3, 3, 64, 128, device=dev, dtype=dt), torch.zeros(128, device=dev),
                              a_sub=1)
        x = torch.zeros(4, 4, 128, device=dev, dtype=dt)  # 16-channel output sub-positions
        with pytest.raises(ValueError, match="Hopper tile"):
            fused_down2(x, torch.zeros(3, 3, 128, 64, device=dev, dtype=dt), torch.zeros(64, device=dev), a_sub=1)
    # fp32: 36 chunks a list, whose split weights do not fit in shared memory
    x = torch.zeros(4, 4, 512, device=dev)
    with pytest.raises(ValueError, match="3×TF32 Hopper tile"):
        fused_block_conv3(x, torch.zeros(3, 3, 512, 512, device=dev), torch.zeros(512, device=dev), a_sub=1)


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


@pytest.mark.parametrize("hb,wb,cf,ch0", [(9, 15, 768, 0), (6, 10, 768, 512), (5, 7, 256, 0)])
def test_mix_chain_s2d_matches_plain(dev, hb, wb, cf, ch0):
    """bf16, s2d=True: the CondNet2 tail (natural 64 → 64 lrelu → 16, weights
    w_s2d_1x1, biases b_s2d) on the row tile of csrc/chain_sm90.cuh, reading
    the window [ch0, ch0 + 256) in place (pixels cf apart; ragged row
    tiles), against the plain s2d form: one bf16 step (the middle value is
    rounded at the same place)."""
    from hdrtv_tpu_torch.ops.megakernel import fused_mix_chain, fused_mix_chain_ref

    rng = np.random.RandomState(hb * wb + ch0)
    x = _t(rng.rand(hb, wb, cf) - 0.3, dev, "bf16")
    steps = [(_t(w_s2d_1x1(rng.randn(1, 1, ci, co) * 0.1)[0, 0], dev, "bf16"), _t(b_s2d(rng.randn(co) * 0.1), dev),
              act) for ci, co, act in ((64, 64, "lrelu"), (64, 16, None))]
    before = native.launch_counts["mix_chain"]
    y = fused_mix_chain(x, steps, cin=256, ch0=ch0, s2d=True)
    assert native.launch_counts["mix_chain"] == before + 1
    _close(y, fused_mix_chain_ref(x[..., ch0 : ch0 + 256], steps, s2d=True), "bf16")


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


def _head_s2d_args(rng, dev, c_nat=(3, 64, 64), co_nat=(32, 64)):
    """mods and the head's parameters in their s2d forms (bf16 weights),
    natural AGCM widths c_nat and input-conv widths co_nat; mods drawn
    whole (the s2d form reads each row's sub-position's lanes)."""
    f = np.float32
    c, c1, c2 = c_nat
    w_in = np.concatenate([w_s2d_s1(rng.randn(3, 3, c, co).astype(f) * 0.1) for co in co_nat], axis=-1)
    return (_t(rng.randn(6, 4 * max(c1, c2)) * 0.1, dev),
            _t(w_s2d_1x1(rng.randn(1, 1, c, c1).astype(f) * 0.2)[0, 0], dev, "bf16"),
            _t(b_s2d(rng.randn(c1).astype(f) * 0.1), dev),
            _t(w_s2d_1x1(rng.randn(1, 1, c1, c2).astype(f) * 0.1)[0, 0], dev, "bf16"),
            _t(b_s2d(rng.randn(c2).astype(f) * 0.1), dev),
            _t(w_s2d_1x1(rng.randn(1, 1, c2, c).astype(f) * 0.1)[0, 0], dev, "bf16"),
            _t(b_s2d(rng.randn(c).astype(f) * 0.1), dev),
            _t(w_in, dev, "bf16"),
            _t(np.concatenate([b_s2d(rng.randn(co).astype(f) * 0.1) for co in co_nat]), dev))


@pytest.mark.parametrize("frame", ["pairs", "u8", "float", "pairs_bgr"])
@pytest.mark.parametrize("hb,wb", [(12, 20), (9, 15), (5, 7), (1, 64), (8, 16)])
def test_agcm_head_s2d_matches_plain(dev, hb, wb, frame):
    """agcm_head's s2d form in bf16: the AGCM pass on the row tile, the
    input conv on its wgmma tile over the slots; ragged 64-pixel tiles (a
    row shorter than a tile, 20 = 64 − 44 ...), u8 pair planes, u8 s2d and
    the frame in bf16, and BGR (aw1 with its rows permuted, as the program
    passes it, with its own pack). Against the plain version's s2d form, two
    steps on c0 and fea as the dense form; the pack passed or built gives the
    same bytes."""
    from hdrtv_tpu_torch.ops.megakernel import agcm_head_pack_s2d, fused_agcm_head, fused_agcm_head_ref

    rng = np.random.RandomState(hb * wb + 41)
    args = list(_head_s2d_args(rng, dev))
    if frame == "pairs_bgr":
        perm = torch.tensor([(k // 3) * 3 + 2 - (k % 3) for k in range(12)], device=dev)
        args[1] = args[1][perm].contiguous()
    if frame == "float":
        xs, scale = _t(rng.rand(hb, wb, 12), dev, "bf16"), 1.0
    else:
        shape = (hb, wb, 12) if frame == "u8" else (hb, 2, wb, 6)
        xs, scale = torch.as_tensor((rng.rand(*shape) * 255).astype(np.uint8), device=dev), 1.0 / 255.0
    before = native.launch_counts["agcm_head"]
    got = fused_agcm_head(xs, *args, n_first=128, scale=scale, s2d=True)
    assert native.launch_counts["agcm_head"] == before + 1
    want = fused_agcm_head_ref(xs, *args, n_first=128, scale=scale, s2d=True)
    for y, y_r, shape in zip(got, want, ((hb, wb, 128), (hb, wb, 256), (hb, wb, 12)), strict=True):
        assert y.shape == shape
        _close(y, y_r, "bf16", steps=2, flips=0.05)
    packed_s2d = agcm_head_pack_s2d(args[1], args[3], args[5], args[7], args[8], n_first=128)
    again = fused_agcm_head(xs, *args, n_first=128, scale=scale, s2d=True, packed_s2d=packed_s2d)
    assert all(torch.equal(a, b) for a, b in zip(again, got, strict=True))


def test_new_hopper_instances_refuse_other_widths(dev):
    """agcm_head's s2d form in bf16 at natural widths it is not built for
    (AGCM 3 → 32 → 64 → 3, or the input conv 3 → 64 ‖ 32), and trunk3's bf16
    instance at an output width its conv tile does not take, raise on the
    card; nothing falls back to the dense or FMA kernels."""
    from hdrtv_tpu_torch.ops.megakernel import fused_agcm_head, fused_trunk3

    rng = np.random.RandomState(43)
    xs = torch.as_tensor((rng.rand(4, 2, 8, 6) * 255).astype(np.uint8), device=dev)
    for c_nat, co_nat, n_first in (((3, 32, 64), (32, 64), 128), ((3, 64, 64), (64, 32), 256)):
        args = _head_s2d_args(rng, dev, c_nat, co_nat)
        with pytest.raises(ValueError, match="s2d head"):
            fused_agcm_head(xs, *args, n_first=n_first, scale=1.0 / 255.0, s2d=True)
    fea3, cond4, blocks, _, _ = _trunk3_bf16_args(rng, 6, 8, dev)
    with pytest.raises(ValueError, match="Hopper conv tile"):
        fused_trunk3(fea3, cond4, blocks, _t(rng.randn(3, 3, 32, 16) * 0.03, dev, "bf16"), torch.zeros(16, device=dev))


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


def _p11(rng, ci, co, dev, scale=0.1, dtype="bf16"):
    """A 1×1 conv as the s2d program has it: w_s2d_1x1 weight (bf16, or
    ``dtype``), b_s2d bias."""
    w = w_s2d_1x1(rng.randn(1, 1, ci, co).astype(np.float32) * scale)[0, 0]
    return _t(w, dev, dtype), _t(b_s2d(rng.randn(co).astype(np.float32) * 0.1), dev)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hb,wb", [(12, 20), (9, 15), (1, 7), (3, 5), (72, 128)])
def test_cond_chain_s2d_matches_plain(dev, dtype, hb, wb):
    """The Hopper row tile (csrc/chain_sm90.cuh) of cond_chain's s2d form,
    in fp32 its 3×TF32 instance (csrc/chain_tf32x3.cuh), natural widths 64 →
    64 ×4 → 16: 4·Hb·Wb rows, a whole number of 64-row tiles (12 × 20),
    ragged ones (9 × 15, 3 × 5), less than one tile (1 × 7), and several
    tiles per warpgroup (72 × 128). Against the plain version's s2d form:
    fp32 within ATOL, bf16 two steps as the dense chain (a flipped rounding
    of one step moves the next)."""
    from hdrtv_tpu_torch.ops.megakernel import fused_cond_chain, fused_cond_chain_ref

    rng = np.random.RandomState(hb * wb + 13)
    c0 = _t(rng.rand(hb, wb, 256) - 0.3, dev, dtype)
    weights = [_p11(rng, 64, n, dev, dtype=dtype) for n in (64, 64, 64, 64, 16)]
    before = native.launch_counts["cond_chain"]
    c, cond1 = fused_cond_chain(c0, weights, s2d=True)
    assert native.launch_counts["cond_chain"] == before + 1
    c_r, cond1_r = fused_cond_chain_ref(c0, weights, s2d=True)
    assert c.shape == (hb, wb, 256) and cond1.shape == (hb, wb, 64)
    _close(c, c_r, dtype, steps=2, flips=0.05)
    _close(cond1, cond1_r, dtype, steps=2, flips=0.05)


@pytest.mark.parametrize("hb,wb,coarse,pack", [
    (12, 20, True, True), (9, 15, False, True), (10, 14, True, False), (5, 7, False, False), (64, 96, True, True),
])
def test_tail_s2d_matches_plain(dev, hb, wb, coarse, pack):
    """The tail's s2d form in bf16: the SFT pass on the row tile, HR_conv2 on
    the Hopper conv tile over the s2d slot table, conv_last as before; tile
    edges of all three, both forms of s, packed and not. Against the plain
    version's s2d form, with test_tail_matches_plain's bounds."""
    from hdrtv_tpu_torch.ops.megakernel import fused_tail, fused_tail_ref

    rng = np.random.RandomState(hb * wb + 19)
    s = _t(rng.rand(hb, wb, 128) - 0.3, dev, "bf16")
    up = _t(rng.rand(hb // 2, wb // 2, 512) - 0.3, dev, "bf16") if coarse else None
    cond1 = _t(rng.rand(hb, wb, 64) - 0.3, dev, "bf16")
    skip = _t(rng.rand(hb, wb, 12), dev, "bf16")
    sft = [_p11(rng, ci, co, dev, 0.2) for ci, co in ((16, 16), (16, 32), (16, 16), (16, 32))]
    args = (sft, _t(w_s2d_s1(rng.randn(3, 3, 32, 32).astype(np.float32) * 0.04), dev, "bf16"),
            _t(b_s2d(rng.randn(32).astype(np.float32) * 0.1), dev),
            _t(w_s2d_s1(rng.randn(3, 3, 32, 3).astype(np.float32) * 0.02), dev, "bf16"),
            _t(b_s2d(rng.randn(3).astype(np.float32) * 0.1), dev))
    before = native.launch_counts["tail"]
    y = fused_tail(s, cond1, skip, *args, pack=pack, up_coarse=up, s2d=True)
    assert native.launch_counts["tail"] == before + 1
    y_r = fused_tail_ref(s, cond1, skip, *args, pack=pack, up_coarse=up, s2d=True)
    if not pack:
        assert y.shape == (hb, wb, 12)
        _close(y, y_r, "bf16", steps=2, flips=0.05)
        return
    torch.cuda.synchronize()
    assert y.shape == (hb, 2, wb, 6) and y.dtype == torch.uint16
    d = (y.to(torch.int32) - y_r.to(torch.int32)).abs()
    assert int(y_r.to(torch.int32).max()) > int(y_r.to(torch.int32).min())
    assert int(d.max()) <= 64 and float(d.float().mean()) < 1.0, (int(d.max()), float(d.float().mean()))


def test_s2d_row_tile_refuses_other_widths(dev):
    """s2d=True in bf16 (cond_chain in fp32 too) with natural widths the row
    tile is not built for raises on the card; nothing falls back to the
    dense kernels."""
    from hdrtv_tpu_torch.ops.megakernel import fused_cond_chain, fused_tail

    rng = np.random.RandomState(5)
    for dtype in DTYPES:
        c0 = _t(rng.rand(4, 4, 128), dev, dtype)
        with pytest.raises(ValueError, match="row tile"):
            fused_cond_chain(c0, [_p11(rng, 32, n, dev, dtype=dtype) for n in (32, 32, 32, 32, 16)], s2d=True)
    sft = [_p11(rng, ci, co, dev) for ci, co in ((16, 16), (16, 64), (16, 16), (16, 64))]
    z = torch.zeros
    with pytest.raises(ValueError, match="row tile"):
        fused_tail(_t(rng.rand(4, 4, 256), dev, "bf16"), _t(rng.rand(4, 4, 64), dev, "bf16"),
                   _t(rng.rand(4, 4, 12), dev, "bf16"), sft, z(3, 3, 256, 256, device=dev, dtype=torch.bfloat16),
                   z(256, device=dev), z(3, 3, 256, 12, device=dev, dtype=torch.bfloat16), z(12, device=dev),
                   s2d=True)


def _sft_s2d(rng, dev, scale=0.2, dtype="bf16"):
    """The four SFT 1×1s at the programs' natural widths (CC 16, C 32), s2d."""
    return [_p11(rng, ci, co, dev, scale, dtype) for ci, co in ((16, 16), (16, 32), (16, 16), (16, 32))]


def _conv_s2d(rng, dev, scale=0.05, dtype="bf16"):
    """A 3×3 trunk conv (32 → 32 natural) as the s2d program has it: w_s2d_s1 (bf16, or ``dtype``), b_s2d."""
    return (_t(w_s2d_s1(rng.randn(3, 3, 32, 32).astype(np.float32) * scale), dev, dtype),
            _t(b_s2d(rng.randn(32).astype(np.float32) * 0.1), dev))


@pytest.mark.parametrize("hb,wb,relu,skip", [
    (12, 20, True, False), (9, 15, False, True), (1, 7, True, False), (5, 7, False, True), (135, 240, True, False),
    (135, 240, False, True),
])
def test_sft_conv3_s2d_matches_plain(dev, hb, wb, relu, skip):
    """sft_conv3's s2d form in bf16: the SFT pass on the row tile, the conv on
    the Hopper conv tile over the s2d slot table, its epilogue adding bias and
    skip; whole, ragged and partial 64-row tiles, the L2 shape (135 odd rows,
    240 columns: not a multiple of the conv tile's 64). Against the plain
    version's s2d form, one bf16 step as the dense form."""
    from hdrtv_tpu_torch.ops.megakernel import fused_sft_conv3_v2, fused_sft_conv3_v2_ref

    rng = np.random.RandomState(hb * wb + 23)
    x = _t(rng.rand(hb, wb, 128) - 0.3, dev, "bf16")
    cond = _t(rng.rand(hb, wb, 64) - 0.3, dev, "bf16")
    sk = _t(rng.rand(hb, wb, 128), dev, "bf16") if skip else None
    args = (x, cond, _sft_s2d(rng, dev), *_conv_s2d(rng, dev))
    before = native.launch_counts["sft_conv3"]
    y = fused_sft_conv3_v2(*args, relu=relu, skip=sk, s2d=True)
    assert native.launch_counts["sft_conv3"] == before + 1
    assert y.shape == (hb, wb, 128)
    _close(y, fused_sft_conv3_v2_ref(*args, relu=relu, skip=sk, s2d=True), "bf16")


def _resblock_s2d_inputs(rng, hb, wb, second, dev):
    x = _t(rng.rand(hb, wb, 128) - 0.3, dev, "bf16")
    cond = _t(rng.rand(hb, wb, 64) - 0.3, dev, "bf16")
    kw = {}
    if second == "x_add":
        kw[second] = _t(rng.rand(hb, wb, 128) - 0.3, dev, "bf16")
    elif second == "up_coarse":
        kw[second] = _t(rng.rand(hb // 2, wb // 2, 512) - 0.3, dev, "bf16")
    return x, cond, kw


@pytest.mark.parametrize("hb,wb,second", [
    (12, 20, None), (9, 15, "x_add"), (10, 14, "up_coarse"), (5, 7, None), (3, 5, "x_add"), (2, 6, "up_coarse"),
    (64, 96, "up_coarse"), (135, 240, "x_add"),
])
def test_resblock_s2d_matches_plain(dev, hb, wb, second):
    """resblock's s2d form in bf16: SFT1 (with x_add or up_coarse summed on
    read and the sum written as the residual) and SFT2 (reading the fp32 h1)
    on the row tile, conv1 through the Hopper tile's fp32-output epilogue,
    conv2 with the residual; whole, ragged and partial tiles, odd shapes.
    Against the plain version's s2d form, two bf16 steps as the dense form."""
    from hdrtv_tpu_torch.ops.megakernel import fused_resblock, fused_resblock_ref

    rng = np.random.RandomState(hb * wb + 29)
    x, cond, kw = _resblock_s2d_inputs(rng, hb, wb, second, dev)
    args = (x, cond, _sft_s2d(rng, dev), *_conv_s2d(rng, dev), _sft_s2d(rng, dev), *_conv_s2d(rng, dev))
    before = native.launch_counts["resblock"]
    y = fused_resblock(*args, **kw, s2d=True)
    assert native.launch_counts["resblock"] == before + 1
    assert y.shape == (hb, wb, 128)
    _close(y, fused_resblock_ref(*args, **kw, s2d=True), "bf16", steps=2, flips=0.05)


@pytest.mark.parametrize("hb,wb,second", [(9, 15, "x_add"), (10, 14, "up_coarse"), (135, 240, "x_add")])
def test_resblock_s2d_residual_is_bit_exact(dev, hb, wb, second):
    """The rounded sum SFT1 writes (xsum) is the residual: with conv2's
    weight and bias zero the output is xsum itself, which must equal
    round(x + add) bit for bit, as in the plain version."""
    from hdrtv_tpu_torch.ops.megakernel import _d2s_fine, fused_resblock, fused_resblock_ref

    rng = np.random.RandomState(hb * wb + 31)
    x, cond, kw = _resblock_s2d_inputs(rng, hb, wb, second, dev)
    w0 = torch.zeros(3, 3, 128, 128, device=dev, dtype=torch.bfloat16)
    args = (x, cond, _sft_s2d(rng, dev), *_conv_s2d(rng, dev), _sft_s2d(rng, dev), w0,
            torch.zeros(128, device=dev))
    y = fused_resblock(*args, **kw, s2d=True)
    add = kw["x_add"] if second == "x_add" else _d2s_fine(kw["up_coarse"])
    torch.cuda.synchronize()
    assert torch.equal(y, (x.float() + add.float()).to(torch.bfloat16))
    assert torch.equal(y, fused_resblock_ref(*args, **kw, s2d=True))


def test_s2d_sft_forms_refuse_other_widths(dev):
    """sft_conv3 and resblock with s2d=True in bf16 at natural widths the row
    tile is not built for raise on the card; nothing falls back to the dense
    kernels."""
    from hdrtv_tpu_torch.ops.megakernel import fused_resblock, fused_sft_conv3_v2

    rng = np.random.RandomState(7)
    x = _t(rng.rand(4, 4, 256), dev, "bf16")
    cond = _t(rng.rand(4, 4, 64), dev, "bf16")
    sft = [_p11(rng, ci, co, dev) for ci, co in ((16, 16), (16, 64), (16, 16), (16, 64))]
    w = _t(w_s2d_s1(rng.randn(3, 3, 64, 64).astype(np.float32) * 0.05), dev, "bf16")
    b = torch.zeros(256, device=dev)
    with pytest.raises(ValueError, match="row tile"):
        fused_sft_conv3_v2(x, cond, sft, w, b, s2d=True)
    with pytest.raises(ValueError, match="row tile"):
        fused_resblock(x, cond, sft, w, b, sft, w, b, s2d=True)


def _kernel_launches(fn, attempts: int = 3) -> dict:
    """The kernels fn() launches, by name (torch.profiler), after a warm call.
    The profiler sometimes reports a session without some of its kernels: a
    session that shows fewer kernels than cudaLaunchKernel calls is profiled
    again, at most ``attempts`` times in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts = {e.key: e.count for e in prof.key_averages()}
        if sum(n for k, n in counts.items() if k.startswith("void ")) >= counts.get("cudaLaunchKernel", 0):
            break
    return counts


def _launched(counts: dict, sub: str) -> int:
    return sum(n for k, n in counts.items() if sub in k)


@pytest.mark.parametrize("hb,wb,relu,skip", [
    (12, 20, True, False), (9, 15, False, True), (1, 7, True, False), (5, 7, False, True), (135, 240, False, True),
    (540, 960, True, False),
])
def test_sft_conv3_f32_s2d_matches_plain(dev, hb, wb, relu, skip):
    """sft_conv3's fp32 s2d form: the SFT pass on the 3×TF32 row tile
    (csrc/sft_tf32x3.cuh), the conv on the 3×TF32 conv tile over the slot
    table, bias, skip and ReLU in its epilogue; whole, ragged and partial
    64-row tiles, the L2 shape and the L0 1080p shape. Against the plain
    version's s2d form within ATOL, one launch counted, the two tiles
    launched once each and no dense kernel."""
    from hdrtv_tpu_torch.ops.megakernel import fused_sft_conv3_v2, fused_sft_conv3_v2_ref

    rng = np.random.RandomState(hb * wb + 123)
    x = _t(rng.rand(hb, wb, 128) - 0.3, dev)
    cond = _t(rng.rand(hb, wb, 64) - 0.3, dev)
    sk = _t(rng.rand(hb, wb, 128), dev) if skip else None
    args = (x, cond, _sft_s2d(rng, dev, dtype="f32"), *_conv_s2d(rng, dev, dtype="f32"))
    before = native.launch_counts["sft_conv3"]
    y = fused_sft_conv3_v2(*args, relu=relu, skip=sk, s2d=True)
    assert native.launch_counts["sft_conv3"] == before + 1
    assert y.shape == (hb, wb, 128) and y.dtype == torch.float32
    _close(y, fused_sft_conv3_v2_ref(*args, relu=relu, skip=sk, s2d=True), "f32")
    counts = _kernel_launches(lambda: fused_sft_conv3_v2(*args, relu=relu, skip=sk, s2d=True))
    assert _launched(counts, "sft_tf32x3_kernel") == 1 and _launched(counts, "conv3x3_tf32x3_kernel") == 1, counts
    assert _launched(counts, "sft_kernel") == 0 and _launched(counts, "conv3x3_kernel") == 0, counts


@pytest.mark.parametrize("hb,wb,second", [
    (12, 20, None), (9, 15, "x_add"), (10, 14, "up_coarse"), (5, 7, None), (3, 5, "x_add"), (2, 6, "up_coarse"),
    (135, 240, "x_add"), (270, 480, "up_coarse"),
])
def test_resblock_f32_s2d_matches_plain(dev, hb, wb, second):
    """resblock's fp32 s2d form: SFT1 (x_add or up_coarse summed on read,
    the fp32 sum written as the residual) and SFT2 (on h1) on the 3×TF32 row
    tile, both convs on the 3×TF32 conv tile, conv2 adding the residual;
    ragged and partial tiles, the L2 shape and the L1 1080p shape. Against
    the plain version's s2d form within ATOL, two launches of each tile."""
    from hdrtv_tpu_torch.ops.megakernel import fused_resblock, fused_resblock_ref

    rng = np.random.RandomState(hb * wb + 129)
    x, cond, kw = _resblock_s2d_inputs(rng, hb, wb, second, dev)
    x, cond = x.float(), cond.float()
    kw = {k: v.float() for k, v in kw.items()}
    args = (x, cond, _sft_s2d(rng, dev, dtype="f32"), *_conv_s2d(rng, dev, dtype="f32"),
            _sft_s2d(rng, dev, dtype="f32"), *_conv_s2d(rng, dev, dtype="f32"))
    before = native.launch_counts["resblock"]
    y = fused_resblock(*args, **kw, s2d=True)
    assert native.launch_counts["resblock"] == before + 1
    assert y.shape == (hb, wb, 128) and y.dtype == torch.float32
    _close(y, fused_resblock_ref(*args, **kw, s2d=True), "f32")
    counts = _kernel_launches(lambda: fused_resblock(*args, **kw, s2d=True))
    assert _launched(counts, "sft_tf32x3_kernel") == 2 and _launched(counts, "conv3x3_tf32x3_kernel") == 2, counts
    assert _launched(counts, "sft_kernel") == 0 and _launched(counts, "conv3x3_kernel") == 0, counts


@pytest.mark.parametrize("hb,wb,second", [(9, 15, "x_add"), (10, 14, "up_coarse"), (270, 480, "up_coarse")])
def test_resblock_f32_s2d_residual_is_exact(dev, hb, wb, second):
    """The fp32 sum SFT1 writes (xsum) is the residual: with conv2's weight
    and bias zero the output is xsum itself, x + add in fp32 bit for bit,
    as in the plain version."""
    from hdrtv_tpu_torch.ops.megakernel import _d2s_fine, fused_resblock, fused_resblock_ref

    rng = np.random.RandomState(hb * wb + 131)
    x, cond, kw = _resblock_s2d_inputs(rng, hb, wb, second, dev)
    x, cond = x.float(), cond.float()
    kw = {k: v.float() for k, v in kw.items()}
    args = (x, cond, _sft_s2d(rng, dev, dtype="f32"), *_conv_s2d(rng, dev, dtype="f32"),
            _sft_s2d(rng, dev, dtype="f32"),
            torch.zeros(3, 3, 128, 128, device=dev), torch.zeros(128, device=dev))
    y = fused_resblock(*args, **kw, s2d=True)
    add = kw["x_add"] if second == "x_add" else _d2s_fine(kw["up_coarse"])
    torch.cuda.synchronize()
    assert torch.equal(y, x + add)
    assert torch.equal(y, fused_resblock_ref(*args, **kw, s2d=True))


def test_f32_s2d_sft_forms_refuse_other_widths(dev):
    """sft_conv3 and resblock with s2d=True in fp32 at natural widths the
    3×TF32 row tile is not built for raise on the card; nothing falls back to
    the dense kernels."""
    from hdrtv_tpu_torch.ops.megakernel import fused_resblock, fused_sft_conv3_v2

    rng = np.random.RandomState(71)
    x = _t(rng.rand(4, 4, 256), dev)
    cond = _t(rng.rand(4, 4, 64), dev)
    sft = [_p11(rng, ci, co, dev, dtype="f32") for ci, co in ((16, 16), (16, 64), (16, 16), (16, 64))]
    w = _t(w_s2d_s1(rng.randn(3, 3, 64, 64).astype(np.float32) * 0.05), dev)
    b = torch.zeros(256, device=dev)
    before = dict(native.launch_counts)
    with pytest.raises(ValueError, match="row tile"):
        fused_sft_conv3_v2(x, cond, sft, w, b, s2d=True)
    with pytest.raises(ValueError, match="row tile"):
        fused_resblock(x, cond, sft, w, b, sft, w, b, s2d=True)
    assert native.launch_counts == before


@pytest.mark.parametrize("kernel", ["sft_conv3_w8a8", "resblock_w8a8", "tail_w8a8"])
def test_f32_int8_sft_and_tail_run_the_q8_tiles_resblock_stays_dense(dev, kernel):
    """fp32 with s2d: the int8 bodies of sft_conv3 and the tail run the SFT
    pass's int8-output mode (csrc/sft_tf32x3.cuh sft_q8_f32_kernel) and the
    wgmma s8 tile's fp32-output instance, the tail's conv_last its fp32 tile
    (conv_last_tf32x3_kernel), and no dense kernel; resblock's int8 body
    keeps its dense kernels (pointwise.cuh's SFT pass, the mma.sync convs);
    each within its plain version's bounds."""
    from hdrtv_tpu_torch.ops.megakernel import (
        fused_resblock, fused_resblock_ref, fused_sft_conv3_v2, fused_sft_conv3_v2_ref, fused_tail, fused_tail_ref,
    )

    rng = np.random.RandomState(73)
    hb, wb = 12, 20
    x = _t(rng.rand(hb, wb, 128) - 0.2, dev)
    cond = _t(rng.rand(hb, wb, 64), dev)
    sft = _sft_s2d(rng, dev, 0.05, "f32")
    if kernel == "tail_w8a8":
        w_hr, b_hr, qa = _qlayer(rng, dev, 128, 128, (-0.6, 2.0), False)
        w_last = _t(w_s2d_s1(rng.randn(3, 3, 32, 3).astype(np.float32) * 0.01), dev)
        targs = (x, cond, _t(rng.rand(hb, wb, 12), dev), sft, w_hr, b_hr, w_last, _t(rng.randn(12) * 0.1, dev))

        def call():
            return fused_tail(*targs, pack=True, qargs_hr=qa, s2d=True)

        d = (call().to(torch.int32) - fused_tail_ref(*targs, pack=True, qargs_hr=qa, s2d=True).to(torch.int32)).abs()
        assert int(d.max()) <= 16 and float((d > 0).float().mean()) <= 0.1, (int(d.max()), float((d > 0).float().mean()))
    elif kernel == "sft_conv3_w8a8":
        w, b, qa = _qlayer(rng, dev, 128, 128, (-0.6, 1.5), False)

        def call():
            return fused_sft_conv3_v2(x, cond, sft, w, b, relu=True, qargs=qa, s2d=True)

        _q_close(call(), fused_sft_conv3_v2_ref(x, cond, sft, w, b, relu=True, qargs=qa, s2d=True), qa, "f32",
                 share=0.04)
    else:
        w1, b1, q1 = _qlayer(rng, dev, 128, 128, (-0.6, 2.0), False)
        w2, b2, q2 = _qlayer(rng, dev, 128, 128, (-0.2, 1.0), False)
        args = (x, cond, sft, w1, b1, _sft_s2d(rng, dev, 0.05, "f32"), w2, b2)

        def call():
            return fused_resblock(*args, qargs1=q1, qargs2=q2, s2d=True)

        _q_close(call(), fused_resblock_ref(*args, qargs1=q1, qargs2=q2, s2d=True), q2, "f32", share=0.1, flips=8)
    counts = _kernel_launches(call)
    assert _launched(counts, "sft_tf32x3_kernel") == 0, counts
    if kernel == "resblock_w8a8":
        assert _launched(counts, "sft_q8_f32_kernel") == 0 and _launched(counts, "sft_kernel") >= 1, counts
        return
    assert _launched(counts, "sft_q8_f32_kernel") == 1 and _launched(counts, "sft_kernel") == 0, counts
    assert _launched(counts, "conv3x3_s8_sm90_kernel<1, false, true, false>") == 1, counts
    assert _launched(counts, "conv3x3_s8_kernel") == 0 and _launched(counts, "conv_last_kernel") == 0, counts
    if kernel == "tail_w8a8":
        assert _launched(counts, "conv_last_tf32x3_kernel") == 1, counts


@pytest.mark.parametrize("hb,wb,coarse,asym", [
    (12, 20, False, False), (9, 15, False, True), (1, 7, False, False), (2, 70, True, True), (135, 240, False, True),
    (540, 960, True, False),
])
def test_f32_q8_sft_pass_codes_equal_plain(dev, hb, wb, coarse, asym):
    """The fp32 SFT pass's int8-output mode (sft_q8_f32_kernel), launched by
    fp32 sft_conv3_w8a8's s2d call with codes the test keeps: on whole,
    ragged and partial 64-row tiles, the L2 and the 1080p L0 shape, x alone
    or summed with the d2s of a coarse up tensor (the tail's input),
    symmetric and with a zero point, its codes equal the plain version's
    codes of the fp32 t bit for bit (FMA chains in the plain matmul's
    order, quantize_code_fast with its band fix-up); the s2d call's output
    equals the plain version's."""
    from hdrtv_tpu_torch.ops.megakernel import (
        _d2s_fine, _sft_hopper, _sft_t_rows, fused_sft_conv3_v2, fused_sft_conv3_v2_ref,
    )
    from hdrtv_tpu_torch.ops.w8a8 import _quantize_act

    rng = np.random.RandomState(hb * wb + 7 * asym)
    x = _t(rng.rand(hb, wb, 128) - 0.3, dev)
    if coarse:
        x = x + _d2s_fine(_t(rng.rand(hb // 2, wb // 2, 512) - 0.3, dev))
    cond = _t(rng.rand(hb, wb, 64) - 0.3, dev)
    sft = _sft_s2d(rng, dev, 0.05, "f32")
    t_r = _sft_t_rows(x, cond, sft, torch.float32)
    w, b, qa = _qlayer(rng, dev, 128, 128, (float(t_r.min()), float(t_r.max())), asym)
    hopper, table, per_list = _sft_hopper("sft_conv3", True, torch.float32, 64, 128, 128, quant=True)
    codes = torch.empty(hb, wb, 128, dtype=torch.int8, device=dev)
    y = torch.empty(hb, wb, 128, device=dev)
    native.launch("sft_conv3", torch.float32, x.data_ptr(), cond.data_ptr(),
                  native.pointer_array([p for pair in sft for p in pair]), w.data_ptr(), b.data_ptr(),
                  native.quant_params(qa), None, y.data_ptr(), codes.data_ptr(), hb, wb, 128, 64, 128, 1, hopper,
                  table, per_list, native.stream_of(x))
    torch.cuda.synchronize()
    assert torch.equal(codes, _quantize_act(t_r, qa))
    assert torch.equal(fused_sft_conv3_v2(x, cond, sft, w, b, relu=True, qargs=qa, s2d=True),
                       fused_sft_conv3_v2_ref(x, cond, sft, w, b, relu=True, qargs=qa, s2d=True))


def _tail_f32_s2d_args(rng, dev, hb, wb, coarse):
    """The fp32 s2d tail's inputs at the programs' widths: s (+ up_coarse),
    cond1, skip, the SFT, HR_conv2 and conv_last in their s2d forms."""
    s = _t(rng.rand(hb, wb, 128) - 0.3, dev)
    up = _t(rng.rand(hb // 2, wb // 2, 512) - 0.3, dev) if coarse else None
    args = (s, _t(rng.rand(hb, wb, 64) - 0.3, dev), _t(rng.rand(hb, wb, 12) * 1.1 - 0.05, dev),
            _sft_s2d(rng, dev, 0.05, "f32"), *_conv_s2d(rng, dev, dtype="f32"),
            _t(w_s2d_s1(rng.randn(3, 3, 32, 3).astype(np.float32) * 0.03), dev),
            _t(b_s2d(rng.randn(3).astype(np.float32) * 0.02), dev))
    return args, up


@pytest.mark.parametrize("hb,wb,coarse,pack", [
    (12, 20, True, True), (9, 15, False, True), (10, 14, True, False), (5, 7, False, False), (1, 64, False, True),
    (2, 70, True, True), (66, 130, True, False), (540, 960, True, True),
])
def test_tail_f32_s2d_matches_plain(dev, hb, wb, coarse, pack):
    """The fp32 s2d tail: the SFT pass on the 3×TF32 row tile, HR_conv2 on
    the 3×TF32 conv tile over the slot table, conv_last on its fp32 tile
    (csrc/conv_last.cuh conv_last_tf32x3_kernel); images narrower than a
    band (64 columns) or a row tile, bands cut at the edge (70, 130), a
    single row, and the 1080p shape. Against the plain version's s2d form:
    packed within 1 code, unpacked within ATOL; one launch counted, the three
    tiles once each and no dense kernel."""
    from hdrtv_tpu_torch.ops.megakernel import fused_tail, fused_tail_ref

    rng = np.random.RandomState(hb * wb + 291)
    args, up = _tail_f32_s2d_args(rng, dev, hb, wb, coarse)
    before = native.launch_counts["tail"], native.launch_counts["tail_w8a8"]
    y = fused_tail(*args, pack=pack, up_coarse=up, s2d=True)
    assert (native.launch_counts["tail"], native.launch_counts["tail_w8a8"]) == (before[0] + 1, before[1])
    y_r = fused_tail_ref(*args, pack=pack, up_coarse=up, s2d=True)
    if pack:
        torch.cuda.synchronize()
        assert y.shape == (hb, 2, wb, 6) and y.dtype == torch.uint16
        assert int(y_r.to(torch.int32).max()) > int(y_r.to(torch.int32).min())
        assert int((y.to(torch.int32) - y_r.to(torch.int32)).abs().max()) <= 1
    else:
        assert y.shape == (hb, wb, 12)
        _close(y, y_r, "f32")
    counts = _kernel_launches(lambda: fused_tail(*args, pack=pack, up_coarse=up, s2d=True))
    for tile in ("sft_tf32x3_kernel", "conv3x3_tf32x3_kernel", "conv_last_tf32x3_kernel"):
        assert _launched(counts, tile) == 1, (tile, counts)
    for dense in ("sft_kernel", "conv3x3_kernel", "conv3x3_mma_kernel", "conv_last_kernel"):
        assert _launched(counts, dense) == 0, (dense, counts)


def _head_f32_s2d_args(rng, dev):
    """_head_s2d_args's parameters in fp32 (weights and all)."""
    return tuple(a.float() for a in _head_s2d_args(rng, dev))


@pytest.mark.parametrize("frame", ["pairs", "u8", "float", "pairs_bgr"])
@pytest.mark.parametrize("hb,wb", [(12, 20), (9, 15), (5, 7), (1, 64), (3, 130), (540, 960)])
def test_agcm_head_f32_s2d_matches_plain(dev, hb, wb, frame):
    """agcm_head's fp32 s2d form: the AGCM pass on its 3×TF32 row tile
    (csrc/agcm_tf32x3.cuh agcm_tf32x3_kernel), the input conv on its
    3×TF32 tile (csrc/agcm_head.cu in_conv_tf32x3_kernel); ragged 64-pixel
    tiles, a row shorter than one and rows of three (130), u8 pair planes,
    u8 s2d, the frame in fp32 and BGR (aw1's rows permuted, its own pack),
    and the 1080p frame. Against the plain version's s2d form within ATOL;
    the pack passed or built gives the same bytes; both tiles launched once,
    no dense kernel."""
    from hdrtv_tpu_torch.ops.megakernel import agcm_head_pack_s2d, fused_agcm_head, fused_agcm_head_ref

    if hb == 540 and frame != "pairs":
        pytest.skip("the 1080p frame as the programs pass it: u8 pair planes")
    rng = np.random.RandomState(hb * wb + 293)
    args = list(_head_f32_s2d_args(rng, dev))
    if frame == "pairs_bgr":
        perm = torch.tensor([(k // 3) * 3 + 2 - (k % 3) for k in range(12)], device=dev)
        args[1] = args[1][perm].contiguous()
    if frame == "float":
        xs, scale = _t(rng.rand(hb, wb, 12), dev), 1.0
    else:
        shape = (hb, wb, 12) if frame == "u8" else (hb, 2, wb, 6)
        xs, scale = torch.as_tensor((rng.rand(*shape) * 255).astype(np.uint8), device=dev), 1.0 / 255.0
    before = native.launch_counts["agcm_head"]
    got = fused_agcm_head(xs, *args, n_first=128, scale=scale, s2d=True)
    assert native.launch_counts["agcm_head"] == before + 1
    want = fused_agcm_head_ref(xs, *args, n_first=128, scale=scale, s2d=True)
    for y, y_r, shape in zip(got, want, ((hb, wb, 128), (hb, wb, 256), (hb, wb, 12)), strict=True):
        assert y.shape == shape
        _close(y, y_r, "f32")
    packed_s2d = agcm_head_pack_s2d(args[1], args[3], args[5], args[7], args[8], n_first=128)
    again = fused_agcm_head(xs, *args, n_first=128, scale=scale, s2d=True, packed_s2d=packed_s2d)
    assert all(torch.equal(a, b) for a, b in zip(again, got, strict=True))
    counts = _kernel_launches(lambda: fused_agcm_head(xs, *args, n_first=128, scale=scale, s2d=True,
                                                      packed_s2d=packed_s2d))
    assert _launched(counts, "agcm_tf32x3_kernel") == 1 and _launched(counts, "in_conv_tf32x3_kernel") == 1, counts
    assert _launched(counts, "agcm_kernel") == 0 and _launched(counts, "in_conv_kernel") == 0, counts


def test_f32_s2d_tail_and_head_refuse_other_widths(dev):
    """The fp32 s2d tail with a conv_last of another width (Cl 8), and the
    fp32 s2d head at natural widths it is not built for (AGCM 3 → 32 → 64
    → 3, or the input conv 3 → 64 ‖ 32), raise on the card; nothing falls
    back to the dense kernels."""
    from hdrtv_tpu_torch.ops.megakernel import fused_agcm_head, fused_tail

    rng = np.random.RandomState(295)
    args, _ = _tail_f32_s2d_args(rng, dev, 4, 6, False)
    narrow = _t(w_s2d_s1(rng.randn(3, 3, 32, 2).astype(np.float32) * 0.03), dev)
    before = dict(native.launch_counts)
    with pytest.raises(ValueError, match="conv_last's s2d tile takes"):
        fused_tail(args[0], args[1], _t(rng.rand(4, 6, 8), dev), *args[3:6], narrow, torch.zeros(8, device=dev),
                   s2d=True)
    xs = torch.as_tensor((rng.rand(4, 2, 6, 6) * 255).astype(np.uint8), device=dev)
    for c_nat, co_nat in (((3, 32, 64), (32, 64)), ((3, 64, 64), (64, 32))):
        hargs = tuple(a.float() for a in _head_s2d_args(rng, dev, c_nat, co_nat))
        with pytest.raises(ValueError, match="natural widths"):
            fused_agcm_head(xs, *hargs, n_first=4 * co_nat[0], scale=1.0 / 255.0, s2d=True)
    assert native.launch_counts == before


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
    gpu = _eager_frame(HDRTVNetTorch(weights), frame).astype(np.int64)
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


def _bf16_sweep(dev):
    """Every bf16 value in [0, 1] on each channel (the other two a fixed
    draw), and gray: (4·0x3F81, 3) bf16, 0 and 1 first."""
    sweep = (torch.arange(0x3F81, dtype=torch.int32) << 16).view(torch.float32)
    rest = torch.from_numpy(np.random.RandomState(5).rand(0x3F81, 3).astype(np.float32))
    rows = [sweep[:, None].expand(-1, 3)]
    for c in range(3):
        x = rest.clone()
        x[:, c] = sweep
        rows.append(x)
    x = torch.cat(rows)
    x[:2] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]])
    return x.to(device=dev, dtype=torch.bfloat16)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(36, 50, 3), (2, 7, 129, 3), "sweep"])
def test_colorimetric_matches_plain(dev, dtype, shape):
    """The kernel (tables of code thresholds and bf16 powers, a guess from the
    approximate instructions corrected against the thresholds) against
    torch.pow on the card: ≤ 2 u16 codes, equal at 0 and 1; ragged pixel
    counts (36 × 50, 2 × 7 × 129: groups of 8 and a tail); "sweep" every bf16
    value in [0, 1] on each channel. Another peak and gamma are arguments,
    not constants: a change between calls builds the tables again, the same
    parameters do not."""
    from hdrtv_tpu_torch.ops.pack import colorimetric_pq_pack, colorimetric_pq_pack_ref

    if shape == "sweep":
        x = _bf16_sweep(dev).to(DTYPES[dtype])
    else:
        v = np.random.RandomState(len(shape)).uniform(-0.1, 1.1, shape).astype(np.float32)
        v.reshape(-1, 3)[:2] = [[0, 0, 0], [1, 1, 1]]
        x = _t(v, dev, dtype)
    for i, kwargs in enumerate(({}, {"peak_nits": 600.0, "gamma": 2.2}, {"peak_nits": 600.0, "gamma": 2.2})):
        before = native.launch_counts["colorimetric"], native.launch_counts["colorimetric_tables"]
        u = colorimetric_pq_pack(x, **kwargs)
        assert native.launch_counts["colorimetric"] == before[0] + 1
        rebuilt = native.launch_counts["colorimetric_tables"] - before[1]
        assert rebuilt == (1, 0)[i - 1] if i else rebuilt <= 1, (i, rebuilt)
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
    gpu = _eager_frame(HDRTVNetTorch(path, precision=precision), frame).astype(np.int64)
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


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("hb,wb,coarse", [(12, 20, True), (9, 15, False), (2, 6, True), (3, 5, False), (64, 96, True)])
def test_tail_w8a8_s2d_matches_plain(dev, asym, hb, wb, coarse):
    """tail_w8a8's s2d form in bf16: the SFT pass on the row tile in its
    int8-output mode, HR_conv2 on the wgmma s8 tile over the slot table,
    conv_last as before; images narrower and shorter than one conv tile
    (64 columns, 4 rows) and a ragged one. Against the plain version's s2d
    form, with test_tail_w8a8_matches_plain's bounds."""
    from hdrtv_tpu_torch.ops.megakernel import fused_tail, fused_tail_ref

    rng = np.random.RandomState(hb * wb + 41 + asym)
    s = _t(rng.rand(hb, wb, 128) * 0.6, dev, "bf16")
    up = _t(rng.rand(hb // 2, wb // 2, 512) * 0.6, dev, "bf16") if coarse else None
    cond1 = _t(rng.rand(hb, wb, 64), dev, "bf16")
    skip = _t(rng.rand(hb, wb, 12), dev, "bf16")
    w_hr, b_hr, qa = _qlayer(rng, dev, 128, 128, (-0.6, 2.0), asym)
    args = (_sft_s2d(rng, dev, 0.05), w_hr.to(torch.bfloat16), b_hr,
            _t(w_s2d_s1(rng.randn(3, 3, 32, 3).astype(np.float32) * 0.02), dev, "bf16"),
            _t(b_s2d(rng.randn(3).astype(np.float32) * 0.1), dev))
    before = native.launch_counts["tail_w8a8"], native.launch_counts["tail"]
    y = fused_tail(s, cond1, skip, *args, pack=True, up_coarse=up, qargs_hr=qa, s2d=True)
    assert (native.launch_counts["tail_w8a8"], native.launch_counts["tail"]) == (before[0] + 1, before[1])
    y_r = fused_tail_ref(s, cond1, skip, *args, pack=True, up_coarse=up, qargs_hr=qa, s2d=True)
    torch.cuda.synchronize()
    assert y.shape == (hb, 2, wb, 6) and y.dtype == torch.uint16
    d = (y.to(torch.int32) - y_r.to(torch.int32)).abs()
    assert int(d.max()) <= 16 and float((d > 0).float().mean()) <= 0.1, (int(d.max()), float((d > 0).float().mean()))


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("hb,wb,relu,skip", [
    (12, 20, True, False), (9, 15, False, True), (1, 7, True, False), (5, 70, False, True), (135, 240, True, False),
    (135, 240, False, True),
])
def test_sft_conv3_w8a8_s2d_matches_plain(dev, asym, hb, wb, relu, skip):
    """sft_conv3_w8a8's s2d form in bf16: the SFT pass on the row tile in its
    int8-output mode, the conv on the wgmma s8 tile over the slot table, its
    epilogue adding yscale, the folded bias and the skip rounded apart;
    images narrower than one conv tile, one a column past it, the L2 shape.
    Against the plain version's s2d form, with
    test_sft_conv3_w8a8_matches_plain's bounds."""
    from hdrtv_tpu_torch.ops.megakernel import fused_sft_conv3_v2, fused_sft_conv3_v2_ref

    rng = np.random.RandomState(hb * wb + 43 + asym)
    x = _t(rng.rand(hb, wb, 128) - 0.2, dev, "bf16")
    cond = _t(rng.rand(hb, wb, 64), dev, "bf16")
    w, b, qa = _qlayer(rng, dev, 128, 128, (-0.6, 1.5), asym)
    sk = _t(rng.rand(hb, wb, 128), dev, "bf16") if skip else None
    args = (x, cond, _sft_s2d(rng, dev, 0.05), w.to(torch.bfloat16), b)
    before = native.launch_counts["sft_conv3_w8a8"], native.launch_counts["sft_conv3"]
    y = fused_sft_conv3_v2(*args, relu=relu, skip=sk, qargs=qa, s2d=True)
    assert (native.launch_counts["sft_conv3_w8a8"], native.launch_counts["sft_conv3"]) == (before[0] + 1, before[1])
    assert y.shape == (hb, wb, 128)
    _q_close(y, fused_sft_conv3_v2_ref(*args, relu=relu, skip=sk, qargs=qa, s2d=True), qa, "bf16", share=0.04)


@pytest.mark.parametrize("hb,wb,relu,skip", [(6, 10, False, False), (9, 70, True, True), (4, 64, False, True)])
def test_s8_tile_reads_the_pad_code_at_the_border(dev, hb, wb, relu, skip):
    """An asymmetric layer (pad code ≠ 0) behind an SFT whose weights and
    biases are zero, so t = x exactly and both sides quantize the same
    values: the wgmma s8 tile equals the plain version bit for bit, border
    pixels included, and differs there from the same conv with code 0 in
    the out-of-image taps (what TMA's zero fill alone would give)."""
    import dataclasses

    from hdrtv_tpu_torch.ops.megakernel import fused_sft_conv3_v2, fused_sft_conv3_v2_ref

    rng = np.random.RandomState(hb * wb + 47)
    x = _t(rng.rand(hb, wb, 128) * 1.2 - 0.3, dev, "bf16")
    cond = _t(rng.rand(hb, wb, 64), dev, "bf16")
    w, b, qa = _qlayer(rng, dev, 128, 128, (-0.3, 0.9), True)
    assert qa.pad != 0
    sk = _t(rng.rand(hb, wb, 128), dev, "bf16") if skip else None
    zero_sft = [(torch.zeros(ci, co, device=dev, dtype=torch.bfloat16), torch.zeros(co, device=dev))
                for ci, co in ((64, 64), (64, 128), (64, 64), (64, 128))]
    args = (x, cond, zero_sft, w.to(torch.bfloat16), b)
    y = fused_sft_conv3_v2(*args, relu=relu, skip=sk, qargs=qa, s2d=True)
    y_r = fused_sft_conv3_v2_ref(*args, relu=relu, skip=sk, qargs=qa, s2d=True)
    y_0 = fused_sft_conv3_v2_ref(*args, relu=relu, skip=sk, qargs=dataclasses.replace(qa, pad=0), s2d=True)
    torch.cuda.synchronize()
    assert torch.equal(y, y_r), _max_err(y, y_r)
    border = torch.ones(hb, wb, dtype=torch.bool, device=dev)
    border[1:-1, 1:-1] = False
    assert bool((y_0 != y_r).any(dim=-1)[border].float().mean() > 0.5)
    assert torch.equal(y_0[~border], y_r[~border])


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("hb,wb,second", [
    (270, 480, None), (270, 480, "up_coarse"), (9, 15, "x_add"), (5, 70, None), (2, 6, "up_coarse"),
])
def test_resblock_w8a8_s2d_matches_plain(dev, asym, hb, wb, second):
    """resblock_w8a8's s2d form in bf16: SFT1 on the row tile in its
    int8-output mode (the rounded sum with x_add or up_coarse written as the
    residual), conv1 on the wgmma s8 tile storing h1 in fp32, SFT2 in the
    int8-output mode on that fp32 h1, conv2 on the s8 tile with the residual;
    the L1 shape (trunk1, trunk5 with up_coarse), ragged and small images.
    Against the plain version's s2d form, with
    test_resblock_w8a8_matches_plain's bounds."""
    from hdrtv_tpu_torch.ops.megakernel import fused_resblock, fused_resblock_ref

    rng = np.random.RandomState(hb * wb + 53 + asym)
    x, cond, kw = _resblock_s2d_inputs(rng, hb, wb, second, dev)
    w1, b1, q1 = _qlayer(rng, dev, 128, 128, (-0.6, 2.0), asym)
    w2, b2, q2 = _qlayer(rng, dev, 128, 128, (-0.2, 1.0), asym)
    args = (x, cond, _sft_s2d(rng, dev, 0.05), w1.to(torch.bfloat16), b1, _sft_s2d(rng, dev, 0.05),
            w2.to(torch.bfloat16), b2)
    before = native.launch_counts["resblock_w8a8"], native.launch_counts["resblock"]
    y = fused_resblock(*args, **kw, qargs1=q1, qargs2=q2, s2d=True)
    assert (native.launch_counts["resblock_w8a8"], native.launch_counts["resblock"]) == (before[0] + 1, before[1])
    assert y.shape == (hb, wb, 128)
    _q_close(y, fused_resblock_ref(*args, **kw, qargs1=q1, qargs2=q2, s2d=True), q2, "bf16", share=0.1, flips=8)


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("hb,wb,co,skip", [(270, 480, 512, False), (135, 240, 512, False), (9, 70, 128, True),
                                           (1, 5, 512, False)])
def test_block_conv3_w8a8_s2d_matches_plain(dev, asym, hb, wb, co, skip):
    """block_conv3_w8a8 with a_sub = 1 in bf16: the quantize pass, then the
    wgmma s8 tile over the slot table; up_conv3's L1 shape and up_conv2's L2
    shape (135 rows: the last tile's second row lies outside the image), PS
    folded 128 → 512 with ReLU, and a ragged 128 → 128 with the skip. The
    same codes and exact int32 sums as the plain version, the epilogue's
    operations rounded apart on both sides: bit for bit."""
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3, fused_block_conv3_q_ref

    rng = np.random.RandomState(hb * wb + co + 59 + asym)
    x = _t(rng.rand(hb, wb, 128) * 1.2 - 0.1, dev, "bf16")
    w, b, qa = _qlayer(rng, dev, 128, co, (-0.1, 1.0), asym, ps=co == 512)
    sk = _t(rng.rand(hb, wb, co), dev, "bf16") if skip else None
    before = native.launch_counts["block_conv3_w8a8"], native.launch_counts["block_conv3"]
    y = fused_block_conv3(x, w.to(torch.bfloat16), b, relu=not skip, skip=sk, qargs=qa, a_sub=1)
    assert (native.launch_counts["block_conv3_w8a8"], native.launch_counts["block_conv3"]) == (before[0] + 1, before[1])
    y_r = fused_block_conv3_q_ref(x, qa, relu=not skip, skip=sk)
    torch.cuda.synchronize()
    assert y.shape == (hb, wb, co) and torch.equal(y, y_r), _max_err(y, y_r)


def _zero_sft_s2d(dev):
    """SFT weights and biases all zero: t = x·(0 + 1) + 0 = x exactly."""
    return [(torch.zeros(ci, co, device=dev, dtype=torch.bfloat16), torch.zeros(co, device=dev))
            for ci, co in ((64, 64), (64, 128), (64, 64), (64, 128))]


@pytest.mark.parametrize("hb,wb", [(6, 10), (9, 70), (4, 64)])
def test_s8_tile_f32_epilogue_reads_the_pad_code_at_the_border(dev, hb, wb):
    """resblock_w8a8's s2d form with both SFTs zero, so t1 = x and t2 = h1
    exactly and both sides quantize the same values, and asymmetric layers
    (pad codes ≠ 0): conv1's fp32-output epilogue stores h1 unrounded (a
    rounding to bf16 would move its codes), so the output equals the plain
    version bit for bit, border pixels included; and it differs on the
    border from the same block with code 0 in conv1's out-of-image taps
    (TMA's zero fill alone), not two pixels inside."""
    import dataclasses

    from hdrtv_tpu_torch.ops.megakernel import fused_resblock, fused_resblock_ref

    rng = np.random.RandomState(hb * wb + 61)
    x = _t(rng.rand(hb, wb, 128) * 1.2 - 0.3, dev, "bf16")
    cond = _t(rng.rand(hb, wb, 64), dev, "bf16")
    w1, b1, q1 = _qlayer(rng, dev, 128, 128, (-0.3, 0.9), True)
    w2, b2, q2 = _qlayer(rng, dev, 128, 128, (-0.1, 2.5), True)
    assert q1.pad != 0 and q2.pad != 0
    args = (x, cond, _zero_sft_s2d(dev), w1.to(torch.bfloat16), b1, _zero_sft_s2d(dev), w2.to(torch.bfloat16), b2)
    y = fused_resblock(*args, qargs1=q1, qargs2=q2, s2d=True)
    y_r = fused_resblock_ref(*args, qargs1=q1, qargs2=q2, s2d=True)
    y_0 = fused_resblock_ref(*args, qargs1=dataclasses.replace(q1, pad=0), qargs2=q2, s2d=True)
    torch.cuda.synchronize()
    assert torch.equal(y, y_r), _max_err(y, y_r)
    border = torch.ones(hb, wb, dtype=torch.bool, device=dev)
    border[1:-1, 1:-1] = False
    assert bool((y_0 != y_r).any(dim=-1)[border].float().mean() > 0.5)
    assert torch.equal(y_0[2:-2, 2:-2], y_r[2:-2, 2:-2])


def _resblock_scratch(monkeypatch, call):
    """Runs ``call`` (one fused_resblock) and returns its output and the
    scratch the wrapper allocated: t's codes (int8, SFT2's last), h1 (fp32)
    and xsum (bf16, with a second input) or None."""
    made = []
    real = torch.empty

    def empty(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    with monkeypatch.context() as m:
        m.setattr(torch, "empty", empty)
        y = call()
    torch.cuda.synchronize()
    mine = [e for e in made if e.dim() == 3]
    by = {dt: [e for e in mine if e.dtype == dt] for dt in (torch.int8, torch.float32, torch.bfloat16)}
    (t,), (h1,) = by[torch.int8], by[torch.float32]
    bf = by[torch.bfloat16]
    assert bf[-1] is y and len(bf) in (1, 2)
    return y, t, h1, bf[0] if len(bf) == 2 else None


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("hb,wb,second", [(270, 480, "up_coarse"), (9, 15, "x_add"), (12, 20, None)])
def test_q8_sft_passes_match_the_dense_int8_output_pass(dev, monkeypatch, asym, hb, wb, second):
    """The row tile's int8-output mode with a second input (SFT1, writing
    xsum) and with fp32 x (SFT2 on h1), against pointwise.cuh's dense
    int8-output pass, in one resblock_w8a8 call each (s2d and dense, their
    scratch read back): SFT1's weights zero, so t1 = xsum exactly and both
    forms quantize the same values; xsum and h1 (the s8 tile's fp32 epilogue
    against the mma.sync tile's) equal bit for bit; SFT2's codes, whose
    scale and shift sums are taken in another order, within one code on at
    most 1e-3 of them."""
    from hdrtv_tpu_torch.ops.megakernel import fused_resblock

    rng = np.random.RandomState(hb * wb + 67 + asym)
    x, cond, kw = _resblock_s2d_inputs(rng, hb, wb, second, dev)
    w1, b1, q1 = _qlayer(rng, dev, 128, 128, (-0.6, 1.5), asym)
    w2, b2, q2 = _qlayer(rng, dev, 128, 128, (-0.3, 1.2), asym)
    args = (x, cond, _zero_sft_s2d(dev), w1.to(torch.bfloat16), b1, _sft_s2d(rng, dev, 0.05),
            w2.to(torch.bfloat16), b2)
    got = _resblock_scratch(monkeypatch, lambda: fused_resblock(*args, **kw, qargs1=q1, qargs2=q2, s2d=True))
    want = _resblock_scratch(monkeypatch, lambda: fused_resblock(*args, **kw, qargs1=q1, qargs2=q2))
    if second is None:
        assert got[3] is None and want[3] is None
    else:
        assert torch.equal(got[3], want[3])
    assert torch.equal(got[2], want[2]), _max_err(got[2], want[2])
    d = (got[1].int() - want[1].int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3, (int(d.max()), float((d > 0).float().mean()))


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
    gpu = _eager_frame(HDRTVNetTorch(path), frame)
    assert native.launch_counts["tail_w8a8"] == 1 and native.launch_counts["tail"] == 0
    cpu = HDRTVNetTorch(path, device="cpu").process_rgb48(frame)
    d = np.abs(gpu.astype(np.int64) - cpu.astype(np.int64))
    mse = float(np.mean((d / 65535.0) ** 2))
    assert 10 * np.log10(1.0 / max(mse, 1e-20)) >= 36.9, float(d.mean())


def test_int8_down2_frame_runs_the_s8_hopper_tile(dev, monkeypatch):
    """One frame of the W8A8 checkpoint's default program with
    HDRTV_INT8_DOWN2=1 under torch.profiler: its three int8 down convs run
    the one quantize pass and the wgmma s8 tile at stride 2 each, and no int8
    conv of the frame reaches the mma.sync tile of csrc/conv3x3_s8.cuh."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    monkeypatch.setenv("HDRTV_INT8_DOWN2", "1")
    proc = HDRTVNetTorch(os.path.join(os.path.dirname(__file__), "fixtures", "hr_w8a8.npz"))
    frame = (np.random.RandomState(66).rand(64, 128, 3) * 255).astype(np.uint8)
    _eager_frame(proc, frame)
    torch.cuda.synchronize()
    native.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _eager_frame(proc, frame)
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()}
    assert native.launch_counts["down2_w8a8"] == 3, native.launch_counts
    assert sum(n for k, n in counts.items() if "quantize_planes_kernel" in k) == 3, counts
    assert sum(n for k, n in counts.items() if "conv3x3_s8_kernel" in k) == 0, counts


def test_int8_frame_runs_the_s8_hopper_tile(dev, monkeypatch):
    """One frame of the W8A8 checkpoint's default program under
    torch.profiler: every int8 conv of the frame runs on the wgmma s8 tile
    (csrc/conv3x3_s8_sm90.cuh: one a call of sft_conv3_w8a8, tail_w8a8 and
    block_conv3_w8a8, two of resblock_w8a8) and none on the mma.sync tile of
    csrc/conv3x3_s8.cuh, nor any SFT pass on pointwise.cuh's dense one."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    monkeypatch.delenv("HDRTV_INT8_DOWN2", raising=False)
    proc = HDRTVNetTorch(os.path.join(os.path.dirname(__file__), "fixtures", "hr_w8a8.npz"))
    frame = (np.random.RandomState(65).rand(64, 128, 3) * 255).astype(np.uint8)
    _eager_frame(proc, frame)
    torch.cuda.synchronize()
    native.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _eager_frame(proc, frame)
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()}

    def launched(sub):
        return sum(n for k, n in counts.items() if sub in k)

    lc = native.launch_counts
    s2d_calls = lc["sft_conv3_w8a8"] + lc["tail_w8a8"] + lc["block_conv3_w8a8"] + 2 * lc["resblock_w8a8"]
    assert lc["tail_w8a8"] == 1 and lc["resblock_w8a8"] >= 1 and lc["block_conv3_w8a8"] >= 1
    assert launched("conv3x3_s8_sm90_kernel") == s2d_calls, counts
    assert launched("conv3x3_s8_kernel") == 0 and launched("sft_kernel") == 0, counts


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("hb,wb,cf,cin,ch0,branches,a_sub", [
    (12, 20, 128, None, 0, 1, 0),
    (10, 18, 768, 256, 512, 1, 1),
    (14, 12, 256, None, 0, 3, 3),
    (18, 132, 256, None, 0, 3, 3),
    (14, 12, 768, 256, 256, 1, 0),
])
def test_down2_w8a8_matches_plain(dev, dtype, asym, hb, wb, cf, cin, ch0, branches, a_sub):
    """down2's int8 body: the window quantized per branch with the same
    arithmetic and the exact int32 stride-2 sum, rescaled and biased by
    separately rounded operations on both sides: bit for bit, ragged pixel
    tiles, the channel window and three branches (each with its own scale,
    zero and pad code) included. In bf16 with a_sub ≥ 1 (C = 256) the one
    quantize pass and the wgmma s8 tile at stride 2 (an odd output height
    and two column tiles included), with a_sub = 0 the dense mma.sync tile;
    a_sub = 1 with C = 128 raises in bf16 (the s8 tile takes C = 256)."""
    from hdrtv_tpu_torch.models.s2d import b_s2d
    from hdrtv_tpu_torch.ops.megakernel import fused_down2, fused_down2_q_ref
    from hdrtv_tpu_torch.ops.w8a8 import pack_qargs, pack_qargs_branches
    from hdrtv_tpu_torch.quant.int8 import quantize_weight

    rng = np.random.RandomState(hb * wb + cf + asym)
    c = cin or cf
    x = _t(rng.rand(hb, wb, cf) * 1.3 - 0.2, dev, dtype)
    nat = [quantize_weight(rng.randn(3, 3, c // 4, 64).astype(np.float32) * 0.05) for _ in range(branches)]
    tq = np.concatenate([w_s2d_s2(q) for q, _ in nat], axis=-1)
    tsc = np.concatenate([b_s2d(s) for _, s in nat])
    co = tq.shape[-1]
    bnp = (rng.randn(co) * 0.1).astype(np.float32)
    scales = [1.3 / 255.0 + 0.001 * i if asym else 1.1 / 127.0 + 0.001 * i for i in range(branches)]
    zeros = [-0.2 - 0.05 * i for i in range(branches)] if asym else None
    if branches > 1:
        qa = pack_qargs_branches(tq, tsc, scales, zeros, bnp, dev)
    else:
        qa = pack_qargs(tq, tsc, scales[0], None if zeros is None else zeros[0], bnp, dev)
    w, b = _t(tq.astype(np.float32) * tsc, dev, dtype), _t(bnp, dev)
    if dtype == "bf16" and c != 256:
        with pytest.raises(ValueError, match="wgmma s8 tile takes"):
            fused_down2(x, w, b, act="lrelu", cin=cin, ch0=ch0, qargs=qa, a_sub=1)
    before = native.launch_counts["down2_w8a8"], native.launch_counts["down2"]
    y = fused_down2(x, w, b, act="lrelu", cin=cin, ch0=ch0, qargs=qa, a_sub=a_sub)
    assert (native.launch_counts["down2_w8a8"], native.launch_counts["down2"]) == (before[0] + 1, before[1])
    y_r = fused_down2_q_ref(x[..., ch0 : ch0 + c], qa, act="lrelu")
    torch.cuda.synchronize()
    assert y.shape == (hb // 2, wb // 2, co) and torch.equal(y, y_r), _max_err(y, y_r)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("flags", [(1, 0, 2, 0, 1), (0, 2, 2, 1, 0)], ids=["10201", "02210"])
def test_cond_chain_w8a8_matches_plain(dev, dtype, flags):
    """cond_chain's int8 steps (1: symmetric, 2: zero point) among float
    ones, on a ragged pixel count. A float step's sum order moves the running
    value by its last bit, which can flip a code of the int8 step after it:
    each output within 4 flipped codes' worth of the last int8 step (plus a
    bf16 step), at most 5% of them differing by more than that last-bit
    difference (fp32: 1e-5·max(1, |y|); bf16: at all). With a float last
    step, 78% of the fp32 outputs were seen a few ulps apart."""
    from hdrtv_tpu_torch.ops.megakernel import fused_cond_chain, fused_cond_chain_ref
    from hdrtv_tpu_torch.ops.w8a8 import pack_qargs
    from hdrtv_tpu_torch.quant.int8 import quantize_weight

    rng = np.random.RandomState(sum(flags) + 3 * flags[0])
    hb, wb = 9, 15
    c0 = _t(rng.rand(hb, wb, 128) - 0.3, dev, dtype)
    weights, qargs = [], []
    for i, (k, n) in enumerate(((128, 128), (128, 128), (128, 128), (128, 128), (128, 32))):
        wq, ws = quantize_weight(rng.randn(1, 1, k, n).astype(np.float32) * 0.1)
        bnp = (rng.randn(n) * 0.1).astype(np.float32)
        weights.append((_t(wq[0, 0].astype(np.float32) * ws, dev, dtype), _t(bnp, dev)))
        qargs.append(pack_qargs(wq, ws, 2.0 / 127.0 if flags[i] == 1 else 3.0 / 255.0,
                                -1.0 if flags[i] == 2 else None, bnp, dev) if flags[i] else None)
    before = native.launch_counts["cond_chain_w8a8"], native.launch_counts["cond_chain"]
    y = fused_cond_chain(c0, weights, qargs=qargs)
    assert (native.launch_counts["cond_chain_w8a8"], native.launch_counts["cond_chain"]) == (before[0] + 1, before[1])
    y_r = fused_cond_chain_ref(c0, weights, qargs)
    last = max(i for i, q in enumerate(qargs) if q is not None)
    torch.cuda.synchronize()
    for a, r in zip(y, y_r):
        assert a.dtype == r.dtype and a.shape == r.shape
        err = (a.float() - r.float()).abs()
        scale = r.float().abs().clamp_min(1.0)
        bound = 4 * 127.0 * float(qargs[last].yscale.max()) + (2.0 ** -7 * scale if dtype == "bf16" else 0.0)
        assert bool((err <= bound).all()), float(err.max())
        moved = err > (1e-5 * scale if dtype == "f32" else 0.0)
        assert float(moved.float().mean()) <= 0.05, float(moved.float().mean())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("flags", [(1, 0, 2, 0, 1), (0, 2, 2, 1, 0), (2, 1, 1, 1, 2)],
                         ids=["10201", "02210", "21112"])
@pytest.mark.parametrize("hb,wb", [(9, 15), (1, 7), (40, 64)])
def test_cond_chain_w8a8_s2d_matches_plain(dev, dtype, flags, hb, wb):
    """cond_chain's int8 steps declared s2d: the row tile's int8 instance
    (codes made in registers, s8 wgmma on each step's diagonal block), in
    fp32 that of its 3×TF32 instance, natural widths 64 → 64 ×4 → 16,
    w_s2d_1x1 weights and b_s2d biases, ragged, sub-tile and many-tile row
    counts, int8 first and last steps, consecutive int8 steps. Against the
    plain version's s2d form with test_cond_chain_w8a8_matches_plain's bounds
    (a float step's sum order can flip a code of the int8 step after it)."""
    from hdrtv_tpu_torch.ops.megakernel import fused_cond_chain, fused_cond_chain_ref
    from hdrtv_tpu_torch.ops.w8a8 import pack_qargs
    from hdrtv_tpu_torch.quant.int8 import quantize_weight

    rng = np.random.RandomState(sum(flags) + 7 * flags[0] + hb)
    c0 = _t(rng.rand(hb, wb, 256) - 0.3, dev, dtype)
    weights, qargs = [], []
    for i, n in enumerate((64, 64, 64, 64, 16)):
        wq, ws = quantize_weight(rng.randn(1, 1, 64, n).astype(np.float32) * 0.15)
        tq, tsc = w_s2d_1x1(wq), b_s2d(ws)
        bnp = b_s2d((rng.randn(n) * 0.1).astype(np.float32))
        weights.append((_t(tq[0, 0].astype(np.float32) * tsc, dev, dtype), _t(bnp, dev)))
        qargs.append(pack_qargs(tq, tsc, 2.0 / 127.0 if flags[i] == 1 else 3.0 / 255.0,
                                -1.0 if flags[i] == 2 else None, bnp, dev) if flags[i] else None)
    before = native.launch_counts["cond_chain_w8a8"], native.launch_counts["cond_chain"]
    y = fused_cond_chain(c0, weights, qargs=qargs, s2d=True)
    assert (native.launch_counts["cond_chain_w8a8"], native.launch_counts["cond_chain"]) == (before[0] + 1, before[1])
    y_r = fused_cond_chain_ref(c0, weights, qargs, s2d=True)
    last = max(i for i, q in enumerate(qargs) if q is not None)
    torch.cuda.synchronize()
    for a, r in zip(y, y_r):
        assert a.dtype == r.dtype == DTYPES[dtype] and a.shape == r.shape
        err = (a.float() - r.float()).abs()
        scale = r.float().abs().clamp_min(1.0)
        bound = 4 * 127.0 * float(qargs[last].yscale.max()) + (2.0 ** -7 * scale if dtype == "bf16" else 0.0)
        assert bool((err <= bound).all()), float(err.max())
        moved = err > (1e-5 * scale if dtype == "f32" else 0.0)
        assert float(moved.float().mean()) <= 0.05, float(moved.float().mean())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("form", ["float", "int8", "int8_zero"])
@pytest.mark.parametrize("hb,wb,co,skip", [(12, 20, 128, False), (10, 14, 512, True), (8, 32, 128, False),
                                           (6, 130, 512, False)])
def test_block_conv3_pool_a_sub_matches_plain(dev, dtype, form, hb, wb, co, skip):
    """pool_out with a_sub = 1 on the Hopper tiles' pooled epilogues: bf16
    on conv3x3_sm90's kEpiPool (Co = 128: the BN = 32 instance, both tile
    rows in one warpgroup; Co = 512: BN = 128, the two warpgroups' rows
    exchanged), fp32 on the 3×TF32 tile's, int8 on the wgmma s8 tile's after
    the quantize pass (the pad code at the edges with a zero point). Ragged
    row and column tiles (130 columns: three of 64) and the residual. Float
    as block_conv3 (fp32 absolute, bf16 one step); int8 bit for bit."""
    from hdrtv_tpu_torch.ops.conv_kernels import (
        fused_block_conv3, fused_block_conv3_q_ref, fused_block_conv3_ref,
    )

    rng = np.random.RandomState(hb * wb + co + len(form))
    c = 128
    x = _t(rng.rand(hb, wb, c) * 1.2 - 0.1, dev, dtype)
    w, b, qa = _qlayer(rng, dev, c, co, (-0.1, 1.1), form == "int8_zero", ps=co == 512)
    sk = _t(rng.rand(hb, wb, co) - 0.5, dev, dtype) if skip else None
    qa = qa if form != "float" else None
    counter = "block_conv3_pool_w8a8" if qa is not None else "block_conv3_pool"
    before = native.launch_counts[counter], native.launch_counts["block_conv3"]
    y = fused_block_conv3(x, w.to(x.dtype), b, relu=True, skip=sk, qargs=qa, pool_out=True, a_sub=1)
    assert (native.launch_counts[counter], native.launch_counts["block_conv3"]) == (before[0] + 1, before[1])
    assert y.shape == (hb // 2, wb // 2, co)
    if qa is not None:
        y_r = fused_block_conv3_q_ref(x, qa, relu=True, skip=sk, pool_out=True)
        torch.cuda.synchronize()
        assert torch.equal(y, y_r), _max_err(y, y_r)
    else:
        _close(y, fused_block_conv3_ref(x, w.to(x.dtype), b, relu=True, skip=sk, pool_out=True), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_block_conv3_pool_a_sub_streams_weights(dev, dtype):
    """pool_out with a_sub = 1 at C = 256 → Co = 512: in bf16 the chunks do
    not fit in shared memory beside the ring (18 a list), so the pooled
    epilogue runs on the tile's streamed-weight instance; in fp32 the 3×TF32
    tile's 32-wide N tile. Ragged tiles; as block_conv3's float bounds."""
    from hdrtv_tpu_torch.models.s2d import w_s2d_s1_ps
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3, fused_block_conv3_ref

    rng = np.random.RandomState(256)
    hb, wb, c, co = 10, 70, 256, 512
    x = _t(rng.rand(hb, wb, c) * 1.2 - 0.1, dev, dtype)
    w = _t(w_s2d_s1_ps(rng.randn(3, 3, c // 4, co // 4).astype(np.float32) * 0.04), dev, dtype)
    b = _t(rng.randn(co) * 0.1, dev)
    before = native.launch_counts["block_conv3_pool"]
    y = fused_block_conv3(x, w, b, relu=True, pool_out=True, a_sub=1)
    assert native.launch_counts["block_conv3_pool"] == before + 1
    assert y.shape == (hb // 2, wb // 2, co)
    _close(y, fused_block_conv3_ref(x, w, b, relu=True, pool_out=True), dtype)


def test_block_conv3_pool_a_sub_refuses(dev):
    """A pooled a_sub shape its tile does not take raises on the card, as on
    the CPU, and launches nothing: no fallback to the dense tiles."""
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3

    rng = np.random.RandomState(9)
    w, b, qa = _qlayer(rng, dev, 256, 128, (-0.1, 1.1), False)
    x = _t(rng.rand(8, 8, 256), dev, "bf16")
    before = dict(native.launch_counts)
    with pytest.raises(ValueError, match="wgmma s8 tile takes"):
        fused_block_conv3(x, w.to(x.dtype), b, relu=True, qargs=qa, pool_out=True, a_sub=1)
    x = _t(rng.rand(8, 8, 64), dev, "bf16")
    with pytest.raises(ValueError, match="Hopper tile takes"):
        fused_block_conv3(x, _t(rng.rand(3, 3, 64, 128), dev, "bf16"), b, relu=True, pool_out=True, a_sub=1)
    assert dict(native.launch_counts) == before


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("hb,wb,co,skip", [(12, 20, 128, False), (10, 14, 512, True), (8, 32, 128, False)])
def test_block_conv3_pool_matches_plain(dev, dtype, int8, hb, wb, co, skip):
    """pool_out: the tiles walk pooled pixels (four conv pixels of one pooled
    pixel in one thread or four lanes) and reduce them in the epilogue.
    Float: as block_conv3 (fp32 absolute, bf16 one step); int8: bit for bit.
    Ragged tiles, masked output channels and the residual included."""
    from hdrtv_tpu_torch.ops.conv_kernels import (
        fused_block_conv3, fused_block_conv3_q_ref, fused_block_conv3_ref,
    )

    rng = np.random.RandomState(hb * wb + co + int8)
    c = 128
    x = _t(rng.rand(hb, wb, c) * 1.2 - 0.1, dev, dtype)
    w, b, qa = _qlayer(rng, dev, c, co, (-0.1, 1.1), False, ps=co == 512)
    sk = _t(rng.rand(hb, wb, co) - 0.5, dev, dtype) if skip else None
    qa = qa if int8 else None
    counter = "block_conv3_pool_w8a8" if int8 else "block_conv3_pool"
    before = native.launch_counts[counter], native.launch_counts["block_conv3"]
    y = fused_block_conv3(x, w.to(x.dtype), b, relu=True, skip=sk, qargs=qa, pool_out=True)
    assert (native.launch_counts[counter], native.launch_counts["block_conv3"]) == (before[0] + 1, before[1])
    assert y.shape == (hb // 2, wb // 2, co)
    if int8:
        y_r = fused_block_conv3_q_ref(x, qa, relu=True, skip=sk, pool_out=True)
        torch.cuda.synchronize()
        assert torch.equal(y, y_r), _max_err(y, y_r)
    else:
        _close(y, fused_block_conv3_ref(x, w.to(x.dtype), b, relu=True, skip=sk, pool_out=True), dtype)


@pytest.mark.parametrize("hbc,wbc,c", [(4, 8, 128), (7, 5, 8), (33, 17, 64)])
def test_d2s_add_matches_plain(dev, hbc, wbc, c):
    """The probe's d2s + add: one rounding, so equal bit for bit; any hbc,
    wbc, and C a multiple of 8 (the grid-stride tail included)."""
    from hdrtv_tpu_torch.ops.probe_kernels import d2s_add, d2s_add_ref

    rng = np.random.RandomState(hbc * wbc + c)
    coarse = _t(rng.randn(hbc, wbc, 4 * c) * 3, dev, "bf16")
    fine = _t(rng.randn(2 * hbc, 2 * wbc, c), dev, "bf16")
    before = native.launch_counts["d2s_add"]
    y = d2s_add(coarse, fine)
    assert native.launch_counts["d2s_add"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(y, d2s_add_ref(coarse, fine))


@pytest.mark.parametrize("h,w,co", [(16, 32, 256), (10, 6, 16), (34, 18, 2048)])
def test_rowmajor_head_matches_plain(dev, h, w, co):
    """The head probe: raw rows and pair planes give the same bits, and
    both are within one bf16 step of the plain version (another fp32 sum
    order of the same exact products)."""
    from hdrtv_tpu_torch.ops.probe_kernels import rowmajor_head_pre, rowmajor_head_raw, rowmajor_head_raw_ref

    rng = np.random.RandomState(h * w + co)
    x = torch.as_tensor(rng.randint(0, 256, (h, 3 * w), dtype=np.uint8), device=dev)
    wm = _t(rng.randn(12, co) * 0.1, dev, "bf16")
    before = native.launch_counts["rowmajor_head"]
    raw = rowmajor_head_raw(x, wm)
    pre = rowmajor_head_pre(x.view(h // 2, 2, w // 2, 6), wm)
    assert native.launch_counts["rowmajor_head"] == before + 2
    torch.cuda.synchronize()
    assert raw.shape == (h // 2, w // 2, co) and torch.equal(raw, pre)
    _close(raw, rowmajor_head_raw_ref(x, wm), "bf16", flips=0.05)


# ---------------------------------------------------------------------------
# conv_last on its Hopper tile (csrc/conv_last.cuh conv_last_sm90_kernel, the
# s2d tail in bf16) and block_conv3_w8a8 in fp32 on the wgmma s8 tile.
# ---------------------------------------------------------------------------


def _tail_s2d_args(rng, dev, hb, wb, coarse):
    """The tail's s2d inputs in bf16 at the programs' widths (C 128, CC 64,
    Cl 12), weights from the s2d transforms."""
    s = _t(rng.rand(hb, wb, 128) - 0.3, dev, "bf16")
    up = _t(rng.rand(hb // 2, wb // 2, 512) - 0.3, dev, "bf16") if coarse else None
    cond1 = _t(rng.rand(hb, wb, 64) - 0.3, dev, "bf16")
    skip = _t(rng.rand(hb, wb, 12), dev, "bf16")
    args = (_sft_s2d(rng, dev), _t(w_s2d_s1(rng.randn(3, 3, 32, 32).astype(np.float32) * 0.04), dev, "bf16"),
            _t(b_s2d(rng.randn(32).astype(np.float32) * 0.1), dev),
            _t(w_s2d_s1(rng.randn(3, 3, 32, 3).astype(np.float32) * 0.02), dev, "bf16"),
            _t(b_s2d(rng.randn(3).astype(np.float32) * 0.1), dev))
    return s, up, cond1, skip, args


@pytest.mark.parametrize("hb,wb,coarse,pack", [
    (540, 960, True, True), (200, 130, False, False), (66, 258, True, True), (3, 64, False, True),
    (1, 70, False, False), (31, 3, False, True),
])
def test_conv_last_tile_matches_plain(dev, hb, wb, coarse, pack):
    """The tail's s2d form in bf16, whose conv_last runs the Hopper tile:
    at 1080p (bands of 64 columns walked down by persistent blocks, runs
    crossing from one band into the next), with a ragged last band (130,
    258 columns: 4-byte stores where a row is not 16-byte aligned), bands
    narrower than one (3 columns) and a single row. Against the plain
    version's s2d form with test_tail_s2d_matches_plain's bounds
    (test_frames_run_the_new_tiles checks the route by kernel name)."""
    from hdrtv_tpu_torch.ops.megakernel import fused_tail, fused_tail_ref

    rng = np.random.RandomState(hb * wb + 23)
    s, up, cond1, skip, args = _tail_s2d_args(rng, dev, hb, wb, coarse)
    before = native.launch_counts["tail"]
    y = fused_tail(s, cond1, skip, *args, pack=pack, up_coarse=up, s2d=True)
    assert native.launch_counts["tail"] == before + 1
    y_r = fused_tail_ref(s, cond1, skip, *args, pack=pack, up_coarse=up, s2d=True)
    if not pack:
        assert y.shape == (hb, wb, 12)
        _close(y, y_r, "bf16", steps=2, flips=0.05)
        return
    torch.cuda.synchronize()
    assert y.shape == (hb, 2, wb, 6) and y.dtype == torch.uint16
    d = (y.to(torch.int32) - y_r.to(torch.int32)).abs()
    assert int(d.max()) <= 64 and float(d.float().mean()) < 1.0, (int(d.max()), float(d.float().mean()))


def test_conv_last_tile_sums_only_the_populated_slots(dev):
    """h is fed through HR_conv2 = 0 with bias b_hr, so h = relu(b_hr) on
    every pixel inside the image and 0 outside: a w_last with weights in
    slots the s2d declaration leaves out gives the s2d-slots-only result on
    the card (the tile skips them), not the dense one."""
    from hdrtv_tpu_torch.ops.megakernel import _s2d_slots_only, fused_tail, fused_tail_ref

    rng = np.random.RandomState(29)
    hb, wb = 12, 80
    s, _, cond1, skip, args = _tail_s2d_args(rng, dev, hb, wb, False)
    sft, _, _, _, b_last = args
    w_hr = torch.zeros(3, 3, 128, 128, device=dev, dtype=torch.bfloat16)
    b_hr = _t(rng.rand(128), dev)
    w_last = _t(rng.randn(3, 3, 128, 12) * 0.02, dev, "bf16")
    y = fused_tail(s, cond1, skip, sft, w_hr, b_hr, w_last, b_last, pack=False, s2d=True)
    y_slots = fused_tail_ref(s, cond1, skip, sft, w_hr, b_hr, _s2d_slots_only(w_last), b_last, pack=False)
    y_dense = fused_tail_ref(s, cond1, skip, sft, w_hr, b_hr, w_last, b_last, pack=False)
    _close(y, y_slots, "bf16", steps=1, flips=0.05)
    assert _max_err(y, y_dense) > 0.05


def test_conv_last_tile_refuses_other_widths(dev):
    """bf16 s2d=True with Cl other than 12 raises on the card, naming the
    widths; nothing falls back to the dense conv_last."""
    from hdrtv_tpu_torch.ops.megakernel import fused_tail

    rng = np.random.RandomState(31)
    s, _, cond1, _, args = _tail_s2d_args(rng, dev, 4, 8, False)
    sft, w_hr, b_hr, _, _ = args
    w_last = _t(w_s2d_s1(rng.randn(3, 3, 32, 2).astype(np.float32) * 0.02), dev, "bf16")
    with pytest.raises(ValueError, match="conv_last's s2d tile takes"):
        fused_tail(s, cond1, _t(rng.rand(4, 8, 8), dev, "bf16"), sft, w_hr, b_hr, w_last,
                   torch.zeros(8, device=dev), s2d=True)


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("hb,wb,co,relu,skip", [
    (540, 960, 128, True, False), (270, 480, 128, False, True), (135, 240, 512, True, False),
    (9, 70, 128, False, True), (1, 5, 512, True, False), (12, 20, 128, True, True),
])
def test_block_conv3_w8a8_fp32_s2d_matches_plain(dev, asym, hb, wb, co, relu, skip):
    """block_conv3_w8a8 in fp32 with a_sub = 1: the quantize pass, then the
    wgmma s8 tile through its fp32-output epilogue, with an fp32 skip where
    the trunk conv2s have one; the int8 fp32 program's shapes (HR_conv1/2,
    trunk conv2 + skip, up_conv2's 135 rows PS-folded to 512) and ragged
    ones. The same codes, exact int32 sums and separately rounded epilogue
    operations on both sides: bit for bit."""
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3, fused_block_conv3_q_ref

    rng = np.random.RandomState(hb * wb + co + 67 + asym)
    x = _t(rng.rand(hb, wb, 128) * 1.2 - 0.1, dev)
    w, b, qa = _qlayer(rng, dev, 128, co, (-0.1, 1.0), asym, ps=co == 512)
    sk = _t(rng.rand(hb, wb, co) - 0.5, dev) if skip else None
    before = native.launch_counts["block_conv3_w8a8"], native.launch_counts["block_conv3"]
    y = fused_block_conv3(x, w, b, relu=relu, skip=sk, qargs=qa, a_sub=1)
    assert (native.launch_counts["block_conv3_w8a8"], native.launch_counts["block_conv3"]) == (before[0] + 1, before[1])
    y_r = fused_block_conv3_q_ref(x, qa, relu=relu, skip=sk)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and y.shape == (hb, wb, co) and torch.equal(y, y_r), _max_err(y, y_r)


@pytest.mark.parametrize("program", ["bf16", "int8_bf16", "int8_fp32"])
def test_frames_run_the_new_tiles(dev, monkeypatch, program):
    """One frame of the bf16 default program, the int8 default and the int8
    fp32 program under torch.profiler: the two bf16 ones run conv_last on
    its Hopper tile once and never the dense conv_last_kernel; the int8 fp32
    program runs all twelve block_conv3_w8a8 convs on the wgmma s8 tile and
    none on the mma.sync tile."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    monkeypatch.delenv("HDRTV_INT8_DOWN2", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    weights = os.path.join(root, "weights", "hr_fp32.npz") if program == "bf16" else \
        os.path.join(root, "tests", "fixtures", "hr_w8a8.npz")
    proc = HDRTVNetTorch(weights, precision="fp32" if program == "int8_fp32" else "fp16")
    frame = (np.random.RandomState(71).rand(64, 128, 3) * 255).astype(np.uint8)
    _eager_frame(proc, frame)
    torch.cuda.synchronize()
    native.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _eager_frame(proc, frame)
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()}

    def launched(sub):
        return sum(n for k, n in counts.items() if sub in k)

    if program == "int8_fp32":
        assert native.launch_counts["block_conv3_w8a8"] == 12, dict(native.launch_counts)
        assert launched("conv3x3_s8_sm90_kernel") == 12 and launched("conv3x3_s8_kernel") == 0, counts
        assert launched("conv_last") == 0, counts
    else:
        assert launched("conv_last_sm90_kernel") == 1 and launched("conv_last_kernel") == 0, counts


def _trunk3_f32_args(rng, hb, wb, dev):
    """trunk3's inputs at its natural widths (C 32, CC 16, Co 128) in fp32,
    with test_trunk3_matches_plain's fp32 weights."""
    cin, cc, co = 32, 16, 128
    fea3 = _t(rng.rand(hb, wb, cin) - 0.2, dev)
    cond4 = _t(rng.rand(hb, wb, cc) - 0.3, dev)
    blocks = [(_sft4(rng, cc, cin, dev, "f32", 0.2), _t(rng.randn(3, 3, cin, cin) * 0.1, dev),
               _t(rng.randn(cin) * 0.1, dev), _sft4(rng, cc, cin, dev, "f32", 0.2),
               _t(rng.randn(3, 3, cin, cin) * 0.1, dev), _t(rng.randn(cin) * 0.1, dev)) for _ in range(4)]
    return fea3, cond4, blocks, _t(rng.randn(3, 3, cin, co) * 0.1, dev), _t(rng.randn(co) * 0.1, dev)


# 1080p's /8 level; odd row counts (the tile's 2 rows) and columns off its 64
@pytest.mark.parametrize("hb,wb", [(135, 240), (27, 100), (9, 20), (5, 7), (1, 3)])
def test_trunk3_fp32_on_tf32x3_tile_matches_plain(dev, hb, wb):
    """trunk3's fp32 instance (its convs on the 3×TF32 tile, dense; its SFT
    passes on the coalesced fp32 pass) within 5e-4 of the plain version,
    chip_smoke.py's fp32 trunk3 check, in one counted launch."""
    from hdrtv_tpu_torch.ops.megakernel import fused_trunk3, fused_trunk3_ref, trunk3_pack

    args = _trunk3_f32_args(np.random.RandomState(hb * wb + 17), hb, wb, dev)
    before = native.launch_counts["trunk3"]
    y = fused_trunk3(*args)
    assert native.launch_counts["trunk3"] == before + 1
    assert y.shape == (hb, wb, 128)
    _close(y, fused_trunk3_ref(*args), "f32", atol=5e-4)
    assert torch.equal(fused_trunk3(*args, packed=trunk3_pack(*args[2:])), y)


def test_trunk3_fp32_runs_the_tf32x3_tile(dev):
    """Under torch.profiler one fp32 trunk3 call launches the 3×TF32 tile 9
    times (the two-skip instance once) and the coalesced SFT pass 8 times,
    and neither the FMA conv tile nor the one-thread-a-pixel SFT pass."""
    from torch.profiler import ProfilerActivity, profile

    from hdrtv_tpu_torch.ops.megakernel import fused_trunk3

    args = _trunk3_f32_args(np.random.RandomState(5), 27, 100, dev)
    fused_trunk3(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused_trunk3(*args)
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()}

    def launched(sub):
        return sum(n for k, n in counts.items() if sub in k)

    # the two-skip instance: <BN 32, stride 1, SK2, not pooled>
    assert launched("conv3x3_tf32x3_kernel") == 9, counts
    assert launched("conv3x3_tf32x3_kernel<32, 1, true, false>") == 1, counts
    assert launched("sft_rows_f32_kernel") == 8, counts
    assert launched("conv3x3_kernel") + launched("conv3x3_mma_kernel") + launched("::sft_kernel") == 0, counts


def _pack_values(rng, n):
    """Values beyond [0, 1], 0 and 1, and every seventh on a +0.5 rounding
    boundary: k/65535 lands within an ulp of (k + 0.5)/65535's neighbours."""
    v = rng.uniform(-0.5, 1.5, n).astype(np.float32)
    k = np.arange(n, dtype=np.float64) % 65536
    v[::7] = ((k[::7] + 0.5) / 65535.0).astype(np.float32)
    v[1::97], v[2::97], v[3::97] = 0.0, 1.0, -0.0
    return v


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,offset", [
    ((1080, 1920, 3), 0), ((99, 131, 3), 0), ((99, 131, 3), 1), ((36, 50, 3), 3), ((2, 9, 3), 7), ((5,), 2),
], ids=["1080p", "99x131", "99x131-offset1", "36x50-offset3", "2x9-offset7", "5-offset2"])
def test_pack_rgb48_streaming_pass_matches_plain_exactly(dev, dtype, shape, offset):
    """The streaming pack bit for bit against the plain version: at 1080p,
    at element counts that are not a multiple of 8 (the scalar tail), and
    on views whose data pointer is not 16-byte aligned (the scalar head; the
    output lies as far past a 16-byte boundary), in one counted launch."""
    from hdrtv_tpu_torch.ops.pack import pack_rgb48, pack_rgb48_ref

    n = int(np.prod(shape))
    base = _t(_pack_values(np.random.RandomState(n + offset), n + 8), dev, dtype)
    x = base[offset: offset + n].view(shape)
    assert (x.data_ptr() % 16 != 0) == bool(offset * x.element_size() % 16)
    before = native.launch_counts["pack_rgb48"]
    u = pack_rgb48(x)
    assert native.launch_counts["pack_rgb48"] == before + 1
    assert u.dtype == torch.uint16 and u.shape == x.shape and u.is_contiguous()
    np.testing.assert_array_equal(u.cpu().numpy(), pack_rgb48_ref(x.cpu()).numpy())


# ---------------------------------------------------------------------------
# The runtime's CUDA graphs (runtime/engine.py GraphCache): one per frame
# signature, replayed by process_rgb48_device.
# ---------------------------------------------------------------------------


def _chip_smoke():
    """chip_smoke.py's tables (its module level imports the standard library only)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_tables", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smooth(h, w, seed):
    rng = np.random.RandomState(seed)
    blocks = np.kron(rng.rand(-(-h // 8), -(-w // 8), 1), np.ones((8, 8, 3)))[:h, :w] * 420
    return np.clip(blocks + rng.randn(h, w, 3) * 10, 0, 255).astype(np.uint8)


# program: (checkpoint, precision, HDRTV_MEGAKERNEL, constructor keywords, frame size)
GRAPH_PROGRAMS = {
    "bf16": ("float", "fp16", "1", {}, (360, 640)),
    "bf16_nomega": ("float", "fp16", "0", {}, (360, 640)),
    "fp32": ("float", "fp32", "1", {}, (360, 640)),
    "hg_bf16": ("hg", "fp16", "1", {}, (360, 640)),
    "int8": ("int8", "fp16", "1", {}, (360, 640)),
    "natural_360x640": ("float", "fp16", "1", {"turbo": False}, (360, 640)),
    "natural_99x131": ("float", "fp16", "1", {}, (99, 131)),
}


def _graph_proc(program, monkeypatch, tmp_path):
    import os

    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch
    from hdrtv_tpu_torch.tools.synth_hg import write_synth_hg

    ckpt, precision, mega, kw, size = GRAPH_PROGRAMS[program]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    weights = {"float": os.path.join(root, "weights", "hr_fp32.npz"),
               "int8": os.path.join(root, "tests", "fixtures", "hr_w8a8.npz")}.get(ckpt)
    if ckpt == "hg":
        weights = write_synth_hg(str(tmp_path / "hg16.npz"), nf=16, seed=1)
    for var in ("HDRTV_HG_TAIL", "HDRTV_INT8_DOWN2", "HDRTV_PAIRS_BOUNDARY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HDRTV_MEGAKERNEL", mega)
    return HDRTVNetTorch(weights, precision=precision, persistent_cache=False, **kw), size


@pytest.mark.parametrize("program", list(GRAPH_PROGRAMS))
def test_graph_replay_matches_eager(dev, monkeypatch, tmp_path, program):
    """The first frame of a signature runs the program eagerly, captures it
    (the counters see one frame's launches in the capture, the same as an
    eager frame's) and replays it; later frames replay only (no launch the
    counters see). Every replay equals the eager program's output bit for
    bit: both run the same kernels on the same inputs. Should two eager runs
    already differ, the replay is held to the card-against-CPU bound of
    chip_smoke.py phase 3 instead (fp32 4 codes, bf16 1536 max / 34 mean)."""
    proc, (h, w) = _graph_proc(program, monkeypatch, tmp_path)
    frame = _smooth(h, w, h + w)
    x = proc.put_frame(frame.reshape(h, 3 * w))
    e1 = proc._rgb48_eager(x)
    native.reset_launch_counts()
    e2 = proc._rgb48_eager(x)
    one_frame = {k: v for k, v in native.launch_counts.items() if v}
    native.reset_launch_counts()
    g1 = proc.process_rgb48_device(x)
    torch.cuda.synchronize()
    assert len(proc.graphs) == 1
    entry = next(iter(proc.graphs.entries.values()))
    assert entry.launches == one_frame and one_frame
    assert {k: v for k, v in native.launch_counts.items() if v} == {k: 2 * v for k, v in one_frame.items()}
    native.reset_launch_counts()
    g2 = proc.process_rgb48_device(x)
    torch.cuda.synchronize()
    assert not any(native.launch_counts.values()) and len(proc.graphs) == 1
    assert g1.shape == e1.shape and g1.dtype == torch.uint16
    if torch.equal(e1, e2):
        assert torch.equal(g1, e1) and torch.equal(g2, e1)
    else:
        d = (torch.stack([g1, g2]).to(torch.int64) - e1.to(torch.int64)).abs()
        bound = (4, None) if proc.policy.compute_dtype == torch.float32 else (1536, 34.0)
        print(f"{program}: two eager runs differ; replay against eager max {int(d.max())}, "
              f"mean {float(d.float().mean()):.3f}")
        assert int(d.max()) <= bound[0] and (bound[1] is None or float(d.float().mean()) <= bound[1])
    proc.graphs.clear()


def test_graph_returns_the_callers_tensor(dev, monkeypatch, tmp_path):
    """Two calls return distinct tensors and the first keeps its values; a
    second input gives its own result, not the captured one."""
    proc, (h, w) = _graph_proc("bf16", monkeypatch, tmp_path)
    x = proc.put_frame(_smooth(h, w, 1).reshape(h, 3 * w))
    x2 = proc.put_frame(_smooth(h, w, 2).reshape(h, 3 * w))
    a = proc.process_rgb48_device(x)
    a_values = a.clone()
    b = proc.process_rgb48_device(x)
    assert a.data_ptr() != b.data_ptr() and torch.equal(a, a_values) and torch.equal(a, b)
    c = proc.process_rgb48_device(x2)
    assert len(proc.graphs) == 1 and torch.equal(a, a_values)
    assert torch.equal(c, proc._rgb48_eager(x2)) and not torch.equal(c, a)


def test_graph_follows_hdrtv_megakernel(dev, monkeypatch, tmp_path):
    """Flipping HDRTV_MEGAKERNEL between calls runs the other program: a
    graph of its own, whose capture counted that program's launches of one
    frame (chip_smoke.py PATHS bf16_mega and bf16_nomega), and back again
    the first graph replays."""
    paths = _chip_smoke().PATHS
    proc, _ = _graph_proc("bf16", monkeypatch, tmp_path)
    h, w = 1080, 1920  # the size of chip_smoke.py's launch counts
    x = proc.put_frame(_smooth(h, w, 3).reshape(h, 3 * w))
    seen = []
    for mega, path in (("1", "bf16_mega"), ("0", "bf16_nomega"), ("1", "bf16_mega")):
        monkeypatch.setenv("HDRTV_MEGAKERNEL", mega)
        out = proc.process_rgb48_device(x)
        assert torch.equal(out, proc._rgb48_eager(x))
        seen.append(out)
        entry = next(e for k, e in proc.graphs.entries.items() if dict(k[-1])["HDRTV_MEGAKERNEL"] == (mega == "1"))
        assert entry.launches == paths[path]["launches"], (path, entry.launches)
    assert len(proc.graphs) == 2 and torch.equal(seen[0], seen[2]) and not torch.equal(seen[0], seen[1])
    proc.graphs.clear()


def test_graph_capture_failure_raises(dev):
    """A program that syncs with the host cannot be captured: the call
    raises, and nothing runs eagerly in the graph's place."""
    from hdrtv_tpu_torch.runtime.engine import GraphCache

    ran = []

    def fn(x):
        ran.append(1)
        return x * int((x > 0).sum().item() > 0)

    cache = GraphCache()
    with pytest.raises(RuntimeError, match="capture"):
        cache.run(("sync",), fn, torch.ones(64, device="cuda"))
    assert len(ran) == 2 and len(cache) == 0  # the eager run before the capture, the capture's
    torch.cuda.synchronize()
    assert float(torch.ones(4, device="cuda").sum()) == 4.0  # the device is usable after


@pytest.mark.parametrize("kw,size", [({"proc_resolution": (640, 360)}, (480, 640)),
                                     ({"fast_condition_resize": True}, (360, 640)),
                                     ({"fast_zero_condition": True}, (360, 640))],
                         ids=["proc_resolution", "fast_condition_resize", "fast_zero_condition"])
def test_graph_runtime_options_match_cpu(dev, monkeypatch, kw, size):
    """proc_resolution (a 480 × 640 frame letterboxed to 360 × 640) and the
    fast-condition shortcuts, bf16 default, through the graph on the card
    against the same processor on the CPU: within chip_smoke.py's
    RUNTIME_BF16_CODES (twice the largest max and mean of its sound
    readings); the replay equals the eager program. The same card frame
    against chip_smoke.py's planted faults on the CPU (the letterbox one
    row down, the shortcut ignored) breaks that bound: it can fail."""
    import os

    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    weights = os.path.join(os.path.dirname(__file__), "..", "weights", "hr_fp32.npz")
    h, w = size
    frame = (np.random.RandomState(h).rand(h, w, 3) * 255).astype(np.uint8)
    proc = HDRTVNetTorch(weights, persistent_cache=False, **kw)
    gpu = proc.process_rgb48(frame)
    assert gpu.shape == (360, 640, 3) and len(proc.graphs) == 1
    assert np.array_equal(gpu, _eager_frame(proc, frame))
    cpu = HDRTVNetTorch(weights, device="cpu", persistent_cache=False, **kw).process_rgb48(frame)
    smoke = _chip_smoke()
    bound = smoke.RUNTIME_BF16_CODES
    assert not smoke.breaks(smoke.codes_apart(np, gpu, cpu), bound), smoke.codes_apart(np, gpu, cpu)
    plain = HDRTVNetTorch(weights, device="cpu", persistent_cache=False).process_rgb48
    for fault, bad in smoke.runtime_faults(np, torch, frame, kw, plain).items():
        assert smoke.breaks(smoke.codes_apart(np, gpu, bad), bound), (fault, smoke.codes_apart(np, gpu, bad))


def test_graph_keeps_the_matrices_it_reads(dev, monkeypatch, tmp_path):
    """A graph replays the addresses of the cached resize matrices its
    capture read: after more frame sizes than those caches hold (the first
    size's matrices evicted, and memory of their sizes handed out again
    and filled with NaN), the first size's graph still gives its eager
    bytes."""
    from hdrtv_tpu_torch.ops import resize

    proc, _ = _graph_proc("bf16", monkeypatch, tmp_path)
    sizes = [(64, 96 + 16 * i) for i in range(resize._flat_matrices.cache_info().maxsize + 1)]
    frames = [proc.put_frame(_smooth(h, w, w).reshape(h, 3 * w)) for h, w in sizes]
    assert frames[0].ndim == 4  # pair planes: the condition reads _pairs_matrices, views of _flat_matrices'
    eager = proc._rgb48_eager(frames[0])
    first = proc.process_rgb48_device(frames[0])
    for x in frames[1:]:
        proc.process_rgb48_device(x)
    assert len(proc.graphs) == len(sizes)
    h, w = sizes[0]
    info = resize._flat_matrices.cache_info()
    assert info.currsize == info.maxsize < len(sizes)  # the first size's entry evicted
    resize._flat_matrices.cache_clear()
    resize._pairs_matrices.cache_clear()
    torch.cuda.synchronize()
    junk = [torch.full(shape, float("nan"), device="cuda") for _ in range(4)
            for shape in ((h // 4, h), (3 * w, 3 * w // 4))]
    again = proc.process_rgb48_device(frames[0])
    assert torch.equal(first, eager) and torch.equal(again, eager)
    del junk
    proc.graphs.clear()


# ---------------------------------------------------------------------------
# The pipeline on the card: pinned host rings and copy streams
# ---------------------------------------------------------------------------


def _pipeline_proc(monkeypatch, **kw):
    import os

    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    for var in ("HDRTV_MEGAKERNEL", "HDRTV_HG_TAIL", "HDRTV_INT8_DOWN2", "HDRTV_PAIRS_BOUNDARY"):
        monkeypatch.delenv(var, raising=False)
    weights = os.path.join(os.path.dirname(__file__), "..", "weights", "hr_fp32.npz")
    return HDRTVNetTorch(weights, persistent_cache=False, **kw)


class _KeepingSink:
    """Keeps a copy of every frame with its stamp, slowly."""

    def __init__(self, delay=0.0):
        self.delay = delay
        self.got = []

    def show(self, rgb48, pts=None):
        import time

        if self.delay:
            time.sleep(self.delay)
        self.got.append((pts, rgb48.copy()))

    def close(self):
        pass


def test_pipeline_slow_sink_full_ring_matches_per_frame(dev, monkeypatch):
    """A sink slower than the card keeps the ring full: every frame it gets
    (through the pinned out-slots and the D2H stream) equals the frame
    program's output for that source frame, bit for bit."""
    from hdrtv_tpu_torch.pipeline.runner import PipelineRunner
    from hdrtv_tpu_torch.pipeline.source import SyntheticSource

    proc = _pipeline_proc(monkeypatch)
    h, w, n = 360, 640, 16
    sink = _KeepingSink(delay=0.01)
    m = PipelineRunner(SyntheticSource(w, h, fps=30, frames=n), proc, sink, realtime=False, ring=3).run()
    assert m.frames == n and len(sink.got) == n and len(proc.graphs) == 1
    src = SyntheticSource(w, h, fps=30, frames=n)
    for pts, got in sink.got:
        frame, idx, _ = src.read_with_meta()
        assert abs(pts - idx / 30) < 1e-9
        assert np.array_equal(got.reshape(h, w, 3), proc.process_rgb48(frame)), idx


def test_pipeline_process_rgb48_result_is_the_callers(dev, monkeypatch):
    """process_rgb48 returns the caller's own array: the next call (which
    reuses the pinned readback slot) leaves it as it was."""
    proc = _pipeline_proc(monkeypatch)
    a = proc.process_rgb48(_smooth(360, 640, 1))
    kept = a.copy()
    b = proc.process_rgb48(_smooth(360, 640, 2))
    slot = next(iter(proc._readback.values()))
    assert slot.pinned and slot.tensor.is_pinned()
    assert np.array_equal(a, kept) and not np.array_equal(a, b)
    assert not np.shares_memory(a, b) and not np.shares_memory(a, slot.tensor.numpy())
    x = proc.put_frame(_smooth(360, 640, 3).reshape(360, -1))
    assert all(s.tensor is None or s.tensor.is_pinned() for slots in proc._staging.values() for s in slots)
    assert x.device.type == "cuda"


def test_pipeline_cross_stream_lifetimes(dev, monkeypatch):
    """Blocks one stream reads while another stream allocates: with the
    reading stream held back (torch.cuda._sleep), the tensors the other
    stream frees are not handed out again until the read is done. The
    output read by the D2H stream, and the input read by the compute stream
    after its H2D copy, survive being freed and memory of their sizes being
    filled on the other stream at once (no empty_cache here: its cudaFree
    waits for the device and would hide the race)."""
    from hdrtv_tpu_torch.runtime import transfer

    proc = _pipeline_proc(monkeypatch)
    f1, f2 = _smooth(360, 640, 4), _smooth(360, 640, 5)
    want1, want2 = proc.process_rgb48(f1), proc.process_rgb48(f2)  # the graph captured
    slot = transfer.HostSlot(pinned=True)
    # The output: the D2H stream held back, the output freed, its memory reused.
    out = proc.process_rgb48_device(proc.put_frame(f1.reshape(360, -1)))
    with torch.cuda.stream(proc._d2h):
        torch.cuda._sleep(100_000_000)
    transfer.copy_out(out, slot, proc._d2h)
    shape, dtype = out.shape, out.dtype
    del out
    junk = [torch.full(shape, 65535, dtype=torch.int32, device="cuda").to(dtype) for _ in range(8)]
    assert np.array_equal(proc._hw3(slot.array()), want1)
    # The input: the compute stream held back, the input freed, its memory reused on the H2D stream.
    torch.cuda._sleep(100_000_000)
    x = proc.put_frame(f2.reshape(360, -1))
    out2 = proc.process_rgb48_device(x)
    xshape = x.shape
    del x
    with torch.cuda.stream(proc._h2d):
        junk += [torch.full(xshape, 255, dtype=torch.uint8, device="cuda") for _ in range(8)]
    assert np.array_equal(proc._hw3(proc._to_host(out2)), want2)
    del junk


def test_pipeline_hot_swap_mid_run(dev, monkeypatch):
    """Resolution hot-swaps with the ring full (640 × 360 → 320 × 180, the
    natural program, → 640 × 360): no capture error, three graphs, and
    every frame after a swap equals its processor's per-frame output."""
    import time

    from hdrtv_tpu_torch.pipeline.runner import PipelineRunner
    from hdrtv_tpu_torch.pipeline.source import SyntheticSource

    base = _pipeline_proc(monkeypatch)
    made = {}

    def factory(precision=None, proc_resolution=None):
        made[proc_resolution] = p = base.with_proc_resolution(proc_resolution)
        return p

    h, w = 360, 640
    sink = _KeepingSink(delay=0.004)
    r = PipelineRunner(SyntheticSource(w, h, fps=30, frames=100000), factory(proc_resolution=(640, 360)), sink,
                       realtime=False, ring=3, processor_factory=factory)
    import threading

    t = threading.Thread(target=r.run, daemon=True)
    t.start()
    for res in ((320, 180), (640, 360)):
        n0 = len(sink.got)
        deadline = time.monotonic() + 60
        while len(sink.got) < n0 + 20 and time.monotonic() < deadline:
            time.sleep(0.01)
        r.request_resolution_change(res)
    deadline = time.monotonic() + 60
    while len(sink.got) < 80 and time.monotonic() < deadline:
        time.sleep(0.01)
    r.stop()
    t.join(timeout=60)
    assert not t.is_alive() and r.flushed >= 0
    sizes = {}
    for pts, got in sink.got:
        idx = int(round(pts * 30))
        frame = _synthetic_frame(w, h, idx)
        res = (640, 360) if got.shape == (360, 3 * 640) else (320, 180)
        assert got.shape == (res[1], 3 * res[0])
        want = made[res].process_rgb48(frame)
        assert np.array_equal(got.reshape(res[1], res[0], 3), want), (idx, res)
        sizes[res] = sizes.get(res, 0) + 1
    assert sizes.get((320, 180), 0) >= 5 and sizes.get((640, 360), 0) >= 20


def _synthetic_frame(w, h, idx):
    from hdrtv_tpu_torch.pipeline.source import SyntheticSource

    src = SyntheticSource(w, h, fps=30, frames=idx + 1)
    src.seek(idx)
    return src.read_with_meta()[0]


# ---------------------------------------------------------------------------
# The mesh on one card: n shards, each a thread on its own stream of cuda:0
# ---------------------------------------------------------------------------

# Sharded against single-device bytes, the largest difference in u16 codes (chip_smoke.py
# MESH_LSB): bf16 bit-equal; fp32 JAX's one code (cuBLAS picks its fp32 1×1 products by the
# pixel count: 354 values one code apart over 4 shards at 360 × 640, NVIDIA H100 80GB HBM3).
MESH_CODES = {"fp16": 0, "fp32": 1}


@pytest.mark.parametrize("precision,n", [("fp16", 2), ("fp16", 4), ("fp32", 4)])
def test_mesh_sharded_frame_matches_single_device(dev, monkeypatch, precision, n):
    """A 360 × 640 frame W-sharded over n shards on the one card (the
    default program in bf16; fp32) against the single-device eager frame:
    within MESH_CODES, and n times its launches."""
    from hdrtv_tpu_torch.parallel.mesh import spatial_mesh
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch
    from hdrtv_tpu_torch.tools.synth_hg import BASE_WEIGHTS as WEIGHTS

    monkeypatch.setenv("HDRTV_MEGAKERNEL", "1")
    h, w = 360, 640
    frame = _smooth(h, w, 7)
    single = HDRTVNetTorch(WEIGHTS, precision=precision, persistent_cache=False)
    sharded = HDRTVNetTorch(WEIGHTS, precision=precision, persistent_cache=False,
                            mesh=spatial_mesh(n, devices=[dev] * n))
    flat = frame.reshape(h, 3 * w)
    ref = single._rgb48_eager(single.put_frame(flat))
    native.reset_launch_counts()
    single._rgb48_eager(single.put_frame(flat))
    one = dict(native.launch_counts)
    native.reset_launch_counts()
    out = sharded.process_rgb48_device(sharded.put_frame(flat))
    torch.cuda.synchronize()
    assert {k: v for k, v in native.launch_counts.items() if v} == {k: n * v for k, v in one.items() if v}
    assert len(sharded.graphs) == 0  # a sharded frame runs eagerly
    d = (out.reshape(-1).to(torch.int32) - ref.reshape(-1).to(torch.int32)).abs()
    assert int(d.max()) <= MESH_CODES[precision], f"{int((d > 0).sum())} values apart, max {int(d.max())}"


def test_mesh_exchange_waits_for_the_senders_stream(dev):
    """A halo exchange reads the sender's columns only after the sender's
    stream wrote them: shard 0 writes its shard behind a long sleep on its
    own stream, and its neighbour's window still holds the new columns."""
    from hdrtv_tpu_torch.parallel import halo

    x = torch.arange(4 * 64, dtype=torch.float32, device=dev).reshape(1, 4, 64, 1)

    def body(k, part):
        with halo.manual_axis("spatial"):
            if k == 0:
                torch.cuda._sleep(50_000_000)
                part = part * 2.0
            return halo.ext(part, 4, 2)

    outs = halo.run_sharded(body, [(x.narrow(2, 16 * k, 16),) for k in range(4)], [dev] * 4)
    torch.cuda.synchronize()
    want = x.clone()
    want[:, :, :16] *= 2.0
    assert torch.equal(outs[1], want[:, :, 12:36])
    assert torch.equal(outs[0], want[:, :, 0:24])
