"""The ``s2d=True`` declaration of the port's ``fused_tail`` over ``w_last``,
and the routes of the tail's conv_last and of block_conv3_w8a8 in fp32
(hdrtv_tpu_torch/ops/megakernel.py, ops/conv_kernels.py), on the CPU.

With ``s2d=True`` in bf16 on the card the tail's conv_last runs the Hopper
tile of csrc/conv_last.cuh, which multiplies only the 16 (tap, input
sub-position) slots of ``w_last`` that some output sub-position reads, each
into the sub-positions it feeds (``conv_last_walk``, the union of
``models/s2d.py s2d_slots(1)``; the tile's N tiles are the two output row
parities, whose columns for a sub-position the slot does not feed hold
zeros); the plain version honours the declaration with
``_s2d_slots_only(w_last)``.

- Both checkpoints' ``LE.conv_last.weight`` as the processor loads them has
  that structure, so the skip is exact on them.
- The walk is exactly the union of ``s2d_slots(1)``; the slots' weight rows
  the tile stages, scattered back per sub-position, are
  ``_s2d_slots_only(w_last)``; the walk's sum equals the conv of
  ``_s2d_slots_only(w_last)``.
- On such weights the port's ``fused_tail(..., s2d=True)`` equals the JAX
  kernel in interpret mode in the int8 body too (fp32 and bf16, packed and
  unpacked; the float body is tests/test_torch_s2d_1x1.py's), and a
  ``w_last`` with a weight off the slots gives another result than the JAX
  kernel's: the skip is visible.
- The frame programs hand the tail C = 128, Cl = 12 with ``s2d=True`` on
  every call, and the wrapper hands its kernel the walk for s2d calls (bf16,
  and fp32 float or int8) only; the int8 fp32 program's twelve block_conv3 calls with qargs all
  declare ``a_sub`` = 1 at widths the wgmma s8 tile takes, and the wrapper
  hands them its slot table.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_s2d_conv_last.py -q
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hdrtv_tpu.models.s2d import b_s2d, w_s2d_1x1, w_s2d_s1
from tests.test_torch_int8 import FIXTURE, _flip_bound, _layer, _t_range

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
f32 = np.float32
CC, C = 16, 32  # natural widths of the tail's SFT and convs in the frame programs


def _both(a, dtype="f32"):
    """One numpy array as a JAX and a torch array, rounded once to bf16 for ``bf16``."""
    a = np.ascontiguousarray(a, f32)
    j, t = jnp.asarray(a), torch.from_numpy(a.copy())
    if dtype == "bf16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _walk():
    """conv_last_walk decoded: (tap, si, so mask) per slot."""
    from hdrtv_tpu_torch.ops.megakernel import conv_last_walk

    return [(e & 15, (e >> 4) & 15, e >> 8) for e in conv_last_walk()]


@pytest.mark.parametrize("weights", [WEIGHTS, FIXTURE], ids=["float", "int8"])
def test_checkpoints_conv_last_has_the_s2d_structure(weights):
    """LE.conv_last.weight as HDRTVNetTorch loads it (the float checkpoint,
    and the W8A8 one pre-dequantized: conv_last stays float there) is a
    w_s2d_s1 transform, (3, 3, 128, 12), zero outside the populated slots."""
    from hdrtv_tpu_torch.ops.megakernel import _s2d_slots_only
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    p = HDRTVNetTorch(weights, device="cpu").params
    w = p["LE.conv_last.weight"]
    assert tuple(w.shape) == (3, 3, 4 * C, 12) and bool((w != 0).any())
    assert torch.equal(_s2d_slots_only(w), w)


def test_conv_last_walk_is_the_union_of_the_slots():
    """16 slots in (tap, si) order, each with the output sub-positions that
    read it: the centre tap's 4 slots feed all four, the edges' 2 feed two,
    the corners' 1 one; 36 (slot, so) pairs, each so's 9 slots exactly,
    and 24 (slot, row parity) pairs, the tile's N tiles."""
    from hdrtv_tpu_torch.models.s2d import s2d_slots

    walk = _walk()
    assert [(t, si) for t, si, _ in walk] == sorted({slot for slots in s2d_slots(1) for slot in slots})
    assert len(walk) == 16 and sum(bin(m).count("1") for _, _, m in walk) == 36
    for so, slots in enumerate(s2d_slots(1)):
        assert {(t, si) for t, si, m in walk if m >> so & 1} == set(slots)
    assert sorted(bin(m).count("1") for t, _, m in walk if t == 4) == [4] * 4
    assert sum(bool(m & 3) + bool(m & 12) for _, _, m in walk) == 24


def _staged_rows(w_last: torch.Tensor) -> torch.Tensor:
    """The weight rows the tile copies into shared memory: per walk slot
    (tap, si) the 32 rows (tap, si·32 + k) of all 12 outputs, (16, 32, 12)."""
    w9 = w_last.reshape(9, 4 * C, 12)
    return torch.stack([w9[tap, si * C:(si + 1) * C] for tap, si, _ in _walk()])


def _unstage(rows: torch.Tensor) -> torch.Tensor:
    """The (3, 3, 128, 12) weight the tile multiplies: for each staged slot
    and each row parity a it feeds, B's columns n < 6 (channel 6a + n,
    sub-position 2a + n // 3) kept where the slot feeds that sub-position,
    zero where it does not."""
    w9 = torch.zeros(9, 4 * C, 12, dtype=rows.dtype)
    for (tap, si, mask), r in zip(_walk(), rows, strict=True):
        for a in range(2):
            if mask >> 2 * a & 3:
                for n in range(6):
                    if mask >> (2 * a + n // 3) & 1:
                        w9[tap, si * C:(si + 1) * C, 6 * a + n] = r[:, 6 * a + n]
    return w9.reshape(3, 3, 4 * C, 12)


@pytest.mark.parametrize("structured", [True, False], ids=["w_s2d_s1", "dense"])
def test_staged_slots_unpack_to_the_slots_only_weight(structured):
    """What the tile stages and multiplies, scattered back, is
    _s2d_slots_only(w_last), for a w_s2d_s1 weight (then w_last itself) and
    for a dense one (the weights off the slots are what it skips)."""
    from hdrtv_tpu_torch.ops.megakernel import _s2d_slots_only

    rng = np.random.RandomState(3)
    w = w_s2d_s1(rng.randn(3, 3, C, 3).astype(f32)) if structured else rng.randn(3, 3, 4 * C, 12).astype(f32)
    w = torch.from_numpy(w).to(torch.bfloat16)
    got = _unstage(_staged_rows(w))
    assert torch.equal(got, _s2d_slots_only(w))
    assert torch.equal(got, w) == structured


def test_walk_sum_equals_the_slots_only_conv():
    """The tile's sum, walked as it walks (per slot one 32-channel slice of
    h at the tap's shift, into each sub-position it feeds), in fp32 over bf16
    h and weights, equals the 'same' conv of _s2d_slots_only(w_last), border
    pixels (zero outside the image) included, to fp32 rounding."""
    from hdrtv_tpu_torch.ops.megakernel import _conv_same, _s2d_slots_only

    rng = np.random.RandomState(5)
    hb, wb = 7, 10
    h = torch.from_numpy(np.maximum(rng.rand(hb, wb, 4 * C) - 0.3, 0).astype(f32)).to(torch.bfloat16).float()
    w = torch.from_numpy(rng.randn(3, 3, 4 * C, 12).astype(f32) * 0.05).to(torch.bfloat16).float()
    hp = torch.nn.functional.pad(h, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(hb, wb, 12)
    for tap, si, mask in _walk():
        a = hp[tap // 3:tap // 3 + hb, tap % 3:tap % 3 + wb, si * C:(si + 1) * C]
        for so in range(4):
            if mask >> so & 1:
                acc[..., 3 * so:3 * so + 3] += a @ w[tap // 3, tap % 3, si * C:(si + 1) * C, 3 * so:3 * so + 3]
    want = _conv_same(h, _s2d_slots_only(w), torch.zeros(12))
    assert float((acc - want).abs().max()) <= 1e-5
    assert float((_conv_same(h, w, torch.zeros(12)) - want).abs().max()) > 1e-2


def _int8_tail_args(rng, hb, wb, dtype, asym, w_last=None):
    """The tail's inputs for both sides with HR_conv2's int8 layer, the SFT
    weights w_s2d_1x1, w_last w_s2d_s1 (or the one given)."""
    sj, st = _both(rng.rand(hb, wb, 4 * C) * 0.6, dtype)
    cj, ct = _both(rng.rand(hb, wb, 4 * CC), dtype)
    kj, kt = _both(rng.rand(hb, wb, 12), dtype)
    sft = []
    for ci, co in ((CC, CC), (CC, C), (CC, CC), (CC, C)):
        wj, wt = _both(w_s2d_1x1(rng.randn(1, 1, ci, co).astype(f32) * 0.05)[0, 0], dtype)
        bj, bt = _both(b_s2d(rng.randn(co).astype(f32) * 0.1))
        sft.append(((wj, bj), (wt, bt)))
    sftj, sftt = [p[0] for p in sft], [p[1] for p in sft]
    (whj, wht), (bhj, bht), (qj, qt) = _layer(rng, 4 * C, 4 * C, _t_range(st, ct, sftt, dtype), asym)
    wl = w_s2d_s1(rng.randn(3, 3, C, 3).astype(f32) * 0.04) if w_last is None else w_last
    wlj, wlt = _both(wl, dtype)
    blj, blt = _both(b_s2d(rng.randn(3).astype(f32) * 0.1))
    jax_args = (sj, cj, kj, sftj, whj.astype(sj.dtype), bhj, wlj, blj)
    port_args = (st, ct, kt, sftt, wht.to(st.dtype), bht, wlt, blt)
    return jax_args, port_args, qj, qt


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pack", [True, False], ids=["packed", "y"])
def test_tail_int8_s2d_matches_pallas(dtype, pack):
    """The int8 body (HR_conv2 on qargs_hr) with s2d=True, conv_last over
    w_last's populated slots, against the JAX kernel in interpret mode
    (Hb = 16: two Pallas row tiles with their halos), asymmetric. Packed:
    test_tail_int8_plain_matches_pallas's bounds, 8 codes and 3.4e-2 of them
    differing. Unpacked: each y within two flipped codes of t under one 3 × 3
    window moving h (max|w_last|·(flip + a bf16 step of h), doubled; in
    fp32 no step), plus one bf16 step of y in bf16, on at most 3.4e-2 of the
    values beyond fp32 rounding."""
    from hdrtv_tpu.ops.megakernel import fused_tail as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_tail

    rng = np.random.RandomState(210 + 2 * (dtype == "bf16") + pack)
    hb, wb = 16, 16
    ja, ta, qj, qt = _int8_tail_args(rng, hb, wb, dtype, True)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fn(*ja, pack=pack, qargs_hr=qj).astype(jnp.float32))
    got = fused_tail(*ta, pack=pack, qargs_hr=qt, s2d=True)
    if pack:
        assert got.shape == (hb, 2, wb, 6) and got.dtype == torch.uint16
        d = np.abs(got.numpy().astype(np.int64) - want.astype(np.int64))
        assert want.max() > want.min()
        assert d.max() <= 8 and (d > 0).mean() <= 3.4e-2, (int(d.max()), float((d > 0).mean()))
        return
    assert got.shape == (hb, wb, 12) and got.dtype == ta[0].dtype
    g = got.float().numpy()
    step_h = 2.0 ** -7 if dtype == "bf16" else 0.0  # |h| < 1 here
    bound = 2 * float(np.abs(np.asarray(ja[6].astype(jnp.float32))).max()) * (_flip_bound(qt) + step_h)
    if dtype == "bf16":
        bound = bound + 2.0 ** -7 * np.maximum(1.0, np.abs(want))
    err = np.abs(g - want)
    assert (err <= bound + 1e-6).all(), float(err.max())
    assert float((err > 1e-6).mean()) <= 3.4e-2, float((err > 1e-6).mean())


def test_conv_last_skip_is_visible():
    """A w_last with weights in a slot the declaration says is zero (tap
    (−1, −1), input sub-position 0: outside every output sub-position's 3 × 3
    window): with s2d=True the port ignores them and differs from the JAX
    kernel (which multiplies them); with s2d=False it takes them and agrees.
    fp32, float body, 8 × 8 blocks."""
    from hdrtv_tpu.ops.megakernel import fused_tail as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_tail

    rng = np.random.RandomState(221)
    hb, wb = 8, 8
    w_last = w_s2d_s1(rng.randn(3, 3, C, 3).astype(f32) * 0.04)
    w_last[0, 0, :C, :] = rng.randn(C, 12) * 0.1
    sj, st = _both(rng.rand(hb, wb, 4 * C))
    cj, ct = _both(rng.rand(hb, wb, 4 * CC))
    kj, kt = _both(rng.rand(hb, wb, 12))
    sft = []
    for ci, co in ((CC, CC), (CC, C), (CC, CC), (CC, C)):
        sft.append((_both(w_s2d_1x1(rng.randn(1, 1, ci, co).astype(f32) * 0.05)[0, 0]), _both(b_s2d(rng.randn(co)))))
    whj, wht = _both(w_s2d_s1(rng.randn(3, 3, C, C).astype(f32) * 0.02))
    bhj, bht = _both(b_s2d(rng.randn(C).astype(f32) * 0.1))
    wlj, wlt = _both(w_last)
    blj, blt = _both(b_s2d(rng.randn(3).astype(f32) * 0.1))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fn(sj, cj, kj, [(w[0], b[0]) for w, b in sft], whj, bhj, wlj, blj, pack=False))
    skip, dense = (fused_tail(st, ct, kt, [(w[1], b[1]) for w, b in sft], wht, bht, wlt, blt, pack=False,
                              s2d=s2d).numpy() for s2d in (True, False))
    np.testing.assert_allclose(dense, want, atol=3e-5)
    assert float(np.abs(skip - want).max()) > 1e-2


def _spy(monkeypatch, name):
    """Record the shapes and keywords of every call the frame programs make
    to ``models/s2d.py``'s ``name``."""
    from hdrtv_tpu_torch.models import s2d as port_s2d

    calls = []

    def spy(*a, _fn=getattr(port_s2d, name), **k):
        calls.append(([tuple(x.shape) if isinstance(x, torch.Tensor) else None for x in a], k))
        return _fn(*a, **k)

    monkeypatch.setattr(port_s2d, name, spy)
    return calls


@pytest.mark.parametrize("program", ["float", "int8", "int8_down2", "hg", "int8_hg"])
def test_bf16_programs_tail_calls_take_the_conv_last_tile(monkeypatch, tmp_path, program):
    """One small frame of each bf16 program that calls the tail (the
    megakernel program on the float and W8A8 checkpoints, the latter with
    HDRTV_INT8_DOWN2=1 too, and the HG composite over either, whose base
    hands the tail's output over unpacked): one tail call, s2d=True, h 128
    channels and w_last (3, 3, 128, 12), the widths conv_last's tile takes."""
    from hdrtv_tpu_torch.ops.megakernel import CONV_LAST_S2D_WIDTHS
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch
    from hdrtv_tpu_torch.tools.synth_hg import write_synth_hg

    calls = _spy(monkeypatch, "fused_tail")
    monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    if program == "int8_down2":
        monkeypatch.setenv("HDRTV_INT8_DOWN2", "1")
    else:
        monkeypatch.delenv("HDRTV_INT8_DOWN2", raising=False)
    base = FIXTURE if program.startswith("int8") else WEIGHTS
    path = write_synth_hg(str(tmp_path / "hg.npz"), nf=8, seed=5, base_path=base) if program.endswith("hg") else base
    proc = HDRTVNetTorch(path, device="cpu")
    proc.process_rgb48((np.random.RandomState(91).rand(64, 96, 3) * 255).astype(np.uint8))
    assert len(calls) == 1, calls
    shapes, kw = calls[0]
    assert kw.get("s2d") is True and kw.get("pack", True) == (not program.endswith("hg"))
    assert (shapes[0][-1], shapes[6][-1]) == CONV_LAST_S2D_WIDTHS and shapes[6] == (3, 3, 128, 12)
    assert (kw.get("qargs_hr") is not None) == program.startswith("int8")


@pytest.mark.parametrize("call", ["bf16", "bf16_int8", "bf16_dense", "fp32", "fp32_int8"])
def test_tail_wrapper_hands_its_kernel_the_walk(monkeypatch, call):
    """The card branch of fused_tail, its launch intercepted (device checks
    and the stream stubbed, CPU tensors standing in): bf16 s2d calls, float
    or int8, and fp32 s2d calls, float or int8 (conv_last's fp32 tile), hand
    the kernel conv_last_walk; bf16 s2d=False hands none; a bf16 s2d call
    with Cl other than 12 raises."""
    from hdrtv_tpu_torch.ops import native
    from hdrtv_tpu_torch.ops.megakernel import conv_last_walk, fused_tail

    launched = []
    monkeypatch.setattr(native, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(native, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(native, "stream_of", lambda t: 0)
    monkeypatch.setattr(native, "launch", lambda kernel, dt, *args, counter=None: launched.append(args))
    rng = np.random.RandomState(9)
    dtype = "bf16" if call.startswith("bf16") else "f32"
    _, ta, _, qt = _int8_tail_args(rng, 4, 6, dtype, False)
    s2d = call != "bf16_dense"
    fused_tail(*ta, qargs_hr=qt if call.endswith("int8") else None, s2d=s2d)
    (args,) = launched
    walk = args[10]
    if s2d:
        assert walk is conv_last_walk() and args[-4] == 1
    else:
        assert walk is None and args[-4] == 0
    if dtype == "bf16":
        narrow = torch.from_numpy(w_s2d_s1(rng.randn(3, 3, C, 2).astype(f32))).to(torch.bfloat16)
        with pytest.raises(ValueError, match="conv_last's s2d tile takes"):
            fused_tail(ta[0], ta[1], torch.zeros(4, 6, 8, dtype=torch.bfloat16), ta[3], ta[4], ta[5], narrow,
                       torch.zeros(8), s2d=True)


def test_int8_fp32_program_block_conv3_calls_fit_the_s8_tile(monkeypatch):
    """One 64 × 128 frame of the int8 fp32 program (the W8A8 checkpoint at
    precision fp32) on the CPU: its twelve block_conv3 calls with qargs
    (HR_conv1/2, the trunk convs, the up convs) all declare a_sub = 1, C =
    128, Co 128 or 512, widths the wgmma s8 tile takes, in fp32; the trunk
    conv2s pass an fp32 skip."""
    from hdrtv_tpu_torch.models import s2d as port_s2d
    from hdrtv_tpu_torch.ops.conv_kernels import s8_sm90_table
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    calls = []

    def spy(x, w, b, *, _fn=port_s2d.fused_block_conv3, **k):
        if k.get("qargs") is not None:
            sk = k.get("skip")
            calls.append((k.get("a_sub", 0), x.shape[-1], w.shape[-1], x.dtype, None if sk is None else sk.dtype))
        return _fn(x, w, b, **k)

    monkeypatch.setattr(port_s2d, "fused_block_conv3", spy)
    monkeypatch.delenv("HDRTV_INT8_DOWN2", raising=False)
    monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    proc = HDRTVNetTorch(FIXTURE, precision="fp32", device="cpu")
    proc.process_rgb48((np.random.RandomState(117).rand(64, 128, 3) * 255).astype(np.uint8))
    assert len(calls) == 12, calls
    assert sum(co == 4 * 4 * C for _, _, co, _, _ in calls) == 2
    assert sum(sk is not None for *_, sk in calls) == 4
    for a_sub, c, co, dt, sk in calls:
        assert (a_sub, c, dt) == (1, 4 * C, torch.float32) and sk in (None, torch.float32)
        assert s8_sm90_table("block_conv3", a_sub, c, co)[1] == 9


def test_block_conv3_w8a8_fp32_wrapper_hands_the_s8_table(monkeypatch):
    """The card branch of fused_block_conv3's int8 body in fp32 with a_sub =
    1 and an fp32 skip (a trunk conv2): the slot table s8_sm90_table gives;
    a width the tile does not take raises rather than running dense."""
    from hdrtv_tpu_torch.ops import native
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3, s8_sm90_table

    launched = []
    monkeypatch.setattr(native, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(native, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(native, "stream_of", lambda t: 0)
    monkeypatch.setattr(native, "launch", lambda kernel, dt, *args, counter=None: launched.append((dt, counter, args)))
    rng = np.random.RandomState(11)
    (_, w), (_, b), (_, qa) = _layer(rng, 4 * C, 4 * C, (-0.5, 1.0), False)
    x = torch.from_numpy(rng.rand(4, 6, 4 * C).astype(f32))
    fused_block_conv3(x, w, b, skip=torch.zeros(4, 6, 4 * C), qargs=qa, a_sub=1)
    ((dt, counter, args),) = launched
    assert (dt, counter) == (torch.float32, "block_conv3_w8a8")
    assert list(args[-3]) == list(s8_sm90_table("block_conv3", 1, 4 * C, 4 * C)[0]) and args[-2] == 9
    (_, w2), (_, b2), (_, q2) = _layer(rng, 4 * 16, 4 * 16, (-0.5, 1.0), False)
    with pytest.raises(ValueError, match="wgmma s8 tile takes"):
        fused_block_conv3(torch.from_numpy(rng.rand(4, 6, 64).astype(f32)), w2, b2, qargs=q2, a_sub=1)
