"""The fp32 s2d forms of the tail and agcm_head on 3×TF32 tiles, on the CPU
against hdrtv_tpu, their plain versions and float64:

- conv_last's fp32 tile (``csrc/conv_last.cuh conv_last_tf32x3_kernel``),
  the AGCM pass (``csrc/agcm_tf32x3.cuh agcm_tf32x3_kernel``) and the input
  conv (``csrc/agcm_head.cu in_conv_tf32x3_kernel``) emulated in torch
  (``ops/megakernel.py conv_last_tf32x3_emulation``, ``agcm_tf32x3_emulation``,
  ``in_conv_tf32x3_emulation``: the rna split to TF32, three products per
  chunk summed from zero, the chunk sums added in fp32) against their plain
  versions and a float64 witness, as close to it as the plain version is,
  and at least 16× closer than one TF32 product is;
- each whole fp32 s2d call emulated (the tail: the SFT pass of
  ``sft_tf32x3_emulation``, HR_conv2 as ``tests/test_torch_tf32x3.py``'s
  ``_tile_conv`` sums it over the stride-1 slot table, conv_last; the head:
  the AGCM pass, then the input conv) against the JAX ``fused_tail`` and
  ``fused_agcm_head`` in fp32 (Pallas in interpret mode) on the same numpy
  inputs: packed within 1 code, unpacked within ATOL, with and without
  up_coarse; the head within ATOL for the three frame kinds;
- the routing: the card branch of both wrappers in fp32 with ``s2d`` hands
  the tile routes (the tail: s2d = 1, the slot table and conv_last's walk;
  the head: ``agcm_head_s2d`` with the s2d pack in fp32), the fp32 tail with
  ``qargs_hr`` too (tests/test_torch_fp32_int8_tiles.py); ``s2d=False``
  stays dense; other widths raise.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_fp32_tail_head.py -q
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from hdrtv_tpu.models.s2d import b_s2d, w_s2d_1x1, w_s2d_s1
from hdrtv_tpu_torch.ops.conv_kernels import sm90_table
from hdrtv_tpu_torch.ops.megakernel import (
    _conv_same, _d2s_fine, _s2d_slots_only, agcm_head_pack_s2d, agcm_head_tf32x3_emulation, agcm_tf32x3_emulation,
    conv_last_tf32x3_emulation, fused_agcm_head_ref, in_conv_tf32x3_emulation, sft_tf32x3_emulation,
)
from tests.test_torch_s2d_1x1 import C, _tail_args
from tests.test_torch_s2d_head import NF, _frame, _head_args, _head_np, _jax_head
from tests.test_torch_tf32x3 import _tile_conv

f32 = np.float32
ATOL = 1e-4  # the fp32 kernels' check against their plain versions on the card (chip_smoke.py ATOL)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _closer(got, plain, witness, one) -> None:
    """``got`` as close to the float64 ``witness`` as ``plain`` is (twice its
    error, or 2^-22 of scale), with no drift of its mean, and ``one`` (one
    TF32 product) at least 16× farther."""
    e_got, e_plain = got.double() - witness, plain.double() - witness
    scale = max(1.0, float(witness.abs().max()))
    assert float(e_got.abs().max()) <= max(2 * float(e_plain.abs().max()), 2.0 ** -22 * scale)
    assert abs(float(e_got.mean())) <= 1e-8 * scale
    assert float(e_got.abs().max()) * 16 <= float((one.double() - witness).abs().max())


def _last_args(rng, hb, wb):
    """conv_last's inputs at the tail's widths: h ≥ 0 (a ReLU's output), a
    w_s2d_s1 weight at conv_last's scale, its bias, a skip."""
    h = torch.from_numpy(np.maximum(rng.rand(hb, wb, 128) - 0.3, 0).astype(f32))
    w = torch.from_numpy(w_s2d_s1(rng.randn(3, 3, 32, 3).astype(f32) * 0.03))
    b = torch.from_numpy(b_s2d(rng.randn(3).astype(f32) * 0.02))
    skip = torch.from_numpy((rng.rand(hb, wb, 12) * 1.1 - 0.05).astype(f32))
    return h, w, b, skip


@pytest.mark.parametrize("hb,wb", [(16, 16), (9, 70)], ids=["16x16", "9x70-ragged"])
def test_conv_last_emulation_vs_witness(hb, wb):
    """conv_last's fp32 tile, emulated (unpacked), within ATOL of the plain
    s2d conv (the populated slots, + b + skip), as close to a float64 conv
    as it is, one TF32 product ≥ 16× farther; packed, within 1 code of the
    plain pack."""
    rng = np.random.RandomState(290 + wb)
    h, w, b, skip = _last_args(rng, hb, wb)
    ws = _s2d_slots_only(w)
    got = conv_last_tf32x3_emulation(h, w, b, skip, pack=False)
    plain = _conv_same(h, ws, b) + skip
    w64 = ws.double().permute(3, 2, 0, 1)
    witness = F.conv2d(h.double().permute(2, 0, 1)[None], w64, b.double(), padding=1)[0].permute(1, 2, 0)
    witness = witness + skip.double()
    assert got.shape == plain.shape == (hb, wb, 12)
    assert _err(got, plain) < ATOL
    _closer(got, plain, witness, conv_last_tf32x3_emulation(h, w, b, skip, pack=False, products=1))
    packed = conv_last_tf32x3_emulation(h, w, b, skip, pack=True)
    u = (plain.clamp(0.0, 1.0) * 65535.0 + 0.5).to(torch.int32)
    want = torch.stack([u[..., :6], u[..., 6:]], dim=1)
    assert packed.shape == (hb, 2, wb, 6) and packed.dtype == torch.uint16
    assert int((packed.to(torch.int32) - want).abs().max()) <= 1


def _head_witness(xs, params, scale):
    """The s2d head in float64: the AGCM pass on the natural rows (blocks,
    modulation at each row's sub-position), then the input conv over each
    part's populated slots on the zero-padded result; (fea, c0, agcm)."""
    mods, aw1, ab1, aw2, ab2, aw3, ab3, w_in, b_in = [p.double() for p in params]
    x = torch.cat([xs[:, 0], xs[:, 1]], dim=-1) if xs.ndim == 4 else xs
    hb, wb, _ = x.shape
    v = x.reshape(-1, 12).double() * scale

    def rows(v, w, b):
        k, n = w.shape[0] // 4, w.shape[1] // 4
        return (v.reshape(-1, k) @ w[:k, :n] + b[:n]).reshape(*v.shape[:-1], 4 * n)

    def mod(v, row, width):
        return v * (mods[row, :width] + 1.0) + mods[row + 1, :width]

    a = torch.clamp_min(mod(rows(v, aw1, ab1), 0, 256), 0.0)
    b = torch.clamp_min(mod(rows(a, aw2, ab2), 2, 256), 0.0)
    agcm = mod(rows(b, aw3, ab3), 4, 12).reshape(hb, wb, 12)
    w = torch.cat([_s2d_slots_only(w_in[..., :NF]), _s2d_slots_only(w_in[..., NF:])], dim=-1)
    acc = F.conv2d(agcm.permute(2, 0, 1)[None], w.permute(3, 2, 0, 1), b_in, padding=1)[0].permute(1, 2, 0)
    return torch.clamp_min(acc[..., :NF], 0.0), F.leaky_relu(acc[..., NF:], 0.1), agcm


@pytest.mark.parametrize("frame", ["pairs_u8", "u8", "float"])
def test_agcm_pass_emulation_vs_witness(frame):
    """The AGCM pass's fp32 tile, emulated, within ATOL of the plain s2d
    pass, as close to the float64 pass as it is, one TF32 product each
    ≥ 16× farther. Odd sizes (7 × 70): no tile is whole."""
    rng = np.random.RandomState(292 + len(frame))
    _, at = _head_args(_head_np(rng), "f32")
    _, xt, scale = _frame(rng, frame, 7, 70, "f32")
    got = agcm_tf32x3_emulation(xt, *at[:7], scale=scale)
    plain = fused_agcm_head_ref(xt, *at, n_first=NF, scale=scale, s2d=True)[2]
    witness = _head_witness(xt, at, scale)[2]
    assert got.shape == plain.shape == (7, 70, 12)
    assert _err(got, plain) < ATOL
    _closer(got, plain, witness, agcm_tf32x3_emulation(xt, *at[:7], scale=scale, products=1))


def test_in_conv_emulation_vs_witness():
    """The input conv's fp32 tile, emulated on the plain AGCM result, within
    ATOL of the plain s2d conv (fea and c0), as close to the float64 conv of
    the same AGCM result as it is, one TF32 product ≥ 16× farther."""
    rng = np.random.RandomState(293)
    _, at = _head_args(_head_np(rng), "f32")
    _, xt, scale = _frame(rng, "pairs_u8", 9, 70, "f32")
    mods, aw1, ab1, aw2, ab2, aw3, ab3, w_in, b_in = at
    fea, c0, agcm = fused_agcm_head_ref(xt, *at, n_first=NF, scale=scale, s2d=True)
    pk = agcm_head_pack_s2d(aw1, aw2, aw3, w_in, b_in, n_first=NF)
    got = in_conv_tf32x3_emulation(agcm, n_first=NF, packed_s2d=pk)
    one = in_conv_tf32x3_emulation(agcm, n_first=NF, packed_s2d=pk, products=1)
    w = torch.cat([_s2d_slots_only(w_in[..., :NF]), _s2d_slots_only(w_in[..., NF:])], dim=-1).double()
    acc = F.conv2d(agcm.double().permute(2, 0, 1)[None], w.permute(3, 2, 0, 1), b_in.double(),
                   padding=1)[0].permute(1, 2, 0)
    witness = (torch.clamp_min(acc[..., :NF], 0.0), F.leaky_relu(acc[..., NF:], 0.1))
    for g, p, wit, o in zip(got, (fea, c0), witness, one, strict=True):
        assert g.shape == p.shape and _err(g, p) < ATOL
    _closer(torch.cat([g.reshape(-1) for g in got]), torch.cat([fea.reshape(-1), c0.reshape(-1)]),
            torch.cat([w_.reshape(-1) for w_ in witness]), torch.cat([o.reshape(-1) for o in one]))


def _tail_emulation(ta, ut, pack):
    """fused_tail(..., s2d=True) in fp32 as the card runs it: the 3×TF32 SFT
    pass on s (+ d2s(up_coarse), summed in fp32), HR_conv2 on the 3×TF32
    conv tile over the stride-1 slot table with bias and ReLU, conv_last's
    fp32 tile."""
    s, cond, skip, sft, w_hr, b_hr, w_last, b_last = ta
    x = s if ut is None else s + _d2s_fine(ut)
    table, per_list = sm90_table("tail", 1, 1, 4 * C, 4 * C, 4 * C, dtype=torch.float32)
    h = _tile_conv(sft_tf32x3_emulation(x, cond, sft), w_hr, b_hr, stride=1, a_sub=1, table=table,
                   per_list=per_list, act="relu")
    return conv_last_tf32x3_emulation(h, w_last, b_last, skip, pack=pack)


@pytest.mark.parametrize("coarse,pack", [(True, True), (False, False), (True, False), (False, True)],
                         ids=["up_coarse-packed", "s-y", "up_coarse-y", "s-packed"])
def test_tail_fp32_s2d_emulation_matches_pallas(coarse, pack):
    """The fp32 s2d tail as the card runs it, against the JAX kernel in
    interpret mode (Hb = 16: two Pallas row tiles with their halos) and the
    port's plain version: packed within 1 code, unpacked within ATOL."""
    from hdrtv_tpu.ops.megakernel import fused_tail as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_tail

    rng = np.random.RandomState(294 + 2 * coarse + pack)
    ja, ta, uj, ut = _tail_args(rng, 16, 16, "f32", coarse)
    got = _tail_emulation(ta, ut, pack)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fn(*ja, pack=pack, up_coarse=uj))
    plain = fused_tail(*ta, pack=pack, up_coarse=ut, s2d=True)
    if pack:
        assert got.shape == (16, 2, 16, 6) and got.dtype == torch.uint16
        g = got.numpy().astype(np.int64)
        assert want.max() > want.min()
        assert int(np.abs(g - want.astype(np.int64)).max()) <= 1
        assert int(np.abs(g - plain.numpy().astype(np.int64)).max()) <= 1
    else:
        assert got.shape == (16, 16, 12)
        assert _err(got, want) <= ATOL and _err(got, plain) <= ATOL


@pytest.mark.parametrize("frame", ["pairs_u8", "u8", "float"])
def test_agcm_head_fp32_s2d_emulation_matches_pallas(frame):
    """The fp32 s2d head as the card runs it (the AGCM pass's and the input
    conv's 3×TF32 tiles), against the JAX kernel in interpret mode (Hb = 16:
    two Pallas row tiles, the image's edges and the tile seam) and the port's
    plain version, fea, c0 and agcm, within ATOL."""
    from hdrtv_tpu_torch.ops.megakernel import fused_agcm_head

    rng = np.random.RandomState(297 + len(frame))
    aj, at = _head_args(_head_np(rng), "f32")
    xj, xt, scale = _frame(rng, frame, 16, 16, "f32")
    got = agcm_head_tf32x3_emulation(xt, *at, n_first=NF, scale=scale)
    want = _jax_head(xj, aj, "f32", scale)
    plain = fused_agcm_head(xt, *at, n_first=NF, scale=scale, s2d=True)
    for g, w_, p, shape in zip(got, want, plain, ((16, 16, 128), (16, 16, 256), (16, 16, 12)), strict=True):
        assert g.shape == shape
        assert _err(g, w_) <= ATOL and _err(g, p) <= ATOL


def _stub_card(monkeypatch) -> list:
    """The wrappers' card branch with CPU tensors: device checks and the
    stream stubbed, launches recorded as (kernel, dtype, counter, args)."""
    from hdrtv_tpu_torch.ops import native

    launched = []
    monkeypatch.setattr(native, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(native, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(native, "stream_of", lambda t: 0)
    monkeypatch.setattr(native, "launch", lambda kernel, dt, *args, counter=None: launched.append(
        (kernel, dt, counter, args)))
    return launched


@pytest.mark.parametrize("call", ["float", "float_unpacked", "int8", "dense"])
def test_tail_fp32_wrapper_hands_its_kernel_the_route(monkeypatch, call):
    """fp32 fused_tail's card branch: the float s2d body, packed or not, and
    the int8 s2d body (qargs_hr) hand the kernel s2d = 1, the stride-1 slot
    table and conv_last's walk; s2d=False hands the dense route (no table,
    no walk); a conv_last of another width raises on the tile route."""
    from hdrtv_tpu_torch.ops.megakernel import conv_last_walk, fused_tail
    from tests.test_torch_s2d_conv_last import _int8_tail_args

    launched = _stub_card(monkeypatch)
    rng = np.random.RandomState(298)
    _, ta, _, qt = _int8_tail_args(rng, 4, 6, "f32", False)
    fused_tail(*ta, pack=call != "float_unpacked", qargs_hr=qt if call == "int8" else None, s2d=call != "dense")
    ((kernel, dt, counter, args),) = launched
    assert kernel == "tail" and dt == torch.float32 and counter == ("tail_w8a8" if call == "int8" else None)
    walk, (hopper, table, per_list) = args[10], args[-4:-1]
    if call != "dense":
        table_want, n = sm90_table("tail", 1, 1, 4 * C, 4 * C, 4 * C, dtype=torch.float32)
        assert walk is conv_last_walk() and (hopper, per_list) == (1, n) == (1, 9)
        assert list(table) == list(table_want)
        narrow = torch.from_numpy(w_s2d_s1(rng.randn(3, 3, C, 2).astype(f32)))
        with pytest.raises(ValueError, match="conv_last's s2d tile takes"):
            fused_tail(ta[0], ta[1], torch.zeros(4, 6, 8), ta[3], ta[4], ta[5], narrow, torch.zeros(8),
                       qargs_hr=qt if call == "int8" else None, s2d=True)
    else:
        assert walk is None and (hopper, table, per_list) == (0, None, 0)


@pytest.mark.parametrize("call", ["s2d", "s2d_packed", "dense", "wide"])
def test_agcm_head_fp32_wrapper_hands_its_kernel_the_route(monkeypatch, call):
    """fp32 fused_agcm_head's card branch: with s2d it launches
    ``agcm_head_s2d`` in fp32 with the s2d pack (agcm_head_pack_s2d, built
    when none is passed, or the one passed) and the head's slot table;
    s2d=False the dense kernel with the dense pack; natural widths other than
    AGCM_S2D_WIDTHS raise on the s2d route."""
    from hdrtv_tpu_torch.ops.megakernel import _head_slots, fused_agcm_head

    launched = _stub_card(monkeypatch)
    rng = np.random.RandomState(299)
    _, at = _head_args(_head_np(rng), "f32")
    xs = torch.from_numpy((rng.rand(4, 2, 6, 6) * 255).astype(np.uint8))
    mods, aw1, ab1, aw2, ab2, aw3, ab3, w_in, b_in = at
    if call == "wide":
        aw1 = torch.from_numpy(w_s2d_1x1(rng.randn(1, 1, 3, 128).astype(f32))[0, 0])
        aw2 = torch.from_numpy(w_s2d_1x1(rng.randn(1, 1, 128, 64).astype(f32))[0, 0])
        ab1 = torch.from_numpy(b_s2d(rng.randn(128).astype(f32)))
        mods = torch.zeros(6, 512)
        with pytest.raises(ValueError, match="natural widths"):
            fused_agcm_head(xs, mods, aw1, ab1, aw2, ab2, aw3, ab3, w_in, b_in, n_first=NF, scale=1 / 255, s2d=True)
        assert not launched
        return
    from hdrtv_tpu_torch.ops import megakernel

    built = []

    def pack_s2d(*a, _fn=megakernel.agcm_head_pack_s2d, **k):
        built.append(_fn(*a, **k))
        return built[-1]

    monkeypatch.setattr(megakernel, "agcm_head_pack_s2d", pack_s2d)
    pk = agcm_head_pack_s2d(aw1, aw2, aw3, w_in, b_in, n_first=NF) if call == "s2d_packed" else None
    fused_agcm_head(xs, *at, n_first=NF, scale=1 / 255, packed_s2d=pk, s2d=call != "dense")
    ((kernel, dt, counter, args),) = launched
    assert dt == torch.float32 and counter == (None if call == "dense" else "agcm_head")
    if call == "dense":
        assert kernel == "agcm_head" and not built
        return
    assert kernel == "agcm_head_s2d" and args[1] == 2  # u8 pair planes
    if pk is None:
        (pk,) = built
    assert all(t.dtype == torch.float32 for t in pk)
    assert [args[i] for i in (5, 7, 9, 11, 12)] == [t.data_ptr() for t in pk]
    assert list(args[13]) == _head_slots()
