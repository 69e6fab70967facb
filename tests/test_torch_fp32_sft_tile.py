"""The fp32 s2d forms of sft_conv3 and resblock on the 3×TF32 tiles, on the
CPU against hdrtv_tpu and their plain versions:

- the SFT pass of ``csrc/sft_tf32x3.cuh`` emulated in torch
  (``ops/megakernel.py sft_tf32x3_emulation``: the rna split to TF32, the
  three products of each 16-deep product summed from zero, the leaky ReLU
  between, t's multiply and add rounded apart) against the plain s2d pass
  and a float64 witness, and at least 16× closer to the witness than one
  TF32 product is;
- each whole fp32 s2d call emulated (that pass, and
  ``tests/test_torch_tf32x3.py``'s ``_tile_conv`` over ``sm90_table``'s
  stride-1 slot table for the convs), in every form (relu, skip, up_coarse,
  x_add), against the JAX ``fused_sft_conv3_v2`` and ``fused_resblock`` in
  fp32 (Pallas in interpret mode) and the port's plain versions, within
  ATOL;
- the routing: ``_sft_hopper`` and the wrappers' card branch give the tile
  route to fp32 sft_conv3, resblock and the tail with ``s2d``, and to the
  fp32 int8 sft_conv3 and tail (the int8-output mode and the s8 tile:
  tests/test_torch_fp32_int8_tiles.py), the dense route to fp32 resblock
  with qargs.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_fp32_sft_tile.py -q
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hdrtv_tpu_torch.ops.conv_kernels import sm90_table
from hdrtv_tpu_torch.ops.megakernel import (
    SFT_Q8_F32, SFT_TF32X3, _d2s_fine, _sft_hopper, _sft_t_rows, fused_resblock, fused_sft_conv3_v2,
    sft_tf32x3_emulation,
)
from tests.test_torch_s2d_sft import C, CC, _resblock_args, _sft4, _sft_conv_args
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


def _witness(x, cond, sft4) -> torch.Tensor:
    """The s2d SFT pass in float64: the rows of natural pixels against each
    weight's first diagonal block."""
    def rows(v, w, b):
        k, n = w.shape[0] // 4, w.shape[1] // 4
        return (v.reshape(-1, k) @ w[:k, :n].double() + b[:n].double()).reshape(*v.shape[:-1], 4 * n)

    cd = cond.double()
    hs = torch.nn.functional.leaky_relu(rows(cd, *sft4[0]), 0.1)
    hh = torch.nn.functional.leaky_relu(rows(cd, *sft4[2]), 0.1)
    return x.double() * (rows(hs, *sft4[1]) + 1.0) + rows(hh, *sft4[3])


def _table():
    return sm90_table("sft_conv3", 1, 1, 4 * C, 4 * C, 4 * C, dtype=torch.float32)


def _conv(t, w, b, **kw):
    """A 3×3 conv of the fp32 s2d forms as the 3×TF32 tile sums it over the
    stride-1 slot table."""
    table, per_list = _table()
    return _tile_conv(t, w, b, stride=1, a_sub=1, table=table, per_list=per_list, **kw)


@pytest.mark.parametrize("hb,wb,scale", [(16, 16, 0.05), (9, 15, 0.3)], ids=["16x16", "9x15-wide"])
def test_sft_pass_emulation_vs_witness(hb, wb, scale):
    """The emulated 3×TF32 SFT pass within ATOL of the plain s2d pass, as
    close to the float64 witness as the plain pass is, with no drift of its
    mean; one TF32 product each lies at least 16× farther from the witness."""
    rng = np.random.RandomState(5 + hb)
    x = torch.from_numpy((rng.rand(hb, wb, 4 * C) * 1.3 - 0.3).astype(f32))
    cond = torch.from_numpy((rng.rand(hb, wb, 4 * CC) * 1.3 - 0.3).astype(f32))
    _, sft = _sft4(rng, "f32", scale)
    got = sft_tf32x3_emulation(x, cond, sft)
    plain = _sft_t_rows(x, cond, sft, torch.float32)
    witness = _witness(x, cond, sft)
    assert got.shape == plain.shape == (hb, wb, 4 * C)
    assert _err(got, plain) < ATOL
    e_got, e_plain = got.double() - witness, plain.double() - witness
    assert float(e_got.abs().max()) <= max(2 * float(e_plain.abs().max()), 2.0 ** -22)
    assert abs(float(e_got.mean())) <= 1e-8
    one = sft_tf32x3_emulation(x, cond, sft, products=1)
    assert float(e_got.abs().max()) * 16 <= float((one.double() - witness).abs().max())


@pytest.mark.parametrize("relu,skip", [(True, False), (False, True)], ids=["relu", "skip"])
def test_sft_conv3_fp32_s2d_emulation_matches_pallas(relu, skip):
    """fp32 sft_conv3 with s2d as the card runs it (the 3×TF32 SFT pass, then
    the 3×TF32 conv over the slot table, bias, skip, ReLU), against the JAX
    kernel in interpret mode and the port's plain version, within ATOL."""
    from hdrtv_tpu.ops.megakernel import fused_sft_conv3_v2 as jax_fn

    rng = np.random.RandomState(281 + relu)
    ja, ta, sj, st = _sft_conv_args(rng, 16, 16, "f32", skip)
    x, cond, sft, w, b = ta
    got = _conv(sft_tf32x3_emulation(x, cond, sft), w, b, act="relu" if relu else None, skip=st)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(*ja, relu=relu, skip=sj)
    plain = fused_sft_conv3_v2(*ta, relu=relu, skip=st, s2d=True)
    assert got.shape == plain.shape == (16, 16, 4 * C)
    assert _err(got, want) <= ATOL and _err(got, plain) <= ATOL


@pytest.mark.parametrize("second", [None, "up_coarse", "x_add"])
def test_resblock_fp32_s2d_emulation_matches_pallas(second):
    """fp32 resblock with s2d as the card runs it: SFT1 on x (+ the second
    input, summed in fp32: xsum), conv1 + ReLU → h1, SFT2 on h1, conv2 + the
    residual (xsum), against the JAX kernel in interpret mode and the port's
    plain version, within ATOL."""
    from hdrtv_tpu.ops.megakernel import fused_resblock as jax_fn

    rng = np.random.RandomState(291 + (second is not None) + (second == "x_add"))
    ja, ta, kj, kt = _resblock_args(rng, 16, 16, "f32", second)
    x, cond, sft1, w1, b1, sft2, w2, b2 = ta
    xin = x
    if second == "up_coarse":
        xin = x + _d2s_fine(kt[second])
    elif second == "x_add":
        xin = x + kt[second]
    h1 = _conv(sft_tf32x3_emulation(xin, cond, sft1), w1, b1, act="relu")
    got = _conv(sft_tf32x3_emulation(h1, cond, sft2), w2, b2, skip=xin)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(*ja, **kj)
    plain = fused_resblock(*ta, **kt, s2d=True)
    assert got.shape == plain.shape == (16, 16, 4 * C)
    assert _err(got, want) <= ATOL and _err(got, plain) <= ATOL


def test_sft_hopper_routes_fp32_s2d_calls():
    """fp32 with s2d: sft_conv3, resblock and the tail get the 3×TF32 tiles'
    route with the fp32 stride-1 slot table (9 chunks a list), and so do
    sft_conv3 and the tail with qargs (SFT_Q8_F32: the int8-output mode and
    the s8 tile); resblock with qargs and s2d=False get the dense route;
    natural widths other than (16, 32) raise on the tile route."""
    f = torch.float32
    table, per_list = sm90_table("sft_conv3", 1, 1, 4 * C, 4 * C, 4 * C, dtype=f)
    assert SFT_TF32X3 == ("sft_conv3", "resblock", "tail") and SFT_Q8_F32 == ("sft_conv3", "tail")
    for name in SFT_TF32X3:
        for quant in (False, True):
            hopper, got, n = _sft_hopper(name, True, f, 4 * CC, 4 * C, 4 * C, quant=quant)
            if quant and name not in SFT_Q8_F32:
                assert (hopper, got, n) == (0, None, 0)
                continue
            assert (hopper, n) == (1, per_list) == (1, 9) and list(got) == list(table)
            with pytest.raises(ValueError, match="row tile"):
                _sft_hopper(name, True, f, 4 * 32, 4 * 64, 4 * 64, quant=quant)
        assert _sft_hopper(name, False, f, 4 * CC, 4 * C, 4 * C) == (0, None, 0)
        assert _sft_hopper(name, False, f, 4 * CC, 4 * C, 4 * C, quant=True) == (0, None, 0)
    assert _sft_hopper("resblock", True, f, 4 * CC, 4 * C, 4 * C, quant=True) == (0, None, 0)
    assert _sft_hopper("sft_conv3", True, torch.bfloat16, 4 * CC, 4 * C, 4 * C, quant=True)[0] == 1


@pytest.mark.parametrize("call", ["sft_conv3", "resblock", "resblock_up", "tail", "sft_conv3_w8a8",
                                  "resblock_w8a8", "tail_w8a8"])
def test_fp32_wrappers_hand_their_kernels_the_route(monkeypatch, call):
    """The card branch of the wrappers in fp32, their launch intercepted
    (device checks and the stream stubbed, CPU tensors standing in): the
    float s2d sft_conv3 and resblock hand the kernel s2d = 1 and the slot
    table and count under their own names (resblock with up_coarse also its
    xsum scratch, fp32), and so does the float s2d tail; the int8 bodies of
    sft_conv3 and the tail hand the same route (their SFT's int8-output mode,
    the s8 tile) and count as *_w8a8, resblock's int8 body hands the dense
    route."""
    from hdrtv_tpu_torch.ops import native
    from hdrtv_tpu_torch.ops.megakernel import fused_tail
    from tests.test_torch_s2d_int8 import _int8_layer

    launched = []
    monkeypatch.setattr(native, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(native, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(native, "stream_of", lambda t: 0)
    monkeypatch.setattr(native, "launch", lambda kernel, dt, *args, counter=None: launched.append(
        (kernel, dt, counter, args)))
    rng = np.random.RandomState(17)
    _, (x, cond, sft, w, b), _, _ = _sft_conv_args(rng, 4, 6, "f32", False)
    qa = _int8_layer(rng, True) if call.endswith("w8a8") else None
    if call.startswith("tail"):
        fused_tail(x, cond, torch.zeros(4, 6, 12), sft, w, b, torch.zeros(3, 3, 4 * C, 12), torch.zeros(12),
                   qargs_hr=qa, s2d=True)
        want = ("tail", "tail_w8a8" if qa else None)
    elif call.startswith("sft_conv3"):
        fused_sft_conv3_v2(x, cond, sft, w, b, relu=True, qargs=qa, s2d=True)
        want = ("sft_conv3", "sft_conv3_w8a8" if qa else None)
    else:
        up = torch.zeros(2, 3, 16 * C) if call == "resblock_up" else None
        fused_resblock(x, cond, sft, w, b, sft, w, b, up_coarse=up, qargs1=qa, qargs2=qa, s2d=True)
        want = ("resblock", "resblock_w8a8" if qa else None)
    (kernel, dt, counter, args), = launched
    assert (kernel, counter) == want and dt == torch.float32
    hopper, table, per_list = args[-4:-1]
    if call in ("sft_conv3", "resblock", "resblock_up", "tail", "sft_conv3_w8a8", "tail_w8a8"):
        assert (hopper, per_list) == (1, 9) and list(table) == list(_table()[0])
    else:
        assert (hopper, table, per_list) == (0, None, 0)
