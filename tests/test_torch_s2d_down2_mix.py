"""The int8 body of the port's ``fused_down2`` on the stride-2 slot table
(down2_w8a8 with ``a_sub`` ≥ 1) and the ``s2d=True`` form of
``fused_mix_chain`` (the CondNet2 tail), on the CPU.

In bf16 on the card, down2_w8a8 with ``a_sub`` ≥ 1 quantizes its window once
into one code plane per branch and runs the wgmma s8 tile of
csrc/conv3x3_s8_sm90.cuh at stride 2 over the slot table of
``s2d_slots(2)`` (C = 256, ``a_sub`` 1 or 3: the consolidated CondNet down
conv and CondNet3.2/4.2 on its output's windows); mix_chain with
``s2d=True`` runs the row tile of csrc/chain_sm90.cuh (natural widths 64 →
64 → 16) on the diagonal blocks of its w_s2d_1x1 weights.

- down2: the port's plain int8 form equals the Pallas int8 body in
  interpret mode, symmetric and asymmetric, three branches and a ``ch0``
  window: bf16 within one step on at most SHARE of the values (XLA on the
  CPU contracts the body's ``acc·yscale + b`` into one FMA, the port keeps
  two ops: tests/test_torch_int8_rest.py). The tile's K walk over the
  stride-2 slots gives the dense int32 sums exactly, out-of-image taps
  carrying each branch's pad code; the fixture's int8 down weights are zero
  outside the slots; ``s8_sm90_table`` takes the widths the program has and
  refuses others; every down2 call of the ``HDRTV_INT8_DOWN2=1`` programs
  fits it; the card branch of the wrapper hands the kernel the table.
- mix_chain: on w_s2d_1x1 weights the port's s2d form equals the JAX kernel
  in interpret mode (fp32 2e-5; bf16 one step on at most 2% of the values:
  the same exact products summed in fp32 in another order, rounded at the
  same places); a weight off the declared structure gives another result;
  widths that are not four blocks raise, and the card branch takes the row
  tile in bf16 only, for the program's chain only.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_s2d_down2_mix.py -q
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hdrtv_tpu.models.s2d import b_s2d, w_s2d_1x1, w_s2d_s2
from tests.test_torch_int8 import FIXTURE
from tests.test_torch_int8_rest import _calib, _close, _qnat
from tests.test_torch_s2d_1x1 import _both, _check

f32 = np.float32
C = 256  # s2d channels of every int8 down conv's input (natural 64)
CO_NAT = 64  # natural output channels of one branch
# (hb, wb, cf, cin, ch0, branches): the consolidated conv over its whole input, and
# CondNet4.2 on the last of three windows of a wider tensor
DOWN2_CASES = {"branches3": (24, 32, C, None, 0, 3), "window": (24, 32, 3 * C, C, 2 * C, 1)}


def _down2_layer(rng, nb, x, ch0, asym):
    """An int8 down conv of ``nb`` branches for both sides: each branch's
    natural weight quantized per output channel and w_s2d_s2-transformed,
    its activation calibrated on the window (shifted per branch). Returns the
    JAX qargs dict, the port's QArgs (one per branch, with JAX's folded bias,
    as test_down2_int8_plain_matches_pallas builds them) and the raw bias."""
    from hdrtv_tpu_torch.ops.w8a8 import pack_qargs

    wqs, wss = zip(*[_qnat(rng, C // 4, CO_NAT) for _ in range(nb)])
    tq = np.concatenate([w_s2d_s2(w) for w in wqs], axis=-1)
    tsc = np.concatenate([b_s2d(s) for s in wss])
    co = tq.shape[-1]
    b = (rng.randn(co) * 0.1).astype(f32)
    xw = x[..., ch0 : ch0 + C].float()
    cal = [_calib(float(xw.min()) - 0.05 * i, float(xw.max()) + 0.1 * i, asym) for i in range(nb)]
    qj = {"w_int8": jnp.asarray(tq), "w_scale": jnp.asarray(tsc)}
    if nb > 1:
        qj["x_scales"] = jnp.asarray([s for s, _ in cal], jnp.float32)
        if asym:
            qj["x_zeros"] = jnp.asarray([z for _, z in cal], jnp.float32)
    else:
        qj["x_scale"] = jnp.float32(cal[0][0])
        if asym:
            qj["x_zero"] = jnp.float32(cal[0][1])
    bj = jnp.asarray(b)
    if asym:
        xs = jnp.repeat(jnp.asarray([s for s, _ in cal], jnp.float32), co // nb)
        wsum = (jnp.asarray(tq).astype(jnp.float32) * jnp.asarray(tsc)).sum(axis=(0, 1, 2))
        bj = bj + (jnp.repeat(jnp.asarray([z for _, z in cal], jnp.float32), co // nb) + 128.0 * xs) * wsum
    bj = np.asarray(bj)
    m = co // nb
    qt = [dataclasses.replace(
        pack_qargs(tq[..., i * m:(i + 1) * m], tsc[i * m:(i + 1) * m], *cal[i], b[i * m:(i + 1) * m]),
        bias=torch.from_numpy(bj[i * m:(i + 1) * m].copy())) for i in range(nb)]
    return qj, qt, b


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("case", list(DOWN2_CASES))
def test_down2_int8_s2d_matches_pallas(asym, case):
    """bf16, C = 256, s2d stride-2 weights: the port's wrapper with the
    programs' a_sub (3 for the three branches, 1 on the window) runs the
    plain int8 form on the CPU (``fused_down2_q_ref``, what the s8 tile is
    held to on the card, bit for bit where the codes agree) and equals the
    Pallas int8 body in interpret mode within one bf16 step on at most
    SHARE of the values; the call's shape is one the s8 tile takes."""
    from hdrtv_tpu.ops.megakernel import fused_down2 as jax_down2
    from hdrtv_tpu_torch.ops.conv_kernels import s8_sm90_table
    from hdrtv_tpu_torch.ops.megakernel import fused_down2, fused_down2_q_ref

    hb, wb, cf, cin, ch0, nb = DOWN2_CASES[case]
    rng = np.random.RandomState(150 + 2 * list(DOWN2_CASES).index(case) + asym)
    xj, xt = _both(rng.rand(hb, wb, cf) * 1.4 - 0.3, "bf16")
    qj, qt, b = _down2_layer(rng, nb, xt, ch0, asym)
    assert all((qa.pad != 0) == asym for qa in qt)
    co = nb * 4 * CO_NAT
    a_sub = 3 if nb > 1 else 1
    assert s8_sm90_table("down2", a_sub, C, co, stride=2)[1] == 18
    with pltpu.force_tpu_interpret_mode():
        want = jax_down2(xj, jnp.zeros((3, 3, C, co), xj.dtype), jnp.asarray(b), act="lrelu", qargs=qj,
                         a_sub=a_sub, cin=cin, ch0=ch0)
    qargs = qt if nb > 1 else qt[0]
    got = fused_down2(xt, torch.zeros((3, 3, C, co), dtype=xt.dtype), torch.from_numpy(b), act="lrelu",
                      cin=cin, ch0=ch0, qargs=qargs, a_sub=a_sub)
    assert got.shape == (hb // 2, wb // 2, co) and got.dtype == torch.bfloat16
    assert torch.equal(got, fused_down2_q_ref(xt[..., ch0 : ch0 + C], qargs, act="lrelu"))
    _close(got, want, "bf16")


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
def test_stride2_slot_walk_int32_sum_equals_dense(asym):
    """The s8 tile's K walk at stride 2 for the consolidated conv (three
    branches, a_sub = 3, Co = 768): N tile n reads branch n // 256's codes,
    its output sub-position (n % 256) // 64 walks that list of
    conv_chunks(2, 3, 256), 18 chunks (tap, c0) of 32 channels, out-of-image
    taps (global row −1 and column −1 only, the (1,0) pad; 14 × 22 s2d
    pixels in, 7 × 11 out) carrying the branch's pad code. The
    int32 sums equal the dense 3×3 stride-2 sums exactly; with a zero fill
    (TMA's) only where every pad code is 0."""
    from hdrtv_tpu_torch.ops.conv_kernels import conv_chunks
    from hdrtv_tpu_torch.ops.w8a8 import _quantize_act, _tap_views_q, pack_qargs_branches
    from hdrtv_tpu_torch.quant.int8 import quantize_weight

    rng = np.random.RandomState(160 + asym)
    hb, wb, nb = 14, 22, 3
    nat = [quantize_weight(rng.randn(3, 3, C // 4, CO_NAT).astype(f32) * 0.05) for _ in range(nb)]
    tq = np.concatenate([w_s2d_s2(q) for q, _ in nat], axis=-1)
    tsc = np.concatenate([b_s2d(s) for _, s in nat])
    co = tq.shape[-1]
    qas = pack_qargs_branches(tq, tsc, [0.01, 0.012, 0.014], [-0.25, -0.2, -0.15] if asym else None,
                              np.zeros(co, f32))
    assert all((qa.pad != 0) == asym for qa in qas)
    x = torch.from_numpy((rng.rand(hb, wb, C) * 1.6 - 0.3).astype(f32))
    codes = [_quantize_act(x, qa) for qa in qas]
    lists = conv_chunks(2, 3, C)
    assert [len(chunks) for chunks in lists] == [18] * 4  # K = 576 of the dense 2304
    ho, wo, m = hb // 2, wb // 2, co // nb

    def walk(pads):
        acc = torch.zeros(ho * wo, co, dtype=torch.long)
        for n0 in range(0, co, 64):
            bi, so = n0 // m, (n0 % m) // 64
            views = _tap_views_q(codes[bi], pads[bi], 2)
            w9 = qas[bi].w.reshape(m, 9, C).long()
            cols = slice(n0 - bi * m, n0 - bi * m + 64)
            for tap, c0 in lists[so]:
                acc[:, n0:n0 + 64] += (views[tap].reshape(-1, C)[:, c0:c0 + 32].long()
                                       @ w9[cols, tap, c0:c0 + 32].T)
        return acc

    dense = torch.cat([sum(v.reshape(-1, C).long() @ qa.w.reshape(m, 9, C).long()[:, i].T
                           for i, v in enumerate(_tap_views_q(q, qa.pad, 2)))
                       for q, qa in zip(codes, qas)], dim=1)
    assert torch.equal(walk([qa.pad for qa in qas]), dense)
    assert torch.equal(walk([0] * nb), dense) != asym


def _slots2_mask(co_blk):
    """(3, 3, 256, co_blk) True on the (tap, input sub-position) slots
    s2d_slots(2) gives each output sub-position of one w_s2d_s2 block."""
    from hdrtv_tpu_torch.models.s2d import s2d_slots

    ci, cn = C // 4, co_blk // 4
    mask = torch.zeros(9, 4, 4, dtype=torch.bool)
    for so, slots in enumerate(s2d_slots(2)):
        for tap, si in slots:
            mask[tap, si, so] = True
    return mask.repeat_interleave(ci, dim=1).repeat_interleave(cn, dim=2).reshape(3, 3, C, co_blk)


def test_fixture_int8_down_weights_have_the_s2d_structure():
    """LE.__cond_down's three branches and LE.CondNet3.2/4.2's int8 weights
    as prepared at load (QArgs.w, (Co, 9·C), C = 256 → 256 a branch) are
    zero outside the stride-2 slots of their output sub-positions, branch by
    branch: the s8 tile's slot walk skips nothing but zeros."""
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    p = HDRTVNetTorch(FIXTURE, device="cpu").params
    mask = _slots2_mask(4 * CO_NAT)
    for layer, nb in (("LE.__cond_down", 3), ("LE.CondNet3.2", 1), ("LE.CondNet4.2", 1)):
        qas = p[layer + ".__qargs"]
        qas = qas if isinstance(qas, tuple) else (qas,)
        assert len(qas) == nb, layer
        for bi, qa in enumerate(qas):
            w = qa.w.reshape(qa.co, 3, 3, qa.c).permute(1, 2, 3, 0)  # HWIO codes
            assert (qa.c, qa.co) == (C, 4 * CO_NAT) and int((w != 0).sum()) > 0, (layer, bi)
            assert not bool(w[~mask].any()), (layer, bi)


def test_s8_sm90_table_takes_the_down_convs_and_refuses_other_widths():
    """Stride 2: C = 256 with a_sub 1 (Co = 256) or 3 (Co = 768), the lists
    of conv_chunks(2, a_sub, 256), 18 chunks each; other widths, a_sub
    values and strides raise, naming what the tile takes."""
    from hdrtv_tpu_torch.ops.conv_kernels import conv_chunks, s8_sm90_table

    for a_sub, co in ((1, 256), (3, 768), (1, 512)):
        table, per_list = s8_sm90_table("down2", a_sub, C, co, stride=2)
        want = [tap | c0 << 4 for chunks in conv_chunks(2, a_sub, C) for tap, c0 in chunks]
        assert per_list == 18 and list(table) == want
    for a_sub, c, co in ((1, 128, 256), (1, 512, 256), (2, 256, 512), (0, 256, 256), (3, 256, 384), (1, 256, 128)):
        with pytest.raises(ValueError, match="wgmma s8 tile takes a_sub=1 or 3 with C = 256"):
            s8_sm90_table("down2", a_sub, c, co, stride=2)
    with pytest.raises(ValueError, match="stride 1 or 2"):
        s8_sm90_table("down2", 1, C, 256, stride=3)


@pytest.mark.parametrize("mega", [True, False], ids=["mega", "nomega"])
def test_int8_down2_program_calls_fit_the_s8_tile(monkeypatch, mega):
    """One 64 × 128 frame of each bf16 int8 program with HDRTV_INT8_DOWN2=1
    on the CPU: the three down2 calls with qargs (the consolidated conv,
    CondNet3.2 and CondNet4.2) declare an a_sub with a width the stride-2 s8
    tile takes, so none of them raises on the card; down_conv1/2 stay float."""
    from hdrtv_tpu_torch.models import s2d as port_s2d
    from hdrtv_tpu_torch.ops.conv_kernels import s8_sm90_table
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    calls = []

    def spy(x, w, b, *, _fn=port_s2d.fused_down2, **k):
        qa = k.get("qargs")
        c = k.get("cin") or x.shape[-1]
        calls.append(None if qa is None else (k.get("a_sub", 1), c, w.shape[-1], x.dtype,
                                              len(qa) if isinstance(qa, tuple) else 1))
        return _fn(x, w, b, **k)

    monkeypatch.setattr(port_s2d, "fused_down2", spy)
    monkeypatch.setenv("HDRTV_INT8_DOWN2", "1")
    monkeypatch.setenv("HDRTV_MEGAKERNEL", "1" if mega else "0")
    proc = HDRTVNetTorch(FIXTURE, device="cpu")
    proc.process_rgb48((np.random.RandomState(117).rand(64, 128, 3) * 255).astype(np.uint8))
    assert calls[3:] == [None, None] and None not in calls[:3], calls
    assert [call[:5] for call in calls[:3]] == [(3, C, 768, torch.bfloat16, 3), (1, C, 256, torch.bfloat16, 1),
                                                (1, C, 256, torch.bfloat16, 1)]
    for a_sub, c, co, _, _ in calls[:3]:
        assert s8_sm90_table("down2", a_sub, c, co, stride=2)[1] == 18


def _intercept(monkeypatch):
    """The card branch of the wrappers with the launch intercepted (device
    checks and the stream stubbed, CPU tensors standing in): the launches'
    (kernel, counter, arguments)."""
    from hdrtv_tpu_torch.ops import native

    launched = []
    monkeypatch.setattr(native, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(native, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(native, "stream_of", lambda t: 0)
    monkeypatch.setattr(native, "launch", lambda kernel, dt, *args, counter=None: launched.append(
        (kernel, counter, args)))
    return launched


@pytest.mark.parametrize("call", ["bf16_branches3", "bf16_window", "fp32", "bf16_a_sub0", "bf16_c128"])
def test_down2_int8_wrapper_hands_the_kernel_the_route(monkeypatch, call):
    """bf16 with a_sub ≥ 1 hands the kernel the stride-2 slot table (18 a
    list) and counts as down2_w8a8; fp32 and a_sub = 0 the dense route (no
    table); a bf16 a_sub = 1 call with C = 128 raises instead of falling back."""
    from hdrtv_tpu_torch.ops.megakernel import fused_down2
    from hdrtv_tpu_torch.ops.w8a8 import pack_qargs

    launched = _intercept(monkeypatch)
    rng = np.random.RandomState(170)
    dt = torch.float32 if call == "fp32" else torch.bfloat16
    c = 128 if call == "bf16_c128" else C
    nb = 3 if call == "bf16_branches3" else 1
    cf, cin, ch0 = (3 * c, c, c) if call == "bf16_window" else (c, None, 0)
    x = torch.from_numpy(rng.rand(8, 16, cf).astype(f32)).to(dt)
    wq = np.concatenate([w_s2d_s2(_qnat(rng, c // 4, CO_NAT)[0]) for _ in range(nb)], axis=-1)
    co = wq.shape[-1]
    qas = tuple(pack_qargs(wq[..., i * 256:(i + 1) * 256], np.full(256, 0.01, f32), f32(0.01), None,
                           np.zeros(256, f32)) for i in range(nb))
    w, b = torch.zeros((3, 3, c, co), dtype=dt), torch.zeros(co)
    a_sub = 0 if call == "bf16_a_sub0" else nb
    kw = {"act": "lrelu", "cin": cin, "ch0": ch0, "qargs": qas if nb > 1 else qas[0], "a_sub": a_sub}
    if call == "bf16_c128":
        with pytest.raises(ValueError, match="wgmma s8 tile takes a_sub=1 or 3 with C = 256"):
            fused_down2(x, w, b, **kw)
        assert launched == []
        return
    fused_down2(x, w, b, **kw)
    (kernel, counter, args), = launched
    assert (kernel, counter) == ("down2", "down2_w8a8")
    got_a_sub, table, per_list = args[-4:-1]
    assert got_a_sub == a_sub and args[4] == nb
    if call.startswith("bf16_") and a_sub:
        assert per_list == 18 and table is not None
    else:
        assert (table, per_list) == (None, 0)


# ---------------------------------------------------------------------------
# mix_chain, s2d=True
# ---------------------------------------------------------------------------


def _mix_steps(rng, dtype):
    """The CondNet2 tail as the program has it, for both sides: natural 64 →
    64 (lrelu) → 16, weights w_s2d_1x1, biases b_s2d."""
    steps = []
    for ci, co, act in ((64, 64, "lrelu"), (64, 16, None)):
        wj, wt = _both(w_s2d_1x1(rng.randn(1, 1, ci, co).astype(f32) * 0.1)[0, 0], dtype)
        bj, bt = _both(b_s2d(rng.randn(co).astype(f32) * 0.1))
        steps.append(((wj, bj, act), (wt, bt, act)))
    return [s[0] for s in steps], [s[1] for s in steps]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mix_chain_s2d_matches_pallas(dtype):
    """The window [0, 256) of a (10, 16, 768) tensor, as the program reads
    __cond_down's output: the port's s2d form (each step over the diagonal
    block only) against the JAX kernel on the dense block-diagonal weights."""
    from hdrtv_tpu.ops.megakernel import fused_mix_chain as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_mix_chain, fused_mix_chain_ref

    rng = np.random.RandomState(180 + (dtype == "bf16"))
    xj, xt = _both(rng.rand(10, 16, 3 * C) - 0.3, dtype)
    sj, st = _mix_steps(rng, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(xj, sj, cin=C, ch0=0)
    got = fused_mix_chain(xt, st, cin=C, ch0=0, s2d=True)
    assert got.shape == (10, 16, 64)
    assert torch.equal(got, fused_mix_chain_ref(xt[..., :C], st, s2d=True))
    _check(got, want, dtype, 2e-5)


def test_mix_chain_s2d_skips_an_off_structure_block():
    """A second-step weight with one non-zero block off the diagonal: the
    dense form still equals the JAX kernel, the s2d form (which multiplies
    the first diagonal block only) is visibly apart from it."""
    from hdrtv_tpu.ops.megakernel import fused_mix_chain as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_mix_chain

    rng = np.random.RandomState(183)
    xj, xt = _both(rng.rand(6, 8, C) - 0.3)
    sj, st = _mix_steps(rng, "f32")
    bad = st[1][0].numpy().copy()
    bad[:64, 16:32] = rng.randn(64, 16) * 0.1  # input sub-position 0 → output 1: off the diagonal
    sj[1] = (jnp.asarray(bad), sj[1][1], sj[1][2])
    st[1] = (torch.from_numpy(bad), st[1][1], st[1][2])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fn(xj, sj))
    skip, dense = (fused_mix_chain(xt, st, s2d=s2d).numpy() for s2d in (True, False))
    np.testing.assert_allclose(dense, want, atol=2e-5)
    assert float(np.abs(skip - want).max()) > 1e-2


def test_mix_chain_s2d_needs_four_blocks():
    """s2d=True with a width that is not four sub-position blocks raises,
    on the CPU as on the card; the dense form takes any width."""
    from hdrtv_tpu_torch.ops.megakernel import fused_mix_chain

    rng = np.random.RandomState(184)
    x = torch.from_numpy(rng.rand(4, 4, 8).astype(f32))
    steps = [(torch.from_numpy(rng.randn(8, 6).astype(f32)), torch.zeros(6), "lrelu")]
    fused_mix_chain(x, steps)
    with pytest.raises(ValueError, match="divisible by 4"):
        fused_mix_chain(x, steps, s2d=True)


@pytest.mark.parametrize("call", ["bf16_s2d", "fp32_s2d", "bf16_dense", "bf16_other_chain"])
def test_mix_chain_wrapper_hands_the_kernel_the_route(monkeypatch, call):
    """bf16 with s2d=True hands the kernel s2d = 1 (the row tile); fp32 with
    s2d=True and s2d=False hand it 0 (the dense chain, the same function on
    such weights); a bf16 s2d chain other than the program's raises."""
    from hdrtv_tpu_torch.ops import native
    from hdrtv_tpu_torch.ops.megakernel import fused_mix_chain

    launched = _intercept(monkeypatch)
    monkeypatch.setattr(native, "lib", lambda: types.SimpleNamespace(hdrtv_mix_chain_max_steps=lambda: 5))
    rng = np.random.RandomState(185)
    dt = torch.float32 if call.startswith("fp32") else torch.bfloat16
    x = torch.from_numpy(rng.rand(4, 6, 3 * C).astype(f32)).to(dt)
    _, steps = _mix_steps(rng, "f32")
    steps = [(w.to(dt), b, act) for w, b, act in steps]
    if call == "bf16_other_chain":
        steps = steps[:1]
        with pytest.raises(ValueError, match="row tile takes natural widths"):
            fused_mix_chain(x, steps, cin=C, ch0=C, s2d=True)
        assert launched == []
        return
    fused_mix_chain(x, steps, cin=C, ch0=C, s2d=call != "bf16_dense")
    (kernel, counter, args), = launched
    assert (kernel, counter) == ("mix_chain", None)
    assert args[-5:-1] == (4 * 6, 3 * C, C, int(call == "bf16_s2d"))
