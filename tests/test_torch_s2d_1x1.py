"""The ``s2d=True`` declaration of the port's ``fused_cond_chain`` and
``fused_tail`` (hdrtv_tpu_torch/ops/megakernel.py), on the CPU.

With it every 1×1 weight is ``w_s2d_1x1(w)``, every bias ``b_s2d(b)`` and
the tail's ``w_hr`` ``w_s2d_s1(w)``, and the kernels (csrc/chain_sm90.cuh,
csrc/conv3x3_sm90.cuh) multiply only the weights' diagonal blocks and
populated slots; the plain versions here do the same.

- On such weights the port equals the JAX kernels in interpret mode, with
  the tolerances of tests/test_torch_kernels.py: fp32 2e-5 (3e-5 for the
  unpacked tail, 1 code packed), bf16 one step (two for the unpacked tail;
  4 codes packed): the same exact products summed in fp32 in another order.
- A weight with one non-zero block off the declared structure gives another
  result than the JAX kernel's: the skip is visible, not assumed.
- The megakernel frame program passes ``s2d=True`` to both, and the real
  checkpoints (``weights/hr_fp32.npz`` and the pre-dequantized
  ``tests/fixtures/hr_w8a8.npz``) have the declared structure.
- Widths that are not four sub-position blocks raise.
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
DTYPES = ["f32", "bf16"]
# natural widths of the frame programs: cond_chain 64 → 64 ×4 → 16; SFT cond 16, features 32
CHAIN = (64, 64, 64, 64, 64, 16)
CC, C = 16, 32


def _both(a, dtype="f32"):
    """One numpy array as a JAX and a torch array, rounded once to bf16 for ``bf16``."""
    a = np.ascontiguousarray(a, f32)
    j, t = jnp.asarray(a), torch.from_numpy(a.copy())
    if dtype == "bf16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _check(got: torch.Tensor, want, dtype: str, atol: float, *, steps: int = 1, flips: float = 0.02):
    """fp32: absolute; bf16: within ``steps`` bf16 steps (2^-7·max(1, |y|)
    each) and equal but for a share ``flips`` of the values."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape
    err = np.abs(g - w)
    if dtype == "f32":
        assert float(err.max()) <= atol, float(err.max())
        return
    assert got.dtype == torch.bfloat16
    assert (err <= steps * 2.0 ** -7 * np.maximum(1.0, np.abs(w))).all(), float(err.max())
    assert float((err > 0).mean()) <= flips, float((err > 0).mean())


def _p11(rng, ci, co, dtype, scale):
    """A 1×1 conv as the s2d program has it: (w_s2d_1x1 weight, b_s2d bias) for both sides."""
    wj, wt = _both(w_s2d_1x1(rng.randn(1, 1, ci, co).astype(f32) * scale)[0, 0], dtype)
    bj, bt = _both(b_s2d(rng.randn(co).astype(f32) * 0.1))
    return (wj, bj), (wt, bt)


def _chain_weights(rng, dtype):
    pairs = [_p11(rng, ci, co, dtype, 0.1) for ci, co in zip(CHAIN[:-1], CHAIN[1:])]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _tail_args(rng, hb, wb, dtype, coarse):
    """The tail's inputs for both sides, its weights in their s2d forms, at
    the scales of tests/test_torch_kernels.py's tail test (|w_last| ≲ 0.04),
    for which its packed bounds hold."""
    sj, st = _both(rng.rand(hb, wb, 4 * C), dtype)
    cj, ct = _both(rng.rand(hb, wb, 4 * CC), dtype)
    kj, kt = _both(rng.rand(hb, wb, 12), dtype)
    uj, ut = _both(rng.rand(hb // 2, wb // 2, 16 * C), dtype) if coarse else (None, None)
    sft = [_p11(rng, ci, co, dtype, 0.05) for ci, co in ((CC, CC), (CC, C), (CC, CC), (CC, C))]
    whj, wht = _both(w_s2d_s1(rng.randn(3, 3, C, C).astype(f32) * 0.02), dtype)
    bhj, bht = _both(b_s2d(rng.randn(C).astype(f32) * 0.1))
    wlj, wlt = _both(w_s2d_s1(rng.randn(3, 3, C, 3).astype(f32) * 0.01), dtype)
    blj, blt = _both(b_s2d(rng.randn(3).astype(f32) * 0.1))
    jax_args = [sj, cj, kj, [p[0] for p in sft], whj, bhj, wlj, blj]
    port_args = [st, ct, kt, [p[1] for p in sft], wht, bht, wlt, blt]
    return jax_args, port_args, uj, ut


@pytest.mark.parametrize("dtype", DTYPES)
def test_cond_chain_s2d_matches_pallas(dtype):
    """c0 (16, 16, 256) through the frame programs' widths; c and cond1 both
    compared. The JAX kernel multiplies the dense block-diagonal weights."""
    from hdrtv_tpu.ops.megakernel import fused_cond_chain as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_cond_chain

    rng = np.random.RandomState(31)
    hb, wb = 16, 16
    cj, ct = _both(rng.rand(hb, wb, 4 * CHAIN[0]) - 0.3, dtype)
    wj, wt = _chain_weights(rng, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(cj, wj)
    got = fused_cond_chain(ct, wt, s2d=True)
    assert got[0].shape == (hb, wb, 256) and got[1].shape == (hb, wb, 64)
    for g, w_ in zip(got, want, strict=True):
        _check(g, w_, dtype, 2e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("coarse,pack", [(True, True), (False, False), (True, False), (False, True)],
                         ids=["up_coarse-packed", "s-y", "up_coarse-y", "s-packed"])
def test_tail_s2d_matches_pallas(dtype, coarse, pack):
    """Hb = 16: two Pallas row tiles of 8 with their halos, against the
    port's SFT over diagonal blocks and HR_conv2 over the populated slots.
    Unpacked: 3e-5 in fp32, two bf16 steps (the rounded t and h feed further
    convs). Packed, in u16 codes: fp32 ≤ 1; bf16 ≤ 4 and mean ≤ 0.03 (a
    flipped bf16 step of h moves conv_last's unrounded sum by |w_last|·step·
    65535 codes, a few at these weights)."""
    from hdrtv_tpu.ops.megakernel import fused_tail as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_tail

    rng = np.random.RandomState(41 + 2 * coarse + pack)
    hb, wb = 16, 16
    ja, ta, uj, ut = _tail_args(rng, hb, wb, dtype, coarse)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(*ja, pack=pack, up_coarse=uj)
    got = fused_tail(*ta, pack=pack, up_coarse=ut, s2d=True)
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


def _off_block(w: np.ndarray, rng) -> np.ndarray:
    """``w`` (4K, 4N) plus one non-zero block off the diagonal (sub-positions 0 → 1)."""
    k, n = w.shape[0] // 4, w.shape[1] // 4
    w = w.copy()
    w[:k, n: 2 * n] = rng.randn(k, n)
    return w


@pytest.mark.parametrize("what", ["cond_chain", "tail_sft", "tail_hr_conv2"])
def test_s2d_skip_is_visible(what):
    """One weight with a block the declaration says is zero: with s2d=True
    the port ignores it and differs from the JAX kernel (which multiplies
    it); with s2d=False the port takes it and agrees. fp32, 8 × 8 blocks."""
    from hdrtv_tpu.ops.megakernel import fused_cond_chain as jax_chain, fused_tail as jax_tail
    from hdrtv_tpu_torch.ops.megakernel import fused_cond_chain, fused_tail

    rng = np.random.RandomState(51)
    hb, wb = 8, 8
    if what == "cond_chain":
        cj, ct = _both(rng.rand(hb, wb, 4 * CHAIN[0]) - 0.3)
        wj, wt = _chain_weights(rng, "f32")
        bad = _off_block(np.asarray(wj[2][0]), rng)
        wj[2], wt[2] = (jnp.asarray(bad), wj[2][1]), (torch.from_numpy(bad), wt[2][1])
        with pltpu.force_tpu_interpret_mode():
            want = np.concatenate([np.asarray(o).reshape(-1) for o in jax_chain(cj, wj)])
        skip, dense = (torch.cat([o.reshape(-1) for o in fused_cond_chain(ct, wt, s2d=s2d)]).numpy()
                       for s2d in (True, False))
    else:
        ja, ta, _, _ = _tail_args(rng, hb, wb, "f32", False)
        if what == "tail_sft":
            bad = _off_block(np.asarray(ja[3][1][0]), rng)
            ja[3][1], ta[3][1] = (jnp.asarray(bad), ja[3][1][1]), (torch.from_numpy(bad), ta[3][1][1])
        else:
            bad = np.asarray(ja[4]).copy()
            # tap (-1, -1), input sub-position 0 → output 0: outside the 3 × 3 window, not a slot
            bad[0, 0, :C, :C] = rng.randn(C, C)
            ja[4], ta[4] = jnp.asarray(bad), torch.from_numpy(bad)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax_tail(*ja, pack=False))
        skip, dense = (fused_tail(*ta, pack=False, s2d=s2d).numpy() for s2d in (True, False))
    np.testing.assert_allclose(dense, want, atol=3e-5)
    assert float(np.abs(skip - want).max()) > 1e-2


@pytest.mark.parametrize("weights", [WEIGHTS, INT8_WEIGHTS], ids=["float", "int8"])
def test_mega_program_declares_s2d(weights, monkeypatch):
    """One 64 × 96 frame of the bf16 megakernel program (the float and the
    pre-dequantized W8A8 checkpoint): cond_chain, the tail and the mix_chain
    CondNet2 tail are called once each, with s2d=True; the int8 tail keeps
    its int8 body (qargs_hr)."""
    from hdrtv_tpu_torch.models import s2d as port_s2d
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    calls = {}
    for name in ("fused_cond_chain", "fused_tail", "fused_mix_chain"):
        def spy(*a, _fn=getattr(port_s2d, name), _name=name, **k):
            calls.setdefault(_name, []).append(k)
            return _fn(*a, **k)
        monkeypatch.setattr(port_s2d, name, spy)
    monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    proc = HDRTVNetTorch(weights, device="cpu")
    frame = (np.random.RandomState(61).rand(64, 96, 3) * 255).astype(np.uint8)
    out = proc.process_rgb48(frame)
    assert out.shape == (64, 96, 3) and out.dtype == np.uint16
    assert [k.get("s2d") for k in calls["fused_cond_chain"]] == [True]
    assert [k.get("s2d") for k in calls["fused_tail"]] == [True]
    assert [k.get("s2d") for k in calls["fused_mix_chain"]] == [True]
    assert (calls["fused_tail"][0].get("qargs_hr") is not None) == (weights == INT8_WEIGHTS)


@pytest.mark.parametrize("weights", [WEIGHTS, INT8_WEIGHTS], ids=["float", "int8"])
def test_checkpoints_have_the_declared_structure(weights):
    """The weights the program hands cond_chain, the tail and mix_chain
    with s2d=True: each 1×1 four equal diagonal blocks and zeros elsewhere,
    each bias four equal quarters, HR_conv2 zero outside the populated
    slots."""
    from hdrtv_tpu_torch.ops.megakernel import _s2d_slots_only
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    p = HDRTVNetTorch(weights, device="cpu").params
    names = ["LE.cond_first.2", "LE.cond_first.4", "LE.CondNet1.0", "LE.CondNet1.2", "LE.CondNet1.4"]
    names += [f"LE.SFT_layer2.SFT_{kind}_conv{i}" for kind in ("scale", "shift") for i in (0, 1)]
    names += ["LE.CondNet2.2", "LE.CondNet2.4"]
    for name in names:
        w, b = p[f"{name}.weight"][0, 0], p[f"{name}.bias"]
        k, n = w.shape[0] // 4, w.shape[1] // 4
        assert torch.equal(torch.block_diag(*[w[:k, :n]] * 4), w), name
        assert torch.equal(b[:n].repeat(4), b), name
    w_hr = p["LE.HR_conv2.weight"]
    assert torch.equal(_s2d_slots_only(w_hr), w_hr)
    assert bool((w_hr != 0).any())


@pytest.mark.parametrize("what", ["cond_chain", "tail"])
def test_s2d_needs_four_blocks(what):
    """s2d=True with a width that is not four sub-position blocks raises,
    on the CPU as on the card."""
    from hdrtv_tpu_torch.ops.megakernel import fused_cond_chain, fused_tail

    rng = np.random.RandomState(71)
    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(f32) * 0.1)

    if what == "cond_chain":
        c0 = t(4, 4, 8)
        args = (c0, [(t(8, 8), t(8)) for _ in range(4)] + [(t(8, 6), t(6))])
        call = fused_cond_chain
    else:
        c, cc = 6, 8
        sft = [(t(ci, co), t(co)) for ci, co in ((cc, cc), (cc, c), (cc, cc), (cc, c))]
        args = (t(4, 4, c), t(4, 4, cc), t(4, 4, 12), sft, t(3, 3, c, c), t(c), t(3, 3, c, 12), t(12))
        call = fused_tail
    call(*args)  # dense: any width
    with pytest.raises(ValueError, match="divisible by 4"):
        call(*args, s2d=True)
