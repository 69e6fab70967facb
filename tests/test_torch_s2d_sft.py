"""The ``s2d=True`` declaration of the port's ``fused_sft_conv3_v2`` and
``fused_resblock`` (hdrtv_tpu_torch/ops/megakernel.py), on the CPU.

With it every SFT 1×1 weight is ``w_s2d_1x1(w)``, its bias ``b_s2d(b)`` and
every 3×3 weight ``w_s2d_s1(w)``, and the kernels' s2d forms (the SFT passes
on csrc/chain_sm90.cuh's row tile, the convs on csrc/conv3x3_sm90.cuh's tile
over the slot table) multiply only the diagonal blocks and populated slots;
the plain versions here do the same.

- On such weights the port equals the JAX kernels in interpret mode, with
  the tolerances of tests/test_torch_kernels.py: sft_conv3 fp32 3e-5, bf16
  one step; resblock fp32 5e-5 (3e-5 with a second input), bf16 two steps
  on at most 5% of the values (a flipped t2 moves the rounded output).
- A weight with one non-zero block off the declared structure gives another
  result than the JAX kernel's: the skip is visible, not assumed.
- Both frame programs (the megakernel one and ``HDRTV_MEGAKERNEL=0``) pass
  ``s2d=True`` to both kernels, on the float and the int8 checkpoints.
- Widths that are not four sub-position blocks raise.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_s2d_sft.py -q
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
CC, C = 16, 32  # natural widths of every SFT and trunk conv of the frame programs


def _both(a, dtype="f32"):
    """One numpy array as a JAX and a torch array, rounded once to bf16 for ``bf16``."""
    a = np.ascontiguousarray(a, f32)
    j, t = jnp.asarray(a), torch.from_numpy(a.copy())
    if dtype == "bf16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _check(got: torch.Tensor, want, dtype: str, atol: float, *, steps: int = 1, flips: float = 0.005):
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


def _sft4(rng, dtype, scale=0.05):
    """Four SFT (w, b) pairs as the s2d program has them (w_s2d_1x1 weights,
    b_s2d biases), for both sides."""
    pairs = []
    for ci, co in ((CC, CC), (CC, C), (CC, CC), (CC, C)):
        wj, wt = _both(w_s2d_1x1(rng.randn(1, 1, ci, co).astype(f32) * scale)[0, 0], dtype)
        bj, bt = _both(b_s2d(rng.randn(co).astype(f32) * 0.1))
        pairs.append(((wj, bj), (wt, bt)))
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _conv(rng, dtype, scale=0.05):
    """A 3×3 trunk conv as the s2d program has it (w_s2d_s1 weight, b_s2d bias)."""
    wj, wt = _both(w_s2d_s1(rng.randn(3, 3, C, C).astype(f32) * scale), dtype)
    bj, bt = _both(b_s2d(rng.randn(C).astype(f32) * 0.1))
    return (wj, bj), (wt, bt)


def _sft_conv_args(rng, hb, wb, dtype, skip):
    xj, xt = _both(rng.rand(hb, wb, 4 * C), dtype)
    cj, ct = _both(rng.rand(hb, wb, 4 * CC), dtype)
    sj, st = _both(rng.rand(hb, wb, 4 * C), dtype) if skip else (None, None)
    sftj, sftt = _sft4(rng, dtype)
    (wj, bj), (wt, bt) = _conv(rng, dtype)
    return [xj, cj, sftj, wj, bj], [xt, ct, sftt, wt, bt], sj, st


def _resblock_args(rng, hb, wb, dtype, second):
    xj, xt = _both(rng.rand(hb, wb, 4 * C), dtype)
    cj, ct = _both(rng.rand(hb, wb, 4 * CC), dtype)
    kj, kt = {}, {}
    if second == "up_coarse":
        kj[second], kt[second] = _both(rng.rand(hb // 2, wb // 2, 16 * C), dtype)
    elif second == "x_add":
        kj[second], kt[second] = _both(rng.rand(hb, wb, 4 * C), dtype)
    s1j, s1t = _sft4(rng, dtype)
    (w1j, b1j), (w1t, b1t) = _conv(rng, dtype)
    s2j, s2t = _sft4(rng, dtype)
    (w2j, b2j), (w2t, b2t) = _conv(rng, dtype)
    return [xj, cj, s1j, w1j, b1j, s2j, w2j, b2j], [xt, ct, s1t, w1t, b1t, s2t, w2t, b2t], kj, kt


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("relu,skip", [(True, False), (False, True)], ids=["relu", "skip"])
def test_sft_conv3_s2d_matches_pallas(dtype, relu, skip):
    """16 × 16 blocks: Pallas row tiles with their halos, against the port's
    SFT over the diagonal blocks and conv over the populated slots."""
    from hdrtv_tpu.ops.megakernel import fused_sft_conv3_v2 as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_sft_conv3_v2

    rng = np.random.RandomState(81 + relu)
    ja, ta, sj, st = _sft_conv_args(rng, 16, 16, dtype, skip)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(*ja, relu=relu, skip=sj)
    got = fused_sft_conv3_v2(*ta, relu=relu, skip=st, s2d=True)
    assert got.shape == (16, 16, 4 * C)
    _check(got, want, dtype, 3e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("second", [None, "up_coarse", "x_add"])
def test_resblock_s2d_matches_pallas(dtype, second):
    """16 × 16 blocks, each second input; h1 stays fp32 into SFT2 on both
    sides, and the residual is the rounded sum."""
    from hdrtv_tpu.ops.megakernel import fused_resblock as jax_fn
    from hdrtv_tpu_torch.ops.megakernel import fused_resblock

    rng = np.random.RandomState(91 + (second is not None) + (second == "x_add"))
    ja, ta, kj, kt = _resblock_args(rng, 16, 16, dtype, second)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(*ja, **kj)
    got = fused_resblock(*ta, **kt, s2d=True)
    assert got.shape == (16, 16, 4 * C)
    _check(got, want, dtype, 5e-5 if second is None else 3e-5, steps=2, flips=0.05)


def _off_block(w: np.ndarray, rng) -> np.ndarray:
    """``w`` (4K, 4N) plus one non-zero block off the diagonal (sub-positions 0 → 1)."""
    k, n = w.shape[0] // 4, w.shape[1] // 4
    w = w.copy()
    w[:k, n: 2 * n] = rng.randn(k, n)
    return w


def _off_slot(w: np.ndarray, rng) -> np.ndarray:
    """``w`` (3, 3, 4C, 4Co) plus a non-zero (tap, input sub-position) slot
    that no output sub-position reads: tap (-1, -1), input sub-position 0 →
    output 0, outside the 3 × 3 window of natural pixels."""
    w = w.copy()
    w[0, 0, :C, :C] = rng.randn(C, C)
    return w


@pytest.mark.parametrize("what", ["sft_conv3_sft", "sft_conv3_conv", "resblock_sft2", "resblock_conv1"])
def test_s2d_skip_is_visible(what):
    """One weight with a block or slot the declaration says is zero: with
    s2d=True the port ignores it and differs from the JAX kernel (which
    multiplies it); with s2d=False the port takes it and agrees. fp32, 8 × 8
    blocks; resblock's SFT2 is the one that reads the fp32 h1."""
    from hdrtv_tpu.ops.megakernel import fused_resblock as jax_res, fused_sft_conv3_v2 as jax_sft
    from hdrtv_tpu_torch.ops.megakernel import fused_resblock, fused_sft_conv3_v2

    rng = np.random.RandomState(101)
    if what.startswith("sft_conv3"):
        ja, ta, _, _ = _sft_conv_args(rng, 8, 8, "f32", False)
        if what == "sft_conv3_sft":
            bad = _off_block(np.asarray(ja[2][1][0]), rng)
            ja[2][1], ta[2][1] = (jnp.asarray(bad), ja[2][1][1]), (torch.from_numpy(bad), ta[2][1][1])
        else:
            bad = _off_slot(np.asarray(ja[3]), rng)
            ja[3], ta[3] = jnp.asarray(bad), torch.from_numpy(bad)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax_sft(*ja, relu=True))
        skip, dense = (fused_sft_conv3_v2(*ta, relu=True, s2d=s2d).numpy() for s2d in (True, False))
        atol = 3e-5
    else:
        ja, ta, _, _ = _resblock_args(rng, 8, 8, "f32", None)
        if what == "resblock_sft2":
            bad = _off_block(np.asarray(ja[5][3][0]), rng)
            ja[5][3], ta[5][3] = (jnp.asarray(bad), ja[5][3][1]), (torch.from_numpy(bad), ta[5][3][1])
        else:
            bad = _off_slot(np.asarray(ja[3]), rng)
            ja[3], ta[3] = jnp.asarray(bad), torch.from_numpy(bad)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax_res(*ja))
        skip, dense = (fused_resblock(*ta, s2d=s2d).numpy() for s2d in (True, False))
        atol = 5e-5
    np.testing.assert_allclose(dense, want, atol=atol)
    assert float(np.abs(skip - want).max()) > 1e-2


@pytest.mark.parametrize("mega", [True, False], ids=["mega", "nomega"])
@pytest.mark.parametrize("weights", [WEIGHTS, INT8_WEIGHTS], ids=["float", "int8"])
def test_programs_declare_s2d(weights, mega, monkeypatch):
    """One 64 × 96 frame of each bf16 s2d program (the megakernel one and
    ``HDRTV_MEGAKERNEL=0``) on the float and the pre-dequantized W8A8
    checkpoint: both kernels are called, every call with s2d=True; the int8
    checkpoint's calls keep their int8 bodies (qargs)."""
    from hdrtv_tpu_torch.models import s2d as port_s2d
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    calls = {}
    for name in ("fused_sft_conv3_v2", "fused_resblock"):
        def spy(*a, _fn=getattr(port_s2d, name), _name=name, **k):
            calls.setdefault(_name, []).append(k)
            return _fn(*a, **k)
        monkeypatch.setattr(port_s2d, name, spy)
    if mega:
        monkeypatch.delenv("HDRTV_MEGAKERNEL", raising=False)
    else:
        monkeypatch.setenv("HDRTV_MEGAKERNEL", "0")
    proc = HDRTVNetTorch(weights, device="cpu")
    frame = (np.random.RandomState(111).rand(64, 96, 3) * 255).astype(np.uint8)
    out = proc.process_rgb48(frame)
    assert out.shape == (64, 96, 3) and out.dtype == np.uint16
    int8 = weights == INT8_WEIGHTS
    for name, qkey in (("fused_sft_conv3_v2", "qargs"), ("fused_resblock", "qargs1")):
        assert calls.get(name), name
        assert all(k.get("s2d") is True for k in calls[name]), name
        assert any(k.get(qkey) is not None for k in calls[name]) == int8, name


def test_checkpoints_have_the_declared_structure():
    """The SFT and trunk weights both programs hand the two kernels with
    s2d=True, in the float checkpoint: each SFT 1×1 four equal diagonal
    blocks and zeros elsewhere, each bias four equal quarters, each 3×3 conv
    zero outside the populated slots."""
    from hdrtv_tpu_torch.ops.megakernel import _s2d_slots_only
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    p = HDRTVNetTorch(WEIGHTS, device="cpu").params
    blocks = ["LE.SFT_layer1"] + [f"LE.recon_trunk{i}.0.sft{j}" for i in (1, 2, 4, 5) for j in (1, 2)]
    convs = ["LE.HR_conv1"] + [f"LE.recon_trunk{i}.0.conv{j}" for i in (1, 2, 4, 5) for j in (1, 2)]
    for block in blocks:
        for kind in ("scale", "shift"):
            for i in (0, 1):
                name = f"{block}.SFT_{kind}_conv{i}"
                w, b = p[f"{name}.weight"][0, 0], p[f"{name}.bias"]
                k, n = w.shape[0] // 4, w.shape[1] // 4
                assert torch.equal(torch.block_diag(*[w[:k, :n]] * 4), w), name
                assert torch.equal(b[:n].repeat(4), b), name
    for name in convs:
        w = p[f"{name}.weight"]
        assert torch.equal(_s2d_slots_only(w), w), name
        assert bool((w != 0).any()), name


@pytest.mark.parametrize("what", ["sft_conv3", "resblock"])
def test_s2d_needs_four_blocks(what):
    """s2d=True with a width that is not four sub-position blocks raises,
    on the CPU as on the card."""
    from hdrtv_tpu_torch.ops.megakernel import fused_resblock, fused_sft_conv3_v2

    rng = np.random.RandomState(121)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(f32) * 0.1)

    c, cc = 6, 8
    def sft():
        return [(t(ci, co), t(co)) for ci, co in ((cc, cc), (cc, c), (cc, cc), (cc, c))]

    if what == "sft_conv3":
        args = (t(4, 4, c), t(4, 4, cc), sft(), t(3, 3, c, c), t(c))
        call = fused_sft_conv3_v2
    else:
        args = (t(4, 4, c), t(4, 4, cc), sft(), t(3, 3, c, c), t(c), sft(), t(3, 3, c, c), t(c))
        call = fused_resblock
    call(*args)  # dense: any width
    with pytest.raises(ValueError, match="divisible by 4"):
        call(*args, s2d=True)
