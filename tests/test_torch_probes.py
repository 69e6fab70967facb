"""The two layout probes of ``tools/`` against hdrtv_tpu_torch's plain
versions of their kernels, on the CPU.

The probes' own Pallas kernels (``tools/proto_d2s_kernel.py _kernel``,
``tools/proto_rowmajor_head.py _kernel_raw`` and ``_kernel_pre``) run in
interpret mode with the probes' BlockSpecs, on numpy-seeded bf16 / u8
inputs. ``d2s_add_ref`` has one rounding, as the kernel does: equal bit for
bit. The head's plain versions sum the same exact bf16 products in fp32 in
another order than the interpreted dot: within one bf16 step. The CUDA
kernels are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _tool(name: str):
    """A root ``tools/`` module, loaded by path (``tools/`` is no package)."""
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def d2s_tool():
    return _tool("proto_d2s_kernel")


@pytest.fixture(scope="module")
def head_tool():
    return _tool("proto_rowmajor_head")


def _bf16_pair(a: np.ndarray):
    """The same bf16 values as a jax and a torch array."""
    j = jnp.asarray(a.astype(np.float32)).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _d2s_pallas(tool, hbc, wbc, c, tc):
    """The probe's pallas_call (run()'s), over the probe's own kernel, interpreted."""
    return pl.pallas_call(
        functools.partial(tool._kernel, tc=tc, wbc=wbc, c=c),
        out_shape=jax.ShapeDtypeStruct((2 * hbc, 2 * wbc, c), jnp.bfloat16),
        grid=(hbc // tc,),
        in_specs=[
            pl.BlockSpec((tc, wbc, 4 * c), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((2 * tc, 2 * wbc, c), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((2 * tc, 2 * wbc, c), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        interpret=True,
    )


# (hbc, wbc, C, the Pallas row tile tc): the probe's C; a grid of 3 tiles, hbc = 6 not a
# multiple of the probe's tc = 8; a narrow C.
@pytest.mark.parametrize("hbc,wbc,c,tc", [(4, 8, 128, 4), (6, 5, 128, 2), (3, 4, 8, 3)])
def test_d2s_add_ref_equals_probe_kernel(d2s_tool, hbc, wbc, c, tc):
    from hdrtv_tpu_torch.ops.probe_kernels import d2s_add, d2s_add_ref

    rng = np.random.RandomState(hbc * 100 + wbc)
    cj, ct = _bf16_pair(rng.randn(hbc, wbc, 4 * c) * 3)
    fj, ft = _bf16_pair(rng.randn(2 * hbc, 2 * wbc, c))
    want = _d2s_pallas(d2s_tool, hbc, wbc, c, tc)(cj, fj)
    got = d2s_add_ref(ct, ft)
    assert got.dtype == torch.bfloat16 and got.shape == (2 * hbc, 2 * wbc, c)
    assert np.array_equal(_np(got), _np(want))
    assert torch.equal(d2s_add(ct, ft), got)  # the CPU wrapper takes the plain version
    # the probe's own parity form: XLA's reshape/transpose d2s + add
    c4 = np.asarray(cj.astype(jnp.float32))
    x = c4.reshape(hbc, wbc, 2, 2, c).transpose(0, 2, 1, 3, 4).reshape(2 * hbc, 2 * wbc, c)
    assert np.array_equal(_np(got), np.asarray(jnp.asarray(x + _np(fj)).astype(jnp.bfloat16).astype(jnp.float32)))


def _head_pallas(tool, h, w, co, t):
    hb, wb, w3 = h // 2, w // 2, 3 * w
    raw = pl.pallas_call(
        functools.partial(tool._kernel_raw, t=t, wb=wb),
        out_shape=jax.ShapeDtypeStruct((hb, wb, co), jnp.bfloat16),
        grid=(hb // t,),
        in_specs=[
            pl.BlockSpec((2 * t, w3), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((t, wb, co), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        interpret=True,
    )
    pre = pl.pallas_call(
        functools.partial(tool._kernel_pre, t=t, wb=wb),
        out_shape=jax.ShapeDtypeStruct((hb, wb, co), jnp.bfloat16),
        grid=(hb // t,),
        in_specs=[
            pl.BlockSpec((t, 2, wb, 6), lambda i: (i, 0, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((t, wb, co), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        interpret=True,
    )
    return raw, pre


def _within_one_step(got: np.ndarray, want: np.ndarray) -> None:
    step = 2.0 ** -7 * np.maximum(1.0, np.abs(want))
    assert (np.abs(got - want) <= step).all(), float((np.abs(got - want) / step).max())


# (H, W, Co, t): a 16×32 frame at the probe's Co = 256 and t = 8; 12×20 with three row tiles;
# a narrow Co.
@pytest.mark.parametrize("h,w,co,t", [(16, 32, 256, 8), (12, 20, 256, 2), (8, 6, 16, 4)])
def test_rowmajor_head_refs_match_probe_kernels(head_tool, h, w, co, t):
    from hdrtv_tpu_torch.ops.probe_kernels import (
        rowmajor_head_pre, rowmajor_head_pre_ref, rowmajor_head_raw, rowmajor_head_raw_ref,
    )

    rng = np.random.RandomState(h * w)
    frame = rng.randint(0, 256, (h, 3 * w), dtype=np.uint8)
    wj, wt = _bf16_pair(rng.randn(12, co) * 0.1)
    raw_k, pre_k = _head_pallas(head_tool, h, w, co, t)
    want_raw = _np(raw_k(jnp.asarray(frame), wj))
    want_pre = _np(pre_k(jnp.asarray(frame.reshape(h // 2, 2, w // 2, 6)), wj))
    assert np.array_equal(want_raw, want_pre)  # the probe's own parity
    x = torch.from_numpy(frame)
    got_raw = rowmajor_head_raw_ref(x, wt)
    got_pre = rowmajor_head_pre_ref(x.reshape(h // 2, 2, w // 2, 6), wt)
    assert got_raw.dtype == torch.bfloat16 and got_raw.shape == (h // 2, w // 2, co)
    assert torch.equal(got_raw, got_pre)
    _within_one_step(_np(got_raw), want_raw)
    assert torch.equal(rowmajor_head_raw(x, wt), got_raw)
    assert torch.equal(rowmajor_head_pre(x.reshape(h // 2, 2, w // 2, 6), wt), got_pre)


def test_head_scale_is_a_multiply():
    """·f32(1/255), then bf16, as the probe: the code k's value is
    bf16(k · f32(1/255)), which differs from bf16(k / 255) for some k (the
    multiply and the division differ in the last fp32 bit)."""
    from hdrtv_tpu_torch.ops.probe_kernels import rowmajor_head_pre_ref

    codes = np.arange(256, dtype=np.uint8)
    xr = np.zeros((256, 2, 1, 6), np.uint8)
    xr[:, 0, 0, 0] = codes
    w = torch.zeros((12, 8), dtype=torch.bfloat16)
    w[0, 0] = 1.0
    got = rowmajor_head_pre_ref(torch.from_numpy(xr), w)[:, 0, 0].float().numpy()
    want = (codes.astype(np.float32) * np.float32(1.0 / 255.0))
    want = np.asarray(jnp.asarray(want).astype(jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", ["d2s_fine_shape", "d2s_dtype", "d2s_c", "head_w", "head_odd", "head_planes"])
def test_probe_wrappers_reject_bad_inputs(case):
    from hdrtv_tpu_torch.ops import probe_kernels as pk

    bf = torch.bfloat16
    with pytest.raises(ValueError):
        if case == "d2s_fine_shape":
            pk.d2s_add(torch.zeros((2, 2, 32), dtype=bf), torch.zeros((4, 4, 16), dtype=bf))
        elif case == "d2s_dtype":
            pk.d2s_add(torch.zeros((2, 2, 32)), torch.zeros((4, 4, 8)))
        elif case == "d2s_c":
            pk.d2s_add(torch.zeros((2, 2, 16), dtype=bf), torch.zeros((4, 4, 4), dtype=bf))
        elif case == "head_w":
            pk.rowmajor_head_raw(torch.zeros((4, 12), dtype=torch.uint8), torch.zeros((12, 12), dtype=bf))
        elif case == "head_odd":
            pk.rowmajor_head_raw(torch.zeros((5, 12), dtype=torch.uint8), torch.zeros((12, 8), dtype=bf))
        else:
            pk.rowmajor_head_pre(torch.zeros((2, 2, 3, 4), dtype=torch.uint8), torch.zeros((12, 8), dtype=bf))


def test_probe_tools_import_without_a_card():
    """The port's probe tools import on the CPU and refuse to run without a card."""
    from hdrtv_tpu_torch.tools import proto_d2s_kernel, proto_rowmajor_head

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert proto_d2s_kernel.run(4, 8, 128, 1) == 2
    assert proto_rowmajor_head.run(16, 32, 1) == 2


def test_probe_tool_torch_sequences_match_plain():
    """The torch-op forms the port's probe tools time beside the kernels (a
    permute copy and a bf16 add; a regroup, cast and bf16 matmul) compute
    the same function: d2s bit for bit, the head within one bf16 step."""
    from hdrtv_tpu_torch.ops.probe_kernels import d2s_add_ref, rowmajor_head_raw_ref
    from hdrtv_tpu_torch.tools import proto_d2s_kernel, proto_rowmajor_head

    rng = np.random.RandomState(8)
    _, coarse = _bf16_pair(rng.randn(5, 6, 64) * 3)
    _, fine = _bf16_pair(rng.randn(10, 12, 16))
    assert torch.equal(proto_d2s_kernel.torch_sequence(coarse, fine), d2s_add_ref(coarse, fine))
    x = torch.from_numpy(rng.randint(0, 256, (8, 36), dtype=np.uint8))
    _, w = _bf16_pair(rng.randn(12, 32) * 0.1)
    _within_one_step(_np(proto_rowmajor_head.torch_sequence(x, w)), _np(rowmajor_head_raw_ref(x, w)))
