"""The port's double-s2d mode (``hdrtv_tpu_torch/models/dd.py``) against the
JAX package's (``hdrtv_tpu/models/dd.py``), on the CPU.

- data movement: ``s2d2`` / ``d2s2``, the quad-row view (a free view) and
  its round trip, equal to JAX's exactly;
- weight transforms: ``w_dd_s1``, ``w_dd_1x1``, ``w_dd_s2``, ``b_dd`` on
  seeded weights and ``dd_transform_params`` of the shipped checkpoint, each
  array equal to JAX's exactly;
- the forward: fp32 at 64 × 96 on the real checkpoint within 1e-5 of JAX's
  ``ensemble_dd`` and of the port's ``ensemble_s2d`` (``tests/test_dd.py``'s
  tolerance); bf16 at 32 × 48 within 3e-2 of JAX's dd bf16 and of the port's
  ``ensemble_s2d`` bf16 (its bf16 tolerance);
- the routing: the kernel wrappers the port's dd frame calls in bf16 and in
  fp32, counted by a spy, equal what the JAX module reaches on a TPU (its
  ``_use_fused_kernel`` / ``_sft_conv_ok`` predicates, traced abstractly
  with ``HDRTV_FORCE_FUSED_TRACE=1``), at a size whose widths pass the TPU
  width rule; the JAX routing at 1080p is the one chip_smoke.py asserts;
- the refusals (a composite tree, ``cfg.use_hg``, an active halo, sides
  not multiples of 4), the carry (no kernel pack; the biases rounded where
  JAX rounds them), and the wiring of chip_smoke.py's phase 15.

On the CPU every kernel wrapper runs its plain version.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_dd.py -q
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
FP32_ATOL = 1e-5  # tests/test_dd.py:91
BF16_ATOL = 3e-2  # tests/test_dd.py:151
ROUTE_SIZE = (72, 128)  # L2 width 32, L3 width 16 (multiples of 8); L3 height 9: trunks 2 and 4 fall back, as at 1080p
# the kernel wrappers the dd frame calls, by policy (the JAX module's routing on a TPU at ROUTE_SIZE and 1080p)
ROUTES = {
    "bf16": {"fused_down2": 3, "fused_resblock": 2, "fused_sft_conv3_v2": 4, "fused_block_conv3": 2},
    "fp32": {"fused_down2": 3, "fused_block_conv3": 10},
}
NEVER = ("fused_trunk3", "fused_mix_chain", "fused_agcm_head", "fused_cond_chain", "fused_tail")
_JAX_KERNELS = {"megakernel": ("fused_down2", "fused_resblock", "fused_sft_conv3_v2") + NEVER,
                "conv_kernels": ("fused_block_conv3",)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU programs on one intra-op thread: the suite runs in several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def natural():
    from hdrtv_tpu.models.import_torch import load_npz

    return load_npz(WEIGHTS)


@pytest.fixture(scope="module")
def trees(natural):
    """(JAX dd tree on device, port dd tree as numpy)."""
    from hdrtv_tpu.models.dd import dd_transform_params as jax_transform
    from hdrtv_tpu_torch.models.dd import dd_transform_params

    return {k: jnp.asarray(v) for k, v in jax_transform(natural).items()}, dd_transform_params(natural)


def _policies(name):
    from hdrtv_tpu.models import layers as jl
    from hdrtv_tpu_torch.models import layers as tl

    return (jl.F32, tl.F32) if name == "fp32" else (jl.BF16, tl.BF16)


# ---------------------------------------------------------------------------
# Data movement
# ---------------------------------------------------------------------------


def test_s2d2_d2s2_match_jax():
    from hdrtv_tpu.models import dd as jdd
    from hdrtv_tpu_torch.models import dd

    x = np.random.RandomState(0).rand(2, 8, 12, 3).astype(np.float32)
    y = dd.s2d2(torch.from_numpy(x))
    assert y.shape == (2, 2, 3, 48)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jdd.s2d2(jnp.asarray(x))))
    np.testing.assert_array_equal(dd.d2s2(y).numpy(), x)
    z = np.random.RandomState(1).rand(1, 3, 5, 32).astype(np.float32)
    np.testing.assert_array_equal(dd.d2s2(torch.from_numpy(z)).numpy(), np.asarray(jdd.d2s2(jnp.asarray(z))))


def test_quads_match_jax():
    """The quad-row view is a free view of the byte rows; ``dd_from_quads``
    of it equals JAX's and ``s2d2`` of the frame; ``quads_from_dd`` inverts
    it on u16 output, where the planes are the flat RGB48 rows."""
    from hdrtv_tpu.models import dd as jdd
    from hdrtv_tpu_torch.models import dd

    np.testing.assert_array_equal(dd._QUAD_PERM, jdd._QUAD_PERM)
    rng = np.random.RandomState(4)
    h, w = 16, 24
    frame2d = (rng.rand(h, 3 * w) * 255).astype(np.uint8)
    v = dd.dd_quads_view(frame2d)
    assert v.shape == (h // 4, 4, w // 4, 12) and (v.base is frame2d or v.base is frame2d.base)
    got = dd.dd_from_quads(torch.from_numpy(v))
    want = np.asarray(jdd.dd_from_quads(jnp.asarray(jdd.dd_quads_view(frame2d))))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    s = dd.s2d2(torch.from_numpy(frame2d.reshape(1, h, w, 3).astype(np.float32)))
    np.testing.assert_array_equal(got.float().numpy(), s.numpy())

    rows = (rng.rand(h, 3 * w) * 65535).astype(np.uint16)
    x = dd.dd_from_quads(torch.from_numpy(rows.reshape(h // 4, 4, w // 4, 12).astype(np.int32)).to(torch.uint16))
    back = dd.quads_from_dd(x)
    assert back.dtype == torch.uint16
    back = back.to(torch.int32).numpy()
    np.testing.assert_array_equal(back.reshape(h, 3 * w), rows)
    np.testing.assert_array_equal(
        back, np.asarray(jdd.quads_from_dd(jdd.dd_from_quads(jnp.asarray(rows.reshape(h // 4, 4, w // 4, 12))))))


# ---------------------------------------------------------------------------
# Weight transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn,shape", [("w_dd_s1", (3, 3, 2, 3)), ("w_dd_s1", (3, 3, 4, 1)),
                                      ("w_dd_1x1", (1, 1, 2, 4)), ("w_dd_s2", (3, 3, 2, 3)),
                                      ("w_dd_s2", (3, 3, 3, 2)), ("b_dd", (5,))])
def test_weight_transforms_match_jax(fn, shape):
    from hdrtv_tpu.models import dd as jdd
    from hdrtv_tpu_torch.models import dd

    w = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    got, want = getattr(dd, fn)(w), getattr(jdd, fn)(w)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_w_dd_s2_is_the_strided_conv():
    """The 2×2 (1,0)-padded conv over s2d2(x) with ``w_dd_s2`` equals s2d of
    the natural stride-2 'same' conv (torch ops on both sides)."""
    from hdrtv_tpu_torch.models import dd
    from hdrtv_tpu_torch.models.layers import conv_nhwc
    from hdrtv_tpu_torch.models.s2d import s2d

    rng = np.random.RandomState(2)
    w = rng.rand(3, 3, 2, 3).astype(np.float32)
    x = torch.from_numpy(rng.rand(1, 16, 24, 2).astype(np.float32))
    ref = s2d(conv_nhwc(x, torch.from_numpy(w), stride=2, padding=1))
    out = conv_nhwc(dd.s2d2(x), torch.from_numpy(dd.w_dd_s2(w)), padding=((1, 0), (1, 0)))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-6, rtol=0)


def test_dd_transform_params_match_jax(natural, trees):
    from hdrtv_tpu_torch.models import dd

    jp, tp = trees
    assert set(tp) == set(jp)
    assert "LE.__cond_down.weight" not in tp and "LE.__in_fused.weight" in tp
    for k, v in tp.items():
        want = np.asarray(jp[k])
        assert v.dtype == want.dtype and v.shape == want.shape, k
        np.testing.assert_array_equal(v, want, err_msg=k)
    assert tp["LE.HR_conv1.weight"].shape == (3, 3, 512, 512)
    assert tp["LE.down_conv1.weight"].shape == (2, 2, 512, 128)
    np.testing.assert_array_equal(tp["LE.HR_conv1.bias"], dd.b_dd(natural["LE.HR_conv1.bias"]))


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------


def test_ensemble_dd_fp32_matches_jax_and_s2d(natural, trees):
    from hdrtv_tpu.models.dd import ensemble_dd as jax_dd
    from hdrtv_tpu_torch.models.dd import dd_params_to_torch, ensemble_dd
    from hdrtv_tpu_torch.models.s2d import ensemble_s2d, params_to_torch, s2d_transform_params

    jp, tp = trees
    rng = np.random.RandomState(0)
    img = rng.rand(1, 64, 96, 3).astype(np.float32)
    cond = rng.rand(1, 16, 24, 3).astype(np.float32)
    got = ensemble_dd(dd_params_to_torch(tp, "cpu"), torch.from_numpy(img), torch.from_numpy(cond))
    assert got.shape == (1, 64, 96, 3) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(jax_dd(jp, jnp.asarray(img), jnp.asarray(cond))),
                               atol=FP32_ATOL, rtol=0)
    sp = params_to_torch(s2d_transform_params(natural), "cpu")
    s = ensemble_s2d(sp, torch.from_numpy(img), torch.from_numpy(cond)).numpy()
    np.testing.assert_allclose(got, s, atol=FP32_ATOL, rtol=0)


def test_ensemble_dd_bf16_matches_jax_and_s2d(natural, trees):
    from hdrtv_tpu.models.dd import ensemble_dd as jax_dd
    from hdrtv_tpu_torch.models.dd import dd_params_to_torch, ensemble_dd
    from hdrtv_tpu_torch.models.s2d import ensemble_s2d, params_to_torch, s2d_transform_params

    jpol, tpol = _policies("bf16")
    jp, tp = trees
    rng = np.random.RandomState(6)
    img = rng.rand(1, 32, 48, 3).astype(np.float32)
    cond = rng.rand(1, 8, 12, 3).astype(np.float32)
    got = ensemble_dd(dd_params_to_torch(tp, "cpu", tpol), torch.from_numpy(img), torch.from_numpy(cond),
                      policy=tpol)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 32, 48, 3)
    got = got.float().numpy()
    want = np.asarray(jax_dd(jp, jnp.asarray(img), jnp.asarray(cond), policy=jpol)).astype(np.float32)
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    sp = params_to_torch(s2d_transform_params(natural), "cpu", tpol)
    s = ensemble_s2d(sp, torch.from_numpy(img), torch.from_numpy(cond), policy=tpol).float().numpy()
    np.testing.assert_allclose(got, s, atol=BF16_ATOL, rtol=0)


def test_bf16_biases_round_where_jax_rounds(trees):
    """Every bias no kernel reads, carried fp32 or rounded to bf16 at load,
    gives the same bf16 frame bit for bit: the port rounds it once where a
    torch op uses it (``policy.cast``), as JAX's ``policy.cast`` does. The
    biases the kernels read stay fp32 (the wrappers refuse others)."""
    from hdrtv_tpu_torch.models.dd import dd_params_to_torch, ensemble_dd

    _, tpol = _policies("bf16")
    _, tp = trees
    p = dd_params_to_torch(tp, "cpu", tpol)
    kernel_layers = ("LE.down_conv2.", "LE.CondNet3.2.", "LE.CondNet4.2.", "LE.up_conv2.0.", "LE.up_conv3.0.") + tuple(
        f"LE.recon_trunk{i}.0." for i in (1, 2, 4, 5))
    kept = [k for k, v in p.items() if k.endswith(".bias") and v.dtype == torch.float32]
    assert all(p[f"{layer}conv1.bias" if "trunk" in layer else f"{layer}bias"].dtype == torch.float32
               for layer in kernel_layers)
    others = [k for k in kept if not k.startswith(kernel_layers)]
    assert "LE.HR_conv1.bias" in others and "LE.SFT_layer1.SFT_scale_conv0.bias" in others
    rounded = dict(p)
    for k in others:
        rounded[k] = p[k].to(torch.bfloat16).float()
    rng = np.random.RandomState(7)
    img = torch.from_numpy(rng.rand(1, 32, 48, 3).astype(np.float32))
    cond = torch.from_numpy(rng.rand(1, 8, 12, 3).astype(np.float32))
    a = ensemble_dd(p, img, cond, policy=tpol)
    b = ensemble_dd(rounded, img, cond, policy=tpol)
    assert torch.equal(a, b)


def test_carry_builds_no_pack_and_defaults_to_the_card(trees, monkeypatch):
    from hdrtv_tpu_torch.models import s2d
    from hdrtv_tpu_torch.models.dd import dd_params_to_torch

    _, tp = trees
    for policy in _policies("fp32")[1], _policies("bf16")[1]:
        p = dd_params_to_torch(tp, "cpu", policy)
        packs = (s2d._TRUNK3_PACKED, *s2d._TRUNK3_PACKED_BF16, s2d._HEAD_AW1_BGR, *s2d._HEAD_PACKED,
                 *s2d._HEAD_PACKED_S2D)
        assert not any(k in p for k in packs) and set(p) == set(tp)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dd_params_to_torch(tp)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def _frame(h=32, w=48):
    rng = np.random.RandomState(3)
    return (torch.from_numpy(rng.rand(1, h, w, 3).astype(np.float32)),
            torch.from_numpy(rng.rand(1, h // 4, w // 4, 3).astype(np.float32)))


def test_refusals(natural, trees):
    from hdrtv_tpu_torch.models.dd import dd_params_to_torch, dd_transform_params, ensemble_dd, le_dd
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig
    from hdrtv_tpu_torch.parallel import halo

    _, tp = trees
    p = dd_params_to_torch(tp, "cpu")
    composite = {**{f"base.{k}": v for k, v in natural.items()}, "hg.conv1.0.weight": np.zeros((3, 3, 3, 64))}
    with pytest.raises(ValueError, match="composite"):
        dd_transform_params(composite)
    with pytest.raises(ValueError, match="composite"):
        dd_params_to_torch({**tp, "hg.conv1.0.weight": np.zeros((3, 3, 3, 64), np.float32)}, "cpu")
    img, cond = _frame()
    with pytest.raises(ValueError, match="composite"):
        ensemble_dd({**p, "hg.conv1.0.weight": torch.zeros(3, 3, 3, 64)}, img, cond)
    with pytest.raises(ValueError, match="use_hg"):
        ensemble_dd(p, img, cond, ModelConfig(use_hg=True))
    with halo.manual_axis("spatial"):
        with pytest.raises(ValueError, match="sharded"):
            ensemble_dd(p, img, cond)
        with pytest.raises(ValueError, match="sharded"):
            le_dd(p, img, img, policy=_policies("fp32")[1])
    for h, w in ((30, 48), (32, 46)):
        img, cond = _frame(h, w)
        with pytest.raises(ValueError, match="multiples of 4"):
            ensemble_dd(p, img, cond)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def _jax_routes(jp, policy, h, w) -> dict:
    """The Pallas kernel entry points the JAX dd frame reaches on a TPU: its
    routing predicates with HDRTV_FORCE_FUSED_TRACE=1, the frame traced
    abstractly (nothing runs), each entry point counted on the way."""
    from hdrtv_tpu.models import dd as jdd
    from hdrtv_tpu.ops import conv_kernels, megakernel

    mods = {"megakernel": megakernel, "conv_kernels": conv_kernels}
    calls, saved = {}, {}
    for mod_name, names in _JAX_KERNELS.items():
        for name in names:
            fn = saved[(mod_name, name)] = getattr(mods[mod_name], name)

            def counted(*a, _fn=fn, _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **k)
            setattr(mods[mod_name], name, counted)
    prev = os.environ.get("HDRTV_FORCE_FUSED_TRACE")
    os.environ["HDRTV_FORCE_FUSED_TRACE"] = "1"
    try:
        out = jax.eval_shape(lambda p, i, c: jdd.ensemble_dd(p, i, c, policy=policy), jp,
                             jax.ShapeDtypeStruct((1, h, w, 3), jnp.float32),
                             jax.ShapeDtypeStruct((1, h // 4, w // 4, 3), jnp.float32))
    finally:
        for (mod_name, name), fn in saved.items():
            setattr(mods[mod_name], name, fn)
        if prev is None:
            del os.environ["HDRTV_FORCE_FUSED_TRACE"]
        else:
            os.environ["HDRTV_FORCE_FUSED_TRACE"] = prev
    assert out.shape == (1, h, w, 3)
    return calls


@pytest.mark.parametrize("policy", ["bf16", "fp32"])
def test_routing_matches_jax_on_a_tpu(trees, policy, monkeypatch):
    """The kernel wrappers one dd frame calls (a spy on ``models/s2d.py``'s
    names, which the dd module's L2+ helpers call; nothing else reaches a
    wrapper) equal the Pallas entry points the JAX frame reaches on a TPU at
    ROUTE_SIZE, and those at 1080p; trunk3, mix_chain, the head, the cond
    chain and the tail see no call."""
    from hdrtv_tpu_torch.models import dd, s2d
    from hdrtv_tpu_torch.models.dd import dd_params_to_torch, ensemble_dd

    jpol, tpol = _policies(policy)
    jp, tp = trees
    calls = {}
    for name in tuple(ROUTES["bf16"]) + NEVER:
        def counted(*a, _fn=getattr(s2d, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(s2d, name, counted)
        assert not hasattr(dd, name)
    img, cond = _frame(*ROUTE_SIZE)
    out = ensemble_dd(dd_params_to_torch(tp, "cpu", tpol), img, cond, policy=tpol)
    assert out.shape == (1, *ROUTE_SIZE, 3) and bool(torch.isfinite(out.float()).all())
    assert calls == ROUTES[policy]
    assert _jax_routes(jp, jpol, *ROUTE_SIZE) == ROUTES[policy]
    assert _jax_routes(jp, jpol, 1080, 1920) == ROUTES[policy]


# ---------------------------------------------------------------------------
# chip_smoke.py phase 15
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_dd", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase_dd_is_wired_into_main():
    """Phase 15 runs after phase 14 inside main's fp32_math block, its launch
    counts join the kernels line's (paths dd_bf16, dd_fp32, asserted equal to
    the routing above), and its line comes before the card's line."""
    import inspect

    mod = _chip_smoke()
    src = inspect.getsource(mod.main)
    mesh, dd = src.index("phase_mesh(torch, np, native,"), src.index("phase_dd(torch, np, native, smi, tmp)")
    assert src.index("with fp32_math():") < mesh < dd < src.index("finally:")
    assert "counts.update(dd_counts)" in src
    assert src.index("log(mesh_line(mesh))") < src.index("log(dd_line(dd))") < src.index("log(smi)")
    assert "15. the double-s2d mode" in mod.__doc__
    wrapper_kernel = {"fused_down2": "down2", "fused_resblock": "resblock", "fused_sft_conv3_v2": "sft_conv3",
                      "fused_block_conv3": "block_conv3"}
    for path, policy in (("dd_bf16", "bf16"), ("dd_fp32", "fp32")):
        assert mod.DD_LAUNCHES[path] == {wrapper_kernel[k]: v for k, v in ROUTES[policy].items()}
        assert set(mod.DD_LAUNCHES[path]) <= set(mod.KERNEL_INFO)


def test_dd_line_shape():
    """Phase 15's {"dd": ...} line: every key of DD_KEYS in order; a missing
    or an extra key fails."""
    import json

    mod = _chip_smoke()
    figures = {k: {"x": 1} for k in mod.DD_KEYS}
    body = json.loads(mod.dd_line(dict(reversed(list(figures.items())))))
    assert list(body) == ["dd"] and tuple(body["dd"]) == mod.DD_KEYS
    for broken in ({k: v for k, v in figures.items() if k != "calls"}, {**figures, "extra": 1}):
        with pytest.raises(AssertionError, match="dd line"):
            mod.dd_line(broken)


def test_dd_planted_fault_moves_the_frame(trees):
    """The planted fault of phase 15 (b), ``w_dd_s2``'s Δ one row off in
    down_conv1, moves the fp32 frame on the CPU by far more than phase 15's
    fp32 bound; the unfaulted frame stays inside it."""
    from hdrtv_tpu_torch.models.dd import dd_params_to_torch, ensemble_dd

    mod = _chip_smoke()
    _, tp = trees
    p = dd_params_to_torch(tp, "cpu")
    bad = dd_params_to_torch(mod.dd_planted_fault(tp), "cpu")
    img, cond = _frame(64, 96)
    ref = ensemble_dd(p, img, cond)
    codes = lambda y: (y.clamp(0, 1) * 65535 + 0.5).to(torch.int32)  # noqa: E731
    moved = (codes(ensemble_dd(bad, img, cond)) - codes(ref)).abs()
    assert int(moved.max()) > 10 * mod.DD_FRAME_CODES["fp32"][0]
    assert int((codes(ensemble_dd(p, img, cond)) - codes(ref)).abs().max()) <= mod.DD_FRAME_CODES["fp32"][0]
