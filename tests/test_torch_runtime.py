"""The runtime of hdrtv_tpu_torch on the CPU against hdrtv_tpu: the whole
public API of ``HDRTVNetTorch`` (``proc_resolution``, the fast-condition
shortcuts, the stage API, ``process``, ``passthrough_rgb48``,
``process_rgb48_batch``, ``process_timed``, ``warmup_compile``,
``with_proc_resolution``), ``ops/resize.py``'s letterbox and bilinear ¼-res
functions, ``runtime/engine.py`` (the fingerprint, the registry, the graph
signature), and the bf16 megakernel program of an nf = 16 checkpoint.

Same numpy inputs from a seed go through both packages. fp32 frames within
CODES (the 5e-5 golden tolerance × 65535, rounded up), as
``tests/test_torch_slice.py`` holds them; BGR u8 frames within 1 code (the
8-bit rounding at the +0.5 boundary). The CUDA graphs themselves run only on
a card (``tests/test_torch_cuda.py``).
"""

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import load_fixture

ROOT = os.path.join(os.path.dirname(__file__), "..")
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
CODES = 4


def _frame(h, w, seed):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def fp32_pair():
    """One fp32 processor per package, no letterbox, no shortcut."""
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    return (HDRTVNetTPU(WEIGHTS, precision="fp32", persistent_cache=False),
            HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu", persistent_cache=False))


# ---------------------------------------------------------------------------
# The nf = 16 bf16 megakernel program (a fault of the port until the tail's
# biases stayed fp32 at every width)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nf16(tmp_path_factory):
    """The synthetic nf = 16 checkpoint of tests/test_torch_card_widths.py,
    its bf16 port processor, and the port's frame on the 64 × 96 frame with
    the kernel wrappers it called."""
    from hdrtv_tpu_torch.models import s2d as port_s2d
    from hdrtv_tpu_torch.models.import_npz import load_npz, save_npz
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    out = {}
    for k, v in load_npz(WEIGHTS).items():
        if k.startswith("LE.") and not k.startswith(("LE.cond_first", "LE.CondNet")):
            v = v[tuple(slice(0, d // 2) if d in (32, 128) else slice(None) for d in v.shape)]
        out[k] = v
    with open(os.path.join(ROOT, "weights", "hr_fp32.json")) as f:
        arch = {**json.load(f), "nf": 16}
    path = str(tmp_path_factory.mktemp("nf16") / "hr_nf16.npz")
    save_npz(path, out, {"architecture": arch})

    frame = _frame(64, 96, 16)
    calls = {}
    mp = pytest.MonkeyPatch()
    for name in ("fused_agcm_head", "fused_cond_chain", "fused_tail"):
        def counted(*a, _fn=getattr(port_s2d, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        mp.setattr(port_s2d, name, counted)
    mp.delenv("HDRTV_MEGAKERNEL", raising=False)
    try:
        got = HDRTVNetTorch(path, precision="fp16", device="cpu", persistent_cache=False).process_rgb48(frame)
    finally:
        mp.undo()
    return path, frame, got, calls


def test_nf16_bf16_runs_the_megakernel_program(nf16):
    from hdrtv_tpu_torch.models.s2d import _fp32_param_names, s2d_transform_params
    from hdrtv_tpu_torch.models.import_npz import load_npz

    path, _, got, calls = nf16
    assert calls == {"fused_agcm_head": 1, "fused_cond_chain": 1, "fused_tail": 1}
    assert got.shape == (64, 96, 3) and got.dtype == np.uint16 and got.max() > 0
    # the tail's biases reach fused_tail fp32 at nf = 16, where HR_conv2's 64 s2d channels fit no conv kernel
    keep = _fp32_param_names(s2d_transform_params(load_npz(path)))
    assert {"LE.HR_conv2.bias", "LE.SFT_layer2.SFT_scale_conv0.bias", "LE.SFT_layer2.SFT_shift_conv1.bias"} <= keep


def test_nf16_bf16_matches_jax_lax_program(nf16):
    """Against ``HDRTVNetTPU(precision="fp16")``, which off the TPU runs its
    all-lax program: within 3e-2 of full scale, the bound of
    ``test_bf16_slice_matches_jax_lax_program`` (seen: max 636, mean 108.7)."""
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU

    path, frame, got, _ = nf16
    want = HDRTVNetTPU(path, precision="fp16", persistent_cache=False).process_rgb48(frame)
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 3e-2 * 65535


def test_nf16_bf16_matches_jax_mega_program(nf16, monkeypatch):
    """Against the JAX megakernel program with its Pallas kernels in
    interpret mode, within the bounds of
    ``test_bf16_mega_slice_matches_jax_mega_program`` (max 192, mean 13.1
    codes; seen here: max 22, mean 1.55)."""
    from jax.experimental.pallas import tpu as pltpu

    from hdrtv_tpu.models.hdrtvnet import ModelConfig
    from hdrtv_tpu.models.import_torch import load_npz, load_npz_meta, npz_arch_dict
    from hdrtv_tpu.models.layers import BF16
    from hdrtv_tpu.models.s2d import ensemble_s2d_rgb48_pairs, s2d_transform_params

    path, frame, got, _ = nf16
    cfg = ModelConfig.from_arch_dict(npz_arch_dict(load_npz_meta(path)))
    pj = {k: jnp.asarray(v) for k, v in s2d_transform_params(load_npz(path), cfg).items()}
    monkeypatch.setenv("HDRTV_FORCE_FUSED_TRACE", "1")
    monkeypatch.setenv("HDRTV_MEGAKERNEL_INTERPRET", "1")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ensemble_s2d_rgb48_pairs(pj, jnp.asarray(frame.reshape(32, 2, 48, 6)), None,
                                                   policy=BF16, bgr=True))
    d = np.abs(got.astype(np.int64) - want.reshape(64, 96, 3).astype(np.int64))
    assert d.max() <= 192 and d.mean() <= 13.1, (int(d.max()), float(d.mean()))


# ---------------------------------------------------------------------------
# ops/resize.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,oh,ow", [(128, 96, 64, 96), (48, 64, 64, 96), (1080, 1440, 1080, 1920),
                                       (99, 131, 360, 640), (64, 96, 64, 96)])
def test_letterbox_plan_matches_jax(h, w, oh, ow):
    from hdrtv_tpu.ops.resize import letterbox_plan as jax_plan
    from hdrtv_tpu_torch.ops.resize import letterbox_plan

    assert letterbox_plan(h, w, oh, ow) == jax_plan(h, w, oh, ow)


@pytest.mark.parametrize("h,w,oh,ow", [(128, 96, 64, 96), (64, 128, 64, 96), (48, 64, 64, 96), (20, 30, 64, 96)],
                         ids=["down_bars_lr", "down_bars_tb", "up", "up_x3"])
def test_letterbox_u8_matches_jax(h, w, oh, ow):
    """Downscale (INTER_AREA) and upscale (bicubic) cases within one code of
    the JAX letterbox; the bars are black."""
    from hdrtv_tpu.ops.resize import letterbox_u8 as jax_letterbox
    from hdrtv_tpu_torch.ops.resize import letterbox_plan, letterbox_u8

    frame = _frame(h, w, h * w)
    got = letterbox_u8(torch.from_numpy(frame), oh, ow).numpy()
    want = np.asarray(jax_letterbox(jnp.asarray(frame), oh, ow))
    assert got.shape == want.shape == (oh, ow, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(np.int64) - want).max() <= 1
    nh, nw, top, left, _ = letterbox_plan(h, w, oh, ow)
    inside = np.zeros((oh, ow), bool)
    inside[top:top + nh, left:left + nw] = True
    assert got[~inside].max(initial=0) == 0


def test_letterbox_u8_same_size_is_the_frame():
    from hdrtv_tpu_torch.ops.resize import letterbox_u8

    frame = torch.from_numpy(_frame(64, 96, 1))
    assert letterbox_u8(frame, 64, 96) is frame


def test_quarter_bilinear_matches_torch_golden():
    from hdrtv_tpu_torch.ops.resize import downsample_quarter_bilinear

    fx = load_fixture("cond_resize.npz")
    out = downsample_quarter_bilinear(torch.from_numpy(fx["frame"]))
    np.testing.assert_allclose(out.numpy(), fx["quarter_bilinear"], atol=2e-6, rtol=0)


@pytest.mark.parametrize("fn", ["resize_area", "resize_bicubic_aa"])
def test_resizes_match_jax(fn):
    import hdrtv_tpu.ops.resize as jax_resize
    import hdrtv_tpu_torch.ops.resize as port_resize

    x = np.random.RandomState(7).rand(1, 40, 56, 3).astype(np.float32)
    for oh, ow in ((20, 28), (13, 17)) if fn == "resize_area" else ((20, 28), (60, 84)):
        got = getattr(port_resize, fn)(torch.from_numpy(x), oh, ow).numpy()
        want = np.asarray(getattr(jax_resize, fn)(jnp.asarray(x), oh, ow))
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    np.testing.assert_array_equal(port_resize.area_matrix(40, 13), jax_resize.area_matrix(40, 13))


def test_resize_matrices_stay_on_the_device():
    """The separable resize copies its matrices to the device once per
    (sizes, kind, device): a later frame of the same size reuses them."""
    from hdrtv_tpu_torch.ops import resize

    x = torch.rand(1, 48, 64, 3)
    resize._device_matrices.cache_clear()
    resize.downsample_quarter_aa(x)
    resize.downsample_quarter_bilinear(x)
    resize.downsample_quarter_aa(x)
    info = resize._device_matrices.cache_info()
    assert (info.misses, info.hits) == (2, 1)


@pytest.mark.parametrize("call", ["separable", "flat", "pairs"])
def test_hold_matrices_keeps_what_the_block_read(call):
    """``hold_matrices`` collects the cached device matrices each resize
    form reads inside the block, and they outlive their cache (a graph
    captured there replays their addresses); outside a block nothing is
    collected."""
    from hdrtv_tpu_torch.ops import resize

    frame = torch.from_numpy((np.random.RandomState(3).rand(48, 64, 3) * 255).astype(np.uint8))
    run = {"separable": lambda: resize.downsample_quarter_aa(frame[None].float() / 255.0),
           "flat": lambda: resize.downsample_quarter_aa_flat(frame.reshape(48, 192)),
           "pairs": lambda: resize.downsample_quarter_aa_pairs(frame.reshape(24, 2, 32, 6))}[call]
    caches = (resize._device_matrices, resize._flat_matrices, resize._pairs_matrices)
    for cache in caches:
        cache.cache_clear()
    want = run()
    with resize.hold_matrices() as held, resize.hold_matrices() as inner:
        got = run()
    assert len(held) == 2 and [t is u for t, u in zip(held, inner)] == [True, True]
    ptrs = [t.data_ptr() for t in held]
    for cache in caches:
        cache.cache_clear()
    assert [t.data_ptr() for t in held] == ptrs and held[0].shape[0] == 12
    run()
    assert len(held) == 2 and not resize._holders
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# proc_resolution and the fast-condition shortcuts against HDRTVNetTPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def letterbox_pair():
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    return (HDRTVNetTPU(WEIGHTS, precision="fp32", persistent_cache=False, proc_resolution=(96, 64)),
            HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu", persistent_cache=False,
                          proc_resolution=(96, 64)))


@pytest.mark.parametrize("h,w", [(64, 128), (48, 64)], ids=["down", "up"])
def test_proc_resolution_matches_jax(letterbox_pair, fp32_pair, h, w):
    """Frames letterboxed on the device to (W, H) = (96, 64) first: against
    HDRTVNetTPU within CODES, and equal (≤ 1 code) to the port processing
    the pre-letterboxed frame, as tests/test_runtime.py holds the JAX one."""
    from hdrtv_tpu_torch.ops.resize import letterbox_u8

    jax_proc, proc = letterbox_pair
    frame = _frame(h, w, h + w)
    assert not proc.wants_pairs(h, w) and proc._program(torch.zeros(h, 3 * w, dtype=torch.uint8)) == "flat"
    got = proc.process_rgb48(frame)
    want = jax_proc.process_rgb48(frame)
    assert got.shape == want.shape == (64, 96, 3) and got.dtype == np.uint16
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= CODES
    pre = letterbox_u8(torch.from_numpy(frame), 64, 96).numpy()
    ref = fp32_pair[1].process_rgb48(pre)
    assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1


def test_proc_resolution_device_layouts(letterbox_pair):
    """The three layouts of process_rgb48_device come back at the processing
    size, the same bytes in each."""
    proc = letterbox_pair[1]
    frame = _frame(64, 128, 3)
    flat = torch.from_numpy(frame.reshape(64, 384).copy())
    rows = proc.process_rgb48_device(flat)
    hwc = proc.process_rgb48_device(flat.reshape(64, 128, 3))
    pairs = proc.process_rgb48_device(flat.reshape(32, 2, 64, 6))
    assert rows.shape == (64, 288) and hwc.shape == (64, 96, 3) and pairs.shape == (32, 2, 48, 6)
    assert torch.equal(rows.reshape(64, 96, 3), hwc) and torch.equal(pairs.reshape(64, 96, 3), hwc)


def test_batch_letterboxes_to_processing_resolution(letterbox_pair):
    proc = letterbox_pair[1]
    frames = (np.random.RandomState(2).rand(2, 128, 96, 3) * 255).astype(np.uint8)
    out = proc.process_rgb48_batch(frames)
    assert out.shape == (2, 64, 96, 3) and out.dtype == np.uint16
    np.testing.assert_array_equal(out[0], proc.process_rgb48(frames[0]))
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        proc.process_rgb48_batch(frames, mesh=object())


@pytest.fixture(scope="module", params=["fast_condition_resize", "fast_zero_condition"])
def shortcut_pair(request):
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    kw = {request.param: True}
    return (request.param,
            HDRTVNetTPU(WEIGHTS, precision="fp32", persistent_cache=False, **kw),
            HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu", persistent_cache=False, **kw))


@pytest.mark.parametrize("h,w", [(64, 96), (60, 92)], ids=["s2d", "natural"])
def test_fast_condition_matches_jax(shortcut_pair, fp32_pair, h, w):
    """The bilinear ¼-res condition and the zero condition, on an s2d frame
    and on a natural one, against HDRTVNetTPU with the same flag within
    CODES; the frames ship as flat rows; the shortcut changes the frame."""
    flag, jax_proc, proc = shortcut_pair
    frame = _frame(h, w, h * 7 + w)
    assert getattr(proc, flag) and not proc.wants_pairs(h, w)
    assert proc._program(proc.put_frame(frame.reshape(h, 3 * w))) == ("flat" if h % 8 == 0 else "natural")
    got = proc.process_rgb48(frame)
    want = jax_proc.process_rgb48(frame)
    assert got.shape == (h, w, 3) and got.dtype == np.uint16
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= CODES
    assert not np.array_equal(got, fp32_pair[1].process_rgb48(frame))


def test_fast_condition_from_the_environment(monkeypatch):
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    monkeypatch.setenv("HDRTVNET_FAST_COND_RESIZE", "1")
    monkeypatch.setenv("HDRTVNET_FAST_ZERO_CONDITION", "1")
    proc = HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu", persistent_cache=False)
    assert proc.fast_condition_resize and proc.fast_zero_condition
    x = torch.rand(1, 32, 48, 3)
    assert torch.equal(proc._cond_of(x), torch.zeros(1, 8, 12, 3))


# ---------------------------------------------------------------------------
# The stage API, process, passthrough
# ---------------------------------------------------------------------------


def test_process_and_stages_match_jax(fp32_pair):
    """process (BGR u8) against HDRTVNetTPU within 1 code; preprocess →
    infer → postprocess gives the same bytes as process; preprocess's image
    and condition against the JAX ones."""
    jax_proc, proc = fp32_pair
    frame = _frame(64, 96, 11)
    got = proc.process(frame)
    want = jax_proc.process(frame)
    assert got.shape == (64, 96, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(np.int64) - want).max() <= 1
    x, cond = proc.preprocess(frame)
    jx, jcond = jax_proc.preprocess(frame)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=0, rtol=0)
    np.testing.assert_allclose(cond.numpy(), np.asarray(jcond), atol=2e-6, rtol=0)
    np.testing.assert_array_equal(proc.postprocess(proc.infer((x, cond))), got)


def test_passthrough_matches_jax(fp32_pair):
    jax_proc, proc = fp32_pair
    frame = _frame(20, 30, 5)
    got = proc.passthrough_rgb48(frame)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, jax_proc.passthrough_rgb48(frame))
    dev = proc.passthrough_rgb48_device(torch.from_numpy(frame))
    np.testing.assert_array_equal(dev.numpy(), got)


def test_process_timed_returns_the_stage_times(fp32_pair):
    proc = fp32_pair[1]
    frame = _frame(32, 48, 9)
    res, pre, inf, post = proc.process_timed(frame)
    np.testing.assert_array_equal(res, proc.process(frame))
    assert all(isinstance(t, float) and t >= 0.0 for t in (pre, inf, post)) and inf > 0.0


def test_with_proc_resolution_shares_parameters(fp32_pair):
    proc = fp32_pair[1]
    clone = proc.with_proc_resolution((48, 32))
    assert clone.proc_resolution == (48, 32) and proc.proc_resolution is None
    assert clone.params is proc.params and clone._nat_params is proc._nat_params
    assert clone.graphs is not proc.graphs and clone._timings == {}
    assert clone.process_rgb48(_frame(64, 96, 4)).shape == (32, 48, 3)
    assert proc.end_profiling() is None


def test_warmup_compile_records_the_signature(tmp_path, monkeypatch):
    from hdrtv_tpu_torch.runtime.engine import EngineRegistry
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    monkeypatch.setenv("HDRTVNET_ENGINE_CACHE_DIR", str(tmp_path))
    proc = HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu")
    dt = proc.warmup_compile(48, 32)
    dt2 = proc.warmup_compile(48, 32, rgb48=False)
    assert dt > 0 and dt2 > 0
    key = f"{proc.model_hash}_48x32_fp32"
    rec = EngineRegistry().lookup(key)
    assert rec is not None and rec.device_name == "cpu" and rec.torch_version == torch.__version__
    assert EngineRegistry().validate(key, proc.model_hash) and set(proc._timings) == {key}
    assert HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu", persistent_cache=False).registry is None


# ---------------------------------------------------------------------------
# runtime/engine.py
# ---------------------------------------------------------------------------


def test_model_fingerprint_matches_jax(fp32_pair):
    from hdrtv_tpu.models.import_torch import load_npz
    from hdrtv_tpu.runtime.engine import model_fingerprint as jax_fp
    from hdrtv_tpu_torch.runtime.engine import model_fingerprint

    params = load_npz(WEIGHTS)
    assert model_fingerprint(params) == jax_fp(params)
    jax_proc, proc = fp32_pair
    assert proc.model_hash == jax_proc.model_hash  # the s2d-transformed parameters


def test_engine_registry_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("HDRTVNET_ENGINE_CACHE_DIR", str(tmp_path / "engines"))
    from hdrtv_tpu_torch.runtime.engine import EngineRecord, EngineRegistry, default_cache_root

    assert default_cache_root() == str(tmp_path / "engines")
    reg = EngineRegistry()
    assert reg.list() == [] and not (tmp_path / "engines").exists()  # made at the first record
    key = EngineRecord.make_key("abc123", 1920, 1080, "fp16")
    assert key == "abc123_1920x1080_fp16"
    reg.record(EngineRecord(key=key, model_hash="abc123", width=1920, height=1080, precision="fp16",
                            use_hg=False, torch_version="2.x", device_name="test", compile_seconds=1.5,
                            created=time.time()))
    assert reg.lookup(key).model_hash == "abc123"
    assert reg.validate(key, "abc123") and not reg.validate(key, "OTHER")
    assert len(reg.list()) == 1
    assert reg.clear() == 1 and reg.lookup(key) is None


def test_engine_cache_root_overrides(monkeypatch):
    from hdrtv_tpu_torch.runtime.engine import default_cache_root

    monkeypatch.delenv("HDRTVNET_ENGINE_CACHE_DIR", raising=False)
    monkeypatch.setenv("HDRTVNET_CACHE_DIR", "/x/shared")
    assert default_cache_root() == "/x/shared"
    monkeypatch.setenv("HDRTVNET_ENGINE_CACHE_DIR", "/x/engines")
    assert default_cache_root() == "/x/engines"
    monkeypatch.delenv("HDRTVNET_ENGINE_CACHE_DIR")
    monkeypatch.delenv("HDRTVNET_CACHE_DIR")
    assert default_cache_root().endswith(os.path.join(".cache", "hdrtv_tpu_torch", "engines"))


def test_clear_leaves_foreign_files(tmp_path, monkeypatch):
    """clear removes only what the registry writes, in a shared directory."""
    monkeypatch.setenv("HDRTVNET_ENGINE_CACHE_DIR", str(tmp_path))
    from hdrtv_tpu_torch.runtime.engine import EngineRegistry

    reg = EngineRegistry()
    (tmp_path / "engines.json").write_text("{}")
    (tmp_path / "jit_step_deadbeef").write_text("x")
    (tmp_path / ("a" * 40)).write_text("x")
    (tmp_path / "my_thesis.docx").write_text("precious")
    assert reg.clear() == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(["jit_step_deadbeef", "a" * 40, "my_thesis.docx"])


SIG_ARGS = ((540, 2, 960, 6), torch.uint8, "pairs", "fp16", None, False, False)


@pytest.mark.parametrize("name,value", [("HDRTV_MEGAKERNEL", "0"), ("HDRTV_PAIRS_BOUNDARY", "0"),
                                        ("HDRTV_HG_TAIL", "0"), ("HDRTV_INT8_DOWN2", "1")])
def test_graph_signature_changes_with_each_switch(monkeypatch, name, value):
    from hdrtv_tpu_torch.runtime.engine import PER_CALL_SWITCHES, graph_signature

    for var, _ in PER_CALL_SWITCHES:
        monkeypatch.delenv(var, raising=False)
    base = graph_signature(*SIG_ARGS)
    monkeypatch.setenv(name, value)
    assert graph_signature(*SIG_ARGS) != base
    monkeypatch.setenv(name, "1" if value == "0" else "0")  # the default again, spelt out
    assert graph_signature(*SIG_ARGS) == base


@pytest.mark.parametrize("i,value", [(0, (1080, 5760)), (1, torch.int16), (2, "flat"), (3, "fp32"),
                                     (4, (960, 540)), (5, True), (6, True)])
def test_graph_signature_changes_with_each_argument(i, value):
    from hdrtv_tpu_torch.runtime.engine import graph_signature

    args = list(SIG_ARGS)
    args[i] = value
    assert graph_signature(*args) != graph_signature(*SIG_ARGS)


def test_graphs_replay_cuda_tensors_only():
    from hdrtv_tpu_torch.runtime.engine import GraphCache

    with pytest.raises(ValueError, match="CUDA"):
        GraphCache().run(("k",), lambda x: x, torch.zeros(4, dtype=torch.uint8))
