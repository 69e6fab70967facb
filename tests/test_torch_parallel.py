"""The port's mesh (``hdrtv_tpu_torch/parallel/``) against the JAX package's
(``hdrtv_tpu/parallel/``) and against its own single-device programs, on the
CPU.

A sharded run's shards are threads over a mesh of listed CPU devices
(``[torch.device("cpu")] * n``), the counterpart of the 8-device virtual CPU
mesh that ``tests/conftest.py`` gives the JAX package. The sharded frame
programs (fp32, bf16 with and without the megakernel program, int8 on the
W8A8 fixture, the HG composite; n = 2, 4 and 8 at 32 × 384, where some
stages take shifted windows and the deep ones the gather path) are held to
the port's single-device programs within 1 u16 code. They are run with
oneDNN off (``torch.backends.mkldnn``): oneDNN picks its convolution's
algorithm by the tensor's width, so a window and the whole frame sum a
pixel's products in different orders (4e-6 apart in fp32 at 8 columns,
``test_onednn_sums_depend_on_width``) and a bf16 rounding flips; PyTorch's
own convolution sums each pixel alike at any width. The JAX ``shard_map``
programs run as ``tests/test_parallel.py`` runs them (the lax program, and
the megakernel program with its kernels stubbed to their ``_ref``
oracles: interpret mode under a multi-device ``shard_map`` deadlocks).
"""

import contextlib
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
INT8 = os.path.join(ROOT, "tests", "fixtures", "hr_w8a8.npz")
CPU = torch.device("cpu")
H, W = 32, 384  # at n = 2 trunk3's windows fit (24 ≥ 2·10 columns at /8); at n = 4, 8 it gathers
CODES_JAX = 4  # u16 codes, the port's fp32 program against the JAX one (tests/test_torch_slice.py CODES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU programs on one intra-op thread: the suite runs in several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def cpu_mesh(n, data=1):
    from hdrtv_tpu_torch.parallel.mesh import make_mesh, spatial_mesh

    if data == 1:
        return spatial_mesh(n, devices=[CPU] * n)
    return make_mesh(n * data, devices=[CPU] * (n * data))


def _frame(h, w, seed=0):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# mesh.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
def test_factor2_and_mesh_shapes_match_jax(n):
    from hdrtv_tpu.parallel.mesh import _factor2 as jax_factor2
    from hdrtv_tpu_torch.parallel.mesh import _factor2, make_mesh, spatial_mesh

    assert _factor2(n) == jax_factor2(n)
    assert make_mesh(devices=[CPU] * n).shape == dict(zip(("data", "spatial"), jax_factor2(n)))
    assert spatial_mesh(devices=[CPU] * n).shape == {"data": 1, "spatial": n}


def test_default_mesh_needs_cuda(monkeypatch):
    """Without a card, a mesh must be given its devices: the default list is
    every visible CUDA device, and a CPU mesh is never chosen on its own."""
    from hdrtv_tpu_torch.parallel.mesh import make_mesh, spatial_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (make_mesh, spatial_mesh):
        with pytest.raises(RuntimeError, match="no.*CUDA|none is available"):
            fn()
    assert make_mesh(2, devices=[CPU] * 4).size == 2


def test_shardings_and_replicated_params():
    from hdrtv_tpu_torch.ops.w8a8 import QArgs
    from hdrtv_tpu_torch.parallel.mesh import flat_sharding, frame_sharding, replicate_params

    mesh = cpu_mesh(2, data=2)
    assert flat_sharding(mesh).spec == (None, "spatial")
    assert frame_sharding(mesh).spec == ("data", None, "spatial", None)
    assert frame_sharding(mesh, spatial=False).spec == ("data", None, None, None)
    qa = QArgs(torch.zeros(4, 9, dtype=torch.int8), torch.ones(4), torch.zeros(4), 0.5, None, 0)
    params = {"w": torch.ones(3), "q": qa, "t": (torch.zeros(2), torch.ones(1))}
    rep = replicate_params(params, mesh)
    assert list(rep) == [CPU]  # one copy per distinct device; its own device shares the tensors
    assert rep[CPU]["w"] is params["w"] and rep[CPU]["q"].w is qa.w and rep[CPU]["q"].scale == 0.5


# ---------------------------------------------------------------------------
# halo.py: the shifted windows against JAX's
# ---------------------------------------------------------------------------


PICKS = [
    (240, 1, 8, 2, None), (240, 2, 16, 2, None), (720, 24, 12, 12, None), (240, 4, 8, 2, 120),
    (120, 4, 8, 2, 60), (44, 4, 8, 2, 22), (60, 9, 8, 2, None), (16, 6, 16, 2, None), (15, 1, 1, 1, None),
    (30, 4, 2, 2, None), (1440, 24, 12, 12, None), (248, 2, 8, 2, None), (33, 2, 8, 2, None),
]


@pytest.mark.parametrize("w,need,mod,align,coarse_w", PICKS)
def test_pick_radius_matches_jax(w, need, mod, align, coarse_w):
    from hdrtv_tpu.parallel.halo import pick_radius as jax_pick
    from hdrtv_tpu_torch.parallel.halo import pick_radius

    kw = {"mod": mod, "align": align, "coarse_w": coarse_w}
    assert pick_radius(w, need, **kw) == jax_pick(w, need, **kw)


def _jax_sharded(local, n, in_specs, out_specs, *args):
    from hdrtv_tpu.parallel import halo as jax_halo
    from hdrtv_tpu.parallel.mesh import spatial_mesh as jax_spatial_mesh

    def body(*a):
        with jax_halo.manual_axis("spatial"):
            return local(*a)

    return np.asarray(jax.jit(jax_halo.make_shard_map(body, jax_spatial_mesh(n), in_specs, out_specs))(*args))


def _port_sharded(local, n, *full, axes):
    """Run ``local(*shards)`` on n CPU shards of ``full`` (split on ``axes``)
    and join the results on the first axis of ``axes``."""
    from hdrtv_tpu_torch.parallel import halo

    def split(x, ax):
        w = x.shape[ax] // n
        return [x.narrow(ax, k * w, w) for k in range(n)]

    parts = list(zip(*[split(x, ax) for x, ax in zip(full, axes)]))

    def body(k, *xs):
        with halo.manual_axis("spatial"):
            return local(*xs)

    outs = halo.run_sharded(body, parts, [CPU] * n)
    return torch.cat(outs, dim=axes[0])


def test_ext_windows_and_crop_match_jax(cpu_devices):
    """Each shard's shifted window of radius r is JAX's, column for column
    (edge shards borrowing their whole margin from one side), and ext → a
    3×3 conv → crop is the whole frame's conv, bit for bit."""
    from jax.sharding import PartitionSpec as P

    from hdrtv_tpu.parallel import halo as jax_halo
    from hdrtv_tpu_torch.parallel import halo

    x = np.random.RandomState(3).rand(1, 4, 256, 8).astype(np.float32)
    spec = P(None, None, "spatial", None)
    for n, r in ((8, 2), (4, 6), (2, 64)):
        want = _jax_sharded(lambda v: jax_halo.ext(v, r, 2), n, spec, spec, jnp.asarray(x))
        got = _port_sharded(lambda v: halo.ext(v, r, 2), n, torch.from_numpy(x), axes=(2,))
        np.testing.assert_array_equal(got.numpy(), want)
    w = torch.from_numpy(np.random.RandomState(4).rand(8, 8, 3, 3).astype(np.float32) - 0.5)

    def conv(v):
        return torch.nn.functional.conv2d(v.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)

    xt = torch.from_numpy(x)
    with no_onednn():
        ref = conv(xt)
        got = _port_sharded(lambda v: halo.crop(conv(halo.ext(v, 2, 2)), 2, 2), 8, xt, axes=(2,))
    assert torch.equal(got, ref)
    # ext → crop is the identity on the canonical shards
    got = _port_sharded(lambda v: halo.crop(halo.ext(v, 4, 2), 4, 2), 4, xt, axes=(2,))
    assert torch.equal(got, xt)


@pytest.mark.parametrize("case", ["coarse_first", "wide", "gather", "stride2", "upscale"])
def test_run_stage_matches_jax(case, cpu_devices):
    """run_stage's radius, windows and crop against JAX's on the same stage:
    the coarse companion passed first (``coarse_conv``: both extended widths
    multiples of 8, the radius measured on the fine input), a wide stage, a
    stage whose shards are narrower than 2r (gather → replicated → slice),
    a stride-2 stage and a ×2 upscaling one."""
    from jax.sharding import PartitionSpec as P

    from hdrtv_tpu.parallel import halo as jax_halo
    from hdrtv_tpu_torch.parallel import halo

    rng = np.random.RandomState(7)
    fine = rng.rand(1, 8, 88, 4).astype(np.float32)
    coarse = rng.rand(1, 8, 44, 4).astype(np.float32)
    spec = P(None, None, "spatial", None)
    seen = {}

    def shapes_and(fn, lib):
        def stage(*xs):
            seen.setdefault(lib, set()).add(tuple(tuple(x.shape) for x in xs))
            return fn(*xs)
        return stage

    def mix(f, c, lib):  # a fine output reading both inputs at every column
        if lib == "jax":
            return f * 2.0 + jnp.repeat(c, 2, axis=2)
        return f * 2.0 + torch.repeat_interleave(c, 2, dim=2)

    if case == "coarse_first":
        n, kw = 2, dict(need=4, mod=8, out_axis=2, coarse_idx=(0,), coarse_conv=True)
        ins, axes = (coarse, fine), (2, 2)

        def fn(c, f, lib):
            return mix(f, c, lib)
    else:
        n = 8 if case == "gather" else 2
        kw = {"wide": dict(need=2, mod=8, out_axis=2), "gather": dict(need=9, mod=8, out_axis=2),
              "stride2": dict(need=2, mod=16, out_axis=2, out_stride=2),
              "upscale": dict(need=1, mod=1, align=1, out_axis=2, out_upscale=2)}[case]
        ins, axes = (fine,), (2,)

        def fn(f, lib):
            if case == "stride2":
                return f[:, :, ::2] + f[:, :, 1::2]
            if case == "upscale":
                return jnp.repeat(f, 2, axis=2) if lib == "jax" else torch.repeat_interleave(f, 2, dim=2)
            return f + 1.0

    want = _jax_sharded(
        lambda *a: jax_halo.run_stage(shapes_and(lambda *x: fn(*x, "jax"), "jax"), list(a), list(axes), **kw),
        n, (spec,) * len(ins), spec, *[jnp.asarray(a) for a in ins])
    got = _port_sharded(
        lambda *a: halo.run_stage(shapes_and(lambda *x: fn(*x, "torch"), "torch"), list(a), list(axes), **kw),
        n, *[torch.from_numpy(a) for a in ins], axes=axes)
    np.testing.assert_array_equal(got.numpy(), want)
    assert seen["torch"] == seen["jax"]
    if case == "coarse_first":
        (cs, fs), = seen["torch"]
        assert cs[2] % 8 == 0 and cs[2] > 22 and fs[2] % 8 == 0 and fs[2] > 44


def test_a_failing_shard_raises_in_every_shard():
    """A shard that raises breaks the barrier: the others, waiting in an
    exchange, raise too, and the run raises the first shard's own error."""
    from hdrtv_tpu_torch.parallel import halo

    def body(k, x):
        if k == 2:
            raise KeyError("shard two")
        with halo.manual_axis("spatial"):
            return halo.ext(x, 1, 0)

    with pytest.raises(KeyError, match="shard two"):
        halo.run_sharded(body, [(torch.zeros(4),)] * 4, [CPU] * 4)
    assert not [t for t in threading.enumerate() if t.name.startswith("shard")]


def test_onednn_sums_depend_on_width():
    """Why the sharded programs run without oneDNN here: its fp32 3×3 conv
    of an 8-column window and of the 64-column frame sum the shared interior
    columns apart; PyTorch's own conv sums them alike."""
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 128, 4, 64).astype(np.float32))
    w = torch.from_numpy(np.random.RandomState(1).randn(128, 128, 3, 3).astype(np.float32) * 0.05)
    apart = {}
    for on in (True, False):
        with torch.backends.mkldnn.flags(enabled=on):
            y = torch.nn.functional.conv2d(x, w, padding=1)
            yw = torch.nn.functional.conv2d(x[..., 16:24].contiguous(), w, padding=1)
        apart[on] = float((y[..., 17:23] - yw[..., 1:-1]).abs().max())
    assert apart[False] == 0.0
    if torch.backends.mkldnn.is_available():
        assert apart[True] > 0.0


# ---------------------------------------------------------------------------
# The sharded frame programs against the port's single-device ones
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hg_composite(tmp_path_factory):
    from hdrtv_tpu_torch.tools.synth_hg import write_synth_hg

    d = tmp_path_factory.mktemp("hg")
    return {"float": write_synth_hg(str(d / "hg8.npz"), nf=8, seed=3),
            "int8": write_synth_hg(str(d / "hg8_int8.npz"), nf=8, seed=3, base_path=INT8)}


PROGRAMS = {
    "fp32": (WEIGHTS, "fp32", {}),
    "bf16_mega": (WEIGHTS, "fp16", {}),
    "bf16_nomega": (WEIGHTS, "fp16", {"HDRTV_MEGAKERNEL": "0"}),
    "int8_bf16": (INT8, "fp16", {}),
    "int8_fp32": (INT8, "fp32", {}),
    "hg_bf16": ("float", "fp16", {}),
    "hg_fp32": ("float", "fp32", {}),
    "hg_int8": ("int8", "fp16", {}),
}


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("program", list(PROGRAMS))
def test_sharded_program_matches_single_device(program, n, hg_composite, monkeypatch):
    """``HDRTVNetTorch(mesh=spatial_mesh(n))`` against the same processor
    without a mesh, within 1 u16 code (each stage on its window sums each
    pixel as the whole frame does: bit-equal in every case run here)."""
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    path, precision, env = PROGRAMS[program]
    path = hg_composite.get(path, path)
    h, w = (64, 512) if program.startswith(("hg", "int8")) else (H, W)  # with HG or int8 layers: W % (32·n)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    frame = _frame(h, w, seed=n)
    with no_onednn():
        single = HDRTVNetTorch(path, precision=precision, device="cpu", persistent_cache=False)
        sharded = HDRTVNetTorch(path, precision=precision, device="cpu", persistent_cache=False,
                                mesh=cpu_mesh(n))
        assert sharded._program(torch.from_numpy(frame.reshape(h, 3 * w))) == "mesh"
        assert sharded.native_int8 == ("int8" in program) and sharded.cfg.use_hg == program.startswith("hg")
        ref, out = single.process_rgb48(frame), sharded.process_rgb48(frame)
    assert out.shape == ref.shape == (h, w, 3) and out.dtype == np.uint16
    d = np.abs(out.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= 1, f"{program} n={n}: {int(d.max())} codes on {int((d > 0).sum())} values"


def test_windows_keep_the_kernels_widths(monkeypatch):
    """Every 128-channel conv inside a shard's windows (the merged ones
    included) sees an extended width that is a multiple of 8, so each shard
    routes its convs as the single-device program does (JAX's
    ``test_merged_windows_keep_fused_conv_eligibility``)."""
    from hdrtv_tpu_torch.models import s2d
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    seen, bad = [0], []
    orig = s2d._use_fused_kernel

    def spy(x, w):
        if w.shape[2] % 128 == 0 and w.shape[3] % 128 == 0 and x.shape[0] == 1:
            seen[0] += 1
            if x.shape[2] % 8:
                bad.append((tuple(x.shape), tuple(w.shape)))
        return orig(x, w)

    monkeypatch.setattr(s2d, "_use_fused_kernel", spy)
    proc = HDRTVNetTorch(WEIGHTS, precision="fp16", device="cpu", persistent_cache=False, mesh=cpu_mesh(8))
    with no_onednn():
        proc.process_rgb48(_frame(64, 1024))
    assert seen[0] > 0 and not bad


# ---------------------------------------------------------------------------
# The sharded programs against JAX's shard_map programs
# ---------------------------------------------------------------------------


def _jax_flat_shard_map(params, cfg, policy, n, flat):
    from jax.sharding import PartitionSpec as P

    from hdrtv_tpu.models.s2d import ensemble_s2d_rgb48_flat as jax_flat
    from hdrtv_tpu.parallel.mesh import replicate_params as jax_replicate
    from hdrtv_tpu.parallel.mesh import spatial_mesh as jax_spatial_mesh

    mesh = jax_spatial_mesh(n)
    return _jax_sharded(lambda p, f: jax_flat(p, f, None, cfg, policy=policy, bgr=True), n,
                        (P(), P(None, "spatial")), P(None, "spatial"), jax_replicate(params, mesh), flat)


def _port_flat_sharded(params, cfg, policy, n, flat):
    """The port's sharded body as the JAX one: the flat program with its
    condition image computed on each shard's halo window."""
    from hdrtv_tpu_torch.models.s2d import ensemble_s2d_rgb48_flat

    with torch.inference_mode(), policy.math(), no_onednn():
        return _port_sharded(lambda f: ensemble_s2d_rgb48_flat(params, f, None, cfg, policy=policy, bgr=True),
                             n, flat, axes=(1,)).numpy()


def test_sharded_lax_program_matches_jax(cpu_devices):
    """JAX's ``TestShardMapTurbo`` size (64 × 1024 over 8 shards: the head,
    tail and resblocks on windows, trunk3 gathering): the port's sharded
    fp32 program within CODES_JAX of JAX's ``shard_map`` program, and of
    the port's single-device frame within 1 code."""
    from hdrtv_tpu.models.import_torch import load_npz as jax_load_npz
    from hdrtv_tpu.models.layers import F32 as JAX_F32
    from hdrtv_tpu.models.s2d import s2d_transform_params as jax_transform
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig
    from hdrtv_tpu_torch.models.layers import F32
    from hdrtv_tpu_torch.models.s2d import ensemble_s2d_rgb48_flat, params_to_torch, s2d_transform_params
    from hdrtv_tpu_torch.models.import_npz import load_npz

    from hdrtv_tpu.models.hdrtvnet import ModelConfig as JaxConfig

    flat = (np.random.RandomState(0).rand(64, 1024 * 3) * 255).astype(np.uint8)
    jp = {k: jnp.asarray(v) for k, v in jax_transform(jax_load_npz(WEIGHTS)).items()}
    want = _jax_flat_shard_map(jp, JaxConfig(), JAX_F32, 8, jnp.asarray(flat))
    p = params_to_torch(s2d_transform_params(load_npz(WEIGHTS)), "cpu", F32)
    got = _port_flat_sharded(p, ModelConfig(), F32, 8, torch.from_numpy(flat))
    with torch.inference_mode(), F32.math(), no_onednn():
        single = ensemble_s2d_rgb48_flat(p, torch.from_numpy(flat), None, ModelConfig(), policy=F32, bgr=True).numpy()
    assert np.abs(got.astype(np.int64) - single.astype(np.int64)).max() <= 1
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= CODES_JAX


def test_sharded_megakernel_program_matches_jax(cpu_devices, monkeypatch):
    """JAX's ``TestShardMapMegaGeometry`` size (64 × 1024 over 8 shards, the
    megakernel program with its two merged L0 windows) in fp32: the JAX
    program with its megakernels stubbed to their ``_ref`` oracles
    (``tests/test_parallel.py``'s stubs), the port's on its kernels' plain
    versions (its ``_mega_ok`` opened to fp32 as JAX's interpret switch
    opens its own), within CODES_JAX; and the port's sharded frame within
    1 code of its single-device one."""
    from hdrtv_tpu.models.hdrtvnet import ModelConfig as JaxConfig
    from hdrtv_tpu.models.import_torch import load_npz as jax_load_npz
    from hdrtv_tpu.models.layers import F32 as JAX_F32
    from hdrtv_tpu.models.s2d import _mega_ok as jax_mega_ok
    from hdrtv_tpu.models.s2d import s2d_transform_params as jax_transform
    from hdrtv_tpu_torch.models import s2d as port_s2d
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig
    from hdrtv_tpu_torch.models.import_npz import load_npz
    from hdrtv_tpu_torch.models.layers import BF16, F32
    from tests.test_parallel import TestShardMapMegaGeometry

    TestShardMapMegaGeometry()._patch_kernels(monkeypatch)
    h, w = 64, 1024
    jp = {k: jnp.asarray(v) for k, v in jax_transform(jax_load_npz(WEIGHTS)).items()}
    assert jax_mega_ok(jp, (1, h // 2, w // 2, 12), JAX_F32)
    flat = (np.random.RandomState(0).rand(h, w * 3) * 255).astype(np.uint8)
    want = _jax_flat_shard_map(jp, JaxConfig(), JAX_F32, 8, jnp.asarray(flat))

    orig = port_s2d._mega_ok
    monkeypatch.setattr(port_s2d, "_mega_ok", lambda p, shape, policy: orig(p, shape, BF16))
    p = port_s2d.params_to_torch(port_s2d.s2d_transform_params(load_npz(WEIGHTS)), "cpu", F32)
    calls = []
    head = port_s2d.fused_agcm_head
    monkeypatch.setattr(port_s2d, "fused_agcm_head", lambda *a, **k: (calls.append(a[0].shape), head(*a, **k))[1])
    got = _port_flat_sharded(p, ModelConfig(), F32, 8, torch.from_numpy(flat))
    assert calls and all(s[2] % 8 == 0 and s[2] > w // 16 for s in calls)  # the head on its windows
    with torch.inference_mode(), F32.math(), no_onednn():
        single = port_s2d.ensemble_s2d_rgb48_flat(p, torch.from_numpy(flat), None, ModelConfig(), policy=F32,
                                                  bgr=True).numpy()
    assert np.abs(got.astype(np.int64) - single.astype(np.int64)).max() <= 1
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= CODES_JAX


# ---------------------------------------------------------------------------
# The runtime: refusals, data parallelism
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["width", "hg_width", "int8_width", "height", "switch", "natural"])
def test_mesh_refusals_raise_value_error(case, hg_composite, monkeypatch):
    """Where the JAX runtime falls back to its GSPMD-partitioned lax program
    (``_mesh_manual_ok`` false), the port has no partitioner and raises
    ``ValueError`` naming the failed condition; so does a size the sharded
    program cannot take at all."""
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    path = {"hg_width": hg_composite["float"], "int8_width": INT8}.get(case, WEIGHTS)
    h, w, match = {
        "width": (32, 16 * 4 * 3 + 32, "multiple of 16 × 4"),
        "hg_width": (32, 16 * 4 * 5, "multiple of 32 × 4"),
        "int8_width": (32, 16 * 4 * 5, "native int8 layers the width 320 must be a multiple of 32 × 4"),
        "height": (36, 256, "W divisible by 8"),
        "switch": (32, 256, "HDRTV_MESH_SHARD_MAP=0"),
        "natural": (32, 256, "turbo"),
    }[case]
    if case == "switch":
        monkeypatch.setenv("HDRTV_MESH_SHARD_MAP", "0")
    proc = HDRTVNetTorch(path, device="cpu", persistent_cache=False, mesh=cpu_mesh(4),
                         turbo=case != "natural")
    assert not proc._mesh_manual_ok(h, 3 * w) or case == "height"
    with pytest.raises(ValueError, match=match):
        proc.process_rgb48(_frame(h, w))


@pytest.mark.parametrize("n_frames,grid", [(3, False), (4, False), (5, True)])
def test_batch_data_parallel_pads_and_trims(n_frames, grid, monkeypatch):
    """``process_rgb48_batch(mesh=)`` splits the batch over the data axis,
    padding it with repeats of the last frame (never running it unsplit)
    and trimming after: each frame equal to ``process_rgb48``'s, and the
    padded frames run, on the data rows' threads."""
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    proc = HDRTVNetTorch(WEIGHTS, device="cpu", persistent_cache=False)
    frames = np.stack([_frame(32, 64, seed=s) for s in range(n_frames)])
    from hdrtv_tpu_torch.parallel.mesh import Mesh

    mesh = cpu_mesh(2, data=2) if grid else Mesh([[CPU], [CPU]])
    assert mesh.shape == {"data": 2, "spatial": 2 if grid else 1}
    runs, orig = [], proc._run_flat
    monkeypatch.setattr(proc, "_run_flat", lambda *a, **k: (runs.append(threading.current_thread().name),
                                                           orig(*a, **k))[1])
    out = proc.process_rgb48_batch(frames, mesh=mesh)
    assert out.shape == (n_frames, 32, 64, 3) and out.dtype == np.uint16
    assert len(runs) == n_frames + (-n_frames) % 2 and set(runs) == {"shard0", "shard1"}
    monkeypatch.setattr(proc, "_run_flat", orig)
    for i in range(n_frames):
        np.testing.assert_array_equal(out[i], proc.process_rgb48(frames[i]))


# ---------------------------------------------------------------------------
# multihost.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_frames,hosts", [(10, 3), (3, 4), (0, 2), (120, 8), (7, 1)])
def test_frame_ranges_and_segments_match_jax(n_frames, hosts, tmp_path):
    from hdrtv_tpu.parallel import multihost as jax_mh
    from hdrtv_tpu_torch.parallel import multihost

    ranges = multihost.plan_frame_ranges(n_frames, hosts)
    assert ranges == jax_mh.plan_frame_ranges(n_frames, hosts)
    assert ranges[0][0] == 0 and ranges[-1][1] == n_frames
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert max(e - s for s, e in ranges) - min(e - s for s, e in ranges) <= 1
    out = str(tmp_path / "it's.mov")
    segs = multihost.segment_paths(out, hosts)
    assert segs == jax_mh.segment_paths(out, hosts)
    cmd = multihost.concat_command(segs, out, str(tmp_path / "a.txt"))
    want = jax_mh.concat_command(segs, out, str(tmp_path / "b.txt"))
    assert cmd[:-4] == want[:-4] and cmd[-3:] == want[-3:]
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    with pytest.raises(ValueError):
        multihost.plan_frame_ranges(4, 0)


def test_initialize_distributed_single_host_noop(monkeypatch):
    """No coordinator and no process count: False, no process group."""
    import torch.distributed as dist

    from hdrtv_tpu_torch.parallel.multihost import initialize_distributed

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is False
    assert not dist.is_initialized()
