"""The port's export path and writers on the CPU against hdrtv_tpu: the
Y4M writer and reader, ``FileSink``, ``Y4MFileSink`` and the raw writer
(byte-equal files and sidecars for the same u16 input),
``ffmpeg_hdr10_command`` (equal lists), and ``export_video`` (raw and y4m)
through ``HDRTVNetTorch(device="cpu")`` against the JAX export through
``HDRTVNetTPU``, plus the export's contract with fakes: the writer sized from
the first processed frame, batches, the finalize error order, the warm-up's
frame signature, and what is not ported yet raising.

Tolerances: writers, sinks and commands equal byte for byte. Whole exports:
the same frame count; raw frames within CODES u16 codes in fp32 (the 5e-5
golden tolerance × 65535, rounded up, as ``tests/test_torch_slice.py``) and
BF16_CODES in bf16 (3e-2 of full scale, the bound of
``tests/test_torch_runtime.py`` against ``HDRTVNetTPU(precision="fp16")``);
y4m planes (10-bit, limited range: one 10-bit code ≈ 75 u16 codes) within
Y4M_CODES_FP32 = 1 and Y4M_CODES_BF16 = BF16_CODES // 64 + 1 codes.
"""

import json
import os

import numpy as np
import pytest
import torch

from hdrtv_tpu.bench import y4m as jax_y4m
from hdrtv_tpu.pipeline import export as jax_export
from hdrtv_tpu.pipeline import sinks as jax_sinks
from hdrtv_tpu_torch.bench import y4m
from hdrtv_tpu_torch.pipeline import export, sinks
from hdrtv_tpu_torch.pipeline.source import SyntheticSource

ROOT = os.path.join(os.path.dirname(__file__), "..")
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
CODES = 4
BF16_CODES = int(3e-2 * 65535)
Y4M_CODES_FP32 = 1
Y4M_CODES_BF16 = BF16_CODES // 64 + 1


def _rgb48(n, h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 65536, (n, h, w, 3)).astype(np.uint16)


def _files(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU programs on one intra-op thread: the suite runs in several
    worker processes at once, and torch's thread pools, one a core in each,
    slow every one of them down many times over when they share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Writers, sinks and commands: byte-equal to the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ctag,matrix", [("422p10", "bt2020nc"), ("444p12", "bt709"), ("420", "bt601")])
def test_y4m_writer_and_reader_match_jax(tmp_path, ctag, matrix):
    frames = _rgb48(3, 16, 24, seed=len(ctag))
    paths = {}
    for name, mod in (("port", y4m), ("jax", jax_y4m)):
        paths[name] = str(tmp_path / f"{name}.y4m")
        w = mod.Y4MWriter(paths[name], 24, 16, fps=24000 / 1001, ctag=ctag)
        for f in frames:
            w.write_rgb_unit(f.astype(np.float32) / 65535.0, matrix=matrix)
        w.close()
    assert _files(paths["port"]) == _files(paths["jax"])
    assert y4m.probe_y4m(paths["port"]) == jax_y4m.probe_y4m(paths["jax"])
    with y4m.Y4MReader(paths["port"]) as a, jax_y4m.Y4MReader(paths["jax"]) as b:
        assert a.frame_count == b.frame_count == 3
        for i in range(3):
            assert np.array_equal(a.read_rgb_unit(i, matrix=matrix), b.read_rgb_unit(i, matrix=matrix))


def test_file_sinks_match_jax(tmp_path):
    """FileSink and Y4MFileSink (flat (H, 3W) rows, as the runner delivers
    them): the same files and sidecar."""
    frames = _rgb48(3, 16, 24, seed=1)
    for ext, cls_port, cls_jax in ((".rgb48", sinks.FileSink, jax_sinks.FileSink),
                                   (".y4m", sinks.Y4MFileSink, jax_sinks.Y4MFileSink)):
        got = {}
        for name, cls in (("port", cls_port), ("jax", cls_jax)):
            path = str(tmp_path / f"{name}{ext}")
            sink = cls(path)
            for f in frames:
                sink.show(f.reshape(16, 72), 0.0)
            sink.close()
            assert sink.frames == 3
            got[name] = _files(path)
            if ext == ".y4m":
                with open(path + ".json") as f:
                    side = json.load(f)
                got[name + "_side"] = json.dumps(side).replace(str(tmp_path), "T").replace(name, "X")
        assert got["port"] == got["jax"] and got.get("port_side") == got.get("jax_side")


def test_raw_and_y4m_writers_match_jax(tmp_path):
    frames = _rgb48(2, 16, 24, seed=2)
    for cls in ("_RawWriter", "_Y4MWriter"):
        got = {}
        for name, mod in (("port", export), ("jax", jax_export)):
            out = str(tmp_path / f"{cls}_{name}.mov")
            wr = getattr(mod, cls)(mod.ExportConfig(output=out), 24, 16, 25.0)
            for f in frames:
                wr.write(f)
            wr.close()
            with open(wr.path + ".json") as f:
                got[name + "_side"] = json.dumps(json.load(f)).replace(str(tmp_path), "T").replace(f"{cls}_{name}", "X")
            got[name] = _files(wr.path)
        assert got["port"] == got["jax"] and got["port_side"] == got["jax_side"]


@pytest.mark.parametrize("codec,audio", [("prores", None), ("hevc", None), ("prores", "a.wav"), ("raw", "a.wav")])
def test_ffmpeg_command_matches_jax(codec, audio):
    kw = dict(codec=codec, peak_nits=1000, audio_source=audio)
    assert export.ffmpeg_hdr10_command(1920, 1080, 23.976, "o.mov", **kw) == \
        jax_export.ffmpeg_hdr10_command(1920, 1080, 23.976, "o.mov", **kw)


# ---------------------------------------------------------------------------
# export_video's contract (fakes returning torch tensors)
# ---------------------------------------------------------------------------


class FakeProcessor:
    """put_frame / process_rgb48_device as HDRTVNetTorch on the CPU: u16 ×
    257; records the shapes process_rgb48_device sees."""

    device = torch.device("cpu")

    def __init__(self):
        self.seen = []

    def warmup_compile(self, w, h, **kw):
        self.process_rgb48_device(self.put_frame(np.zeros((h, 3 * w), np.uint8)))
        return 0.0

    def put_frame(self, flat):
        h, w = flat.shape[0], flat.shape[1] // 3
        return torch.from_numpy(np.ascontiguousarray(flat).reshape(h // 2, 2, w // 2, 6))

    def process_rgb48_device(self, x):
        self.seen.append(tuple(x.shape))
        return x.to(torch.int32).mul(257).to(torch.uint16)

    def process_rgb48_batch(self, frames, *, mesh=None):
        return np.asarray(frames, dtype=np.uint16) * 257


def _want(n, h, w):
    src = SyntheticSource(w, h, fps=24, frames=n)
    return np.stack([src.read_with_meta()[0].astype(np.uint16) * 257 for _ in range(n)])


def test_export_raw_with_sidecar_and_warmup_signature(tmp_path):
    """No ffmpeg: the prores request falls back to raw + sidecar. Every frame
    (pair planes from put_frame, written as (H, W, 3)) is exact, and the
    warm-up ran the very signature the frames run."""
    proc = FakeProcessor()
    cfg = export.ExportConfig(output=str(tmp_path / "master.mov"), codec="prores")
    stats = export.export_video(None, proc, cfg, source=SyntheticSource(64, 32, fps=24, frames=5))
    assert stats["frames"] == 5 and stats["codec"] in ("raw", "prores")
    if stats["codec"] == "raw":
        data = np.fromfile(stats["output"], np.uint16).reshape(5, 32, 64, 3)
        assert np.array_equal(data, _want(5, 32, 64))
        with open(stats["output"] + ".json") as f:
            side = json.load(f)
        assert (side["width"], side["height"]) == (64, 32) and "zscale" in side["containerize_with"]
    assert len(proc.seen) == 6 and set(proc.seen) == {(16, 2, 32, 6)}


def test_export_batches_match_single(tmp_path):
    for batch in (1, 4):
        export.export_video(None, FakeProcessor(), export.ExportConfig(output=str(tmp_path / f"b{batch}.rgb48"),
                                                                       codec="raw", batch=batch),
                            source=SyntheticSource(64, 32, fps=24, frames=10))
    a, b = (np.fromfile(tmp_path / f"b{n}.rgb48", np.uint16) for n in (1, 4))
    assert np.array_equal(a, b) and np.array_equal(a.reshape(10, 32, 64, 3), _want(10, 32, 64))


def test_export_writer_sized_from_processed_frame(tmp_path):
    class Upscaling(FakeProcessor):
        def process_rgb48_device(self, x):
            return torch.full((64, 96 * 3), int(x.max()), dtype=torch.uint16)

    stats = export.export_video(None, Upscaling(), export.ExportConfig(output=str(tmp_path / "m.mov"), codec="raw"),
                                source=SyntheticSource(48, 24, fps=24, frames=2))
    assert os.path.getsize(stats["output"]) == 2 * 96 * 64 * 3 * 2
    with open(stats["output"] + ".json") as f:
        assert (lambda sc: (sc["width"], sc["height"]))(json.load(f)) == (96, 64)


def test_export_write_failure_raises_root_cause_and_closes_source(tmp_path):
    src = SyntheticSource(64, 32, fps=24, frames=6)
    closed = []
    orig = src.close
    src.close = lambda: (closed.append(True), orig())[1]
    cfg = export.ExportConfig(output=str(tmp_path / "nope" / "master.mov"), codec="raw", queue_depth=1)
    with pytest.raises(FileNotFoundError):
        export.export_video(None, FakeProcessor(), cfg, source=src)
    assert closed


def test_export_zero_frames_still_writes_the_container(tmp_path):
    stats = export.export_video(None, FakeProcessor(), export.ExportConfig(output=str(tmp_path / "z.y4m"), codec="y4m"),
                                source=SyntheticSource(64, 32, fps=24, frames=0))
    assert stats["frames"] == 0 and os.path.isfile(stats["output"]) and os.path.isfile(stats["output"] + ".json")


class MeshFakeProcessor(FakeProcessor):
    """FakeProcessor recording the mesh each batch is given."""

    def __init__(self):
        super().__init__()
        self.meshes = []

    def process_rgb48_batch(self, frames, *, mesh=None):
        self.meshes.append(None if mesh is None else mesh.shape)
        return super().process_rgb48_batch(frames, mesh=mesh)


def test_export_mesh_and_farm_raise_not_ported(tmp_path):
    """``use_mesh`` with ``batch > 1`` hands each full batch a mesh of the
    processor's device (data axis 1 on the CPU) and the last partial one
    none, as the JAX export does; the farm's hosts (host 1, then host 0,
    which waits for every ``.done`` marker) write their frame ranges, and
    host 0's raw master is the single-host export's, byte for byte, its
    sidecar naming the joined file. The JAX farm's master on the same frames
    is the same bytes."""
    n = 5
    cfg = export.ExportConfig(output=str(tmp_path / "m.mov"), codec="raw", batch=2, use_mesh=True)
    proc = MeshFakeProcessor()
    stats = export.export_video(None, proc, cfg, source=SyntheticSource(64, 32, fps=24, frames=n))
    assert stats["frames"] == n and proc.meshes == [{"data": 1, "spatial": 1}] * 2 + [None]
    single = np.fromfile(stats["output"], np.uint16)
    np.testing.assert_array_equal(single.reshape(n, 32, 64, 3), _want(n, 32, 64))
    farm = export.ExportConfig(output=str(tmp_path / "farm.mov"), codec="raw")
    for host in (1, 0):
        st = export.export_video_multihost(None, FakeProcessor(), farm, hosts=2, host_id=host,
                                           source=SyntheticSource(64, 32, fps=24, frames=n))
        assert st["frame_range"] == [[0, 3], [3, 5]][host]
    assert st["concatenated"] and st["output"].endswith("farm.mov.rgb48")
    assert open(st["output"], "rb").read() == single.tobytes()
    with open(st["output"] + ".json") as f:
        assert st["output"] in json.load(f)["containerize_with"]
    # (the JAX export's per-frame path hands the processor jax arrays: its batch path takes numpy)
    jax_farm = jax_export.ExportConfig(output=str(tmp_path / "jax.mov"), codec="raw", batch=2)
    for host in (1, 0):
        jst = jax_export.export_video_multihost(None, FakeProcessor(), jax_farm, hosts=2, host_id=host,
                                                source=SyntheticSource(64, 32, fps=24, frames=n))
    assert open(jst["output"], "rb").read() == single.tobytes()


# ---------------------------------------------------------------------------
# export_video through HDRTVNetTorch(device="cpu") against the JAX export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["fp32", "fp16"], ids=["fp32", "bf16"])
def test_export_matches_jax(tmp_path, precision):
    """Six synthetic 64 × 96 frames, raw and y4m, through each package's
    export_video: the same frame count and header, frames within the
    bounds above; the port's raw frames equal its own process_rgb48."""
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    n, h, w = 6, 64, 96
    procs = {"port": (export, HDRTVNetTorch(WEIGHTS, precision=precision, device="cpu", persistent_cache=False)),
             "jax": (jax_export, HDRTVNetTPU(WEIGHTS, precision=precision, persistent_cache=False))}
    raw, planes = {}, {}
    for name, (mod, proc) in procs.items():
        for codec in ("raw", "y4m"):
            cfg = mod.ExportConfig(output=str(tmp_path / f"{name}.mov"), codec=codec)
            stats = mod.export_video(None, proc, cfg, source=SyntheticSource(w, h, fps=30, frames=n))
            assert stats["frames"] == n and stats["codec"] == codec
            if codec == "raw":
                raw[name] = np.fromfile(stats["output"], np.uint16).reshape(n, h, w, 3)
            else:
                with y4m.Y4MReader(stats["output"]) as rd:
                    assert (rd.frame_count, rd.fmt.ctag, rd.fmt.width, rd.fmt.height) == (n, "422p10", w, h)
                    planes[name] = [np.stack([p.astype(np.int64) for p in rd.read_planes(i)[:1]]) for i in range(n)]
                    planes[name + "_c"] = [np.stack([p.astype(np.int64) for p in rd.read_planes(i)[1:]])
                                           for i in range(n)]
    src = SyntheticSource(w, h, fps=30, frames=n)
    assert np.array_equal(raw["port"], np.stack([procs["port"][1].process_rgb48(src.read_with_meta()[0])
                                                 for _ in range(n)]))
    bound = CODES if precision == "fp32" else BF16_CODES
    assert np.abs(raw["port"].astype(np.int64) - raw["jax"].astype(np.int64)).max() <= bound
    y_bound = Y4M_CODES_FP32 if precision == "fp32" else Y4M_CODES_BF16
    for key in ("port", "port_c"):
        other = key.replace("port", "jax")
        assert max(int(np.abs(a - b).max()) for a, b in zip(planes[key], planes[other])) <= y_bound


def test_export_warmup_captures_the_frames_signature(tmp_path, monkeypatch):
    """The warm-up's frame has the CUDA-graph signature of every frame the
    export then sends (pair planes at 64 × 96, flat rows at the natural
    540p-like 60 × 96): on a card the first real frame replays."""
    from hdrtv_tpu_torch.runtime import engine
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    for h, w, layout in ((64, 96, 4), (60, 96, 2)):
        proc = HDRTVNetTorch(WEIGHTS, precision="fp16", device="cpu", persistent_cache=False)
        keys = []
        run = proc.process_rgb48_device

        def spy(x, _proc=proc, _run=run):
            keys.append(engine.graph_signature(x.shape, x.dtype, _proc._program(x), _proc.precision,
                                               _proc.proc_resolution, False, False))
            return _run(x)

        monkeypatch.setattr(proc, "process_rgb48_device", spy)
        cfg = export.ExportConfig(output=str(tmp_path / f"w{h}.rgb48"), codec="raw")
        assert export.export_video(None, proc, cfg, source=SyntheticSource(w, h, fps=30, frames=2))["frames"] == 2
        assert len(keys) == 3 and len(set(keys)) == 1 and len(keys[0][0]) == layout
