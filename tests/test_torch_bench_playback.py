"""The port's playback benchmark, its supervised wrapper and its runtime check
on the CPU, held against ``hdrtv_tpu``: the session layout (file names,
``session.json`` keys, ``summary.txt`` lines, the runtime-metrics CSV header
and sample rows) and the batch CSVs from the same configurations through
fakes in both packages, ``write_session`` byte for byte, ``LoopingSource``,
``run_device_resident``'s chain through a torch fake (each input the base
frame OR'd with a one-bit token of the previous output), the wrapper's
budget killing a child that prints nothing (the JAX wrapper checks its
budget only when a line arrives), its streaming, lock and result table, and
the doctor without a card (``ok`` false with the issue named, nothing run
on the CPU in the card's place)."""

import csv
import dataclasses
import json
import os
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdrtv_tpu.bench import playback as jp
from hdrtv_tpu.bench import wrapper as jw
from hdrtv_tpu_torch.bench import playback as tp
from hdrtv_tpu_torch.bench import wrapper as tw


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU programs on one intra-op thread: the suite runs in several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small(monkeypatch, tmp_path):
    """Both packages' 540p preset cut to 96 × 64, the playback lock in
    tmp_path."""
    from hdrtv_tpu import config as jc
    from hdrtv_tpu_torch import config as tc

    for cfg in (jc, tc):
        monkeypatch.setitem(cfg.RESOLUTION_SCALES, "540p", (96, 64))
    monkeypatch.setenv("HDRTVNET_CACHE_DIR", str(tmp_path / "cache"))
    return tmp_path


class JaxFake:
    """The JAX package's fake processor (``tests/test_bench.py``)."""

    model_path = ""

    def warmup_compile(self, w, h, **kw):
        return 0.0

    def process_rgb48_device(self, frame):
        return frame.astype(jnp.uint16) * 257


class TorchFake:
    """HDRTVNetTorch's frame contract on the CPU: (H, 3W) u8 in, u16 × 257
    out; keeps its inputs and outputs."""

    device = torch.device("cpu")
    model_path = ""

    def __init__(self):
        self.ins, self.outs = [], []

    def warmup_compile(self, w, h, **kw):
        return 0.0

    def put_frame(self, flat):
        return torch.from_numpy(np.ascontiguousarray(flat))

    def process_rgb48_device(self, x):
        self.ins.append(x.clone())
        out = x.to(torch.int32).mul(257).add(len(self.ins)).to(torch.uint16)
        self.outs.append(out)
        return out


def _files(d):
    with open(os.path.join(d, "session.json")) as f:
        session = json.load(f)
    with open(os.path.join(d, "summary.txt")) as f:
        summary = [ln.split("=")[0] for ln in f.read().splitlines()]
    with open(os.path.join(d, "runtime_metrics.csv")) as f:
        rows = list(csv.reader(f))
    return sorted(os.listdir(d)), session, summary, rows


@pytest.mark.parametrize("wall_clock", [False, True], ids=["frames", "wall_clock"])
def test_session_layout_matches_jax(small, wall_clock):
    """The same configuration through both packages' run_playback_benchmark
    (synthetic source, flat out): the same files, keys, lines and CSV
    header; by frames the same frame count."""
    cfg = dict(resolution_key="540p", realtime=False, duration_s=0.6 if wall_clock else 0.3, warmup_frames=2,
               wall_clock=wall_clock, sample_interval=3)
    got = tp.run_playback_benchmark(tp.PlaybackRunConfig(**cfg), TorchFake(), str(small / "t"))
    want = jp.run_playback_benchmark(jp.PlaybackRunConfig(**cfg), JaxFake(), str(small / "j"))
    assert set(dataclasses.asdict(got)) == set(dataclasses.asdict(want))
    assert got.config == want.config and got.frames > 0
    gf, jf = _files(small / "t"), _files(small / "j")
    assert gf[0] == jf[0] == ["runtime_metrics.csv", "session.json", "summary.txt"]
    assert set(gf[1]) == set(jf[1]) and gf[2] == jf[2] and gf[3][0] == jf[3][0]
    if wall_clock:
        assert got.samples and set(got.samples[0]) == set(want.samples[0])
        assert got.samples[0]["proc_res"] == want.samples[0]["proc_res"] == "96x64"
        assert 0.5 <= got.wall_s <= 8.0
    else:
        assert got.frames == want.frames == 9 and got.dropped == want.dropped == 0


def test_batch_csv_matches_jax(small):
    """run_batch over two presets: the same run folders and the three batch
    CSVs with the same header and first columns."""
    cfgs = [dict(resolution_key="540p", precision_key=k, realtime=False, duration_s=0.2, warmup_frames=1)
            for k in ("FP16", "INT8 Mixed (QAT)")]
    got = tp.run_batch([tp.PlaybackRunConfig(**c) for c in cfgs], lambda c: TorchFake(), str(small / "t"))
    want = jp.run_batch([jp.PlaybackRunConfig(**c) for c in cfgs], lambda c: JaxFake(), str(small / "j"))
    assert len(got) == len(want) == 2
    assert sorted(os.listdir(small / "t")) == sorted(os.listdir(small / "j"))
    assert "540p_INT8_Mixed_QAT_nohg" in os.listdir(small / "t")
    for name in ("playback_benchmark_summary.csv", "batch_summary.csv", "batch.csv"):
        with open(small / "t" / name) as f1, open(small / "j" / name) as f2:
            r1, r2 = list(csv.reader(f1)), list(csv.reader(f2))
        assert r1[0] == r2[0] and "ring_ms" in r1[0]
        assert [r[:3] for r in r1] == [r[:3] for r in r2]
        assert [r[7] for r in r1[1:]] == [r[7] for r in r2[1:]]  # frames


def test_write_session_is_byte_equal(tmp_path):
    fields = dict(config={"video": None, "precision": "FP16"}, fps=239.9, fps_1pct_low=80.1, model_ms=4.2,
                  frames=1136, dropped=0, realtime_factor=7.99, artifact_mb=2.27, wall_s=5.01, ring_ms=14.2)
    for samples in ([], [{"elapsed_s": 1.0, "fps": 240.0, "frame": 120}]):
        tp.write_session(str(tmp_path / "t"), tp.PlaybackResult(**fields, samples=samples))
        jp.write_session(str(tmp_path / "j"), jp.PlaybackResult(**fields, samples=samples))
        for name in ("session.json", "summary.txt", "runtime_metrics.csv"):
            assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def test_looping_source_matches_jax():
    from hdrtv_tpu.pipeline.source import SyntheticSource as JaxSource
    from hdrtv_tpu_torch.pipeline.source import SyntheticSource

    a, b = tp.LoopingSource(SyntheticSource(32, 16, fps=30, frames=5)), jp.LoopingSource(JaxSource(32, 16, fps=30,
                                                                                                    frames=5))
    for _ in range(12):
        ma, mb = a.read_with_meta(), b.read_with_meta()
        assert np.array_equal(ma[0], mb[0]) and ma[1:] == mb[1:]
    assert a.loops == b.loops >= 2 and a.fps == 30


def test_device_resident_chains_the_outputs(small):
    """run_device_resident through a torch fake: one upload, the first call,
    then ``frames`` calls, each input the base frame OR'd with bit 0 of the
    previous output's first code; the JAX report's keys, and the device."""
    fake = TorchFake()
    rep = tp.run_device_resident(fake, "540p", frames=4)
    want = jp.run_device_resident(JaxFake(), "540p", frames=2)
    assert set(rep) == set(want) | {"device"} and rep["device"] == "cpu"
    assert rep["frames"] == 4 and rep["resolution"] == want["resolution"] == "96x64" and rep["device_fps"] > 0
    assert len(fake.ins) == 5
    base = torch.from_numpy((np.random.RandomState(0).rand(64, 96 * 3) * 255).astype(np.uint8))
    assert torch.equal(fake.ins[0], base)
    for prev, nxt in zip(fake.outs, fake.ins[1:]):
        token = int(prev.reshape(-1)[0]) & 1
        assert torch.equal(nxt, base | token)
    assert {int(o.reshape(-1)[0]) & 1 for o in fake.outs} == {0, 1}  # the token changes the next input


def _child(tmp_path, body):
    path = tmp_path / "child.py"
    path.write_text(textwrap.dedent(body))
    return [sys.executable, str(path)]


def test_wrapper_kills_a_silent_child_at_its_budget(small):
    """A child that prints once and then nothing for 60 s: killed by group
    at the 1.5 s budget, well under 5 s, the lock released."""
    argv = _child(small, """
        import time
        print("sleeping", flush=True)
        time.sleep(60)
        print("never printed")
    """)
    w = tw.PlaybackBenchmarkWrapper(argv=argv, budget_s=1.5)
    t0 = time.monotonic()
    rc = w.run()
    took = time.monotonic() - t0
    assert w.canceled and rc != 0 and 1.4 <= took < 5.0
    assert w.lines == ["sleeping"] and not os.path.exists(tw.playback_lock_path())


def test_wrapper_streams_locks_and_parses_like_jax(small):
    """A child that checks the lock and writes a batch CSV: the lines
    stream, the lock is held during the run and released after, and the
    result table is the JAX wrapper's."""
    out = small / "session"
    out.mkdir()
    lock = tw.playback_lock_path()
    assert lock == jw.playback_lock_path()
    argv = _child(small, f"""
        import csv, os
        print("locked" if os.path.exists({lock!r}) else "unlocked")
        with open(os.path.join({str(out)!r}, "batch.csv"), "w", newline="") as f:
            wr = csv.writer(f)
            wr.writerow(["resolution", "precision", "fps", "model_ms", "ring_ms"])
            wr.writerow(["1080p", "FP16", "234.0", "4.39", "14.2"])
        print("batch CSV: " + os.path.join({str(out)!r}, "batch.csv"))
    """)
    seen = []
    w = tw.PlaybackBenchmarkWrapper(argv=argv, on_line=seen.append, out_dir=str(out))
    assert w.run() == 0 and not w.canceled
    assert seen == w.lines and w.lines[0] == "locked" and not tw.is_playback_locked()
    j = jw.PlaybackBenchmarkWrapper(argv=argv, out_dir=str(out))
    j.lines = list(w.lines)
    assert w.batch_rows() == j.batch_rows() and w.render_table() == j.render_table()
    os.makedirs(os.path.dirname(lock), exist_ok=True)
    with open(lock, "w") as f:
        f.write("999999999")  # a dead pid: stale
    assert not tw.is_playback_locked()
    with open(lock, "w") as f:
        f.write(str(os.getpid()))
    assert tw.is_playback_locked() and jw.is_playback_locked()
    assert tw.PlaybackBenchmarkWrapper(["--duration", "1"]).argv[1:4] == ["-m", "hdrtv_tpu_torch.cli", "bench"]


def test_doctor_without_a_card(monkeypatch, tmp_path):
    """No card: ok false with the issue named (the probe runs in its
    subprocess, which sees no CUDA device here); --no-device skips it. The
    tool belt and the weights are the JAX check's readings."""
    from hdrtv_tpu.runtime.doctor import check_tpu_runtime
    from hdrtv_tpu_torch.runtime.doctor import check_runtime

    monkeypatch.setenv("HDRTVNET_ENGINE_CACHE_DIR", str(tmp_path / "engines"))
    rep = check_runtime()
    assert not rep["ok"] and any("no CUDA device" in i for i in rep["issues"])
    assert rep["details"]["device_count"] == 0 and rep["details"]["torch"] == torch.__version__
    skipped = check_runtime(probe_device=False)
    assert skipped["details"]["device_probe"] == "skipped" and "device_count" not in skipped["details"]
    jax_rep = check_tpu_runtime(probe_device=False)
    for k in ("ffmpeg", "ffprobe", "mpv", "octave", "weights", "engine_cache"):
        assert skipped["details"][k] == jax_rep["details"][k]
    tools = ("ffmpeg", "ffprobe", "mpv", "octave")
    assert [d for d in skipped["details"].get("degraded", []) if d.split()[0] in tools] == \
        [d for d in jax_rep["details"].get("degraded", []) if d.split()[0] in tools]
