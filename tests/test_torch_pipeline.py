"""The port's playback pipeline on the CPU against hdrtv_tpu: the synthetic
source, the presentation clock and the runtime metrics' statistics (equal to
the JAX package's), the pinned slot ring's bookkeeping (driven with injected
completions), ``PipelineRunner``'s control surface (mirrored from
``tests/test_pipeline.py`` with a fake processor that returns torch
tensors), and ``PipelineRunner`` + ``FileSink`` through ``HDRTVNetTorch(device="cpu")``
against the JAX runner through ``HDRTVNetTPU``.

Tolerances: the sources, clocks and statistics are equal (bytes, floats).
Whole runs: the same frame count; fp32 frames within CODES u16 codes (the
5e-5 golden tolerance × 65535, rounded up, as ``tests/test_torch_slice.py``
holds them), bf16 frames within BF16_CODES (3e-2 of full scale, the bound of
``tests/test_torch_runtime.py`` against ``HDRTVNetTPU(precision="fp16")``,
whose CPU program is all-lax).
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from hdrtv_tpu.pipeline import pacing as jax_pacing
from hdrtv_tpu.pipeline import runner as jax_runner
from hdrtv_tpu.pipeline import source as jax_source
from hdrtv_tpu_torch.pipeline import pacing, runner, source
from hdrtv_tpu_torch.pipeline.sinks import FileSink, NullSink
from hdrtv_tpu_torch.runtime import transfer

ROOT = os.path.join(os.path.dirname(__file__), "..")
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
CODES = 4
BF16_CODES = int(3e-2 * 65535)


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
# Copies of host modules: equal to the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w", [(32, 64), (64, 250), (48, 377)], ids=["narrow", "wraps", "odd"])
def test_synthetic_source_is_byte_equal(h, w):
    """40 frames, then a seek back and 5 more: the same bytes, indices and
    stamps as the JAX source (the bar's start wraps at width − 200; under
    200 columns it covers the frame)."""
    a = source.SyntheticSource(w, h, fps=24, frames=60)
    b = jax_source.SyntheticSource(w, h, fps=24, frames=60)
    for i in range(45):
        if i == 40:
            a.seek(7)
            b.seek(7)
        fa, ia, pa = a.read_with_meta()
        fb, ib, pb = b.read_with_meta()
        assert fa.dtype == fb.dtype == np.uint8 and fa.shape == fb.shape == (h, w, 3)
        assert np.array_equal(fa, fb) and (ia, pa) == (ib, pb)


def test_synthetic_source_frames_are_the_callers():
    """Each frame is a new array: writing to one leaves the next intact."""
    src = source.SyntheticSource(96, 64, frames=3)
    f0 = src.read_with_meta()[0]
    f0[:] = 0
    src.seek(0)
    assert src.read_with_meta()[0].max() > 0


def test_presentation_clock_matches_jax(monkeypatch):
    """The same lags give the same skips, drops and slots on both clocks
    (time.monotonic and time.sleep faked: each reading of the clock moves it
    by 50 µs, a sleep by its length, so the run is deterministic)."""
    now = [100.0]

    def monotonic():
        now[0] += 5e-5
        return now[0]

    monkeypatch.setattr(time, "monotonic", monotonic)
    monkeypatch.setattr(time, "sleep", lambda s: now.__setitem__(0, now[0] + s))
    lags = [0.0, 0.001, 0.05, 0.2, 0.0, 0.4, 1.0, 0.0, 0.017]
    seen = []
    for mod in (pacing, jax_pacing):
        now[0] = 100.0
        clk = mod.PresentationClock(fps=60)
        clk.start()
        trace = []
        for lag in lags:
            now[0] += lag
            trace.append((clk.wait_for_slot(), clk.dropped, round(clk.next_frame_t, 9)))
        seen.append(trace)
    assert seen[0] == seen[1] and any(s for s, _, _ in seen[0])


@pytest.mark.parametrize("n", [2, 9, 57, 400])
def test_fps_statistics_match_jax(n):
    rng = np.random.RandomState(n)
    stamps = list(np.cumsum(rng.exponential(1 / 60, n) + rng.rand(n) * (rng.rand(n) < 0.05) * 0.1))
    assert runner.trimmed_mean_fps(stamps) == jax_runner.trimmed_mean_fps(stamps)
    assert runner.one_percent_low_fps(stamps) == jax_runner.one_percent_low_fps(stamps)


def test_new_modules_are_walked_for_jax():
    """``tests/test_torch_slice.py test_import_leaves_jax_out`` imports every
    module pkgutil finds under the package: the pipeline's among them."""
    import pkgutil

    import hdrtv_tpu_torch

    found = {m.name for m in pkgutil.walk_packages(hdrtv_tpu_torch.__path__, "hdrtv_tpu_torch.")}
    want = {f"hdrtv_tpu_torch.{m}" for m in (
        "config", "cli", "bench.y4m", "runtime.probe", "runtime.transfer", "utils.prefs", "utils.assets",
        "utils.profiling", "pipeline.pacing", "pipeline.source", "pipeline.sinks", "pipeline.scaling",
        "pipeline.runner", "pipeline.export")}
    assert want <= found, want - found


# ---------------------------------------------------------------------------
# The slot ring (runtime/transfer.py), driven on the CPU
# ---------------------------------------------------------------------------


class Pending:
    """An injected completion: ``synchronize`` blocks until ``finish``."""

    def __init__(self):
        self._ev = threading.Event()
        self.waited = 0

    def finish(self):
        self._ev.set()

    def synchronize(self):
        self.waited += 1
        assert self._ev.wait(10.0)


def test_ring_hands_out_no_held_slot():
    ring = transfer.HostRing(3, pinned=False)
    held = [ring.acquire() for _ in range(3)]
    assert len({id(s) for s in held}) == 3 and ring.held == 3
    got = []
    t = threading.Thread(target=lambda: got.append(ring.acquire()))
    t.start()
    t.join(0.2)
    assert t.is_alive() and not got  # every slot held: the acquire waits
    ring.release(held[1])
    t.join(5.0)
    assert not t.is_alive() and got == [held[1]]
    ring.release(held[1])
    with pytest.raises(ValueError):
        ring.release(held[1])  # released twice
    with pytest.raises(ValueError):
        ring.release(transfer.HostSlot(pinned=False))  # not this ring's
    assert ring.acquire() is held[1] and ring.held == 3
    stop = threading.Event()
    stop.set()
    assert ring.acquire(stop) is None  # a stopping producer does not wait


def test_slot_refill_waits_for_its_copy():
    """A slot whose copy is pending is refilled only after that copy's
    completion; its array is read only after it too."""
    slot = transfer.HostSlot(pinned=False)
    transfer.copy_out(torch.arange(6, dtype=torch.int16), slot, None)
    pending = slot.done = Pending()
    done = []
    t = threading.Thread(target=lambda: done.append(transfer.copy_out(torch.zeros(6, dtype=torch.int16), slot, None)))
    t.start()
    t.join(0.2)
    assert t.is_alive() and not done and pending.waited == 1
    pending.finish()
    t.join(5.0)
    assert done and not slot.array().any()


# ---------------------------------------------------------------------------
# PipelineRunner's control surface (tests/test_pipeline.py, a torch fake)
# ---------------------------------------------------------------------------


class FakeProcessor:
    """HDRTVNetTorch's frame contract on the CPU: (H, 3W) u8 in, u16 × 257
    out (at ``proc_resolution`` when set), with an optional delay."""

    device = torch.device("cpu")

    def __init__(self, delay_s: float = 0.0, proc_resolution=None, precision="fp32"):
        self.delay = delay_s
        self.proc_resolution = proc_resolution
        self.precision = precision
        self.calls = 0

    def warmup_compile(self, w, h, **kw):
        return 0.0

    def put_frame(self, flat):
        return torch.from_numpy(np.ascontiguousarray(flat))

    def process_rgb48_device(self, x):
        self.calls += 1
        if self.delay:
            time.sleep(self.delay)
        out = x.to(torch.int32).mul(257).to(torch.uint16)
        if self.proc_resolution is not None:
            pw, ph = self.proc_resolution
            return out[:ph, : 3 * pw].clone()
        return out

    def with_proc_resolution(self, r):
        return FakeProcessor(self.delay, r, self.precision)


def _runner(frames=100000, **kw):
    def factory(precision="fp32", proc_resolution=None):
        return FakeProcessor(0.002, proc_resolution, precision)

    src = source.SyntheticSource(64, 48, fps=240.0, frames=frames)
    sink = NullSink()
    r = runner.PipelineRunner(src, factory(), sink, realtime=False, processor_factory=factory, **kw)
    return r, src, sink


def _wait(cond, timeout=30.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.01)
    return False


def _start(r):
    t = threading.Thread(target=r.run, daemon=True)
    t.start()
    return t


def _stop(r, t):
    r.stop()
    t.join(timeout=30)
    assert not t.is_alive()


def test_runner_offline_processes_all_frames():
    src = source.SyntheticSource(64, 32, fps=1000, frames=20)
    sink = NullSink()
    m = runner.PipelineRunner(src, FakeProcessor(), sink, realtime=False).run()
    assert m.frames == 20 and sink.frames == 20 and sink.bytes == 20 * 32 * 64 * 3 * 2
    assert m.model_ms > 0 and m.ring_ms >= m.model_ms * 0.5 and m.device_mem_mb == 0.0


def test_runner_failing_sink_raises_instead_of_hanging():
    class ExplodingSink:
        frames = 0

        def show(self, rgb48, pts=None):
            raise ValueError("disk full")

        def close(self):
            pass

    src = source.SyntheticSource(64, 32, fps=1000, frames=50)
    r = runner.PipelineRunner(src, FakeProcessor(), ExplodingSink(), realtime=False, ring=1)
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="disk full"):
        r.run()
    assert time.monotonic() - t0 < 30
    assert r._out.held == 0  # every slot came back


def test_runner_realtime_paces_and_reports():
    src = source.SyntheticSource(64, 32, fps=120, frames=24)
    t0 = time.monotonic()
    m = runner.PipelineRunner(src, FakeProcessor(), NullSink(), realtime=True).run()
    assert m.frames + m.dropped >= 20 and time.monotonic() - t0 > 0.1


def test_runner_pause_resume():
    r, src, sink = _runner()
    t = _start(r)
    assert _wait(lambda: sink.frames >= 5)
    r.pause()
    assert _wait(lambda: r._paused.is_set())
    time.sleep(0.2)
    at_pause = sink.frames
    time.sleep(0.3)
    assert sink.frames <= at_pause + r.ring  # only the ring drains
    level = sink.frames
    r.resume()
    assert _wait(lambda: sink.frames > level + 2)
    _stop(r, t)


def test_runner_seek_flushes_stale_frames():
    r, src, sink = _runner()
    t = _start(r)
    assert _wait(lambda: sink.frames >= 5)
    r.request_seek(5000)
    assert _wait(lambda: src._idx >= 5000)
    _stop(r, t)
    assert r._generation == 1


def test_runner_hot_swap_resolution_mid_run():
    """The new processor's frames reach the sink at its size (the out-slots
    take the new shape)."""
    shapes = []

    class Sink(NullSink):
        def show(self, rgb48, pts=None):
            shapes.append(rgb48.shape)
            super().show(rgb48, pts)

    r, src, _ = _runner()
    sink = r.sink = Sink()
    t = _start(r)
    assert _wait(lambda: sink.frames >= 5)
    before = sink.frames
    r.request_resolution_change((32, 24))
    assert _wait(lambda: r.processor.proc_resolution == (32, 24) and sink.frames > before + 3)
    _stop(r, t)
    assert shapes[0] == (48, 192) and shapes[-1] == (24, 96)


def test_runner_paused_hot_swap_redraws():
    r, src, sink = _runner()
    t = _start(r)
    assert _wait(lambda: sink.frames >= 5)
    r.pause()
    assert _wait(lambda: r._paused.is_set())
    time.sleep(0.3)  # let the in-flight ring drain
    base = sink.frames
    r.request_precision_change("fp16")
    assert _wait(lambda: sink.frames == base + 1)  # exactly the redraw
    time.sleep(0.2)
    assert sink.frames == base + 1 and r.processor.precision == "fp16"
    _stop(r, t)


def test_runner_warmup_frames_excluded_from_final_stats():
    class Sink:
        frames = 0

        def show(self, *a, **k):
            Sink.frames += 1

        def close(self):
            pass

    src = source.SyntheticSource(64, 32, fps=240, frames=20)
    r = runner.PipelineRunner(src, FakeProcessor(), Sink(), realtime=False, warmup_frames=10)
    m = r.run()
    assert m.frames == 20 and m.fps > 0
    assert m.fps == runner.trimmed_mean_fps(r._stamps[10:])


def test_runner_slow_sink_full_ring_keeps_every_frame():
    """A slow sink with the ring full: every frame reaches the sink with its
    own bytes, the copies' injected completions are waited for before the
    sink reads a slot, and no out-slot is handed out while the sink holds
    it. The out-ring is cut to two slots under a queue of three, so the
    producer must wait for the sink's releases."""
    showing = {"ptr": None}
    injected = []

    class Checked(runner.PipelineRunner):
        def _setup_copies(self):
            super()._setup_copies()
            assert len(self._out.slots) == self.ring + 2
            self._out = transfer.HostRing(2, pinned=False)

        def _copy_out(self, dev_out):
            slot = super()._copy_out(dev_out)
            assert slot.tensor.numpy().__array_interface__["data"][0] != showing["ptr"]
            pending = slot.done = Pending()
            injected.append(pending)
            threading.Timer(0.003, pending.finish).start()  # the copy "lands" later
            return slot

    class SlowSink:
        def __init__(self):
            self.frames = []

        def show(self, rgb48, pts=None):
            showing["ptr"] = rgb48.__array_interface__["data"][0]
            time.sleep(0.01)
            self.frames.append(rgb48.copy())
            showing["ptr"] = None

        def close(self):
            pass

    sink = SlowSink()
    src = source.SyntheticSource(96, 64, fps=1000, frames=24)
    r = Checked(src, FakeProcessor(), sink, realtime=False, ring=3)
    m = r.run()
    ref = source.SyntheticSource(96, 64, fps=1000, frames=24)
    want = [(ref.read_with_meta()[0].reshape(64, -1).astype(np.uint16) * 257) for _ in range(24)]
    assert m.frames == 24 and len(sink.frames) == 24 and len(injected) == 24
    assert all(np.array_equal(a, b) for a, b in zip(sink.frames, want))
    assert all(p.waited == 1 for p in injected) and r._out.held == 0


def test_runner_drains_before_a_new_processor_runs():
    """A hot-swap waits for the frames in flight before the new processor's
    first frame (which may capture a CUDA graph on a card)."""
    inflight_at_swap = []

    class Watch(FakeProcessor):
        def process_rgb48_device(self, x):
            if self.calls == 0:
                inflight_at_swap.append(r._pending)
            return super().process_rgb48_device(x)

    def factory(precision="fp32", proc_resolution=None):
        return Watch(0.002, proc_resolution, precision)

    class SlowSink(NullSink):
        def show(self, rgb48, pts=None):
            time.sleep(0.005)
            super().show(rgb48, pts)

    src = source.SyntheticSource(64, 48, fps=240.0, frames=100000)
    sink = SlowSink()
    r = runner.PipelineRunner(src, factory(), sink, realtime=False, processor_factory=factory)
    t = _start(r)
    assert _wait(lambda: sink.frames >= 8)
    r.request_precision_change("fp16")
    assert _wait(lambda: len(inflight_at_swap) == 2 and sink.frames > 12)
    _stop(r, t)
    assert inflight_at_swap == [0, 0]


# ---------------------------------------------------------------------------
# PipelineRunner + FileSink: the port against the JAX pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision,bound", [("fp32", CODES), ("fp16", BF16_CODES)], ids=["fp32", "bf16"])
def test_runner_file_sink_matches_jax(tmp_path, precision, bound):
    """Six synthetic 64 × 96 frames through each package's runner into a
    FileSink: the same byte count, every frame within the bound; the port's
    frames equal its own process_rgb48 of the same frames."""
    from hdrtv_tpu.pipeline.sinks import FileSink as JaxFileSink
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    n, h, w = 6, 64, 96
    outs = {}
    for name, run_cls, sink_cls, proc in (
        ("port", runner.PipelineRunner, FileSink,
         HDRTVNetTorch(WEIGHTS, precision=precision, device="cpu", persistent_cache=False)),
        ("jax", jax_runner.PipelineRunner, JaxFileSink,
         HDRTVNetTPU(WEIGHTS, precision=precision, persistent_cache=False)),
    ):
        path = str(tmp_path / f"{name}.rgb48")
        sink = sink_cls(path)
        m = run_cls(source.SyntheticSource(w, h, fps=30, frames=n), proc, sink, realtime=False).run()
        sink.close()
        assert m.frames == n and sink.frames == n
        outs[name] = np.fromfile(path, np.uint16)
        if name == "port":
            src = source.SyntheticSource(w, h, fps=30, frames=n)
            own = np.stack([proc.process_rgb48(src.read_with_meta()[0]) for _ in range(n)])
    assert outs["port"].size == outs["jax"].size == n * h * w * 3
    assert np.array_equal(outs["port"].reshape(n, h, w, 3), own)
    assert np.abs(outs["port"].astype(np.int64) - outs["jax"].astype(np.int64)).max() <= bound
