"""Realtime pipeline runner — the PipelineWorker equivalent (the port's
counterpart of ``hdrtv_tpu/pipeline/runner.py``).

Maps the reference's worker design (gui_pipeline_worker.py:563-1146 +
frame_processing + feeders) onto CUDA streams:

  decode ─► paced main loop ─► pinned in-slot, H2D copy stream ─► graph replay
      on the compute stream ─► D2H copy stream into a pinned out-slot
      ─► in-flight ring ─► feeder thread (waits on that slot's event, sink)

The JAX runner relies on XLA's asynchronous dispatch and a host fetch in the
feeder. Here the main loop stages each frame in a pinned buffer of the
processor (``put_frame``: a non-blocking copy on its H2D stream, which the
compute stream waits for), enqueues the frame's program on the runner's
compute stream (``process_rgb48_device``, one CUDA graph replay), then the
copy of its output into a pinned out-slot on the runner's D2H stream, and
records that copy's event. The feeder thread waits on the slot's event
alone, never on the device as a whole, hands the slot's array to the sink
and returns the slot to the ring. So the copies of frame n overlap the
replay of frame n + 1, the reference's 3-slot pinned ring with converter
streams (VIDEO_PLAYBACK_BUFFER_FRAMES, gui_config.py:380-390).

A sink's ``show`` must not keep the array after it returns: its slot is
refilled. The ring holds ``ring + 2`` out-slots (``ring`` queued, one at the
sink, one being filled); the producer waits for a free one. A frame that may
capture a CUDA graph (the first after a hot-swap or a size change) is
submitted only after the ring has drained: the generation flush drops those
frames anyway, and nothing of the feeder's runs beside the capture.

With a processor on the CPU (``device="cpu"``) there are no streams and
nothing is pinned: the out-slots are plain host buffers filled at once. The
runner uses the CPU only then.

Runtime metrics mirror gui_pipeline_worker_runtime_metrics.py: trimmed-mean
FPS over presentation stamps, per-stage model latency, drop counts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from hdrtv_tpu_torch.pipeline.pacing import PresentationClock
from hdrtv_tpu_torch.runtime import transfer
from hdrtv_tpu_torch.utils.env import env_int
from hdrtv_tpu_torch.utils.profiling import StageTimers


@dataclasses.dataclass
class RuntimeMetrics:
    fps: float = 0.0
    fps_1pct_low: float = 0.0
    model_ms: float = 0.0  # marginal device service time per frame
    ring_ms: float = 0.0  # submit→fetched latency incl. queue residency
    frames: int = 0
    dropped: int = 0
    realtime_factor: float = 0.0
    device_mem_mb: float = 0.0  # whole-app VRAM analog (runtime_metrics.py:28-78)
    host_rss_mb: float = 0.0


def _device_memory_mb(device: torch.device) -> float:
    """Device memory the caching allocator has handed out (0 on the CPU)."""
    if device.type != "cuda":
        return 0.0
    return round(torch.cuda.memory_allocated(device) / 1e6, 1)


def _host_rss_mb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024, 1)
    except OSError:
        pass
    return 0.0


def trimmed_mean_fps(stamps: list[float], trim: float = 0.05) -> float:
    """FPS from presentation timestamps, trimming outlier intervals
    (gui_pipeline_worker_runtime_metrics.py:28-78 methodology)."""
    if len(stamps) < 3:
        return 0.0
    iv = np.diff(np.asarray(stamps))
    iv = np.sort(iv)
    k = int(len(iv) * trim)
    core = iv[k : len(iv) - k] if len(iv) > 2 * k else iv
    mean = float(np.mean(core))
    return 1.0 / mean if mean > 0 else 0.0


def one_percent_low_fps(stamps: list[float]) -> float:
    """1%-low FPS (worst 1% frame intervals — cli_playback_benchmark.py:332-362)."""
    if len(stamps) < 10:
        return 0.0
    iv = np.sort(np.diff(np.asarray(stamps)))
    worst = iv[-max(1, len(iv) // 100) :]
    mean = float(np.mean(worst))
    return 1.0 / mean if mean > 0 else 0.0


def processor_device(processor) -> torch.device:
    """The device a processor runs on (``HDRTVNetTorch.device``); a processor
    that names none runs on the CPU."""
    return torch.device(getattr(processor, "device", None) or "cpu")


class PipelineRunner:
    """Paced realtime loop: source → processor → sink.

    ``processor`` must expose ``process_rgb48_device(tensor) -> tensor``
    (HDRTVNetTorch) and may expose ``put_frame(host (H, 3W) u8) -> tensor``.
    ``realtime=False`` runs flat-out (export / benchmark mode).
    """

    def __init__(
        self,
        source,
        processor,
        sink,
        *,
        realtime: bool = True,
        ring: int | None = None,
        max_frames: int | None = None,
        processor_factory=None,
        on_metrics=None,
        target_fps: float | None = None,
        warmup_frames: int = 0,
    ):
        self.source = source
        self.processor = processor
        self.sink = sink
        self.realtime = realtime
        self.ring = ring or env_int("HDRTVNET_VIDEO_PLAYBACK_BUFFER_FRAMES", 3, lo=1, hi=24)
        self.max_frames = max_frames
        self.processor_factory = processor_factory
        # Live metrics emission (0.2 s throttle — the reference's
        # _emit_runtime_metrics_if_ready cadence, runtime_metrics.py:79).
        self.on_metrics = on_metrics
        self._last_emit = 0.0
        # Per-stage host timing (decode/submit/render — the reference CLI's
        # stage report, main.py:282-331, via utils/profiling.StageTimers).
        self.timers = StageTimers()
        # --target-fps overrides the source rate for pacing (main.py:162)
        self.clock = PresentationClock(target_fps or getattr(source, "fps", 30.0))
        # frames excluded from the final timing stats (main.py --warmup)
        self.warmup_frames = max(0, int(warmup_frames))
        self.metrics = RuntimeMetrics()
        self._stamps: list[float] = []
        self._stop = threading.Event()
        # Control surface (reference worker gates: pause/seek/hot-swap —
        # gui_pipeline_worker.py:159-561, seek gate :788-824).
        self._commands: queue.Queue = queue.Queue()
        self._paused = threading.Event()
        self._generation = 0  # bumps on seek/swap; stale in-flight frames drop
        self._last_frame = None  # most recent source frame (paused redraw)
        self.flushed = 0
        # Frames put in flight and not yet through the feeder, and what the
        # last submission ran on (a new processor or size drains first).
        self._pending = 0
        self._pending_cv = threading.Condition()
        self._last_signature = None
        self._feeder_alive = False
        self.device = processor_device(processor)
        self._out: transfer.HostRing | None = None
        self._compute = self._d2h = None

    def stop(self):
        self._stop.set()

    # ------------------------------------------------------------------
    # Control requests (thread-safe; applied at the next loop iteration)
    # ------------------------------------------------------------------

    def pause(self):
        """Gate the loop; in-flight frames still drain to the sink."""
        self._commands.put(("pause", None))

    def resume(self):
        self._commands.put(("resume", None))

    def request_seek(self, frame_idx: int):
        """source.seek + generation flush + presentation clock reset
        (gui_pipeline_worker.py:788-824 semantics)."""
        self._commands.put(("seek", int(frame_idx)))

    def request_precision_change(self, precision: str):
        """Hot-swap the processor to a new precision mid-run. Needs a
        ``processor_factory(precision=..., proc_resolution=...)``; the new
        processor captures its graph at its first frame, after the ring has
        drained. While paused, the last frame is re-rendered with the new
        engine (paused hot-swap redraw)."""
        self._commands.put(("precision", str(precision)))

    def request_resolution_change(self, proc_resolution: tuple[int, int]):
        """Hot-swap the processing resolution (device letterbox target)."""
        self._commands.put(("resolution", tuple(proc_resolution)))

    def _apply_commands(self, inflight) -> None:
        while True:
            try:
                cmd, arg = self._commands.get_nowait()
            except queue.Empty:
                return
            if cmd == "pause":
                self._paused.set()
            elif cmd == "resume":
                self._paused.clear()
                if self.realtime:
                    self.clock.start()
            elif cmd == "seek":
                self._generation += 1
                self.source.seek(arg)
                if self.realtime:
                    self.clock.start()
                if self._paused.is_set():
                    # Paused-seek redraw (gui_timeline paused-seek queueing).
                    meta = self.source.read_with_meta()
                    if meta is not None:
                        self._last_frame = meta
                        self._submit(meta, inflight)
            elif cmd in ("precision", "resolution"):
                self._generation += 1
                if cmd == "precision" and self.processor_factory is not None:
                    self.processor = self.processor_factory(precision=arg)
                elif cmd == "resolution":
                    if self.processor_factory is not None:
                        self.processor = self.processor_factory(proc_resolution=arg)
                    elif hasattr(self.processor, "with_proc_resolution"):
                        self.processor = self.processor.with_proc_resolution(arg)
                # Paused hot-swap redraw: re-render the held frame so the
                # display reflects the new engine immediately.
                if self._paused.is_set() and self._last_frame is not None:
                    self._submit(self._last_frame, inflight)

    # ------------------------------------------------------------------
    # The copies (the hooks a measurement of other copies replaces)
    # ------------------------------------------------------------------

    def _setup_copies(self) -> None:
        """The compute and D2H streams and the out-slots: pinned on a CUDA
        processor, plain host buffers on a CPU one."""
        cuda = self.device.type == "cuda"
        if cuda:
            self._compute = torch.cuda.Stream(self.device)
            self._d2h = torch.cuda.Stream(self.device)
        self._out = transfer.HostRing(self.ring + 2, pinned=cuda)

    def _copy_out(self, dev_out: torch.Tensor):
        """Enqueue the output's copy into a free out-slot (waiting while the
        sink holds every slot); the handle the feeder receives, or None once
        the run is stopping."""
        slot = self._out.acquire(self._stop)
        if slot is None:
            return None
        return transfer.copy_out(dev_out, slot, self._d2h)

    def _fetch(self, handle) -> np.ndarray:
        """The frame of a handle on the host, once its copy is done."""
        return handle.array()

    def _finish(self, handle) -> None:
        """The sink is done with a handle's frame."""
        self._out.release(handle)

    # ------------------------------------------------------------------
    # The loop
    # ------------------------------------------------------------------

    def _drain(self) -> None:
        """Wait until every frame in flight has been through the feeder (or
        the feeder is gone, or the run is stopping)."""
        with self._pending_cv:
            while self._pending and self._feeder_alive and not self._stop.is_set():
                self._pending_cv.wait(0.05)

    def _submit(self, meta, inflight) -> None:
        frame, idx, pts = meta
        t_submit = time.monotonic()
        # Ship flat byte rows; the processor's put_frame picks its layout
        # (pair planes where its pair-plane program runs) and copies them in
        # on its H2D stream.
        h = frame.shape[0]
        flat = np.ascontiguousarray(frame).reshape(h, -1)
        signature = (id(self.processor), flat.shape)
        if signature != self._last_signature:
            self._drain()  # this frame may capture a CUDA graph
            self._last_signature = signature
        put = getattr(self.processor, "put_frame", None)
        dev = put(flat) if put is not None else torch.from_numpy(flat)
        dev_out = self.processor.process_rgb48_device(dev)
        handle = self._copy_out(dev_out)
        if handle is None:
            return
        # Side-by-side sinks also want the source frame (SDR pane).
        sdr = frame if hasattr(self.sink, "show_sdr") else None
        with self._pending_cv:
            self._pending += 1
        inflight.put((handle, pts, t_submit, self._generation, sdr))

    def _done(self, handle) -> None:
        self._finish(handle)
        with self._pending_cv:
            self._pending -= 1
            self._pending_cv.notify_all()

    def run(self) -> RuntimeMetrics:
        self.device = processor_device(self.processor)
        self._setup_copies()
        inflight: queue.Queue = queue.Queue(maxsize=self.ring)
        feeder_done = threading.Event()
        feeder_error: list[BaseException] = []
        model_ms: list[float] = []
        ring_ms: list[float] = []

        def feeder():
            try:
                _feeder_loop()
            except BaseException as exc:  # surface sink/fetch failures
                feeder_error.append(exc)
                self._stop.set()  # a dead feeder must stop the producer too
                # Keep draining: the producer may be blocked in
                # inflight.put() on a full ring, and its finally-clause
                # sentinel put(None) must never deadlock against us.
                while True:
                    try:
                        item = inflight.get(timeout=5.0)
                    except queue.Empty:
                        break
                    if item is None:
                        break
                    self._done(item[0])
            finally:
                with self._pending_cv:
                    self._feeder_alive = False
                    self._pending_cv.notify_all()
                feeder_done.set()

        def _feeder_loop():
            """Hand completed frames to the sink.

            The wait on the slot's copy event here is the only host↔device
            fence in the steady state — the reference's feeder-thread /
            ready-event pattern (gui_pipeline_worker_feeders.py:313-496)."""
            prev_done = None
            while True:
                item = inflight.get()
                if item is None:
                    break
                handle, pts, t_submit, gen, sdr = item
                try:
                    host = self._fetch(handle)
                    if host.ndim == 4:
                        # Pair-plane program output (Hb,2,Wb,6): restore the
                        # sinks' (H, 3W) byte-row contract — a free numpy view
                        # of the same RGB48 bytes.
                        hb, _, wb, _ = host.shape
                        host = host.reshape(2 * hb, 6 * wb)
                    t_done = time.monotonic()
                    if gen != self._generation:
                        # Stale frame from before a seek/hot-swap: the
                        # reference's drop-until-watermark flush
                        # (gui_pipeline_worker.py:808).
                        self.flushed += 1
                        continue
                    # Ring latency includes queue residency; model time is the
                    # marginal device service time — the interval this frame
                    # kept the (saturated) device busy. Stable as ring depth
                    # varies, matching the reference's CUDA-event model timing
                    # role (gui_pipeline_worker_frame_processing.py:158-166).
                    ring_ms.append((t_done - t_submit) * 1e3)
                    start = t_submit if prev_done is None else max(prev_done, t_submit)
                    model_ms.append((t_done - start) * 1e3)
                    prev_done = t_done
                    with self.timers.stage("render"):
                        if sdr is not None:
                            self.sink.show_sdr(sdr, pts)
                        self.sink.show(host, pts)
                    self._stamps.append(time.monotonic())
                finally:
                    self._done(handle)

        self._feeder_alive = True
        fthread = threading.Thread(target=feeder, daemon=True, name="hdr-feeder")
        fthread.start()

        processed = 0
        t_start = time.monotonic()
        if self.realtime:
            self.clock.start()
        streams = torch.cuda.stream(self._compute) if self._compute is not None else contextlib.nullcontext()
        try:
            with streams:
                while not self._stop.is_set():
                    self._apply_commands(inflight)
                    if self._paused.is_set():
                        time.sleep(0.005)  # pause gate; commands still apply
                        continue
                    if self.max_frames is not None and processed >= self.max_frames:
                        break
                    if self.realtime:
                        skip = self.clock.wait_for_slot()
                        for _ in range(skip):
                            if self.source.read_with_meta() is None:
                                break
                        self.metrics.dropped = self.clock.dropped
                    with self.timers.stage("decode"):
                        meta = self.source.read_with_meta()
                    if meta is None:
                        break
                    self._last_frame = meta
                    with self.timers.stage("submit"):
                        self._submit(meta, inflight)  # blocks when ring full
                    processed += 1
                    now = time.monotonic()
                    if self.on_metrics is not None and now - self._last_emit >= 0.2:
                        self._last_emit = now
                        snap = RuntimeMetrics(
                            fps=trimmed_mean_fps(self._stamps[-60:]),
                            fps_1pct_low=one_percent_low_fps(self._stamps[-120:]),
                            frames=processed,
                            dropped=self.metrics.dropped,
                        )
                        self.on_metrics(snap)
        finally:
            try:
                # Bounded: if the feeder died and its drain loop already gave
                # up (e.g. ring==1 and we were mid-submit past its 5 s drain
                # window), the ring may be full with no consumer — the
                # sentinel is only a wake-up, never worth deadlocking run().
                inflight.put(None, timeout=10.0)
            except queue.Full:
                pass
            feeder_done.wait(timeout=10.0)
        if feeder_error:
            raise feeder_error[0]  # a silent sink is a lying benchmark

        wall = time.monotonic() - t_start
        self.metrics.device_mem_mb = _device_memory_mb(self.device)
        self.metrics.host_rss_mb = _host_rss_mb()
        self.metrics.frames = processed
        stats_stamps = self._stamps[self.warmup_frames:] if len(self._stamps) > self.warmup_frames else self._stamps
        self.metrics.fps = trimmed_mean_fps(stats_stamps)
        self.metrics.fps_1pct_low = one_percent_low_fps(stats_stamps)
        self.metrics.model_ms = float(np.mean(model_ms)) if model_ms else 0.0
        self.metrics.ring_ms = float(np.mean(ring_ms)) if ring_ms else 0.0
        if wall > 0 and processed:
            self.metrics.realtime_factor = (processed / getattr(self.source, "fps", 30.0)) / wall
        return self.metrics
