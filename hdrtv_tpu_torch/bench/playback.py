"""Playback performance benchmark — cli_playback_benchmark.py equivalent (the
port of ``hdrtv_tpu/bench/playback.py``).

Batch runs over resolutions × precisions × HG; realtime mode mirrors the GUI
pacing including catch-up drops (cli_playback_benchmark.py:1007-1050);
reports FPS, 1% low, model latency, memory, artifact size, processed/dropped
and writes the reference session layout: ``summary.txt``, ``session.json``,
``runtime_metrics.csv`` (:596-888). The pipelined run goes through
``pipeline/runner.py`` (pinned rings, copy streams, one CUDA graph per frame
signature); ``run_device_resident`` chains ``process_rgb48_device`` replays
on the card with no host copy between them.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import time

import numpy as np
import torch

from hdrtv_tpu_torch.pipeline.runner import PipelineRunner
from hdrtv_tpu_torch.pipeline.sinks import make_sink
from hdrtv_tpu_torch.pipeline.source import SyntheticSource, VideoSource


@dataclasses.dataclass
class PlaybackRunConfig:
    video: str | None = None  # None → synthetic source
    precision_key: str = "FP16"
    resolution_key: str = "1080p"
    use_hg: bool = False
    realtime: bool = True
    duration_s: float = 30.0
    warmup_frames: int = 8
    sink: str = "null"
    # loop the source at EOF so short clips sustain the full duration
    # (cli_playback_benchmark.py --loop-source)
    loop_source: bool = False
    # measure for true wall-clock duration instead of duration_s × fps
    # frames (cli_playback_benchmark.py --wall-clock)
    wall_clock: bool = False
    # periodic runtime sample cadence in frames (— --sample-interval)
    sample_interval: int = 120


class LoopingSource:
    """EOF-looping wrapper over a source (the --loop-source behavior)."""

    def __init__(self, source):
        self._src = source
        self.loops = 0

    def __getattr__(self, name):
        return getattr(self._src, name)

    def read_with_meta(self, *a, **k):
        meta = self._src.read_with_meta(*a, **k)
        if meta is None:
            self.loops += 1
            self._src.seek(0)
            meta = self._src.read_with_meta(*a, **k)
        return meta


@dataclasses.dataclass
class PlaybackResult:
    config: dict
    fps: float
    fps_1pct_low: float
    model_ms: float
    frames: int
    dropped: int
    realtime_factor: float
    artifact_mb: float
    wall_s: float
    ring_ms: float = 0.0  # submit→fetched latency incl. queue residency
    samples: list = dataclasses.field(default_factory=list)  # periodic runtime rows


def run_playback_benchmark(cfg: PlaybackRunConfig, processor, out_dir: str | None = None) -> PlaybackResult:
    from hdrtv_tpu_torch.config import processing_dims

    w, h = processing_dims(cfg.resolution_key)
    if cfg.video:
        source = VideoSource(cfg.video)
        fps = source.fps
    else:
        fps = 30.0
        frames = int(cfg.duration_s * fps) + cfg.warmup_frames
        source = SyntheticSource(w, h, fps=fps, frames=(1 << 30) if cfg.wall_clock else frames)
    if cfg.loop_source:
        source = LoopingSource(source)

    sink = make_sink(cfg.sink, w, h, fps)
    # Warmup (compile) outside the timed window.
    processor.warmup_compile(w, h)
    put = getattr(processor, "put_frame", None)
    for _ in range(cfg.warmup_frames):
        meta = source.read_with_meta()
        if meta is None:
            break
        flat = np.ascontiguousarray(meta[0]).reshape(meta[0].shape[0], -1)
        processor.process_rgb48_device(put(flat) if put is not None else torch.from_numpy(flat))

    # periodic runtime samples (the Log Session sample CSV,
    # gui_playback_logging.py:276-338)
    samples: list[dict] = []
    t0 = time.monotonic()
    state = {"next": max(1, int(cfg.sample_interval))}

    def on_metrics(snap):
        if snap.frames >= state["next"]:
            state["next"] = snap.frames + max(1, int(cfg.sample_interval))
            samples.append({
                "elapsed_s": round(time.monotonic() - t0, 3),
                "fps": round(snap.fps, 2),
                "fps_1pct_low": round(snap.fps_1pct_low, 2),
                "frame": snap.frames,
                "dropped": snap.dropped,
                "precision": cfg.precision_key,
                "proc_res": f"{w}x{h}",
            })

    max_frames = None if cfg.wall_clock else int(cfg.duration_s * fps)
    runner = PipelineRunner(
        source, processor, sink, realtime=cfg.realtime, max_frames=max_frames,
        on_metrics=on_metrics,
    )
    stop_timer = None
    if cfg.wall_clock:
        # true wall-clock window: stop the runner after duration_s
        # (cli_playback_benchmark.py --wall-clock)
        import threading

        stop_timer = threading.Timer(cfg.duration_s, runner.stop)
        stop_timer.daemon = True
        stop_timer.start()
    t0 = time.monotonic()
    metrics = runner.run()
    wall = time.monotonic() - t0
    if stop_timer is not None:
        stop_timer.cancel()
    source.close()
    sink.close()

    artifact_mb = 0.0
    model_path = getattr(processor, "model_path", "")
    if model_path and os.path.isfile(model_path):
        artifact_mb = os.path.getsize(model_path) / 1e6

    result = PlaybackResult(
        config=dataclasses.asdict(cfg),
        fps=round(metrics.fps, 2),
        fps_1pct_low=round(metrics.fps_1pct_low, 2),
        model_ms=round(metrics.model_ms, 2),
        frames=metrics.frames,
        dropped=metrics.dropped,
        realtime_factor=round(metrics.realtime_factor, 3),
        artifact_mb=round(artifact_mb, 2),
        wall_s=round(wall, 2),
        ring_ms=round(metrics.ring_ms, 2),
        samples=samples,
    )
    if out_dir:
        write_session(out_dir, result)
    return result


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_device_resident(processor, resolution_key: str, frames: int = 120) -> dict:
    """Device-resident sustained model throughput (the bench.py methodology
    behind the product CLI).

    The pipelined runner's per-frame host↔device copies measure the copies
    as well as the model. This loop keeps frames device-resident: one
    upload, ``frames`` chained ``process_rgb48_device`` calls (CUDA graph
    replays on a card) with a data dependence (a one-bit token of each packed
    output OR'd into the base frame feeds the next input), one final fetch.
    The clock reads the host between two device synchronizations, so it
    times the device's work, not the enqueue.
    """
    from hdrtv_tpu_torch.config import processing_dims
    from hdrtv_tpu_torch.pipeline.runner import processor_device

    w, h = processing_dims(resolution_key)
    device = processor_device(processor)

    frame_np = (np.random.RandomState(0).rand(h, w * 3) * 255).astype(np.uint8)
    put = getattr(processor, "put_frame", None)
    if put is not None:
        flat, base = put(frame_np), put(frame_np)
    else:
        flat, base = (torch.from_numpy(frame_np).to(device) for _ in range(2))

    def feedback(packed: torch.Tensor) -> torch.Tensor:
        # One-bit token from the output OR'd into the base frame: frame i+1's
        # input waits on frame i's output at one u8 pass. The u16 code is read
        # as int16 (the same bits; the bitwise ops take it on every device).
        tok = (packed.reshape(-1)[:1].view(torch.int16) & 1).to(torch.uint8)
        return base | tok

    _sync(device)
    t0 = time.perf_counter()
    out = processor.process_rgb48_device(flat)
    f = feedback(out)
    _ = out.reshape(-1)[:4].cpu()  # the first call: kernels built, graph captured
    compile_s = time.perf_counter() - t0

    _sync(device)
    t0 = time.perf_counter()
    for _ in range(frames):
        out = processor.process_rgb48_device(f)
        f = feedback(out)
    _ = out.reshape(-1)[:4].cpu()  # the final fetch completes the chain
    _sync(device)
    dt = (time.perf_counter() - t0) / max(1, frames)
    return {
        "device_fps": round(1.0 / dt, 2),
        "device_model_ms": round(dt * 1e3, 3),
        "frames": frames,
        "compile_s": round(compile_s, 1),
        "resolution": f"{w}x{h}",
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "methodology": "device-resident chained dispatches + final fetch "
                       "(excludes host<->device frame transfers)",
    }


def write_session(out_dir: str, result: PlaybackResult) -> None:
    """Reference session layout: summary.txt / session.json / runtime_metrics.csv
    under logs/playback_sessions/<ts>_<source>/ (gui_playback_logging.py:276-534)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "session.json"), "w") as f:
        json.dump(dataclasses.asdict(result), f, indent=2)
    with open(os.path.join(out_dir, "summary.txt"), "w") as f:
        f.write(
            f"fps={result.fps}\n1pct_low={result.fps_1pct_low}\n"
            f"model_ms={result.model_ms}\nframes={result.frames}\n"
            f"dropped={result.dropped}\nrealtime_factor={result.realtime_factor}\n"
            f"artifact_mb={result.artifact_mb}\n"
        )
    with open(os.path.join(out_dir, "runtime_metrics.csv"), "w", newline="") as f:
        if result.samples:
            # periodic sample rows (the reference's runtime sample CSV,
            # gui_playback_logging.py:276-338 schema subset)
            wr = csv.DictWriter(f, fieldnames=list(result.samples[0]))
            wr.writeheader()
            for s in result.samples:
                wr.writerow(s)
        else:
            wr = csv.writer(f)
            wr.writerow(["fps", "fps_1pct_low", "model_ms", "frames", "dropped", "realtime_factor"])
            wr.writerow(
                [result.fps, result.fps_1pct_low, result.model_ms, result.frames, result.dropped, result.realtime_factor]
            )


def run_batch(configs: list[PlaybackRunConfig], make_processor, root_dir: str) -> list[PlaybackResult]:
    """Batch sweep writing per-run sessions + batch CSVs.

    Layout mirrors the reference batch contract (README.md:1006-1018):
    per-run folders ``<resolution>_<preset>_<hg|nohg>/`` each holding
    ``summary.txt``/``session.json``/``runtime_metrics.csv``, plus
    ``playback_benchmark_summary.csv`` with a ``batch_summary.csv``
    compatibility copy (and this build's earlier ``batch.csv`` name)."""
    results = []
    os.makedirs(root_dir, exist_ok=True)
    for cfg in configs:
        proc = make_processor(cfg)
        preset = cfg.precision_key.replace(" ", "_").replace("(", "").replace(")", "")
        out = os.path.join(
            root_dir, f"{cfg.resolution_key}_{preset}_{'hg' if cfg.use_hg else 'nohg'}"
        )
        results.append(run_playback_benchmark(cfg, proc, out))
    rows = [
        ["resolution", "precision", "use_hg", "fps", "fps_1pct_low", "model_ms", "ring_ms", "frames", "dropped", "artifact_mb"]
    ]
    for r in results:
        c = r.config
        rows.append(
            [c["resolution_key"], c["precision_key"], c["use_hg"], r.fps, r.fps_1pct_low, r.model_ms, r.ring_ms, r.frames, r.dropped, r.artifact_mb]
        )
    for name in ("playback_benchmark_summary.csv", "batch_summary.csv", "batch.csv"):
        with open(os.path.join(root_dir, name), "w", newline="") as f:
            csv.writer(f).writerows(rows)
    return results
