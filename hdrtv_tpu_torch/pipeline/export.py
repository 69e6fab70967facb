"""HDR10 export — gui_export.py equivalent (the port's counterpart of
``hdrtv_tpu/pipeline/export.py``).

The reference exports ProRes 422 HQ masters by piping RGB48 into FFmpeg with
``deband → zscale (matrixin=gbr, transferin=smpte2084, primariesin=bt2020 →
bt2020nc/smpte2084/limited, dither=error_diffusion, npl=1001) → yuv422p10le``
plus prores_ks profile 3 and the prores_metadata BSF (gui_export.py:948-1023),
with a bounded writer-queue thread (:1038-1067).

This module keeps that exact FFmpeg contract when ffmpeg is on PATH, and
degrades where it isn't: a raw ``.rgb48`` stream + sidecar JSON, or a 16-bit
PNG frame sequence, or a y4m master — lossless HDR masters that ffmpeg can
containerize later with the same filter chain (emitted into the sidecar for
reproducibility).

On a CUDA device every frame goes through ``put_frame`` (a pinned staging
slot, copied on the processor's H2D stream) and ``process_rgb48_device`` (the
frame signature's CUDA graph, replayed on the export's compute stream), and
its output is copied on a D2H stream into a pinned slot of a ring of
``queue_depth + 2`` (``runtime/transfer.py``): ``queue_depth`` queued for the
writer thread, one being written, one being filled. The writer waits on the
slot's copy event, writes, and returns the slot; the loop waits for a free
slot. The writer is sized from the first processed frame. ``batch > 1`` runs
``process_rgb48_batch``: with ``use_mesh``, each full batch split over the
data axis of ``parallel/mesh.py make_mesh()`` (every visible card), the last
partial one without a mesh, as in the JAX package.

``export_video_multihost`` is the multi-host farm: each host exports its
contiguous frame range (``parallel/multihost.py plan_frame_ranges``) to a
segment and marks it ``.done``; host 0 waits for every marker and
reassembles: raw segments appended byte for byte, y4m segments with every
header after the first dropped, other codecs by ffmpeg's concat demuxer
(where ``ffmpeg`` exists).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import queue
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from hdrtv_tpu_torch.runtime import transfer


def ffmpeg_hdr10_command(
    width: int,
    height: int,
    fps: float,
    output: str,
    *,
    codec: str = "prores",
    peak_nits: int = 1001,
    audio_source: str | None = None,
) -> list[str]:
    """The reference export FFmpeg invocation (gui_export.py:948-1023)."""
    vf = (
        "deband,"
        "zscale=matrixin=gbr:transferin=smpte2084:primariesin=bt2020:"
        "matrix=bt2020nc:transfer=smpte2084:primaries=bt2020:range=limited:"
        f"dither=error_diffusion:npl={peak_nits},"
        "format=yuv422p10le"
    )
    cmd = [
        "ffmpeg", "-y",
        "-f", "rawvideo",
        "-pix_fmt", "rgb48le",
        "-s", f"{width}x{height}",
        "-r", f"{fps}",
        "-i", "pipe:0",
    ]
    if audio_source:
        cmd += ["-i", audio_source, "-map", "0:v", "-map", "1:a?", "-c:a", "pcm_s16le"]
    cmd += ["-vf", vf]
    if codec == "prores":
        cmd += [
            "-c:v", "prores_ks", "-profile:v", "3",
            "-bsf:v", "prores_metadata=color_primaries=bt2020:color_trc=smpte2084:colorspace=bt2020nc",
        ]
    elif codec == "hevc":
        cmd += [
            "-c:v", "libx265", "-crf", "16", "-preset", "medium",
            "-x265-params",
            "hdr10=1:colorprim=bt2020:transfer=smpte2084:colormatrix=bt2020nc",
            "-pix_fmt", "yuv420p10le",
        ]
    cmd += [
        "-color_primaries", "bt2020",
        "-color_trc", "smpte2084",
        "-colorspace", "bt2020nc",
        output,
    ]
    return cmd


@dataclasses.dataclass
class ExportConfig:
    output: str = "export.mov"
    resolution_key: str = "1080p"
    codec: str = "prores"  # prores | hevc | raw | png16 | y4m
    peak_nits: int = 1001
    queue_depth: int = 3  # bounded writer queue (gui_export.py:1038-1067)
    audio_source: str | None = None
    batch: int = 1  # frames per process_rgb48_batch call when > 1
    use_mesh: bool = False  # with batch > 1: each full batch over make_mesh()'s data axis


class _FfmpegWriter:
    def __init__(self, cfg: ExportConfig, width: int, height: int, fps: float):
        self.proc = subprocess.Popen(
            ffmpeg_hdr10_command(
                width, height, fps, cfg.output,
                codec=cfg.codec, peak_nits=cfg.peak_nits, audio_source=cfg.audio_source,
            ),
            stdin=subprocess.PIPE,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )

    def write(self, rgb48: np.ndarray):
        self.proc.stdin.write(np.ascontiguousarray(rgb48).tobytes())

    def close(self):
        self.proc.stdin.close()
        rc = self.proc.wait(timeout=120)
        if rc != 0:
            # An encode that fails at container finalize (moov write, BSF
            # error) leaves a truncated file — must not report success.
            raise RuntimeError(f"ffmpeg exited rc={rc} while finalizing the container")


class _RawWriter:
    def __init__(self, cfg: ExportConfig, width: int, height: int, fps: float):
        self.path = cfg.output if cfg.output.endswith(".rgb48") else cfg.output + ".rgb48"
        self._f = open(self.path, "wb")
        sidecar = {
            "format": "rgb48le",
            "width": width,
            "height": height,
            "fps": fps,
            "color": {"primaries": "bt2020", "transfer": "smpte2084", "range": "full"},
            "containerize_with": " ".join(
                ffmpeg_hdr10_command(width, height, fps, cfg.output, codec="prores", peak_nits=cfg.peak_nits)
            ).replace("pipe:0", self.path),
        }
        with open(self.path + ".json", "w") as f:
            json.dump(sidecar, f, indent=2)

    def write(self, rgb48: np.ndarray):
        self._f.write(np.ascontiguousarray(rgb48).tobytes())

    def close(self):
        self._f.close()


def _y4m_sidecar(path: str) -> dict:
    """Color/containerize sidecar for a y4m master at ``path`` (Y4M headers
    cannot carry PQ/BT.2020 tags)."""
    return {
        "format": "y4m yuv422p10le limited",
        "color": {"primaries": "bt2020", "transfer": "smpte2084", "matrix": "bt2020nc"},
        "containerize_with": (
            f"ffmpeg -y -i {path} -c:v prores_ks -profile:v 3 "
            "-color_primaries bt2020 -color_trc smpte2084 -colorspace bt2020nc "
            + os.path.splitext(path)[0] + ".mov"
        ),
    }


class _Y4MWriter:
    """Binary-free playable master: YUV4MPEG2 at the reference chain's
    intermediate format — 4:2:2 10-bit limited-range BT.2020-NCL
    (ffmpeg_hdr10_command's ``format=yuv422p10le`` + matrix/range tags).
    ffmpeg/mpv read the result directly; a sidecar carries the PQ/BT.2020
    tags Y4M headers cannot, plus the lossless containerize command."""

    def __init__(self, cfg: ExportConfig, width: int, height: int, fps: float):
        from hdrtv_tpu_torch.bench.y4m import Y4MWriter

        # case-insensitive to match export_video_multihost's suffix check
        self.path = cfg.output if cfg.output.lower().endswith(".y4m") else os.path.splitext(cfg.output)[0] + ".y4m"
        self._w = Y4MWriter(self.path, width, height, fps=fps, ctag="422p10")
        with open(self.path + ".json", "w") as f:
            json.dump(_y4m_sidecar(self.path), f, indent=2)

    def write(self, rgb48: np.ndarray):
        self._w.write_rgb_unit(rgb48.astype(np.float32) / 65535.0, matrix="bt2020nc")

    def close(self):
        self._w.close()


class _Png16Writer:
    def __init__(self, cfg: ExportConfig, width: int, height: int, fps: float):
        import cv2

        self._cv2 = cv2
        self.dir = cfg.output if not os.path.splitext(cfg.output)[1] else os.path.splitext(cfg.output)[0]
        os.makedirs(self.dir, exist_ok=True)
        self.idx = 0

    def write(self, rgb48: np.ndarray):
        bgr = rgb48[..., ::-1]
        self._cv2.imwrite(os.path.join(self.dir, f"frame_{self.idx:06d}.png"), bgr)
        self.idx += 1

    def close(self):
        pass


class _RangeSource:
    """A source bounded to frame range [start, end): one host's part of the
    multi-host export farm (frame ranges from ``parallel/multihost.py``)."""

    def __init__(self, source, start: int, end: int):
        self._src = source
        self._limit = max(0, end - start)
        self._n = 0
        if start:
            source.seek(start)
        self.width = getattr(source, "width", None)
        self.height = getattr(source, "height", None)
        self.fps = getattr(source, "fps", 30.0)

    def read_with_meta(self, timeout: float = 5.0):
        if self._n >= self._limit:
            return None
        meta = self._src.read_with_meta()
        if meta is None:
            return None
        self._n += 1
        return meta

    def close(self):
        self._src.close()


def export_video_multihost(
    video_path: str | None,
    processor,
    cfg: ExportConfig,
    *,
    hosts: int,
    host_id: int,
    source=None,
    wait_timeout: float = 900.0,
) -> dict:
    """Multi-host export farm: each host exports its contiguous frame range
    to a segment; host 0 reassembles once every segment is complete.

    No activations cross hosts (frames are independent): the only shared
    artifact is the final concatenation, lossless (byte append for the raw
    master, header-stripped append for y4m, FFmpeg's concat demuxer stream
    copy for the containers: ``parallel/multihost.py``). ``.done`` markers
    gate the reassembly, so a partial segment is never read."""
    from hdrtv_tpu_torch.parallel.multihost import concat_command, plan_frame_ranges, segment_paths
    from hdrtv_tpu_torch.pipeline.source import SyntheticSource, VideoSource

    if not 0 <= host_id < hosts:
        raise ValueError(f"host_id {host_id} outside [0, {hosts})")
    if source is None:
        from hdrtv_tpu_torch.config import processing_dims

        source = VideoSource(video_path) if video_path else SyntheticSource(*processing_dims(cfg.resolution_key))
    n_frames = getattr(source, "frame_count", None) or getattr(source, "frames", 0)
    if int(n_frames) <= 0:
        # cv2 may report 0 frames for some containers: a farm planned from
        # that would "succeed" with an empty master.
        raise ValueError(
            f"multi-host export needs a source with a known frame count (got {n_frames!r}); "
            "use single-host export, which reads to EOF"
        )
    start, end = plan_frame_ranges(int(n_frames), hosts)[host_id]

    codec = cfg.codec
    if codec in ("prores", "hevc") and shutil.which("ffmpeg") is None:
        codec = "raw"
    if codec == "y4m" and not cfg.output.lower().endswith(".y4m"):
        cfg = dataclasses.replace(cfg, output=os.path.splitext(cfg.output)[0] + ".y4m")
    segs = segment_paths(cfg.output, hosts)
    seg_out = segs[host_id] + (".rgb48" if codec == "raw" else "")
    stats = export_video(
        None, processor, dataclasses.replace(cfg, output=segs[host_id], codec=codec),
        source=_RangeSource(source, start, end),
    )
    stats.update(host_id=host_id, hosts=hosts, frame_range=[start, end])
    with open(seg_out + ".done", "w") as f:
        json.dump(stats, f)

    if host_id != 0:
        return stats

    # Host 0: wait for every segment's .done marker, then reassemble.
    seg_files = [s + (".rgb48" if codec == "raw" else "") for s in segs]
    deadline = time.monotonic() + wait_timeout
    for seg in seg_files:
        while not os.path.exists(seg + ".done"):
            if time.monotonic() > deadline:
                raise TimeoutError(f"segment never completed: {seg}")
            time.sleep(0.2)
    if codec == "raw":
        final = cfg.output if cfg.output.endswith(".rgb48") else cfg.output + ".rgb48"
        with open(final, "wb") as out_f:
            for seg in seg_files:
                with open(seg, "rb") as f:
                    shutil.copyfileobj(f, out_f)
        with open(seg_files[0] + ".json") as f:
            sidecar = json.load(f)
        # The segment's containerize command names the seg000 path: rebuild
        # it for the joined master (dims and fps from the segment's sidecar).
        sidecar["containerize_with"] = " ".join(
            ffmpeg_hdr10_command(
                sidecar["width"], sidecar["height"], sidecar["fps"],
                cfg.output, codec="prores", peak_nits=cfg.peak_nits,
            )
        ).replace("pipe:0", final)
        with open(final + ".json", "w") as f:
            json.dump(sidecar, f, indent=2)
        stats["output"] = final
    elif codec == "y4m":
        # y4m segments share one fixed-stride stream header: dropping the
        # header line of every segment after the first makes the byte
        # concatenation lossless (frame records are self-delimiting).
        final = cfg.output
        with open(final, "wb") as out_f:
            for i, seg in enumerate(seg_files):
                with open(seg, "rb") as f:
                    if i:
                        f.readline()
                    shutil.copyfileobj(f, out_f)
        with open(final + ".json", "w") as f:
            json.dump(_y4m_sidecar(final), f, indent=2)  # not the segment's
        stats["output"] = final
    else:
        list_path = cfg.output + ".segments.txt"
        cmd = concat_command(seg_files, cfg.output, list_path)
        subprocess.run(cmd, check=True, capture_output=True)
        stats["output"] = cfg.output
    stats["concatenated"] = True
    return stats


def _hw3(a: np.ndarray) -> np.ndarray:
    """An RGB48 frame in any of the processor's layouts ((Hb, 2, Wb, 6) pair
    planes, (H, 3W) rows, (H, W, 3)) as (H, W, 3), a view."""
    if a.ndim == 4:
        hb, _, wb, _ = a.shape
        return a.reshape(2 * hb, 2 * wb, 3)
    if a.ndim == 2:
        return a.reshape(a.shape[0], a.shape[1] // 3, 3)
    return a


def export_video(video_path: str | None, processor, cfg: ExportConfig, *, source=None) -> dict:
    """Flat-out export: decode → model → RGB48 → writer thread → container.

    Returns stats {frames, seconds, fps, output, codec}.
    """
    from hdrtv_tpu_torch.config import processing_dims
    from hdrtv_tpu_torch.pipeline.runner import processor_device
    from hdrtv_tpu_torch.pipeline.source import SyntheticSource, VideoSource

    if source is None:
        source = VideoSource(video_path) if video_path else SyntheticSource(*processing_dims(cfg.resolution_key))
    w = getattr(source, "width", None) or processing_dims(cfg.resolution_key)[0]
    h = getattr(source, "height", None) or processing_dims(cfg.resolution_key)[1]
    fps = getattr(source, "fps", 30.0)

    codec = cfg.codec
    if codec in ("prores", "hevc") and shutil.which("ffmpeg") is None:
        codec = "raw"  # fallback ladder: no ffmpeg → raw master + sidecar
    writer_cls = {
        "prores": _FfmpegWriter,
        "hevc": _FfmpegWriter,
        "raw": _RawWriter,
        "png16": _Png16Writer,
        "y4m": _Y4MWriter,
    }[codec]
    wcfg = dataclasses.replace(cfg, codec=codec)
    # The writer is sized from the FIRST PROCESSED FRAME, not the source:
    # with a processing resolution set the processor letterboxes on device
    # and emits frames at processing dims (runtime/processor.py
    # process_rgb48), so source dims would corrupt fixed-stride outputs
    # (ffmpeg rawvideo -s, y4m strides) and falsify the raw sidecar.
    writer_box: list = []

    def _ensure_writer(fh: int, fw: int):
        if not writer_box:
            writer_box.append(writer_cls(wcfg, fw, fh, fps))
        return writer_box[0]

    device = processor_device(processor)
    cuda = device.type == "cuda"
    ring = transfer.HostRing(cfg.queue_depth + 2, pinned=cuda)
    compute = torch.cuda.Stream(device) if cuda else None
    d2h = torch.cuda.Stream(device) if cuda else None

    q: queue.Queue = queue.Queue(maxsize=cfg.queue_depth)
    error: list[Exception] = []

    def write_loop():
        while True:
            item = q.get()
            if item is None:
                return
            slot = item if isinstance(item, transfer.HostSlot) else None
            try:
                buf = _hw3(slot.array() if slot is not None else item)
                _ensure_writer(buf.shape[0], buf.shape[1]).write(buf)
            except Exception as e:  # keep draining to unblock producer
                error.append(e)
            finally:
                if slot is not None:
                    ring.release(slot)

    wt = threading.Thread(target=write_loop, daemon=True, name="export-writer")
    wt.start()

    # Warm up the signature put_frame gives this size (pair planes or flat
    # rows), so that the first real frame replays the graph.
    processor.warmup_compile(w, h)
    put = getattr(processor, "put_frame", None)
    mesh = None
    if cfg.use_mesh and cfg.batch > 1:
        from hdrtv_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(devices=None if cuda else [device])
    frames = 0
    t0 = time.monotonic()
    with torch.cuda.stream(compute) if cuda else contextlib.nullcontext():
        if cfg.batch > 1 and hasattr(processor, "process_rgb48_batch"):
            # Frames in batches (export throughput): process_rgb48_batch runs
            # them one by one and copies the batch back once; with a mesh a
            # full batch splits over its data axis.
            pending: list[np.ndarray] = []
            while True:
                meta = source.read_with_meta()
                if meta is not None:
                    pending.append(meta[0])
                if (meta is None and pending) or len(pending) == cfg.batch:
                    full = len(pending) == cfg.batch
                    outs = processor.process_rgb48_batch(np.stack(pending), mesh=mesh if full else None)
                    for o in outs:
                        q.put(o)
                    frames += len(pending)
                    pending = []
                if meta is None:
                    break
        else:
            while True:
                meta = source.read_with_meta()
                if meta is None:
                    break
                frame = meta[0]
                flat = np.ascontiguousarray(frame).reshape(frame.shape[0], -1)
                out = processor.process_rgb48_device(put(flat) if put is not None else torch.from_numpy(flat))
                slot = ring.acquire()
                q.put(transfer.copy_out(out, slot, d2h))
                frames += 1
    q.put(None)
    wt.join(timeout=60)
    if wt.is_alive():
        if not writer_box:
            # Never size a writer while the thread may still construct one
            # from a frame (source dims would corrupt a fixed-stride
            # container) — only this pre-construction window is a race.
            raise RuntimeError("export writer thread stalled (>60s past last frame)")
        # Writer exists: a slow disk flushing a deep backlog is healthy,
        # not a failure — wait it out (the thread exits on the sentinel).
        wt.join()
    # Finalize order matters: the in-run error (error[0]) is the root cause
    # and must win over any close()-time exception; source.close() must run
    # regardless (decode thread + capture leak otherwise); and when every
    # write failed, don't construct a fresh writer just to close it.
    writer = writer_box[0] if writer_box else None
    close_err: Exception | None = None
    try:
        if writer is None and not error:
            writer = _ensure_writer(h, w)  # zero-frame source: still emit the container
        if writer is not None:
            try:
                writer.close()
            except Exception as e:
                close_err = e
    finally:
        source.close()
    dt = time.monotonic() - t0
    if error:
        raise error[0]
    if close_err is not None:
        raise close_err
    return {
        "frames": frames,
        "seconds": round(dt, 2),
        "fps": round(frames / dt, 2) if dt > 0 else 0.0,
        "output": getattr(writer, "path", cfg.output),
        "codec": codec,
    }
