"""Display/output sinks for RGB48 HDR frames (the port's copy of
``hdrtv_tpu/pipeline/sinks.py``).

The reference's display is an embedded libmpv fed raw RGB48 over a Windows
named pipe, tagged ``primaries=bt.2020:gamma=pq``
(gui_mpv_widget.py:671-831, 996-1014). The delivery *contract* is kept —
rawvideo rgb48le at the source FPS with the BT.2020/PQ tag — re-hosted on
POSIX: a FIFO feeding an external mpv process (``MpvPipeSink``), a file sink
for golden captures, and a null sink for headless benchmarks
(cli_display.py:51 fallback ladder).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import threading
import time
import queue

import numpy as np


class NullSink:
    """Counts frames; the headless benchmark display."""

    def __init__(self):
        self.frames = 0
        self.bytes = 0

    def show(self, rgb48: np.ndarray, pts: float | None = None) -> None:
        self.frames += 1
        self.bytes += rgb48.nbytes

    def close(self) -> None:
        pass


class FileSink:
    """Raw rgb48le stream to a file (pipe-format golden captures)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self.frames = 0

    def show(self, rgb48: np.ndarray, pts: float | None = None) -> None:
        # uint16 native little-endian == rgb48le on every supported platform.
        self._f.write(np.ascontiguousarray(rgb48).tobytes())
        self.frames += 1

    def close(self) -> None:
        self._f.close()


class Y4MFileSink:
    """Playable file rung of the display ladder: ``*.y4m`` paths capture to
    YUV4MPEG2 at the export chain's intermediate format (4:2:2 10-bit
    limited BT.2020-NCL, bench/y4m.py) — mpv/ffmpeg open the result
    directly, with no binary needed to write it. Sized lazily from the
    first delivered frame (the processor letterboxes to processing dims)."""

    def __init__(self, path: str, fps: float = 30.0):
        self.path = path
        self.fps = fps
        self.frames = 0
        self._w = None

    def show(self, rgb48: np.ndarray, pts: float | None = None) -> None:
        if rgb48.ndim == 2:  # feeder delivers flat (H, 3W) u16 byte rows
            rgb48 = rgb48.reshape(rgb48.shape[0], rgb48.shape[1] // 3, 3)
        if self._w is None:
            from hdrtv_tpu_torch.bench.y4m import Y4MWriter

            h, w = rgb48.shape[:2]
            self._w = Y4MWriter(self.path, w, h, fps=self.fps, ctag="422p10")
        self._w.write_rgb_unit(
            rgb48.astype(np.float32) / 65535.0, matrix="bt2020nc"
        )
        self.frames += 1

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            # Y4M headers cannot carry PQ/BT.2020 tags — ship the same color
            # sidecar the export path writes so downstream ffmpeg/mpv use
            # doesn't silently default to bt709 (pipeline/export.py).
            import json

            from hdrtv_tpu_torch.pipeline.export import _y4m_sidecar

            with open(self.path + ".json", "w") as f:
                json.dump(_y4m_sidecar(self.path), f, indent=2)


def _quality_args(live: bool = False) -> list[str]:
    """Display-quality mpv options (env-configurable, the reference's
    deband/dither/tscale set — gui_mpv_widget.py:80-230 defaults)."""
    from hdrtv_tpu_torch.utils.env import env_bool, env_float, env_int, env_str

    args = []
    if env_bool("HDRTVNET_MPV_DEBAND", True):
        args += [
            "--deband=yes",
            f"--deband-iterations={env_int('HDRTVNET_MPV_DEBAND_ITERATIONS', 3, lo=1, hi=16)}",
            f"--deband-threshold={env_int('HDRTVNET_MPV_DEBAND_THRESHOLD', 100, lo=0, hi=4096)}",
            f"--deband-range={env_int('HDRTVNET_MPV_DEBAND_RANGE', 32, lo=1, hi=64)}",
            f"--deband-grain={env_int('HDRTVNET_MPV_DEBAND_GRAIN', 8, lo=0, hi=4096)}",
        ]
    if env_bool("HDRTVNET_MPV_DITHER", True):
        depth = env_str("HDRTVNET_MPV_DITHER_DEPTH", "10").strip() or "auto"
        if depth != "0":
            algo = env_str("HDRTVNET_MPV_DITHER_ALGO", "fruit").strip() or "fruit"
            args += [f"--dither-depth={depth}", f"--dither={algo}"]
            if algo == "fruit":
                args.append(
                    f"--dither-size-fruit={env_int('HDRTVNET_MPV_DITHER_SIZE_FRUIT', 6, lo=2, hi=8)}"
                )
            if env_bool("HDRTVNET_MPV_TEMPORAL_DITHER", True):
                args += [
                    "--temporal-dither=yes",
                    f"--temporal-dither-period={env_int('HDRTVNET_MPV_TEMPORAL_DITHER_PERIOD', 1, lo=1, hi=128)}",
                ]
    if live:
        # Live capture runs at a capped cadence; display-resample with
        # temporal blending smooths the low-FPS feed by default
        # (gui_mpv_widget.py:157-203: interpolation on, hermite tscale,
        # blur 1.4, radius 3.0; HDRTVNET_LIVE_MPV_* family)
        if env_bool("HDRTVNET_LIVE_MPV_INTERPOLATION", True):
            tscale = (env_str("HDRTVNET_LIVE_MPV_TSCALE", "hermite").strip() or "hermite").replace("-", "_")
            args += [
                "--video-sync=display-resample",
                "--interpolation=yes",
                f"--tscale={tscale}",
                f"--tscale-blur={env_float('HDRTVNET_LIVE_MPV_TSCALE_BLUR', 1.4, lo=0.0, hi=100.0)}",
                f"--tscale-radius={env_float('HDRTVNET_LIVE_MPV_TSCALE_RADIUS', 3.0, lo=0.0, hi=100.0)}",
            ]
    elif env_bool("HDRTVNET_MPV_INTERPOLATION", False):
        args += ["--interpolation=yes", "--tscale=oversample"]
    return args


def _drop_dither(args: list[str]) -> list[str]:
    return [a for a in args if not a.startswith(("--dither", "--temporal-dither"))]


def _drop_display_quality(args: list[str]) -> list[str]:
    return [
        a for a in args
        if not a.startswith(("--dither", "--temporal-dither", "--deband", "--interpolation", "--tscale"))
    ]


def _untimed_fallback(args: list[str]) -> list[str]:
    return _drop_display_quality(args) + ["--untimed", "--video-sync=desync"]


class MpvPipeSink:
    """External mpv fed raw RGB48 through a FIFO with the HDR tag contract.

    mpv args mirror the reference HDR pane: rawvideo demuxer,
    ``--vf=format=colorlevels=full:primaries=bt.2020:gamma=pq``
    (gui_mpv_widget.py:996-1014), plus the scale-kernel/antiring policy when
    an output size is given (gui_scaling.py:69-111 via pipeline/scaling.py).
    A writer thread decouples the 12 MB/frame pipe writes from the compute
    loop (named-pipe writer thread, :671-831).

    Startup uses the reference's fallback ladder (gui_mpv_widget.py:1027-1099):
    full quality options → without dither → without deband/dither → untimed
    desync — each retried when mpv exits during startup.
    """

    _RAW_FORMAT = "rgb48le"
    _VF = "format=colorlevels=full:primaries=bt.2020:gamma=pq"
    _HDR_PANE = True

    def __init__(
        self,
        width: int,
        height: int,
        fps: float,
        *,
        extra_args: tuple = (),
        drop_to_latest: bool = False,
        out_size: tuple[int, int] | None = None,
        upscaler: str | None = None,
        film_grain: bool = False,
        jitter_buffer_frames: int | None = None,
    ):
        if shutil.which("mpv") is None:
            raise RuntimeError("mpv not found on PATH")
        self.width, self.height, self.fps = width, height, fps
        self.drop_to_latest = drop_to_latest
        self.dropped = 0
        self.startup_notes: list[str] = []
        self._dir = tempfile.mkdtemp(prefix="hdrtv_mpv_")
        self.fifo = os.path.join(self._dir, "video.fifo")
        os.mkfifo(self.fifo)
        self.ipc_path = os.path.join(self._dir, "mpv.sock")
        self.hdr_confirmed = False

        scale_args: list[str] = []
        vf = self._VF
        if out_size is not None:
            from hdrtv_tpu_torch.pipeline.scaling import (
                mpv_scale_args, select_cas_strength, select_scale_kernel,
            )

            # Film grain rides the HDR pane's shader chain only; the SDR
            # comparison pane gets the plain kernel policy
            # (gui_mpv_widget.py:935, 1008-1014).
            scale_args = mpv_scale_args(
                width, height, out_size[0], out_size[1], upscaler,
                film_grain=film_grain and self._HDR_PANE, hdr=self._HDR_PANE,
            )
            # CAS sharpening joins the vf chain when the policy calls for it
            # (gui_mpv_widget.py:998-1000; zero under FSR/SSim/no-upscale)
            kern = select_scale_kernel(width, height, out_size[0], out_size[1], upscaler)
            cas = select_cas_strength(
                width, height, out_size[0], out_size[1],
                using_fsr=(kern == "fsr"), scale_kernel=kern,
            )
            if cas > 0:
                vf = f"{vf},cas={cas:.2f}"
        base = [
            "--no-config",
            f"--input-ipc-server={self.ipc_path}",
            "--demuxer=rawvideo",
            f"--demuxer-rawvideo-w={width}",
            f"--demuxer-rawvideo-h={height}",
            f"--demuxer-rawvideo-fps={fps}",
            f"--demuxer-rawvideo-mp-format={self._RAW_FORMAT}",
            f"--vf={vf}",
            "--keep-open=no",
            *scale_args,
            *extra_args,
        ]
        if jitter_buffer_frames:
            # live jitter buffer: short pipe-write stalls repeat a frame
            # instead of underflowing (HDRTVNET_LIVE_CAPTURE_MPV_BUFFER_FRAMES,
            # reference README live-capture tuning)
            frame_bytes = width * height * 6
            base += [
                f"--demuxer-max-bytes={jitter_buffer_frames * frame_bytes}",
                f"--demuxer-readahead-secs={jitter_buffer_frames / max(fps, 1.0):.3f}",
            ]
        quality = _quality_args(live=drop_to_latest)
        ladders = [
            (quality, None),
            (_drop_dither(quality), "mpv dither unavailable; continuing without display dither"),
            (_drop_display_quality(quality), "mpv deband/dither unavailable; continuing without display quality filters"),
            (_untimed_fallback(quality), "mpv vsync/display-quality startup fallback active; using low-latency untimed display"),
        ]
        last_exc: Exception | None = None
        self.proc = None
        self._fifo_fd = None
        for opts, note in ladders:
            try:
                self.proc = self._spawn(base + opts)
                self._fifo_fd = self._open_fifo()
                if note:
                    self.startup_notes.append(note)
                break
            except RuntimeError as exc:
                last_exc = exc
                self._kill_proc()  # no orphan may outlive its ladder rung
                self.proc = None
        if self.proc is None or self._fifo_fd is None:
            shutil.rmtree(self._dir, ignore_errors=True)
            raise RuntimeError(f"mpv startup failed: {last_exc}")

        self._queue: queue.Queue = queue.Queue(maxsize=3)
        self._stop = threading.Event()
        self._writer = threading.Thread(target=self._write_loop, daemon=True, name="mpv-pipe-writer")
        self._writer.start()
        self.frames = 0
        self._ipc_sock = None
        self._ipc_req = 0
        self._ipc_lock = threading.Lock()  # monitor thread + hot-swap share the socket
        # HDR-confirmation monitor: poll mpv's actual VO output params until
        # BT.2020+PQ is confirmed (gui_mpv_widget.py:1145-1185)
        self._monitor = threading.Thread(target=self._hdr_monitor, daemon=True, name="mpv-hdr-monitor")
        self._monitor.start()

    def _ipc_get(self, prop: str, timeout: float = 1.0):
        """mpv JSON-IPC get_property; None on any failure (IPC is advisory —
        the video path never depends on it)."""
        with self._ipc_lock:
            return self._ipc_get_locked(prop, timeout)

    def _ipc_get_locked(self, prop: str, timeout: float = 1.0):
        import json
        import socket

        try:
            if self._ipc_sock is None:
                if not os.path.exists(self.ipc_path):
                    return None
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.settimeout(timeout)
                s.connect(self.ipc_path)
                self._ipc_sock = s
                self._ipc_buf = b""
            self._ipc_req += 1
            rid = self._ipc_req
            msg = json.dumps({"command": ["get_property", prop], "request_id": rid})
            self._ipc_sock.sendall(msg.encode() + b"\n")
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                if b"\n" in self._ipc_buf:
                    line, self._ipc_buf = self._ipc_buf.split(b"\n", 1)
                    try:
                        obj = json.loads(line)
                    except ValueError:
                        continue
                    if obj.get("request_id") == rid:
                        return obj.get("data") if obj.get("error") == "success" else None
                    continue  # events / other replies
                chunk = self._ipc_sock.recv(4096)
                if not chunk:
                    break
                self._ipc_buf += chunk
        except OSError:
            self._ipc_sock = None
        return None

    def _ipc_set(self, prop: str, value) -> bool:
        import json

        with self._ipc_lock:
            try:
                if self._ipc_sock is None:
                    self._ipc_get_locked("mpv-version")  # establishes the connection
                if self._ipc_sock is None:
                    return False
                self._ipc_sock.sendall(
                    json.dumps({"command": ["set_property", prop, value]}).encode() + b"\n"
                )
                return True
            except OSError:
                self._ipc_sock = None
                return False

    def set_scale(self, upscaler: str | None, *, out_size: tuple[int, int] | None = None,
                  film_grain: bool = False) -> bool:
        """Pane-aware scale-kernel hot-swap over IPC (gui_mpv_widget.py:
        1317-1372): recompute the kernel/antiring/shader-chain policy for the
        new upscaler and apply it to the running mpv without restarting."""
        from hdrtv_tpu_torch.pipeline.scaling import mpv_scale_args

        ow, oh = out_size or (self.width, self.height)
        args = mpv_scale_args(
            self.width, self.height, ow, oh, upscaler,
            film_grain=film_grain and self._HDR_PANE, hdr=self._HDR_PANE,
        )
        ok = True
        shaders = [a.split("=", 1)[1] for a in args if a.startswith("--glsl-shader=")]
        ok &= self._ipc_set("glsl-shaders", ":".join(shaders))
        for a in args:
            if a.startswith("--glsl-shader="):
                continue
            prop, val = a[2:].split("=", 1)
            ok &= self._ipc_set(prop, val)
        return bool(ok)

    def hdr_info(self) -> dict:
        """VO output color snapshot (_build_hdr_info_snapshot role,
        gui_mpv_widget.py:390-420): primaries/gamma/levels from
        video-out-params + the BT.2020/PQ confirmation flag."""
        vop = self._ipc_get("video-out-params") or {}
        info = {
            "primaries": str(vop.get("primaries", "")),
            "gamma": str(vop.get("gamma", "")),
            "levels": str(vop.get("colorlevels", vop.get("levels", ""))),
        }
        info["hdr_vo_confirmed"] = (
            "2020" in info["primaries"] and info["gamma"] in ("pq", "smpte2084")
        )
        return info

    def _hdr_monitor(self) -> None:
        from hdrtv_tpu_torch.utils.env import env_bool

        diag = env_bool("HDRTVNET_MPV_DIAG", False)
        printed = False
        while not self._stop.is_set():
            time.sleep(0.5)
            if self.proc is None or self.proc.poll() is not None:
                return
            if self.frames == 0:
                continue  # VO params exist only once frames flow
            info = self.hdr_info()
            if info["hdr_vo_confirmed"]:
                self.hdr_confirmed = True
                if diag and not printed:
                    print(f"[mpv] VO confirms BT.2020+PQ output: {info}")
                    printed = True
                return

    def _spawn(self, args: list[str]) -> subprocess.Popen:
        from hdrtv_tpu_torch.utils.env import env_bool

        # HDRTVNET_MPV_DIAG keeps mpv's own output for debugging instead of
        # discarding it (cli_display.py:149, gui_benchmark.py:169)
        if env_bool("HDRTVNET_MPV_DIAG", False):
            log = open(os.path.join(self._dir, "mpv.log"), "ab")
            out = err = log
        else:
            out = err = subprocess.DEVNULL
        return subprocess.Popen(
            ["mpv", *args, self.fifo],
            stdin=subprocess.DEVNULL,
            stdout=out,
            stderr=err,
        )

    def _open_fifo(self, timeout: float = 10.0):
        """Open the FIFO write end without hanging if mpv dies on startup:
        non-blocking attempts until the reader appears, watching the
        process."""
        import errno
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(f"mpv exited during startup (rc={self.proc.returncode})")
            try:
                fd = os.open(self.fifo, os.O_WRONLY | os.O_NONBLOCK)
                os.set_blocking(fd, True)
                return os.fdopen(fd, "wb")
            except OSError as exc:
                if exc.errno != errno.ENXIO:
                    # Kill the just-spawned mpv before failing this ladder
                    # rung: an orphan holding the FIFO would corrupt the next
                    # rung's open attempt (and leak a process).
                    self._kill_proc()
                    raise RuntimeError(str(exc)) from exc
                time.sleep(0.02)
        self._kill_proc()
        raise RuntimeError("mpv never opened the video pipe")

    def _kill_proc(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                self.proc.kill()

    def _write_loop(self):
        while not self._stop.is_set():
            try:
                buf = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if buf is None:
                break
            try:
                self._fifo_fd.write(buf)
            except Exception:
                # Any write failure (EPIPE on mpv exit, fd closed by a racing
                # close(), other OSError) must set _stop — producers gate on
                # it; a silently-dead writer would leave them blocked in put.
                self._stop.set()

    def show(self, rgb48: np.ndarray, pts: float | None = None) -> None:
        if self._stop.is_set():
            return
        buf = np.ascontiguousarray(rgb48).tobytes()
        if self.drop_to_latest:
            # Live mode: a slow display must not stall the pipeline — drop
            # the oldest queued frame instead (drop-to-latest feeder policy,
            # gui_pipeline_worker_feeders.py:73-104).
            while True:
                try:
                    self._queue.put_nowait(buf)
                    break
                except queue.Full:
                    try:
                        self._queue.get_nowait()
                        self.dropped += 1
                    except queue.Empty:
                        pass
        else:
            # File-paced playback: backpressure is correct, but it must stay
            # interruptible — if mpv dies while we hold a full queue, the
            # writer thread exits without draining and an unconditional put
            # would block this producer forever.
            while not self._stop.is_set():
                try:
                    self._queue.put(buf, timeout=0.1)
                    break
                except queue.Full:
                    continue
        self.frames += 1

    def close(self) -> None:
        try:
            self._queue.put(None, timeout=0.2)
        except queue.Full:
            self._stop.set()
        self._writer.join(timeout=2.0)
        self._stop.set()  # ends the HDR monitor
        if self._ipc_sock is not None:
            try:
                self._ipc_sock.close()
            except OSError:
                pass
            self._ipc_sock = None
        try:
            self._fifo_fd.close()
        except Exception:
            pass
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        shutil.rmtree(self._dir, ignore_errors=True)


class SdrMpvPipeSink(MpvPipeSink):
    """SDR comparison pane: raw rgb24 tagged bt.709/bt.1886
    (gui_mpv_widget.py:364-366, 1008-1014 SDR pane flag set)."""

    _RAW_FORMAT = "rgb24"
    _VF = "format=colorlevels=full:primaries=bt.709:gamma=bt.1886"
    _HDR_PANE = False


class SideBySideSink:
    """HDR pane + SDR source pane fed in lockstep — the reference's
    side-by-side tab (gui_windowing.py SDR/HDR panes; both panes receive
    their streams from the same worker loop).

    ``show`` takes the processed RGB48 frame; ``show_sdr`` takes the source
    BGR frame (the runner routes it when the sink exposes this method).
    """

    def __init__(self, width: int, height: int, fps: float, **kw):
        self.hdr = MpvPipeSink(width, height, fps, **kw)
        try:
            self.sdr = SdrMpvPipeSink(width, height, fps, **kw)
        except Exception:
            self.hdr.close()
            raise
        self.frames = 0

    def show(self, rgb48: np.ndarray, pts: float | None = None) -> None:
        self.hdr.show(rgb48, pts)
        self.frames += 1

    def show_sdr(self, frame_bgr: np.ndarray, pts: float | None = None) -> None:
        # The SDR pane displays the *source*: BGR→RGB byte flip only.
        self.sdr.show(np.ascontiguousarray(frame_bgr[..., ::-1]), pts)

    def close(self) -> None:
        self.hdr.close()
        self.sdr.close()


def make_sink(
    kind: str, width: int, height: int, fps: float, path: str | None = None, *, live: bool = False,
    out_size: tuple[int, int] | None = None, upscaler: str | None = None,
    film_grain: bool = False,
):
    """Sink factory with the reference's fallback ladder: mpv → file → null.

    ``live=True`` selects the live-feeder delivery policy (drop-to-latest
    instead of backpressure — gui_pipeline_worker_feeders.py:73-104).
    ``out_size``/``upscaler``/``film_grain`` drive the display scale policy
    + shader chain on the mpv sinks (gui_scaling.py:69-157,
    gui_mpv_widget.py:371-388)."""
    from hdrtv_tpu_torch.utils.env import env_bool

    kind = (kind or "null").lower()
    if kind in ("mpv", "side-by-side") and env_bool("HDRTVNET_DISABLE_MPV", False):
        # forced mpv bypass (gui_playback_runtime.py:3484-3488) — fall
        # straight to the file/null rungs of the ladder
        kind = "file" if path else "null"
    if kind in ("mpv", "side-by-side"):
        from hdrtv_tpu_torch.utils.env import env_int

        cls = SideBySideSink if kind == "side-by-side" else MpvPipeSink
        kwargs = {}
        if out_size is not None:
            kwargs.update(out_size=out_size, upscaler=upscaler, film_grain=film_grain)
        if live and cls is MpvPipeSink:
            kwargs["jitter_buffer_frames"] = env_int(
                "HDRTVNET_LIVE_CAPTURE_MPV_BUFFER_FRAMES", 8, lo=1, hi=64
            )
        try:
            return cls(width, height, fps, drop_to_latest=live, **kwargs)
        except Exception:
            # mpv rung failed: take the FILE rung when a capture path was
            # requested (matching the explicit DISABLE_MPV branch above) —
            # skipping straight to null would silently discard the capture.
            kind = "file" if path else "null"
    if kind == "file":
        out = path or "out.rgb48"
        if out.lower().endswith(".y4m"):
            return Y4MFileSink(out, fps=fps)
        return FileSink(out)
    return NullSink()
