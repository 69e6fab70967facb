"""Interactive playback shell — the headless-native GUI layer (the port's
copy of ``hdrtv_tpu/pipeline/shell.py``).

The reference wraps playback in a Qt MainWindow (play/pause, timeline seek,
precision/resolution settings with paused hot-swap, live metrics panel —
gui.py mixins, gui_timeline.py, gui_settings_preview.py). This framework is
headless-first, so the interactive surface is a terminal shell over the same
worker control API (:class:`~hdrtv_tpu_torch.pipeline.runner.PipelineRunner`
pause/resume/request_seek/request_precision_change/request_resolution_change).

``ShellController`` holds all behavior (key → control command, status-line
rendering, audio sync) as plain methods so it is testable without a tty;
``run_shell`` is the thin curses loop around it.

Keys: space pause/resume · ←/→ seek ∓5 s · ,/. seek ∓1 frame (paused scrub)
· p cycle precision · r cycle resolution · m mute toggle · q quit.
"""

from __future__ import annotations

import time

__all__ = ["ShellController", "run_shell"]

SEEK_STEP_S = 5.0


class ShellController:
    """Maps keys to runner control requests and renders the status line."""

    def __init__(
        self,
        runner,
        source,
        *,
        audio=None,
        precisions: tuple[str, ...] = ("fp16", "int8"),
        resolutions: tuple[str, ...] = ("540p", "720p", "1080p"),
        precision: str = "fp16",
        resolution: str = "1080p",
    ):
        self.runner = runner
        self.source = source
        self.audio = audio
        self.precisions = tuple(precisions)
        self.resolutions = tuple(resolutions)
        self.precision = precision
        self.resolution = resolution
        self.paused = False
        self.muted = False
        self.position_frame = 0
        self.quit_requested = False
        self.notice = ""
        self.last_metrics = None
        self.upscalers = ("ewa_lanczossharp", "fsr", "ssim_superres")
        self.upscaler = self.upscalers[0]

    # -- runner-side hooks ---------------------------------------------------

    def on_metrics(self, metrics) -> None:
        """PipelineRunner.on_metrics callback (0.2 s cadence)."""
        self.last_metrics = metrics
        self.position_frame = metrics.frames

    # -- key handling ----------------------------------------------------

    def handle_key(self, key: str) -> str | None:
        """Apply one key; returns the action taken (for the status line)."""
        if key == " ":
            return self.toggle_pause()
        if key in ("LEFT", "RIGHT"):
            return self.seek_relative(-SEEK_STEP_S if key == "LEFT" else SEEK_STEP_S)
        if key in (",", "."):
            return self.step_frame(-1 if key == "," else 1)
        if key == "p":
            return self.cycle_precision()
        if key == "r":
            return self.cycle_resolution()
        if key == "m":
            return self.toggle_mute()
        if key == "u":
            return self.cycle_upscaler()
        if key == "q":
            self.quit_requested = True
            self.runner.stop()
            return "quit"
        return None

    def toggle_pause(self) -> str:
        self.paused = not self.paused
        if self.paused:
            self.runner.pause()
            if self.audio is not None:
                self.audio.pause(True)
            return "paused"
        self.runner.resume()
        if self.audio is not None:
            self.audio.pause(False)
        return "resumed"

    def seek_relative(self, delta_s: float) -> str:
        fps = getattr(self.source, "fps", 30.0) or 30.0
        target = max(0, self.position_frame + int(round(delta_s * fps)))
        return self._seek(target)

    def step_frame(self, delta: int) -> str:
        """Single-frame scrub — meaningful while paused (paused-seek redraw,
        gui_timeline.py paused-seek queueing)."""
        return self._seek(max(0, self.position_frame + delta))

    def _seek(self, frame: int) -> str:
        self.position_frame = frame
        self.runner.request_seek(frame)
        if self.audio is not None:
            fps = getattr(self.source, "fps", 30.0) or 30.0
            self.audio.seek(frame / fps)
        return f"seek → frame {frame}"

    def cycle_precision(self) -> str:
        i = self.precisions.index(self.precision) if self.precision in self.precisions else -1
        self.precision = self.precisions[(i + 1) % len(self.precisions)]
        self.runner.request_precision_change(self.precision)
        return f"precision → {self.precision}"

    def cycle_resolution(self) -> str:
        from hdrtv_tpu_torch.config import processing_dims

        i = self.resolutions.index(self.resolution) if self.resolution in self.resolutions else -1
        self.resolution = self.resolutions[(i + 1) % len(self.resolutions)]
        self.runner.request_resolution_change(processing_dims(self.resolution))
        return f"resolution → {self.resolution}"

    def cycle_upscaler(self) -> str:
        """Pane-aware scale-kernel hot-swap (gui_mpv_widget.py:1317-1372):
        applied live over the sink's mpv IPC when the sink supports it."""
        i = self.upscalers.index(self.upscaler) if self.upscaler in self.upscalers else -1
        self.upscaler = self.upscalers[(i + 1) % len(self.upscalers)]
        sink = getattr(self.runner, "sink", None)
        applied = False
        for pane in (sink, getattr(sink, "hdr", None)):
            if pane is not None and hasattr(pane, "set_scale"):
                applied = pane.set_scale(self.upscaler)
                break
        return f"upscaler → {self.upscaler}" + ("" if applied else " (no mpv pane)")

    def toggle_mute(self) -> str:
        self.muted = not self.muted
        if self.audio is not None:
            self.audio.set_gain(0.0 if self.muted else 1.0)
        return "muted" if self.muted else "unmuted"

    # -- rendering ---------------------------------------------------------

    def status_line(self) -> str:
        """Live metrics panel in one line (the runtime-metrics dict fields,
        gui_pipeline_worker_runtime_metrics.py)."""
        m = self.last_metrics
        fps = f"{m.fps:5.1f}" if m else "  ---"
        frames = m.frames if m else 0
        dropped = m.dropped if m else 0
        fps_src = getattr(self.source, "fps", 30.0) or 30.0
        pos_s = self.position_frame / fps_src
        state = "PAUSED" if self.paused else "PLAY  "
        mute = " MUTE" if self.muted else ""
        return (
            f"[{state}] {pos_s:7.2f}s f{frames:<6d} fps {fps} drop {dropped:<4d} "
            f"{self.precision}/{self.resolution}{mute}  {self.notice}"
        )

    def help_line(self) -> str:
        return "space pause · ←/→ ±5s · ,/. ±1f · p precision · r resolution · u upscaler · m mute · q quit"


def status_interval_s() -> float:
    """Status-line refresh period: ``HDRTVNET_PLAYBACK_STATUS_MS`` (default
    900, floor 250 — gui_playback_runtime.py:234-238). Key polling stays
    fast; only the status text recomputes at this cadence."""
    from hdrtv_tpu_torch.utils.env import env_int

    return max(250, env_int("HDRTVNET_PLAYBACK_STATUS_MS", 900)) / 1000.0


def run_shell(controller: ShellController, *, refresh_s: float = 0.1) -> None:
    """Curses loop: render two lines, poll keys, forward to the controller.
    Returns when the controller quits or the runner finishes."""
    import curses

    def loop(scr):  # pragma: no cover - needs a tty; logic lives in the controller
        curses.curs_set(0)
        scr.nodelay(True)
        keymap = {curses.KEY_LEFT: "LEFT", curses.KEY_RIGHT: "RIGHT"}
        status_s = status_interval_s()
        status = controller.status_line()
        next_status = time.monotonic()
        while not controller.quit_requested:
            try:
                ch = scr.getch()
            except curses.error:
                ch = -1
            dirty = False
            if ch != -1:
                key = keymap.get(ch, chr(ch) if 0 <= ch < 256 else "")
                action = controller.handle_key(key)
                if action:
                    controller.notice = action
                dirty = True  # user input refreshes immediately
            now = time.monotonic()
            if dirty or now >= next_status:
                status = controller.status_line()
                next_status = now + status_s
            scr.erase()
            try:
                scr.addstr(0, 0, status)
                scr.addstr(1, 0, controller.help_line())
            except curses.error:
                pass  # terminal too small
            scr.refresh()
            time.sleep(refresh_s)

    curses.wrapper(loop)
