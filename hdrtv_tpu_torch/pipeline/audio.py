"""Audio attach + auto-mute policy + the mpv audio player binding (the
port's copy of ``hdrtv_tpu/pipeline/audio.py``).

The reference attaches a Qt audio track to playback and auto-mutes when
pipeline FPS falls below a threshold, restoring with a fade-in
(gui_audio_playback.py / gui_audio_mute.py). The *policy* is platform-free:
an FPS-window monitor deciding mute state and a fade-in gain ramp.
``AudioPlayer`` is the actual device binding — an audio-only mpv process
playing the source's audio track, volume-controlled live over mpv's JSON
IPC socket so the fade ramp is audible.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import tempfile
import time
from typing import Callable

from hdrtv_tpu_torch.utils.env import env_bool, env_float, env_int

_F = dataclasses.field


@dataclasses.dataclass
class AutoMutePolicy:
    """Sustained-instability auto-mute (gui_audio_mute.py:22-352).

    A sample is *stable* when ``fps >= min_fps`` and the sample-to-sample
    delta stays within ``max(delta_abs, delta_rel · max(|prev|, |fps|, 1))``
    (_update_fps_stability_state, :47-94). Mute triggers after
    ``unstable_need`` accumulated unstable samples — instability-based, not
    "FPS target missed" (:320-352). Unmute requires ``stable_need`` stable
    samples AND ``hold_s`` of continuous stability
    (_is_stability_hold_satisfied, :22-45), then restores through a
    ``fade_ms`` gain ramp while re-muting stays disarmed for ``grace_s``
    (HDRTVNET_POST_RECOVERY_MUTE_GRACE_S, gui_state_init.py:60).
    All knobs carry the reference's env names and defaults
    (gui_state_init.py:60-101,152).
    """

    target_fps: float = 30.0  # informational; the policy is stability-based
    enabled: bool = _F(default_factory=lambda: env_bool("HDRTVNET_ENABLE_LOW_FPS_AUDIO_MUTE", True))
    min_fps: float = _F(default_factory=lambda: env_float("HDRTVNET_AUDIO_STABILITY_MIN_FPS", 6.0, lo=1.0))
    delta_abs: float = _F(default_factory=lambda: env_float("HDRTVNET_AUDIO_STABILITY_DELTA_ABS", 1.2, lo=0.05))
    delta_rel: float = _F(default_factory=lambda: env_float("HDRTVNET_AUDIO_STABILITY_DELTA_REL", 0.10, lo=0.01))
    stable_need: int = _F(default_factory=lambda: env_int("HDRTVNET_AUDIO_STABILITY_SAMPLES", 8, lo=1))
    stable_need_strict: int = _F(default_factory=lambda: env_int("HDRTVNET_AUDIO_STABILITY_SAMPLES_STRICT", 12, lo=1))
    unstable_need: int = _F(default_factory=lambda: env_int("HDRTVNET_AUDIO_UNSTABLE_SAMPLES", 4, lo=1))
    hold_s: float = _F(default_factory=lambda: env_float("HDRTVNET_AUDIO_STABLE_HOLD_S", 0.55, lo=0.0))
    hold_strict_s: float = _F(default_factory=lambda: env_float("HDRTVNET_AUDIO_STABLE_HOLD_STRICT_S", 0.80, lo=0.0))
    fade_ms: float = _F(default_factory=lambda: env_float("HDRTVNET_AUDIO_RESTORE_FADE_MS", 140.0, lo=80.0))
    grace_s: float = _F(default_factory=lambda: env_float("HDRTVNET_POST_RECOVERY_MUTE_GRACE_S", 1.6, lo=0.0))

    def __post_init__(self):
        self.muted = False
        self._prev: float | None = None
        self._is_stable = False
        self._stable_count = 0
        self._unstable_count = 0
        self._stable_since = 0.0
        self._rearm_until = 0.0
        self._fade_start: float | None = None

    def _track_stability(self, fps: float, now: float) -> None:
        """_update_fps_stability_state (gui_audio_mute.py:47-94)."""
        if not (fps == fps and abs(fps) != float("inf")):  # non-finite
            self._prev = None
            self._is_stable = False
            self._stable_count = 0
            self._stable_since = 0.0
            self._unstable_count += 1
            return
        prev, self._prev = self._prev, fps
        if prev is None:
            self._is_stable = False
            self._stable_count = 0
            self._unstable_count = 0
            self._stable_since = 0.0
            return
        allowed = max(self.delta_abs, self.delta_rel * max(abs(prev), abs(fps), 1.0))
        stable_now = fps >= self.min_fps and prev >= self.min_fps and abs(fps - prev) <= allowed
        if stable_now:
            self._stable_count += 1
            self._unstable_count = max(0, self._unstable_count - 1)
            if not self._is_stable or self._stable_since <= 0.0:
                self._stable_since = now
        else:
            self._unstable_count += 1
            self._stable_count = max(0, self._stable_count - 1)
            self._stable_since = 0.0
        self._is_stable = stable_now

    def _hold_satisfied(self, now: float, *, strict: bool = False) -> bool:
        """_is_stability_hold_satisfied (gui_audio_mute.py:22-45)."""
        if not self._is_stable or self._stable_since <= 0.0:
            return False
        need = self.stable_need_strict if strict else self.stable_need
        if self._stable_count < max(1, need):
            return False
        hold = self.hold_strict_s if strict else self.hold_s
        return (now - self._stable_since) >= max(0.0, hold)

    def update(self, fps_sample: float, now: float | None = None) -> float:
        """Feed an FPS sample; returns current gain in [0,1]."""
        now = time.monotonic() if now is None else now
        if not self.enabled:
            self.__post_init__()
            return 1.0
        try:
            fps = float(fps_sample)
        except (TypeError, ValueError):
            fps = float("nan")
        self._track_stability(fps, now)

        armed = now >= self._rearm_until
        if not self.muted and not armed:
            self._unstable_count = 0
        if not self.muted and armed and self._unstable_count >= self.unstable_need:
            self.muted = True
            self._unstable_count = 0
            self._fade_start = None
        elif self.muted and self._hold_satisfied(now):
            self.muted = False
            self._stable_count = 0
            self._fade_start = now
            self._rearm_until = now + self.grace_s

        if self.muted:
            return 0.0
        if self._fade_start is not None:
            t = (now - self._fade_start) * 1000.0
            if t >= self.fade_ms:
                self._fade_start = None
                return 1.0
            return max(0.0, min(1.0, t / max(1e-6, self.fade_ms)))
        return 1.0


def live_audio_delay_target_ms(
    latency_hint_ms: float | None = None, *, tab_audio: bool = False
) -> float:
    """Target delay for live-capture audio (the extension's local delay).

    The reference aims the browser-tab audio delay at the measured pipeline
    latency plus a safety margin, clamped into a sane window, with a higher
    floor when the audio comes from the captured tab itself
    (gui_state_init.py:123-139 env family; gui_audio_playback.py:310-320
    clamp). Without a latency hint the default target applies.
    """
    default = max(50.0, env_float("HDRTVNET_LIVE_AUDIO_DEFAULT_DELAY_MS", 95.0))
    margin = max(0.0, env_float("HDRTVNET_LIVE_AUDIO_DELAY_MARGIN_MS", 10.0))
    min_d = max(40.0, env_float("HDRTVNET_LIVE_AUDIO_MIN_DELAY_MS", 70.0))
    max_d = max(min_d, env_float("HDRTVNET_LIVE_AUDIO_MAX_DELAY_MS", 650.0))
    target = default if latency_hint_ms is None else float(latency_hint_ms) + margin
    if tab_audio:
        target = max(target, max(min_d, env_float("HDRTVNET_LIVE_TAB_AUDIO_FLOOR_DELAY_MS", 80.0)))
    return max(min_d, min(max_d, target))


class AudioAttachment:
    """Binds the policy to a gain callback (e.g. an mpv --volume setter).

    A failed application (callback returns False — e.g. the mpv IPC socket
    is not up yet) is retried on the next metrics tick instead of silently
    leaving the device at a stale volume."""

    def __init__(self, policy: AutoMutePolicy, set_gain: Callable[[float], None] | None = None):
        self.policy = policy
        self.set_gain = set_gain or (lambda g: None)
        self.gain = 1.0
        self._applied = True

    def on_metrics(self, fps: float) -> float:
        g = self.policy.update(fps)
        if g != self.gain or not self._applied:
            self.gain = g
            ok = self.set_gain(g)
            self._applied = ok is not False  # None (no status) counts as ok
        return g


class AudioPlayer:
    """Audio-only mpv bound to the source file — the audio attach device
    (gui_audio_playback.py role). ``set_gain`` drives mpv's volume property
    over the JSON IPC socket (``--input-ipc-server``), so the auto-mute fade
    is applied live; ``track`` selects an ``--aid`` from
    :func:`hdrtv_tpu_torch.runtime.probe.probe_audio_streams` ordinals."""

    def __init__(self, media_path: str, *, track: int | None = None, start_s: float = 0.0,
                 volume: float = 1.0, delay_ms: float = 0.0):
        if shutil.which("mpv") is None:
            raise RuntimeError("mpv not found on PATH")
        self.media_path = media_path
        # audio-delay: positive values make the audio lag the video by that
        # much (the reference's 0-2000 ms slider, README.md:250). With a
        # separate audio-only mpv there is no shared clock, so the delay is
        # applied as a playhead offset: every absolute position maps to
        # position - delay.
        self.delay_s = max(0.0, min(2.0, float(delay_ms) / 1000.0))
        self._dir = tempfile.mkdtemp(prefix="hdrtv_audio_")
        self.ipc_path = os.path.join(self._dir, "mpv.sock")
        args = [
            "mpv", "--no-config", "--no-video", "--keep-open=no",
            f"--input-ipc-server={self.ipc_path}",
            f"--volume={max(0.0, min(1.0, volume)) * 100:.0f}",
        ]
        if track is not None:
            args.append(f"--aid={int(track) + 1}")  # mpv track ids are 1-based
        eff_start = max(0.0, start_s - self.delay_s)
        if eff_start > 0:
            args.append(f"--start={eff_start:.3f}")
        self.proc = subprocess.Popen(
            [*args, media_path],
            stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        self._sock: socket.socket | None = None

    def _ipc(self, command: list) -> bool:
        try:
            if self._sock is None:
                deadline = time.monotonic() + 10.0
                while not os.path.exists(self.ipc_path):
                    if self.proc.poll() is not None or time.monotonic() > deadline:
                        return False
                    time.sleep(0.02)
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                while True:
                    try:
                        sock.connect(self.ipc_path)
                        break
                    except (ConnectionRefusedError, FileNotFoundError):
                        # socket path exists before mpv listens — retry briefly
                        if self.proc.poll() is not None or time.monotonic() > deadline:
                            sock.close()
                            return False
                        time.sleep(0.02)
                self._sock = sock
            self._sock.sendall((json.dumps({"command": command}) + "\n").encode())
            return True
        except OSError:
            self._sock = None
            return False

    def set_gain(self, gain: float) -> bool:
        """[0,1] gain → mpv volume 0-100 (the AudioAttachment callback)."""
        return self._ipc(["set_property", "volume", max(0.0, min(1.0, gain)) * 100.0])

    def pause(self, paused: bool = True) -> bool:
        return self._ipc(["set_property", "pause", bool(paused)])

    def seek(self, seconds: float) -> bool:
        return self._ipc(["seek", max(0.0, float(seconds) - self.delay_s), "absolute"])

    def set_delay(self, delay_ms: float) -> bool:
        """Live delay change (the slider): shift the playhead by the delta so
        the new offset takes effect without a full reseek from the caller."""
        new = max(0.0, min(2.0, float(delay_ms) / 1000.0))
        delta = self.delay_s - new  # more delay → playhead moves back
        self.delay_s = new
        if abs(delta) < 1e-6:
            return True
        return self._ipc(["seek", delta, "relative"])

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        shutil.rmtree(self._dir, ignore_errors=True)
