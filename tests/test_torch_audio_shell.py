"""The audio attach, the interactive shell and the tab-audio bridge of
hdrtv_tpu_torch on the CPU against hdrtv_tpu: ``pipeline/audio.py``
(``AutoMutePolicy``, ``live_audio_delay_target_ms``, ``AudioAttachment``,
``AudioPlayer`` over a fake mpv's IPC socket), ``pipeline/shell.py``
(``ShellController`` against fake runners, ``status_interval_s``),
``pipeline/bridge.py`` (``AudioSyncBridge`` over HTTP on 127.0.0.1), and the
CLI's ``convert --audio`` and ``--interactive``.

The same inputs go through both packages and must give the same results:
gains, delays, the JSON commands mpv receives, the requests a runner
receives and the status lines, the bridge's status codes and bodies
(session ids and URLs aside). The CLI runs on fake processors in both
packages (the frame programs are held elsewhere: tests/test_torch_cli.py,
tests/test_torch_live.py).
"""

import importlib.util
import json
import os
import stat
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from hdrtv_tpu.pipeline import audio as jax_audio
from hdrtv_tpu.pipeline import bridge as jax_bridge
from hdrtv_tpu.pipeline import shell as jax_shell
from hdrtv_tpu_torch.pipeline import audio, bridge, shell

ROOT = os.path.join(os.path.dirname(__file__), "..")
H, W = 64, 96
PACKAGES = {"port": (audio, shell, bridge), "jax": (jax_audio, jax_shell, jax_bridge)}


def _fake_mpv_script() -> str:
    """chip_smoke.py's fake mpv (tests/test_audio_player.py's): serves the
    --input-ipc-server socket and appends every command line it receives to
    <socket>.log; with no socket it sleeps, as an mpv playing would."""
    spec = importlib.util.spec_from_file_location("chip_smoke_fake_mpv", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FAKE_MPV.replace("{python}", sys.executable)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU on one intra-op thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def fake_mpv(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    mpv = bindir / "mpv"
    mpv.write_text(_fake_mpv_script())
    mpv.chmod(mpv.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    return bindir


def _read_log(player, n, timeout=10.0):
    """The first n JSON commands the fake received (waits for them)."""
    log = player.ipc_path + ".log"
    deadline = time.monotonic() + timeout
    cmds = []
    while time.monotonic() < deadline:
        if os.path.exists(log):
            with open(log) as f:
                cmds = [json.loads(line) for line in f if line.strip()]
            if len(cmds) >= n:
                return cmds
        time.sleep(0.02)
    return cmds


# ---------------------------------------------------------------------------
# The auto-mute policy and the live audio delay
# ---------------------------------------------------------------------------

MUTE_ENV = {
    "HDRTVNET_AUDIO_STABILITY_MIN_FPS": "10", "HDRTVNET_AUDIO_STABILITY_DELTA_ABS": "0.01",
    "HDRTVNET_AUDIO_STABILITY_DELTA_REL": "0.2", "HDRTVNET_AUDIO_STABILITY_SAMPLES": "3",
    "HDRTVNET_AUDIO_STABILITY_SAMPLES_STRICT": "0", "HDRTVNET_AUDIO_UNSTABLE_SAMPLES": "2",
    "HDRTVNET_AUDIO_STABLE_HOLD_S": "0.3", "HDRTVNET_AUDIO_STABLE_HOLD_STRICT_S": "-1",
    "HDRTVNET_AUDIO_RESTORE_FADE_MS": "50", "HDRTVNET_POST_RECOVERY_MUTE_GRACE_S": "0.5",
}


def _timed(policy, times):
    """The policy with each update's time taken from ``times`` in turn (as
    AudioAttachment passes none)."""
    clock, update = iter(times), policy.update
    policy.update = lambda fps, now=None: update(fps, now=next(clock))
    return policy


def _fps_series(seed, n=400):
    """Stable stretches, unstable bursts, dropouts and non-numbers, with the
    sample times (40-90 ms apart, so a fade-in shows between samples)."""
    rng = np.random.RandomState(seed)
    fps, t, now, times = [], 0.0, 100.0, []
    for i in range(n):
        phase = (i // 40) % 4
        if phase == 0:
            v = 30.0 + rng.randn() * 0.3
        elif phase == 1:
            v = float(rng.choice([2.0, 30.0, 8.0, 55.0]))
        elif phase == 2:
            v = 24.0 + rng.randn() * 4.0
        else:
            v = float(rng.choice([30.0, 29.8, float("nan"), float("inf"), 30.1]))
        fps.append(v)
        now += 0.04 + rng.rand() * 0.05
        times.append(now)
    fps[7], fps[13] = "junk", None  # not a number: unstable
    return fps, times


@pytest.mark.parametrize("env", [{}, MUTE_ENV, {"HDRTVNET_ENABLE_LOW_FPS_AUDIO_MUTE": "0"}],
                         ids=["defaults", "knobs", "disabled"])
@pytest.mark.parametrize("seed", [0, 1])
def test_auto_mute_policy_matches_jax(seed, env, monkeypatch):
    """A seeded FPS series with injected times: every gain equal, and the
    policy's knobs read from the same environment."""
    for k in MUTE_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.delenv("HDRTVNET_ENABLE_LOW_FPS_AUDIO_MUTE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours, theirs = audio.AutoMutePolicy(target_fps=30.0), jax_audio.AutoMutePolicy(target_fps=30.0)
    assert {k: v for k, v in vars(ours).items() if not k.startswith("_")} == \
        {k: v for k, v in vars(theirs).items() if not k.startswith("_")}
    fps, times = _fps_series(seed)
    got = [ours.update(f, now=t) for f, t in zip(fps, times)]
    want = [theirs.update(f, now=t) for f, t in zip(fps, times)]
    assert got == want
    if not env.get("HDRTVNET_ENABLE_LOW_FPS_AUDIO_MUTE"):
        assert 0.0 in got and any(0.0 < g < 1.0 for g in got)  # muted, then faded back in


@pytest.mark.parametrize("env", [{}, {"HDRTVNET_LIVE_AUDIO_DEFAULT_DELAY_MS": "20",
                                      "HDRTVNET_LIVE_AUDIO_DELAY_MARGIN_MS": "-5",
                                      "HDRTVNET_LIVE_AUDIO_MIN_DELAY_MS": "30",
                                      "HDRTVNET_LIVE_AUDIO_MAX_DELAY_MS": "10",
                                      "HDRTVNET_LIVE_TAB_AUDIO_FLOOR_DELAY_MS": "400"},
                                 {"HDRTVNET_LIVE_AUDIO_MAX_DELAY_MS": "2000",
                                  "HDRTVNET_LIVE_AUDIO_DELAY_MARGIN_MS": "35"}],
                         ids=["defaults", "clamped", "wide"])
def test_live_audio_delay_target_matches_jax(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for hint in (None, 0.0, 4.2, 21.7, 60.0, 140.5, 900.0, 5000.0):
        for tab in (False, True):
            assert audio.live_audio_delay_target_ms(hint, tab_audio=tab) == \
                jax_audio.live_audio_delay_target_ms(hint, tab_audio=tab)


@pytest.mark.parametrize("fail_every", [0, 3])
def test_audio_attachment_matches_jax(fail_every):
    """AudioAttachment over the same policy inputs (times injected): the same
    gain calls, a failed application (False) retried at the next tick."""
    fps, times = _fps_series(5, 200)
    calls = {}
    for name, (mod, _, _) in PACKAGES.items():
        seen = []

        def set_gain(g, _seen=seen):
            _seen.append(g)
            return not (fail_every and len(_seen) % fail_every == 0)

        attach = mod.AudioAttachment(_timed(mod.AutoMutePolicy(unstable_need=2), times), set_gain)
        gains = [attach.on_metrics(f) for f in fps]
        calls[name] = (gains, seen)
    assert calls["port"] == calls["jax"]
    assert 0.0 in calls["port"][1]
    assert audio.AudioAttachment(audio.AutoMutePolicy()).on_metrics(30.0) == 1.0  # no callback


# ---------------------------------------------------------------------------
# The mpv audio player
# ---------------------------------------------------------------------------


def test_audio_player_ipc_matches_jax(fake_mpv, tmp_path):
    """The same calls on each package's AudioPlayer: the same mpv argv (the
    socket path aside) and the same JSON commands on the IPC socket, in
    order: gains, pause, seeks under the delay, live delay changes."""
    media = tmp_path / "clip.mp4"
    media.write_bytes(b"x")
    logs, argvs = {}, {}
    for name, (mod, _, _) in PACKAGES.items():
        p = mod.AudioPlayer(str(media), track=1, start_s=5.0, volume=0.7, delay_ms=500)
        try:
            results = [p.set_gain(0.5), p.set_gain(1.7), p.set_gain(-1), p.pause(True), p.pause(False),
                       p.seek(10.0), p.seek(0.1), p.set_delay(400), p.set_delay(400), p.set_delay(9999)]
            logs[name] = (results, p.delay_s, _read_log(p, 9))
        finally:
            p.close()
        assert not os.path.exists(p._dir)
        argvs[name] = [a for a in p.proc.args if not a.startswith("--input-ipc-server=")]
    assert logs["port"] == logs["jax"]
    results, delay_s, cmds = logs["port"]
    assert all(results) and delay_s == 2.0 and len(cmds) == 9
    assert cmds[0] == {"command": ["set_property", "volume", 50.0]}
    assert cmds[5] == {"command": ["seek", 9.5, "absolute"]}
    assert argvs["port"] == argvs["jax"]
    assert "--start=4.500" in argvs["port"] and "--aid=2" in argvs["port"] and "--volume=70" in argvs["port"]


def test_audio_attachment_reaches_the_player(fake_mpv, tmp_path):
    """The policy's gains through AudioAttachment into each package's player:
    the same volume commands reach mpv."""
    media = tmp_path / "clip.mp4"
    media.write_bytes(b"x")
    fps = [30.0, 3.0, 25.0, 2.0, 20.0] + [30.0] * 12
    times = [10.0 + 0.2 * i for i in range(len(fps))]
    issued = []
    dry = audio.AudioAttachment(_timed(audio.AutoMutePolicy(unstable_need=2), times), issued.append)
    for f in fps:
        dry.on_metrics(f)
    assert 0.0 in issued and issued[-1] == 1.0  # muted, then restored through the fade
    got = {}
    for name, (mod, _, _) in PACKAGES.items():
        p = mod.AudioPlayer(str(media))
        try:
            attach = mod.AudioAttachment(_timed(mod.AutoMutePolicy(unstable_need=2), times), p.set_gain)
            for f in fps:
                attach.on_metrics(f)
            got[name] = _read_log(p, len(issued))
        finally:
            p.close()
    assert got["port"] == got["jax"]
    assert got["port"] == [{"command": ["set_property", "volume", g * 100.0]} for g in issued]


def test_missing_mpv_raises_as_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    msgs = []
    for mod in (audio, jax_audio):
        with pytest.raises(RuntimeError) as e:
            mod.AudioPlayer("x.mp4")
        msgs.append(str(e.value))
    assert msgs == ["mpv not found on PATH"] * 2


# ---------------------------------------------------------------------------
# The shell controller
# ---------------------------------------------------------------------------


class _Calls:
    """A fake runner, audio device and sink recording every call (the log
    shared, so their order is kept)."""

    def __init__(self, log, prefix):
        self._log, self._prefix = log, prefix

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def call(*args):
            self._log.append((self._prefix, name, *args))
            return True

        return call


class _Source:
    fps = 24.0


class _Metrics:
    def __init__(self, fps, frames, dropped):
        self.fps, self.frames, self.dropped = fps, frames, dropped


KEYS = [" ", " ", "RIGHT", "LEFT", ",", ".", "p", "p", "p", "r", "r", "r", "r", "m", "m", "u", "u", "u", "z",
        "LEFT", "LEFT", "LEFT", ".", "q"]


@pytest.mark.parametrize("with_audio,with_sink", [(True, True), (False, False), (True, False)],
                         ids=["audio-sink", "bare", "audio-only"])
def test_shell_controller_matches_jax(with_audio, with_sink):
    """The same key sequence on each package's ShellController over fake
    runners (metrics fed between keys): the same runner / audio / sink calls
    in the same order, the same actions and status lines."""
    out = {}
    for name, (_, mod, _) in PACKAGES.items():
        log = []
        runner = _Calls(log, "runner")
        if with_sink:
            runner.sink = _Calls(log, "sink")
        ctl = mod.ShellController(runner, _Source(), audio=_Calls(log, "audio") if with_audio else None,
                                  precisions=("fp16", "int8", "fp32"), resolution="720p")
        lines = [ctl.status_line(), ctl.help_line()]
        for i, key in enumerate(KEYS):
            ctl.on_metrics(_Metrics(fps=30.0 - i * 0.7, frames=100 + 37 * i, dropped=i // 3))
            action = ctl.handle_key(key)
            if action:
                ctl.notice = action
            lines.append((action, ctl.status_line()))
        out[name] = (log, lines, ctl.precision, ctl.resolution, ctl.upscaler, ctl.quit_requested)
    assert out["port"] == out["jax"]
    log = out["port"][0]
    assert ("runner", "stop") in log and ("runner", "request_resolution_change", (1920, 1080)) in log


@pytest.mark.parametrize("env", [None, "100", "2500", "junk"])
def test_status_interval_matches_jax(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("HDRTVNET_PLAYBACK_STATUS_MS", raising=False)
    else:
        monkeypatch.setenv("HDRTVNET_PLAYBACK_STATUS_MS", env)
    assert shell.status_interval_s() == jax_shell.status_interval_s()


# ---------------------------------------------------------------------------
# The tab-audio bridge
# ---------------------------------------------------------------------------

_NO_PROXY = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _req(url, method="GET", payload=None, raw=None):
    data = raw if raw is not None else (json.dumps(payload).encode() if payload is not None else None)
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with _NO_PROXY.open(req, timeout=5) as r:
            body = r.read().decode()
            return r.status, json.loads(body) if body else None, r.headers.get("Access-Control-Allow-Origin")
    except urllib.error.HTTPError as e:
        body = e.read().decode()
        return e.code, json.loads(body) if body else None, e.headers.get("Access-Control-Allow-Origin")


def _scrub(body, ids):
    """A body with session ids, URLs and times replaced by stable names."""
    if isinstance(body, dict):
        out = {}
        for k, v in body.items():
            if k == "session_id":
                out[k] = ids.setdefault(v, f"sid{len(ids)}")
            elif k in ("bridge_url", "last_seen_perf"):
                out[k] = "<scrubbed>"
            else:
                out[k] = _scrub(v, ids)
        return out
    if isinstance(body, list):
        return [_scrub(v, ids) for v in body]
    if isinstance(body, str):
        for sid, name in ids.items():
            body = body.replace(sid, name)
    return body


def _exchange(base):
    """One client's exchange with a bridge: start, list, keepalive, stop,
    late keepalive, unknown routes, bad JSON, an upsert with a given id."""
    steps = [
        ("GET", "/health", None), ("OPTIONS", "/health", None),
        ("POST", "/session/start", {"title": "Daredevil - Netflix", "fps": 60, "has_audio": True,
                                    "width": 1920, "height": 1080, "audio_sample_rate": 48000,
                                    "audio_channels": "2", "browser_name": "Chrome"}),
        ("GET", "/sessions", None), ("GET", "/health", None),
        ("POST", "/session/{sid}/keepalive", {"has_audio": False, "fps": "junk", "width": -5}),
        ("POST", "/session/start", {"session_id": "fixed-1", "title": "B", "fps": 0.5}),
        ("POST", "/session/start", {"session_id": "fixed-1", "height": 50}),
        ("GET", "/sessions", None),
        ("POST", "/session/{sid}/stop", {}),
        ("POST", "/session/{sid}/keepalive", {}),
        ("POST", "/session/nope/keepalive", {}),
        ("POST", "/session/fixed-1/keepalive", b"{not json"),
        ("POST", "/session/start", b"[1, 2]"),
        ("GET", "/nope", None), ("POST", "/session/zz/frobnicate", {}),
        ("POST", "/session/fixed-1/stop", {}), ("GET", "/health", None),
    ]
    ids, out, sid = {}, [], None
    for method, path, payload in steps:
        raw = payload if isinstance(payload, bytes) else None
        st, body, cors = _req(base + path.replace("{sid}", str(sid)), method,
                              None if raw is not None else payload, raw)
        if sid is None and isinstance(body, dict) and body.get("session_id"):
            sid = body["session_id"]
        out.append((method, path, st, cors, _scrub(body, ids)))
    return out


def test_bridges_answer_alike():
    """The same HTTP exchange against each package's bridge on 127.0.0.1
    (port 0): equal status codes, CORS headers and JSON bodies, session ids
    and URLs aside; a keepalive after the stop gets 410."""
    got = {}
    for name, (_, _, mod) in PACKAGES.items():
        with mod.AudioSyncBridge(host="127.0.0.1", port=0) as b:
            assert b.port != 0 and b.address() == f"http://127.0.0.1:{b.port}"
            got[name] = _exchange(b.address())
    assert got["port"] == got["jax"]
    codes = [st for _, _, st, _, _ in got["port"]]
    assert codes.count(410) == 2 and codes.count(404) == 2 and codes.count(400) == 2


def test_bridge_expiry_and_revocation_match_jax(monkeypatch):
    """Both registries: the knobs read from the same environment (clamped
    alike), sessions expired after the timeout and revocations after their
    TTL."""
    monkeypatch.setenv("HDRTVNET_TAB_SESSION_TIMEOUT_S", "12")
    monkeypatch.setenv("HDRTVNET_TAB_REVOKED_SESSION_TTL_S", "1")
    out = {}
    for name, (_, _, mod) in PACKAGES.items():
        b = mod.AudioSyncBridge(port=0)
        b.upsert_session({"session_id": "old", "title": "t"})
        b.upsert_session({"session_id": "new"})
        b.close_session("gone")
        b.close_session("late")
        with b._lock:
            b._sessions["old"].last_seen -= 13
            b._revoked["gone"] -= 6
        b._expire()
        out[name] = (b.host, b.port, b.timeout_s, b.revoked_ttl_s, [s.session_id for s in b.list_sessions()],
                     sorted(b._revoked))
    assert out["port"] == out["jax"] == ("127.0.0.1", 0, 12.0, 5.0, ["new"], ["late"])


def test_bridge_sessions_match_jax():
    """upsert / touch / close / list on both registries: the same fields."""
    out = {}
    for name, (_, _, mod) in PACKAGES.items():
        b = mod.AudioSyncBridge(port=0)
        a = b.upsert_session({"session_id": "s1", "title": "A", "width": "100", "fps": "x"})
        c = b.upsert_session({"session_id": "s1", "height": 50, "has_audio": 1})
        d = b.touch_session("s1", {"audio_bits_per_sample": 24})
        b.close_session("s1")
        with pytest.raises(mod.SessionClosedError):
            b.touch_session("s1", {})
        with pytest.raises(mod.SessionClosedError, match="unknown session"):
            b.touch_session("s2", {})
        out[name] = [{k: v for k, v in s.to_json().items() if k != "last_seen_perf"} for s in (a, c, d)]
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# The CLI: convert --interactive and --audio
# ---------------------------------------------------------------------------


class _JaxFake:
    """A processor for the JAX CLI: the SDR frame as RGB48."""

    model_path = ""

    def warmup_compile(self, w, h, **kw):
        return 0.0

    def with_proc_resolution(self, res):
        return self

    def process_rgb48_device(self, frame):
        import jax.numpy as jnp

        return frame.astype(jnp.uint16) * 257


class _TorchFake(_JaxFake):
    """The same for the port's CLI on torch tensors."""

    device = torch.device("cpu")

    def put_frame(self, flat):
        return torch.from_numpy(np.ascontiguousarray(flat))

    def process_rgb48_device(self, x):
        return x.to(torch.int32).mul(257).to(torch.uint16)


@pytest.fixture
def both_clis(monkeypatch, tmp_path):
    """Both CLIs on the CPU at 64 × 96 (the presets cut) on fake processors,
    counting the processors each makes; prefs under tmp_path."""
    from hdrtv_tpu import cli as jax_cli
    from hdrtv_tpu import config as jax_config
    from hdrtv_tpu_torch import cli, config

    monkeypatch.setenv("HDRTV_CLI_PLATFORM", "cpu")
    monkeypatch.setenv("HDRTVNET_ENGINE_CACHE_DIR", str(tmp_path / "engines"))
    monkeypatch.setenv("HDRTVNET_CACHE_DIR", str(tmp_path / "cache"))
    for cfg in (config, jax_config):
        for key in ("540p", "720p", "1080p"):
            monkeypatch.setitem(cfg.RESOLUTION_SCALES, key, (W, H))
    made = {"port": [], "jax": []}

    def maker(name, fake):
        def make(args):
            made[name].append(args.precision)
            return fake()

        return make

    monkeypatch.setattr(cli, "_make_processor", maker("port", _TorchFake))
    monkeypatch.setattr(jax_cli, "_make_processor", maker("jax", _JaxFake))
    return {"port": cli.main, "jax": jax_cli.main}, made, tmp_path


def _clip(path, n=6):
    import cv2

    rng = np.random.RandomState(5)
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 24, (W, H))
    for _ in range(n):
        wr.write((rng.rand(H, W, 3) * 255).astype(np.uint8))
    wr.release()


def _summary(text):
    line = [ln for ln in text.splitlines() if ln.startswith("frames=")]
    assert len(line) == 1, text
    return line[0].split()[:2]


def test_convert_interactive_without_a_tty(both_clis, capsys, monkeypatch):
    """convert --interactive with stdout not a tty runs as a plain convert in
    both CLIs: frames= printed, no shell, prefs as given."""
    mains, made, tmp = both_clis
    for name, main in mains.items():
        monkeypatch.setenv("HDRTVNET_PREFS_PATH", str(tmp / f"{name}.json"))
        assert main(["convert", "--interactive", "--display", "null", "--frames", "5", "--no-realtime",
                     "--resolution", "540p"]) == 0
        out = capsys.readouterr().out
        assert _summary(out) == ["frames=5", "dropped=0"]
    prefs = {n: json.load(open(tmp / f"{n}.json")) for n in mains}
    assert prefs["port"] == prefs["jax"] and prefs["port"]["resolution"] == "540p"


def test_convert_interactive_drives_the_shell(both_clis, capsys, monkeypatch):
    """convert --interactive on a tty: the runner runs on its own thread
    under the shell (run_shell replaced by a script pressing p, r, r once
    frames flow, and q once the runner has made their processors); each
    hot-swap makes a processor through the CLI's factory, and the prefs keep
    the precision and resolution the session ended with. The same in both
    CLIs."""
    from hdrtv_tpu.pipeline import shell as jax_shell_mod
    from hdrtv_tpu_torch.pipeline import shell as shell_mod

    mains, made, tmp = both_clis
    seen = {}

    def scripted(name):
        def run_shell(ctl):
            deadline = time.monotonic() + 20
            while ctl.last_metrics is None and time.monotonic() < deadline:
                time.sleep(0.01)
            actions = [ctl.handle_key(k) for k in ("p", "r", "r")]
            while len(made[name]) < 4 and time.monotonic() < deadline:  # the runner applied the swaps
                time.sleep(0.01)
            actions.append(ctl.handle_key("q"))
            seen[name] = (actions, ctl.status_line().split("]")[0])

        return run_shell

    monkeypatch.setattr(shell_mod, "run_shell", scripted("port"))
    monkeypatch.setattr(jax_shell_mod, "run_shell", scripted("jax"))
    monkeypatch.setattr(sys.stdout, "isatty", lambda: True)
    for name, main in mains.items():
        monkeypatch.setenv("HDRTVNET_PREFS_PATH", str(tmp / f"{name}.json"))
        assert main(["convert", "--interactive", "--display", "null", "--frames", "100000", "--resolution",
                     "1080p", "--precision", "fp16"]) == 0
        assert _summary(capsys.readouterr().out)[0].startswith("frames=")
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == ["precision → int8", "resolution → 540p", "resolution → 720p", "quit"]
    prefs = {n: json.load(open(tmp / f"{n}.json")) for n in mains}
    assert prefs["port"] == prefs["jax"]
    assert (prefs["port"]["precision"], prefs["port"]["resolution"]) == ("int8", "720p")
    assert made["port"] == made["jax"] == ["fp16", "int8", "fp16", "fp16"]  # the first, then one a swap


def test_convert_audio_attach(both_clis, capsys, monkeypatch, fake_mpv):
    """convert --audio on a clip under the fake mpv in both CLIs: the same
    mpv argv (the socket aside), frames= printed, no "unavailable"; without
    mpv on the PATH both print "audio attach unavailable" and still run."""
    pytest.importorskip("cv2")
    import subprocess

    mains, made, tmp = both_clis
    clip = str(tmp / "clip.avi")
    _clip(clip)
    spawned, popen = [], subprocess.Popen

    def recording_popen(args, *a, **kw):
        spawned.append(list(args))
        return popen(args, *a, **kw)

    monkeypatch.setattr(subprocess, "Popen", recording_popen)
    argvs = {}
    for name, main in mains.items():
        monkeypatch.setenv("HDRTVNET_PREFS_PATH", str(tmp / f"{name}.json"))
        spawned.clear()
        assert main(["convert", "--video", clip, "--audio", "--audio-track", "0", "--audio-delay-ms", "250",
                     "--display", "null", "--no-realtime", "--prefetch", "0", "--resolution", "540p"]) == 0
        out = capsys.readouterr().out
        assert "unavailable" not in out and _summary(out) == ["frames=6", "dropped=0"]
        mpv = [a for a in spawned if a[0] == "mpv"]
        assert len(mpv) == 1
        argvs[name] = [a for a in mpv[0] if not a.startswith("--input-ipc-server=")]
    assert argvs["port"] == argvs["jax"]
    assert argvs["port"][-1] == clip and "--aid=1" in argvs["port"]
    monkeypatch.setenv("PATH", str(tmp / "empty"))
    for name, main in mains.items():
        assert main(["convert", "--video", clip, "--audio", "--display", "null", "--no-realtime",
                     "--prefetch", "0", "--resolution", "540p", "--frames", "2"]) == 0
        out = capsys.readouterr().out
        assert "audio attach unavailable: mpv not found on PATH" in out and _summary(out)[0] == "frames=2"
