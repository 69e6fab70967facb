"""Browser-tab audio-sync bridge — the local HTTP session registry (the
port's copy of ``hdrtv_tpu/pipeline/bridge.py``).

The reference pairs its window capture with a Chrome extension that delays
tab audio locally; the app side is a localhost HTTP bridge the extension
talks to (browser_tab_bridge.py). The *protocol* is platform-neutral, so it
is reproduced here verbatim (browser_tab_bridge.py:311-434 contract):

- ``GET  /health``                 → ``{ok, bridge_url, session_count}``
- ``GET  /sessions``               → ``{ok, sessions: [...]}``
- ``POST /session/start``          → upsert, ``{ok, session_id, bridge_url}``
- ``POST /session/<id>/keepalive`` → touch, ``{ok, session_id, has_audio}``;
  410 GONE once the session was closed app-side (revocation)
- ``POST /session/<id>/stop``      → close, ``{ok}``

Sessions expire after ``HDRTVNET_TAB_SESSION_TIMEOUT_S`` without a
keepalive (cleanup loop, browser_tab_bridge.py:159-176); closed sessions
are remembered for a revocation TTL so late keepalives get 410 instead of
silently re-registering.
"""

from __future__ import annotations

import dataclasses
import json
import re
import threading
import time
import uuid
from http import HTTPStatus
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse

from hdrtv_tpu_torch.utils.env import env_float, env_int, env_str

__all__ = ["TabSession", "AudioSyncBridge", "SessionClosedError"]


class SessionClosedError(RuntimeError):
    pass


@dataclasses.dataclass
class TabSession:
    """One captured browser tab (BrowserTabSessionInfo parity fields)."""

    session_id: str
    title: str = ""
    browser_name: str = ""
    process_name: str = ""
    source_url: str = ""
    width: int = 0
    height: int = 0
    fps: float = 30.0
    has_audio: bool = False
    audio_sample_rate: int = 0
    audio_channels: int = 0
    audio_bits_per_sample: int = 16
    last_seen: float = 0.0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["last_seen_perf"] = d.pop("last_seen")
        return d


def _session_fields(payload: dict) -> dict:
    out = {}
    for k in ("title", "browser_name", "process_name", "source_url"):
        if k in payload:
            out[k] = str(payload[k] or "")
    for k in ("width", "height", "audio_sample_rate", "audio_channels", "audio_bits_per_sample"):
        if k in payload:
            try:
                out[k] = max(0, int(payload[k]))
            except (TypeError, ValueError):
                pass
    if "fps" in payload:
        try:
            out["fps"] = max(1.0, float(payload["fps"]))
        except (TypeError, ValueError):
            pass
    if "has_audio" in payload:
        out["has_audio"] = bool(payload["has_audio"])
    return out


class AudioSyncBridge:
    """Thread-safe localhost bridge server with session expiry."""

    def __init__(self, host: str | None = None, port: int | None = None):
        self.host = host or env_str("HDRTVNET_TAB_BRIDGE_HOST", "127.0.0.1")
        self.port = port if port is not None else env_int("HDRTVNET_TAB_BRIDGE_PORT", 39091, lo=0, hi=65535)
        self.timeout_s = env_float("HDRTVNET_TAB_SESSION_TIMEOUT_S", 45.0, lo=10.0, hi=3600.0)
        self.revoked_ttl_s = env_float("HDRTVNET_TAB_REVOKED_SESSION_TTL_S", 30.0, lo=5.0, hi=3600.0)
        self._sessions: dict[str, TabSession] = {}
        self._revoked: dict[str, float] = {}
        self._lock = threading.Lock()
        self._server: ThreadingHTTPServer | None = None
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()

    # -- registry ----------------------------------------------------------

    def upsert_session(self, payload: dict) -> TabSession:
        sid = str(payload.get("session_id") or "").strip() or uuid.uuid4().hex
        now = time.monotonic()
        with self._lock:
            self._revoked.pop(sid, None)
            sess = self._sessions.get(sid)
            if sess is None:
                sess = TabSession(session_id=sid)
                self._sessions[sid] = sess
            for k, v in _session_fields(payload).items():
                setattr(sess, k, v)
            sess.last_seen = now
            return dataclasses.replace(sess)

    def touch_session(self, sid: str, payload: dict) -> TabSession:
        now = time.monotonic()
        with self._lock:
            if sid in self._revoked:
                raise SessionClosedError(f"session {sid} was closed")
            sess = self._sessions.get(sid)
            if sess is None:
                raise SessionClosedError(f"unknown session {sid}")
            for k, v in _session_fields(payload).items():
                setattr(sess, k, v)
            sess.last_seen = now
            return dataclasses.replace(sess)

    def close_session(self, sid: str, *, revoke: bool = True) -> None:
        with self._lock:
            self._sessions.pop(sid, None)
            if revoke:
                self._revoked[sid] = time.monotonic()

    def list_sessions(self) -> list[TabSession]:
        with self._lock:
            return [dataclasses.replace(s) for s in self._sessions.values()]

    def _expire(self) -> None:
        now = time.monotonic()
        with self._lock:
            dead = [sid for sid, s in self._sessions.items() if now - s.last_seen > self.timeout_s]
            for sid in dead:
                del self._sessions[sid]
            gone = [sid for sid, t in self._revoked.items() if now - t > self.revoked_ttl_s]
            for sid in gone:
                del self._revoked[sid]

    # -- server ------------------------------------------------------------

    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "AudioSyncBridge":
        if self._server is not None:
            return self
        self._server = ThreadingHTTPServer((self.host, self.port), self._make_handler())
        self.port = self._server.server_address[1]  # resolve port 0
        t = threading.Thread(target=self._server.serve_forever, daemon=True, name="tab-bridge-http")
        t.start()
        c = threading.Thread(target=self._cleanup_loop, daemon=True, name="tab-bridge-cleanup")
        c.start()
        self._threads = [t, c]
        return self

    def _cleanup_loop(self):
        while not self._stop.wait(2.0):
            self._expire()

    def shutdown(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    def _make_handler(self):
        bridge = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *_args):  # quiet
                pass

            def _send(self, status: int, payload: dict):
                raw = json.dumps(payload).encode()
                self.send_response(int(status))
                self.send_header("Content-Type", "application/json; charset=utf-8")
                self.send_header("Content-Length", str(len(raw)))
                # the extension runs cross-origin against localhost
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Access-Control-Allow-Methods", "GET, POST, OPTIONS")
                self.send_header("Access-Control-Allow-Headers", "Content-Type")
                self.end_headers()
                self.wfile.write(raw)

            def _json_body(self) -> dict | None:
                try:
                    n = max(0, int(self.headers.get("Content-Length", "0")))
                except ValueError:
                    n = 0
                raw = self.rfile.read(n) if n else b""
                if not raw:
                    return {}
                try:
                    payload = json.loads(raw.decode())
                except (ValueError, UnicodeDecodeError):
                    return None
                return payload if isinstance(payload, dict) else None

            def do_OPTIONS(self):
                self._send(HTTPStatus.NO_CONTENT, {})

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/health":
                    self._send(HTTPStatus.OK, {
                        "ok": True,
                        "bridge_url": bridge.address(),
                        "session_count": len(bridge.list_sessions()),
                    })
                elif path == "/sessions":
                    self._send(HTTPStatus.OK, {
                        "ok": True,
                        "sessions": [s.to_json() for s in bridge.list_sessions()],
                    })
                else:
                    self._send(HTTPStatus.NOT_FOUND, {"ok": False, "error": "not found"})

            def do_POST(self):
                path = urlparse(self.path).path
                if path == "/session/start":
                    payload = self._json_body()
                    if payload is None:
                        self._send(HTTPStatus.BAD_REQUEST, {"ok": False, "error": "invalid json"})
                        return
                    info = bridge.upsert_session(payload)
                    self._send(HTTPStatus.OK, {
                        "ok": True, "session_id": info.session_id, "bridge_url": bridge.address(),
                    })
                    return
                m = re.fullmatch(r"/session/([^/]+)/stop", path)
                if m:
                    bridge.close_session(m.group(1))
                    self._send(HTTPStatus.OK, {"ok": True})
                    return
                m = re.fullmatch(r"/session/([^/]+)/keepalive", path)
                if m:
                    payload = self._json_body()
                    if payload is None:
                        self._send(HTTPStatus.BAD_REQUEST, {"ok": False, "error": "invalid json"})
                        return
                    try:
                        info = bridge.touch_session(m.group(1), payload)
                    except SessionClosedError as exc:
                        self._send(HTTPStatus.GONE, {"ok": False, "error": str(exc)})
                        return
                    self._send(HTTPStatus.OK, {
                        "ok": True, "session_id": info.session_id, "has_audio": info.has_audio,
                    })
                    return
                self._send(HTTPStatus.NOT_FOUND, {"ok": False, "error": "not found"})

        return Handler
