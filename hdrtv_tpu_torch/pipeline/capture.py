"""Real capture grabber backends for :class:`~hdrtv_tpu_torch.pipeline.live.LiveSource`
(the port's copy of ``hdrtv_tpu/pipeline/capture.py``).

The reference captures browser windows through WinRT Graphics Capture with a
GDI fallback and window enumeration/match scoring
(window_capture_source.py:427-728, :832-1058). The POSIX equivalents here:

- **X11**: ctypes ``libX11`` — ``XGetImage`` (ZPixmap) of the root window or
  a specific window, plus ``XQueryTree``/``XFetchName`` enumeration with the
  reference's match-score tiers (window id ≫ pid ≫ title ≫ class ≫ size).
- **v4l2**: ctypes ioctls on ``/dev/video*`` — mmap streaming capture
  (QUERYCAP → S_FMT YUYV → REQBUFS → STREAMON → DQBUF loop).
- **synthetic**: the deterministic pattern grabber (tests/headless).

``make_grabber`` resolves a backend spec with the fallback ladder
x11 → v4l2 → synthetic, mirroring the capture-source recovery policy
(README.md:333 — a lost source is a clean stop, not a crash).

Pixel conversions (BGRA→BGR, YUYV→BGR) are pure numpy functions so they are
unit-testable without a display or camera.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import fcntl
import mmap
import os
import re

import numpy as np

__all__ = [
    "WindowTarget",
    "target_match_score",
    "find_best_matching_target",
    "bgra_to_bgr",
    "yuyv_to_bgr",
    "X11Grabber",
    "V4L2Grabber",
    "make_grabber",
    "list_x11_windows",
]


# ---------------------------------------------------------------------------
# Window targets + match scoring (window_capture_source.py:832-906 semantics)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WindowTarget:
    """A capture candidate. ``wid`` is the X11 window id (the hwnd analog)."""

    title: str = ""
    wid: int = 0
    pid: int = 0
    wm_class: str = ""
    width: int = 0
    height: int = 0


def _norm_text(s: str) -> str:
    return re.sub(r"\s+", " ", str(s or "").strip().lower())


def target_match_score(candidate: WindowTarget | None, reference: WindowTarget | None) -> int:
    """Tiered match score for re-finding a window across capture restarts.

    Same tier ordering as the reference's ``_target_match_score``
    (window_capture_source.py:832): exact native handle dominates, then pid,
    then url/title, then class, then size; −1 means no usable overlap.
    """
    if candidate is None or reference is None:
        return -1
    score = 0
    if candidate.wid > 0 and reference.wid > 0 and candidate.wid == reference.wid:
        score += 20_000
    if candidate.pid > 0 and reference.pid > 0 and candidate.pid == reference.pid:
        score += 800
    ct, rt = _norm_text(candidate.title), _norm_text(reference.title)
    if ct and rt:
        if ct == rt:
            score += 300
        elif ct in rt or rt in ct:
            score += 180
    cc, rc = _norm_text(candidate.wm_class), _norm_text(reference.wm_class)
    if cc and rc and cc == rc:
        score += 60
    if (
        candidate.width > 0
        and candidate.height > 0
        and candidate.width == reference.width
        and candidate.height == reference.height
    ):
        score += 20
    return score if score > 0 else -1


def find_best_matching_target(
    targets: list[WindowTarget], reference: WindowTarget | None
) -> WindowTarget | None:
    """Highest-scoring candidate, or None (find_best_matching_window_capture_target)."""
    if reference is None:
        return None
    best, best_score = None, -1
    for t in targets or []:
        s = target_match_score(t, reference)
        if s > best_score:
            best, best_score = t, s
    return best


# ---------------------------------------------------------------------------
# Pixel conversions (pure, unit-testable)
# ---------------------------------------------------------------------------


def bgra_to_bgr(buf: bytes | np.ndarray, width: int, height: int) -> np.ndarray:
    """X11 ZPixmap 32-bpp little-endian (B,G,R,X byte order) → BGR uint8 HWC."""
    a = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    return a.reshape(height, width, 4)[..., :3].copy()


def yuyv_to_bgr(buf: bytes | np.ndarray, width: int, height: int) -> np.ndarray:
    """V4L2 YUYV 4:2:2 → BGR uint8 HWC (BT.601 studio-range math, the v4l2
    default for webcams)."""
    a = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    a = a.reshape(height, width // 2, 4).astype(np.float32)
    y0, u, y1, v = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    y = np.empty((height, width), np.float32)
    y[:, 0::2], y[:, 1::2] = y0, y1
    u = np.repeat(u, 2, axis=1) - 128.0
    v = np.repeat(v, 2, axis=1) - 128.0
    c = 1.164 * (y - 16.0)
    r = c + 1.596 * v
    g = c - 0.392 * u - 0.813 * v
    b = c + 2.017 * u
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# X11 backend (ctypes libX11)
# ---------------------------------------------------------------------------

_ZPixmap = 2
_AllPlanes = 0xFFFFFFFF


class _XImage(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("xoffset", ctypes.c_int),
        ("format", ctypes.c_int),
        ("data", ctypes.c_char_p),
        ("byte_order", ctypes.c_int),
        ("bitmap_unit", ctypes.c_int),
        ("bitmap_bit_order", ctypes.c_int),
        ("bitmap_pad", ctypes.c_int),
        ("depth", ctypes.c_int),
        ("bytes_per_line", ctypes.c_int),
        ("bits_per_pixel", ctypes.c_int),
    ]


def _load_x11():
    name = ctypes.util.find_library("X11")
    if not name:
        raise RuntimeError("libX11 not found")
    lib = ctypes.CDLL(name)
    lib.XOpenDisplay.restype = ctypes.c_void_p
    lib.XOpenDisplay.argtypes = [ctypes.c_char_p]
    lib.XDefaultRootWindow.restype = ctypes.c_ulong
    lib.XDefaultRootWindow.argtypes = [ctypes.c_void_p]
    lib.XGetImage.restype = ctypes.POINTER(_XImage)
    lib.XGetImage.argtypes = [
        ctypes.c_void_p, ctypes.c_ulong, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_uint, ctypes.c_ulong, ctypes.c_int,
    ]
    lib.XDestroyImage.argtypes = [ctypes.POINTER(_XImage)]
    lib.XCloseDisplay.argtypes = [ctypes.c_void_p]
    lib.XGetWindowAttributes.argtypes = [ctypes.c_void_p, ctypes.c_ulong, ctypes.c_void_p]
    lib.XQueryTree.argtypes = [
        ctypes.c_void_p, ctypes.c_ulong,
        ctypes.POINTER(ctypes.c_ulong), ctypes.POINTER(ctypes.c_ulong),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_ulong)), ctypes.POINTER(ctypes.c_uint),
    ]
    lib.XFetchName.argtypes = [
        ctypes.c_void_p, ctypes.c_ulong, ctypes.POINTER(ctypes.c_char_p)
    ]
    lib.XFree.argtypes = [ctypes.c_void_p]
    return lib


class _XWindowAttributes(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_int), ("y", ctypes.c_int),
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("border_width", ctypes.c_int), ("depth", ctypes.c_int),
        ("visual", ctypes.c_void_p), ("root", ctypes.c_ulong),
        ("c_class", ctypes.c_int), ("bit_gravity", ctypes.c_int),
        ("win_gravity", ctypes.c_int), ("backing_store", ctypes.c_int),
        ("backing_planes", ctypes.c_ulong), ("backing_pixel", ctypes.c_ulong),
        ("save_under", ctypes.c_int), ("colormap", ctypes.c_ulong),
        ("map_installed", ctypes.c_int), ("map_state", ctypes.c_int),
        ("all_event_masks", ctypes.c_long), ("your_event_mask", ctypes.c_long),
        ("do_not_propagate_mask", ctypes.c_long),
        ("override_redirect", ctypes.c_int), ("screen", ctypes.c_void_p),
    ]


def list_x11_windows(display: str | None = None) -> list[WindowTarget]:
    """Top-level window enumeration (the XQueryTree analog of the reference's
    WinRT window list, window_capture_source.py:907-1058)."""
    lib = _load_x11()
    dpy = lib.XOpenDisplay(display.encode() if display else None)
    if not dpy:
        raise RuntimeError("cannot open X display")
    out: list[WindowTarget] = []
    try:
        root = lib.XDefaultRootWindow(dpy)
        r, par = ctypes.c_ulong(), ctypes.c_ulong()
        children = ctypes.POINTER(ctypes.c_ulong)()
        n = ctypes.c_uint()
        if not lib.XQueryTree(dpy, root, ctypes.byref(r), ctypes.byref(par), ctypes.byref(children), ctypes.byref(n)):
            return out
        try:
            for i in range(n.value):
                wid = children[i]
                attrs = _XWindowAttributes()
                if not lib.XGetWindowAttributes(dpy, wid, ctypes.byref(attrs)):
                    continue
                if attrs.map_state != 2:  # IsViewable
                    continue
                name = ctypes.c_char_p()
                title = ""
                if lib.XFetchName(dpy, wid, ctypes.byref(name)) and name.value:
                    title = name.value.decode("utf-8", "replace")
                    lib.XFree(name)
                out.append(WindowTarget(title=title, wid=int(wid), width=attrs.width, height=attrs.height))
        finally:
            if children:
                lib.XFree(children)
    finally:
        lib.XCloseDisplay(dpy)
    return out


class X11Grabber:
    """Screen/window grabber over ctypes libX11 (no python-xlib dependency).

    ``target``: None → full root window; a :class:`WindowTarget` or title
    substring → best-matching window (re-matched once at construction; a
    destroyed window makes the grabber return None, triggering the
    LiveSource clean-stop policy).
    """

    def __init__(self, target: WindowTarget | str | None = None, display: str | None = None):
        self._lib = _load_x11()
        self._dpy = self._lib.XOpenDisplay(display.encode() if display else None)
        if not self._dpy:
            raise RuntimeError("cannot open X display")
        if target is None:
            self._wid = self._lib.XDefaultRootWindow(self._dpy)
        else:
            ref = WindowTarget(title=target) if isinstance(target, str) else target
            best = find_best_matching_target(list_x11_windows(display), ref)
            if best is None:
                self._lib.XCloseDisplay(self._dpy)
                raise RuntimeError(f"no X11 window matches {ref!r}")
            self._wid = best.wid
        self.target = target

    def __call__(self) -> np.ndarray | None:
        attrs = _XWindowAttributes()
        if not self._lib.XGetWindowAttributes(self._dpy, self._wid, ctypes.byref(attrs)):
            return None  # window gone → source lost
        img_p = self._lib.XGetImage(
            self._dpy, self._wid, 0, 0, attrs.width, attrs.height, _AllPlanes, _ZPixmap
        )
        if not img_p:
            return None
        try:
            img = img_p.contents
            if img.bits_per_pixel != 32:
                return None
            nbytes = img.bytes_per_line * img.height
            raw = ctypes.string_at(img.data, nbytes)
            a = np.frombuffer(raw, np.uint8).reshape(img.height, img.bytes_per_line // 4, 4)
            return bgra_to_bgr(a[:, : img.width].copy(), img.width, img.height)
        finally:
            self._lib.XDestroyImage(img_p)

    def close(self):
        if self._dpy:
            self._lib.XCloseDisplay(self._dpy)
            self._dpy = None


# ---------------------------------------------------------------------------
# v4l2 backend (ctypes ioctl, mmap streaming)
# ---------------------------------------------------------------------------

# ioctl numbers (videodev2.h, stable ABI)
_VIDIOC_QUERYCAP = 0x80685600
_VIDIOC_S_FMT = 0xC0D05605
_VIDIOC_REQBUFS = 0xC0145608
_VIDIOC_QUERYBUF = 0xC0585609
_VIDIOC_QBUF = 0xC058560F
_VIDIOC_DQBUF = 0xC0585611
_VIDIOC_STREAMON = 0x40045612
_VIDIOC_STREAMOFF = 0x40045613
_V4L2_BUF_TYPE_VIDEO_CAPTURE = 1
_V4L2_MEMORY_MMAP = 1
_V4L2_PIX_FMT_YUYV = 0x56595559  # 'YUYV'


class _v4l2_pix_format(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_uint32), ("height", ctypes.c_uint32),
        ("pixelformat", ctypes.c_uint32), ("field", ctypes.c_uint32),
        ("bytesperline", ctypes.c_uint32), ("sizeimage", ctypes.c_uint32),
        ("colorspace", ctypes.c_uint32), ("priv", ctypes.c_uint32),
        ("flags", ctypes.c_uint32), ("enc", ctypes.c_uint32),
        ("quantization", ctypes.c_uint32), ("xfer_func", ctypes.c_uint32),
    ]


class _v4l2_format(ctypes.Structure):
    _fields_ = [("type", ctypes.c_uint32), ("pad", ctypes.c_uint32), ("pix", _v4l2_pix_format), ("raw", ctypes.c_uint8 * 156)]


class _v4l2_requestbuffers(ctypes.Structure):
    _fields_ = [("count", ctypes.c_uint32), ("type", ctypes.c_uint32), ("memory", ctypes.c_uint32), ("reserved", ctypes.c_uint32 * 2)]


class _v4l2_buffer(ctypes.Structure):
    class _m(ctypes.Union):
        _fields_ = [("offset", ctypes.c_uint32), ("userptr", ctypes.c_ulong), ("fd", ctypes.c_int32)]

    _fields_ = [
        ("index", ctypes.c_uint32), ("type", ctypes.c_uint32),
        ("bytesused", ctypes.c_uint32), ("flags", ctypes.c_uint32),
        ("field", ctypes.c_uint32), ("pad0", ctypes.c_uint32),
        ("timestamp_sec", ctypes.c_long), ("timestamp_usec", ctypes.c_long),
        ("timecode", ctypes.c_uint8 * 16), ("sequence", ctypes.c_uint32),
        ("memory", ctypes.c_uint32), ("m", _m),
        ("length", ctypes.c_uint32), ("reserved2", ctypes.c_uint32),
        ("reserved", ctypes.c_uint32),
    ]


class V4L2Grabber:
    """Webcam/capture-card grabber over raw v4l2 ioctls (YUYV mmap streaming)."""

    def __init__(self, device: str = "/dev/video0", width: int = 1280, height: int = 720, n_buffers: int = 3):
        self.device = device
        self._fd = os.open(device, os.O_RDWR | os.O_NONBLOCK)
        try:
            fmt = _v4l2_format()
            fmt.type = _V4L2_BUF_TYPE_VIDEO_CAPTURE
            fmt.pix.width, fmt.pix.height = width, height
            fmt.pix.pixelformat = _V4L2_PIX_FMT_YUYV
            fmt.pix.field = 1  # NONE
            fcntl.ioctl(self._fd, _VIDIOC_S_FMT, fmt)
            if fmt.pix.pixelformat != _V4L2_PIX_FMT_YUYV:
                raise RuntimeError("device does not support YUYV")
            self.width, self.height = fmt.pix.width, fmt.pix.height

            req = _v4l2_requestbuffers()
            req.count, req.type, req.memory = n_buffers, _V4L2_BUF_TYPE_VIDEO_CAPTURE, _V4L2_MEMORY_MMAP
            fcntl.ioctl(self._fd, _VIDIOC_REQBUFS, req)
            self._maps = []
            for i in range(req.count):
                buf = _v4l2_buffer()
                buf.index, buf.type, buf.memory = i, _V4L2_BUF_TYPE_VIDEO_CAPTURE, _V4L2_MEMORY_MMAP
                fcntl.ioctl(self._fd, _VIDIOC_QUERYBUF, buf)
                self._maps.append(mmap.mmap(self._fd, buf.length, offset=buf.m.offset))
                fcntl.ioctl(self._fd, _VIDIOC_QBUF, buf)
            fcntl.ioctl(self._fd, _VIDIOC_STREAMON, ctypes.c_int(_V4L2_BUF_TYPE_VIDEO_CAPTURE))
        except Exception:
            os.close(self._fd)
            raise

    def __call__(self) -> np.ndarray | None:
        import select

        r, _, _ = select.select([self._fd], [], [], 2.0)
        if not r:
            return None
        buf = _v4l2_buffer()
        buf.type, buf.memory = _V4L2_BUF_TYPE_VIDEO_CAPTURE, _V4L2_MEMORY_MMAP
        try:
            fcntl.ioctl(self._fd, _VIDIOC_DQBUF, buf)
        except OSError:
            return None
        try:
            if buf.bytesused < self.width * self.height * 2:
                # Short DQBUF payload (corrupted capture): honor the
                # return-None clean-stop contract instead of crashing on the
                # reshape; the finally re-queues the buffer.
                return None
            raw = self._maps[buf.index][: buf.bytesused]
            return yuyv_to_bgr(bytes(raw), self.width, self.height)
        finally:
            fcntl.ioctl(self._fd, _VIDIOC_QBUF, buf)

    def close(self):
        try:
            fcntl.ioctl(self._fd, _VIDIOC_STREAMOFF, ctypes.c_int(_V4L2_BUF_TYPE_VIDEO_CAPTURE))
        except OSError:
            pass
        for m in self._maps:
            m.close()
        os.close(self._fd)


# ---------------------------------------------------------------------------
# Factory / fallback ladder
# ---------------------------------------------------------------------------


def make_grabber(spec: str | None = None, **kw):
    """Resolve a grabber spec with the x11 → v4l2 → synthetic ladder.

    Specs: ``"x11"`` / ``"x11:Title Substring"`` / ``"v4l2"`` /
    ``"v4l2:/dev/video1"`` / ``"synthetic"`` / None (auto).
    """
    from hdrtv_tpu_torch.pipeline.live import synthetic_grabber

    spec = (spec or "auto").strip()
    kind, _, arg = spec.partition(":")
    kind = kind.lower()

    if kind in ("x11", "auto") and os.environ.get("DISPLAY"):
        try:
            return X11Grabber(arg or None)
        except Exception:
            if kind == "x11":
                raise
    if kind in ("v4l2", "auto"):
        dev = arg or "/dev/video0"
        if os.path.exists(dev):
            try:
                return V4L2Grabber(dev, **kw)
            except Exception:
                if kind == "v4l2":
                    raise
        elif kind == "v4l2":
            raise RuntimeError(f"{dev} does not exist")
    if kind == "synthetic" or kind == "auto":
        return synthetic_grabber(**kw) if kw else synthetic_grabber()
    raise ValueError(f"unknown grabber spec {spec!r}")
