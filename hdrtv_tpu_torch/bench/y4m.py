"""Pure-numpy Y4M (YUV4MPEG2) IO + YCbCr color conversion (the port's copy of
``hdrtv_tpu/bench/y4m.py``; the y4m export and ``Y4MFileSink`` write with it).

Role: the binary-free *exact* GT path. The reference decodes HDR ground
truth through FFmpeg as rawvideo rgb48le (gui_hdr_io.py:205-487); where
ffmpeg is missing, the cv2 fallback flattens 10-bit sources to 8-bit
(bench/gt_sync.py). Y4M is a fixed-stride raw container — a plain-file
header line plus ``FRAME\\n`` + planar YUV per frame — so a numpy reader
gets bit-exact O(1) random access to 10/12-bit planar video with no binary
dependency at all. ``HDRGroundTruthReader`` uses it for ``*.y4m`` GT
(``decode_method="y4m-native-exact"``), preserving full bit depth without ffmpeg,
and the writer lets tests and the export fallback produce real 10-bit
files that ffmpeg/mpv also read.

Color model: Y4M headers carry no matrix/primaries tags (ffmpeg emits only
``XCOLORRANGE``), so conversion defaults follow delivery practice — BT.2020
non-constant-luminance for >8-bit streams, BT.709 for 8-bit — and both the
matrix and the range are overridable per call. Subsampled chroma (420/422)
upsamples bilinearly with edge replication (swscale-like); tests that need
bit-exact RGB round-trips use 444.
"""

from __future__ import annotations

import os

import numpy as np

# BT.601/709/2020-NCL luma coefficients (Rec. ITU-R BT.2020-2 Table 4;
# BT.709-6 §3; conversion equations identical in form across the three).
MATRICES = {
    "bt601": (0.299, 0.114),
    "bt709": (0.2126, 0.0722),
    "bt2020nc": (0.2627, 0.0593),
}

# Y4M C-tag → (chroma x-subsampling, y-subsampling, bits). The bare tags
# are 8-bit; pN suffixes give the depth. 420 sub-variants (jpeg/mpeg2/
# paldv) differ only in chroma siting, which the bilinear upsample here
# does not model — they parse to plain 420 geometry.
_CTAGS = {
    "mono": (0, 0, 8),
    "420": (2, 2, 8),
    "420jpeg": (2, 2, 8),
    "420mpeg2": (2, 2, 8),
    "420paldv": (2, 2, 8),
    "422": (2, 1, 8),
    "444": (1, 1, 8),
}
for _base, (_sx, _sy) in (("420", (2, 2)), ("422", (2, 1)), ("444", (1, 1))):
    for _bits in (9, 10, 12, 14, 16):
        _CTAGS[f"{_base}p{_bits}"] = (_sx, _sy, _bits)
for _bits in (9, 10, 12, 14, 16):
    _CTAGS[f"monop{_bits}"] = (0, 0, _bits)


class Y4MFormat:
    """Parsed stream geometry: shapes, strides, dtype."""

    def __init__(self, width: int, height: int, ctag: str, fps: float,
                 full_range: bool, header_len: int):
        if ctag not in _CTAGS:
            raise ValueError(f"unsupported Y4M colorspace C{ctag}")
        self.width, self.height, self.ctag, self.fps = width, height, ctag, fps
        self.full_range = full_range
        self.header_len = header_len
        sx, sy, bits = _CTAGS[ctag]
        self.bits = bits
        self.dtype = np.dtype("<u2") if bits > 8 else np.dtype("u1")
        self.mono = sx == 0
        if self.mono:
            self.chroma_shape = (0, 0)
        else:
            if width % sx or height % sy:
                raise ValueError(f"{width}x{height} not divisible for C{ctag}")
            self.chroma_shape = (height // sy, width // sx)
        self.luma_bytes = width * height * self.dtype.itemsize
        ch, cw = self.chroma_shape
        self.chroma_bytes = ch * cw * self.dtype.itemsize
        self.frame_bytes = self.luma_bytes + 2 * self.chroma_bytes
        # every frame: b"FRAME" [params] b"\n" + planes; we write bare FRAME
        # markers and require them on read (ffmpeg does the same by default)
        self.record_bytes = 6 + self.frame_bytes

    def frame_offset(self, idx: int) -> int:
        return self.header_len + idx * self.record_bytes


def _parse_ratio(tok: str, default: float) -> float:
    try:
        num, den = tok.split(":")
        return float(num) / float(den) if float(den) else default
    except (ValueError, ZeroDivisionError):
        return default


def parse_header(line: bytes, header_len: int) -> Y4MFormat:
    text = line.decode("ascii", "replace").strip()
    if not text.startswith("YUV4MPEG2"):
        raise ValueError("not a YUV4MPEG2 stream")
    width = height = 0
    fps = 30.0
    ctag = "420"
    full_range = False
    for tok in text.split()[1:]:
        key, val = tok[0], tok[1:]
        if key == "W":
            width = int(val)
        elif key == "H":
            height = int(val)
        elif key == "F":
            fps = _parse_ratio(val, 30.0)
        elif key == "C":
            ctag = val
        elif key == "X" and val.upper() in ("COLORRANGE=FULL", "COLORRANGE=LIMITED"):
            full_range = val.upper().endswith("FULL")
    if width <= 0 or height <= 0:
        raise ValueError("Y4M header missing W/H")
    return Y4MFormat(width, height, ctag, fps, full_range, header_len)


def _upsample(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear chroma upsample with edge replication (float32 out)."""
    ch, cw = plane.shape
    if (ch, cw) == (h, w):
        return plane.astype(np.float32)
    p = plane.astype(np.float32)
    # sample positions: chroma grid centers aligned to luma grid (center-
    # sited, the 420jpeg convention; siting differences are < 1/2 chroma px)
    ys = (np.arange(h) + 0.5) * (ch / h) - 0.5
    xs = (np.arange(w) + 0.5) * (cw / w) - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, ch - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, cw - 1)
    y1 = np.minimum(y0 + 1, ch - 1)
    x1 = np.minimum(x0 + 1, cw - 1)
    fy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)[:, None]
    fx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)[None, :]
    top = p[y0][:, x0] * (1 - fx) + p[y0][:, x1] * fx
    bot = p[y1][:, x0] * (1 - fx) + p[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def default_matrix(fmt: Y4MFormat) -> str:
    return "bt2020nc" if fmt.bits > 8 else "bt709"


def ycbcr_to_rgb_unit(
    y: np.ndarray, cb: np.ndarray, cr: np.ndarray, *, bits: int,
    matrix: str = "bt2020nc", full_range: bool = False,
) -> np.ndarray:
    """Planar code values → [0,1] non-linear RGB float32 (HWC).

    Limited range uses the standard 8-bit-scaled excursions (Y: 16·2^(b-8)
    + 219·2^(b-8); C: ±112·2^(b-8) around 2^(b-1)) — BT.2020-2 Table 5.
    """
    kr, kb = MATRICES[matrix]
    kg = 1.0 - kr - kb
    scale = float(1 << (bits - 8))
    if full_range:
        y01 = y.astype(np.float32) / float((1 << bits) - 1)
        cmax = float((1 << bits) - 1)
        pb = (cb.astype(np.float32) - (1 << (bits - 1))) / cmax
        pr = (cr.astype(np.float32) - (1 << (bits - 1))) / cmax
    else:
        y01 = (y.astype(np.float32) - 16.0 * scale) / (219.0 * scale)
        pb = (cb.astype(np.float32) - float(1 << (bits - 1))) / (224.0 * scale)
        pr = (cr.astype(np.float32) - float(1 << (bits - 1))) / (224.0 * scale)
    r = y01 + 2.0 * (1.0 - kr) * pr
    b = y01 + 2.0 * (1.0 - kb) * pb
    g = (y01 - kr * r - kb * b) / kg
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def rgb_unit_to_ycbcr(
    rgb01: np.ndarray, *, bits: int, matrix: str = "bt2020nc",
    full_range: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[0,1] non-linear RGB (HWC float) → full-resolution planar code values."""
    kr, kb = MATRICES[matrix]
    kg = 1.0 - kr - kb
    r = rgb01[..., 0].astype(np.float32)
    g = rgb01[..., 1].astype(np.float32)
    b = rgb01[..., 2].astype(np.float32)
    y01 = kr * r + kg * g + kb * b
    pb = (b - y01) / (2.0 * (1.0 - kb))
    pr = (r - y01) / (2.0 * (1.0 - kr))
    scale = float(1 << (bits - 8))
    dtype = np.uint16 if bits > 8 else np.uint8
    cmax = (1 << bits) - 1
    if full_range:
        yc = np.round(y01 * cmax)
        cbc = np.round(pb * cmax + (1 << (bits - 1)))
        crc = np.round(pr * cmax + (1 << (bits - 1)))
    else:
        yc = np.round(y01 * 219.0 * scale + 16.0 * scale)
        cbc = np.round(pb * 224.0 * scale + float(1 << (bits - 1)))
        crc = np.round(pr * 224.0 * scale + float(1 << (bits - 1)))
    clip = lambda v: np.clip(v, 0, cmax).astype(dtype)
    return clip(yc), clip(cbc), clip(crc)


class Y4MReader:
    """O(1) random-access frame reader over a seekable Y4M file."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        line = self._f.readline(4096)
        if not line.endswith(b"\n"):
            self._f.close()
            raise ValueError(f"{path}: unterminated Y4M header")
        self.fmt = parse_header(line, len(line))
        size = os.fstat(self._f.fileno()).st_size
        self.frame_count = max(0, (size - self.fmt.header_len) // self.fmt.record_bytes)

    @property
    def fps(self) -> float:
        return self.fmt.fps

    def read_planes(self, idx: int) -> tuple[np.ndarray, np.ndarray | None, np.ndarray | None]:
        """Frame ``idx`` as (Y, Cb, Cr) code-value planes (None chroma = mono)."""
        fmt = self.fmt
        if not 0 <= idx < self.frame_count:
            raise IndexError(f"frame {idx} out of range [0,{self.frame_count})")
        self._f.seek(fmt.frame_offset(idx))
        marker = self._f.read(6)
        if marker != b"FRAME\n":
            # Must be EXACT: record_bytes assumes bare 6-byte markers, so a
            # parameterized FRAME line (legal Y4M, e.g. "FRAME Ip\n") would
            # shift every plane offset — reject loudly, never decode skewed.
            raise ValueError(
                f"{self.path}: unsupported FRAME marker {marker!r} at index {idx} "
                "(parameterized frame headers are not supported)"
            )
        raw = self._f.read(fmt.frame_bytes)
        if len(raw) != fmt.frame_bytes:
            raise ValueError(f"{self.path}: truncated frame {idx}")
        h, w = fmt.height, fmt.width
        y = np.frombuffer(raw, fmt.dtype, count=h * w).reshape(h, w)
        if fmt.mono:
            return y, None, None
        ch, cw = fmt.chroma_shape
        n = ch * cw
        cb = np.frombuffer(raw, fmt.dtype, count=n, offset=fmt.luma_bytes).reshape(ch, cw)
        cr = np.frombuffer(
            raw, fmt.dtype, count=n, offset=fmt.luma_bytes + fmt.chroma_bytes
        ).reshape(ch, cw)
        return y, cb, cr

    def read_rgb_unit(self, idx: int, *, matrix: str | None = None) -> np.ndarray:
        """Frame ``idx`` as [0,1] RGB float32 HWC at full container depth."""
        fmt = self.fmt
        y, cb, cr = self.read_planes(idx)
        if cb is None:
            cmax = float((1 << fmt.bits) - 1)
            y01 = (
                y.astype(np.float32) / cmax
                if fmt.full_range
                else np.clip(
                    (y.astype(np.float32) - 16.0 * (cmax + 1) / 256.0)
                    / (219.0 * (cmax + 1) / 256.0),
                    0.0, 1.0,
                )
            )
            return np.repeat(y01[..., None], 3, axis=-1)
        h, w = fmt.height, fmt.width
        if cb.shape != (h, w):
            cbf, crf = _upsample(cb, h, w), _upsample(cr, h, w)
        else:
            cbf, crf = cb, cr
        return ycbcr_to_rgb_unit(
            y, cbf, crf, bits=fmt.bits,
            matrix=matrix or default_matrix(fmt), full_range=fmt.full_range,
        )

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Y4MWriter:
    """Sequential Y4M writer (444/420/422 at 8–16 bit)."""

    def __init__(self, path: str, width: int, height: int, *, fps: float = 30.0,
                 ctag: str = "444p10", full_range: bool = False):
        if ctag not in _CTAGS:
            raise ValueError(f"unsupported Y4M colorspace C{ctag}")
        # Best rational with the NTSC-scale denominator bound: 12.5 → 25:2,
        # 23.976… → x:1001-family, integers → n:1.
        from fractions import Fraction

        frac = Fraction(fps).limit_denominator(1001)
        num, den = frac.numerator, frac.denominator
        rng = "FULL" if full_range else "LIMITED"
        header = f"YUV4MPEG2 W{width} H{height} F{num}:{den} Ip A1:1 C{ctag} XCOLORRANGE={rng}\n"
        self._f = open(path, "wb")
        self._f.write(header.encode("ascii"))
        self.fmt = Y4MFormat(width, height, ctag, fps, full_range, len(header))
        self.frames_written = 0

    def write_planes(self, y: np.ndarray, cb: np.ndarray | None = None,
                     cr: np.ndarray | None = None) -> None:
        fmt = self.fmt
        self._f.write(b"FRAME\n")
        self._f.write(np.ascontiguousarray(y, fmt.dtype).tobytes())
        if not fmt.mono:
            ch, cw = fmt.chroma_shape
            for c in (cb, cr):
                assert c is not None and c.shape == (ch, cw), "bad chroma plane"
                self._f.write(np.ascontiguousarray(c, fmt.dtype).tobytes())
        self.frames_written += 1

    def write_rgb_unit(self, rgb01: np.ndarray, *, matrix: str | None = None) -> None:
        """[0,1] RGB HWC → code values (box-filter chroma when subsampled)."""
        fmt = self.fmt
        y, cb, cr = rgb_unit_to_ycbcr(
            rgb01, bits=fmt.bits,
            matrix=matrix or default_matrix(fmt), full_range=fmt.full_range,
        )
        if not fmt.mono and fmt.chroma_shape != (fmt.height, fmt.width):
            ch, cw = fmt.chroma_shape
            sy, sx = fmt.height // ch, fmt.width // cw

            def box(p):
                v = p.astype(np.float32).reshape(ch, sy, cw, sx).mean(axis=(1, 3))
                return np.round(v).astype(p.dtype)

            cb, cr = box(cb), box(cr)
        self.write_planes(y, cb, cr)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def probe_y4m(path: str) -> dict:
    """Header-only probe in hdr_io.probe_video's result shape."""
    with Y4MReader(path) as r:
        return {
            "width": r.fmt.width,
            "height": r.fmt.height,
            "fps": r.fmt.fps,
            "frames": r.frame_count,
            "duration": r.frame_count / r.fmt.fps if r.fmt.fps else None,
            "pix_fmt": f"yuv{r.fmt.ctag}",
        }
