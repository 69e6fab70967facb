"""Optional HDR-VDP3 bridge — external CLI hook (the port of
``hdrtv_tpu/bench/hdrvdp3.py``).

The reference scores HDR-VDP3 through an Octave subprocess bridge
(scripts/hdrvdp3_bridge.py: decode BT.2100 PQ → absolute luminance →
hdrvdp3('side-by-side', ...)), invoked via a command template in
``HDRTVNET_HDRVDP3_CMD`` with ``{test}``/``{reference}``/``{encoding}``
placeholders (gui_objective_metrics.py:548-614).

This module keeps the same contract: write the pair as PQ-encoded 16-bit
PNGs (TIFF in the reference; PNG avoids an extra dependency — HDR-VDP3
reads both), run the template, parse the last float on stdout. Everything is
gated: no env var → (None, "disabled").
"""

from __future__ import annotations

import os
import re
import subprocess
import tempfile

import numpy as np

from hdrtv_tpu_torch.utils.env import env_str

HDRVDP3_CMD_ENV = "HDRTVNET_HDRVDP3_CMD"


def pq_encode_u16(rgb01: np.ndarray, peak_nits: float = 1000.0) -> np.ndarray:
    """Unit-range linear RGB → BT.2100 PQ uint16 code values (the bridge's
    input encoding — gui_objective_metrics.py:536-545). Host arrays in and
    out, for the files the external tool reads: the torch ops run on the CPU."""
    import torch

    from hdrtv_tpu_torch.ops.color import pq_oetf

    nits = torch.from_numpy(np.asarray(rgb01, np.float32)).clamp(0.0, 1.0) * peak_nits
    pq = pq_oetf(nits)
    return (pq * 65535.0 + 0.5).clamp(0, 65535).to(torch.int32).numpy().astype(np.uint16)


def hdrvdp3_score(
    pred_rgb01: np.ndarray,
    ref_rgb01: np.ndarray,
    *,
    peak_nits: float = 1000.0,
    encoding: str = "pq",
    timeout_s: float = 300.0,
) -> tuple[float | None, str]:
    """Run the external HDR-VDP3 command; (score, status).

    With ``HDRTVNET_HDRVDP_CACHE_DIR`` set, scores are cached per content
    hash (the reference's HDR-VDP score cache, gui_objective_metrics.py
    HDRVDP_CACHE_DIR) — the Octave bridge costs seconds per pair.
    """
    cmd_tpl = env_str(HDRVDP3_CMD_ENV).strip()
    if not cmd_tpl:
        return None, "disabled (set HDRTVNET_HDRVDP3_CMD)"

    cache_dir = env_str("HDRTVNET_HDRVDP_CACHE_DIR").strip()
    cache_file = None
    if cache_dir:
        import hashlib

        h = hashlib.sha1()
        for a in (pred_rgb01, ref_rgb01):
            arr = np.ascontiguousarray(a, np.float32)
            h.update(arr.shape.__repr__().encode())
            h.update(arr.tobytes())
        h.update(f"{peak_nits}|{encoding}|{cmd_tpl}".encode())
        os.makedirs(cache_dir, exist_ok=True)
        cache_file = os.path.join(cache_dir, h.hexdigest() + ".txt")
        if os.path.isfile(cache_file):
            try:
                with open(cache_file) as f:
                    return float(f.read().strip()), "ok (cached)"
            except (ValueError, OSError):
                pass
    import cv2

    with tempfile.TemporaryDirectory(prefix="hdrvdp3_") as td:
        test_path = os.path.join(td, "test.png")
        ref_path = os.path.join(td, "reference.png")
        cv2.imwrite(test_path, pq_encode_u16(pred_rgb01, peak_nits)[..., ::-1])
        cv2.imwrite(ref_path, pq_encode_u16(ref_rgb01, peak_nits)[..., ::-1])
        cmd = cmd_tpl.format(test=test_path, reference=ref_path, encoding=encoding)
        try:
            cp = subprocess.run(cmd, shell=True, capture_output=True, timeout=timeout_s, text=True)
        except subprocess.TimeoutExpired:
            return None, "timeout"
        if cp.returncode != 0:
            return None, f"exit {cp.returncode}: {cp.stderr[-200:]}"
        floats = re.findall(r"[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?", cp.stdout)
        if not floats:
            return None, "no score in output"
        score = float(floats[-1])
        if cache_file:
            try:
                with open(cache_file, "w") as f:
                    f.write(repr(score))
            except OSError:
                pass
        return score, "ok"
