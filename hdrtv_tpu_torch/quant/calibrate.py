"""PTQ activation calibration for W8A8 layers (port of
``hdrtv_tpu/quant/calibrate.py``).

Run calibration frames through the weight-quantized model (the
natural-layout program, ``models/hdrtvnet.py model_apply``, in fp32 with
TF32 off) while capturing each quantized layer's *input* range, then set
per-tensor activation scales:

  symmetric:  x_scale = max|x| / 127          (method="max")
  asymmetric: x_zero = min(x), x_scale = (max - min) / 255
  percentile: p99.9 clipping variants of both
  kl:         TensorRT-style entropy calibration — 2048-bin |x| histograms,
              threshold chosen to minimize KL(P‖Q) between the reference
              distribution and its 128-level quantization

Capture rides the ``ActivationCapture`` context (``models/layers.py``): the
statistics stay tensors on the device through the forward, and each
frame's are copied to the host at once, one copy a frame.

Two statistics are computed another way than ``jnp`` computes them, with
the same definition:
- percentiles: ``torch.quantile`` refuses inputs above 2^24 elements (one
  1080p activation of the LE UNet holds 66 M or more), so
  :func:`percentile` takes the two order statistics around the position
  with ``kthvalue`` and interpolates linearly, as ``np.percentile`` does on
  float64 data; ``jnp.percentile`` takes the position in fp32, which moves
  the result by a fraction of the gap between those two values;
- histograms: :func:`abs_histogram` builds ``jnp.histogram``'s edges (fp32
  ``linspace``) and bins with ``torch.bucketize`` the way it does (values
  past the range dropped, the range's end in the last bin); the counts are
  exact integers, where ``jnp.histogram`` sums them in fp32 (inexact past
  2^24 in one bin).
"""

from __future__ import annotations

import math
from typing import Iterable

import numpy as np
import torch

from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig, model_apply, natural_params_to_torch
from hdrtv_tpu_torch.models.layers import F32, ActivationCapture, Policy, fp32_math
from hdrtv_tpu_torch.ops.resize import downsample_quarter_aa

KL_BINS = 2048


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q``-th percentile of ``x``'s elements, linearly interpolated
    between the order statistics around the position q/100·(n − 1), as
    ``np.percentile(x.astype(np.float64), q)`` computes it: a float64 0-d
    tensor on ``x``'s device (no host sync)."""
    flat = x.detach().reshape(-1)
    n = flat.numel()
    pos = q / 100.0 * (n - 1)
    lo = min(max(math.floor(pos), 0), n - 1)
    hi = min(lo + 1, n - 1)
    t = pos - lo
    a = torch.kthvalue(flat, lo + 1).values.double()
    if hi == lo or t == 0.0:
        return a
    b = torch.kthvalue(flat, hi + 1).values.double()
    d = b - a
    # numpy's _lerp: a + d·t, from the upper end where t ≥ 0.5
    return b - d * (1.0 - t) if t >= 0.5 else a + d * t


def abs_histogram(x: torch.Tensor, rng: float, bins: int = KL_BINS) -> torch.Tensor:
    """``jnp.histogram(|x|, bins, range=(0, rng))[0]`` as exact int64 counts
    on ``x``'s device: the edges are fp32 ``rng · i / bins`` and ``rng``
    itself, a value lands in the bin whose left edge is the last at or
    below it, ``rng`` in the last bin, values above ``rng`` nowhere."""
    xf = x.detach().float().reshape(-1).abs()
    r = torch.tensor(rng, dtype=torch.float32, device=xf.device)
    steps = torch.arange(bins, dtype=torch.float32, device=xf.device) / bins
    edges = torch.cat([r * steps, r.reshape(1)])
    idx = torch.bucketize(xf, edges, right=True)
    idx = torch.where(xf == r, torch.full_like(idx, bins), idx)
    return torch.bincount(idx, minlength=bins + 2)[1 : bins + 1]


class _PercentileCapture(ActivationCapture):
    def __init__(self, names, percentile: float, percentile_low: float):
        super().__init__(names)
        self.p_hi = percentile
        self.p_lo = percentile_low

    def _record(self, name, x):
        if not self.watches(name):
            return
        xf = x.detach().float()
        lo, hi = torch.aminmax(xf)
        self.stats[name] = {
            "abs_max": torch.maximum(hi, -lo),
            "min": lo,
            "max": hi,
            "p_abs": percentile(xf.abs(), self.p_hi),
            "p_min": percentile(xf, self.p_lo),
            "p_max": percentile(xf, self.p_hi),
        }


class _HistCapture(ActivationCapture):
    """Fixed-range |x| histograms (ranges from a prior abs-max pass)."""

    def __init__(self, names, ranges: dict, bins: int = KL_BINS):
        super().__init__(names)
        self.ranges = ranges
        self.bins = bins

    def _record(self, name, x):
        if not self.watches(name):
            return
        self.stats[name] = {"hist": abs_histogram(x, self.ranges.get(name, 1.0), self.bins)}


def _kl_at(hist: np.ndarray, i: int, levels: int) -> float:
    """KL(P‖Q) of the first ``i`` bins (outliers clipped into the last) and
    their ``levels``-group quantization, each group's mass spread evenly over
    its nonzero bins (the TensorRT reference algorithm). The JAX package
    fills Q group by group in a Python loop, a later group overwriting the
    bin it shares with an earlier one; here each bin takes the value of the
    last group that holds it, from cumulative sums of the integer counts,
    so Q holds the same values bit for bit."""
    ref = hist[:i].copy()
    ref[i - 1] += hist[i:].sum()  # clip outliers into the last bin
    p = ref / ref.sum()

    edges = np.linspace(0, i, levels + 1)
    lo = np.floor(edges[:-1]).astype(int)
    hi = np.minimum(np.ceil(edges[1:]).astype(int), i)
    h = hist[:i]
    nz = h > 0
    mass = np.concatenate(([0.0], np.cumsum(h)))
    count = np.concatenate(([0], np.cumsum(nz)))
    n_nz = count[hi] - count[lo]
    value = np.where(n_nz > 0, (mass[hi] - mass[lo]) / np.maximum(n_nz, 1), 0.0)
    last = np.searchsorted(lo, np.arange(i), side="right") - 1
    q = np.where(nz, value[last], 0.0)
    qs = q.sum()
    if qs <= 0:
        return np.inf
    q /= qs
    mask = p > 0
    return float(np.sum(p[mask] * np.log(p[mask] / np.maximum(q[mask], 1e-12))))


def kl_threshold(hist: np.ndarray, *, levels: int = 128, stride: int = 16) -> int:
    """TensorRT entropy-calibration threshold search: the bin count ``i``
    whose clipped distribution quantizes to ``levels`` with minimal
    KL(P‖Q). Coarse-to-fine: every ``stride`` bins, then ±stride refine.
    Returns the chosen bin index (scale = (i+0.5)·bin_width/127).
    """
    hist = np.asarray(hist, np.float64)
    bins = hist.size
    if hist.sum() <= 0:
        return bins
    coarse = list(range(levels, bins + 1, stride))
    if coarse[-1] != bins:
        coarse.append(bins)
    kls = {i: _kl_at(hist, i, levels) for i in coarse}
    best = min(kls, key=kls.get)
    for i in range(max(levels, best - stride + 1), min(bins, best + stride)):
        if i not in kls:
            kls[i] = _kl_at(hist, i, levels)
    return min(kls, key=kls.get)


def w8a8_layer_names(params: dict) -> list[str]:
    return sorted(k[: -len(".x_scale")] for k in params if k.endswith(".x_scale"))


def frame_inputs(frame: np.ndarray, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """A [0, 1] RGB HWC frame as the model's (1, H, W, 3) fp32 input on
    ``device`` and its quarter-resolution condition image."""
    img = torch.from_numpy(np.ascontiguousarray(frame, dtype=np.float32))[None].to(device)
    return img, downsample_quarter_aa(img)


def _captured(params: dict, frames, cfg, policy, make_capture, device) -> list[dict]:
    """Each frame's captured statistics on the host: one forward under a
    fresh capture, then one copy of all of the frame's values."""
    out = []
    for frame in frames:
        img, cond = frame_inputs(frame, device)
        with make_capture() as cap:
            model_apply(params, img, cond, cfg, policy=policy)
        items = [(n, k, v) for n, s in cap.stats.items() for k, v in s.items()]
        host = torch.cat([v.double().reshape(-1) for _, _, v in items]).cpu().numpy() if items else None
        stats, at = {}, 0
        for n, k, v in items:
            size = v.numel()
            stats.setdefault(n, {})[k] = host[at] if v.ndim == 0 else host[at : at + size]
            at += size
        out.append(stats)
    return out


def calibrate(
    params: dict,
    frames: Iterable[np.ndarray],
    cfg: ModelConfig,
    *,
    policy: Policy = F32,
    method: str = "max",
    percentile: float = 99.9,
    percentile_low: float = 0.1,
    device=None,
) -> dict:
    """Return numpy params with calibrated ``x_scale``/``x_zero``.

    ``frames``: [0,1] RGB HWC float arrays (dataset / video / synthetic
    calibration source roles, hdrtvnet_torch.py:7823-8073). The forwards
    run on ``device``: the CUDA card unless the caller names another
    (``utils/device.py compute_device``), in true fp32 (TF32 off).
    """
    from hdrtv_tpu_torch.utils.device import compute_device

    layers = w8a8_layer_names(params)
    if not layers:
        return dict(params)
    dev = compute_device(device)
    watch = set(layers)
    use_pct = method == "percentile"
    use_kl = method in ("kl", "kl_div", "entropy")
    p_hi, p_lo = percentile, percentile_low

    def make_capture():
        if use_pct:
            return _PercentileCapture(watch, p_hi, p_lo)
        return ActivationCapture(watch)

    frames = list(frames)
    with torch.inference_mode(), fp32_math():
        dev_params = natural_params_to_torch(params, dev, policy)
        agg: dict[str, dict] = {}
        for stats in _captured(dev_params, frames, cfg, policy, make_capture, dev):
            for name, s in stats.items():
                a = agg.setdefault(
                    name,
                    {"abs_max": 0.0, "min": np.inf, "max": -np.inf, "p_abs": 0.0, "p_min": np.inf,
                     "p_max": -np.inf},
                )
                a["abs_max"] = max(a["abs_max"], float(s["abs_max"]))
                a["min"] = min(a["min"], float(s["min"]))
                a["max"] = max(a["max"], float(s["max"]))
                if use_pct:
                    a["p_abs"] = max(a["p_abs"], float(s["p_abs"]))
                    a["p_min"] = min(a["p_min"], float(s["p_min"]))
                    a["p_max"] = max(a["p_max"], float(s["p_max"]))

        kl_scale: dict[str, float] = {}
        if use_kl:
            # Second pass with fixed ranges from the abs-max pass: accumulate
            # 2048-bin histograms, then the entropy threshold search per layer.
            ranges = {n: max(agg[n]["abs_max"], 1e-8) for n in agg}
            hists: dict[str, np.ndarray] = {}
            for stats in _captured(dev_params, frames, cfg, policy, lambda: _HistCapture(watch, ranges), dev):
                for name, s in stats.items():
                    hists[name] = hists.get(name, 0) + np.asarray(s["hist"], np.float64)
            for name, h in hists.items():
                i = kl_threshold(h)
                bin_w = ranges[name] / KL_BINS
                kl_scale[name] = max((i + 0.5) * bin_w, 1e-8) / 127.0

    out = dict(params)
    for name in layers:
        s = agg.get(name)
        if s is None:
            continue
        if f"{name}.x_zero" in out:  # asymmetric (KL calibrates symmetric only)
            if use_pct and np.isfinite(s["p_min"]):
                x_min, x_max = s["p_min"], s["p_max"]
            else:
                x_min, x_max = s["min"], s["max"]
            out[f"{name}.x_scale"] = np.float32(max(x_max - x_min, 1e-8) / 255.0)
            out[f"{name}.x_zero"] = np.float32(x_min)
        elif use_kl and name in kl_scale:
            out[f"{name}.x_scale"] = np.float32(kl_scale[name])
        else:
            val = s["p_abs"] if (use_pct and s["p_abs"] > 0.0) else s["abs_max"]
            out[f"{name}.x_scale"] = np.float32(max(val, 1e-8) / 127.0)
    return out
