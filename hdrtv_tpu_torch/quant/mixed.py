"""Mixed-quantization layout *generation* — per-layer sensitivity probe
(port of ``hdrtv_tpu/quant/mixed.py``).

The reference ships hand-tuned layer recipes (configs/qat_layouts/*.txt) and
the 1,250-line stability probe that produced them
(scripts/quantize/quantize_int8_mixed.py): quantize one layer at a time,
score the output degradation on probe frames, and keep the least-sensitive
layers in W8A8.

A layer's quantization toggles *by value* (the ``x_on`` gate in
models/layers.py plus a dequantized-weight swap), so the probe keeps one
set of device tensors and swaps two entries per layer. Scores per layer:
full-frame MAE, highlight-region MAE (maxRGB > 0.75, the HG mask region
where int8 flicker shows first — probe_trt_temporal_stability.py role), and
ΔEITP. Each layer's conv FLOPs come from the input shapes one real forward
records at the probe size (the JAX package traces them under
``jax.eval_shape``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig, model_apply, natural_params_to_torch
from hdrtv_tpu_torch.models.layers import F32, ActivationCapture, Policy
from hdrtv_tpu_torch.quant.calibrate import calibrate, frame_inputs
from hdrtv_tpu_torch.quant.int8 import DEFAULT_EXCLUDE_SUFFIXES, quantizable_layers, quantize_params


@dataclasses.dataclass
class LayerSensitivity:
    layer: str
    mae: float
    highlight_mae: float
    delta_e_itp: float
    gflops: float = 0.0  # per-probe-frame conv cost (the quantization *benefit*)

    @property
    def score(self) -> float:
        # Highlight stability dominates the reference recipe decisions
        # (README.md:68 "failed visual/temporal checks" on highlights).
        return self.mae + 3.0 * self.highlight_mae + 0.002 * self.delta_e_itp

    @property
    def cost_per_gflop(self) -> float:
        """Quality cost per unit of compute converted to int8 — the mixed
        recipe wants *compute-heavy robust* layers, not no-op layers whose
        quantization is merely invisible."""
        return self.score / max(self.gflops, 1e-6)


class _ShapeCapture(ActivationCapture):
    """Records each layer's input shape during a forward."""

    def __init__(self):
        super().__init__(None)
        self.shapes: dict[str, tuple] = {}

    def _record(self, name, x):
        self.shapes[name] = tuple(x.shape)


def _gflops(params: dict, layers: list[str], shapes: dict) -> dict[str, float]:
    """Conv (or dense) GFLOPs of each layer at its captured input shape,
    counted as the JAX package counts them (at the input's spatial size)."""
    out: dict[str, float] = {}
    for l in layers:
        in_shape = shapes.get(l)
        w = params.get(f"{l}.weight")
        if in_shape is None or w is None:
            out[l] = 0.0
            continue
        if w.ndim == 4:
            kh, kw, ci, co = w.shape
            hw = in_shape[1] * in_shape[2]
            out[l] = 2.0 * hw * kh * kw * ci * co / 1e9
        else:
            out[l] = 2.0 * float(np.prod(in_shape[:-1])) * w.shape[0] * w.shape[1] / 1e9
    return out


def probe_layer_sensitivity(
    params: dict,
    frames,
    cfg: ModelConfig = ModelConfig(),
    *,
    policy: Policy = F32,
    layers: list[str] | None = None,
    exclude: tuple[str, ...] = DEFAULT_EXCLUDE_SUFFIXES,
    highlight_thresh: float = 0.75,
    peak_nits: float = 1000.0,
    device=None,
) -> list[LayerSensitivity]:
    """Quantize one layer at a time (W8 weights + calibrated A8 activation)
    and score degradation vs the float forward on the probe frames, on
    ``device`` (the CUDA card unless the caller names another)."""
    from hdrtv_tpu_torch.utils.device import compute_device
    from hdrtv_tpu_torch.ops.color import delta_e_itp as de_itp

    dev = compute_device(device)
    if layers is None:
        layers = [l for l in quantizable_layers(params) if not l.endswith(exclude)]

    # One calibration pass over the fully-quantized model provides every
    # layer's activation scale; the probe then flips layers on one by one.
    fullq = quantize_params(params, layers, mode="w8a8")
    fullq = calibrate(fullq, frames, cfg, policy=policy, method="max", device=dev)

    probe = dict(params)
    deq_weights: dict[str, np.ndarray] = {}
    for l in layers:
        probe[f"{l}.x_scale"] = np.asarray(fullq[f"{l}.x_scale"], np.float32)
        probe[f"{l}.x_on"] = np.float32(0.0)
        q = np.asarray(fullq[f"{l}.weight_int8"], np.float32)
        deq_weights[l] = q * np.asarray(fullq[f"{l}.w_scale"], np.float32)

    with torch.inference_mode(), policy.math():
        pdev = natural_params_to_torch(probe, dev, policy)
        on = torch.ones((), dtype=torch.float32, device=dev)
        probe_inputs, baselines, masks = [], [], []
        shp = _ShapeCapture()
        for i, frame in enumerate(frames):
            img, cond = frame_inputs(frame, dev)
            probe_inputs.append((img, cond))
            if i == 0:
                with shp:
                    base = model_apply(pdev, img, cond, cfg, policy=policy)
            else:
                base = model_apply(pdev, img, cond, cfg, policy=policy)
            baselines.append(base.float())
            hl = img.amax(dim=-1) > highlight_thresh
            masks.append((hl, bool(hl.any())))
        gflops = _gflops(params, layers, shp.shapes)

        scores = []  # per layer, per frame: mae, highlight mae, ΔEITP (on the device)
        for l in layers:
            trial = dict(pdev)
            trial[f"{l}.x_on"] = on
            trial[f"{l}.weight"] = torch.from_numpy(deq_weights[l]).to(dev, policy.compute_dtype)
            for (img, cond), base, (hl, any_hl) in zip(probe_inputs, baselines, masks):
                out = model_apply(trial, img, cond, cfg, policy=policy).float()
                diff = (out - base).abs()
                hmae = diff[hl].mean() if any_hl else diff.new_zeros(())
                de = de_itp(out[0].clamp(0, 1) * peak_nits, base[0].clamp(0, 1) * peak_nits)
                scores.append(torch.stack([diff.mean(), hmae, de.float()]).double())
        host = torch.stack(scores).cpu().numpy().reshape(len(layers), len(probe_inputs), 3) if scores else None

    results: list[LayerSensitivity] = []
    for j, l in enumerate(layers):
        results.append(
            LayerSensitivity(
                layer=l,
                mae=float(np.mean(host[j, :, 0])),
                highlight_mae=float(np.mean(host[j, :, 1])),
                delta_e_itp=float(np.mean(host[j, :, 2])),
                gflops=gflops.get(l, 0.0),
            )
        )
    return results


def generate_mixed_layout(
    params: dict,
    frames,
    cfg: ModelConfig = ModelConfig(),
    *,
    count: int = 29,
    out_path: str | None = None,
    policy: Policy = F32,
    exclude: tuple[str, ...] = DEFAULT_EXCLUDE_SUFFIXES,
    tag: str = "generated",
    device=None,
) -> list[str]:
    """Emit a mixed W8A8 layout, readable by quant.int8.load_mixed_layout
    (one layer per line, '#' comments — the configs/qat_layouts/*.txt
    contract).

    Selection ranks by quality cost per GFLOP converted: quantizing a layer
    must *buy* compute, so compute-heavy robust layers (the reference
    recipe's trunk3/CondNet4 picks) outrank no-op layers whose quantization
    is merely invisible."""
    sens = probe_layer_sensitivity(params, frames, cfg, policy=policy, exclude=exclude, device=device)
    ranked = sorted(sens, key=lambda s: s.cost_per_gflop)
    chosen = [s.layer for s in ranked[:count]]
    if out_path:
        with open(out_path, "w") as f:
            f.write(f"# Mixed W8A8 layout generated by per-layer sensitivity probe ({tag}).\n")
            f.write(f"# Composition: {len(chosen)} W8A8 of {len(sens)} probed layers.\n")
            f.write("# rank = (mae + 3*highlight_mae + 0.002*dEITP) / gflops, ascending\n")
            for s in ranked[:count]:
                f.write(f"{s.layer}\n")
            f.write("# --- rejected (worst cost/benefit first) ---\n")
            for s in ranked[: count - 1 : -1]:
                f.write(f"# {s.layer}  score={s.score:.6f} gflops={s.gflops:.3f}\n")
    return chosen
