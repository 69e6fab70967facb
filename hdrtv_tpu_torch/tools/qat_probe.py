"""Probes of the QAT and calibration paths, the card against the CPU.

    python -m hdrtv_tpu_torch.tools.qat_probe pool
    python -m hdrtv_tpu_torch.tools.qat_probe vjp [--size 64x128] [--size 128x256] ...
    python -m hdrtv_tpu_torch.tools.qat_probe calib [CKPT] [--qat-steps 5] [--save OUT.npz] [--zero LAYER=VALUE] ...

``pool``: ``F.avg_pool2d(3, 2, 1)`` forward and backward at the AGCM
classifier's shapes, on a channels-last view of an NHWC tensor (what
``models/layers.py avg_pool_3s2p1`` read before it made a contiguous copy) and
on the contiguous NCHW copy it reads now: the device's input gradient against
the CPU's, as a share of the CPU's largest, and whether the forwards are equal.

``vjp``: :func:`vjp_apart` at each size on ``weights/hr_fp32.npz`` with the
default QAT layers: the training step's loss and a seeded VJP's gradients,
the device's against the CPU's, leaf by leaf (median, worst, the AGCM
classifier's worst). ``chip_smoke.py`` phase 12 (d) holds the same at 128 × 256.

``calib``: for each W8A8 layer of ``CKPT`` (without one, the checkpoint
``run_qat`` makes in ``--qat-steps`` steps on the calibration frames, as the
qat CLI does on a video of them), the range its activation scale
(and zero point) covers against the range of the layer's input in the fp32
model on the same seeded natural frames (``--calib-size``, ``--calib-frames``:
the frames the checkpoint was calibrated on, where known), the widest ones
first; then the int8 default program's frame (``--frame-size``, natural frame
3) against the float program on the checkpoint, PSNR. ``--zero`` moves a
layer's zero point first.

Each prints one JSON object. ``--device`` defaults to ``cuda``; ``cpu`` runs
the same on the CPU (the int8 program's plain versions), and ``vjp`` then
compares the CPU with itself.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
CLASSIFIER_POOL_SHAPES = ((1, 32, 64, 16), (1, 16, 32, 32), (1, 8, 16, 64), (1, 4, 8, 128), (1, 270, 480, 16))


def natural_u8_frames(count: int, size: tuple[int, int]) -> list[np.ndarray]:
    """``bench/sweep.py natural_frames`` through u8, as a video source gives
    them: [0, 1] RGB float."""
    from hdrtv_tpu_torch.bench.sweep import natural_frames

    return [(np.clip(f, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8).astype(np.float32) / 255.0
            for f in natural_frames(count, size)]


def pool_apart(device) -> dict:
    """The classifier's pool, channels-last view and contiguous copy, the
    device against the CPU."""
    out = {}
    for shape in CLASSIFIER_POOL_SHAPES:
        x = torch.from_numpy(np.random.RandomState(1).randn(*shape).astype(np.float32))
        row = {}
        for form in ("channels_last_view", "contiguous"):
            got = {}
            for dev in (device, "cpu"):
                t = x.detach().clone().to(dev).requires_grad_(True)
                xn = t.permute(0, 3, 1, 2)
                y = F.avg_pool2d(xn.contiguous() if form == "contiguous" else xn, 3, stride=2, padding=1,
                                 count_include_pad=True).permute(0, 2, 3, 1)
                g = torch.from_numpy(np.random.RandomState(2).randn(*y.shape).astype(np.float32)).to(dev)
                y.backward(g)
                got[dev] = (y.detach().cpu(), t.grad.cpu())
            (yd, gd), (yc, gc) = got[device], got["cpu"]
            row[form] = {"forward_equal": bool(torch.equal(yd, yc)),
                         "backward_apart": float((gd - gc).abs().max() / gc.abs().max())}
        out[str(shape)] = row
    return out


def vjp_apart(fp32: dict, frame: np.ndarray, layers: list, device) -> tuple[float, dict]:
    """One QAT step (``train.py``, the STE fake-quant on ``layers``, the frame
    as its target: ``run_qat``'s form without the teacher) on ``device`` and
    on the CPU from the same weights: its loss's relative difference. Then
    the gradients of the same fake-quantized forward under a seeded
    cotangent (one VJP, free of the L1's kinks, where a residual within the
    two programs' rounding flips its sign): for each leaf, its largest
    difference over its largest magnitude on the CPU. A leaf with a gradient
    on one side only, or an all-zero one, raises. Run it under
    ``fp32_math()``."""
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig, model_apply, natural_params_to_torch
    from hdrtv_tpu_torch.quant.calibrate import frame_inputs
    from hdrtv_tpu_torch.quant.qat import make_weight_fake_quant
    from hdrtv_tpu_torch.train import init_state, make_train_step

    cfg = ModelConfig()
    fq = make_weight_fake_quant(layers)
    h, w, _ = frame.shape
    cot = torch.from_numpy(np.random.RandomState(12).randn(1, h, w, 3).astype(np.float32))
    step_of = {}
    for dev in (device, "cpu"):
        with torch.no_grad():
            img, cond = frame_inputs(frame, dev)
        state = init_state(fp32, lr=2e-6, device=dev)
        state, loss = make_train_step(cfg, fake_quant=fq)(state, img, cond, img, None)
        del state
        q = {k: v.requires_grad_(v.is_floating_point()) for k, v in natural_params_to_torch(fp32, dev).items()}
        with torch.enable_grad():
            model_apply(fq(q), img, cond, cfg).backward(cot.to(dev))
        step_of[dev] = (float(loss), {k: (None if v.grad is None else v.grad.cpu()) for k, v in q.items()})
    (lc, gc), (lp, gp) = step_of[device], step_of["cpu"]
    err = {}
    for k, g in gp.items():
        if (g is None) != (gc[k] is None):
            raise AssertionError(f"QAT step: {k} has a gradient on one side only")
        if g is not None:
            m = float(g.abs().max())
            if m == 0.0:
                raise AssertionError(f"QAT step: {k}'s gradient is zero at {h}x{w}")
            err[k] = float((gc[k] - g).abs().max()) / m
    return abs(lc - lp) / abs(lp), err


def default_qat_layers(params: dict) -> list[str]:
    from hdrtv_tpu_torch.quant.int8 import DEFAULT_EXCLUDE_SUFFIXES, quantizable_layers

    return [l for l in quantizable_layers(params) if not l.endswith(DEFAULT_EXCLUDE_SUFFIXES)]


def vjp_rows(sizes, device) -> list:
    from hdrtv_tpu_torch.models.import_npz import load_npz
    from hdrtv_tpu_torch.models.layers import fp32_math

    fp32 = load_npz(WEIGHTS)
    rows = []
    with fp32_math():
        for h, w in sizes:
            try:
                loss_rel, rel = vjp_apart(fp32, natural_u8_frames(1, (h, w))[0], default_qat_layers(fp32), device)
            except AssertionError as e:
                rows.append({"size": [h, w], "error": str(e)})
                continue
            r = sorted(((v, k) for k, v in rel.items()), reverse=True)
            cls = max((v, k) for k, v in rel.items() if ".classifier." in k)
            rows.append({"size": [h, w], "loss_rel": loss_rel, "leaves": len(r), "median": r[len(r) // 2][0],
                         "worst": r[:3], "classifier_worst": list(cls)})
    return rows


def layer_ranges(params: dict, frames, device) -> dict:
    """Each W8A8 layer's input (min, max) in the fp32 model over ``frames``:
    the calibration's capture, on the float weights under the checkpoint's
    layer names."""
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig, model_apply, natural_params_to_torch
    from hdrtv_tpu_torch.models.import_npz import load_npz
    from hdrtv_tpu_torch.models.layers import ActivationCapture, fp32_math
    from hdrtv_tpu_torch.quant.calibrate import frame_inputs, w8a8_layer_names

    fp = natural_params_to_torch(load_npz(WEIGHTS), device)
    out: dict = {}
    with torch.inference_mode(), fp32_math():
        for frame in frames:
            img, cond = frame_inputs(frame, device)
            with ActivationCapture(set(w8a8_layer_names(params))) as cap:
                model_apply(fp, img, cond, ModelConfig())
            for name, s in cap.stats.items():
                lo, hi = float(s["min"]), float(s["max"])
                a, b = out.get(name, (math.inf, -math.inf))
                out[name] = (min(a, lo), max(b, hi))
    return out


def calib_report(ckpt: str | None, zeros: dict, calib_size, calib_frames: int, frame_size, device,
                 qat_steps: int = 5, save: str | None = None) -> dict:
    """The ``calib`` report on ``ckpt``, or without one on the checkpoint
    ``run_qat`` makes on the calibration frames in ``qat_steps`` steps (the
    qat CLI's defaults otherwise, as ``chip_smoke.py`` phase 12 (d) runs it),
    written to ``save`` where given."""
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig
    from hdrtv_tpu_torch.models.import_npz import load_npz, save_npz
    from hdrtv_tpu_torch.models.layers import fp32_math
    from hdrtv_tpu_torch.quant.qat import run_qat
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    frames = natural_u8_frames(calib_frames, calib_size)
    if ckpt is None:
        fp32 = load_npz(WEIGHTS)
        params = run_qat(fp32, ModelConfig(), default_qat_layers(fp32), frames, steps=qat_steps, log=None,
                         device=device)[0]
    else:
        params = load_npz(ckpt)
    if save:
        save_npz(save, params)
    for layer, z in zeros.items():
        params[f"{layer}.x_zero"] = np.float32(z)
    seen = layer_ranges(params, frames, device)
    rows = []
    for name, (lo, hi) in seen.items():
        s = float(params[f"{name}.x_scale"])
        z = params.get(f"{name}.x_zero")
        cover = (float(z), float(z) + 255.0 * s) if z is not None else (-128.0 * s, 127.0 * s)
        rows.append({"layer": name, "covers": [round(v, 6) for v in cover], "input": [round(lo, 6), round(hi, 6)],
                     "width_ratio": round((cover[1] - cover[0]) / max(hi - lo, 1e-12), 2)})
    rows.sort(key=lambda r: -r["width_ratio"])
    h, w = frame_size
    frame = (natural_u8_frames(4, (h, w))[3][..., ::-1] * 255.0 + 0.5).astype(np.uint8)  # BGR u8, as a video gives
    with tempfile.TemporaryDirectory() as tmp, fp32_math():
        path = os.path.join(tmp, "probe.npz")
        save_npz(path, params)
        proc = HDRTVNetTorch(path, precision="fp16", device=device)
        if not (proc.native_int8 and proc.turbo):
            raise SystemExit(f"not on the int8 default program (native_int8 {proc.native_int8})")
        o = proc._hw3(proc._rgb48_eager(proc.put_frame(frame.reshape(h, w * 3))).cpu().numpy()).astype(np.int64)
        nat = HDRTVNetTorch(path, precision="fp16", device=device, turbo=False)
        f = nat._hw3(nat._rgb48_eager(nat.put_frame(frame.reshape(h, w * 3))).cpu().numpy()).astype(np.int64)
    mse = float((((o - f) / 65535.0) ** 2).mean())
    return {"checkpoint": ckpt or f"run_qat, {qat_steps} steps", "zeros_moved": zeros, "widest": rows[:5],
            "layers": len(rows), "int8_vs_float_psnr": 10.0 * math.log10(1.0 / mse) if mse > 0 else None}


def _size(text: str) -> tuple[int, int]:
    h, w = text.lower().split("x")
    return int(h), int(w)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hdrtv_tpu_torch.tools.qat_probe", description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("pool")
    v = sub.add_parser("vjp")
    v.add_argument("--size", type=_size, action="append")
    c = sub.add_parser("calib")
    c.add_argument("ckpt", nargs="?")
    c.add_argument("--qat-steps", type=int, default=5)
    c.add_argument("--save", help="write the checkpoint probed (before --zero) here")
    c.add_argument("--zero", action="append", default=[], help="LAYER=VALUE")
    c.add_argument("--calib-size", type=_size, default=(540, 960))
    c.add_argument("--calib-frames", type=int, default=5)
    c.add_argument("--frame-size", type=_size, default=(1080, 1920))
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")
    if args.cmd == "pool":
        out = pool_apart(args.device)
    elif args.cmd == "vjp":
        out = vjp_rows(args.size or [(64, 128), (128, 256), (256, 512)], args.device)
    else:
        zeros = {k: float(v) for k, v in (z.split("=") for z in args.zero)}
        out = calib_report(args.ckpt, zeros, args.calib_size, args.calib_frames, args.frame_size, args.device,
                           args.qat_steps, args.save)
    print(json.dumps({args.cmd: out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
