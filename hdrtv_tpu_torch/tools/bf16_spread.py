"""How far the bf16 default program's frame lies from its references, by size.

    python -m hdrtv_tpu_torch.tools.bf16_spread [--size 360x640] [--size 720x1280] ... [--fallback-rows N]

For each size, one seeded noise frame (``RandomState(h)``, as ``chip_smoke.py``
phases 3 and 13 make theirs) through the bf16 default (``precision="fp16"``)
on the card, kernel by kernel (the eager program), and through the same
program on the CPU (the kernels' plain versions) and the fp32 program on the
CPU. It prints, in u16 codes (max, mean) and the share of values that differ:
the card's bf16 frame against the CPU's, each bf16 frame against the CPU's
fp32 frame, and the seconds each CPU run took.

``--fallback-rows N`` routes the LE resblocks with N block rows through the
two sft_conv3 calls each, on both devices (the route trunk2 and trunk4 take at
1080p, where their 135 rows have no even tile): 90 at 720 × 1280 is trunk2
and trunk4, which take the resblock kernel at 720p only. It patches
``models/s2d.py``'s row picker, so give it a size whose other levels have
another row count.

``--per-call``: instead, each kernel call of one eager card frame (the
wrappers ``models/s2d.py`` calls, and ``pack_rgb48``) against the same
wrapper on copies of its inputs on the CPU (its plain version): per call, the
output's shape, the largest error in bf16 steps (of max(1, |plain|)), and
the mean signed and mean absolute error, in units of the output. A kernel
that rounds one way where its plain version rounds to nearest shows as a
mean signed error far from 0.

One JSON object per size (``--per-call``: one per call, then the frame's).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _apart(a: np.ndarray, b: np.ndarray) -> dict:
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return {"max_codes": int(d.max()), "mean_codes": round(float(d.mean()), 3),
            "differ": round(float((d > 0).mean()), 4)}


def spread(h: int, w: int, weights: str, device: str = "cuda") -> dict:
    """The figures above for one (h, w) noise frame."""
    import torch

    from hdrtv_tpu_torch.models.layers import fp32_math
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    frame = (np.random.RandomState(h).rand(h, w, 3) * 255).astype(np.uint8)
    with fp32_math():
        card = HDRTVNetTorch(weights, precision="fp16", device=device, persistent_cache=False)
        x = card.put_frame(frame.reshape(h, w * 3))
        out = card._hw3(card._rgb48_eager(x).cpu().numpy())
        t0 = time.perf_counter()
        cpu = HDRTVNetTorch(weights, precision="fp16", device="cpu", persistent_cache=False).process_rgb48(frame)
        t1 = time.perf_counter()
        fp32 = HDRTVNetTorch(weights, precision="fp32", device="cpu", persistent_cache=False).process_rgb48(frame)
        t2 = time.perf_counter()
    del card
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"size": [h, w], "card_vs_cpu": _apart(out, cpu), "card_vs_fp32": _apart(out, fp32),
            "cpu_vs_fp32": _apart(cpu, fp32), "cpu_bf16_s": round(t1 - t0, 2), "cpu_fp32_s": round(t2 - t1, 2)}


_WRAPPERS = ("fused_agcm_head", "fused_cond_chain", "fused_down2", "fused_mix_chain", "fused_resblock",
             "fused_sft_conv3_v2", "fused_tail", "fused_trunk3", "fused_block_conv3", "pack_rgb48")


def _to_cpu(v):
    import torch

    if isinstance(v, torch.Tensor):
        return v.cpu()
    if isinstance(v, (list, tuple)) and not hasattr(v, "_fields"):
        return type(v)(_to_cpu(x) for x in v)
    if isinstance(v, dict):
        return {k: _to_cpu(x) for k, x in v.items()}
    return v


def per_call(h: int, w: int, weights: str, device: str = "cuda") -> list[dict]:
    """One line per kernel call of an eager card frame of the (h, w) noise
    frame, its output against the plain version's on the same inputs."""
    import torch

    from hdrtv_tpu_torch.models import s2d
    from hdrtv_tpu_torch.models.layers import fp32_math
    from hdrtv_tpu_torch.runtime import processor
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    lines = []

    def wrap(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if kw.get("packed") is not None:
                kw = {**kw, "packed": None}
            ref = fn(*_to_cpu(args), **_to_cpu(kw))
            outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
            for part, (o, r) in enumerate(zip(outs, refs)):
                got, want = o.detach().float().cpu(), r.float()
                e = got - want
                steps = (e.abs() / (2.0 ** -7 * want.abs().clamp_min(1.0))).max()
                lines.append({"call": len(lines), "kernel": name, "part": part, "shape": list(o.shape),
                              "dtype": str(o.dtype), "max_steps": round(float(steps), 3),
                              "max_abs": float(e.abs().max()), "mean_signed": float(e.mean()),
                              "mean_abs": float(e.abs().mean())})
            return out
        return call

    saved = {}
    for mod in (s2d, processor):
        for name in _WRAPPERS:
            if hasattr(mod, name):
                saved[(mod, name)] = getattr(mod, name)
                setattr(mod, name, wrap(name, saved[(mod, name)]))
    frame = (np.random.RandomState(h).rand(h, w, 3) * 255).astype(np.uint8)
    try:
        with fp32_math():
            card = HDRTVNetTorch(weights, precision="fp16", device=device, persistent_cache=False)
            card._rgb48_eager(card.put_frame(frame.reshape(h, w * 3)))
            if device == "cuda":
                torch.cuda.synchronize()
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", action="append", default=None, help="HxW (repeatable; default 360x640, 720x1280)")
    ap.add_argument("--weights", default="weights/hr_fp32.npz")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fallback-rows", type=int, default=None)
    ap.add_argument("--per-call", action="store_true")
    args = ap.parse_args(argv)
    if args.fallback_rows is not None:
        from hdrtv_tpu_torch.models import s2d

        rows = s2d.pick_rows_even
        s2d.pick_rows_even = lambda hb, limit=12: 0 if hb == args.fallback_rows else rows(hb, limit)
    for size in args.size or ["360x640", "720x1280"]:
        h, w = (int(v) for v in size.split("x"))
        if args.per_call:
            for line in per_call(h, w, args.weights, args.device):
                print(json.dumps({"size": [h, w], **line}), flush=True)
            continue
        print(json.dumps({**spread(h, w, args.weights, args.device), "fallback_rows": args.fallback_rows}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
