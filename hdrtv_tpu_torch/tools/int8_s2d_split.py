"""Device time of each launch of the int8 s2d forms at their 1080p shapes.

    python hdrtv_tpu_torch/tools/int8_s2d_split.py [--root DIR]

Runs ``fused_tail`` (packed, with up_coarse), ``fused_sft_conv3_v2`` (L0:
540 × 960 with ReLU; L2: 135 × 240 with a skip), ``fused_resblock`` (L1:
270 × 480, trunk1 and trunk5 with up_coarse) in bf16 with ``qargs`` and
``s2d=True``, and ``fused_block_conv3`` (L1 up_conv3 at 270 × 480, L2
up_conv2 at 135 × 240, PS-folded 128 → 512 with ReLU) with ``qargs`` and
``a_sub=1``, as the int8 programs call them, symmetric and with a zero
point, on seeded s2d weights, under torch.profiler (20 calls after a warm
one), and prints one JSON line: per case, the device ms of each kernel by
its name with its template arguments (the SFT passes, the quantize pass,
the int8 convs, conv_last). A tree that routes a form to the dense kernels
(the parent of the tree that redesigned it) shows their launches under the
same case. ``--root``
imports ``hdrtv_tpu_torch`` from another unpacked tree (say the parent
commit's, from ``git archive``; run this file by path, not with ``-m``,
which imports the package first), which builds its kernels into its own
``build/``: two trees measured in one process each, one after the other,
on one card. The last line is the card's name and power limit as
nvidia-smi gives them. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default="", help="an unpacked tree to import hdrtv_tpu_torch from")
    args = ap.parse_args()
    if args.root and "hdrtv_tpu_torch" in sys.modules:
        raise SystemExit("int8_s2d_split: run the file by path to take --root (-m imported this checkout)")
    sys.path.insert(0, os.path.abspath(args.root) if args.root else ROOT)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hdrtv_tpu_torch.models.s2d import b_s2d, w_ps_permute, w_s2d_1x1, w_s2d_s1, w_s2d_s1_ps
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3
    from hdrtv_tpu_torch.ops.megakernel import fused_resblock, fused_sft_conv3_v2, fused_tail
    from hdrtv_tpu_torch.ops.w8a8 import pack_qargs
    from hdrtv_tpu_torch.quant.int8 import quantize_weight

    if not torch.cuda.is_available():
        raise SystemExit("int8_s2d_split needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.RandomState(3)

    def t(a, dt=torch.bfloat16):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev).to(dt)

    def sft4():
        return [(t(w_s2d_1x1(rng.randn(1, 1, ci, co).astype(np.float32) * 0.05)[0, 0]),
                 t(np.tile(rng.randn(co) * 0.1, 4), torch.float32))
                for ci, co in ((16, 16), (16, 32), (16, 16), (16, 32))]

    def layer(asym, co=32):
        wq, ws = quantize_weight(rng.randn(3, 3, 32, co).astype(np.float32) * 0.05)
        if co == 32:
            tq, tsc = w_s2d_s1(wq), b_s2d(ws)
        else:  # PS-folded, as up_conv2.0 / up_conv3.0
            tq, tsc = w_s2d_s1_ps(wq), np.tile(w_ps_permute(ws.reshape(1, 1, 1, -1))[0, 0, 0], 4)
        b = (rng.randn(4 * co) * 0.1).astype(np.float32)
        qa = pack_qargs(tq, tsc, 0.012, -0.4 if asym else None, b, dev)
        return t(tq.astype(np.float32) * tsc), t(b, torch.float32), qa

    def split(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            us = float(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0) or 0)
            if us:
                out[e.key.split("(anonymous namespace)::", 1)[-1].split("(")[0]] = round(us / 1e3 / reps, 4)
        return out

    res = {}
    for asym in (False, True):
        hb, wb = 540, 960
        s_, up = t(rng.rand(hb, wb, 128) - 0.3), t(rng.rand(hb // 2, wb // 2, 512) - 0.3)
        cond, skip = t(rng.rand(hb, wb, 64) - 0.3), t(rng.rand(hb, wb, 12))
        w, b, qa = layer(asym)
        w_last = t(w_s2d_s1(rng.randn(3, 3, 32, 3).astype(np.float32) * 0.03))
        targs = (s_, cond, skip, sft4(), w, b, w_last, t(rng.randn(12) * 0.02, torch.float32))
        res[f"tail asym={asym}"] = split(lambda: fused_tail(*targs, up_coarse=up, qargs_hr=qa, s2d=True))
        for name, h, w_, with_skip in (("L0", 540, 960, False), ("L2 skip", 135, 240, True)):
            x, c = t(rng.rand(h, w_, 128) - 0.3), t(rng.rand(h, w_, 64) - 0.3)
            sk = t(rng.rand(h, w_, 128)) if with_skip else None
            sft = sft4()
            res[f"sft_conv3 {name} asym={asym}"] = split(
                lambda: fused_sft_conv3_v2(x, c, sft, w, b, relu=not with_skip, skip=sk, qargs=qa, s2d=True))
        h, w_ = 270, 480
        x, c = t(rng.rand(h, w_, 128) - 0.3), t(rng.rand(h, w_, 64) - 0.3)
        sft1, sft2 = sft4(), sft4()
        w1, b1, q1 = layer(asym)
        w2, b2, q2 = layer(asym)
        for name, up in (("trunk1", None), ("trunk5 up_coarse", t(rng.rand(h // 2, w_ // 2, 512) - 0.3))):
            res[f"resblock L1 {name} asym={asym}"] = split(
                lambda: fused_resblock(x, c, sft1, w1, b1, sft2, w2, b2, up_coarse=up, qargs1=q1, qargs2=q2,
                                       s2d=True))
        wp, bp, qp = layer(asym, 128)
        for name, h, w_ in (("L1 up_conv3", 270, 480), ("L2 up_conv2", 135, 240)):
            x = t(rng.rand(h, w_, 128) * 1.2 - 0.1)
            res[f"block_conv3 {name} asym={asym}"] = split(
                lambda: fused_block_conv3(x, wp, bp, relu=True, qargs=qp, a_sub=1))
    print(json.dumps({"root": args.root or ".", **res}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
