"""trunk3 and pack_rgb48 at their 1080p shapes, timed on the card.

    python hdrtv_tpu_torch/tools/trunk3_pack_times.py [--root DIR] [--label NAME]

Runs ``fused_trunk3`` (fea3 135 × 240 × 32, cond 135 × 240 × 16 → 128, the
weights of ``chip_smoke.py``'s trunk3 case) in fp32 and bf16 and
``pack_rgb48`` on a 1080p frame (values in [−0.2, 1.2)) in both types, and
prints one JSON line per case: trunk3's largest error against its plain
version, its ms by CUDA events (three runs of ``chip_smoke.time_ms``) and
the device ms of its SFT passes and convs by kernel name (torch.profiler,
``chip_smoke.launch_split``); the pack checked bit for bit, its ms by CUDA
events and on the card (the profiler's device time), on the same input
every call (which the 50 MB L2 holds: "hot") and on a ring of inputs of
200 MB or more, each call taking the next ("cold": read from device
memory, as the bound counts it). The pack's CUDA-event times are paced by
its wrapper's host time where that exceeds the kernel's.

``--root`` imports ``hdrtv_tpu_torch`` from another unpacked tree (say the
parent commit's, from ``git archive``; run this file by path, not with
``-m``), which builds its kernels into its own ``build/``: run it once per
tree, in turns, in one chip call. The last line is the card's name and
power limit as nvidia-smi gives them. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _chip_smoke():
    """This checkout's chip_smoke.py (its timers), loaded by path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default="", help="an unpacked tree to import hdrtv_tpu_torch from")
    ap.add_argument("--label", default="", help="a name for the tree in the output lines")
    args = ap.parse_args()
    if args.root and "hdrtv_tpu_torch" in sys.modules:
        raise SystemExit("trunk3_pack_times: run the file by path to take --root (-m imported this checkout)")
    sys.path.insert(0, os.path.abspath(args.root) if args.root else ROOT)
    import numpy as np
    import torch

    from hdrtv_tpu_torch.models.layers import fp32_math
    from hdrtv_tpu_torch.ops.megakernel import fused_trunk3, fused_trunk3_ref, trunk3_pack, trunk3_pack_bf16
    from hdrtv_tpu_torch.ops.pack import pack_rgb48, pack_rgb48_ref

    if not torch.cuda.is_available():
        raise SystemExit("trunk3_pack_times needs a CUDA device")
    cs = _chip_smoke()
    dev = torch.device("cuda")
    label = args.label or (args.root or ROOT)
    with fp32_math():
        for dtype, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            rng = np.random.RandomState(1234)

            def t(a, _dt=dt):
                return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev).to(_dt)

            hb, wb, cin, cc, co = 135, 240, 32, 16, 128
            ws, wc = (0.2, 0.1) if dtype == "f32" else (0.05, 0.03)
            fea3, cond4 = t(rng.rand(hb, wb, cin) - 0.2), t(rng.rand(hb, wb, cc) - 0.3)

            def pair(a, b):
                return t(rng.randn(a, b) * ws), t(rng.randn(b) * 0.1, torch.float32)

            def sft():
                return [pair(cc, cc), pair(cc, cin), pair(cc, cc), pair(cc, cin)]

            blocks = [(sft(), t(rng.randn(3, 3, cin, cin) * wc), t(rng.randn(cin) * 0.1, torch.float32),
                       sft(), t(rng.randn(3, 3, cin, cin) * wc), t(rng.randn(cin) * 0.1, torch.float32))
                      for _ in range(4)]
            w_up, b_up = t(rng.randn(3, 3, cin, co) * wc), t(rng.randn(co) * 0.1, torch.float32)
            packed = (trunk3_pack if dtype == "f32" else trunk3_pack_bf16)(blocks, w_up, b_up)

            def trunk(packed=packed):
                return fused_trunk3(fea3, cond4, blocks, w_up, b_up, packed=packed)

            err = float((trunk().float() - fused_trunk3_ref(fea3, cond4, blocks, w_up, b_up).float()).abs().max())
            print(json.dumps({"tree": label, "trunk3": dtype, "max_abs_err": err,
                              "ms": [round(cs.time_ms(trunk, torch), 4) for _ in range(3)],
                              "split": cs.launch_split(trunk, torch, cs.SFT_CONV_PARTS)}), flush=True)

            g = torch.Generator(dev).manual_seed(5)
            v = (torch.rand(1080, 1920, 3, device=dev, generator=g) * 1.4 - 0.2).to(dt)
            if not torch.equal(pack_rgb48(v), pack_rgb48_ref(v)):
                raise AssertionError(f"pack_rgb48 {dtype}: kernel and plain version differ")
            ring = [torch.rand_like(v, dtype=torch.float32).to(dt) for _ in range(max(4, 1 + int(200e6 // v.nbytes)))]
            turn = iter(range(1 << 62))

            def hot():
                return pack_rgb48(v)

            def cold():
                return pack_rgb48(ring[next(turn) % len(ring)])

            part = (("ms", "pack_rgb48"),)
            print(json.dumps({
                "tree": label, "pack": dtype, "ring": len(ring),
                "hot_ms": [round(cs.time_ms(hot, torch), 4) for _ in range(3)],
                "cold_ms": [round(cs.time_ms(cold, torch), 4) for _ in range(3)],
                "card_hot_ms": [cs.launch_split(hot, torch, part)["ms"] for _ in range(3)],
                "card_cold_ms": [cs.launch_split(cold, torch, part)["ms"] for _ in range(3)],
            }), flush=True)
            del ring
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
