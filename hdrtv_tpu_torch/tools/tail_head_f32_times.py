"""The fp32 s2d forms of the tail and agcm_head at their 1080p shapes, timed on the card.

    python -m hdrtv_tpu_torch.tools.tail_head_f32_times

Runs ``fused_tail`` (s 540 × 960 × 128 + up_coarse, cond1, skip, packed and
unpacked) and ``fused_agcm_head`` (u8 pair planes, scale 1/255) in fp32 with
``s2d=True``, seeded weights in their s2d forms at the programs' natural
widths, and prints one JSON line per case: the largest difference from the
plain version (the packed tail in u16 codes), its ms by CUDA events
(``chip_smoke.time_ms``), the device ms of its launches by kernel name
(torch.profiler, ``chip_smoke.launch_split``: the tail's SFT pass, HR_conv2
and conv_last, the head's AGCM pass and input conv), and the dense form's
ms (``s2d=False``) in the same run. TF32 is off, as in ``chip_smoke.py``.
The last line is the card's name and power limit as nvidia-smi gives them.
Needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _chip_smoke():
    """This checkout's chip_smoke.py (its timers), loaded by path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    import numpy as np
    import torch

    from hdrtv_tpu_torch.models.layers import fp32_math
    from hdrtv_tpu_torch.models.s2d import b_s2d, w_s2d_1x1, w_s2d_s1
    from hdrtv_tpu_torch.ops.megakernel import (
        agcm_head_pack_s2d, fused_agcm_head, fused_agcm_head_ref, fused_tail, fused_tail_ref,
    )

    if not torch.cuda.is_available():
        raise SystemExit("tail_head_f32_times needs a CUDA device")
    cs = _chip_smoke()
    dev = torch.device("cuda")
    rng = np.random.RandomState(29)
    hb, wb = 540, 960

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    def p11(ci, co, scale=0.05):
        return t(w_s2d_1x1(rng.randn(1, 1, ci, co).astype(np.float32) * scale)[0, 0])

    with fp32_math():
        sft = [(p11(ci, co), t(np.tile(rng.randn(co) * 0.1, 4))) for ci, co in ((16, 16), (16, 32), (16, 16), (16, 32))]
        targs = (t(rng.rand(hb, wb, 128) - 0.3), t(rng.rand(hb, wb, 64) - 0.3), t(rng.rand(hb, wb, 12) * 1.1 - 0.05),
                 sft, t(w_s2d_s1(rng.randn(3, 3, 32, 32).astype(np.float32) * 0.05)), t(rng.randn(128) * 0.1),
                 t(w_s2d_s1(rng.randn(3, 3, 32, 3).astype(np.float32) * 0.03)), t(rng.randn(12) * 0.02))
        up = t(rng.rand(hb // 2, wb // 2, 512) - 0.3)
        for pack in (True, False):
            def tail(s2d=True, pack=pack):
                return fused_tail(*targs, pack=pack, up_coarse=up, s2d=s2d)

            err = (tail().float() - fused_tail_ref(*targs, pack=pack, up_coarse=up, s2d=True).float()).abs().max()
            print(json.dumps({"tail": "packed" if pack else "unpacked", "max_err": float(err),
                              "ms": round(cs.time_ms(tail, torch), 4),
                              "dense_ms": round(cs.time_ms(lambda: tail(False), torch), 4),
                              "split": cs.launch_split(tail, torch, cs.TAIL_PARTS)}), flush=True)
        del targs, up

        w_in = t(np.concatenate([w_s2d_s1(rng.randn(3, 3, 3, co).astype(np.float32) * 0.1) for co in (32, 64)],
                                axis=-1))
        b_in = t(np.concatenate([b_s2d(rng.randn(co).astype(np.float32) * 0.1) for co in (32, 64)]))
        hargs = (t(rng.randn(6, 256) * 0.1), p11(3, 64, 0.2), t(b_s2d(rng.randn(64).astype(np.float32) * 0.1)),
                 p11(64, 64, 0.1), t(b_s2d(rng.randn(64).astype(np.float32) * 0.1)), p11(64, 3, 0.1),
                 t(b_s2d(rng.randn(3).astype(np.float32) * 0.1)), w_in, b_in)
        pk = agcm_head_pack_s2d(*hargs[1:6:2], w_in, b_in, n_first=128)
        xs = torch.as_tensor((rng.rand(hb, 2, wb, 6) * 255).astype(np.uint8), device=dev)

        def head(s2d=True):
            return fused_agcm_head(xs, *hargs, n_first=128, scale=1.0 / 255.0, packed_s2d=pk, s2d=s2d)

        ref = fused_agcm_head_ref(xs, *hargs, n_first=128, scale=1.0 / 255.0, s2d=True)
        err = max(float((y - r).abs().max()) for y, r in zip(head(), ref, strict=True))
        print(json.dumps({"agcm_head": "u8 pair planes", "max_err": err, "ms": round(cs.time_ms(head, torch), 4),
                          "dense_ms": round(cs.time_ms(lambda: head(False), torch), 4),
                          "split": cs.launch_split(head, torch, cs.HEAD_PARTS)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
