"""Probe: the head's K = 12 product on raw byte rows and on row-pair planes
(counterpart of the JAX package's tools/proto_rowmajor_head.py).

    python -m hdrtv_tpu_torch.tools.proto_rowmajor_head [--height 1080 --width 1920 --n 30]

Runs the ``rowmajor_head`` kernel (``csrc/rowmajor_head.cu``) on a seeded u8
frame and (12, 256) bf16 weight in its two forms: ``raw`` reads the (H, 3W)
byte rows, ``pre`` the (Hb, 2, Wb, 6) pair planes, a free view of the same
bytes on this card (on the TPU, XLA had to materialise it). Prints each
form's time by CUDA events over ``n`` calls after a warm-up, the time of the
torch ops that compute the same thing (regroup, cast, ·(1/255) and
a bf16 ``torch.matmul``, the counterpart of the probe's XLA path), the least time
the bytes allow at 3.35 TB/s, and the parity: raw against pre (must be
equal) and against the plain version (within one bf16 step: another fp32
sum order). The last line is the card's name and power limit as nvidia-smi
gives them. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from hdrtv_tpu_torch.ops.probe_kernels import rowmajor_head_pre, rowmajor_head_raw, rowmajor_head_raw_ref
from hdrtv_tpu_torch.tools.proto_d2s_kernel import HBM_BPS, card, time_ms


def torch_sequence(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same head in torch ops (the probe's XLA form): regroup the row
    pairs, cast, ·(1/255), round to bf16, one bf16 ``torch.matmul``."""
    h, w3 = x.shape
    xr = x.view(h // 2, 2, w3 // 6, 6)
    v = (torch.cat([xr[:, 0], xr[:, 1]], dim=-1).float() * (1.0 / 255.0)).to(torch.bfloat16)
    return torch.matmul(v, w)


def run(h: int, w: int, n: int, co: int = 256) -> int:
    if not torch.cuda.is_available():
        print("proto_rowmajor_head: no CUDA device", file=sys.stderr)
        return 2
    if h % 2 or w % 2:
        raise SystemExit(f"height and width must be even, got {h}x{w}")
    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    frame = torch.as_tensor(rng.randint(0, 256, (h, 3 * w), dtype=np.uint8), device=dev)
    pairs = frame.view(h // 2, 2, w // 2, 6)  # the same bytes
    wmat = torch.as_tensor(rng.randn(12, co).astype(np.float32) * 0.1, device=dev).to(torch.bfloat16)
    raw = rowmajor_head_raw(frame, wmat)
    pre = rowmajor_head_pre(pairs, wmat)
    ref = rowmajor_head_raw_ref(frame, wmat)
    torch.cuda.synchronize()
    steps = float(((raw.float() - ref.float()).abs() / (2.0 ** -7 * ref.float().abs().clamp_min(1.0))).max())
    nbytes = frame.numel() + 2 * wmat.numel() + 2 * raw.numel()
    for name, fn in (("raw_rows", lambda: rowmajor_head_raw(frame, wmat)),
                     ("pre_reshaped", lambda: rowmajor_head_pre(pairs, wmat))):
        print(f"{name}: {time_ms(fn, n):.4f} ms/call over {n} calls")
    print(f"torch regroup + cast + matmul: {time_ms(lambda: torch_sequence(frame, wmat), n):.4f} ms/call; "
          f"bound {nbytes / HBM_BPS * 1e3:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s); out {tuple(raw.shape)} bf16")
    print("parity max|diff| raw vs pre:", float((raw.float() - pre.float()).abs().max()))
    print(f"raw vs plain: {steps:.3f} bf16 steps at most")
    print(card())
    return 0 if torch.equal(raw, pre) and steps <= 1.0 else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--n", type=int, default=30)
    args = ap.parse_args()
    return run(args.height, args.width, args.n)


if __name__ == "__main__":
    sys.exit(main())
