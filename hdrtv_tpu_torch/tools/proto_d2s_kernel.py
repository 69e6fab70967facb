"""Probe: depth-to-space + add on the card (counterpart of the JAX
package's tools/proto_d2s_kernel.py).

    python -m hdrtv_tpu_torch.tools.proto_d2s_kernel [--hbc 32 --wbc 64 --c 128 --n 30]

Runs the ``d2s_add`` kernel (``csrc/d2s_add.cu``) on a seeded bf16 coarse
(hbc, wbc, 4C) and fine (2·hbc, 2·wbc, C) tensor: the probe's shape by
default, ``--hbc 270 --wbc 480 --c 128`` the 1080p shape where the tail
un-folds ``up_coarse``. Prints the kernel's time by CUDA events over ``n``
calls after a warm-up, the time of the torch ops that compute the same
thing (a permute copy and an add, the counterpart of the probe's XLA d2s +
add), the least time the bytes allow at 3.35 TB/s, and the parity against
the torch ops and the plain version ``d2s_add_ref`` (max |diff| must be 0:
one rounding in each). The last line is the
card's name and power limit as nvidia-smi gives them. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

from hdrtv_tpu_torch.ops.probe_kernels import d2s_add, d2s_add_ref

HBM_BPS = 3.35e12  # H100 SXM device memory rate


def torch_sequence(coarse: torch.Tensor, fine: torch.Tensor) -> torch.Tensor:
    """The same d2s + add in torch ops on bf16 (the probe's XLA form): a
    permute copy, then one bf16 add (fp32 inside, one rounding)."""
    hbc, wbc, c4 = coarse.shape
    c = c4 // 4
    return coarse.reshape(hbc, wbc, 2, 2, c).permute(0, 2, 1, 3, 4).reshape(2 * hbc, 2 * wbc, c) + fine


def time_ms(fn, n: int) -> float:
    """Mean device time of fn() over n calls (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def run(hbc: int, wbc: int, c: int, n: int) -> int:
    if not torch.cuda.is_available():
        print("proto_d2s_kernel: no CUDA device", file=sys.stderr)
        return 2
    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    coarse = torch.as_tensor(rng.randn(hbc, wbc, 4 * c).astype(np.float32), device=dev).to(torch.bfloat16)
    fine = torch.as_tensor(rng.randn(2 * hbc, 2 * wbc, c).astype(np.float32), device=dev).to(torch.bfloat16)
    got = d2s_add(coarse, fine)
    want = torch_sequence(coarse, fine)
    torch.cuda.synchronize()
    diff = float((got.float() - want.float()).abs().max())
    plain = bool(torch.equal(got, d2s_add_ref(coarse, fine)))
    ms = time_ms(lambda: d2s_add(coarse, fine), n)
    torch_ms = time_ms(lambda: torch_sequence(coarse, fine), n)
    nbytes = 2 * (coarse.numel() + fine.numel() + got.numel())
    print(f"d2s_add coarse {tuple(coarse.shape)} fine {tuple(fine.shape)} bf16: kernel {ms:.4f} ms/call, "
          f"torch permute copy + add {torch_ms:.4f} ms, bound {nbytes / HBM_BPS * 1e3:.4f} ms "
          f"({nbytes / 1e6:.1f} MB at 3.35 TB/s), {n} calls")
    print("parity max|diff|:", diff, "(against the plain version: equal)" if plain else "(plain version differs)")
    print(card())
    return 0 if diff == 0.0 and plain else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hbc", type=int, default=32)
    ap.add_argument("--wbc", type=int, default=64)
    ap.add_argument("--c", type=int, default=128)
    ap.add_argument("--n", type=int, default=30)
    args = ap.parse_args()
    return run(args.hbc, args.wbc, args.c, args.n)


if __name__ == "__main__":
    sys.exit(main())
