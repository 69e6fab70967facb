"""How often trunk3's bf16 kernel and its plain version round apart, seed by
seed, on the card, and which of the two an exact witness sides with.

    python -m hdrtv_tpu_torch.tools.trunk3_flips [--root DIR] [--seeds 0-11] \
        [--draws chain|tiles] [--shape 27x16 ...] [--conv] [--hybrid]

trunk3 is 9 convs deep, each stage rounded to bf16: where the kernel and the
plain version sum the same exact products in another order, a rounding flips
now and then, and a flip early in the chain reaches every output of a small
frame, so the share of outputs that differ at all is a property of the seed
as much as of the kernel. For each shape and seed this prints, at tests/
test_torch_cuda.py's trunk3 scales (SFT weights 0.05, convs 0.03: gain < 1
per conv), the share of outputs apart and the largest error in bf16 steps
for three pairs: the kernel and the plain version on the card
(``kernel_plain``, what the tests bound), and each of them against a
witness that rounds at the same points but sums in float64 (``kernel_exact``,
``plain_exact``). ``--draws`` picks the tests' draw order:
``chain`` is test_trunk3_matches_plain's (its seed is 18, at 27 × 16),
``tiles`` test_trunk3_bf16_on_hopper_tiles_matches_plain's (its seed is
hb·wb + 37; ``--seeds test`` takes that seed per shape). ``--conv`` also
prints, per seed, how many values of one 32 → 32 conv of the chain's kind
(the Hopper conv tile through ``fused_block_conv3(a_sub=0)``, and the plain
version's cuDNN conv) round apart from the float64 sum: the flips that seed
the chain's. ``--hybrid`` also runs the chain with the plain version's SFT
passes and the Hopper conv tile's convs (``fused_block_conv3``, dense; the
stage skip added in torch) against the witness (``convs_exact``): whether
the conv tile alone moves the chain as far as the kernel does. ``--root``
imports the port from another checkout (for instance the parent commit
unpacked with ``git archive``), so two versions can be held to the same
seeds in one run. TF32 off. Needs a CUDA device; the
last line is the card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CIN, CC, CO = 32, 16, 128


def _seeds(spec: str, hb: int, wb: int) -> list[int]:
    if spec == "test":
        return [hb * wb + 37]
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None, help="a checkout whose hdrtv_tpu_torch to import (default: this one)")
    ap.add_argument("--seeds", default="0-11", help="'0-11,18' or 'test' (the tiles test's seed per shape)")
    ap.add_argument("--draws", choices=("chain", "tiles"), default="chain")
    ap.add_argument("--shape", action="append", default=None, help="HxW (repeatable; default 27x16 5x7 135x240)")
    ap.add_argument("--conv", action="store_true", help="also count one conv's flips against float64")
    ap.add_argument("--hybrid", action="store_true", help="also the chain of plain SFTs and conv-tile convs")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
        for name in [m for m in sys.modules if m.startswith("hdrtv_tpu_torch")]:
            del sys.modules[name]
    import numpy as np
    import torch
    import torch.nn.functional as F

    from hdrtv_tpu_torch.ops import megakernel as mk

    if not torch.cuda.is_available():
        raise SystemExit("trunk3_flips needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    bf = torch.bfloat16

    def t(a, dt=bf):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev).to(dt)

    def sft(rng, s=0.05):
        return [(t(rng.randn(ci, c) * s), t(rng.randn(c) * 0.1, torch.float32))
                for ci, c in ((CC, CC), (CC, CIN), (CC, CC), (CC, CIN))]

    def draws_chain(rng, hb, wb):
        fea3, cond4 = t(rng.rand(hb, wb, CIN) - 0.2), t(rng.rand(hb, wb, CC) - 0.3)
        blocks = [(sft(rng), t(rng.randn(3, 3, CIN, CIN) * 0.03), t(rng.randn(CIN) * 0.1, torch.float32),
                   sft(rng), t(rng.randn(3, 3, CIN, CIN) * 0.03), t(rng.randn(CIN) * 0.1, torch.float32))
                  for _ in range(4)]
        return fea3, cond4, blocks, t(rng.randn(3, 3, CIN, CO) * 0.03), t(rng.randn(CO) * 0.1, torch.float32)

    def draws_tiles(rng, hb, wb):
        fea3, cond4 = t(rng.rand(hb, wb, CIN) - 0.2), t(rng.rand(hb, wb, CC) - 0.3)
        blocks = []
        for _ in range(4):
            w2 = rng.randn(3, 3, CIN, CIN) * 0.03
            blocks.append((sft(rng), t(rng.randn(3, 3, CIN, CIN) * 0.03), t(rng.randn(CIN) * 0.1, torch.float32),
                           sft(rng), t(w2), t(rng.randn(CIN) * 0.1, torch.float32)))
        return fea3, cond4, blocks, t(rng.randn(3, 3, CIN, CO) * 0.03), t(rng.randn(CO) * 0.1, torch.float32)

    def rnd(v):
        return v.to(bf).double()

    def conv64(x, w, b):
        y = F.conv2d(x.permute(2, 0, 1)[None], w.double().permute(3, 2, 0, 1), padding=1)[0]
        return y.permute(1, 2, 0) + b.double()

    def sft64(x, cond, p):
        def mix(p0, p1):
            h = F.leaky_relu(cond @ p0[0].double() + p0[1].double(), 0.1)
            return rnd(h) @ p1[0].double() + p1[1].double()
        return rnd(x * (mix(p[0], p[1]) + 1.0) + mix(p[2], p[3]))

    def exact(fea3, cond4, blocks, w_up, b_up):
        """fused_trunk3_ref's rounding points, every sum and product in float64."""
        x0, cond = fea3.double(), cond4.double()
        x = x0
        for sft1, w1, b1, sft2, w2, b2 in blocks:
            h1 = rnd(torch.clamp_min(conv64(sft64(x, cond, sft1), w1, b1), 0.0))
            x = rnd(x + conv64(sft64(h1, cond, sft2), w2, b2))
        return torch.clamp_min(conv64(rnd(x + x0), w_up, b_up), 0.0).to(bf)

    def hybrid(fea3, cond4, blocks, w_up, b_up):
        """fused_trunk3_ref's SFT passes, the Hopper conv tile's convs."""
        from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3

        cond, x = cond4.float(), fea3
        for sft1, w1, b1, sft2, w2, b2 in blocks:
            h1 = fused_block_conv3(mk._sft(x.float(), cond, sft1, bf).to(bf), w1, b1, relu=True, a_sub=0)
            x = fused_block_conv3(mk._sft(h1.float(), cond, sft2, bf).to(bf), w2, b2, skip=x, a_sub=0)
        return fused_block_conv3((x.float() + fea3.float()).to(bf), w_up, b_up, relu=True, a_sub=0)

    def apart(y, y_ref):
        err = (y.float() - y_ref.float()).abs()
        return [round(float((err > 0).float().mean()), 4),
                round(float((err / (2.0 ** -7 * y_ref.float().abs().clamp_min(1.0))).max()), 3)]

    draws = draws_chain if args.draws == "chain" else draws_tiles
    for shape in args.shape or ["27x16", "5x7", "135x240"]:
        hb, wb = (int(v) for v in shape.split("x"))
        for seed in _seeds(args.seeds, hb, wb):
            a = draws(np.random.RandomState(seed), hb, wb)
            y = mk.fused_trunk3(*a)
            y_p = mk.fused_trunk3_ref(*a)
            y_x = exact(*a)
            torch.cuda.synchronize()
            row = {"port": os.path.dirname(os.path.dirname(mk.__file__)), "draws": args.draws,
                   "shape": [hb, wb], "seed": seed, "kernel_plain": apart(y, y_p),
                   "kernel_exact": apart(y, y_x), "plain_exact": apart(y_p, y_x)}
            if args.hybrid:
                row["convs_exact"] = apart(hybrid(*a), y_x)
            if args.conv:
                from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3

                x = torch.relu(a[0])  # a conv input of the chain's kind: bf16, ≥ 0
                w, b = a[2][0][1], a[2][0][2]
                c_x = conv64(x.double(), w, b).to(bf)
                c_k = fused_block_conv3(x, w, b, a_sub=0)
                c_p = mk._conv_same(x.float(), w, b).to(bf)
                torch.cuda.synchronize()
                row["conv_values"] = int(c_x.numel())
                row["conv_apart_kernel_exact"] = int((c_k != c_x).sum())
                row["conv_apart_plain_exact"] = int((c_p != c_x).sum())
            print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
