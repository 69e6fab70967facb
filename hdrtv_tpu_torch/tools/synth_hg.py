"""A composite base + HG checkpoint with synthetic HG weights.

    python -m hdrtv_tpu_torch.tools.synth_hg OUT.npz [--nf 64] [--seed 0] [--gain 1.0]

No trained HG weights ship with the repository (the reference downloads them
when it starts), so timing and smoke runs of the HG composite use correctly
shaped random weights at the reference architecture (the generator's layer
list at ``hg_nf = 64``: conv1 3 → 64 … conv_code2 512 → 512, Up_conv1
512 → 2048 …, conv10 128 → 3, conv_last 6 → 3) on top of the real base model
(``weights/hr_fp32.npz``). The file is written with its ``.json`` sidecar
(``use_hg``, ``hg_nf``), so ``HDRTVNetTorch(OUT.npz)`` runs the HG program.

This is the port's own version of the JAX package's
``tools/bench_modes.py synth_hg_ckpt``, and departs from it in the weight
scale: that one draws every conv at std 0.05, which at a fan-in of 9·512 is a
gain of 2–3 per layer over some twenty layers, so the activations explode,
the composite saturates at the clip, and one flipped bf16 rounding is
amplified beyond any useful comparison. Timing does not care; comparing the
card with the CPU, or a kernel with its plain version, does. Here each conv is
drawn at ``gain / sqrt(fan_in)`` with gain ≤ 1 (``conv_last``, whose output
is added to a base image that is already near the top of the code range where
the mask is set, at a quarter of that) and BatchNorm stays near the identity,
so the generator's output is a bounded, non-constant residual that the clip
leaves mostly alone.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BASE_WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")


def hg_layers(nf: int) -> list[tuple[str, int, int, int, int]]:
    """The generator's convs as (name, kernel, in, out, level): level L runs
    at 1/2^L of the /32-padded frame's side (level 0 is full resolution;
    conv1 and Up_conv5 run there in their s2d forms, the same work)."""
    return [
        ("conv1", 3, 3, nf, 0), ("conv2", 3, nf, 2 * nf, 1),
        ("conv3_1", 3, 2 * nf, 4 * nf, 1), ("conv3_2", 3, 4 * nf, 4 * nf, 2),
        ("conv4_1", 3, 4 * nf, 8 * nf, 2), ("conv4_2", 3, 8 * nf, 8 * nf, 3),
        ("conv5_1", 3, 8 * nf, 8 * nf, 3), ("conv5_2", 3, 8 * nf, 8 * nf, 4),
        ("conv_code1", 3, 8 * nf, 8 * nf, 4), ("conv_code2", 3, 8 * nf, 8 * nf, 5),
        ("Up_conv1", 3, 8 * nf, 32 * nf, 5), ("conv6", 1, 16 * nf, 8 * nf, 4),
        ("Up_conv2", 3, 8 * nf, 32 * nf, 4), ("conv7", 1, 16 * nf, 4 * nf, 3),
        ("Up_conv3", 3, 4 * nf, 16 * nf, 3), ("conv8", 1, 8 * nf, 2 * nf, 2),
        ("Up_conv4", 3, 2 * nf, 8 * nf, 2), ("conv9", 1, 4 * nf, nf, 1),
        ("Up_conv5", 3, nf, 4 * nf, 1), ("conv10", 1, 2 * nf, 3, 0), ("conv_last", 1, 6, 3, 0),
    ]


def hg_conv_gflop(nf: int, h: int, w: int) -> float:
    """GFLOP (2 per multiply-add) of the generator's convs for an (h, w)
    frame, counted from the layer list at the /32-padded size."""
    hp, wp = -(-h // 32) * 32, -(-w // 32) * 32
    return sum(2.0 * k * k * ci * co * (hp >> lvl) * (wp >> lvl) for _, k, ci, co, lvl in hg_layers(nf)) / 1e9


def synth_hg_params(nf: int = 64, seed: int = 0, gain: float = 1.0,
                    base_path: str = BASE_WEIGHTS) -> dict[str, np.ndarray]:
    """The composite parameters (HWIO numpy, as a converted checkpoint holds
    them): ``base.*`` from ``base_path`` and a synthetic ``hg.*`` at width
    ``nf`` from ``numpy.random.RandomState(seed)``."""
    if not 0.0 < gain <= 1.0:
        raise ValueError(f"gain must lie in (0, 1], got {gain}")
    rng = np.random.RandomState(seed)
    p: dict[str, np.ndarray] = {}
    with np.load(base_path) as z:
        for k in z.files:
            p[f"base.{k}"] = z[k]

    def conv(name, ci, co, k=3, bn=False, scale=1.0):
        std = scale * gain / np.sqrt(k * k * ci)
        p[f"{name}.weight"] = (rng.randn(k, k, ci, co) * std).astype(np.float32)
        p[f"{name}.bias"] = (rng.randn(co) * 0.01).astype(np.float32)
        if bn:
            block = name.rsplit(".", 1)[0]
            p[f"{block}.1.running_mean"] = (rng.randn(co) * 0.01).astype(np.float32)
            p[f"{block}.1.running_var"] = (1 + rng.rand(co) * 0.1).astype(np.float32)
            p[f"{block}.1.weight"] = (1 + rng.randn(co) * 0.01).astype(np.float32)
            p[f"{block}.1.bias"] = (rng.randn(co) * 0.01).astype(np.float32)

    # Encoder conv_blocks carry BatchNorm; they and the pixel-shuffle up blocks
    # are Sequentials (key "<name>.0"), the 1×1 mixes plain convs.
    for name, k, ci, co, _ in hg_layers(nf):
        if name.startswith("Up_conv"):
            conv(f"hg.{name}.0", ci, co)
        elif k == 3:
            conv(f"hg.{name}.0", ci, co, bn=True)
        else:
            conv(f"hg.{name}", ci, co, k=1, scale=0.25 if name == "conv_last" else 1.0)
    return p


def write_synth_hg(path: str, nf: int = 64, seed: int = 0, gain: float = 1.0,
                   base_path: str = BASE_WEIGHTS) -> str:
    """Write the composite checkpoint and its sidecar; returns ``path``."""
    from hdrtv_tpu_torch.models.import_npz import load_npz_meta, npz_arch_dict, save_npz

    arch = dict(npz_arch_dict(load_npz_meta(base_path)))
    arch.update({"use_hg": True, "hg_nf": int(nf)})
    save_npz(path, synth_hg_params(nf, seed, gain, base_path), {"architecture": arch})
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", help="the .npz to write (its .json sidecar goes beside it)")
    ap.add_argument("--nf", type=int, default=64, help="HG width (the reference's is 64)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gain", type=float, default=1.0, help="per-conv gain, at most 1")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    print(write_synth_hg(args.out, args.nf, args.seed, args.gain))
    return 0


if __name__ == "__main__":
    sys.exit(main())
