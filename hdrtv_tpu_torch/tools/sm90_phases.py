"""Where the Hopper conv tiles spend their time: in-kernel phase timers.

    python -m hdrtv_tpu_torch.tools.sm90_phases

Builds ``tools/sm90_phases.cu`` (the bf16 tile of ``csrc/conv3x3_sm90.cuh``
and the fp32 3×TF32 tile of ``csrc/conv3x3_tf32x3.cuh``, with their
``HDRTV_SM90_PHASES`` clock64() timers) with nvcc into ``build/``, runs them
at the 1080p shapes of the frame programs' block_conv3 and down2 calls
(seeded random s2d weights, the ``a_sub`` the program passes; bf16 at the
bf16 programs' shapes, fp32 at the fp32 programs'), and in bf16 at
resblock's L1 shape, its conv2 (bf16 out) and its conv1 (h1 stored by the
fp32-output epilogue), and prints, per shape,
the mean cycles a warpgroup spends in each phase of its step loop and their
share of its total. The bf16 tile:

- ``wait B``: the loop's bookkeeping and, where the weights stream, the wait
  for this thread's cp.async copies of B;
- ``wait A``: the wait on the stage's mbarrier (TMA's bytes of A);
- ``meet``: the __syncthreads after it;
- ``products``: thread 0's refill, the wgmma issue and the wait for the
  previous step's products;
- ``epilogue``: a tile's last step: its products, bias, activation,
  rounding and stores;
- ``B stream``: the streamed weights' copies and the ring's counters.

The fp32 tile (its step issues this chunk's products, then loads and
splits the next chunk's A fragments under them): ``split A`` (loading and
splitting the next step's fragments), ``wait A`` (the next stage's
mbarrier), ``meet`` (the __syncthreads and thread 0's refill),
``products`` (issuing the 12 wgmmas and, after the split, waiting for
them), ``epilogue`` (bias, skip, activation, stores) and ``B load``
(reading and splitting the block's resident weights, once).

The timers cost time themselves; compare shares, not totals, with the
kernel library's times. Needs a CUDA device; the last line is the card's
name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from hdrtv_tpu_torch.models.s2d import w_s2d_s1_ps, w_s2d_s2
from hdrtv_tpu_torch.ops import native
from hdrtv_tpu_torch.ops.conv_kernels import sm90_table

SRC = Path(__file__).resolve().parent / "sm90_phases.cu"
PHASES = {"bf16": ["total", "wait B", "wait A", "meet", "products", "epilogue", "B stream"],
          "f32": ["total", "split A", "wait A", "meet", "products", "epilogue", "B load"]}
# (name, stride, Hb, Wb, C, Co, a_sub): up_conv3/2 (PS-folded, block_conv3), the
# consolidated CondNet down conv, CondNet3.2's window, down_conv1/2 (down2); in fp32
# also the full-resolution HR_conv1/2 (block_conv3, 128 → 128), which only the fp32
# programs run through block_conv3
SHAPES = [
    ("up_conv3", 1, 270, 480, 128, 512, 1), ("up_conv2", 1, 135, 240, 128, 512, 1),
    ("LE.__cond_down", 2, 540, 960, 256, 768, 3), ("CondNet3.2", 2, 270, 480, 256, 256, 1),
    ("down_conv1", 2, 540, 960, 128, 128, 1), ("down_conv2", 2, 270, 480, 128, 128, 1),
]
SHAPES_F32 = SHAPES + [("HR_conv1", 1, 540, 960, 128, 128, 1)]
# resblock at L1 (bf16 only): conv2, and conv1 with h1 stored in fp32 (the last field)
SHAPES_BF16 = [(*shape, False) for shape in SHAPES] + [
    ("resblock conv2", 1, 270, 480, 128, 128, 1, False), ("resblock conv1 h1 fp32", 1, 270, 480, 128, 128, 1, True),
]


def build() -> ctypes.CDLL:
    out = native.BUILD_ROOT / "sm90_phases" / native.source_hash()
    so = out / "libsm90_phases.so"
    if not so.exists():
        out.mkdir(parents=True, exist_ok=True)
        subprocess.run([native._nvcc(), *native.ARCH_FLAGS, *native.NVCC_FLAGS, "-shared", "-o", str(so), str(SRC)],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hdrtv_sm90_phases.argtypes = [p, p, p, p] + [i] * 8 + [p, i, i, i, p, p]
    lib.hdrtv_sm90_phases.restype = i
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sm90_phases needs a CUDA device")
    lib = build()
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)

    for dtype, shapes in (("bf16", SHAPES_BF16), ("f32", [(*shape, False) for shape in SHAPES_F32])):
        tdt = torch.bfloat16 if dtype == "bf16" else torch.float32

        def t(a, _dt=tdt):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev).to(_dt)

        for name, s, hb, wb, c, co, a_sub, out_f32 in shapes:
            tf = w_s2d_s1_ps if s == 1 else w_s2d_s2
            w = t(np.concatenate([tf(rng.randn(3, 3, c // 4, co // (4 * a_sub)).astype(np.float32) * 0.05)
                                  for _ in range(a_sub)], axis=-1))
            x = t(rng.rand(hb, wb, c))
            b = torch.zeros(co, device=dev)
            y = torch.empty(hb // s, wb // s, co, device=dev, dtype=torch.float32 if out_f32 else tdt)
            phases = torch.zeros(2 * 132 * 8 * 8, dtype=torch.int64, device=dev)
            table, per_list = sm90_table(name, s, a_sub, c, co, c, dtype=tdt)
            stream = torch.cuda.current_stream().cuda_stream
            for _ in range(3):  # warm: the last run's sums are read
                rc = lib.hdrtv_sm90_phases(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), hb, wb, c, 0,
                                           c, co, s, a_sub, table, per_list, int(dtype == "f32"), int(out_f32),
                                           phases.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"{name} {dtype}: CUDA error {rc}")
            torch.cuda.synchronize()
            d = phases.view(-1, 8).cpu().numpy()
            d = d[d[:, 0] > 0]
            mean = d.mean(axis=0)
            shares = {k: f"{mean[i]:.0f} ({mean[i] / mean[0]:.0%})" for i, k in enumerate(PHASES[dtype])}
            print(f"{name} {dtype}: {len(d)} warpgroups, {mean[7]:.0f} steps each; cycles {shares}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
