"""Where the time of one frame goes on the card (counterpart of the JAX
package's tools/profile_frame.py).

    [HDRTV_MEGAKERNEL=0] python -m hdrtv_tpu_torch.tools.profile_frame
        [--precision fp16|fp32] [--hg | --int8] [--height 1080 --width 1920 --frames 3]

Runs warm device-resident frames through HDRTVNetTorch.process_rgb48_device
(bf16 takes the megakernel program unless HDRTV_MEGAKERNEL=0 is set; --hg
runs the HG composite program on a synthetic hg_nf = 64 generator over the
real base model, tools/synth_hg.py, written to a temporary directory;
--int8 the native-int8 programs on the W8A8 checkpoint
tests/fixtures/hr_w8a8.npz) under torch.profiler and prints, per frame: the device time of each kernel
(grouped: the port's CUDA kernels, cuDNN convolutions, GEMMs, elementwise
and reduction passes, copies), the top kernels by device time, the wall
time, and the device busy share (kernel time over wall time; one stream, so
kernels do not overlap), and the number of kernel launches. The port's
kernels are also split by source kernel (conv tile on the FMA units and on
the tensor cores, SFT passes, 1×1 chains, the head's two kernels, conv_last,
pack, the HG tail, the int8 conv tile and quantize pass). The last two lines are the card's
name and power limit as nvidia-smi gives them, and the same breakdown as
JSON. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (group, substrings of the kernel name), first match wins
GROUPS = (
    ("port kernels", ("conv3x3_kernel", "conv3x3_mma_kernel", "sft_kernel", "chain_kernel",
                      "pack_rgb48_kernel", "agcm_kernel", "in_conv_kernel", "conv_last_kernel",
                      "hg_tail_mma_kernel", "hg_tail_fma_kernel", "colorimetric_kernel",
                      "conv3x3_s8_kernel", "quantize_kernel")),
    ("cudnn conv", ("cudnn", "conv", "implicit_gemm", "xmma_fprop", "winograd")),
    ("gemm", ("gemm", "cutlass", "sgemm", "matmul")),
    ("elementwise/reduce", ("elementwise", "vectorized", "reduce", "unrolled", "index", "cat")),
    ("copy", ("copy", "memcpy", "memset")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v:
            return float(v)
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--precision", default="fp16",
                    help="the processor's precision token: fp16 (bf16, the default) or fp32")
    ap.add_argument("--hg", action="store_true",
                    help="the HG composite program (synthetic hg_nf = 64 generator on the real base model)")
    ap.add_argument("--int8", action="store_true",
                    help="the native-int8 programs on the W8A8 checkpoint tests/fixtures/hr_w8a8.npz")
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--trace", default="", help="write a chrome trace to this path")
    args = ap.parse_args()

    import shutil
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from hdrtv_tpu_torch.ops import native
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    h, w, n = args.height, args.width, args.frames
    weights = os.path.join(ROOT, "weights", "hr_fp32.npz")
    if args.int8:
        weights = os.path.join(ROOT, "tests", "fixtures", "hr_w8a8.npz")
    if args.hg:
        from hdrtv_tpu_torch.tools.synth_hg import write_synth_hg

        tmp = tempfile.mkdtemp(prefix="profile_frame_")
        try:
            proc = HDRTVNetTorch(write_synth_hg(os.path.join(tmp, "synth_hg64.npz")), precision=args.precision)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    else:
        proc = HDRTVNetTorch(weights, precision=args.precision)
    dtype = str(proc.policy.compute_dtype).replace("torch.", "")
    frame = (np.random.RandomState(h).rand(h, w, 3) * 255).astype(np.uint8)
    x = proc.put_frame(frame.reshape(h, w * 3))
    for _ in range(2):
        proc.process_rgb48_device(x)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            proc.process_rgb48_device(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    if args.trace:
        prof.export_chrome_trace(args.trace)

    kernels = [e for e in prof.key_averages()
               if device_us(e) > 0 and "cuda" in str(getattr(e, "device_type", "")).lower()]
    groups: dict[str, float] = {}
    for e in kernels:
        groups[group_of(e.key)] = groups.get(group_of(e.key), 0.0) + device_us(e) / 1e3 / n
    busy_ms = sum(groups.values())
    launches = sum(e.count for e in kernels) / n
    mega = native.launch_counts["tail"] + native.launch_counts["tail_w8a8"] > 0
    print(f"card: {torch.cuda.get_device_name(0)}; {h}x{w} {dtype}, {n} frames under torch.profiler; "
          f"megakernel program: {mega}; HG composite: {proc.cfg.use_hg}; native int8: {proc.native_int8}")
    print(f"wall {wall_ms:.3f} ms/frame; kernel time {busy_ms:.3f} ms/frame; "
          f"device busy {busy_ms / wall_ms:.3f}, idle {1 - busy_ms / wall_ms:.3f}; "
          f"{launches:.1f} kernel launches/frame")
    if proc.cfg.use_hg:
        from hdrtv_tpu_torch.tools.synth_hg import hg_conv_gflop

        print(f"the HG generator's convs: {hg_conv_gflop(proc.cfg.hg_nf, h, w):.1f} GFLOP/frame (from the layer list)")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:20s} {ms:9.3f} ms/frame  {ms / busy_ms:6.1%}")
    port: dict[str, list] = {}
    for e in kernels:
        if group_of(e.key) == "port kernels":
            key = next(k for k in GROUPS[0][1] if k in e.key.lower())
            acc = port.setdefault(key, [0.0, 0.0])
            acc[0] += device_us(e) / 1e3 / n
            acc[1] += e.count / n
    for key, (ms, count) in sorted(port.items(), key=lambda kv: -kv[1][0]):
        print(f"    {key:20s} {ms:9.3f} ms/frame  {count:5.1f} launches/frame")
    print("top kernels (ms/frame, launches/frame):")
    top = sorted(kernels, key=lambda e: -device_us(e))[:25]
    for e in top:
        print(f"  {device_us(e) / 1e3 / n:8.3f}  {e.count / n:5.1f}  [{group_of(e.key)}] {e.key[:110]}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "precision": args.precision, "dtype": dtype,
        "height": h, "width": w, "frames": n, "megakernel": mega, "hg": proc.cfg.use_hg,
        "int8": proc.native_int8, "launches": launches,
        "wall_ms": wall_ms, "kernel_ms": busy_ms, "busy": busy_ms / wall_ms,
        "groups_ms": groups, "port_kernels_ms": {k: v[0] for k, v in port.items()},
        "top": [{"name": e.key[:160], "ms": device_us(e) / 1e3 / n, "launches": e.count / n}
                for e in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
