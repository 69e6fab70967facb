#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (hdrtv_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels build for sm_90a) and nvcc. It
imports nothing of JAX or of the JAX package. Phases, each printing its own
lines; any failed check raises and the script exits non-zero with no result:

1. card: name and power limit (nvidia-smi), torch/CUDA versions, and the
   build of every kernel from hdrtv_tpu_torch/csrc (time, registers, spills);
2. kernels: each kernel against its plain PyTorch version on the card, at
   every 1080p main-path shape of the fp32 and of the two bf16 frame
   programs and of the HG composite, TF32 off; the kernels only the bf16
   programs run are also held in fp32 at the same shapes. Tolerances. fp32: 1e-4 absolute (5e-4 for
   trunk3's 9-conv chain): the same fp32 products summed in another order.
   bf16: the same exact products summed in fp32 in another order and rounded
   at the same places, so a result moves by one bf16 step where a rounding
   flips: |err| ≤ 2^-7·max(1, |y|) for block_conv3, down2, sft_conv3,
   mix_chain and cond_chain; two steps for resblock, trunk3 and agcm_head,
   whose rounded intermediates feed further convs (twice the one step
   measured). The pack is exact in both types. The tail is compared in its
   packed coarse form, in u16 codes: fp32 ≤ 1 code (the sum order at the +0.5
   boundary). bf16: equal bit for bit except where a bf16 rounding of t or h
   flipped (another sum order): conv_last's fp32 sum is packed unrounded, so
   each of the outputs that read a flipped h moves by |w_last|·step·65535
   codes, step being one bf16 step of h. The bound is computed from the
   run's inputs, max|w_last| · (bf16 step at max|h|) · 65535, doubled for two
   flips under one 3×3 window, and at most TAIL_BF16_SHARE of the values may
   differ at all (twice the share seen). hg_tail, at the 1080p shape of the
   HG composite (544 × 960 blocks, 256 + 256 channels), in codes: fp32 ≤ 1;
   bf16 equal except where the rounding of u10 flipped, each such output
   moving by at most max|wlast| · (bf16 step at max|u10|) · 65535 codes,
   doubled, on at most HG_TAIL_BF16_SHARE of the values. colorimetric at
   (1080, 1920, 3): ≤ 2 codes (powf against torch.pow under the PQ exponent
   78.84), equal at 0 and 1.
   Kernel, plain and library times (CUDA events) and the least
   time the card could take: bytes over 3.35 TB/s, or FLOPs of the non-zero
   weights over the H100 SXM's rate for the element type (67 TFLOP/s fp32
   outside the tensor cores, 989 TFLOP/s bf16), whichever is larger;
3. end to end: HDRTVNetTorch.process_rgb48 on the card against the same
   processor on the CPU, one seeded 360×640 frame, for each of the three
   frame programs: fp32 ≤ 4 u16 codes; bf16 without the megakernels
   (HDRTV_MEGAKERNEL=0) and bf16 with them, the default (a flipped rounding
   is 256 codes near full scale and spreads through the later layers), max
   ≤ 1536 codes and mean ≤ 34, twice what was measured. Then one HG frame
   (HG_E2E_SIZE, which reflect-pads both ways and keeps the CPU run short;
   the synthetic hg_nf = 64 generator of tools/synth_hg.py on the real base
   model) in fp32 and bf16. The highlight mask is a threshold on the base
   output (max RGB > 0.775), so pixels whose base max-RGB lies within a
   margin of it (2e-4 in fp32, 0.02 in bf16) may flip between card and CPU
   and are counted apart (at most HG_NEAR_SHARE of the frame); the rest:
   fp32 ≤ 4 codes, bf16 within HG_BF16_CODES (max, mean);
4. 1080p, the five programs in turn (the three above, then the HG composite
   in bf16 and in fp32, frames as flat rows, hg_tail once per frame and
   pack_rgb48 not at all; its output must differ from the base model's on a
   share of the pixels and stay unclipped on most of them): one frame through
   process_rgb48_device (u8 pair planes from put_frame) with the launch
   counts set to 0 before it and read after, asserted exactly
   (EXPECTED_LAUNCHES: the megakernel program launches agcm_head, cond_chain
   and tail once each and pack_rgb48 not at all), then device-resident frames
   with one sync (3 in fp32, 3 in bf16 without the megakernels, 10 in the
   default program, 5 and 2 with HG): ms/frame, fps, peak memory, output
   range;
5. colorimetric_pq_pack on the 1080p frame (u8 → [0, 1]) in fp32 and bf16:
   the one place the port launches it outside the kernel comparison (no
   frame program reaches it, nor in the JAX package); shape, dtype and range.

The line before the last is the per-kernel JSON summary, one entry per
kernel and element type, with the path whose launches it reports and its
launches on every path; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
HBM_BPS = 3.35e12  # H100 SXM device memory rate
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}  # H100 SXM: fp32 FMA units, bf16 tensor cores
ATOL = 1e-4
TAIL_BF16_SHARE = 0.016  # see the docstring, phase 2
HG_TAIL_BF16_SHARE = 0.01
HG_E2E_SIZE = (184, 336)  # s2d grid 92 × 168: pads 4 rows and 8 columns; takes the megakernel program
HG_NEAR_SHARE = 0.25
HG_CHANGED_CODES = 300  # more than a bf16 step of the base output (256 codes below 1.0)
HG_BF16_CODES = (1536, 60.0)
# The five frame programs (paths): the processor's precision token, the
# element type, HDRTV_MEGAKERNEL, whether the checkpoint is the HG composite,
# frames timed at 1080p, and the launches of one 1080p frame (kernels not
# named launch 0 times). With HG the base program hands its s2d output over
# unpacked and hg_tail packs, so pack_rgb48 launches on no HG path.
_FP32 = {"block_conv3": 12, "down2": 5, "trunk3": 1}
_BF16_MEGA = {"block_conv3": 2, "down2": 5, "trunk3": 1, "sft_conv3": 5, "resblock": 2, "mix_chain": 1,
              "agcm_head": 1, "cond_chain": 1, "tail": 1}
PATHS = {
    "fp32": {"precision": "fp32", "dtype": "f32", "mega": "1", "hg": False, "frames": 3,
             "launches": {**_FP32, "pack_rgb48": 1}},
    "bf16_nomega": {"precision": "fp16", "dtype": "bf16", "mega": "0", "hg": False, "frames": 3, "launches": {
        "block_conv3": 2, "down2": 5, "trunk3": 1, "pack_rgb48": 1, "sft_conv3": 6, "resblock": 2, "mix_chain": 1}},
    "bf16_mega": {"precision": "fp16", "dtype": "bf16", "mega": "1", "hg": False, "frames": 10,
                  "launches": dict(_BF16_MEGA)},
    "hg_bf16": {"precision": "fp16", "dtype": "bf16", "mega": "1", "hg": True, "frames": 5,
                "launches": {**_BF16_MEGA, "hg_tail": 1}},
    "hg_fp32": {"precision": "fp32", "dtype": "f32", "mega": "1", "hg": True, "frames": 2,
                "launches": {**_FP32, "hg_tail": 1}},
}
# The colorimetric pack is on no frame program: phase 5 drives it, once per
# element type, and its entries report that drive.
COLOR_PATHS = {"color_f32": "f32", "color_bf16": "bf16"}
PATH_DTYPE = {**{p: spec["dtype"] for p, spec in PATHS.items()}, **COLOR_PATHS}
KERNEL_INFO = {
    "block_conv3": ("hdrtv_tpu_torch/csrc/block_conv3.cu", "hdrtv_tpu/ops/conv_kernels.py:271"),
    "down2": ("hdrtv_tpu_torch/csrc/down2.cu", "hdrtv_tpu/ops/megakernel.py:706"),
    "trunk3": ("hdrtv_tpu_torch/csrc/trunk3.cu", "hdrtv_tpu/ops/megakernel.py:1161"),
    "pack_rgb48": ("hdrtv_tpu_torch/csrc/pack.cu", "hdrtv_tpu/ops/pack.py:71"),
    "sft_conv3": ("hdrtv_tpu_torch/csrc/sft_conv3.cu", "hdrtv_tpu/ops/megakernel.py:866"),
    "resblock": ("hdrtv_tpu_torch/csrc/resblock.cu", "hdrtv_tpu/ops/megakernel.py:1012"),
    "mix_chain": ("hdrtv_tpu_torch/csrc/mix_chain.cu", "hdrtv_tpu/ops/megakernel.py:1259"),
    "agcm_head": ("hdrtv_tpu_torch/csrc/agcm_head.cu", "hdrtv_tpu/ops/megakernel.py:209"),
    "cond_chain": ("hdrtv_tpu_torch/csrc/cond_chain.cu", "hdrtv_tpu/ops/megakernel.py:352"),
    "tail": ("hdrtv_tpu_torch/csrc/tail.cu", "hdrtv_tpu/ops/megakernel.py:489"),
    "hg_tail": ("hdrtv_tpu_torch/csrc/hg_tail.cu", "hdrtv_tpu/ops/megakernel.py:1435"),
    "colorimetric": ("hdrtv_tpu_torch/csrc/colorimetric.cu", "hdrtv_tpu/ops/pack.py:146"),
}


def expected_launches(path: str) -> dict:
    return {k: PATHS[path]["launches"].get(k, 0) for k in KERNEL_INFO}


def smooth_frame(np, h: int, w: int, seed: int):
    """A u8 frame whose highlights the base model lifts over the HG mask's
    threshold on about a third of the pixels: 8 × 8 blocks of one grey level,
    a third of them clipped to white, under mild noise (uniform noise alone
    stays below the threshold almost everywhere)."""
    rng = np.random.RandomState(seed)
    blocks = np.kron(rng.rand(-(-h // 8), -(-w // 8), 1), np.ones((8, 8, 3)))[:h, :w] * 420
    return np.clip(blocks + rng.randn(h, w, 3) * 10, 0, 255).astype(np.uint8)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, torch) -> float:
    """Mean device time of fn() over enough launches for ~0.2 s, by CUDA
    events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = (time.perf_counter() - t0) * 1e3
    reps = max(3, min(50, int(200.0 / max(one, 1e-3))))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def conv_macs(w, h_out: int, w_out: int, stride: int) -> int:
    """Multiply-adds a 3×3 conv with these weights needs: nonzero weights of
    each tap times the output pixels whose input for that tap lies in the
    image (pad 1 at top/left; at bottom/right only for stride 1)."""
    nnz = (w.reshape(3, 3, -1) != 0).sum(dim=2).cpu()
    total = 0
    for di in range(3):
        for dj in range(3):
            rows = h_out - (di == 0) - (stride == 1 and di == 2)
            cols = w_out - (dj == 0) - (stride == 1 and dj == 2)
            total += int(nnz[di, dj]) * rows * cols
    return total


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype]
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def phase_card(torch, native) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log("phase 1: card")
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib_path = native.build()
    native.lib()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: {lib_path}")
    build_log = lib_path.parent / "build.log"
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())
    return smi


def phase_kernels(torch, np) -> dict:
    """Every kernel at the 1080p main-path shapes, in fp32 and in bf16;
    returns per (kernel, element type, path) per-frame totals: each case
    weighted by its launches per frame of that path. A kernel no fp32 path
    runs is measured in fp32 all the same, weighted like the bf16 paths."""
    import torch.nn.functional as F

    from hdrtv_tpu_torch.models.hg_s2d import _permute_cat_rows
    from hdrtv_tpu_torch.models.s2d import b_s2d, w_ps_permute, w_s2d_1x1, w_s2d_s1, w_s2d_s1_ps, w_s2d_s2
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3, fused_block_conv3_ref
    from hdrtv_tpu_torch.ops.megakernel import (
        agcm_head_pack, fused_agcm_head, fused_agcm_head_ref, fused_cond_chain, fused_cond_chain_ref,
        fused_down2, fused_down2_ref, fused_mix_chain, fused_mix_chain_ref, fused_resblock,
        fused_hg_tail, fused_hg_tail_ref, fused_resblock_ref, fused_sft_conv3_v2, fused_sft_conv3_v2_ref,
        fused_tail, fused_tail_ref, fused_trunk3, fused_trunk3_ref,
    )
    from hdrtv_tpu_torch.ops.pack import colorimetric_pq_pack, colorimetric_pq_pack_ref, pack_rgb48, pack_rgb48_ref

    log("phase 2: kernels against their plain versions (1080p main-path shapes, TF32 off)")
    dev = torch.device("cuda")
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}
    totals: dict = {}

    def runs(dtype, per_path):
        """Launches per frame of a case on the paths that count for ``dtype``:
        those of that element type, or for an fp32 instance that no fp32 path
        launches, the bf16 ones. ``per_path``: a dict path → launches, or the
        case's launches on (fp32, bf16_nomega, bf16_mega), which the two HG
        paths repeat: their base programs are the megakernel and the fp32
        program."""
        if not isinstance(per_path, dict):
            f, n, m = per_path
            per_path = {"fp32": f, "bf16_nomega": n, "bf16_mega": m, "hg_bf16": m, "hg_fp32": f}
        own = {p: k for p, k in per_path.items() if k and PATH_DTYPE[p] == dtype}
        return own or {p: k for p, k in per_path.items() if k and PATH_DTYPE[p] == "bf16"}

    def record(kernel, dtype, case, per_path, y, y_ref, tol, ms, plain_ms, lib_ms, nbytes, flops,
               unit="abs"):
        """``unit``: what ``tol`` bounds. "abs": the absolute error (fp32,
        and u16 codes); "steps": bf16 steps of the result."""
        torch.cuda.synchronize()
        e = (y.float() - y_ref.float()).abs()
        err = float(e.max())
        if unit == "steps":
            steps = float((e / (2.0 ** -7 * y_ref.float().abs().clamp_min(1.0))).max())
            ok, what = steps <= tol, f"{steps:.3f} bf16 steps > {tol}"
        else:
            steps, ok, what = None, err <= tol, f"max abs error {err} > {tol}"
        b_ms, b_by = bound(nbytes, flops, dtype)
        log(json.dumps({
            "kernel": kernel, "dtype": dtype, "case": case, "per_frame": runs(dtype, per_path),
            "max_abs_err": err, "bf16_steps": None if steps is None else round(steps, 3),
            "differ": float((e > 0).float().mean()), "tol": tol,
            "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
            "library_ms": None if lib_ms is None else round(lib_ms, 4),
            "bound_ms": round(b_ms, 4), "bound_by": b_by, "gflop": round(flops / 1e9, 3),
            "mbytes": round(nbytes / 1e6, 3),
        }))
        if not ok:
            raise AssertionError(f"{kernel} {dtype} {case}: {what}")
        for path, n in runs(dtype, per_path).items():
            tot = totals.setdefault((kernel, dtype, path), {
                "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                "bytes": 0.0, "flops": 0.0, "lib_all": True})
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["ms"] += n * ms
            tot["plain_ms"] += n * plain_ms
            tot["bound_ms"] += n * b_ms
            tot["bytes"] += n * nbytes
            tot["flops"] += n * flops
            if lib_ms is None:
                tot["lib_all"] = False
            else:
                tot["library_ms"] += n * lib_ms

    for dtype in ("f32", "bf16"):
        dt = tdt[dtype]
        size = 4 if dtype == "f32" else 2
        unit = "abs" if dtype == "f32" else "steps"
        rng = np.random.RandomState(1234)

        def t(a, _dt=dt):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev).to(_dt)

        def f32(a):
            return t(a, torch.float32)

        def nbytes_of(*tensors):
            return sum(x.numel() * x.element_size() for x in tensors if x is not None)

        def nnz(*ws):
            return sum(int((w != 0).sum()) for w in ws)

        def p11(ci, co, scale=0.05):
            """A 1×1 conv as the model has it: s2d block-diagonal (4ci, 4co)."""
            return t(w_s2d_1x1(rng.randn(1, 1, ci, co).astype(np.float32) * scale)[0, 0])

        def sft4(cc_nat, c_nat):
            """The four SFT 1×1s as the model has them: s2d block-diagonal."""
            return [(p11(ci, co), f32(np.tile(rng.randn(co) * 0.1, 4)))
                    for ci, co in ((cc_nat, cc_nat), (cc_nat, c_nat), (cc_nat, cc_nat), (cc_nat, c_nat))]

        def sft_flops(npix, sft):
            return 2 * npix * nnz(*[w for w, _ in sft])

        # block_conv3: (name, hb, wb, natural ci, natural co, PS-folded, relu, skip,
        #               launches per frame on (fp32, bf16_nomega, bf16_mega))
        for name, hb, wb, ci, co, ps, relu, skip, per_path in (
            ("L0 HR_conv1/2", 540, 960, 32, 32, False, True, False, (2, 0, 0)),
            ("L1 trunk1/5 conv1", 270, 480, 32, 32, False, True, False, (2, 0, 0)),
            ("L1 trunk1/5 conv2", 270, 480, 32, 32, False, False, True, (2, 0, 0)),
            ("L2 trunk2/4 conv1", 135, 240, 32, 32, False, True, False, (2, 0, 0)),
            ("L2 trunk2/4 conv2", 135, 240, 32, 32, False, False, True, (2, 0, 0)),
            ("L1 up_conv3", 270, 480, 32, 128, True, True, False, (1, 1, 1)),
            ("L2 up_conv2", 135, 240, 32, 128, True, True, False, (1, 1, 1)),
        ):
            if not runs(dtype, per_path):
                continue
            w_nat = rng.randn(3, 3, ci, co).astype(np.float32) * 0.05
            w = t(w_s2d_s1_ps(w_nat) if ps else w_s2d_s1(w_nat))
            c, cout = w.shape[2], w.shape[3]
            x = t(rng.rand(hb, wb, c))
            b = f32(rng.randn(cout) * 0.1)
            sk = t(rng.rand(hb, wb, cout)) if skip else None
            y = fused_block_conv3(x, w, b, relu=relu, skip=sk)
            y_r = fused_block_conv3_ref(x, w, b, relu=relu, skip=sk)
            ms = time_ms(lambda: fused_block_conv3(x, w, b, relu=relu, skip=sk), torch)
            plain = time_ms(lambda: fused_block_conv3_ref(x, w, b, relu=relu, skip=sk), torch)
            x_nchw = x[None].permute(0, 3, 1, 2)
            w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            b_lib = b.to(dt)
            lib = time_ms(lambda: F.conv2d(x_nchw, w_oihw, b_lib, padding=1), torch)
            record("block_conv3", dtype, name, per_path, y, y_r, ATOL if dtype == "f32" else 1, ms, plain,
                   lib, nbytes_of(x, w, b, y, sk), 2 * conv_macs(w, hb, wb, 1), unit)
            del x, y, y_r, sk

        # down2: (name, hb, wb, cf, cin, ch0, natural co per branch, branches, act); once per
        # frame on every path
        for name, hb, wb, cf, cin, ch0, co_nat, nbr, act in (
            ("LE.__cond_down (a_sub=3)", 540, 960, 256, None, 0, 64, 3, "lrelu"),
            ("CondNet3.2 window ch0=256", 270, 480, 768, 256, 256, 64, 1, "lrelu"),
            ("CondNet4.2 window ch0=512", 270, 480, 768, 256, 512, 64, 1, "lrelu"),
            ("down_conv1", 540, 960, 128, None, 0, 32, 1, "relu"),
            ("down_conv2", 270, 480, 128, None, 0, 32, 1, "relu"),
        ):
            c = cin or cf
            w = t(np.concatenate([
                w_s2d_s2(rng.randn(3, 3, c // 4, co_nat).astype(np.float32) * 0.05) for _ in range(nbr)
            ], axis=-1))
            cout = w.shape[-1]
            x = t(rng.rand(hb, wb, cf))
            b = f32(rng.randn(cout) * 0.1)
            y = fused_down2(x, w, b, act=act, cin=cin, ch0=ch0)
            xw = x[..., ch0 : ch0 + c]
            y_r = fused_down2_ref(xw, w, b, act=act)
            ms = time_ms(lambda: fused_down2(x, w, b, act=act, cin=cin, ch0=ch0), torch)
            plain = time_ms(lambda: fused_down2_ref(x[..., ch0 : ch0 + c], w, b, act=act), torch)
            x_pad = F.pad(xw[None].permute(0, 3, 1, 2), (1, 0, 1, 0))
            w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            b_lib = b.to(dt)
            lib = time_ms(lambda: F.conv2d(x_pad, w_oihw, b_lib, stride=2), torch)
            record("down2", dtype, name, (1, 1, 1), y, y_r, ATOL if dtype == "f32" else 1, ms, plain, lib,
                   size * hb * wb * c + nbytes_of(w, b, y), 2 * conv_macs(w, hb // 2, wb // 2, 2), unit)
            del x, y, y_r, xw, x_pad

        # sft_conv3: x (hb,wb,128), cond (hb,wb,64); on the bf16 frame programs only (the
        # megakernel program has SFT_layer2 + HR_conv2 in its tail)
        for name, hb, wb, relu, skip, per_path in (
            ("L0 SFT_layer1/2 + HR_conv1/2", 540, 960, True, False, (0, 2, 1)),
            ("L2 trunk2/4 sft1 + conv1", 135, 240, True, False, (0, 2, 2)),
            ("L2 trunk2/4 sft2 + conv2 + skip", 135, 240, False, True, (0, 2, 2)),
        ):
            w = t(w_s2d_s1(rng.randn(3, 3, 32, 32).astype(np.float32) * 0.05))
            x = t(rng.rand(hb, wb, 128) - 0.3)
            cond = t(rng.rand(hb, wb, 64) - 0.3)
            sft = sft4(16, 32)
            b = f32(rng.randn(128) * 0.1)
            sk = t(rng.rand(hb, wb, 128)) if skip else None
            y = fused_sft_conv3_v2(x, cond, sft, w, b, relu=relu, skip=sk)
            y_r = fused_sft_conv3_v2_ref(x, cond, sft, w, b, relu=relu, skip=sk)
            ms = time_ms(lambda: fused_sft_conv3_v2(x, cond, sft, w, b, relu=relu, skip=sk), torch)
            plain = time_ms(lambda: fused_sft_conv3_v2_ref(x, cond, sft, w, b, relu=relu, skip=sk), torch)
            params = [p for pair in sft for p in pair]
            record("sft_conv3", dtype, name, per_path, y, y_r, ATOL if dtype == "f32" else 1, ms, plain,
                   None, nbytes_of(x, cond, w, b, y, sk, *params),
                   2 * conv_macs(w, hb, wb, 1) + sft_flops(hb * wb, sft) + 3 * hb * wb * 128, unit)
            del x, cond, y, y_r, sk

        # resblock at L1: x (270,480,128), cond (270,480,64)
        hb, wb = 270, 480
        for name, coarse in (("L1 trunk1", False), ("L1 trunk5 + up_coarse", True)):
            x = t(rng.rand(hb, wb, 128) - 0.3)
            cond = t(rng.rand(hb, wb, 64) - 0.3)
            up = t(rng.rand(hb // 2, wb // 2, 512) - 0.3) if coarse else None
            sft1, sft2 = sft4(16, 32), sft4(16, 32)
            w1 = t(w_s2d_s1(rng.randn(3, 3, 32, 32).astype(np.float32) * 0.05))
            w2 = t(w_s2d_s1(rng.randn(3, 3, 32, 32).astype(np.float32) * 0.05))
            b1, b2 = f32(rng.randn(128) * 0.1), f32(rng.randn(128) * 0.1)
            args = (x, cond, sft1, w1, b1, sft2, w2, b2)
            y = fused_resblock(*args, up_coarse=up)
            y_r = fused_resblock_ref(*args, up_coarse=up)
            ms = time_ms(lambda: fused_resblock(*args, up_coarse=up), torch)
            plain = time_ms(lambda: fused_resblock_ref(*args, up_coarse=up), torch)
            params = [p for pair in (*sft1, *sft2) for p in pair]
            record("resblock", dtype, name, (0, 1, 1), y, y_r, ATOL if dtype == "f32" else 2, ms, plain, None,
                   nbytes_of(x, cond, up, w1, b1, w2, b2, y, *params),
                   2 * (conv_macs(w1, hb, wb, 1) + conv_macs(w2, hb, wb, 1))
                   + sft_flops(hb * wb, sft1) + sft_flops(hb * wb, sft2) + 8 * hb * wb * 128, unit)
            del x, cond, up, y, y_r, args

        # mix_chain: the CondNet2 tail, window [0, 256) of (270,480,768): 256 → 256 lrelu → 64
        x = t(rng.rand(hb, wb, 768) - 0.3)
        steps = [(p11(64, 64), f32(rng.randn(256) * 0.1), "lrelu"), (p11(64, 16), f32(rng.randn(64) * 0.1), None)]
        y = fused_mix_chain(x, steps, cin=256, ch0=0)
        y_r = fused_mix_chain_ref(x[..., :256], steps)
        ms = time_ms(lambda: fused_mix_chain(x, steps, cin=256, ch0=0), torch)
        plain = time_ms(lambda: fused_mix_chain_ref(x[..., :256], steps), torch)
        record("mix_chain", dtype, "L1 CondNet2.2/.4 window ch0=0", (0, 1, 1), y, y_r,
               ATOL if dtype == "f32" else 1, ms, plain, None,
               size * hb * wb * 256 + nbytes_of(y, *[p for w, b, _ in steps for p in (w, b)]),
               2 * hb * wb * nnz(*[w for w, _, _ in steps]), unit)
        del x, y, y_r

        # The three L0 megakernels at (540, 960): only the bf16 megakernel program runs them.
        hb, wb = 540, 960
        npix = hb * wb

        # agcm_head: u8 pair planes in, scale 1/255; AGCM 3 → 64 → 64 → 3 and the input conv
        # 3 → 32 ‖ 64 in their s2d forms; the three outputs compared as one vector
        xs = torch.as_tensor((rng.rand(hb, 2, wb, 6) * 255).astype(np.uint8), device=dev)
        mods = f32(np.tile(rng.randn(6, 64) * 0.1, (1, 4)))
        mods[4:, 12:] = 0.0
        w_in = t(np.concatenate([w_s2d_s1(rng.randn(3, 3, 3, co).astype(np.float32) * 0.1) for co in (32, 64)], axis=-1))
        hargs = (mods, p11(3, 64, 0.2), f32(rng.randn(256) * 0.1), p11(64, 64), f32(rng.randn(256) * 0.1),
                 p11(64, 3, 0.1), f32(rng.randn(12) * 0.1), w_in, f32(rng.randn(384) * 0.1))
        packed = agcm_head_pack(hargs[1], hargs[5], w_in)

        def head():
            return fused_agcm_head(xs, *hargs, n_first=128, scale=1.0 / 255.0, packed=packed)

        def head_plain():
            return fused_agcm_head_ref(xs, *hargs, n_first=128, scale=1.0 / 255.0)

        def joined(outs):
            return torch.cat([o.reshape(-1) for o in outs])

        y, y_r = head(), head_plain()
        if [tuple(o.shape) for o in y] != [(hb, wb, 128), (hb, wb, 256), (hb, wb, 12)]:
            raise AssertionError(f"agcm_head output shapes {[tuple(o.shape) for o in y]}")
        ms, plain = time_ms(head, torch), time_ms(head_plain, torch)
        record("agcm_head", dtype, "L0 u8 pair planes -> fea, c0, agcm", (0, 0, 1), joined(y), joined(y_r),
               ATOL if dtype == "f32" else 2, ms, plain, None, nbytes_of(xs, *hargs, *y),
               2 * npix * nnz(hargs[1], hargs[3], hargs[5]) + 2 * conv_macs(w_in, hb, wb, 1)
               + 3 * npix * (256 + 256 + 12), unit)
        del xs, y, y_r

        # cond_chain: c0 (540,960,256) → 256 ×4 (lrelu) → 64; c and cond1 compared as one vector
        c0 = t(rng.rand(hb, wb, 256) - 0.3)
        weights = [(p11(64, n), f32(rng.randn(4 * n) * 0.1)) for n in (64, 64, 64, 64, 16)]
        y, y_r = fused_cond_chain(c0, weights), fused_cond_chain_ref(c0, weights)
        if [tuple(o.shape) for o in y] != [(hb, wb, 256), (hb, wb, 64)]:
            raise AssertionError(f"cond_chain output shapes {[tuple(o.shape) for o in y]}")
        ms = time_ms(lambda: fused_cond_chain(c0, weights), torch)
        plain = time_ms(lambda: fused_cond_chain_ref(c0, weights), torch)
        record("cond_chain", dtype, "L0 c0 -> c, cond1", (0, 0, 1), joined(y), joined(y_r),
               ATOL if dtype == "f32" else 1, ms, plain, None,
               nbytes_of(c0, *y, *[p for pair in weights for p in pair]),
               2 * npix * nnz(*[w for w, _ in weights]), unit)
        del c0, y, y_r

        # tail, packed coarse form: s = fea0 (540,960,128) + d2s(up_coarse (270,480,512)),
        # cond1 (…,64), skip (…,12) → (540,2,960,6) u16, compared in codes
        s_ = t(rng.rand(hb, wb, 128) - 0.3)
        up = t(rng.rand(hb // 2, wb // 2, 512) - 0.3)
        cond = t(rng.rand(hb, wb, 64) - 0.3)
        skip = t(rng.rand(hb, wb, 12) * 1.1 - 0.05)
        sft = sft4(16, 32)
        w_hr = t(w_s2d_s1(rng.randn(3, 3, 32, 32).astype(np.float32) * 0.05))
        w_last = t(w_s2d_s1(rng.randn(3, 3, 32, 3).astype(np.float32) * 0.03))
        targs = (s_, cond, skip, sft, w_hr, f32(rng.randn(128) * 0.1), w_last, f32(rng.randn(12) * 0.02))
        y = fused_tail(*targs, pack=True, up_coarse=up)
        y_r = fused_tail_ref(*targs, pack=True, up_coarse=up)
        codes = y_r.to(torch.int32)
        inside = float(((codes > 0) & (codes < 65535)).float().mean())
        if tuple(y.shape) != (hb, 2, wb, 6) or y.dtype != torch.uint16 or inside < 0.5:
            raise AssertionError(f"tail output {tuple(y.shape)} {y.dtype}, {inside:.2f} of the codes unclipped")
        ms = time_ms(lambda: fused_tail(*targs, pack=True, up_coarse=up), torch)
        plain = time_ms(lambda: fused_tail_ref(*targs, pack=True, up_coarse=up), torch)
        params = [p for pair in sft for p in pair] + list(targs[4:])
        tol = 1
        if dtype == "bf16":
            # h as the tail computes it: relu(HR_conv2(sft(round(s + d2s(up)))))
            s_sum = (s_.float() + up.reshape(hb // 2, wb // 2, 2, 2, 128).permute(0, 2, 1, 3, 4)
                     .reshape(hb, wb, 128).float()).to(dt)
            h_max = float(fused_sft_conv3_v2_ref(s_sum, cond, sft, w_hr, targs[5], relu=True).float().abs().max())
            step = 2.0 ** (int(np.floor(np.log2(h_max))) - 7)
            tol = int(2 * float(w_last.float().abs().max()) * step * 65535) + 1
            share = float((y.to(torch.int32) != codes).float().mean())
            log(f"tail bf16: max|h| {h_max:.3f} (bf16 step {step}), max|w_last| "
                f"{float(w_last.float().abs().max()):.4f}: bound {tol} codes; {share:.2e} of the codes differ")
            if share > TAIL_BF16_SHARE:
                raise AssertionError(f"tail bf16: {share:.3e} of the codes differ > {TAIL_BF16_SHARE}")
            del s_sum
        record("tail", dtype, "L0 fea0 + up_coarse -> packed u16", (0, 0, 1), y.to(torch.int32), codes,
               tol, ms, plain, None,
               nbytes_of(s_, up, cond, skip, y, *params),
               2 * (conv_macs(w_hr, hb, wb, 1) + conv_macs(w_last, hb, wb, 1)) + sft_flops(npix, sft)
               + 4 * npix * 128 + 5 * npix * 12)
        del s_, up, cond, skip, y, y_r, codes, targs

        # trunk3 at the /8 level: fea3 (135,240,32), cond4 (135,240,16) → 128. In bf16 the
        # weights are scaled to a chain that does not amplify (gain < 1 per conv, as a
        # trained trunk's): with the fp32 case's weights one flipped rounding grows ~300×.
        hb, wb, cin, cc, co = 135, 240, 32, 16, 128
        ws, wc = (0.2, 0.1) if dtype == "f32" else (0.05, 0.03)
        fea3 = t(rng.rand(hb, wb, cin) - 0.2)
        cond4 = t(rng.rand(hb, wb, cc) - 0.3)

        def pair(a, b_):
            return t(rng.randn(a, b_) * ws), f32(rng.randn(b_) * 0.1)

        blocks = []
        for _ in range(4):
            sft1 = [pair(cc, cc), pair(cc, cin), pair(cc, cc), pair(cc, cin)]
            sft2 = [pair(cc, cc), pair(cc, cin), pair(cc, cc), pair(cc, cin)]
            blocks.append((sft1, t(rng.randn(3, 3, cin, cin) * wc), f32(rng.randn(cin) * 0.1),
                           sft2, t(rng.randn(3, 3, cin, cin) * wc), f32(rng.randn(cin) * 0.1)))
        w_up = t(w_ps_permute(rng.randn(3, 3, cin, co).astype(np.float32) * wc))
        b_up = f32(rng.randn(co) * 0.1)
        y = fused_trunk3(fea3, cond4, blocks, w_up, b_up)
        y_r = fused_trunk3_ref(fea3, cond4, blocks, w_up, b_up)
        ms = time_ms(lambda: fused_trunk3(fea3, cond4, blocks, w_up, b_up), torch)
        plain = time_ms(lambda: fused_trunk3_ref(fea3, cond4, blocks, w_up, b_up), torch)
        flops = 2 * sum(conv_macs(blk[i], hb, wb, 1) for blk in blocks for i in (1, 4))
        flops += 2 * conv_macs(w_up, hb, wb, 1)
        flops += 8 * hb * wb * 2 * 2 * (cc * cc + cc * cin)  # the SFT 1×1 pairs
        params = [p for blk in blocks for s in (blk[0], blk[3]) for pr in s for p in pr]
        params += [blk[i] for blk in blocks for i in (1, 2, 4, 5)] + [w_up, b_up]
        record("trunk3", dtype, "trunk3 + up_conv1 (135x240)", (1, 1, 1), y, y_r, 5e-4 if dtype == "f32" else 2,
               ms, plain, None, nbytes_of(fea3, cond4, y, *params), flops, unit)

        # pack: the (1080,1920,3) frame, values beyond [0,1] included
        v = (torch.rand(1080, 1920, 3, device=dev, generator=torch.Generator(dev).manual_seed(5)) * 1.4 - 0.2).to(dt)
        u = pack_rgb48(v)
        host = u.cpu().numpy()
        if host.dtype != np.uint16 or host.shape != (1080, 1920, 3):
            raise AssertionError(f"pack output {host.dtype} {host.shape}")
        ms = time_ms(lambda: pack_rgb48(v), torch)
        plain = time_ms(lambda: pack_rgb48_ref(v), torch)
        record("pack_rgb48", dtype, f"(1080,1920,3) {dtype} -> u16", {"fp32": 1, "bf16_nomega": 1},
               u.to(torch.int32), pack_rgb48_ref(v).to(torch.int32), 0.0, ms, plain, None,
               v.numel() * (size + 2), v.numel() * 4)

        # colorimetric: the same frame through gamma, gamut, PQ and the pack; on no frame path
        u = colorimetric_pq_pack(v)
        u_r = colorimetric_pq_pack_ref(v)
        if tuple(u.shape) != (1080, 1920, 3) or u.dtype != torch.uint16:
            raise AssertionError(f"colorimetric output {tuple(u.shape)} {u.dtype}")
        ends = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], device=dev, dtype=dt)
        if not torch.equal(colorimetric_pq_pack(ends), colorimetric_pq_pack_ref(ends)):
            raise AssertionError("colorimetric: kernel and plain version differ at 0 or 1")
        ms = time_ms(lambda: colorimetric_pq_pack(v), torch)
        plain = time_ms(lambda: colorimetric_pq_pack_ref(v), torch)
        # per pixel: 3 gamma powers, a 3×3 matrix, 3 × (2 powers, a divide, ~8 more): ~60 operations
        record("colorimetric", dtype, f"(1080,1920,3) {dtype} -> PQ u16", {f"color_{dtype}": 1},
               u.to(torch.int32), u_r.to(torch.int32), 2, ms, plain, None,
               v.numel() * (size + 2), v.numel() * 20)
        del v, u, u_r

        # hg_tail at the 1080p HG shape: Hb 540 reflect-padded to 544, Wb 960, hg_nf = 64, so up5
        # and c1 are (544, 960, 256); relu'd inputs, concat-permuted block-diagonal weights
        hb, wb, cn = 544, 960, 64
        gen = torch.Generator(dev).manual_seed(77)
        up5 = torch.randn(hb, wb, 4 * cn, device=dev, generator=gen).clamp_min_(0).to(dt)
        c1 = torch.randn(hb, wb, 4 * cn, device=dev, generator=gen).clamp_min_(0).to(dt)
        img = t(rng.rand(hb, wb, 12) * 1.1 - 0.05)
        mask4 = t(rng.rand(hb, wb, 4) > 0.6)
        w10 = t(_permute_cat_rows(w_s2d_1x1(rng.randn(1, 1, 2 * cn, 3).astype(np.float32) * 0.06), (cn, cn))[0, 0])
        wlast = t(_permute_cat_rows(w_s2d_1x1(rng.randn(1, 1, 6, 3).astype(np.float32) * 0.3), (3, 3))[0, 0])
        hargs = (up5, c1, img, mask4, w10, f32(b_s2d(rng.randn(3) * 0.1)), wlast, f32(b_s2d(rng.randn(3) * 0.05)))
        y = fused_hg_tail(*hargs)
        y_r = fused_hg_tail_ref(*hargs)
        codes = y_r.to(torch.int32)
        inside = float(((codes > 0) & (codes < 65535)).float().mean())
        if tuple(y.shape) != (hb, 2, wb, 6) or y.dtype != torch.uint16 or inside < 0.5:
            raise AssertionError(f"hg_tail output {tuple(y.shape)} {y.dtype}, {inside:.2f} of the codes unclipped")
        tol = 1
        if dtype == "bf16":
            u10_max = float((up5.float() @ w10[: 4 * cn].float() + c1.float() @ w10[4 * cn :].float()
                             + hargs[5]).abs().max())
            step = 2.0 ** (int(np.floor(np.log2(u10_max))) - 7)
            tol = int(2 * float(wlast[:12].float().abs().max()) * step * 65535) + 1
            share = float((y.to(torch.int32) != codes).float().mean())
            log(f"hg_tail bf16: max|u10| {u10_max:.3f} (bf16 step {step}), max|wlast| "
                f"{float(wlast[:12].float().abs().max()):.4f}: bound {tol} codes; {share:.2e} of the codes differ")
            if share > HG_TAIL_BF16_SHARE:
                raise AssertionError(f"hg_tail bf16: {share:.3e} of the codes differ > {HG_TAIL_BF16_SHARE}")
        ms = time_ms(lambda: fused_hg_tail(*hargs), torch)
        plain = time_ms(lambda: fused_hg_tail_ref(*hargs), torch)
        npix = hb * wb
        record("hg_tail", dtype, "(544,960,256) x2 + base + mask -> packed u16", {"hg_bf16": 1, "hg_fp32": 1},
               y.to(torch.int32), codes, tol, ms, plain, None, nbytes_of(*hargs, y),
               2 * npix * (nnz(w10) + nnz(wlast)) + 6 * npix * 12)
        del up5, c1, img, mask4, y, y_r, codes, hargs
    return totals


def phase_end_to_end(torch, np, hg_weights: str) -> None:
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    frame = (np.random.RandomState(360).rand(360, 640, 3) * 255).astype(np.uint8)
    bounds = {"fp32": (4, None), "bf16_nomega": (1536, 34.0), "bf16_mega": (1536, 34.0)}
    for path, spec in PATHS.items():
        if spec["hg"]:
            continue
        max_codes, mean_codes = bounds[path]
        os.environ["HDRTV_MEGAKERNEL"] = spec["mega"]
        log(f"phase 3: end to end, card against CPU (360x640 {path})")
        t0 = time.perf_counter()
        gpu = HDRTVNetTorch(WEIGHTS, precision=spec["precision"]).process_rgb48(frame)
        t1 = time.perf_counter()
        cpu = HDRTVNetTorch(WEIGHTS, precision=spec["precision"], device="cpu").process_rgb48(frame)
        t2 = time.perf_counter()
        d = np.abs(gpu.astype(np.int64) - cpu.astype(np.int64))
        log(f"card {gpu.shape} {gpu.dtype} range [{gpu.min()}, {gpu.max()}] ({t1 - t0:.2f} s incl. load); "
            f"cpu {t2 - t1:.2f} s; max |card - cpu| = {int(d.max())} codes, mean {float(d.mean()):.3f}, "
            f"{float((d > 0).mean()):.2e} of values differ")
        if gpu.shape != (360, 640, 3) or gpu.dtype != np.uint16:
            raise AssertionError("wrong output shape or dtype")
        if d.max() > max_codes or (mean_codes is not None and d.mean() > mean_codes):
            raise AssertionError(f"{path}: card and CPU differ by max {int(d.max())} > {max_codes} codes "
                                 f"or mean {float(d.mean()):.3f} > {mean_codes}")

    # One HG frame, card against CPU, with the pixels at the mask's threshold counted apart.
    h, w = HG_E2E_SIZE
    frame = smooth_frame(np, h, w, 184)
    for path, spec in PATHS.items():
        if not spec["hg"]:
            continue
        os.environ["HDRTV_MEGAKERNEL"] = spec["mega"]
        log(f"phase 3: end to end with HG, card against CPU ({h}x{w} {path}, hg_nf 64)")
        t0 = time.perf_counter()
        gpu = HDRTVNetTorch(hg_weights, precision=spec["precision"]).process_rgb48(frame)
        t1 = time.perf_counter()
        cpu = HDRTVNetTorch(hg_weights, precision=spec["precision"], device="cpu").process_rgb48(frame)
        t2 = time.perf_counter()
        base = HDRTVNetTorch(WEIGHTS, precision=spec["precision"], device="cpu").process_rgb48(frame)
        m = base.astype(np.float32).max(axis=-1) / 65535.0
        near = np.abs(m - 0.775) <= (2e-4 if spec["dtype"] == "f32" else 0.02)
        d = np.abs(gpu.astype(np.int64) - cpu.astype(np.int64)).max(axis=-1)
        away = d[~near]
        changed = float((np.abs(gpu.astype(np.int64) - base.astype(np.int64)) > HG_CHANGED_CODES).any(axis=-1).mean())
        log(f"card {gpu.shape} {gpu.dtype} range [{gpu.min()}, {gpu.max()}] ({t1 - t0:.2f} s incl. load); "
            f"cpu {t2 - t1:.2f} s; masked {float((m > 0.775).mean()):.3f} of the pixels, {float(near.mean()):.4f} "
            f"near the threshold (max |card - cpu| there {int(d[near].max()) if near.any() else 0}); away from it "
            f"max {int(away.max())} codes, mean {float(away.mean()):.3f}; the HG changed {changed:.3f} of the pixels")
        if gpu.shape != (h, w, 3) or gpu.dtype != np.uint16:
            raise AssertionError("wrong output shape or dtype")
        if near.mean() > HG_NEAR_SHARE or changed < 0.05:
            raise AssertionError(f"{path}: {float(near.mean()):.3f} of the pixels near the threshold, "
                                 f"HG changed {changed:.3f}")
        max_codes, mean_codes = (4, None) if spec["dtype"] == "f32" else HG_BF16_CODES
        if away.max() > max_codes or (mean_codes is not None and away.mean() > mean_codes):
            raise AssertionError(f"{path}: card and CPU differ away from the threshold by max {int(away.max())} > "
                                 f"{max_codes} codes or mean {float(away.mean()):.3f} > {mean_codes}")


def phase_1080p(torch, np, native, path: str, hg_weights: str) -> dict:
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    spec = PATHS[path]
    expected, n = expected_launches(path), spec["frames"]
    os.environ["HDRTV_MEGAKERNEL"] = spec["mega"]
    log(f"phase 4: 1080p {path} frames on the card (HDRTV_MEGAKERNEL={spec['mega']}"
        + (", HG composite, hg_nf 64)" if spec["hg"] else ")"))
    proc = HDRTVNetTorch(hg_weights if spec["hg"] else WEIGHTS, precision=spec["precision"])
    h, w = 1080, 1920
    if spec["hg"]:
        frame = smooth_frame(np, h, w, 1080)
    else:
        frame = (np.random.RandomState(1080).rand(h, w, 3) * 255).astype(np.uint8)
    x = proc.put_frame(frame.reshape(h, w * 3))
    if proc.cfg.use_hg != spec["hg"] or (x.ndim == 2) != spec["hg"]:
        raise AssertionError(f"{path}: use_hg {proc.cfg.use_hg}, frame shipped as {tuple(x.shape)}")
    proc.process_rgb48_device(x)  # warm
    torch.cuda.synchronize()

    native.reset_launch_counts()
    out = proc.process_rgb48_device(x)
    torch.cuda.synchronize()
    counts = dict(native.launch_counts)
    log(f"launches for one frame: {counts}")
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != {expected}")
    o = out.to(torch.int32)
    lo, hi = int(o.min()), int(o.max())
    shape = (h, 3 * w) if spec["hg"] else (h // 2, 2, w // 2, 6)
    if out.shape != shape or out.dtype != torch.uint16 or lo == hi:
        raise AssertionError(f"1080p output {tuple(out.shape)} {out.dtype} range [{lo}, {hi}]")
    if spec["hg"]:
        # What the generator did: against the base model's own output for the same frame, it
        # must have changed a share of the pixels (the masked ones) by more than
        # HG_CHANGED_CODES (in bf16 the HG program sees the base output rounded to bf16, which
        # alone moves every value a little) and left most of them inside the code range: a
        # residual that is neither absent nor clipped everywhere.
        base_proc = HDRTVNetTorch(WEIGHTS, precision=spec["precision"])
        base = base_proc.process_rgb48_device(base_proc.put_frame(frame.reshape(h, w * 3))).reshape(h, w, 3)
        hg = o.reshape(h, w, 3)
        changed = ((hg - base.to(torch.int32)).abs() > HG_CHANGED_CODES).any(dim=-1)
        share = float(changed.float().mean())
        inside = float(((hg[changed] > 0) & (hg[changed] < 65535)).float().mean()) if share else 0.0
        log(f"HG changed {share:.3f} of the pixels; {inside:.3f} of their values lie inside (0, 65535)")
        if not 0.02 < share < 0.98 or inside < 0.5:
            raise AssertionError(f"{path}: the HG changed {share:.3f} of the pixels, {inside:.3f} unclipped")
        del base_proc, base, hg, changed

    native.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        out = proc.process_rgb48_device(x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    peak = torch.cuda.max_memory_allocated()
    if any(native.launch_counts[k] != n * v for k, v in expected.items()):
        raise AssertionError(f"launch counts over {n} frames: {native.launch_counts}")
    log(f"1080p {path}: {ms:.2f} ms/frame, {1e3 / ms:.2f} fps over {n} device-resident frames "
        f"(one sync); peak allocated {peak / 2**30:.2f} GiB; output range [{lo}, {hi}]")
    del proc, x, out
    torch.cuda.empty_cache()
    return counts


def phase_color(torch, np, native) -> dict:
    """colorimetric_pq_pack on the 1080p frame, once per element type with the
    counts set to 0 before and read after; returns the counts by drive."""
    from hdrtv_tpu_torch.ops.pack import colorimetric_pq_pack

    log("phase 5: colorimetric_pq_pack on the 1080p frame (u8 -> [0, 1] -> BT.2020 PQ u16)")
    frame = torch.as_tensor(smooth_frame(np, 1080, 1920, 5), device="cuda")
    counts = {}
    for path, dtype in COLOR_PATHS.items():
        x = (frame.float() * (1.0 / 255.0)).to(torch.float32 if dtype == "f32" else torch.bfloat16)
        native.reset_launch_counts()
        out = colorimetric_pq_pack(x)
        torch.cuda.synchronize()
        counts[path] = dict(native.launch_counts)
        o = out.to(torch.int32)
        lo, hi = int(o.min()), int(o.max())
        log(f"{path}: {tuple(out.shape)} {out.dtype} range [{lo}, {hi}]; launches {counts[path]['colorimetric']}")
        # SDR white at 1000 nits is PQ code 0.7518 · 65535; nothing may exceed it
        if out.shape != (1080, 1920, 3) or out.dtype != torch.uint16 or lo != 0 or not 45000 < hi <= 49300:
            raise AssertionError(f"colorimetric on the frame: {tuple(out.shape)} {out.dtype} range [{lo}, {hi}]")
        if counts[path] != {k: int(k == "colorimetric") for k in KERNEL_INFO}:
            raise AssertionError(f"{path}: launch counts {counts[path]}")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    import shutil
    import tempfile

    sys.path.insert(0, ROOT)
    from hdrtv_tpu_torch.models.layers import fp32_math
    from hdrtv_tpu_torch.ops import native
    from hdrtv_tpu_torch.tools.synth_hg import write_synth_hg

    smi = phase_card(torch, native)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # The repository ships no HG weights: the HG paths run the real base model under a
        # synthetic generator at the reference width, made from a seed.
        hg_weights = write_synth_hg(os.path.join(tmp, "synth_hg64.npz"), nf=64, seed=0)
        with fp32_math():
            totals = phase_kernels(torch, np)
            phase_end_to_end(torch, np, hg_weights)
            counts = {path: phase_1080p(torch, np, native, path, hg_weights) for path in PATHS}
            counts.update(phase_color(torch, np, native))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def entry(name, dtype, path):
        tot = totals[(name, dtype, path)]
        _, b_by = bound(tot["bytes"], tot["flops"], dtype)
        return {"max_abs_err": tot["max_abs_err"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                "bound_ms": tot["bound_ms"], "bound_by": b_by,
                "library_ms": tot["library_ms"] if tot["lib_all"] else None}

    # One entry per kernel and element type that a path runs, reporting the
    # first path of that element type that launches it: fp32 the fp32 path,
    # bf16 the megakernel path (the default) or the path without the
    # megakernels; hg_tail the HG paths; colorimetric its own drive. Times are
    # per frame of the reported path. The fp32 instances of the kernels no
    # fp32 path runs ride along under "off_path" (compared and timed at the
    # same shapes, launched by no path).
    prefer = {"f32": ("fp32", "hg_fp32", "color_f32"), "bf16": ("bf16_mega", "bf16_nomega", "hg_bf16", "color_bf16")}
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        for dtype, paths in prefer.items():
            path = next((p for p in paths if counts[p][name]), None)
            if path is None:
                continue
            k = {"name": f"{name}_{dtype}", "dtype": dtype, "route": "cuda", "source": source,
                 "replaces": replaces, "path": path, "launches": counts[path][name],
                 "launches_by_path": {p: counts[p][name] for p in counts}, **entry(name, dtype, path)}
            if dtype == "bf16" and not any(counts[p][name] for p in prefer["f32"]):
                k["off_path"] = {"dtype": "f32", **entry(name, "f32", path)}
            kernels.append(k)
    if len(kernels) != 18:
        raise AssertionError(f"{len(kernels)} kernel entries, expected 18: {[k['name'] for k in kernels]}")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
