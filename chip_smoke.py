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
   programs run are also held in fp32 at the same shapes. block_conv3 and down2 run with the
   a_sub their callers pass (conv_s1: 1; conv_s2: 3 for the consolidated CondNet down conv, 1
   elsewhere), with which their float forms skip the s2d weights' structural zeros: bf16 on the
   Hopper tile (csrc/conv3x3_sm90.cuh), fp32 on its 3×TF32 sibling (csrc/conv3x3_tf32x3.cuh),
   whose bound is taken at a third of the TF32 rate ("tf32x3"), with the FMA-rate bound beside
   it (bound_fma_ms), and its error and the plain version's against the same conv in float64
   (vs_fp64: mean and mean |error|; information, not a check); and once more each with a_sub = 0 (the dense product: bf16 on the same
   tile, fp32 on the FMA tile of csrc/conv3x3.cuh) at up_conv3's and __cond_down's shape, cases
   no path launches; every case line gives TFLOP/s on the non-zero FLOPs. Tolerances. fp32:
   1e-4 absolute (5e-4 for trunk3's 9-conv chain): the same fp32 products summed in another
   order (on the 3×TF32 tile each product's operands kept to 2^-22 by the split).
   bf16: the same exact products summed in fp32 in another order and rounded
   at the same places, so a result moves by one bf16 step where a rounding
   flips: |err| ≤ 2^-7·max(1, |y|) for block_conv3, down2, sft_conv3,
   mix_chain and cond_chain; two steps for resblock, trunk3 and agcm_head,
   whose rounded intermediates feed further convs (twice the one step
   measured). mix_chain runs in the s2d form the bf16 programs call
   (s2d=True, weights w_s2d_1x1: in bf16 the row tile of csrc/chain_sm90.cuh)
   and in bf16 once more dense (s2d=False), a case no path launches. The pack is exact in both types,
   timed on one 1080p input, which the L2 holds (ms), and on a ring of inputs it does not (cold_ms),
   by CUDA events and on the card (card_ms, card_cold_ms: torch.profiler's device time). The tail is compared in its
   packed coarse form, in u16 codes: fp32 ≤ 1 code (the sum order at the +0.5
   boundary). bf16: equal bit for bit except where a bf16 rounding of t or h
   flipped (another sum order): conv_last's fp32 sum is packed unrounded, so
   each of the outputs that read a flipped h moves by |w_last|·step·65535
   codes, step being one bf16 step of h. The bound is computed from the
   run's inputs, max|w_last| · (bf16 step at max|h|) · 65535, doubled for two
   flips under one 3×3 window, and at most TAIL_BF16_SHARE of the values may
   differ at all (twice the share seen). cond_chain and the tail run in the
   s2d form the megakernel program calls (s2d=True, weights from the s2d
   transforms: in bf16 the Hopper row tile of csrc/chain_sm90.cuh for
   cond_chain and the tail's SFT pass, the Hopper conv tile over the slot
   table for the tail's HR_conv2, and conv_last's tile of csrc/conv_last.cuh
   over w_last's populated slots) against the plain version's s2d form, and in
   bf16 once more in the dense form (s2d=False), a case no path launches,
   with the same tolerances; a "tail_split" line gives each bf16 form's three
   launches (SFT pass, HR_conv2, conv_last) timed apart under torch.profiler.
   In bf16 the s2d tail runs once more unpacked, as the HG composite calls
   it: y in bf16 within that code bound in value plus one bf16 step of y, on
   at most TAIL_BF16_SHARE of the values, with its own "tail_split" line;
   a "conv_last" line gives the third launch alone: its device ms (s2d and
   dense), its bound, the plain version's time on the plain h, and F.conv2d's
   on its conv part alone (no single PyTorch call packs).
   sft_conv3 and resblock likewise run in the s2d form both bf16 programs
   call (s2d=True: in bf16 the SFT passes on the row tile, resblock's SFT2
   reading the fp32 h1, the convs on the Hopper conv tile over the slot
   table, resblock's conv1 storing h1 in fp32) and in bf16 once more in the
   dense form, with the same tolerances; "sft_conv3_split" and
   "resblock_split" lines give each bf16 case's SFT and conv launches apart.
   agcm_head likewise runs in the s2d form the megakernel program calls
   (s2d=True: in bf16 the AGCM pass on the row tile, the input conv on its
   wgmma tile over the s2d slots) and in bf16 once more dense, an
   "agcm_head_split" line giving each form's two launches; trunk3 runs on
   the Hopper tiles with the dense table (bf16: its SFT passes on the row
   tile, its convs on the conv tile; fp32: its SFT passes on the coalesced
   fp32 pass of csrc/trunk3.cu, its convs on the 3×TF32 tile, the bound's
   convs at the "tf32x3" rate and its SFT at the FMA rate, bound_fma_ms
   beside it), a "trunk3_split" line per type giving its SFT and conv
   launches.
   hg_tail, at the 1080p shape of the
   HG composite (544 × 960 blocks, 256 + 256 channels), in codes: fp32 ≤ 1;
   bf16 equal except where the rounding of u10 flipped, each such output
   moving by at most max|wlast| · (bf16 step at max|u10|) · 65535 codes,
   doubled, on at most HG_TAIL_BF16_SHARE of the values. colorimetric at
   (1080, 1920, 3): ≤ 2 codes (powf against torch.pow under the PQ exponent
   78.84), equal at 0 and 1.
   The native-int8 (W8A8) bodies at the 1080p shapes of the three int8
   programs (block_conv3_w8a8 in fp32 and bf16, the other three in bf16 with
   an fp32 instance off the path), each also once with an asymmetric
   calibration (x_zero != 0, so the pad code is not 0). block_conv3_w8a8
   quantizes the same input as its plain version and sums exact int32
   products: equal bit for bit, or within one ulp of the epilogue (fp32) or
   one step (bf16). In the others t's scale and shift are fp32 sums taken in
   another order, so t may differ in its last bit and flip a code: each
   output within the flips' worth (127·yscale each; 2 flips for sft_conv3, 8
   for resblock, whose flipped t1 codes move h1 and t2 around them) plus a
   bf16 step, the packed tail_w8a8 within 2·|w_last|·(one flip + one bf16
   step of h)·65535 codes, and at most INT8_SHARE of the outputs differing.
   sft_conv3_w8a8, tail_w8a8 and resblock_w8a8 run in the s2d form the int8
   programs call (s2d=True: in bf16 the SFT passes on the row tile in its
   int8-output mode, resblock's SFT1 writing the rounded sum and its SFT2
   reading the fp32 h1, the convs on the wgmma s8 tile of
   csrc/conv3x3_s8_sm90.cuh over the slot table, resblock's conv1 storing h1
   in fp32), and block_conv3_w8a8 with the programs' a_sub = 1 (the quantize
   pass, then the s8 tile, in fp32 through its fp32-output epilogue with the
   trunk conv2s' fp32 skip; up_conv2's odd 135 rows included), symmetric and
   asymmetric, and in bf16 once more in the dense form, with the same
   tolerances; "sft_conv3_w8a8_split", "tail_w8a8_split" and
   "resblock_w8a8_split" lines give each bf16 case's launches apart,
   "block_conv3_w8a8_split" each case's in both types.
   The forms ported with the rest of the int8 slice: down2_w8a8 (down2's int8
   body) at the consolidated CondNet down conv (540 × 960 × 256 → 768, three
   branches) and at CondNet3.2/4.2's channel window, symmetric and with zero
   points, in fp32 and bf16 (the same codes and exact sums as its plain
   version: one ulp of the epilogue or one bf16 step), with the programs'
   a_sub (in bf16 the one quantize pass into every branch's code plane, then
   the wgmma s8 tile at stride 2 over the slot table; 135 output rows at the
   window) and in bf16 once more the dense route (a_sub = 0, the mma.sync
   tile, which takes one branch) at the window; a "down2_w8a8_split" line
   gives each bf16 s8-tile case's quantize pass and tile apart, beside the
   bf16 float form of the same call (one launch of the Hopper conv tile, as
   the programs run it without HDRTV_INT8_DOWN2; CUDA events); block_conv3's
   pool_out
   form at L1 up_conv3's shape (270 × 480 × 128 → 512, pooled to 135 × 240),
   float (as block_conv3) and int8 (one ulp or one step), its library time
   F.conv2d + F.relu + F.max_pool2d; cond_chain_w8a8 (steps 0 and 4 int8
   symmetric, step 2 with a zero point) at 540 × 960 × 256, where a float
   step's sum order can flip a code of the next int8 step: each output within
   4 flipped codes' worth of the last int8 step, at most COND_CHAIN_INT8_SHARE
   of them differing.
   The two layout probes (bf16 only, as the Pallas probes): d2s_add at the
   probe's shape (coarse 32 × 64 × 512) and at the 1080p shape where the tail
   un-folds up_coarse (coarse 270 × 480 × 512, fine 540 × 960 × 128), bit for
   bit (one rounding); rowmajor_head raw ((1080, 5760) u8 rows) and pre
   ((540, 2, 960, 6) planes, the same bytes) to Co = 256, each within one
   bf16 step of the plain version (the same exact products summed in fp32 in
   another order), and raw equal to pre bit for bit; beside the plain time,
   the torch-op sequence of the port's probe tools (torch_seq_ms).
   Kernel, plain and library times (CUDA events) and the least
   time the card could take: bytes over 3.35 TB/s, or FLOPs of the non-zero
   weights over the H100 SXM's rate for the element type (67 TFLOP/s fp32
   outside the tensor cores, 989 TFLOP/s bf16; the int8 bodies' operations
   at the 1979 TOPS int8 rate), whichever is larger;
3. end to end: HDRTVNetTorch.process_rgb48's eager program (``_rgb48_eager``,
   kernel by kernel, as before the CUDA graphs; phase 8 holds the graphs to
   it) on the card against the same processor on the CPU, one seeded
   360×640 frame, for each of the three
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
   fp32 ≤ 4 codes, bf16 within HG_BF16_CODES (max, mean). Then the three
   native-int8 programs on the W8A8 checkpoint (tests/fixtures/hr_w8a8.npz)
   at 360×640, card against CPU within INT8_E2E_CODES (max, mean) and at a
   PSNR of at least INT8_E2E_PSNR: a code that flips on one side moves every
   int8 layer after it, so the two drift apart by a share of the quantization
   noise; the floor must lie above the PSNR of the CPU's int8 frame against
   its float program on the same pre-dequantized weights (measured in the
   run), so that a program that skipped quantization fails it. The same for
   the int8 megakernel program with HDRTV_INT8_DOWN2=1 (INT8_DOWN2_E2E_CODES,
   INT8_DOWN2_E2E_PSNR), and for the int8 composite (the W8A8 base under the
   same synthetic generator) at HG_E2E_SIZE, away from the mask's threshold,
   to INT8_HG_E2E_PSNR. Then the natural-layout program (model_apply on the
   untransformed weights, then pack_rgb48), card against CPU: the 540p
   preset frame (540 × 960, 540 % 8 = 4) in fp32, ≤ 4 codes, and in bf16
   within NAT_BF16_CODES (max, mean); turbo off at 360 × 640 in bf16 within
   TURBO_OFF_CODES; the eager W8A8 program (predequantize off) at
   EAGER_E2E_SIZE to the PSNR floor EAGER_E2E_PSNR, which lies above the
   CPU's int8 frame against its float program on the same frame; the natural
   HG composite at HG_NAT_SIZE (sides not multiples of 8; the /32 reflect
   pad) in fp32 and bf16, the pixels near the mask's threshold counted apart
   as above;
4. 1080p, the ten programs in turn (the three above, then the HG composite
   in bf16 and in fp32, frames as flat rows, hg_tail once per frame and
   pack_rgb48 not at all; its output must differ from the base model's on a
   share of the pixels and stay unclipped on most of them; then the three
   int8 programs, on the smooth frame, whose output must differ from the
   float program's on the same pre-dequantized weights by a PSNR at most
   INT8_PSNR_MARGIN under what tests/test_torch_int8.py measures on the
   CPU; then the int8 megakernel program with HDRTV_INT8_DOWN2=1, which
   launches down2_w8a8 three times and down2 twice, and the int8 composite,
   whose base hands tail_w8a8's unpacked output to the generator and hg_tail):
   one frame through
   process_rgb48_device's eager program (u8 pair planes from put_frame)
   with the launch counts set to 0 before it and read after, asserted exactly
   (EXPECTED_LAUNCHES: the megakernel program launches agcm_head, cond_chain
   and tail once each and pack_rgb48 not at all), then device-resident frames
   with one sync (3 in fp32, 3 in bf16 without the megakernels, 10 in the
   default program, 5 and 2 with HG; 10, 3 and 2 in int8; 5 with the int8
   down2, 2 with the int8 composite): ms/frame, fps, peak memory, output range.
   Then the natural program at 540p (NAT_PATHS: bf16, fp32, eager W8A8 in
   bf16), frames as flat rows: pack_rgb48 once a frame and no other kernel,
   asserted exactly; 10, 3 and 3 frames timed;
5. colorimetric_pq_pack on the 1080p frame (u8 → [0, 1]) in fp32 and bf16:
   the one place the port launches it outside the kernel comparison (no
   frame program reaches it, nor in the JAX package); shape, dtype and range;
6. the same for cond_chain's int8 steps and block_conv3's pool_out form
   (float and int8), which no frame program runs either: one call each per
   element type at their 1080p shapes, launch counts asserted, outputs of
   the right shape and finite;
7. the same for the two layout probes' kernels (d2s_add, rowmajor_head raw
   and pre), which no frame program runs either: one call each at its 1080p
   shape, launch counts asserted, output of the right shape and finite;
8. the CUDA graphs of the runtime (runtime/engine.py): right after each of
   the thirteen programs of phase 4, on the same processor and frame,
   process_rgb48_device's first frame (an eager run, the capture, a
   replay): the capture counted exactly one frame's launches of phase 4,
   the first call two; replays count none; every replay equals the eager
   output's bytes (were two eager runs to differ, within phase 3's
   card-against-CPU bound, and said so); two calls return two tensors; then
   eager / replay / replay / eager, the phase 4 frame count each, ms/frame
   and peak allocated memory of each, the graph's memory pool, the card's
   name and power limit on the line; the graph and its pool freed before
   the next program. Then proc_resolution (1920, 1080) on a 1080×1440 frame
   (the letterbox in the graph; equal to eager, one frame's launches of the
   default program) and, card against CPU at 360×640 in the default
   program on six noise frames each, the program as it is,
   proc_resolution (640, 360) on 480×640 frames, fast_condition_resize and
   fast_zero_condition, within RUNTIME_BF16_CODES; and the same card
   frames against planted faults on the CPU (the letterbox one row down;
   each shortcut ignored), each of which must break that bound. One JSON
   line of these numbers comes before the card's line;
9. the playback and export pipeline (pipeline/runner.py, pipeline/export.py,
   the CLI) on pinned host rings and copy streams (phase_pipeline's
   docstring);
10. checkpoints, model variants and metrics: the shipped weights written
   back to the torch layout as a reference .pt, loaded into HDRTVNetTorch
   in bf16 and fp32, its 1080p process_rgb48_device frames bit-equal to
   the .npz processor's, with the same fingerprint (load times printed);
   an HR .pt with a synthetic hg_nf = 64 generator's own .pt as hg_path,
   its BatchNorms unfolded (folded at load), bit-equal at 1080p HG bf16 to
   the processor of the .npz folded the same way; an FP8 source container
   (every 3×3 and 1×1 conv but LE.conv_last named in weight_qparams), its
   emulated layers counted, card against CPU at VARIANT_SIZE within phase
   3's bf16 bound and apart from the fp32 weights' frame; the goldens of
   tests/test_model_variants.py on the card in fp32, TF32 off, within
   GOLDEN_ATOL; every variant of tools/synth_variants.py (five AGCM modes,
   ten LE archs, the lowrank AGCM, the direct HG over the release base, six
   post-correction heads; the fixtures' nf = 16) as a .pt: turbo off, card
   against CPU at VARIANT_SIZE in fp32 (4 codes) and bf16
   (NAT_BF16_CODES, or VARIANT_BF16_CODES), the direct HG's threshold
   pixels counted apart as in phase 3; at 1080p bf16 one eager frame
   launching pack_rgb48 once and nothing else (counts set to 0 before, read
   after), VARIANT_FRAMES eager frames and as many replays of
   process_rgb48_device's graph, ms/frame, replays equal to the eager
   bytes; then full_reference_metrics on the card on the 1080p bf16-default
   / fp32 pair against the port on the CPU within METRIC_TOL, ms per pair,
   and the metrics golden on the card within tests/test_ops.py's
   tolerances. A JSON line of these figures comes before the card's line.

The line before the last is the per-kernel JSON summary, one entry per
kernel and element type, with the path whose launches it reports and its
launches on every path; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
INT8_WEIGHTS = os.path.join(ROOT, "tests", "fixtures", "hr_w8a8.npz")  # W8A8 PTQ of WEIGHTS (test_torch_int8.py)
HBM_BPS = 3.35e12  # H100 SXM device memory rate
# H100 SXM: fp32 FMA units, bf16 tensor cores, int8 tensor cores (dense); and the fp32
# products of the 3×TF32 tile (csrc/conv3x3_tf32x3.cuh): each one three TF32 products
# on the tensor cores (big·big + small·big + big·small), a third of the dense TF32 rate.
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12, "tf32x3": 494.7e12 / 3}
ATOL = 1e-4
TAIL_BF16_SHARE = 0.016  # see the docstring, phase 2
HG_TAIL_BF16_SHARE = 0.01
HG_E2E_SIZE = (184, 336)  # s2d grid 92 × 168: pads 4 rows and 8 columns; takes the megakernel program
HG_NEAR_SHARE = 0.25
HG_CHANGED_CODES = 300  # more than a bf16 step of the base output (256 codes below 1.0)
HG_BF16_CODES = (1536, 60.0)
# int8 against the float program on the pre-dequantized weights, PSNR in dB of the
# smooth frame, as tests/test_torch_int8.py measures it on the CPU (120×256); the
# 1080p frame on the card may sit at most INT8_PSNR_MARGIN under it.
INT8_PSNR_CPU = {"int8_bf16_mega": 33.85, "int8_bf16_nomega": 33.51, "int8_fp32": 33.65}
INT8_PSNR_MARGIN = 3.0
# Share of an int8 body's outputs that may differ from its plain version on the card
# (codes flipped by last-bit differences of t; see phase 2 in the docstring): twice the
# largest share seen over its 1080p cases in both types (sft_conv3 2.02e-6, resblock
# 2.36e-5, tail 1.97e-3 of the codes; NVIDIA H100 80GB HBM3, 700 W).
INT8_SHARE = {"sft_conv3": 4.1e-6, "resblock": 4.8e-5, "tail": 4.0e-3}
# Card against CPU at 360×640 for the three int8 programs, u16 codes (max, mean): twice
# what was seen (7320 / 507.4, 7424 / 497.9, 6169 / 83.6 on the same card). One flipped code
# moves every int8 layer after it, so the int8 programs drift apart far more than the float
# ones (tests/test_torch_int8.py _cascade_note).
INT8_E2E_CODES = {"int8_bf16_mega": (14640, 1015.0), "int8_bf16_nomega": (14848, 996.0),
                  "int8_fp32": (12338, 167.2)}
# The same comparison as a PSNR floor in dB, 3 dB under what was seen (twice the mean
# squared difference; 39.40, 39.46 and 47.58 dB on the same card). The CPU's int8 frame
# against its float program sits at 32.75-32.77 dB on this frame: the floor lies above that.
INT8_E2E_PSNR = {"int8_bf16_mega": 36.4, "int8_bf16_nomega": 36.4, "int8_fp32": 44.5}
# The two paths added with the int8 down2 body and int8 composites, card against CPU:
# HDRTV_INT8_DOWN2=1 on the megakernel program at 360×640 (max, mean codes: twice the 7732
# / 464.7 seen; PSNR floor 3 dB under the 39.90 dB seen), and the int8 HG composite at
# HG_E2E_SIZE away from the mask's threshold (PSNR floor 3 dB under the 57.55 dB seen;
# the CPU's int8 composite against its float one: 33.48 dB). NVIDIA H100 80GB HBM3, 700 W.
INT8_DOWN2_E2E_CODES = (15464, 929.4)
INT8_DOWN2_E2E_PSNR = 36.9
INT8_HG_E2E_PSNR = 54.5
# Share of the int8 cond_chain's outputs that may differ from its plain version (a float
# step's sum order moves the running value by its last bit, which can flip a code of the
# next int8 step): twice the 6.8e-5 seen in bf16 (0 in fp32) at 540 × 960.
COND_CHAIN_INT8_SHARE = 1.4e-4
# The eight frame programs (paths): the processor's precision token, the
# element type, HDRTV_MEGAKERNEL, whether the checkpoint is the HG composite
# (or, "int8", the W8A8 one), frames timed at 1080p, and the launches of one
# 1080p frame (kernels not
# named launch 0 times). With HG the base program hands its s2d output over
# unpacked and hg_tail packs, so pack_rgb48 launches on no HG path.
_FP32 = {"block_conv3": 12, "down2": 5, "trunk3": 1}
_BF16_MEGA = {"block_conv3": 2, "down2": 5, "trunk3": 1, "sft_conv3": 5, "resblock": 2, "mix_chain": 1,
              "agcm_head": 1, "cond_chain": 1, "tail": 1}
# The native-int8 programs (the W8A8 checkpoint, INT8_WEIGHTS): the same programs with
# the quantized layers' convs in the kernels' int8 forms and none in their float forms.
_INT8_MEGA = {"block_conv3_w8a8": 2, "sft_conv3_w8a8": 5, "resblock_w8a8": 2, "tail_w8a8": 1, "agcm_head": 1,
              "cond_chain": 1, "mix_chain": 1, "down2": 5, "trunk3": 1}
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
    "int8_bf16_mega": {"precision": "fp16", "dtype": "bf16", "mega": "1", "hg": False, "int8": True,
                       "frames": 10, "launches": dict(_INT8_MEGA)},
    "int8_bf16_nomega": {"precision": "fp16", "dtype": "bf16", "mega": "0", "hg": False, "int8": True,
                         "frames": 3, "launches": {"sft_conv3_w8a8": 6, "resblock_w8a8": 2,
                                                   "block_conv3_w8a8": 2, "mix_chain": 1, "down2": 5,
                                                   "trunk3": 1, "pack_rgb48": 1}},
    "int8_fp32": {"precision": "fp32", "dtype": "f32", "mega": "1", "hg": False, "int8": True, "frames": 2,
                  "launches": {"block_conv3_w8a8": 12, "down2": 5, "trunk3": 1, "pack_rgb48": 1}},
    # HDRTV_INT8_DOWN2=1: the consolidated CondNet down conv and CondNet3.2/4.2 in down2's
    # int8 body; down_conv1/2 (Co = 128, under the JAX rule's 2·128 per a_sub) stay float.
    "int8_down2_bf16_mega": {"precision": "fp16", "dtype": "bf16", "mega": "1", "hg": False, "int8": True,
                             "down2": "1", "frames": 5,
                             "launches": {**_INT8_MEGA, "down2": 2, "down2_w8a8": 3}},
    # The int8 composite: the W8A8 base (megakernel program, its tail int8 and unpacked)
    # under the synthetic hg_nf = 64 generator in float, hg_tail packing.
    "int8_hg_bf16": {"precision": "fp16", "dtype": "bf16", "mega": "1", "hg": True, "int8": True, "frames": 2,
                     "launches": {**_INT8_MEGA, "hg_tail": 1}},
}
# The colorimetric pack is on no frame program: phase 5 drives it, once per
# element type, and its entries report that drive.
COLOR_PATHS = {"color_f32": "f32", "color_bf16": "bf16"}
# Neither are the int8 steps of cond_chain nor the pool_out form of block_conv3 (no
# program of the JAX package passes them either): phase 6 drives each once per element
# type at its 1080p shape, and their entries report that drive.
FORM_PATHS = {"forms_f32": "f32", "forms_bf16": "bf16"}
FORM_LAUNCHES = {"cond_chain_w8a8": 1, "block_conv3_pool": 1, "block_conv3_pool_w8a8": 1}
# Nor are the two layout probes (the JAX package's tools/proto_d2s_kernel.py and
# tools/proto_rowmajor_head.py, bf16 only): phase 7 drives each kernel once at its 1080p
# shape, and their entries report that drive.
PROBE_PATH = "probes_bf16"
PROBE_SHAPES = {"d2s_probe": (32, 64, 128), "d2s_1080p": (270, 480, 128), "head": (1080, 1920, 256)}
PATH_DTYPE = {**{p: spec["dtype"] for p, spec in PATHS.items()}, **COLOR_PATHS, **FORM_PATHS, PROBE_PATH: "bf16"}
# The natural-layout program (models/hdrtvnet.py model_apply, torch ops, then pack_rgb48):
# the product's 540p preset (960 × 540; 540 % 8 = 4, so HDRTVNetTPU runs it on every
# frame), in its default precision (bf16), fp32, and the eager W8A8 program of the int8
# checkpoint kept int8 (predequantize off). Launches of one frame: pack_rgb48 only.
NAT_SIZE = (540, 960)
NAT_PATHS = {
    "nat540_bf16": {"precision": "fp16", "weights": "float", "kw": {}, "frames": 10},
    "nat540_fp32": {"precision": "fp32", "weights": "float", "kw": {}, "frames": 3},
    "nat540_w8a8_bf16": {"precision": "fp16", "weights": "int8", "kw": {"predequantize": False}, "frames": 3},
}
# Phase 3's natural cases, card against CPU. bf16 at 540 × 960 and turbo off at 360 × 640,
# u16 codes (max, mean): twice what was seen on the card (768 / 28.69 and 768 / 28.26;
# per-op bf16 roundings of cuDNN's and the CPU's sums, 18% of the values differ). The
# eager W8A8 program at EAGER_E2E_SIZE, PSNR floor in dB 3 dB under the 53.62 seen,
# above the CPU's int8 frame against its float program on the same frame (26.25 dB), so
# a program that skipped the fake-quant fails. The natural HG composite at HG_NAT_SIZE
# (sides not multiples of 8), away from the mask's threshold: fp32 ≤ 4 codes (1 seen),
# bf16 within HG_BF16_CODES (512 / 24.47 seen). NVIDIA H100 80GB HBM3, 700 W.
NAT_BF16_CODES = (1536, 57.4)
TURBO_OFF_CODES = (1536, 56.6)
EAGER_E2E_SIZE = (180, 324)
EAGER_E2E_PSNR = 50.6
HG_NAT_SIZE = (180, 324)
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
    "block_conv3_w8a8": ("hdrtv_tpu_torch/csrc/block_conv3.cu", "hdrtv_tpu/ops/conv_kernels.py:271"),
    "sft_conv3_w8a8": ("hdrtv_tpu_torch/csrc/sft_conv3.cu", "hdrtv_tpu/ops/megakernel.py:866"),
    "resblock_w8a8": ("hdrtv_tpu_torch/csrc/resblock.cu", "hdrtv_tpu/ops/megakernel.py:1012"),
    "tail_w8a8": ("hdrtv_tpu_torch/csrc/tail.cu", "hdrtv_tpu/ops/megakernel.py:489"),
    "down2_w8a8": ("hdrtv_tpu_torch/csrc/down2.cu", "hdrtv_tpu/ops/megakernel.py:706"),
    "cond_chain_w8a8": ("hdrtv_tpu_torch/csrc/cond_chain.cu", "hdrtv_tpu/ops/megakernel.py:352"),
    "block_conv3_pool": ("hdrtv_tpu_torch/csrc/block_conv3.cu", "hdrtv_tpu/ops/conv_kernels.py:271"),
    "block_conv3_pool_w8a8": ("hdrtv_tpu_torch/csrc/block_conv3.cu", "hdrtv_tpu/ops/conv_kernels.py:271"),
    "d2s_add": ("hdrtv_tpu_torch/csrc/d2s_add.cu", "tools/proto_d2s_kernel.py:34"),
    "rowmajor_head_raw": ("hdrtv_tpu_torch/csrc/rowmajor_head.cu", "tools/proto_rowmajor_head.py:35"),
    "rowmajor_head_pre": ("hdrtv_tpu_torch/csrc/rowmajor_head.cu", "tools/proto_rowmajor_head.py:45"),
}
# The launch counter a KERNEL_INFO entry reads, where it is not its own name: the head
# probe's two forms share one kernel body and one counter.
COUNTER = {"rowmajor_head_raw": "rowmajor_head", "rowmajor_head_pre": "rowmajor_head"}


def read_counts(native) -> dict:
    """The launch counts by KERNEL_INFO entry."""
    return {k: native.launch_counts[COUNTER.get(k, k)] for k in KERNEL_INFO}


def expected_launches(path: str) -> dict:
    return {k: PATHS[path]["launches"].get(k, 0) for k in KERNEL_INFO}


def set_path_env(spec: dict) -> None:
    """The switches a path runs under, read by the port at each call."""
    os.environ["HDRTV_MEGAKERNEL"] = spec["mega"]
    os.environ["HDRTV_INT8_DOWN2"] = spec.get("down2", "0")


def path_weights(spec: dict, hg_weights: dict) -> str:
    """The checkpoint a path runs: the base model, its W8A8 PTQ, or the
    synthetic composite over either."""
    if spec["hg"]:
        return hg_weights["int8" if spec.get("int8") else "float"]
    return INT8_WEIGHTS if spec.get("int8") else WEIGHTS


def smooth_frame(np, h: int, w: int, seed: int):
    """A u8 frame whose highlights the base model lifts over the HG mask's
    threshold on about a third of the pixels: 8 × 8 blocks of one grey level,
    a third of them clipped to white, under mild noise (uniform noise alone
    stays below the threshold almost everywhere)."""
    rng = np.random.RandomState(seed)
    blocks = np.kron(rng.rand(-(-h // 8), -(-w // 8), 1), np.ones((8, 8, 3)))[:h, :w] * 420
    return np.clip(blocks + rng.randn(h, w, 3) * 10, 0, 255).astype(np.uint8)


def psnr(mse: float) -> float:
    """PSNR in dB of a mean squared difference of values in [0, 1]."""
    return 10 * math.log10(1.0 / max(mse, 1e-20))


def log(msg: str) -> None:
    print(msg, flush=True)


def eager_rgb48(proc, frame):
    """process_rgb48 on the eager frame program, kernel by kernel (what
    phases 3 and 4 run; process_rgb48 itself replays the program's CUDA
    graph, which phase 8 drives)."""
    h, w, _ = frame.shape
    return proc._hw3(proc._rgb48_eager(proc.put_frame(frame.reshape(h, w * 3))).cpu().numpy())


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


SPLIT_ATTEMPTS = 3  # profiler sessions launch_split takes at most for one split


def launch_split(fn, torch, parts, reps: int = 20) -> dict:
    """Device ms per call of each launch kind of one kernel call, from
    torch.profiler over ``reps`` calls of fn() after a warm one: the kernels'
    device time summed by name. ``parts``: (key, substring of the kernel
    name), first match wins; the rest goes to other_ms. Every part must
    show device time. "kernels" has each kernel's ms by its name with its
    template arguments (which tell, say, resblock's two SFT passes and two
    convs apart). The profiler sometimes reports a session without some or
    all of its kernels (seen late in phase 2 on an H100): a session where a
    part shows none is profiled again, at most SPLIT_ATTEMPTS times in all,
    and "attempts" says how many it took."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, SPLIT_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        split = {key: 0.0 for key, _ in parts}
        split["other_ms"] = 0.0
        kernels = {}
        for e in prof.key_averages():
            us = next((float(v) for v in (getattr(e, a, None) for a in ("self_device_time_total",
                                                                         "self_cuda_time_total")) if v), 0.0)
            name = e.key.lower()
            part = next((key for key, sub in parts if sub in name), "other_ms")
            split[part] += us / 1e3 / reps
            if us:
                kernels[e.key.split("(anonymous namespace)::", 1)[-1].split("(")[0]] = round(us / 1e3 / reps, 4)
        if all(split[key] > 0 for key, _ in parts):
            return {**{k: round(v, 4) for k, v in split.items()}, "kernels": kernels, "attempts": attempt}
    raise AssertionError(f"the profiler saw no device time for one of the launches in {SPLIT_ATTEMPTS} sessions: "
                         f"{split}")


# The launches of the tail (its SFT pass, HR_conv2, conv_last) and of sft_conv3 and
# resblock (SFT passes, 3×3 convs), by kernel name.
TAIL_PARTS = (("conv_last_ms", "conv_last"), ("sft_ms", "sft"), ("hr_conv2_ms", "conv3x3"))
SFT_CONV_PARTS = (("sft_ms", "sft"), ("conv_ms", "conv3x3"))
# block_conv3_w8a8's two launches: the quantize pass, the int8 conv.
QCONV_PARTS = (("quantize_ms", "quantize"), ("conv_ms", "conv3x3"))
# agcm_head's two launches (the AGCM pass, the input conv), dense or s2d.
HEAD_PARTS = (("agcm_ms", "agcm"), ("in_conv_ms", "in_conv"))


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


def bound(nbytes: float, flops: float, rate: str, fma_flops: float = 0.0) -> tuple[float, str]:
    """Least time in ms for the bytes at HBM_BPS and the operations at the
    peak rate ``rate`` (a key of PEAK_FLOPS), of which ``fma_flops`` run on
    the FMA units whatever ``rate`` says (trunk3's SFT passes beside its
    3×TF32 convs), and which of the two."""
    t_b = nbytes / HBM_BPS
    t_o = (flops - fma_flops) / PEAK_FLOPS[rate] + fma_flops / PEAK_FLOPS["f32"]
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
            if "registers" in line or "spill" in line or "C75" in line:
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
        agcm_head_pack, agcm_head_pack_s2d, fused_agcm_head, fused_agcm_head_ref, fused_cond_chain,
        fused_cond_chain_ref,
        fused_down2, fused_down2_ref, fused_mix_chain, fused_mix_chain_ref, fused_resblock,
        fused_hg_tail, fused_hg_tail_ref, fused_resblock_ref, fused_sft_conv3_v2, fused_sft_conv3_v2_ref,
        fused_tail, fused_tail_ref, fused_trunk3, fused_trunk3_ref, trunk3_pack, trunk3_pack_bf16,
    )
    from hdrtv_tpu_torch.ops.pack import colorimetric_pq_pack, colorimetric_pq_pack_ref, pack_rgb48, pack_rgb48_ref
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3_q_ref
    from hdrtv_tpu_torch.ops.megakernel import _conv_same, _s2d_slots_only, _sft_conv_t, _sft_t
    from hdrtv_tpu_torch.ops.megakernel import fused_down2_q_ref
    from hdrtv_tpu_torch.ops.w8a8 import pack_qargs, pack_qargs_branches
    from hdrtv_tpu_torch.quant.int8 import quantize_weight

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
               unit="abs", share=None, rate=None, extra=None, fma_flops=0.0, cold_ms=None):
        """``unit``: what ``tol`` bounds. "abs": the absolute error (fp32,
        and u16 codes); "steps": bf16 steps of the result; "flips": the
        absolute error of an int8 body, ``tol`` being what its flipped codes
        can move an output by, plus in bf16 one step of its rounding.
        ``share``: at most this share of the values may differ at all.
        ``rate``: the peak rate of the bound's operations (default: the
        element type's), ``fma_flops`` the part of ``flops`` on the FMA units
        at any rate. ``extra``: more fields for the case's line. ``cold_ms``:
        the time on inputs the L2 does not hold (``ms`` being on one that
        stays in it), reported beside ``ms``."""
        torch.cuda.synchronize()
        e = (y.float() - y_ref.float()).abs()
        err = float(e.max())
        steps = None
        if unit == "steps":
            steps = float((e / (2.0 ** -7 * y_ref.float().abs().clamp_min(1.0))).max())
            ok, what = steps <= tol, f"{steps:.3f} bf16 steps > {tol}"
        elif unit == "flips":
            slack = tol + (2.0 ** -7 * y_ref.float().abs().clamp_min(1.0) if dtype == "bf16" else 0.0)
            ok, what = bool((e <= slack).all()), f"max abs error {err} beyond {tol} (+ a bf16 step)"
        else:
            ok, what = err <= tol, f"max abs error {err} > {tol}"
        differ = float((e > 0).float().mean())
        if ok and share is not None and differ > share:
            ok, what = False, f"{differ:.3e} of the values differ > {share}"
        rate = rate or dtype
        b_ms, b_by = bound(nbytes, flops, rate, fma_flops)
        # the 3×TF32 tile's fp32 products: the FMA units' bound beside the tensor cores'
        fma_ms = bound(nbytes, flops, "f32")[0] if rate == "tf32x3" else None
        log(json.dumps({
            "kernel": kernel, "dtype": dtype, "case": case, "per_frame": runs(dtype, per_path),
            "max_abs_err": err, "bf16_steps": None if steps is None else round(steps, 3),
            "differ": differ, "tol": tol, "share": share,
            "ms": round(ms, 4), **({} if cold_ms is None else {"cold_ms": round(cold_ms, 4)}),
            "plain_ms": round(plain_ms, 4), "library_ms": None if lib_ms is None else round(lib_ms, 4),
            "bound_ms": round(b_ms, 4), "bound_by": b_by, "rate": rate, "gflop": round(flops / 1e9, 3),
            **({} if fma_ms is None else {"bound_fma_ms": round(fma_ms, 4)}),
            "tflops": round(flops / ms / 1e9, 1),
            "mbytes": round(nbytes / 1e6, 3), **(extra or {}),
        }))
        if not ok:
            raise AssertionError(f"{kernel} {dtype} {case}: {what}")
        for path, n in runs(dtype, per_path).items():
            tot = totals.setdefault((kernel, dtype, path), {
                "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                "bytes": 0.0, "flops": 0.0, "fma_flops": 0.0, "lib_all": True, "rate": rate})
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["ms"] += n * ms
            tot["plain_ms"] += n * plain_ms
            tot["bound_ms"] += n * b_ms
            if fma_ms is not None:
                tot["bound_fma_ms"] = tot.get("bound_fma_ms", 0.0) + n * fma_ms
            if cold_ms is not None:
                tot["cold_ms"] = tot.get("cold_ms", 0.0) + n * cold_ms
            tot["bytes"] += n * nbytes
            tot["flops"] += n * flops
            tot["fma_flops"] += n * fma_flops
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

        def vs_fp64(y, y_r, y64):
            """The fp32 3×TF32 tile's and the plain version's error against the
            same conv in float64: mean (a drift of the sums toward zero shows
            here) and mean |error|. Information, not a check."""
            out = {}
            for who, v in (("kernel", y), ("plain", y_r)):
                e = v.double() - y64
                out[who] = {"mean": float(e.mean()), "mean_abs": float(e.abs().mean())}
            return {"vs_fp64": out}

        def act64(y, act):
            return F.relu(y) if act == "relu" else F.leaky_relu(y, 0.1) if act == "lrelu" else y

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
            # a_sub as conv_s1 passes it (the weight is s2d-structured); once more dense
            for a_sub in (1, 0) if name == "L1 up_conv3" else (1,):
                y = fused_block_conv3(x, w, b, relu=relu, skip=sk, a_sub=a_sub)
                y_r = fused_block_conv3_ref(x, w, b, relu=relu, skip=sk)
                ms = time_ms(lambda: fused_block_conv3(x, w, b, relu=relu, skip=sk, a_sub=a_sub), torch)
                plain = time_ms(lambda: fused_block_conv3_ref(x, w, b, relu=relu, skip=sk), torch)
                x_nchw = x[None].permute(0, 3, 1, 2)
                w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                b_lib = b.to(dt)
                lib = time_ms(lambda: F.conv2d(x_nchw, w_oihw, b_lib, padding=1), torch)
                extra = None
                if dtype == "f32" and a_sub:
                    y64 = F.conv2d(x_nchw.double(), w_oihw.double(), b.double(), padding=1)[0].permute(1, 2, 0)
                    y64 = act64(y64 if sk is None else y64 + sk.double(), "relu" if relu else None)
                    extra = vs_fp64(y, y_r, y64)
                    del y64
                record("block_conv3", dtype, f"{name} a_sub={a_sub}", per_path if a_sub else (0, 0, 0), y, y_r,
                       ATOL if dtype == "f32" else 1, ms, plain, lib, nbytes_of(x, w, b, y, sk),
                       2 * conv_macs(w, hb, wb, 1), unit, rate="tf32x3" if dtype == "f32" and a_sub else None,
                       extra=extra)
            del x, y, y_r, sk

        # down2: (name, hb, wb, cf, cin, ch0, natural co per branch, branches = a_sub, act); once
        # per frame on every path
        for name, hb, wb, cf, cin, ch0, co_nat, nbr, act in (
            ("LE.__cond_down", 540, 960, 256, None, 0, 64, 3, "lrelu"),
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
            xw = x[..., ch0 : ch0 + c]
            y_r = fused_down2_ref(xw, w, b, act=act)
            plain = time_ms(lambda: fused_down2_ref(x[..., ch0 : ch0 + c], w, b, act=act), torch)
            x_pad = F.pad(xw[None].permute(0, 3, 1, 2), (1, 0, 1, 0))
            w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            b_lib = b.to(dt)
            lib = time_ms(lambda: F.conv2d(x_pad, w_oihw, b_lib, stride=2), torch)
            # a_sub as conv_s2 passes it; once more dense
            for a_sub in (nbr, 0) if name == "LE.__cond_down" else (nbr,):
                y = fused_down2(x, w, b, act=act, cin=cin, ch0=ch0, a_sub=a_sub)
                ms = time_ms(lambda: fused_down2(x, w, b, act=act, cin=cin, ch0=ch0, a_sub=a_sub), torch)
                extra = None
                if dtype == "f32" and a_sub:
                    y64 = F.conv2d(x_pad.double(), w_oihw.double(), b.double(), stride=2)[0].permute(1, 2, 0)
                    extra = vs_fp64(y, y_r, act64(y64, act))
                    del y64
                record("down2", dtype, f"{name} a_sub={a_sub}", (1, 1, 1) if a_sub else (0, 0, 0), y, y_r,
                       ATOL if dtype == "f32" else 1, ms, plain, lib, size * hb * wb * c + nbytes_of(w, b, y),
                       2 * conv_macs(w, hb // 2, wb // 2, 2), unit,
                       rate="tf32x3" if dtype == "f32" and a_sub else None, extra=extra)
            del x, y, y_r, xw, x_pad

        # sft_conv3: x (hb,wb,128), cond (hb,wb,64); on the bf16 frame programs only (the
        # megakernel program has SFT_layer2 + HR_conv2 in its tail). The programs' s2d form
        # (bf16: the SFT on the row tile, the conv on the Hopper conv tile over the slot
        # table), then in bf16 the dense form once (no path launches it)
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
            params = [p for pair in sft for p in pair]
            for s2d in (True, False) if dtype == "bf16" else (True,):
                def call(s2d=s2d):
                    return fused_sft_conv3_v2(x, cond, sft, w, b, relu=relu, skip=sk, s2d=s2d)

                def call_plain(s2d=s2d):
                    return fused_sft_conv3_v2_ref(x, cond, sft, w, b, relu=relu, skip=sk, s2d=s2d)

                y, y_r = call(), call_plain()
                ms, plain = time_ms(call, torch), time_ms(call_plain, torch)
                if dtype == "bf16":
                    log(json.dumps({"sft_conv3_split": {"case": name, "s2d": s2d,
                                                        **launch_split(call, torch, SFT_CONV_PARTS)}}))
                record("sft_conv3", dtype, f"{name} s2d={s2d}", per_path if s2d else (0, 0, 0), y, y_r,
                       ATOL if dtype == "f32" else 1, ms, plain, None, nbytes_of(x, cond, w, b, y, sk, *params),
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
            params = [p for pair in (*sft1, *sft2) for p in pair]
            # the programs' s2d form (bf16: both SFT passes on the row tile, both convs on the
            # Hopper conv tile, conv1 storing h1 in fp32), then in bf16 the dense form once
            for s2d in (True, False) if dtype == "bf16" else (True,):
                def call(s2d=s2d):
                    return fused_resblock(*args, up_coarse=up, s2d=s2d)

                def call_plain(s2d=s2d):
                    return fused_resblock_ref(*args, up_coarse=up, s2d=s2d)

                y, y_r = call(), call_plain()
                ms, plain = time_ms(call, torch), time_ms(call_plain, torch)
                if dtype == "bf16":
                    log(json.dumps({"resblock_split": {"case": name, "s2d": s2d,
                                                       **launch_split(call, torch, SFT_CONV_PARTS)}}))
                record("resblock", dtype, f"{name} s2d={s2d}", (0, 1, 1) if s2d else (0, 0, 0), y, y_r,
                       ATOL if dtype == "f32" else 2, ms, plain, None,
                       nbytes_of(x, cond, up, w1, b1, w2, b2, y, *params),
                       2 * (conv_macs(w1, hb, wb, 1) + conv_macs(w2, hb, wb, 1))
                       + sft_flops(hb * wb, sft1) + sft_flops(hb * wb, sft2) + 8 * hb * wb * 128, unit)
            del x, cond, up, y, y_r, args

        # mix_chain: the CondNet2 tail, window [0, 256) of (270,480,768): 256 → 256 lrelu → 64, the
        # weights w_s2d_1x1 and biases b_s2d as the programs pass them with s2d=True (bf16: the row
        # tile of csrc/chain_sm90.cuh; fp32: the dense chain), then in bf16 the dense form once
        x = t(rng.rand(hb, wb, 768) - 0.3)
        steps = [(p11(64, 64), f32(b_s2d((rng.randn(256) * 0.1)[:64])), "lrelu"),
                 (p11(64, 16), f32(b_s2d((rng.randn(64) * 0.1)[:16])), None)]
        for s2d in (True, False) if dtype == "bf16" else (True,):
            def call(s2d=s2d):
                return fused_mix_chain(x, steps, cin=256, ch0=0, s2d=s2d)

            def call_plain(s2d=s2d):
                return fused_mix_chain_ref(x[..., :256], steps, s2d=s2d)

            y, y_r = call(), call_plain()
            ms, plain = time_ms(call, torch), time_ms(call_plain, torch)
            record("mix_chain", dtype, f"L1 CondNet2.2/.4 window ch0=0 s2d={s2d}", (0, 1, 1) if s2d else (0, 0, 0),
                   y, y_r, ATOL if dtype == "f32" else 1, ms, plain, None,
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
        # the biases as the s2d transforms have them (b_s2d: the first quarter tiled, w_in's per part)
        hargs = (*hargs[:2], hargs[2][:64].repeat(4), hargs[3], hargs[4][:64].repeat(4), hargs[5],
                 hargs[6][:3].repeat(4), w_in, torch.cat([hargs[8][:32].repeat(4), hargs[8][128:192].repeat(4)]))
        packed = agcm_head_pack(hargs[1], hargs[5], w_in)
        packed_s2d = agcm_head_pack_s2d(*hargs[1:6:2], w_in, hargs[8], n_first=128)

        def joined(outs):
            return torch.cat([o.reshape(-1) for o in outs])

        # the program's s2d form (bf16: the AGCM pass on the row tile, the input conv on its wgmma
        # tile over the slots), then in bf16 the dense form once (no path launches it)
        for s2d in (True, False) if dtype == "bf16" else (True,):
            def head(s2d=s2d):
                return fused_agcm_head(xs, *hargs, n_first=128, scale=1.0 / 255.0, packed=packed,
                                       packed_s2d=packed_s2d, s2d=s2d)

            def head_plain(s2d=s2d):
                return fused_agcm_head_ref(xs, *hargs, n_first=128, scale=1.0 / 255.0, s2d=s2d)

            y, y_r = head(), head_plain()
            if [tuple(o.shape) for o in y] != [(hb, wb, 128), (hb, wb, 256), (hb, wb, 12)]:
                raise AssertionError(f"agcm_head output shapes {[tuple(o.shape) for o in y]}")
            ms, plain = time_ms(head, torch), time_ms(head_plain, torch)
            if dtype == "bf16":
                log(json.dumps({"agcm_head_split": {"s2d": s2d, **launch_split(head, torch, HEAD_PARTS)}}))
            record("agcm_head", dtype, f"L0 u8 pair planes -> fea, c0, agcm s2d={s2d}", (0, 0, 1) if s2d else (0, 0, 0),
                   joined(y), joined(y_r), ATOL if dtype == "f32" else 2, ms, plain, None, nbytes_of(xs, *hargs, *y),
                   2 * npix * nnz(hargs[1], hargs[3], hargs[5]) + 2 * conv_macs(w_in, hb, wb, 1)
                   + 3 * npix * (256 + 256 + 12), unit)
        del xs, y, y_r

        # cond_chain: c0 (540,960,256) → 256 ×4 (lrelu) → 64; c and cond1 compared as one vector.
        # The program's s2d form (s2d=True: w_s2d_1x1 weights, b_s2d biases, the first quarter
        # of each drawn bias tiled; bf16: the Hopper row tile of csrc/chain_sm90.cuh), then in
        # bf16 the dense form once (s2d=False, the drawn biases as they are; no path launches it)
        c0 = t(rng.rand(hb, wb, 256) - 0.3)
        dense = [(p11(64, n), f32(rng.randn(4 * n) * 0.1)) for n in (64, 64, 64, 64, 16)]
        for s2d in (True, False) if dtype == "bf16" else (True,):
            weights = [(w, b[: b.shape[0] // 4].repeat(4)) for w, b in dense] if s2d else dense
            y, y_r = fused_cond_chain(c0, weights, s2d=s2d), fused_cond_chain_ref(c0, weights, s2d=s2d)
            if [tuple(o.shape) for o in y] != [(hb, wb, 256), (hb, wb, 64)]:
                raise AssertionError(f"cond_chain output shapes {[tuple(o.shape) for o in y]}")
            ms = time_ms(lambda: fused_cond_chain(c0, weights, s2d=s2d), torch)
            plain = time_ms(lambda: fused_cond_chain_ref(c0, weights, s2d=s2d), torch)
            record("cond_chain", dtype, f"L0 c0 -> c, cond1 s2d={s2d}", (0, 0, 1) if s2d else (0, 0, 0),
                   joined(y), joined(y_r), ATOL if dtype == "f32" else 1, ms, plain, None,
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
        params = [p for pair in sft for p in pair] + list(targs[4:])
        h_max = None
        if dtype == "bf16":
            # h as the tail computes it: relu(HR_conv2(sft(round(s + d2s(up)))))
            s_sum = (s_.float() + up.reshape(hb // 2, wb // 2, 2, 2, 128).permute(0, 2, 1, 3, 4)
                     .reshape(hb, wb, 128).float()).to(dt)
            h_plain = fused_sft_conv3_v2_ref(s_sum, cond, sft, w_hr, targs[5], relu=True)
            h_max = float(h_plain.float().abs().max())
            del s_sum
        # the program's s2d form (bf16: the SFT on the row tile, HR_conv2 on the Hopper conv tile
        # over the slot table, conv_last on its tile over w_last's populated slots), then in bf16
        # the dense form once (no path launches it)
        splits = {}
        for s2d in (True, False) if dtype == "bf16" else (True,):
            y = fused_tail(*targs, pack=True, up_coarse=up, s2d=s2d)
            y_r = fused_tail_ref(*targs, pack=True, up_coarse=up, s2d=s2d)
            codes = y_r.to(torch.int32)
            inside = float(((codes > 0) & (codes < 65535)).float().mean())
            if tuple(y.shape) != (hb, 2, wb, 6) or y.dtype != torch.uint16 or inside < 0.5:
                raise AssertionError(f"tail output {tuple(y.shape)} {y.dtype}, {inside:.2f} of the codes unclipped")
            ms = time_ms(lambda: fused_tail(*targs, pack=True, up_coarse=up, s2d=s2d), torch)
            plain = time_ms(lambda: fused_tail_ref(*targs, pack=True, up_coarse=up, s2d=s2d), torch)
            tol = 1
            if dtype == "bf16":
                step = 2.0 ** (int(np.floor(np.log2(h_max))) - 7)
                tol = int(2 * float(w_last.float().abs().max()) * step * 65535) + 1
                share = float((y.to(torch.int32) != codes).float().mean())
                log(f"tail bf16 s2d={s2d}: max|h| {h_max:.3f} (bf16 step {step}), max|w_last| "
                    f"{float(w_last.float().abs().max()):.4f}: bound {tol} codes; {share:.2e} of the codes differ")
                if share > TAIL_BF16_SHARE:
                    raise AssertionError(f"tail bf16 s2d={s2d}: {share:.3e} of the codes differ > {TAIL_BF16_SHARE}")
                splits[s2d] = launch_split(lambda: fused_tail(*targs, pack=True, up_coarse=up, s2d=s2d), torch,
                                           TAIL_PARTS)
                log(json.dumps({"tail_split": {"dtype": dtype, "s2d": s2d, **splits[s2d]}}))
            record("tail", dtype, f"L0 fea0 + up_coarse -> packed u16 s2d={s2d}",
                   {"bf16_mega": 1} if s2d else {}, y.to(torch.int32), codes, tol, ms, plain, None,
                   nbytes_of(s_, up, cond, skip, y, *params),
                   2 * (conv_macs(w_hr, hb, wb, 1) + conv_macs(w_last, hb, wb, 1)) + sft_flops(npix, sft)
                   + 4 * npix * 128 + 5 * npix * 12)
        if dtype == "bf16":
            # the HG composite's call: the same s2d form unpacked, y (540, 960, 12) in bf16; each y
            # within the codes' bound in value (a flipped bf16 step of h under one window, doubled)
            # plus one bf16 step of its own rounding, on at most TAIL_BF16_SHARE of the values
            y = fused_tail(*targs, pack=False, up_coarse=up, s2d=True)
            y_r = fused_tail_ref(*targs, pack=False, up_coarse=up, s2d=True)
            if tuple(y.shape) != (hb, wb, 12) or y.dtype != dt:
                raise AssertionError(f"tail unpacked output {tuple(y.shape)} {y.dtype}")
            ms = time_ms(lambda: fused_tail(*targs, pack=False, up_coarse=up, s2d=True), torch)
            plain = time_ms(lambda: fused_tail_ref(*targs, pack=False, up_coarse=up, s2d=True), torch)
            log(json.dumps({"tail_split": {"dtype": dtype, "s2d": True, "pack": False,
                                           **launch_split(lambda: fused_tail(*targs, pack=False, up_coarse=up,
                                                                             s2d=True), torch, TAIL_PARTS)}}))
            record("tail", dtype, "L0 fea0 + up_coarse -> y bf16 (HG) s2d=True", {"hg_bf16": 1}, y, y_r,
                   2 * float(w_last.float().abs().max()) * step, ms, plain, None,
                   nbytes_of(s_, up, cond, skip, y, *params),
                   2 * (conv_macs(w_hr, hb, wb, 1) + conv_macs(w_last, hb, wb, 1)) + sft_flops(npix, sft)
                   + 4 * npix * 128 + 3 * npix * 12, "flips", share=TAIL_BF16_SHARE)
            # conv_last alone at this shape (the third launch of the s2d and dense forms above, by
            # torch.profiler): its bound (h, skip and the packed output once; the populated slots'
            # products at the bf16 rate), the plain version's time on the plain h, and F.conv2d's
            # on its conv part alone (no single PyTorch call packs)
            w_s = _s2d_slots_only(w_last)
            b_last = targs[7]

            def last_plain():
                v = (_conv_same(h_plain.float(), w_s, b_last) + skip.float()).clamp(0.0, 1.0)
                return (v * 65535.0 + 0.5).to(torch.int32).to(torch.uint16)

            h_nchw = h_plain.permute(2, 0, 1)[None].contiguous()
            w_oihw = w_last.permute(3, 2, 0, 1).contiguous()
            lb_ms, lb_by = bound(nbytes_of(h_plain, skip, w_last, b_last) + 2 * npix * 12,
                                 2 * conv_macs(w_last, hb, wb, 1), "bf16")
            log(json.dumps({"conv_last": {
                "ms": splits[True]["conv_last_ms"], "dense_ms": splits[False]["conv_last_ms"],
                "plain_ms": round(time_ms(last_plain, torch), 4),
                "conv2d_ms": round(time_ms(lambda: F.conv2d(h_nchw, w_oihw, b_last.to(dt), padding=1), torch), 4),
                "bound_ms": round(lb_ms, 4), "bound_by": lb_by, "library": "none"}}))
            del h_plain, h_nchw, w_oihw
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
        # the parameter pack the frame programs build once at load (models/s2d.py params_to_torch)
        tpack = (trunk3_pack if dtype == "f32" else trunk3_pack_bf16)(blocks, w_up, b_up)

        def trunk():
            return fused_trunk3(fea3, cond4, blocks, w_up, b_up, packed=tpack)

        y = trunk()
        y_r = fused_trunk3_ref(fea3, cond4, blocks, w_up, b_up)
        ms = time_ms(trunk, torch)
        plain = time_ms(lambda: fused_trunk3_ref(fea3, cond4, blocks, w_up, b_up), torch)
        # the 8 SFT passes against the 9 convs (fp32: the 3×TF32 tile and the coalesced fp32 pass)
        log(json.dumps({"trunk3_split": {"dtype": dtype, **launch_split(trunk, torch, SFT_CONV_PARTS)}}))
        flops = 2 * sum(conv_macs(blk[i], hb, wb, 1) for blk in blocks for i in (1, 4))
        flops += 2 * conv_macs(w_up, hb, wb, 1)
        t3_sft_flops = 8 * hb * wb * 2 * 2 * (cc * cc + cc * cin)  # the SFT 1×1 pairs
        params = [p for blk in blocks for s in (blk[0], blk[3]) for pr in s for p in pr]
        params += [blk[i] for blk in blocks for i in (1, 2, 4, 5)] + [w_up, b_up]
        # fp32: the convs at the 3×TF32 rate, the SFT passes at the FMA rate (bound_fma_ms: all at the latter)
        record("trunk3", dtype, "trunk3 + up_conv1 (135x240)", (1, 1, 1), y, y_r, 5e-4 if dtype == "f32" else 2,
               ms, plain, None, nbytes_of(fea3, cond4, y, *params), flops + t3_sft_flops, unit,
               rate="tf32x3" if dtype == "f32" else None, fma_flops=t3_sft_flops if dtype == "f32" else 0.0)

        # pack: the (1080,1920,3) frame, values beyond [0,1] included
        v = (torch.rand(1080, 1920, 3, device=dev, generator=torch.Generator(dev).manual_seed(5)) * 1.4 - 0.2).to(dt)
        u = pack_rgb48(v)
        host = u.cpu().numpy()
        if host.dtype != np.uint16 or host.shape != (1080, 1920, 3):
            raise AssertionError(f"pack output {host.dtype} {host.shape}")
        # ms: the same input every call, which stays in the 50 MB L2; cold_ms: a ring of inputs
        # (200 MB or more) each call takes the next of, so that each is read from device memory,
        # as the bound counts it. Both by CUDA events, which the wrapper's host time can pace at
        # this size, and on the card (torch.profiler's device time of the kernel).
        ms = time_ms(lambda: pack_rgb48(v), torch)
        ring = [torch.rand_like(v, dtype=torch.float32).to(dt) for _ in range(max(4, 1 + int(200e6 // v.nbytes)))]
        turn = iter(range(1 << 62))

        def pack_cold():
            return pack_rgb48(ring[next(turn) % len(ring)])

        cold = time_ms(pack_cold, torch)
        on_card = {key: launch_split(fn, torch, (("ms", "pack_rgb48"),))["ms"]
                   for key, fn in (("card_ms", lambda: pack_rgb48(v)), ("card_cold_ms", pack_cold))}
        del ring
        plain = time_ms(lambda: pack_rgb48_ref(v), torch)
        record("pack_rgb48", dtype, f"(1080,1920,3) {dtype} -> u16", {"fp32": 1, "bf16_nomega": 1},
               u.to(torch.int32), pack_rgb48_ref(v).to(torch.int32), 0.0, ms, plain, None,
               v.numel() * (size + 2), v.numel() * 4, cold_ms=cold, extra=on_card)

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

        # ---- The native-int8 (W8A8) bodies, at the 1080p shapes of the int8 programs, each
        # also once with an asymmetric calibration (x_zero != 0: the pad code is not 0).
        # Weights quantized per output channel as the checkpoint's; activation scales
        # calibrated by abs-max (or min/max) on what each conv quantizes.
        def qlayer(ci, co, t_lo, t_hi, asym, ps=False):
            wq, ws = quantize_weight(rng.randn(3, 3, ci, co).astype(np.float32) * 0.05)
            if ps:
                tq, tsc = w_s2d_s1_ps(wq), np.tile(w_ps_permute(ws.reshape(1, 1, 1, -1))[0, 0, 0], 4)
            else:
                tq, tsc = w_s2d_s1(wq), b_s2d(ws)
            sc, z = ((t_hi - t_lo) / 255.0, t_lo) if asym else (max(abs(t_lo), abs(t_hi)) / 127.0, None)
            b = (rng.randn(tq.shape[-1]) * 0.1).astype(np.float32)
            return t(tq.astype(np.float32) * tsc), f32(b), pack_qargs(tq, tsc, sc, z, b, dev)

        def flip_tol(qa, flips):
            """What ``flips`` flipped codes under one output can move it by."""
            return flips * 127.0 * float(qa.yscale.max())

        def qbytes(*qas):
            return sum(q.w.numel() + 8 * q.co for q in qas)

        def t_range(x, cond, sft):
            tt = _sft_t(x.float(), cond.float(), sft, dt)
            return float(tt.min()), float(tt.max())

        # block_conv3_w8a8: (name, hb, wb, natural ci, co, PS-folded, relu, skip, asym,
        #                    launches per frame on the three int8 paths)
        for name, hb, wb, ci, co, ps, relu, skip, asym, per_path in (
            ("L0 HR_conv1/2", 540, 960, 32, 32, False, True, False, False, {"int8_fp32": 2}),
            ("L1 trunk1/5 conv1", 270, 480, 32, 32, False, True, False, False, {"int8_fp32": 2}),
            ("L1 trunk1/5 conv2 + skip", 270, 480, 32, 32, False, False, True, False, {"int8_fp32": 2}),
            ("L2 trunk2/4 conv1", 135, 240, 32, 32, False, True, False, False, {"int8_fp32": 2}),
            ("L2 trunk2/4 conv2 + skip", 135, 240, 32, 32, False, False, True, False, {"int8_fp32": 2}),
            ("L1 up_conv3", 270, 480, 32, 128, True, True, False, False,
             {"int8_fp32": 1, "int8_bf16_nomega": 1, "int8_bf16_mega": 1}),
            ("L2 up_conv2", 135, 240, 32, 128, True, True, False, False,
             {"int8_fp32": 1, "int8_bf16_nomega": 1, "int8_bf16_mega": 1}),
            ("L1 up_conv3, asymmetric", 270, 480, 32, 128, True, True, False, True, {}),
        ):
            if not asym and not runs(dtype, per_path):
                continue
            x = t(rng.rand(hb, wb, 4 * ci) * 1.2 - 0.1)
            w, b, qa = qlayer(ci, co, -0.1, 1.1, asym, ps)
            w = w.to(dt)
            sk = t(rng.rand(hb, wb, 4 * co)) if skip else None
            y_r = fused_block_conv3_q_ref(x, qa, relu=relu, skip=sk)
            plain = time_ms(lambda: fused_block_conv3_q_ref(x, qa, relu=relu, skip=sk), torch)
            # the same codes and exact sums: bit for bit, or one ulp of the epilogue
            tol = float(np.spacing(np.float32(max(1.0, float(y_r.float().abs().max()))))) if dtype == "f32" else 1
            # the programs' route, a_sub = 1 (the quantize pass, then the wgmma s8 tile over the slot
            # table; fp32 through its fp32-output epilogue), then in bf16 the dense form once
            for a_sub in (1, 0) if dtype == "bf16" and not asym else (1,):
                def call(a_sub=a_sub):
                    return fused_block_conv3(x, w, b, relu=relu, skip=sk, qargs=qa, a_sub=a_sub)

                y = call()
                ms = time_ms(call, torch)
                log(json.dumps({"block_conv3_w8a8_split": {"dtype": dtype, "case": name, "a_sub": a_sub,
                                                           **launch_split(call, torch, QCONV_PARTS)}}))
                record("block_conv3_w8a8", dtype, f"{name} a_sub={a_sub}", per_path if a_sub else {}, y, y_r, tol,
                       ms, plain, None, nbytes_of(x, y, sk) + qbytes(qa), 2 * conv_macs(w, hb, wb, 1),
                       "abs" if dtype == "f32" else "steps", rate="int8")
            del x, y, y_r, sk

        # sft_conv3_w8a8: x (hb,wb,128), cond (hb,wb,64); the bf16 int8 programs only. The
        # programs' s2d form (bf16: the SFT on the row tile in its int8-output mode, the conv
        # on the wgmma s8 tile over the slot table), then in bf16 the dense form once (no
        # path launches it)
        for name, hb, wb, relu, skip, asym, per_path in (
            ("L0 SFT_layer1/2 + HR_conv1/2", 540, 960, True, False, False,
             {"int8_bf16_nomega": 2, "int8_bf16_mega": 1}),
            ("L2 trunk2/4 sft1 + conv1", 135, 240, True, False, False, {"int8_bf16_nomega": 2, "int8_bf16_mega": 2}),
            ("L2 trunk2/4 sft2 + conv2 + skip", 135, 240, False, True, False,
             {"int8_bf16_nomega": 2, "int8_bf16_mega": 2}),
            ("L2 trunk2/4 sft1 + conv1, asymmetric", 135, 240, True, False, True, {}),
        ):
            x = t(rng.rand(hb, wb, 128) - 0.3)
            cond = t(rng.rand(hb, wb, 64) - 0.3)
            sft = sft4(16, 32)
            w, b, qa = qlayer(32, 32, *t_range(x, cond, sft), asym)
            w = w.to(dt)
            sk = t(rng.rand(hb, wb, 128)) if skip else None
            params = [p for pair in sft for p in pair]
            dense_once = dtype == "bf16" and name.startswith("L0")
            for s2d in (True, False) if dense_once else (True,):
                def call(s2d=s2d):
                    return fused_sft_conv3_v2(x, cond, sft, w, b, relu=relu, skip=sk, qargs=qa, s2d=s2d)

                def call_plain(s2d=s2d):
                    return fused_sft_conv3_v2_ref(x, cond, sft, w, b, relu=relu, skip=sk, qargs=qa, s2d=s2d)

                y, y_r = call(), call_plain()
                ms, plain = time_ms(call, torch), time_ms(call_plain, torch)
                if dtype == "bf16":
                    log(json.dumps({"sft_conv3_w8a8_split": {"case": name, "s2d": s2d,
                                                             **launch_split(call, torch, SFT_CONV_PARTS)}}))
                record("sft_conv3_w8a8", dtype, f"{name} s2d={s2d}", per_path if s2d else {}, y, y_r,
                       flip_tol(qa, 2), ms, plain, None, nbytes_of(x, cond, y, sk, *params) + qbytes(qa),
                       2 * conv_macs(w, hb, wb, 1) + sft_flops(hb * wb, sft) + 3 * hb * wb * 128,
                       "flips", share=INT8_SHARE["sft_conv3"], rate="int8")
            del x, cond, y, y_r, sk

        # resblock_w8a8 at L1: x (270,480,128), cond (270,480,64)
        hb, wb = 270, 480
        for name, coarse, asym, per_path in (
            ("L1 trunk1", False, False, {"int8_bf16_nomega": 1, "int8_bf16_mega": 1}),
            ("L1 trunk5 + up_coarse", True, False, {"int8_bf16_nomega": 1, "int8_bf16_mega": 1}),
            ("L1 trunk1, asymmetric", False, True, {}),
        ):
            x = t(rng.rand(hb, wb, 128) - 0.3)
            cond = t(rng.rand(hb, wb, 64) - 0.3)
            up = t(rng.rand(hb // 2, wb // 2, 512) - 0.3) if coarse else None
            sft1, sft2 = sft4(16, 32), sft4(16, 32)
            lo, hi = t_range(x if up is None else x + 0.7, cond, sft1)
            w1, b1, q1 = qlayer(32, 32, lo, hi, asym)
            w2, b2, q2 = qlayer(32, 32, -0.5, 2.0, asym)
            args = (x, cond, sft1, w1.to(dt), b1, sft2, w2.to(dt), b2)
            kw = {"up_coarse": up, "qargs1": q1, "qargs2": q2}
            params = [p for pair in (*sft1, *sft2) for p in pair]
            # the programs' s2d form (bf16: both SFT passes on the row tile in its int8-output
            # mode, SFT1 writing the rounded sum, SFT2 reading the fp32 h1; both convs on the wgmma
            # s8 tile, conv1 storing h1 in fp32), then in bf16 the dense form once
            for s2d in (True, False) if dtype == "bf16" and not asym else (True,):
                def call(s2d=s2d):
                    return fused_resblock(*args, **kw, s2d=s2d)

                def call_plain(s2d=s2d):
                    return fused_resblock_ref(*args, **kw, s2d=s2d)

                y, y_r = call(), call_plain()
                ms, plain = time_ms(call, torch), time_ms(call_plain, torch)
                if dtype == "bf16":
                    log(json.dumps({"resblock_w8a8_split": {"case": name, "s2d": s2d,
                                                            **launch_split(call, torch, SFT_CONV_PARTS)}}))
                record("resblock_w8a8", dtype, f"{name} s2d={s2d}", per_path if s2d else {}, y, y_r,
                       flip_tol(q2, 8), ms, plain, None, nbytes_of(x, cond, up, y, *params) + qbytes(q1, q2),
                       2 * (conv_macs(args[3], hb, wb, 1) + conv_macs(args[6], hb, wb, 1))
                       + sft_flops(hb * wb, sft1) + sft_flops(hb * wb, sft2) + 8 * hb * wb * 128,
                       "flips", share=INT8_SHARE["resblock"], rate="int8")
            del x, cond, up, y, y_r, args

        # tail_w8a8, packed coarse form at (540, 960), compared in u16 codes. The program's s2d
        # form (bf16: the SFT on the row tile in its int8-output mode, HR_conv2 on the wgmma s8
        # tile over the slot table), then in bf16 the dense form once (no path launches it)
        hb, wb = 540, 960
        npix = hb * wb
        for name, asym, per_path in (("L0 fea0 + up_coarse -> packed u16", False, {"int8_bf16_mega": 1}),
                                     ("L0 packed, asymmetric", True, {})):
            s_ = t(rng.rand(hb, wb, 128) - 0.3)
            up = t(rng.rand(hb // 2, wb // 2, 512) - 0.3)
            cond = t(rng.rand(hb, wb, 64) - 0.3)
            skip = t(rng.rand(hb, wb, 12) * 1.1 - 0.05)
            sft = sft4(16, 32)
            w_hr, b_hr, qa = qlayer(32, 32, *t_range(s_ + 0.4, cond, sft), asym)
            w_last = t(w_s2d_s1(rng.randn(3, 3, 32, 3).astype(np.float32) * 0.03))
            targs = (s_, cond, skip, sft, w_hr.to(dt), b_hr, w_last, f32(rng.randn(12) * 0.02))
            # a flipped code of t moves h by one flip's worth, and in bf16 its rounding by a step;
            # conv_last carries each moved h into the codes by |w_last|·Δh·65535, doubled for
            # two under one window
            sf = (s_.float() + up.reshape(hb // 2, wb // 2, 2, 2, 128).permute(0, 2, 1, 3, 4)
                  .reshape(hb, wb, 128).float()).to(dt).float()
            h_max = float(_sft_conv_t(sf, cond.float(), sft, targs[4], b_hr, qa, dt).clamp_min(0).max())
            step = 2.0 ** (int(np.floor(np.log2(h_max))) - 7) if dtype == "bf16" else 0.0
            tol = int(2 * float(w_last.float().abs().max()) * (flip_tol(qa, 1) + step) * 65535) + 1
            del sf
            params = [p for pair in sft for p in pair] + [w_last, targs[7]]
            for s2d in (True, False) if dtype == "bf16" and not asym else (True,):
                def call(s2d=s2d):
                    return fused_tail(*targs, pack=True, up_coarse=up, qargs_hr=qa, s2d=s2d)

                def call_plain(s2d=s2d):
                    return fused_tail_ref(*targs, pack=True, up_coarse=up, qargs_hr=qa, s2d=s2d)

                y, y_r = call(), call_plain()
                codes = y_r.to(torch.int32)
                inside = float(((codes > 0) & (codes < 65535)).float().mean())
                if tuple(y.shape) != (hb, 2, wb, 6) or y.dtype != torch.uint16 or inside < 0.5:
                    raise AssertionError(f"tail_w8a8 output {tuple(y.shape)} {y.dtype}, {inside:.2f} unclipped")
                ms, plain = time_ms(call, torch), time_ms(call_plain, torch)
                if dtype == "bf16":
                    log(json.dumps({"tail_w8a8_split": {"case": name, "s2d": s2d,
                                                        **launch_split(call, torch, TAIL_PARTS)}}))
                record("tail_w8a8", dtype, f"{name} s2d={s2d}", per_path if s2d else {}, y.to(torch.int32), codes,
                       tol, ms, plain, None, nbytes_of(s_, up, cond, skip, y, *params) + qbytes(qa),
                       2 * (conv_macs(targs[4], hb, wb, 1) + conv_macs(w_last, hb, wb, 1)) + sft_flops(npix, sft)
                       + 4 * npix * 128 + 5 * npix * 12, share=INT8_SHARE["tail"], rate="int8")
            del s_, up, cond, skip, y, y_r, codes, targs

        # down2_w8a8: the int8 body of down2 at the 1080p shapes of the HDRTV_INT8_DOWN2=1
        # path: (name, hb, wb, cf, cin, ch0, natural co per branch, branches, asym, per path).
        # Both sides quantize the same window with the same arithmetic and sum exact int32
        # products: bit for bit, or one ulp of the epilogue (fp32), one step (bf16).
        for name, hb, wb, cf, cin, ch0, co_nat, nbr, asym, per_path in (
            ("LE.__cond_down (3 branches)", 540, 960, 256, None, 0, 64, 3, False, {"int8_down2_bf16_mega": 1}),
            ("CondNet3.2/4.2 window ch0=256", 270, 480, 768, 256, 256, 64, 1, False, {"int8_down2_bf16_mega": 2}),
            ("LE.__cond_down (3 branches), asymmetric", 540, 960, 256, None, 0, 64, 3, True, {}),
            ("CondNet3.2 window, asymmetric", 270, 480, 768, 256, 256, 64, 1, True, {}),
        ):
            c = cin or cf
            x = t(rng.rand(hb, wb, cf) * 1.3 - 0.2)
            xw = x[..., ch0 : ch0 + c].float()
            lo, hi = float(xw.min()), float(xw.max())
            tqs, tscs, cal = [], [], []
            for bi in range(nbr):
                wq, ws = quantize_weight(rng.randn(3, 3, c // 4, co_nat).astype(np.float32) * 0.05)
                tqs.append(w_s2d_s2(wq))
                tscs.append(b_s2d(ws))
                lo_b, hi_b = lo - 0.05 * bi, hi + 0.1 * bi
                cal.append(((hi_b - lo_b) / 255.0, lo_b) if asym else (max(abs(lo_b), abs(hi_b)) / 127.0, None))
            tq, tsc = np.concatenate(tqs, axis=-1), np.concatenate(tscs)
            cout = tq.shape[-1]
            bnp = (rng.randn(cout) * 0.1).astype(np.float32)
            if nbr > 1:
                qa = pack_qargs_branches(tq, tsc, [sc for sc, _ in cal], [z for _, z in cal] if asym else None,
                                         bnp, dev)
            else:
                qa = pack_qargs(tq, tsc, cal[0][0], cal[0][1], bnp, dev)
            w, b = t(tq.astype(np.float32) * tsc), f32(bnp)
            a_sub = 3 if nbr > 1 else 1
            y_r = fused_down2_q_ref(x[..., ch0 : ch0 + c], qa, act="lrelu")
            plain = time_ms(lambda: fused_down2_q_ref(x[..., ch0 : ch0 + c], qa, act="lrelu"), torch)
            tol = float(np.spacing(np.float32(max(1.0, float(y_r.float().abs().max()))))) if dtype == "f32" else 1
            qas = qa if isinstance(qa, tuple) else (qa,)
            # the programs' a_sub (bf16: the one quantize pass, then the wgmma s8 tile at stride 2;
            # fp32 keeps the dense tile), then in bf16 the dense route (a_sub = 0, one branch) once
            for a_sub_ in (a_sub, 0) if dtype == "bf16" and not asym and nbr == 1 else (a_sub,):
                kw = {"act": "lrelu", "cin": cin, "ch0": ch0, "qargs": qa, "a_sub": a_sub_}

                def call(kw=kw):
                    return fused_down2(x, w, b, **kw)

                y = call()
                ms = time_ms(call, torch)
                if dtype == "bf16" and a_sub_:
                    # beside the two launches, the bf16 float form of the same call (HDRTV_INT8_DOWN2=0)
                    fkw = {"act": "lrelu", "cin": cin, "ch0": ch0, "a_sub": a_sub}
                    float_ms = time_ms(lambda: fused_down2(x, w, b, **fkw), torch)
                    log(json.dumps({"down2_w8a8_split": {
                        "case": name, "a_sub": a_sub_, "ms": round(ms, 4), **launch_split(call, torch, QCONV_PARTS),
                        "float_ms": round(float_ms, 4)}}))
                record("down2_w8a8", dtype, f"{name} a_sub={a_sub_}", per_path if a_sub_ else {}, y, y_r, tol, ms,
                       plain, None, size * hb * wb * c + nbytes_of(y) + qbytes(*qas),
                       2 * conv_macs(w, hb // 2, wb // 2, 2), "abs" if dtype == "f32" else "steps", rate="int8")
            del x, xw, y, y_r, w

        # block_conv3 pool_out at the L1 up_conv3 shape (270, 480, 128) -> 512 (PS-folded): the
        # 2x2 max pool in the epilogue, (135, 240, 512) out; float (as block_conv3) and int8
        # (the same codes and sums as the plain version: one ulp or one step). up_conv2's L2
        # level has 135 rows at 1080p, which pool_out does not take.
        hb, wb = 270, 480
        w_nat = rng.randn(3, 3, 32, 128).astype(np.float32) * 0.05
        w = t(w_s2d_s1_ps(w_nat))
        x = t(rng.rand(hb, wb, 128) * 1.2 - 0.1)
        b = f32(rng.randn(512) * 0.1)
        y = fused_block_conv3(x, w, b, relu=True, pool_out=True)
        y_r = fused_block_conv3_ref(x, w, b, relu=True, pool_out=True)
        if tuple(y.shape) != (hb // 2, wb // 2, 512):
            raise AssertionError(f"block_conv3 pool_out output {tuple(y.shape)}")
        ms = time_ms(lambda: fused_block_conv3(x, w, b, relu=True, pool_out=True), torch)
        plain = time_ms(lambda: fused_block_conv3_ref(x, w, b, relu=True, pool_out=True), torch)
        x_nchw = x[None].permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b_lib = b.to(dt)
        lib = time_ms(lambda: F.max_pool2d(F.relu(F.conv2d(x_nchw, w_oihw, b_lib, padding=1)), 2), torch)
        record("block_conv3_pool", dtype, "L1 up_conv3 shape + 2x2 max pool", {f"forms_{dtype}": 1}, y, y_r,
               ATOL if dtype == "f32" else 1, ms, plain, lib, nbytes_of(x, w, b, y), 2 * conv_macs(w, hb, wb, 1),
               unit)
        wq, ws = quantize_weight(w_nat)
        tq, tsc = w_s2d_s1_ps(wq), np.tile(w_ps_permute(ws.reshape(1, 1, 1, -1))[0, 0, 0], 4)
        qa = pack_qargs(tq, tsc, 1.1 / 127.0, None, (rng.randn(512) * 0.1).astype(np.float32), dev)
        wq_f = t(tq.astype(np.float32) * tsc)
        y = fused_block_conv3(x, wq_f, b, relu=True, qargs=qa, pool_out=True)
        y_r = fused_block_conv3_q_ref(x, qa, relu=True, pool_out=True)
        ms = time_ms(lambda: fused_block_conv3(x, wq_f, b, relu=True, qargs=qa, pool_out=True), torch)
        plain = time_ms(lambda: fused_block_conv3_q_ref(x, qa, relu=True, pool_out=True), torch)
        tol = float(np.spacing(np.float32(max(1.0, float(y_r.float().abs().max()))))) if dtype == "f32" else 1
        record("block_conv3_pool_w8a8", dtype, "L1 up_conv3 shape + 2x2 max pool, int8", {f"forms_{dtype}": 1},
               y, y_r, tol, ms, plain, None, nbytes_of(x, y) + qbytes(qa), 2 * conv_macs(wq_f, hb, wb, 1),
               "abs" if dtype == "f32" else "steps", rate="int8")
        del x, y, y_r, w, wq_f, x_nchw, w_oihw

        # cond_chain_w8a8: c0 (540, 960, 256) -> 256 x4 -> 64, steps 0 and 4 int8 symmetric,
        # step 2 int8 with a zero point, each calibrated on the float chain's value there.
        hb, wb = 540, 960
        c0 = t(rng.rand(hb, wb, 256) - 0.3)
        nat = [quantize_weight(rng.randn(1, 1, 64, n).astype(np.float32) * 0.15) for n in (64, 64, 64, 64, 16)]
        tqs = [w_s2d_1x1(q) for q, _ in nat]
        tscs = [b_s2d(sc) for _, sc in nat]
        bnps = [(rng.randn(q.shape[-1]) * 0.1).astype(np.float32) for q in tqs]
        weights = [(t(q[0, 0].astype(np.float32) * sc), f32(bb)) for q, sc, bb in zip(tqs, tscs, bnps)]
        v, ranges = c0.float(), []
        for i, (w_, b_) in enumerate(weights):
            ranges.append((float(v.min()), float(v.max())))
            v = v @ w_.float() + b_
            v = torch.where(v >= 0, v, v * 0.1) if i != 4 else v
        del v
        qargs = []
        for i, flag in enumerate((1, 0, 2, 0, 1)):
            lo, hi = ranges[i]
            sc, z = ((hi - lo) / 255.0, lo) if flag == 2 else (max(abs(lo), abs(hi)) / 127.0, None)
            qargs.append(pack_qargs(tqs[i], tscs[i], sc, z, bnps[i], dev) if flag else None)
        y = fused_cond_chain(c0, weights, qargs=qargs)
        y_r = fused_cond_chain_ref(c0, weights, qargs)
        ms = time_ms(lambda: fused_cond_chain(c0, weights, qargs=qargs), torch)
        plain = time_ms(lambda: fused_cond_chain_ref(c0, weights, qargs), torch)
        npix = hb * wb
        flops = 2 * npix * nnz(*[w_ for w_, _ in weights])
        record("cond_chain_w8a8", dtype, "L0 c0 -> c, cond1, steps 0/2/4 int8", {f"forms_{dtype}": 1},
               joined(y), joined(y_r), flip_tol(qargs[4], 4), ms, plain, None,
               nbytes_of(c0, *y) + sum(nbytes_of(w_, b_) for (w_, b_), q in zip(weights, qargs) if q is None)
               + qbytes(*[q for q in qargs if q is not None]), flops, "flips", share=COND_CHAIN_INT8_SHARE,
               rate="int8")
        del c0, y, y_r, weights

    # The two layout probes, bf16 only (as the Pallas probes). d2s_add at the probe's own
    # shape (logged, not counted) and at the 1080p shape where the tail un-folds up_coarse
    # (the drive of phase 7): one rounding, so bit for bit. rowmajor_head raw and pre at
    # 1080p: within one bf16 step of the plain version (another fp32 sum order of the same
    # exact products), and raw equal to pre bit for bit (one body, the same bytes). Beside
    # the plain version, the torch-op sequence of the port's probe tools (the probes' XLA
    # form: permute copy + bf16 add; regroup + cast + bf16 matmul); no single PyTorch call
    # computes either, so library_ms is null.
    from hdrtv_tpu_torch.ops.probe_kernels import (
        d2s_add, d2s_add_ref, rowmajor_head_pre, rowmajor_head_raw, rowmajor_head_raw_ref,
    )
    from hdrtv_tpu_torch.tools import proto_d2s_kernel, proto_rowmajor_head

    rng = np.random.RandomState(77)
    bf = torch.bfloat16
    for case, per_path in (("d2s_probe", {}), ("d2s_1080p", {PROBE_PATH: 1})):
        hbc, wbc, c = PROBE_SHAPES[case]
        coarse = torch.as_tensor(rng.randn(hbc, wbc, 4 * c).astype(np.float32), device=dev).to(bf)
        fine = torch.as_tensor(rng.randn(2 * hbc, 2 * wbc, c).astype(np.float32), device=dev).to(bf)
        y, y_r = d2s_add(coarse, fine), d2s_add_ref(coarse, fine)
        torch.cuda.synchronize()
        if not torch.equal(y, y_r):
            raise AssertionError(f"d2s_add {case}: differs from its plain version")
        ms = time_ms(lambda: d2s_add(coarse, fine), torch)
        plain = time_ms(lambda: d2s_add_ref(coarse, fine), torch)
        seq = time_ms(lambda: proto_d2s_kernel.torch_sequence(coarse, fine), torch)
        log(f"d2s_add {case}: torch permute copy + add {seq:.4f} ms")
        record("d2s_add", "bf16", f"{case} coarse {tuple(coarse.shape)}", per_path, y, y_r, 0.0, ms, plain, None,
               2 * (coarse.numel() + fine.numel() + y.numel()), 0.0)
        if per_path:
            totals[("d2s_add", "bf16", PROBE_PATH)]["torch_seq_ms"] = seq
        del coarse, fine, y, y_r
    h, w, co = PROBE_SHAPES["head"]
    frame = torch.as_tensor(rng.randint(0, 256, (h, 3 * w), dtype=np.uint8), device=dev)
    pairs = frame.view(h // 2, 2, w // 2, 6)
    wm = torch.as_tensor(rng.randn(12, co).astype(np.float32) * 0.1, device=dev).to(bf)
    y_r = rowmajor_head_raw_ref(frame, wm)
    seq = time_ms(lambda: proto_rowmajor_head.torch_sequence(frame, wm), torch)
    plain = time_ms(lambda: rowmajor_head_raw_ref(frame, wm), torch)
    log(f"rowmajor_head 1080p: torch regroup + cast + bf16 matmul {seq:.4f} ms")
    outs = {}
    for form, fn, x in (("raw", rowmajor_head_raw, frame), ("pre", rowmajor_head_pre, pairs)):
        outs[form] = fn(x, wm)
        ms = time_ms(lambda: fn(x, wm), torch)
        record(f"rowmajor_head_{form}", "bf16", f"1080p {tuple(x.shape)} u8 -> {co}", {PROBE_PATH: 1},
               outs[form], y_r, 1, ms, plain, None, x.numel() + 2 * wm.numel() + 2 * outs[form].numel(),
               2.0 * 12 * co * (h // 2) * (w // 2), "steps")
        totals[(f"rowmajor_head_{form}", "bf16", PROBE_PATH)]["torch_seq_ms"] = seq
    if not torch.equal(outs["raw"], outs["pre"]):
        raise AssertionError("rowmajor_head: raw and pre differ")
    del frame, pairs, outs, y_r
    return totals


def phase_end_to_end(torch, np, hg_weights: dict) -> None:
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    frame = (np.random.RandomState(360).rand(360, 640, 3) * 255).astype(np.uint8)
    bounds = {"fp32": (4, None), "bf16_nomega": (1536, 34.0), "bf16_mega": (1536, 34.0), **INT8_E2E_CODES,
              "int8_down2_bf16_mega": INT8_DOWN2_E2E_CODES}
    floors = {**INT8_E2E_PSNR, "int8_down2_bf16_mega": INT8_DOWN2_E2E_PSNR}
    for path, spec in PATHS.items():
        if spec["hg"]:
            continue
        max_codes, mean_codes = bounds[path]
        weights = path_weights(spec, hg_weights)
        set_path_env(spec)
        log(f"phase 3: end to end, card against CPU (360x640 {path})")
        t0 = time.perf_counter()
        gpu = eager_rgb48(HDRTVNetTorch(weights, precision=spec["precision"]), frame)
        t1 = time.perf_counter()
        cpu = HDRTVNetTorch(weights, precision=spec["precision"], device="cpu").process_rgb48(frame)
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
        if spec.get("int8"):
            # The int8 frame against the CPU, and the CPU's own int8 frame against its float
            # program on the same pre-dequantized weights: the floor must separate the two.
            os.environ["HDRTVNET_NATIVE_INT8"] = "0"
            try:
                flt = HDRTVNetTorch(weights, precision=spec["precision"], device="cpu").process_rgb48(frame)
            finally:
                del os.environ["HDRTVNET_NATIVE_INT8"]
            p_card = psnr(float(np.mean((d / 65535.0) ** 2)))
            p_float = psnr(float(np.mean(((cpu.astype(np.int64) - flt) / 65535.0) ** 2)))
            log(f"{path}: PSNR card against CPU {p_card:.2f} dB (floor {floors[path]}); "
                f"CPU int8 against CPU float {p_float:.2f} dB")
            if p_card < floors[path] or floors[path] <= p_float:
                raise AssertionError(f"{path}: PSNR card against CPU {p_card:.2f} dB, int8 against float "
                                     f"{p_float:.2f} dB, floor {floors[path]}")

    # One HG frame, card against CPU, with the pixels at the mask's threshold counted apart.
    h, w = HG_E2E_SIZE
    frame = smooth_frame(np, h, w, 184)
    for path, spec in PATHS.items():
        if not spec["hg"]:
            continue
        set_path_env(spec)
        weights = path_weights(spec, hg_weights)
        log(f"phase 3: end to end with HG, card against CPU ({h}x{w} {path}, hg_nf 64)")
        t0 = time.perf_counter()
        gpu = eager_rgb48(HDRTVNetTorch(weights, precision=spec["precision"]), frame)
        t1 = time.perf_counter()
        cpu = HDRTVNetTorch(weights, precision=spec["precision"], device="cpu").process_rgb48(frame)
        t2 = time.perf_counter()
        base_weights = INT8_WEIGHTS if spec.get("int8") else WEIGHTS
        base = HDRTVNetTorch(base_weights, precision=spec["precision"], device="cpu").process_rgb48(frame)
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
        if spec.get("int8"):
            # int8: a PSNR floor away from the threshold (one flipped code moves every int8
            # layer after it), above the CPU's int8 composite against its float one
            diff = (gpu.astype(np.int64) - cpu.astype(np.int64))[~near]
            p_card = psnr(float(np.mean((diff / 65535.0) ** 2)))
            os.environ["HDRTVNET_NATIVE_INT8"] = "0"
            try:
                flt = HDRTVNetTorch(weights, precision=spec["precision"], device="cpu").process_rgb48(frame)
            finally:
                del os.environ["HDRTVNET_NATIVE_INT8"]
            p_float = psnr(float(np.mean(((cpu.astype(np.int64) - flt)[~near] / 65535.0) ** 2)))
            log(f"{path}: PSNR card against CPU away from the threshold {p_card:.2f} dB (floor "
                f"{INT8_HG_E2E_PSNR}); CPU int8 against CPU float {p_float:.2f} dB")
            if p_card < INT8_HG_E2E_PSNR or INT8_HG_E2E_PSNR <= p_float:
                raise AssertionError(f"{path}: PSNR card against CPU {p_card:.2f} dB, int8 against float "
                                     f"{p_float:.2f} dB, floor {INT8_HG_E2E_PSNR}")
            continue
        max_codes, mean_codes = (4, None) if spec["dtype"] == "f32" else HG_BF16_CODES
        if away.max() > max_codes or (mean_codes is not None and away.mean() > mean_codes):
            raise AssertionError(f"{path}: card and CPU differ away from the threshold by max {int(away.max())} > "
                                 f"{max_codes} codes or mean {float(away.mean()):.3f} > {mean_codes}")


def phase_natural_end_to_end(torch, np, hg_weights: dict) -> None:
    """The natural-layout program, card against CPU: the 540p preset in fp32
    and bf16, turbo off at 360 × 640, the eager W8A8 program, the natural HG
    composite."""
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    set_path_env({"mega": "1"})

    def both(weights, precision, frame, label, **kw):
        h, w, _ = frame.shape
        t0 = time.perf_counter()
        gproc = HDRTVNetTorch(weights, precision=precision, **kw)
        gpu = eager_rgb48(gproc, frame)
        t1 = time.perf_counter()
        cproc = HDRTVNetTorch(weights, precision=precision, device="cpu", **kw)
        cpu = cproc.process_rgb48(frame)
        t2 = time.perf_counter()
        if not (gproc.natural(h, w) and cproc.natural(h, w)) or gpu.shape != (h, w, 3) or gpu.dtype != np.uint16:
            raise AssertionError(f"{label}: not the natural program, or output {gpu.shape} {gpu.dtype}")
        d = np.abs(gpu.astype(np.int64) - cpu.astype(np.int64))
        log(f"{label}: card range [{gpu.min()}, {gpu.max()}] ({t1 - t0:.2f} s incl. load); cpu {t2 - t1:.2f} s; "
            f"max |card - cpu| = {int(d.max())} codes, mean {float(d.mean()):.3f}, "
            f"{float((d > 0).mean()):.2e} of values differ")
        return gpu, cpu, d

    h, w = NAT_SIZE
    frame = (np.random.RandomState(540).rand(h, w, 3) * 255).astype(np.uint8)
    for precision, (max_codes, mean_codes) in (("fp32", (4, None)), ("fp16", NAT_BF16_CODES)):
        log(f"phase 3: natural program, card against CPU ({h}x{w}, the 540p preset, {precision})")
        _, _, d = both(WEIGHTS, precision, frame, f"natural {h}x{w} {precision}")
        if d.max() > max_codes or (mean_codes is not None and d.mean() > mean_codes):
            raise AssertionError(f"natural {precision}: max {int(d.max())} > {max_codes} or mean "
                                 f"{float(d.mean()):.3f} > {mean_codes}")

    log("phase 3: turbo off, card against CPU (360x640 bf16: the natural program at an s2d size)")
    frame = (np.random.RandomState(360).rand(360, 640, 3) * 255).astype(np.uint8)
    _, _, d = both(WEIGHTS, "fp16", frame, "turbo off 360x640 bf16", turbo=False)
    if d.max() > TURBO_OFF_CODES[0] or d.mean() > TURBO_OFF_CODES[1]:
        raise AssertionError(f"turbo off: max {int(d.max())} or mean {float(d.mean()):.3f} beyond {TURBO_OFF_CODES}")

    h, w = EAGER_E2E_SIZE
    log(f"phase 3: eager W8A8 (predequantize off), card against CPU ({h}x{w} bf16)")
    frame = smooth_frame(np, h, w, 181)
    gpu, cpu, _ = both(INT8_WEIGHTS, "fp16", frame, f"eager W8A8 {h}x{w} bf16", predequantize=False)
    flt = HDRTVNetTorch(INT8_WEIGHTS, precision="fp16", device="cpu").process_rgb48(frame)
    p_card = psnr(float(np.mean(((gpu.astype(np.int64) - cpu) / 65535.0) ** 2)))
    p_float = psnr(float(np.mean(((cpu.astype(np.int64) - flt) / 65535.0) ** 2)))
    log(f"eager W8A8: PSNR card against CPU {p_card:.2f} dB (floor {EAGER_E2E_PSNR}); CPU int8 against CPU "
        f"float (pre-dequantized) {p_float:.2f} dB")
    if p_card < EAGER_E2E_PSNR or EAGER_E2E_PSNR <= p_float:
        raise AssertionError(f"eager W8A8: PSNR card against CPU {p_card:.2f}, int8 against float {p_float:.2f}")

    h, w = HG_NAT_SIZE
    frame = smooth_frame(np, h, w, 182)
    for precision in ("fp32", "fp16"):
        log(f"phase 3: natural HG composite, card against CPU ({h}x{w} {precision}, hg_nf 64)")
        gpu, cpu, _ = both(hg_weights["float"], precision, frame, f"natural HG {h}x{w} {precision}")
        base = HDRTVNetTorch(WEIGHTS, precision=precision, device="cpu").process_rgb48(frame)
        m = base.astype(np.float32).max(axis=-1) / 65535.0
        near = np.abs(m - 0.775) <= (2e-4 if precision == "fp32" else 0.02)
        away = np.abs(gpu.astype(np.int64) - cpu.astype(np.int64)).max(axis=-1)[~near]
        changed = float((np.abs(gpu.astype(np.int64) - base) > HG_CHANGED_CODES).any(axis=-1).mean())
        log(f"natural HG {precision}: {float(near.mean()):.4f} of the pixels near the threshold; away from it max "
            f"{int(away.max())} codes, mean {float(away.mean()):.3f}; the HG changed {changed:.3f} of the pixels")
        max_codes, mean_codes = (4, None) if precision == "fp32" else HG_BF16_CODES
        if near.mean() > HG_NEAR_SHARE or changed < 0.05 or away.max() > max_codes or (
                mean_codes is not None and away.mean() > mean_codes):
            raise AssertionError(f"natural HG {precision}: near {float(near.mean()):.3f}, changed {changed:.3f}, "
                                 f"away max {int(away.max())} mean {float(away.mean()):.3f}")


def phase_natural_540p(torch, np, native, path: str, smi: str, graphs: dict) -> dict:
    """The natural-layout program at the 540p preset on the card: one frame
    with the launch counts set to 0 before and read after (pack_rgb48 once,
    nothing else), then device-resident frames with one sync."""
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    spec = NAT_PATHS[path]
    set_path_env({"mega": "1"})
    h, w = NAT_SIZE
    log(f"phase 4: 540p natural program {path} frames on the card")
    weights = INT8_WEIGHTS if spec["weights"] == "int8" else WEIGHTS
    proc = HDRTVNetTorch(weights, precision=spec["precision"], **spec["kw"])
    frame = smooth_frame(np, h, w, 540)
    x = proc.put_frame(frame.reshape(h, w * 3))
    if not proc.natural(h, w) or x.shape != (h, 3 * w):
        raise AssertionError(f"{path}: natural {proc.natural(h, w)}, frame shipped as {tuple(x.shape)}")
    proc._rgb48_eager(x)  # warm
    torch.cuda.synchronize()
    expected = {k: int(k == "pack_rgb48") for k in KERNEL_INFO}
    native.reset_launch_counts()
    out = proc._rgb48_eager(x)
    torch.cuda.synchronize()
    counts = read_counts(native)
    log(f"launches for one frame: { {k: v for k, v in counts.items() if v} }")
    if counts != expected:
        raise AssertionError(f"{path}: launch counts {counts} != {expected}")
    o = out.to(torch.int32)
    lo, hi = int(o.min()), int(o.max())
    if out.shape != (h, 3 * w) or out.dtype != torch.uint16 or lo == hi:
        raise AssertionError(f"{path}: output {tuple(out.shape)} {out.dtype} range [{lo}, {hi}]")
    extra = ""
    if spec["weights"] == "int8":
        # the eager int8 frame against the float program on the same (pre-dequantized) weights
        fl = HDRTVNetTorch(weights, precision=spec["precision"])
        flo = fl._rgb48_eager(fl.put_frame(frame.reshape(h, w * 3))).to(torch.int32)
        p_float = psnr(float(((o - flo).double() / 65535.0).pow(2).mean()))
        if bool((o == flo).all()):
            raise AssertionError(f"{path}: the int8 frame equals the float one")
        extra = f"; PSNR against float {p_float:.2f} dB"
        del fl, flo
    n = spec["frames"]
    native.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        out = proc._rgb48_eager(x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    peak = torch.cuda.max_memory_allocated()
    if read_counts(native) != {k: n * v for k, v in expected.items()}:
        raise AssertionError(f"{path}: launch counts over {n} frames: {native.launch_counts}")
    log(f"540p {path}: {ms:.2f} ms/frame, {1e3 / ms:.2f} fps over {n} device-resident frames (one sync); "
        f"peak allocated {peak / 2**30:.2f} GiB; output range [{lo}, {hi}]{extra}")
    graphs[path] = phase_graph(torch, native, smi, proc, x, out, expected, f"540p {path}", n,
                               (4, None) if spec["precision"] == "fp32" else NAT_BF16_CODES)
    del proc, x, out
    torch.cuda.empty_cache()
    return counts


def phase_1080p(torch, np, native, path: str, hg_weights: dict, smi: str, graphs: dict) -> dict:
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    spec = PATHS[path]
    expected, n = expected_launches(path), spec["frames"]
    set_path_env(spec)
    log(f"phase 4: 1080p {path} frames on the card (HDRTV_MEGAKERNEL={spec['mega']}, "
        f"HDRTV_INT8_DOWN2={spec.get('down2', '0')}" + (", HG composite, hg_nf 64)" if spec["hg"] else ")"))
    int8 = spec.get("int8", False)
    weights = path_weights(spec, hg_weights)
    proc = HDRTVNetTorch(weights, precision=spec["precision"])
    h, w = 1080, 1920
    if spec["hg"] or int8:
        frame = smooth_frame(np, h, w, 1080)
    else:
        frame = (np.random.RandomState(1080).rand(h, w, 3) * 255).astype(np.uint8)
    x = proc.put_frame(frame.reshape(h, w * 3))
    if proc.cfg.use_hg != spec["hg"] or (x.ndim == 2) != spec["hg"] or proc.native_int8 != int8:
        raise AssertionError(f"{path}: use_hg {proc.cfg.use_hg}, native_int8 {proc.native_int8}, "
                             f"frame shipped as {tuple(x.shape)}")
    proc._rgb48_eager(x)  # warm
    torch.cuda.synchronize()

    native.reset_launch_counts()
    out = proc._rgb48_eager(x)
    torch.cuda.synchronize()
    counts = read_counts(native)
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
        base_proc = HDRTVNetTorch(INT8_WEIGHTS if int8 else WEIGHTS, precision=spec["precision"])
        base = base_proc._rgb48_eager(base_proc.put_frame(frame.reshape(h, w * 3))).reshape(h, w, 3)
        hg = o.reshape(h, w, 3)
        changed = ((hg - base.to(torch.int32)).abs() > HG_CHANGED_CODES).any(dim=-1)
        share = float(changed.float().mean())
        inside = float(((hg[changed] > 0) & (hg[changed] < 65535)).float().mean()) if share else 0.0
        log(f"HG changed {share:.3f} of the pixels; {inside:.3f} of their values lie inside (0, 65535)")
        if not 0.02 < share < 0.98 or inside < 0.5:
            raise AssertionError(f"{path}: the HG changed {share:.3f} of the pixels, {inside:.3f} unclipped")
        del base_proc, base, hg, changed
    p_float = None
    if int8 and path in INT8_PSNR_CPU:
        # The int8 frame against the float program on the same pre-dequantized weights: it
        # must differ (the activations were quantized) by no more than the CPU's PSNR allows.
        os.environ["HDRTVNET_NATIVE_INT8"] = "0"
        try:
            fproc = HDRTVNetTorch(weights, precision=spec["precision"])
        finally:
            del os.environ["HDRTVNET_NATIVE_INT8"]
        if fproc.native_int8:
            raise AssertionError(f"{path}: HDRTVNET_NATIVE_INT8=0 left the int8 forms on")
        fl = fproc._rgb48_eager(fproc.put_frame(frame.reshape(h, w * 3))).to(torch.int32)
        p_float = psnr(float(((o - fl).double() / 65535.0).pow(2).mean()))
        differ = float((o != fl).float().mean())
        log(f"{path}: int8 against float (pre-dequantized) on the smooth frame: PSNR {p_float:.2f} dB "
            f"(CPU at 120x256: {INT8_PSNR_CPU[path]}), {differ:.3f} of the values differ")
        if differ == 0.0 or p_float < INT8_PSNR_CPU[path] - INT8_PSNR_MARGIN:
            raise AssertionError(f"{path}: int8 vs float PSNR {p_float:.2f} dB, {differ} of the values differ")
        del fproc, fl

    native.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        out = proc._rgb48_eager(x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    peak = torch.cuda.max_memory_allocated()
    if read_counts(native) != {k: n * v for k, v in expected.items()}:
        raise AssertionError(f"launch counts over {n} frames: {native.launch_counts}")
    log(f"1080p {path}: {ms:.2f} ms/frame, {1e3 / ms:.2f} fps over {n} device-resident frames "
        f"(one sync); peak allocated {peak / 2**30:.2f} GiB; output range [{lo}, {hi}]"
        + ("" if p_float is None else f"; PSNR against float {p_float:.2f} dB"))
    graphs[path] = phase_graph(torch, native, smi, proc, x, out, expected, f"1080p {path}", n, graph_bound(path))
    del proc, x, out
    torch.cuda.empty_cache()
    return counts


def graph_bound(path: str) -> tuple:
    """Phase 8's bound on a replay against the eager output, used only where
    two eager runs of the program already differ: phase 3's card-against-CPU
    bound of the program, (max, mean) u16 codes."""
    spec = PATHS[path]
    if spec["dtype"] == "f32":
        return 4, None
    if spec.get("int8"):
        return INT8_DOWN2_E2E_CODES if spec.get("down2") == "1" else INT8_E2E_CODES[
            "int8_bf16_nomega" if spec["mega"] == "0" else "int8_bf16_mega"]
    return HG_BF16_CODES if spec["hg"] else (1536, 34.0)


def phase_graph(torch, native, smi: str, proc, x, eager_out, expected: dict, label: str, n: int,
                bound: tuple) -> dict:
    """Phase 8: the program of phase 4 through process_rgb48_device, which
    captures it as a CUDA graph at its first frame (after an eager run) and
    replays it: the capture counted one frame's launches (``expected``),
    the first call two (the eager run and the capture), n replays none; each
    replay's output equals the eager program's bytes (where two eager runs
    already differ, it stays within ``bound``, (max, mean) codes); two calls
    return two tensors. Then eager / replay / replay / eager, n frames each
    with one sync, ms/frame and peak allocated memory of each; the graph's
    memory pool; the graph and its pool freed at the end."""
    log(f"phase 8: {label} through process_rgb48_device's CUDA graph")
    torch.cuda.synchronize()
    native.reset_launch_counts()
    t0 = time.perf_counter()
    first = proc.process_rgb48_device(x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if len(proc.graphs) != 1:
        raise AssertionError(f"{label}: {len(proc.graphs)} graphs after one signature's first frame")
    entry = next(iter(proc.graphs.entries.values()))
    captured = {k: entry.launches.get(COUNTER.get(k, k), 0) for k in KERNEL_INFO}
    if captured != expected or read_counts(native) != {k: 2 * v for k, v in expected.items()}:
        raise AssertionError(f"{label}: the capture counted {captured}, the first call {read_counts(native)}; "
                             f"one frame launches {expected}")

    def block(fn):
        native.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        for _ in range(n):
            out = fn(x)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / n, torch.cuda.max_memory_allocated(), read_counts(native), out

    blocks = [block(fn) for fn in (proc._rgb48_eager, proc.process_rgb48_device, proc.process_rgb48_device,
                                   proc._rgb48_eager)]
    if any(any(b[2].values()) for b in blocks[1:3]) or blocks[0][2] != {k: n * v for k, v in expected.items()}:
        raise AssertionError(f"{label}: launches counted over {n} eager frames {blocks[0][2]}, "
                             f"over {n} replays {blocks[1][2]}, {blocks[2][2]}")
    replays = [first, blocks[1][3], blocks[2][3]]
    if len({r.data_ptr() for r in replays}) != len(replays):
        raise AssertionError(f"{label}: two calls returned the same tensor")
    eager_same = torch.equal(eager_out, blocks[0][3]) and torch.equal(eager_out, blocks[3][3])
    d = max(int((r.to(torch.int32) - eager_out.to(torch.int32)).abs().max()) for r in replays)
    mean = max(float((r.to(torch.int32) - eager_out.to(torch.int32)).abs().double().mean()) for r in replays)
    if eager_same and d:
        raise AssertionError(f"{label}: a replay differs from the eager output by up to {d} codes")
    if not eager_same and (d > bound[0] or (bound[1] is not None and mean > bound[1])):
        raise AssertionError(f"{label}: two eager runs differ; a replay differs from eager by max {d}, "
                             f"mean {mean:.3f} > {bound}")
    ms = [round(b[0], 3) for b in blocks]
    peak = [round(b[1] / 2**30, 3) for b in blocks]
    log(f"graph {label}: eager / replay / replay / eager {ms[0]:.3f} / {ms[1]:.3f} / {ms[2]:.3f} / {ms[3]:.3f} "
        f"ms/frame over {n} frames each (one sync); peak allocated {peak[0]:.3f} / {peak[1]:.3f} / "
        f"{peak[2]:.3f} / {peak[3]:.3f} GiB; graph pool {entry.pool_bytes / 2**30:.3f} GiB; first call "
        f"(eager run, capture, replay) {first_s:.2f} s, capture {entry.capture_s:.3f} s; replays equal to "
        f"eager: {d == 0}" + ("" if eager_same else f" (two eager runs differ; max {d}, mean {mean:.3f})")
        + f"; {smi}")
    proc.graphs.clear()
    del first, replays, blocks
    torch.cuda.empty_cache()
    return {"eager_ms": [ms[0], ms[3]], "replay_ms": [ms[1], ms[2]], "eager_peak_gib": [peak[0], peak[3]],
            "replay_peak_gib": [peak[1], peak[2]], "pool_gib": round(entry.pool_bytes / 2**30, 3),
            "capture_s": round(entry.capture_s, 3), "equal": d == 0}


# Phase 8's runtime options: proc_resolution at 1080p from a 1440 × 1080 source (content at
# scale 1, two 240-column bars), and card against CPU at 360 × 640, in the bf16 default
# program, on six noise frames each: the program as it is, proc_resolution (a 480 × 640
# source, INTER_AREA down to 360 × 480 and bars) and the two fast-condition shortcuts. Codes
# (max, mean): twice the largest sound max (561) and mean (37.89) of these 24 readings (max
# 145-561, mean 2.9-37.89 on an NVIDIA H100 80GB HBM3, 700 W). The mean is set by whether a
# bf16 rounding of the AGCM modulation flips between card and CPU, which moves every pixel:
# 6.5 codes where none does, 18-38 where one does. The same card frames against the planted
# faults of runtime_faults read max 1508-5007, mean 92-329 (a shortcut ignored) and max
# 40787-44822, mean 3648-3666 (the letterbox one row down): each breaks the bound.
RUNTIME_BF16_CODES = (1122, 76.0)


RUNTIME_SEEDS = 6  # frames of seeds h .. h + 5 for each option


def codes_apart(np, a, b) -> list:
    """[max, mean] of |a - b| over two u16 frames, in codes."""
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return [int(d.max()), float(d.mean())]


def rounded(readings: list) -> list:
    return [[m, round(mean, 3)] for m, mean in readings]


def breaks(reading, bound) -> bool:
    """Whether a [max, mean] reading breaks a (max, mean) bound (a mean of
    None bounds the max alone)."""
    return reading[0] > bound[0] or (bound[1] is not None and reading[1] > bound[1])


def runtime_faults(np, torch, frame, kw: dict, plain_rgb48) -> dict:
    """The CPU frames of planted faults of a runtime option, by name: what
    the output would be were the option broken, from ``plain_rgb48``, a CPU
    processor's process_rgb48 without options. proc_resolution: the
    letterboxed frame one row down; a fast-condition shortcut: the shortcut
    ignored (the default condition image). None without an option."""
    from hdrtv_tpu_torch.ops.resize import letterbox_u8

    if "proc_resolution" in kw:
        pw, ph = kw["proc_resolution"]
        lb = letterbox_u8(torch.from_numpy(frame), ph, pw).numpy()
        down = np.zeros_like(lb)
        down[1:] = lb[:-1]
        return {"letterbox one row down": plain_rgb48(down)}
    return {"shortcut ignored": plain_rgb48(frame)} if kw else {}


def phase_runtime(torch, np, native, smi: str) -> dict:
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    set_path_env({"mega": "1"})
    log("phase 8: proc_resolution (1920, 1080) from a 1080x1440 frame, bf16, through the CUDA graph")
    proc = HDRTVNetTorch(WEIGHTS, proc_resolution=(1920, 1080))
    frame = smooth_frame(np, 1080, 1440, 1440)
    x = proc.put_frame(frame.reshape(1080, 1440 * 3))
    if x.shape != (1080, 4320):
        raise AssertionError(f"the letterboxed frame shipped as {tuple(x.shape)}")
    eager = proc._rgb48_eager(x)
    native.reset_launch_counts()
    first = proc.process_rgb48_device(x)
    torch.cuda.synchronize()
    entry = next(iter(proc.graphs.entries.values()))
    captured = {k: entry.launches.get(COUNTER.get(k, k), 0) for k in KERNEL_INFO}
    n = 5
    times = {}
    for name, fn in (("eager", proc._rgb48_eager), ("replay", proc.process_rgb48_device)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            out = fn(x)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t) * 1e3 / n
    if first.shape != (1080, 5760) or not torch.equal(first, eager) or not torch.equal(out, eager) or \
            captured != expected_launches("bf16_mega"):
        raise AssertionError(f"proc_resolution 1080p: output {tuple(first.shape)}, equal to eager "
                             f"{torch.equal(first, eager)}, captured {captured}")
    log(f"proc_resolution 1080p: output {tuple(first.shape)} equal to eager; eager {times['eager']:.3f}, replay "
        f"{times['replay']:.3f} ms/frame over {n} frames (letterbox included); {smi}")
    result = {"proc_resolution_1080p": {k: round(v, 3) for k, v in times.items()}}
    proc.graphs.clear()
    del proc, x, eager, first, out
    torch.cuda.empty_cache()

    plain = HDRTVNetTorch(WEIGHTS, device="cpu")
    plain_outs: dict = {}

    def plain_rgb48(f):
        key = f.tobytes()
        if key not in plain_outs:
            plain_outs[key] = plain.process_rgb48(f)
        return plain_outs[key]

    for label, kw, (h, w) in (("default", {}, (360, 640)),
                              ("proc_resolution (640, 360)", {"proc_resolution": (640, 360)}, (480, 640)),
                              ("fast_condition_resize", {"fast_condition_resize": True}, (360, 640)),
                              ("fast_zero_condition", {"fast_zero_condition": True}, (360, 640))):
        log(f"phase 8: {label}, card (CUDA graph) against CPU ({h}x{w} frames of seeds {h}-"
            f"{h + RUNTIME_SEEDS - 1}, bf16)")
        gproc = HDRTVNetTorch(WEIGHTS, **kw)
        cpu_rgb48 = HDRTVNetTorch(WEIGHTS, device="cpu", **kw).process_rgb48 if kw else plain_rgb48
        sound, faults = [], {}
        for seed in range(h, h + RUNTIME_SEEDS):
            frame = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)
            gpu = gproc.process_rgb48(frame)
            if gpu.shape != (360, 640, 3) or (seed == h and not np.array_equal(gpu, eager_rgb48(gproc, frame))):
                raise AssertionError(f"{label}: output {gpu.shape}, or the replay differs from eager")
            sound.append(codes_apart(np, gpu, cpu_rgb48(frame)))
            for fault, bad in runtime_faults(np, torch, frame, kw, plain_rgb48).items():
                faults.setdefault(fault, []).append(codes_apart(np, gpu, bad))
        log(f"{label}: card (360, 640, 3), the first equal to eager; |card - cpu| [max, mean] codes by seed: "
            f"{rounded(sound)} (bound {RUNTIME_BF16_CODES})")
        if any(breaks(r, RUNTIME_BF16_CODES) for r in sound):
            raise AssertionError(f"{label}: card against CPU {rounded(sound)} breaks {RUNTIME_BF16_CODES}")
        for fault, readings in faults.items():
            seen = [breaks(r, RUNTIME_BF16_CODES) for r in readings]
            log(f"{label}, planted fault ({fault}): |card - cpu| by seed {rounded(readings)}; breaks the bound: "
                f"{seen}")
            if not all(seen):
                raise AssertionError(f"{label}: the bound {RUNTIME_BF16_CODES} does not see the planted "
                                     f"fault '{fault}': {rounded(readings)}")
        result[label] = {"card_vs_cpu": rounded(sound), **{f"fault: {k}": rounded(v) for k, v in faults.items()}}
        gproc.graphs.clear()
        del gproc
        torch.cuda.empty_cache()
    return result


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
        counts[path] = read_counts(native)
        o = out.to(torch.int32)
        lo, hi = int(o.min()), int(o.max())
        log(f"{path}: {tuple(out.shape)} {out.dtype} range [{lo}, {hi}]; launches {counts[path]['colorimetric']}")
        # SDR white at 1000 nits is PQ code 0.7518 · 65535; nothing may exceed it
        if out.shape != (1080, 1920, 3) or out.dtype != torch.uint16 or lo != 0 or not 45000 < hi <= 49300:
            raise AssertionError(f"colorimetric on the frame: {tuple(out.shape)} {out.dtype} range [{lo}, {hi}]")
        if counts[path] != {k: int(k == "colorimetric") for k in KERNEL_INFO}:
            raise AssertionError(f"{path}: launch counts {counts[path]}")
    return counts


def phase_forms(torch, np, native) -> dict:
    """The kernel forms no frame program runs, once per element type at a
    1080p main-path shape with the counts set to 0 before and read after:
    cond_chain's int8 steps (c0 (540, 960, 256), steps 0/2/4 int8), and
    block_conv3's pool_out form, float and int8 (L1 up_conv3's (270, 480, 128)
    -> 512); returns the counts by drive."""
    from hdrtv_tpu_torch.models.s2d import b_s2d, w_ps_permute, w_s2d_1x1, w_s2d_s1_ps
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3
    from hdrtv_tpu_torch.ops.megakernel import fused_cond_chain
    from hdrtv_tpu_torch.ops.w8a8 import pack_qargs
    from hdrtv_tpu_torch.quant.int8 import quantize_weight

    log("phase 6: cond_chain's int8 steps and block_conv3's pool_out, which no frame program runs")
    rng = np.random.RandomState(6)
    dev = torch.device("cuda")
    counts = {}
    for path, dtype in FORM_PATHS.items():
        dt = torch.float32 if dtype == "f32" else torch.bfloat16
        c0 = torch.as_tensor(rng.rand(540, 960, 256).astype(np.float32) - 0.3, device=dev).to(dt)
        steps, qargs = [], []
        for i, n in enumerate((64, 64, 64, 64, 16)):
            wq, ws = quantize_weight(rng.randn(1, 1, 64, n).astype(np.float32) * 0.15)
            tq, tsc = w_s2d_1x1(wq), b_s2d(ws)
            bnp = (rng.randn(4 * n) * 0.1).astype(np.float32)
            steps.append((torch.as_tensor(tq[0, 0].astype(np.float32) * tsc, device=dev).to(dt),
                          torch.as_tensor(bnp, device=dev)))
            qargs.append(pack_qargs(tq, tsc, 2.0 / 127.0, -0.3 if i == 2 else None, bnp, dev) if i % 2 == 0 else None)
        x = torch.as_tensor(rng.rand(270, 480, 128).astype(np.float32), device=dev).to(dt)
        wq, ws = quantize_weight(rng.randn(3, 3, 32, 128).astype(np.float32) * 0.05)
        tq, tsc = w_s2d_s1_ps(wq), np.tile(w_ps_permute(ws.reshape(1, 1, 1, -1))[0, 0, 0], 4)
        bnp = (rng.randn(512) * 0.1).astype(np.float32)
        w = torch.as_tensor(tq.astype(np.float32) * tsc, device=dev).to(dt)
        b = torch.as_tensor(bnp, device=dev)
        qa = pack_qargs(tq, tsc, 1.1 / 127.0, None, bnp, dev)
        torch.cuda.synchronize()
        native.reset_launch_counts()
        c, cond1 = fused_cond_chain(c0, steps, qargs=qargs)
        pooled = fused_block_conv3(x, w, b, relu=True, pool_out=True)
        pooled_q = fused_block_conv3(x, w, b, relu=True, qargs=qa, pool_out=True)
        torch.cuda.synchronize()
        counts[path] = read_counts(native)
        shapes = [tuple(o.shape) for o in (c, cond1, pooled, pooled_q)]
        finite = all(bool(torch.isfinite(o.float()).all()) for o in (c, cond1, pooled, pooled_q))
        log(f"{path}: outputs {shapes}, finite {finite}; launches "
            f"{ {k: v for k, v in counts[path].items() if v} }")
        if shapes != [(540, 960, 256), (540, 960, 64), (135, 240, 512), (135, 240, 512)] or not finite:
            raise AssertionError(f"{path}: outputs {shapes}, finite {finite}")
        if counts[path] != {k: FORM_LAUNCHES.get(k, 0) for k in KERNEL_INFO}:
            raise AssertionError(f"{path}: launch counts {counts[path]}")
        del c0, c, cond1, x, pooled, pooled_q
    return counts


def phase_probes(torch, np, native) -> dict:
    """The two layout probes' kernels at their 1080p shapes, each call with
    the counts set to 0 before and read after; returns the probe path's
    counts (each entry from its own call)."""
    from hdrtv_tpu_torch.ops.probe_kernels import d2s_add, rowmajor_head_pre, rowmajor_head_raw

    log("phase 7: the two layout probes' kernels, which no frame program runs")
    rng = np.random.RandomState(7)
    dev = torch.device("cuda")
    hbc, wbc, c = PROBE_SHAPES["d2s_1080p"]
    h, w, co = PROBE_SHAPES["head"]
    coarse = torch.as_tensor(rng.randn(hbc, wbc, 4 * c).astype(np.float32), device=dev).to(torch.bfloat16)
    fine = torch.as_tensor(rng.randn(2 * hbc, 2 * wbc, c).astype(np.float32), device=dev).to(torch.bfloat16)
    frame = torch.as_tensor(rng.randint(0, 256, (h, 3 * w), dtype=np.uint8), device=dev)
    wm = torch.as_tensor(rng.randn(12, co).astype(np.float32) * 0.1, device=dev).to(torch.bfloat16)
    drives = (("d2s_add", "d2s_add", lambda: d2s_add(coarse, fine), (2 * hbc, 2 * wbc, c)),
              ("rowmajor_head_raw", "rowmajor_head", lambda: rowmajor_head_raw(frame, wm), (h // 2, w // 2, co)),
              ("rowmajor_head_pre", "rowmajor_head",
               lambda: rowmajor_head_pre(frame.view(h // 2, 2, w // 2, 6), wm), (h // 2, w // 2, co)))
    counts = {k: 0 for k in KERNEL_INFO}
    for name, counter, fn, shape in drives:
        torch.cuda.synchronize()
        native.reset_launch_counts()
        y = fn()
        torch.cuda.synchronize()
        launched = {k: v for k, v in native.launch_counts.items() if v}
        finite = bool(torch.isfinite(y.float()).all())
        log(f"{name}: output {tuple(y.shape)} {y.dtype}, finite {finite}; launches {launched}")
        if launched != {counter: 1} or tuple(y.shape) != shape or not finite:
            raise AssertionError(f"{name}: launches {launched}, output {tuple(y.shape)}, finite {finite}")
        counts[name] = read_counts(native)[name]
    return counts


# Phase 9, the playback and export pipeline (pipeline/runner.py, pipeline/export.py): the paths
# it drives through the frame programs' CUDA graphs, with the phase-4 path whose launches one
# frame makes. The export's warm-up runs the program eagerly and captures it (two frames'
# launches, which the counters see); every frame after it replays the graph (none).
PIPE_PATHS = {
    "pipeline_bf16": {"weights": "float", "path": "bf16_mega", "size": (1080, 1920), "proc_resolution": None},
    "pipeline_int8": {"weights": "int8", "path": "int8_bf16_mega", "size": (1080, 1920), "proc_resolution": None},
    "pipeline_540p": {"weights": "float", "path": "nat540_bf16", "size": (540, 960), "proc_resolution": (960, 540)},
}
PIPE_EXPORT_FRAMES = 120
PIPE_FLAT_FRAMES = 300
PIPE_PROFILE_FRAMES = 60
PIPE_REALTIME = (60.0, 600)  # fps and frames: 10 s at 60 fps
PIPE_SWAP = ((1920, 1080), (960, 540))  # (W, H): the hot-swap's sizes, the source at the first
PIPE_MAX_DROP = 0.01
PIPE_CLI_FRAMES = 30


def _pipe_launches(path: str) -> dict:
    if path in PATHS:
        return expected_launches(path)
    return {k: int(k == "pack_rgb48") for k in KERNEL_INFO}


def stream_overlap(trace_path: str) -> dict:
    """From a torch.profiler Chrome trace of a pipelined run: the device's
    busy share (the union of kernel and copy intervals over the span from the
    first to the last), the stream that runs most kernel time (the replays'),
    the streams of the HtoD and DtoH copies, and the share of the copies'
    time that lies under a kernel running on another stream."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels, copies, other = [], {"HtoD": [], "DtoH": []}, []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        stream = (e.get("args") or {}).get("stream", e.get("tid"))
        iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]), stream)
        if cat == "kernel":
            kernels.append(iv)
        elif cat in ("gpu_memcpy", "gpu_memset"):
            kind = next((k for k in copies if k in name), None)
            (copies[kind] if kind else other).append(iv)

    def union(ivs):
        out = []
        for a, b in sorted((a, b) for a, b, _ in ivs):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def covered(a, b, spans):
        return sum(max(0.0, min(b, y) - max(a, x)) for x, y in spans)

    if not kernels:
        raise AssertionError("the profiler saw no kernel on the card")
    per_stream = {}
    for a, b, st in kernels:
        per_stream[st] = per_stream.get(st, 0.0) + (b - a)
    replay_stream = max(per_stream, key=per_stream.get)
    everything = kernels + copies["HtoD"] + copies["DtoH"] + other
    span = max(b for _, b, _ in everything) - min(a for a, _, _ in everything)
    busy = sum(b - a for a, b in union(everything)) / span
    out = {"busy": round(busy, 4), "replay_stream": replay_stream, "kernel_ms": round(sum(per_stream.values()) / 1e3, 3)}
    for kind, ivs in copies.items():
        total = sum(b - a for a, b, _ in ivs)
        under = 0.0
        for a, b, st in ivs:
            under += covered(a, b, union([k for k in kernels if k[2] != st]))
        out[kind] = {"n": len(ivs), "ms": round(total / 1e3, 3), "streams": sorted({str(st) for _, _, st in ivs}),
                     "overlapped": round(under / total, 4) if total else None,
                     "off_replay_stream": all(st != replay_stream for _, _, st in ivs)}
    return out


def phase_pipeline(torch, np, native, smi: str, tmp: str) -> dict:
    """Phase 9: the playback and export pipeline on the card. Returns the
    pipeline paths' launch counts (the export's warm-up: the eager run and
    the capture) and the phase's figures."""
    import hashlib

    from hdrtv_tpu_torch.pipeline.export import ExportConfig, _Y4MWriter, export_video
    from hdrtv_tpu_torch.pipeline.runner import PipelineRunner
    from hdrtv_tpu_torch.pipeline.sinks import NullSink
    from hdrtv_tpu_torch.pipeline.source import SyntheticSource
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    set_path_env({"mega": "1"})
    counts, figures = {}, {"card": smi}

    def make(spec, **kw):
        weights = INT8_WEIGHTS if spec["weights"] == "int8" else WEIGHTS
        return HDRTVNetTorch(weights, precision="fp16", proc_resolution=spec["proc_resolution"],
                             persistent_cache=False, **kw)

    # --- exports, every frame against process_rgb48 of the same frame ---------------------
    procs = {}
    for name, spec in PIPE_PATHS.items():
        h, w = spec["size"]
        proc = procs[name] = make(spec)
        for codec in ("raw",) + (("y4m",) if name == "pipeline_540p" else ()):
            n = PIPE_EXPORT_FRAMES if codec == "raw" else 30
            log(f"phase 9: export_video {name} {codec}, {n} synthetic {h}x{w} frames")
            out = os.path.join(tmp, f"{name}.{codec}")
            torch.cuda.synchronize()
            native.reset_launch_counts()
            stats = export_video(None, proc, ExportConfig(output=out, codec=codec),
                                 source=SyntheticSource(w, h, fps=30, frames=n))
            torch.cuda.synchronize()
            if codec == "raw":
                counts[name] = read_counts(native)
                want = {k: 2 * v for k, v in _pipe_launches(spec["path"]).items()}
                if counts[name] != want:
                    raise AssertionError(f"{name}: the export counted {counts[name]}, its warm-up launches {want}")
            if stats["frames"] != n or len(proc.graphs) != 1:
                raise AssertionError(f"{name} {codec}: {stats['frames']} frames, {len(proc.graphs)} graphs")
            src = SyntheticSource(w, h, fps=30, frames=n)
            if codec == "raw":
                data = np.memmap(stats["output"], np.uint16, "r", shape=(n, h, w, 3))
                bad = [i for i in range(n) if not np.array_equal(data[i], proc.process_rgb48(src.read_with_meta()[0]))]
                del data
            else:
                ref = os.path.join(tmp, f"{name}_ref.y4m")
                wr = _Y4MWriter(ExportConfig(output=ref, codec="y4m"), w, h, 30.0)
                for _ in range(n):
                    wr.write(proc.process_rgb48(src.read_with_meta()[0]))
                wr.close()
                with open(stats["output"], "rb") as f1, open(ref, "rb") as f2:
                    bad = [] if f1.read() == f2.read() else ["file"]
            for f in os.listdir(tmp):
                if f.startswith(name):
                    os.remove(os.path.join(tmp, f))
            ms = stats["seconds"] * 1e3 / n
            log(f"export {name} {codec}: {n} frames, {stats['fps']} fps ({ms:.3f} ms/frame, writer included), "
                f"bit-equal to process_rgb48: {not bad}" + (f"; launches (warm-up) "
                                                             f"{ {k: v for k, v in counts[name].items() if v} }"
                                                             if codec == "raw" else "") + f"; {smi}")
            if bad:
                raise AssertionError(f"{name} {codec}: frames {bad[:10]} differ from process_rgb48")
            figures[f"export_{name}_{codec}_ms"] = round(ms, 3)

    # --- flat-out runner: pinned rings and copy streams against the parent's pageable copies --
    class PageableRunner(PipelineRunner):
        """The parent's copies: torch.from_numpy(...).to(device) in put_frame and .cpu() in
        the feeder, both on the default stream, where the replays run too."""

        def _setup_copies(self):
            self._compute = torch.cuda.default_stream(self.device)
            self._d2h = self._out = None

        def _copy_out(self, dev_out):
            return dev_out

        def _fetch(self, handle):
            return handle.cpu().numpy()

        def _finish(self, handle):
            pass

    def pageable(proc, on: bool):
        if on:
            proc._to_device = lambda arr: torch.from_numpy(np.ascontiguousarray(arr)).to(proc.device)
        else:
            del proc._to_device

    def flat_out(proc, kind, w, h, n, profile=None):
        cls = PageableRunner if kind == "pageable" else PipelineRunner
        if kind == "pageable":
            pageable(proc, True)
        try:
            sink = NullSink()
            r = cls(SyntheticSource(w, h, fps=60, frames=n), proc, sink, realtime=False, ring=3, warmup_frames=10)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if profile is None:
                m = r.run()
            else:
                from torch.profiler import ProfilerActivity, profile as prof_ctx

                with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    m = r.run()
                prof.export_chrome_trace(profile)
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            if kind == "pageable":
                pageable(proc, False)
        if m.frames != n or sink.frames != n:
            raise AssertionError(f"{kind}: {m.frames} frames run, {sink.frames} shown of {n}")
        st = r.timers.as_dict()
        return {"ms_per_frame": round(1e3 / m.fps, 3), "wall_ms_per_frame": round(wall / n, 3),
                "model_ms": round(m.model_ms, 3), "ring_ms": round(m.ring_ms, 3),
                **{f"{k}_ms": round(st[k]["mean_ms"], 3) for k in ("decode", "submit", "render") if k in st}}

    for name in ("pipeline_bf16", "pipeline_int8"):
        proc = procs[name]
        h, w = PIPE_PATHS[name]["size"]
        runs = [(kind, flat_out(proc, kind, w, h, PIPE_FLAT_FRAMES))
                for kind in ("pinned", "pageable", "pageable", "pinned")]
        for kind, res in runs:
            log(f"flat-out {name} {kind}: {json.dumps(res)}; {smi}")
        trace = os.path.join(tmp, f"{name}_trace.json")
        flat_out(proc, "pinned", w, h, PIPE_PROFILE_FRAMES, profile=trace)
        ov = stream_overlap(trace)
        os.remove(trace)
        trace = os.path.join(tmp, f"{name}_pageable_trace.json")
        flat_out(proc, "pageable", w, h, PIPE_PROFILE_FRAMES, profile=trace)
        ov_pageable = stream_overlap(trace)
        os.remove(trace)
        log(f"profile {name} pinned ({PIPE_PROFILE_FRAMES} frames): {json.dumps(ov)}")
        log(f"profile {name} pageable ({PIPE_PROFILE_FRAMES} frames): {json.dumps(ov_pageable)}")
        for kind in ("HtoD", "DtoH"):
            if not ov[kind]["n"] or not ov[kind]["off_replay_stream"]:
                raise AssertionError(f"{name}: the {kind} copies ran on the replays' stream: {ov}")
        figures[f"flat_{name}"] = {"runs": runs, "profile_pinned": ov, "profile_pageable": ov_pageable}

    # --- realtime: 10 s at 60 fps, bf16 default, null sink -------------------------------------
    proc = procs["pipeline_bf16"]
    fps, n = PIPE_REALTIME
    h, w = PIPE_PATHS["pipeline_bf16"]["size"]
    log(f"phase 9: realtime {n} frames at {fps:g} fps, {h}x{w} bf16 default, null sink")
    sink = NullSink()
    m = PipelineRunner(SyntheticSource(w, h, fps=fps, frames=n), proc, sink, realtime=True, ring=3).run()
    rt = {"frames": m.frames, "shown": sink.frames, "dropped": m.dropped, "fps": round(m.fps, 3),
          "fps_1pct_low": round(m.fps_1pct_low, 3), "model_ms": round(m.model_ms, 3), "ring_ms": round(m.ring_ms, 3)}
    log(f"realtime: {json.dumps(rt)}; {smi}")
    if m.dropped > PIPE_MAX_DROP * n:
        raise AssertionError(f"realtime: {m.dropped} of {n} frames dropped (at most {PIPE_MAX_DROP:.0%})")
    figures["realtime"] = rt

    # --- a hot-swap under load: 1080p -> 540p -> 1080p with the ring full ---------------------
    big, small = PIPE_SWAP
    log(f"phase 9: resolution hot-swap {big} -> {small} -> {big} (W, H) under load")
    import threading

    made = {}

    def factory(precision=None, proc_resolution=None):
        made[proc_resolution] = p = proc.with_proc_resolution(proc_resolution)
        return p

    class HashSink:
        def __init__(self):
            self.got = []

        def show(self, rgb48, pts=None):
            self.got.append((pts, rgb48.shape, hashlib.blake2b(rgb48, digest_size=16).digest()))

        def close(self):
            pass

    sink = HashSink()
    r = PipelineRunner(SyntheticSource(*big, fps=30, frames=100000), factory(proc_resolution=big), sink,
                       realtime=False, ring=3, processor_factory=factory)
    errors = []

    def run():
        try:
            r.run()
        except BaseException as e:  # re-raised below, on the main thread
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    for res in (small, big):
        n0, deadline = len(sink.got), time.monotonic() + 120
        while len(sink.got) < n0 + 30 and time.monotonic() < deadline and t.is_alive():
            time.sleep(0.01)
        r.request_resolution_change(res)
    n0, deadline = len(sink.got), time.monotonic() + 120
    while len(sink.got) < n0 + 30 and time.monotonic() < deadline and t.is_alive():
        time.sleep(0.01)
    r.stop()
    t.join(timeout=120)
    if t.is_alive():
        raise AssertionError("hot-swap: the runner did not stop")
    if errors:
        raise errors[0]
    sizes, bad = {}, []
    src = SyntheticSource(*big, fps=30, frames=100000)
    for pts, shape, digest in sink.got:
        idx = int(round(pts * 30))
        res = big if shape == (big[1], 3 * big[0]) else small
        sizes[res] = sizes.get(res, 0) + 1
        src.seek(idx)
        want = made[res].process_rgb48(src.read_with_meta()[0])
        if hashlib.blake2b(np.ascontiguousarray(want.reshape(shape)), digest_size=16).digest() != digest:
            bad.append((idx, res))
    swap = {"frames": len(sink.got), "by_size": {f"{k[0]}x{k[1]}": v for k, v in sizes.items()},
            "flushed": r.flushed, "wrong": len(bad), "graphs": {f"{k[0]}x{k[1]}": len(p.graphs) for k, p in made.items()}}
    log(f"hot-swap: {json.dumps(swap)}")
    if bad or sizes.get(small, 0) < 10 or sizes.get(big, 0) < 40:
        raise AssertionError(f"hot-swap: {swap}; wrong frames {bad[:10]}")
    figures["hot_swap"] = swap
    for p in list(made.values()) + list(procs.values()):
        p.graphs.clear()
    del made, procs, proc, p
    torch.cuda.empty_cache()

    # --- the CLI in a subprocess ---------------------------------------------------------------
    out = os.path.join(tmp, "cli.rgb48")
    env = {**os.environ, "HDRTVNET_PREFS_PATH": os.path.join(tmp, "prefs.json"),
           "HDRTVNET_ENGINE_CACHE_DIR": os.path.join(tmp, "engines"), "HDRTVNET_CACHE_DIR": os.path.join(tmp, "cache")}
    cmd = [sys.executable, "-m", "hdrtv_tpu_torch.cli", "convert", "--display", "file", "--output", out,
           "--no-realtime", "--frames", str(PIPE_CLI_FRAMES)]
    log("phase 9: " + " ".join(cmd[1:]))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    for line in res.stdout.strip().splitlines()[-3:]:
        log("  cli: " + line)
    size = os.path.getsize(out) if os.path.exists(out) else -1
    want = PIPE_CLI_FRAMES * 1920 * 1080 * 6
    log(f"cli: exit {res.returncode}, {size} bytes (want {want}), {cli_s:.1f} s")
    if res.returncode != 0 or size != want:
        raise AssertionError(f"cli: exit {res.returncode}, {size} bytes; stderr {res.stderr[-2000:]}")
    os.remove(out)
    figures["cli_s"] = round(cli_s, 1)
    return counts, figures


# Phase 10: checkpoints, model variants and metrics. The model variants run the natural
# program (turbo off by the JAX runtime's rule) at the fixtures' own width (nf = 16;
# tools/synth_variants.py), card against CPU at VARIANT_SIZE within phase 3's natural
# bounds (fp32 4 codes, bf16 NAT_BF16_CODES) unless VARIANT_BF16_CODES names a wider one
# (twice the largest reading, said there), and at 1080p bf16 through process_rgb48_device:
# VARIANT_FRAMES eager frames and as many replays, the replays equal to the eager bytes.
# The goldens of tests/test_model_variants.py hold on the card in fp32 at their tolerances
# (GOLDEN_ATOL). An FP8 source container's frame, card against CPU at VARIANT_SIZE, within
# phase 3's bf16 bound. full_reference_metrics on the card against the port on the CPU on
# the 1080p bf16-default / fp32 pair within METRIC_TOL (PSNR and SSIM absolute, ΔEITP
# relative), and the metrics golden within tests/test_ops.py's tolerances.
DEVICE = "cuda"  # where phase 10 puts the tensors it makes itself
FULL_SIZE = (1080, 1920)
VARIANT_SIZE = (360, 640)
VARIANT_FRAMES = 3
# The direct HG composite in bf16 needs a wider bound than phase 3's natural one: twice
# the 768 / 87.947 read on the card (max over channels, off the mask's threshold; its
# seeded low-resolution trunk of eight 3×3 convs moves a flipped bf16 rounding of the
# base further than the base alone does). NVIDIA H100 80GB HBM3, 700.00 W.
VARIANT_BF16_CODES = {"hg_direct": (1536, 175.9)}
FP8_E2E_CODES = (1536, 34.0)
VARIANT_RAW_ATOL = 1e-4  # fp32, times max(1, max |y|): phase 2's fp32 tolerance
GOLDEN_ATOL = {"agcm": 2e-5, "le": 1e-4, "lowrank4": 2e-4, "hg_direct": 2e-5}
METRIC_TOL = {"psnr": 1e-3, "psnr_gn": 1e-3, "ssim": 1e-5, "delta_e_itp": 1e-3, "delta_e_itp_gn": 1e-3}


def phase_checkpoints(torch, np, native, smi: str, tmp: str) -> tuple[dict, dict]:
    """Phase 10 (a)-(c): the shipped weights as a reference .pt against the .npz at 1080p
    (bf16 default and fp32, process_rgb48_device, bit for bit, equal fingerprints, load
    times); an HR .pt with a synthetic hg_nf = 64 generator's own .pt as hg_path (its
    BatchNorms unfolded, folded at load) against the .npz folded the same way (HG bf16,
    bit for bit); an FP8 source container, card against CPU. Returns the figures and the
    two 1080p frames of (a) for the metrics."""
    from hdrtv_tpu_torch.models.import_npz import convert_state, load_npz, load_npz_meta, npz_arch_dict, save_npz
    from hdrtv_tpu_torch.models.import_torch import HG_BN_BLOCKS, fold_hg_batchnorm, load_checkpoint
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch
    from hdrtv_tpu_torch.tools.synth_hg import synth_hg_params
    from hdrtv_tpu_torch.tools.synth_variants import to_torch_layout, write_pt

    set_path_env({"mega": "1"})
    figures, frames = {"card": smi}, {}
    arch = dict(npz_arch_dict(load_npz_meta(WEIGHTS)))
    state = to_torch_layout(load_npz(WEIGHTS))
    hr_pt = write_pt(os.path.join(tmp, "HR.pt"), state, arch)
    h, w = FULL_SIZE
    flat = smooth_frame(np, h, w, 1080).reshape(h, 3 * w)

    def load(path, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proc = HDRTVNetTorch(path, persistent_cache=False, **kw)
        torch.cuda.synchronize()
        return proc, time.perf_counter() - t0

    def same_frame(a, b, label):
        ya = a.process_rgb48_device(a.put_frame(flat))
        yb = b.process_rgb48_device(b.put_frame(flat))
        torch.cuda.synchronize()
        if a.model_hash != b.model_hash or not torch.equal(ya, yb):
            raise AssertionError(f"{label}: fingerprints {a.model_hash} / {b.model_hash}, frames equal "
                                 f"{torch.equal(ya, yb)}")
        a.graphs.clear()
        b.graphs.clear()
        return ya

    for precision in ("fp16", "fp32"):
        log(f"phase 10: the shipped weights as a .pt, against the .npz (1080p {precision})")
        pt, pt_s = load(hr_pt, precision=precision)
        nz, nz_s = load(WEIGHTS, precision=precision)
        if not pt.turbo or repr(pt.cfg) != repr(nz.cfg):
            raise AssertionError(f".pt {precision}: turbo {pt.turbo}, config {pt.cfg} against {nz.cfg}")
        frames[precision] = same_frame(pt, nz, f".pt {precision}").reshape(h, w, 3)
        figures[f"pt_{precision}"] = {"load_s": round(pt_s, 3), "npz_load_s": round(nz_s, 3), "equal": True}
        log(f".pt {precision}: load {pt_s:.2f} s (.npz {nz_s:.2f} s), fingerprint {pt.model_hash[:12]}, "
            f"1080p frame bit-equal to the .npz processor's; {smi}")
        del pt, nz

    log("phase 10: HR .pt + hg_path (synthetic hg_nf 64, BatchNorms folded at load) against the folded .npz "
        "(1080p HG bf16)")
    hg = synth_hg_params(nf=64, seed=0)
    hg_state = to_torch_layout({k[len("hg."):]: v for k, v in hg.items() if k.startswith("hg.")})
    n_bn = sum(f"{b}.1.running_mean" in hg_state for b in HG_BN_BLOCKS)
    hg_pt = write_pt(os.path.join(tmp, "HG.pt"), hg_state)
    folded = os.path.join(tmp, "hg64_folded.npz")
    save_npz(folded, {**{k: v for k, v in hg.items() if k.startswith("base.")},
                      **convert_state(fold_hg_batchnorm({f"hg.{k}": v for k, v in hg_state.items()}))},
             {"architecture": {**arch, "use_hg": True, "hg_nf": 64}})
    pt, pt_s = load(hr_pt, hg_path=hg_pt, use_hg=True)
    nz, _ = load(folded)
    if not (pt.cfg.use_hg and pt.turbo and n_bn == len(HG_BN_BLOCKS)) or any(".1.running_" in k for k in pt.params):
        raise AssertionError(f"hg_path: use_hg {pt.cfg.use_hg}, turbo {pt.turbo}, {n_bn} BatchNorms in the file")
    same_frame(pt, nz, "hg_path")
    figures["pt_hg_path_bf16"] = {"load_s": round(pt_s, 3), "bn_folded": n_bn, "equal": True}
    log(f"hg_path: load {pt_s:.2f} s, {n_bn} BatchNorms folded, 1080p HG frame bit-equal to the folded .npz's")
    del pt, nz

    h, w = VARIANT_SIZE
    log(f"phase 10: FP8 source container, card against CPU ({h}x{w} bf16 default)")
    layers = [k[: -len(".weight")] for k, v in state.items()
              if k.endswith(".weight") and v.ndim == 4 and k != "LE.conv_last.weight"]
    fp8_pt = write_pt(os.path.join(tmp, "HR_fp8.pt"), state, arch, fp8_source_schema="hdrtv-fp8-source",
                      fp8_source_note="fp32 sources; FP8 Q/DQ at build",
                      weight_qparams={n: {"amax": torch.tensor(float(np.abs(state[f"{n}.weight"]).max()))}
                                      for n in layers})
    p8, _ = load_checkpoint(fp8_pt)
    p32, _ = load_checkpoint(fp8_pt, fp8_emulate=False)
    emulated = sum(not np.array_equal(p8[k], p32[k]) for k in p8)
    frame = (np.random.RandomState(360).rand(h, w, 3) * 255).astype(np.uint8)
    gproc, fp8_s = load(fp8_pt)
    gpu = eager_rgb48(gproc, frame)
    cpu = HDRTVNetTorch(fp8_pt, device="cpu").process_rgb48(frame)
    plain = eager_rgb48(HDRTVNetTorch(hr_pt, persistent_cache=False), frame)
    d = codes_apart(np, gpu, cpu)
    moved = codes_apart(np, gpu, plain)
    log(f"FP8: {emulated} layers emulated of {len(layers)} named; load {fp8_s:.2f} s; card against CPU max "
        f"{d[0]} codes, mean {d[1]:.3f} (bound {FP8_E2E_CODES}); against the fp32 weights' frame max {moved[0]}, "
        f"mean {moved[1]:.3f}")
    if emulated != len(layers) or breaks(d, FP8_E2E_CODES) or moved[0] == 0:
        raise AssertionError(f"FP8: {emulated} of {len(layers)} layers emulated, card against CPU {d}, "
                             f"against the fp32 weights {moved}")
    figures["fp8_bf16"] = {"emulated_layers": emulated, "load_s": round(fp8_s, 3), "card_vs_cpu_codes": rounded([d])[0],
                           "vs_fp32_weights_codes": rounded([moved])[0]}
    del gproc
    torch.cuda.empty_cache()
    return figures, frames


def phase_variants(torch, np, native, smi: str, tmp: str) -> tuple[dict, dict]:
    """Phase 10 (d): every model variant. The goldens on the card (fp32, TF32 off); each
    variant's .pt card against CPU at VARIANT_SIZE in fp32 and bf16; at 1080p bf16 one
    eager frame with the launch counts set to 0 before and read after (pack_rgb48 once,
    nothing else), then VARIANT_FRAMES eager frames and VARIANT_FRAMES replays of
    process_rgb48_device's graph, each replay equal to the eager bytes. Every reading is
    printed before any bound is enforced; the phase then fails on all that broke one.
    Returns the figures and the launch counts of the counted frames."""
    from hdrtv_tpu_torch.models.agcm import agcm_apply
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig, ensemble_agcm_le
    from hdrtv_tpu_torch.models.hg import hg_direct_apply
    from hdrtv_tpu_torch.models.import_npz import convert_state
    from hdrtv_tpu_torch.models.import_torch import remap_condition_state
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch
    from hdrtv_tpu_torch.tools.synth_variants import AGCM_VARIANTS, LE_VARIANTS, write_variants

    set_path_env({"mega": "1"})
    figures, broke = {"card": smi, "goldens": {}}, []
    dev = torch.device(DEVICE)

    def fixture(name):
        with np.load(os.path.join(ROOT, "tests", "fixtures", name)) as z:
            return {k: z[k] for k in z.files}

    def params(fx, prefix, remap=None):
        raw = {k[len(prefix):]: v for k, v in fx.items() if k.startswith(prefix)}
        if remap:
            raw = remap_condition_state(raw, prefix="AGCM.", classifier=remap)
        return {k: torch.from_numpy(v).to(dev) for k, v in convert_state(raw).items()}

    def golden(label, out, want, atol):
        err = float(np.abs(out.float().cpu().numpy() - want).max())
        figures["goldens"][label] = err
        if err > atol:
            broke.append(f"golden {label}: {err:.3e} > {atol}")

    log("phase 10: the variants' goldens on the card (fp32, TF32 off)")
    fx = fixture("agcm_variants.npz")
    img, cond = torch.from_numpy(fx["img"]).to(dev), torch.from_numpy(fx["cond"]).to(dev)
    for tag, classifier in AGCM_VARIANTS.items():
        golden(f"agcm_{tag}", agcm_apply(params(fx, f"{tag}__sd__"), img, cond, prefix="", classifier=classifier),
               fx[f"{tag}__out"], GOLDEN_ATOL["agcm"])
    fx = fixture("ensemble_variants.npz")
    img, cond = torch.from_numpy(fx["img"]).to(dev), torch.from_numpy(fx["cond"]).to(dev)
    with torch.inference_mode():
        for tag, le_arch in LE_VARIANTS.items():
            golden(f"le_{tag}", ensemble_agcm_le(params(fx, f"{tag}__sd__"), img, cond,
                                                 ModelConfig(le_arch=le_arch, nf=16)),
                   fx[f"{tag}__out"], GOLDEN_ATOL["le"])
        golden("lowrank4", ensemble_agcm_le(params(fx, "lowrank4__sd__", remap="lowrank_4"), img, cond,
                                            ModelConfig(classifier="agcm_lowrank4", nf=16)),
               fx["lowrank4__out"], GOLDEN_ATOL["lowrank4"])
    fx = fixture("hg_direct.npz")
    golden("hg_direct", hg_direct_apply(params(fx, "sd__"), torch.from_numpy(fx["img"]).to(dev),
                                        torch.from_numpy(fx["mask"]).to(dev), prefix="", bottleneck_scale=4,
                                        trunk_depth=2), fx["out"], GOLDEN_ATOL["hg_direct"])
    log("goldens, max |card - golden|: " + ", ".join(f"{k} {v:.2e}" for k, v in figures["goldens"].items()))

    paths = write_variants(os.path.join(tmp, "variants"))
    h, w = VARIANT_SIZE
    small = (np.random.RandomState(640).rand(h, w, 3) * 255).astype(np.uint8)
    hg_small = smooth_frame(np, h, w, 641)
    fh, fw = FULL_SIZE
    big = smooth_frame(np, fh, fw, 1081).reshape(fh, 3 * fw)
    expected = {k: int(k == "pack_rgb48") for k in KERNEL_INFO}
    counts = {k: 0 for k in KERNEL_INFO}
    for name, path in paths.items():
        fig = figures[name] = {}
        frame = hg_small if name == "hg_direct" else small
        for precision in ("fp32", "fp16"):
            gproc = HDRTVNetTorch(path, precision=precision, persistent_cache=False)
            cproc = HDRTVNetTorch(path, precision=precision, device="cpu")
            if gproc.turbo or not gproc.natural(h, w):
                broke.append(f"{name}: turbo {gproc.turbo}")
            gpu, cpu = eager_rgb48(gproc, frame), cproc.process_rgb48(frame)
            diff = np.abs(gpu.astype(np.int64) - cpu.astype(np.int64)).max(axis=-1)
            if name != "hg_direct":  # the model's output before the clip and pack
                with torch.inference_mode():
                    yg = gproc.infer(gproc.preprocess(frame)).float().cpu().numpy()
                    yc = cproc.infer(cproc.preprocess(frame)).float().numpy()
                raw = float(np.abs(yg - yc).max())
                scale = max(1.0, float(np.abs(yc).max()))
                fig[f"raw_card_vs_cpu_{precision}"] = [raw, round(scale, 3)]
                if precision == "fp32" and raw > VARIANT_RAW_ATOL * scale:
                    broke.append(f"{name} fp32: the model's output {raw:.3e} apart > {VARIANT_RAW_ATOL} x {scale:.3f}")
            else:  # the mask's threshold pixels counted apart, as in phase 3 (the base in the natural program)
                base = HDRTVNetTorch(path, precision=precision, device="cpu", use_hg=False,
                                     turbo=False).process_rgb48(frame)
                m = base.astype(np.float32).max(axis=-1) / 65535.0
                near = np.abs(m - 0.775) <= (2e-4 if precision == "fp32" else 0.02)
                changed = float((np.abs(gpu.astype(np.int64) - base) > HG_CHANGED_CODES).any(axis=-1).mean())
                fig["hg_near_share"], fig["hg_changed_share"] = float(near.mean()), changed
                if near.mean() > HG_NEAR_SHARE or changed < 0.05:
                    broke.append(f"{name} {precision}: near {float(near.mean()):.3f}, changed {changed:.3f}")
                diff = diff[~near]
            full = np.abs(gpu.astype(np.int64) - cpu.astype(np.int64))
            reading = [int(diff.max()), float(full.mean() if name != "hg_direct" else diff.mean())]
            fig[f"card_vs_cpu_{precision}"] = rounded([reading])[0]
            fig[f"unclipped_{precision}"] = round(float(((gpu > 0) & (gpu < 65535)).mean()), 4)
            bound = (4, None) if precision == "fp32" else VARIANT_BF16_CODES.get(name, NAT_BF16_CODES)
            if breaks(reading, bound):
                broke.append(f"{name} {precision}: card against CPU {rounded([reading])[0]} beyond {bound}")
            del gproc, cproc
        proc = HDRTVNetTorch(path, persistent_cache=False)
        x = proc.put_frame(big)
        eager = proc._rgb48_eager(x)  # warm
        torch.cuda.synchronize()
        native.reset_launch_counts()
        eager = proc._rgb48_eager(x)
        torch.cuda.synchronize()
        got = read_counts(native)
        counts = {k: counts[k] + got[k] for k in KERNEL_INFO}
        if got != expected or not proc.natural(fh, fw):
            broke.append(f"{name}: one 1080p frame launched { {k: v for k, v in got.items() if v} }")

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(VARIANT_FRAMES):
                out = fn(x)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / VARIANT_FRAMES, out

        eager_ms, _ = timed(proc._rgb48_eager)
        first = proc.process_rgb48_device(x)
        replay_ms, replay = timed(proc.process_rgb48_device)
        equal = torch.equal(first, eager) and torch.equal(replay, eager)
        if not equal:
            broke.append(f"{name}: a 1080p replay differs from the eager frame")
        o = eager.to(torch.int32)
        fig.update({"eager_ms": round(eager_ms, 3), "replay_ms": round(replay_ms, 3), "replay_equal": equal,
                    "range": [int(o.min()), int(o.max())]})
        raw = "" if name == "hg_direct" else (f"; the model's output before the clip max |card - cpu| fp32 "
                                               f"{fig['raw_card_vs_cpu_fp32'][0]:.2e}, bf16 "
                                               f"{fig['raw_card_vs_cpu_fp16'][0]:.2e} (max |y| "
                                               f"{fig['raw_card_vs_cpu_fp32'][1]})")
        log(f"{name}: card against CPU {h}x{w} fp32 {fig['card_vs_cpu_fp32']}, bf16 {fig['card_vs_cpu_fp16']} "
            f"(max, mean codes; unclipped {fig['unclipped_fp32']}){raw}; 1080p bf16 eager {eager_ms:.3f} / replay "
            f"{replay_ms:.3f} ms/frame over {VARIANT_FRAMES} frames each, replays equal to eager: {equal}; "
            f"launches of one frame { {k: v for k, v in got.items() if v} }")
        proc.graphs.clear()
        del proc, x, eager, first, replay, o
        torch.cuda.empty_cache()
    if broke:
        raise AssertionError("phase 10 variants: " + "; ".join(broke))
    return figures, counts


def phase_metrics(torch, np, frames: dict) -> dict:
    """Phase 10 (e): full_reference_metrics on the card on the 1080p pair of phase 10 (a)
    (the bf16 default frame against the fp32 frame, u16 codes / 65535) against the port on
    the CPU within METRIC_TOL, ms per pair by CUDA events; the metrics golden on the card
    within tests/test_ops.py's tolerances."""
    from hdrtv_tpu_torch.ops.metrics import delta_e_itp_unit, full_reference_metrics, psnr, ssim

    log("phase 10: full_reference_metrics on the card, 1080p bf16 default against fp32")
    pred = frames["fp16"].float() / 65535.0
    ref = frames["fp32"].float() / 65535.0
    card = {k: float(v) for k, v in full_reference_metrics(pred, ref).items()}
    cpu = {k: float(v) for k, v in full_reference_metrics(pred.cpu(), ref.cpu()).items()}
    ms = time_ms(lambda: full_reference_metrics(pred, ref), torch)
    apart = {k: abs(card[k] - cpu[k]) / (abs(cpu[k]) if k.startswith("delta") else 1.0) for k in card}
    log(f"metrics card {json.dumps({k: round(v, 6) for k, v in card.items()})}; |card - cpu| (ΔEITP relative) "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in apart.items()})}; {ms:.3f} ms per 1080p pair")
    bad = [k for k in card if apart[k] > METRIC_TOL[k]]
    with np.load(os.path.join(ROOT, "tests", "fixtures", "metrics_golden.npz")) as z:
        fx = {k: z[k] for k in z.files}
    gp = torch.from_numpy(fx["pred_bgr"][..., ::-1].astype(np.float32) / 65535.0).to(DEVICE)
    gr = torch.from_numpy(fx["ref_bgr"][..., ::-1].astype(np.float32) / 65535.0).to(DEVICE)
    g = {"psnr": float(psnr(gp, gr)), "ssim": float(ssim(gp, gr)),
         "delta_e_itp": float(delta_e_itp_unit(gp, gr, peak_nits=1000.0))}
    expect = float(fx["delta_e_itp"])
    gerr = {"psnr": abs(g["psnr"] - float(fx["psnr"])), "ssim": abs(g["ssim"] - float(fx["ssim"])),
            "delta_e_itp": abs(g["delta_e_itp"] - expect)}
    log(f"metrics golden on the card: |card - golden| psnr {gerr['psnr']:.2e} (< 1e-3), ssim {gerr['ssim']:.2e} "
        f"(< 1e-4), delta_e_itp {gerr['delta_e_itp']:.2e} (< {max(5e-3, expect * 1e-3):.2e})")
    if bad or gerr["psnr"] >= 1e-3 or gerr["ssim"] >= 1e-4 or gerr["delta_e_itp"] >= max(5e-3, expect * 1e-3):
        raise AssertionError(f"metrics: card against CPU beyond {METRIC_TOL} on {bad}; golden errors {gerr}")
    return {"card": card, "card_vs_cpu": apart, "ms_per_1080p_pair": round(ms, 3), "golden_err": gerr}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    import shutil
    import tempfile

    sys.path.insert(0, ROOT)
    try:
        from hdrtv_tpu_torch.models.layers import fp32_math
        from hdrtv_tpu_torch.ops import native
        from hdrtv_tpu_torch.tools.synth_hg import write_synth_hg
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script ({e}); run it from the root of a checkout "
              "of the repository", file=sys.stderr)
        return 3

    smi = phase_card(torch, native)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # The repository ships no HG weights: the HG paths run the real base model under a
        # synthetic generator at the reference width, made from a seed.
        # The int8 composite puts the same generator over the W8A8 base (its sidecar's arch).
        hg_weights = {
            "float": write_synth_hg(os.path.join(tmp, "synth_hg64.npz"), nf=64, seed=0),
            "int8": write_synth_hg(os.path.join(tmp, "synth_hg64_int8.npz"), nf=64, seed=0, base_path=INT8_WEIGHTS),
        }
        with fp32_math():
            totals = phase_kernels(torch, np)
            phase_end_to_end(torch, np, hg_weights)
            phase_natural_end_to_end(torch, np, hg_weights)
            graphs = {}
            counts = {path: phase_1080p(torch, np, native, path, hg_weights, smi, graphs) for path in PATHS}
            counts.update({path: phase_natural_540p(torch, np, native, path, smi, graphs) for path in NAT_PATHS})
            runtime = phase_runtime(torch, np, native, smi)
            counts.update(phase_color(torch, np, native))
            counts.update(phase_forms(torch, np, native))
            counts[PROBE_PATH] = phase_probes(torch, np, native)
            pipe_counts, pipeline = phase_pipeline(torch, np, native, smi, tmp)
            counts.update(pipe_counts)
            t10 = time.perf_counter()
            models, frames = phase_checkpoints(torch, np, native, smi, tmp)
            models["variants"], counts["variants_bf16"] = phase_variants(torch, np, native, smi, tmp)
            models["metrics"] = phase_metrics(torch, np, frames)
            models["phase_s"] = round(time.perf_counter() - t10, 1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def entry(name, dtype, path):
        tot = totals[(name, dtype, path)]
        _, b_by = bound(tot["bytes"], tot["flops"], tot["rate"], tot["fma_flops"])
        e = {"max_abs_err": tot["max_abs_err"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
             "bound_ms": tot["bound_ms"], "bound_by": b_by,
             "library_ms": tot["library_ms"] if tot["lib_all"] else None}
        if "bound_fma_ms" in tot:  # the 3×TF32 tile: the FMA units' bound beside it
            e["bound_fma_ms"] = tot["bound_fma_ms"]
        if "cold_ms" in tot:  # pack_rgb48: on inputs the L2 does not hold
            e["cold_ms"] = tot["cold_ms"]
        if "torch_seq_ms" in tot:  # the probes: the torch-op sequence of the same function
            e["torch_seq_ms"] = tot["torch_seq_ms"]
        return e

    # One entry per kernel and element type that a path runs, reporting the
    # first path of that element type that launches it: fp32 the fp32 path,
    # bf16 the megakernel path (the default) or the path without the
    # megakernels; hg_tail the HG paths; colorimetric its own drive. Times are
    # per frame of the reported path. The fp32 instances of the kernels no
    # fp32 path runs ride along under "off_path" (compared and timed at the
    # same shapes, launched by no path).
    prefer = {"f32": ("fp32", "hg_fp32", "int8_fp32", "color_f32", "forms_f32"),
              "bf16": ("bf16_mega", "bf16_nomega", "hg_bf16", "int8_bf16_mega", "int8_bf16_nomega",
                       "int8_down2_bf16_mega", "int8_hg_bf16", "color_bf16", "forms_bf16", PROBE_PATH)}
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        for dtype, paths in prefer.items():
            path = next((p for p in paths if counts[p][name]), None)
            if path is None:
                continue
            k = {"name": f"{name}_{dtype}", "dtype": dtype, "route": "cuda", "source": source,
                 "replaces": replaces, "path": path, "launches": counts[path][name],
                 "launches_by_path": {p: counts[p][name] for p in counts}, **entry(name, dtype, path)}
            if (dtype == "bf16" and not any(counts[p][name] for p in prefer["f32"])
                    and (name, "f32", path) in totals):
                k["off_path"] = {"dtype": "f32", **entry(name, "f32", path)}
            kernels.append(k)
    if len(kernels) != 33:
        raise AssertionError(f"{len(kernels)} kernel entries, expected 33: {[k['name'] for k in kernels]}")
    log(json.dumps({"graphs": graphs, "runtime": runtime}))
    log(json.dumps({"pipeline": pipeline}))
    log(json.dumps({"models": models}))
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
