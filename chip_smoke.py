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
   cond_chain (in fp32 its 3×TF32 instance, csrc/chain_tf32x3.cuh, with a
   "cond_chain_split" line per type naming the tile's kernel, its error and
   the plain version's against a float64 chain (vs_fp64) and a planted fault,
   one TF32 product in place of three in the plain emulation of the tile,
   which must break the check) and the tail's SFT pass, the Hopper conv tile over the slot
   table for the tail's HR_conv2, and conv_last's tile of csrc/conv_last.cuh
   over w_last's populated slots; in fp32 the tail's three launches on the
   3×TF32 tiles: the SFT pass on csrc/sft_tf32x3.cuh, HR_conv2 on
   csrc/conv3x3_tf32x3.cuh, conv_last on its fp32 tile, csrc/conv_last.cuh
   conv_last_tf32x3_kernel, bound at the "tf32x3" rate with bound_fma_ms
   beside it) against the plain version's s2d form, and once more in the
   dense form (s2d=False), a case no path launches, with the same
   tolerances; a "tail_split" line gives each form's three launches (SFT
   pass, HR_conv2, conv_last) timed apart under torch.profiler, in fp32 s2d
   naming the three tiles (F32_TAIL_TILES). On the first WITNESS_ROWS image
   rows the fp32 s2d tail's unpacked y and the plain version's are held to
   float64 (vs_fp64, information), and planted faults of the plain version
   are reported: conv_last cut to one TF32 product must break the 1-code
   check; HR_conv2 cut so is reported with its margin.
   In bf16 the s2d tail runs once more unpacked, as the HG composite calls
   it: y in bf16 within that code bound in value plus one bf16 step of y, on
   at most TAIL_BF16_SHARE of the values, with its own "tail_split" line;
   a "conv_last" line per type gives the third launch alone: its device ms
   (s2d and dense), its bound, the plain version's time on the plain h, and
   F.conv2d's on its conv part alone (no single PyTorch call packs).
   sft_conv3 and resblock likewise run in the s2d form both bf16 programs
   call (s2d=True: in bf16 the SFT passes on the row tile, resblock's SFT2
   reading the fp32 h1, the convs on the Hopper conv tile over the slot
   table, resblock's conv1 storing h1 in fp32; in fp32 the SFT passes on the
   row tile's 3×TF32 instance, csrc/sft_tf32x3.cuh, and the convs on the
   3×TF32 conv tile, bound at the "tf32x3" rate with bound_fma_ms beside it)
   and once more in the dense form, with the same tolerances;
   "sft_conv3_split" and "resblock_split" lines give each case's SFT and
   conv launches apart, by kernel name (fp32 s2d: sft_tf32x3_kernel and
   conv3x3_tf32x3_kernel, which they must name). In fp32, sft_conv3's SFT
   pass alone (its t, from the same launch with a t the script keeps) and
   its output are held to float64 (vs_fp64, information); on the first
   WITNESS_ROWS image rows of the L0 case a planted fault of the plain
   version, its conv cut to one TF32 product, must break the check, and for
   both kernels the SFT passes cut to one TF32 product are reported with
   their margin (they stay inside 1e-4: the 16-deep products are small);
   resblock's planted fault, at trunk5 + up_coarse, takes the residual from
   x in place of xsum.
   resblock also runs, in bf16 and the s2d form, at the blocks of the 720p
   program that phase 13 drives (L1 180 × 320 with and without up_coarse,
   L2 90 × 160 with and without x_add: trunk2 and trunk4 take the kernel at
   720p only), with the same tolerance; no counted path launches these.
   agcm_head likewise runs in the s2d form the megakernel program calls
   (s2d=True: in bf16 the AGCM pass on the row tile, the input conv on its
   wgmma tile over the s2d slots; in fp32 their 3×TF32 instances,
   agcm_tf32x3_kernel and in_conv_tf32x3_kernel, bound at the "tf32x3"
   rate) and once more dense, an "agcm_head_split" line giving each form's
   two launches (fp32 s2d: naming both tiles, F32_HEAD_TILES); fp32's s2d
   form also on the first WITNESS_ROWS rows against float64 (vs_fp64) and
   against planted faults: the input conv's pad taken before the modulation
   must break the 1e-4 check, both passes cut to one TF32 product are
   reported with their margin; trunk3 runs on
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
   (1080, 1920, 3): ≤ 2 codes (the exact curve's codes against torch.pow's
   in fp32 under the PQ exponent 78.84), equal at 0 and 1, timed as the
   pack is (hot, cold, on the card) with its tables' build (tables_ms).
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
   in fp32; in fp32 sft_conv3_w8a8 and tail_w8a8 run the SFT pass in the
   int8-output mode of csrc/sft_tf32x3.cuh, sft_q8_f32_kernel, and the conv
   on the s8 tile's fp32-output epilogue, the tail's conv_last on its fp32
   tile, while fp32 resblock_w8a8 stays dense), and block_conv3_w8a8 with
   the programs' a_sub = 1 (the quantize
   pass, then the s8 tile, in fp32 through its fp32-output epilogue with the
   trunk conv2s' fp32 skip; up_conv2's odd 135 rows included), symmetric and
   asymmetric, and once more in the dense form (resblock_w8a8 in bf16 only),
   with the same tolerances; "sft_conv3_w8a8_split", "tail_w8a8_split" and
   "resblock_w8a8_split" lines give each case's launches apart (bf16; and
   fp32 but resblock's, whose s2d splits must name the new kernels,
   F32_Q8_SFT_TILES / F32_Q8_TAIL_TILES, the s8 tile's fp32-output instance,
   and no dense kernel), "block_conv3_w8a8_split" each case's in both
   types. For each fp32 sft_conv3_w8a8 and tail_w8a8 case, an
   "int8_f32_shares" line gives, over INT8_F32_DRAWS draws of its inputs,
   the share of outputs apart from the plain version for the s2d route
   (which must stay within INT8_SHARE), the dense route and the plain
   version fed the float mode's 3×TF32 products (sft_q8_tf32x3_emulation,
   products = 3); on the L0 sft_conv3 case and the symmetric tail, planted
   faults of the plain version: the SFT products cut to one TF32 product
   (must break the check) and quantize_code_fast's band left without its
   IEEE-division fix-up (reported).
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
   F.conv2d + F.relu + F.max_pool2d, with a_sub = 1 (the Hopper tiles' pooled
   epilogues: bf16 kEpiPool, fp32 3×TF32, int8 the wgmma s8 tile) and once
   more dense (a_sub = 0, the older tiles); cond_chain_w8a8 (steps 0 and 4
   int8 symmetric, step 2 with a zero point) at 540 × 960 × 256 on s2d
   weights, declared (s2d=True: the row tile's int8 instance; in fp32 that
   of its 3×TF32 instance) and once more dense, where a float step's sum
   order can flip a code of the next int8 step: each output within 4 flipped
   codes' worth of the last int8 step, at most COND_CHAIN_INT8_SHARE of them
   differing (in fp32 by more than ATOL). Each declared
   route prints a "block_conv3_pool_split" or "cond_chain_w8a8_split" line
   (its launches by kernel name, which must be its tile's) and holds its
   output to a planted fault of the plain version (the pool window one conv
   pixel right; step 2's zero-point correction dropped), which must break
   the check ("planted" lines).
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
   element type at their 1080p shapes on their declared routes (s2d=True,
   a_sub = 1), launch counts asserted, outputs of the right shape and
   finite;
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
   tolerances. A JSON line of these figures comes before the card's line;
11. the quality and playback benchmarks (phase_bench; BENCH_SIZE 1080p): eight
   seeded smooth textures from a list-backed source; a 10-bit 4:4:4 y4m ground
   truth written from the fp32 program on the card over them, with a planted
   lead of BENCH_OFFSET frames; run_quality_queue over the FP32, FP16 and INT8
   Full (PTQ) presets (the fp32, bf16 default and int8 default programs on
   weights/hr_fp32.npz and tests/fixtures/hr_w8a8.npz) with the frame ids
   given and post-verify on: every row recovers the offset, each hdr_convert
   equals process_rgb48 of the same frame bit for bit (and its tiff, where
   cv2 imports), the card's metrics equal evaluate_pair(device="cpu") on the
   same pair within METRIC_TOL, the fp32 rows read the 10-bit quantization
   alone (PSNR ≥ QUALITY_FP32_PSNR, derived beside it) and bf16 and int8
   read lower; the same fp32 run with post-verify off and the offset not
   given breaks that bound on every row; compare_frame on the card equals the
   bf16 quality row of its frame, and, where cv2 imports, render_session over
   the bf16 session's artifacts (the tone map on the card, within 1e-3 of the
   CPU's); run_playback_benchmark at 1080p bf16 flat
   out for PLAYBACK_S seconds of wall clock (its session files) and
   run_device_resident for RESIDENT_FRAMES chained replays; each of these five
   runs counted exactly one graph capture's launches (twice one frame's; the
   paths quality_fp32, quality_bf16, quality_int8, playback_bf16 and
   device_resident_bf16); the CLI's doctor (exit 0, naming the card), bench
   --supervised (child rc 0) and, where cv2 imports, quality in subprocesses;
   the wrapper's budget killing a silent child within WRAPPER_BUDGET_S. It
   says first whether cv2 and ffmpeg are present; a {"bench": ...} line
   (bench_line) comes before the card's line;
12. quantization, QAT and the data tooling (phase_quant; needs cv2): (a) PTQ and
   max calibration of weights/hr_fp32.npz on the fixture's three frames
   equal tests/fixtures/hr_w8a8.npz (codes and w_scale bit for bit, x_scale
   within QUANT_FIXTURE_RTOL); (b) max, percentile and kl calibration at
   QUANT_CAL_SIZE, half the layers asymmetric, card against CPU (scales
   within QUANT_CAL_RTOL, kl's bins at most QUANT_KL_BINS apart, counted);
   (c) the quantize CLI, max and kl, on three seeded 1080p natural frames
   (lossless PNGs the CLI's video source reads), timed; each checkpoint on
   the int8 default program at 1080p: one eager frame launching what
   int8_bf16_mega launches (paths quant_ptq_max, quant_ptq_kl), phase 8's
   graph drive with replays equal to the eager bytes, and the frame against
   the natural float program on the same checkpoint at most INT8_PSNR_MARGIN
   under INT8_PSNR_CPU; (d) one QAT step at QUANT_QAT_CHECK_SIZE card against
   CPU (its loss, and a seeded VJP's gradients leaf by leaf: the bounds'
   comment above phase_quant), then the qat CLI, QUANT_QAT_STEPS steps on
   540p natural frames, asymmetric: ms a step, peak memory, finite losses
   ending at most QUANT_LOSS_GROWTH times the first, its checkpoint on the
   int8 default program as in (c) (path quant_qat; its PSNR printed); (e) the
   layout CLI at its defaults, quantize --layout with it, sweep over that
   checkpoint and (c)'s max one, the card's outputs' metrics on the CPU within
   METRIC_TOL of the rows, the CPU's own rows printed beside; (f) a 1080p MJPG
   clip, teacher-pairs on it (each teacher PNG equal to process_rgb48 of its
   SDR frame), mine-hard-frames over the pairs. The phase takes at most
   QUANT_PHASE_S; a {"quant": ...} line (quant_line) comes before the card's
   line;
13. live capture, the interactive shell, the audio attach and the tab-audio
   bridge (phase_live; its checks in the comment above LIVE_FPS): the
   synthetic grabber through LiveSource into the runner, realtime, at 1080p
   (path live_bf16) and a 720p capture letterboxed onto 1080p (path
   live_letterbox), kept frames mapped back to their observations and equal
   to process_rgb48; the live CLI in a child process; a ShellController's
   keys over a running runner (path shell_swaps: a precision swap, then
   540p, 720p and 1080p), every frame against its program, the 720p replay
   against its eager bytes and a native 720p frame against the CPU's program
   (phase 3's bf16 natural bound), the pause and the paused seek's redraw, memory
   across swaps; an AudioPlayer on a fake mpv
   under an AudioAttachment; the bridge's session with a 410 after the stop.
   At most LIVE_PHASE_S; a {"live": ...} line (live_line) comes before the
   card's line.
14. the mesh (phase_mesh; its checks in the comment above MESH_SIZE): frames
   W-sharded over 2 and 4 shards on the one card (cuda:0 listed n times,
   each shard a thread on its own stream; the shard → device map printed):
   (a) every kernel call of one sharded frame held against its plain version
   at its window's shape (the shapes printed per kernel), 1080p and 4K; (b)
   the bf16 default, the int8 default, the HG composite in bf16 and fp32 and
   the fp32 program at 1080p over 2 and 4 shards against the single-device
   bytes, launches n times the single-device frame's (paths mesh_*_n2,
   mesh_*_n4), ms/frame beside the single-device one; (c) 4K over 4 shards
   (path mesh_bf16_4k_n4); (d) process_rgb48_batch over a data axis of 2
   (path mesh_dp_bf16) and the export farm as two host processes; (e) a
   planted fault (trunk3's halo one align short) that must break (b)'s
   check. At most MESH_PHASE_S; a {"mesh": ...} line (mesh_line) comes
   before the card's line.
15. the double-s2d mode (phase_dd; its checks in the comment above DD_SIZE):
   models/dd.py ensemble_dd at 1080p in bf16 and fp32: (a) every kernel call
   (down2 at down_conv2, CondNet3.2 and CondNet4.2 with a_sub = 1; resblock or
   sft_conv3; block_conv3) against its plain version at its own shape, in
   phase 2's bounds; (b) the frame against the same program on the plain
   versions, within phase 3's frame bound, and a planted fault (down_conv1's
   row taps swapped) that must break it; (c) against ensemble_s2d on the same
   frame; (d) launches asserted (paths dd_bf16, dd_fp32); (e) ms/frame and
   the device time split between the port's kernels and the torch ops; (f) a
   fresh process whose two threads make the first launch of a tile at once,
   and the device ordinals the launchers cached for. At most DD_PHASE_S; a
   {"dd": ...} line (dd_line) comes before the card's line.

The line before the last is the per-kernel JSON summary, one entry per
kernel and element type, with the path whose launches it reports and its
launches on every path; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
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
WITNESS_ROWS = 60  # image rows of fp32 cond_chain, sft_conv3 L0, agcm_head and the tail held to float64 / planted faults
# The kernels the fp32 s2d forms of sft_conv3 and resblock must launch: the SFT pass on the
# row tile's 3×TF32 instance, the convs on the 3×TF32 conv tile.
F32_SFT_TILES = ("sft_tf32x3_kernel", "conv3x3_tf32x3_kernel")
# The kernels the fp32 s2d tail must launch (the SFT pass, HR_conv2, conv_last's fp32
# tile) and the fp32 s2d agcm_head (the AGCM pass, the input conv), all 3×TF32.
F32_TAIL_TILES = ("sft_tf32x3_kernel", "conv3x3_tf32x3_kernel", "conv_last_tf32x3_kernel")
F32_HEAD_TILES = ("agcm_tf32x3_kernel", "in_conv_tf32x3_kernel")
# The kernels the fp32 int8 s2d bodies of sft_conv3 and the tail must launch (the SFT pass's
# int8-output mode, the wgmma s8 conv tile through its fp32-output epilogue; the tail's
# conv_last on its fp32 tile), and the dense kernels of those bodies, which they must not.
F32_Q8_SFT_TILES = ("sft_q8_f32_kernel", "conv3x3_s8_sm90_kernel")
F32_Q8_TAIL_TILES = (*F32_Q8_SFT_TILES, "conv_last_tf32x3_kernel")
DENSE_INT8_KERNELS = ("sft_kernel", "conv3x3_s8_kernel", "conv_last_kernel")
INT8_F32_DRAWS = 5  # draws of each fp32 int8 s2d case's inputs whose shares of differing outputs phase 2 reports
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
# next int8 step): twice the 6.8e-5 seen in bf16 (0 in fp32 on the dense chain) at 540 × 960.
# fp32's s2d route counts the outputs beyond ATOL (its float steps' 3×TF32 sums).
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
# The bf16 default program at 720p (1280 × 720, letterboxed from 1080p in phase 13): by the
# JAX routing rule every LE resblock takes the resblock kernel there (at 1080p two of them
# fall back to two sft_conv3 calls each), so sft_conv3 launches once and resblock four times.
_BF16_MEGA_720P = {**_BF16_MEGA, "sft_conv3": 1, "resblock": 4}
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
# The tiles of the fp32 instances that ride along off the path ("off_path" in the kernels
# line), where they are not the entry's own source: the s2d forms' 3×TF32 row and conv tiles,
# the tail's fp32 conv_last tile, the head's 3×TF32 AGCM pass, and the int8 bodies' row tile
# in its int8-output mode with the wgmma s8 conv tile.
OFF_PATH_SOURCE = {
    "sft_conv3_w8a8": "hdrtv_tpu_torch/csrc/sft_tf32x3.cuh + hdrtv_tpu_torch/csrc/conv3x3_s8_sm90.cuh",
    "tail_w8a8": "hdrtv_tpu_torch/csrc/sft_tf32x3.cuh + hdrtv_tpu_torch/csrc/conv3x3_s8_sm90.cuh + "
                 "hdrtv_tpu_torch/csrc/conv_last.cuh",
    "sft_conv3": "hdrtv_tpu_torch/csrc/sft_tf32x3.cuh + hdrtv_tpu_torch/csrc/conv3x3_tf32x3.cuh",
    "resblock": "hdrtv_tpu_torch/csrc/sft_tf32x3.cuh + hdrtv_tpu_torch/csrc/conv3x3_tf32x3.cuh",
    "cond_chain": "hdrtv_tpu_torch/csrc/chain_tf32x3.cuh",
    "tail": "hdrtv_tpu_torch/csrc/sft_tf32x3.cuh + hdrtv_tpu_torch/csrc/conv3x3_tf32x3.cuh + "
            "hdrtv_tpu_torch/csrc/conv_last.cuh",
    "agcm_head": "hdrtv_tpu_torch/csrc/agcm_tf32x3.cuh + hdrtv_tpu_torch/csrc/agcm_head.cu",
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
        fused_cond_chain_ref, cond_chain_tf32x3_emulation,
        fused_down2, fused_down2_ref, fused_mix_chain, fused_mix_chain_ref, fused_resblock,
        fused_hg_tail, fused_hg_tail_ref, fused_resblock_ref, fused_sft_conv3_v2, fused_sft_conv3_v2_ref,
        fused_tail, fused_tail_ref, fused_trunk3, fused_trunk3_ref, trunk3_pack, trunk3_pack_bf16,
    )
    from hdrtv_tpu_torch.ops.pack import (
        colorimetric_pq_pack, colorimetric_pq_pack_ref, colorimetric_tables, pack_rgb48, pack_rgb48_ref,
    )
    from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3_q_ref
    from hdrtv_tpu_torch.ops import native
    from hdrtv_tpu_torch.ops.megakernel import _conv_same, _s2d_slots_only, _sft_conv_t, _sft_t
    from hdrtv_tpu_torch.ops.megakernel import (
        _d2s_fine, _pack_u16, _sft_hopper, _sft_t_rows, _tf32, agcm_head_tf32x3_emulation,
        conv_last_tf32x3_emulation, fused_down2_q_ref, quantize_codes_fast, sft_q8_tf32x3_emulation,
        sft_tf32x3_emulation,
    )
    from hdrtv_tpu_torch.ops.w8a8 import _rescale, _tap_views_q, pack_qargs, pack_qargs_branches
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

    def check(y, y_ref, dtype, tol, unit="abs", share=None, above=0.0):
        """Whether ``y`` is within ``tol`` of ``y_ref`` (``unit``, ``share``
        and ``above`` as ``record`` takes them): (ok, what failed, max abs
        error, bf16 steps or None, share of the values that differ)."""
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
        differ = float((e > above).float().mean())
        if ok and share is not None and differ > share:
            ok, what = False, f"{differ:.3e} of the values differ > {share}"
        return ok, what, err, steps, differ

    def planted(kernel, dtype, fault, y, y_bad, tol, unit="abs", share=None, above=0.0, required=True):
        """A planted fault of the plain version (``y_bad``) must break the
        check that holds ``y`` to it; the script fails if it does not.
        ``required`` False: the fault is only reported, with its margin (its
        error over the tolerance)."""
        ok, what, err, _, differ = check(y, y_bad, dtype, tol, unit, share, above)
        log(json.dumps({"planted": {"kernel": kernel, "dtype": dtype, "fault": fault, "breaks": not ok,
                                    "required": required, "max_abs_err": err, "margin": err / tol,
                                    "differ": differ, "what": what}}))
        if ok and required:
            raise AssertionError(f"{kernel} {dtype}: the check does not see the planted fault '{fault}'")

    def record(kernel, dtype, case, per_path, y, y_ref, tol, ms, plain_ms, lib_ms, nbytes, flops,
               unit="abs", share=None, rate=None, extra=None, fma_flops=0.0, cold_ms=None, above=0.0):
        """``unit``: what ``tol`` bounds. "abs": the absolute error (fp32,
        and u16 codes); "steps": bf16 steps of the result; "flips": the
        absolute error of an int8 body, ``tol`` being what its flipped codes
        can move an output by, plus in bf16 one step of its rounding.
        ``share``: at most this share of the values may differ at all (by
        more than ``above``: an fp32 chain whose float steps sum in another
        order than the plain version's differs in the last bits everywhere).
        ``rate``: the peak rate of the bound's operations (default: the
        element type's), ``fma_flops`` the part of ``flops`` on the FMA units
        at any rate. ``extra``: more fields for the case's line. ``cold_ms``:
        the time on inputs the L2 does not hold (``ms`` being on one that
        stays in it), reported beside ``ms``."""
        ok, what, err, steps, differ = check(y, y_ref, dtype, tol, unit, share, above)
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

        def chain64(x, weights):
            """cond_chain's s2d form in float64: (c, cond1)."""
            v, c = x.double(), None
            for i, (w, b) in enumerate(weights):
                k, n = w.shape[0] // 4, w.shape[1] // 4
                v = (v.reshape(-1, k) @ w[:k, :n].double() + b[:n].double()).reshape(*v.shape[:-1], 4 * n)
                v = act64(v, "lrelu") if i != 4 else v
                c = v if i == 1 else c
            return c, v

        def tiles_launched(split, kernel, tiles):
            """The kernels of a launch split (by name) must include each of ``tiles``."""
            missing = [k for k in tiles if not any(n.startswith(k) for n in split["kernels"])]
            if missing:
                raise AssertionError(f"{kernel} {dtype} s2d did not launch {missing}: {split['kernels']}")

        def q8_f32_route(split, kernel, tiles):
            """An fp32 int8 s2d split: ``tiles`` launched, the s8 conv tile's instance the
            fp32-output one (its third template argument), no dense kernel of the int8 bodies."""
            tiles_launched(split, kernel, tiles)
            names = split["kernels"]
            dense = [n for n in names if n.startswith(DENSE_INT8_KERNELS)]
            s8 = [n for n in names if n.startswith("conv3x3_s8_sm90_kernel")]
            if dense or any(n.split("<")[1].split(", ")[2] != "true" for n in s8):
                raise AssertionError(f"{kernel} f32 s2d launched {dense or s8}: {names}")

        def conv_q_codes(codes, qa):
            """The plain version's int8 3×3 conv (ops/w8a8.py _taps_conv_q) on given codes:
            the exact int32 sum (pad codes outside the image), ·yscale, + the folded bias."""
            h_, w_, c_ = codes.shape
            w9 = qa.w.reshape(qa.co, 9, c_).double()
            acc = torch.zeros((h_ * w_, qa.co), dtype=torch.float64, device=codes.device)
            for i, v in enumerate(_tap_views_q(codes, qa.pad)):
                acc += v.reshape(h_ * w_, c_).double() @ w9[:, i].T
            return _rescale(acc, qa).reshape(h_, w_, qa.co)

        def q8_faults(kernel, y, x, cond, sft, qa, finish, tol, unit, share):
            """The fp32 int8 s2d route's output ``y`` against its plain version with other codes
            for the int8 conv (``finish``: the rest of the plain version after it): the SFT
            products cut to one TF32 product (it must break the check) and quantize_code_fast's
            band left without its fix-up (reported with its margin)."""
            t_r = _sft_t_rows(x, cond, sft, torch.float32)
            for fault, codes, required in (
                    ("SFT products cut to one TF32 product", sft_q8_tf32x3_emulation(x, cond, sft, qa, products=1),
                     True),
                    ("band fix-up skipped", quantize_codes_fast(t_r, qa.scale, qa.zero, fixup=False), False)):
                planted(kernel, "f32", fault, y, finish(conv_q_codes(codes, qa)), tol, unit, share=share,
                        required=required)
                del codes

        def q8_draws(kernel, case, draw, share):
            """INT8_F32_DRAWS draws of an fp32 int8 s2d case's inputs (``draw(g)``: its s2d
            route, dense route, plain version and the plain version on the float mode's
            3×TF32 products, called on inputs drawn from the generator g): the share of
            each one's outputs that differ from the plain version's. The s2d route's must
            stay within ``share``; the others are reported."""
            g = torch.Generator(device=dev)
            out = {"s2d": [], "dense": [], "tf32x3_products": []}
            for d in range(INT8_F32_DRAWS):
                g.manual_seed(4321 + d)
                y_s2d, y_dense, y_r, y_3 = draw(g)
                for key, v in (("s2d", y_s2d), ("dense", y_dense), ("tf32x3_products", y_3)):
                    out[key].append(float((v.float() != y_r.float()).float().mean()))
                del y_s2d, y_dense, y_r, y_3
            log(json.dumps({"int8_f32_shares": {"kernel": kernel, "case": case, "draws": INT8_F32_DRAWS,
                                                "share": share, **out}}))
            if max(out["s2d"]) > share:
                raise AssertionError(f"{kernel} f32 {case}: {max(out['s2d']):.3e} of the outputs differ > {share}")

        def sft_conv3_t(x, cond, sft, w, b):
            """t of fp32 sft_conv3's s2d call on the card: the wrapper's launch
            (its route and table) with a t the script keeps."""
            hb_, wb_, c = x.shape
            cc = cond.shape[-1]
            hopper, table, per_list = _sft_hopper("sft_conv3", True, torch.float32, cc, c, c)
            t_, y_ = torch.empty_like(x), torch.empty_like(x)
            native.launch("sft_conv3", torch.float32, x.data_ptr(), cond.data_ptr(),
                          native.pointer_array([p for pair in sft for p in pair]), w.data_ptr(), b.data_ptr(),
                          None, None, y_.data_ptr(), t_.data_ptr(), hb_, wb_, c, cc, c, 0, hopper, table, per_list,
                          native.stream_of(x))
            return t_

        def sft64(x, cond, sft):
            """The s2d SFT pass in float64: t."""
            def rows(v, w, b):
                k, n = w.shape[0] // 4, w.shape[1] // 4
                return (v.reshape(-1, k) @ w[:k, :n].double() + b[:n].double()).reshape(*v.shape[:-1], 4 * n)

            cd = cond.double()
            hs, hh = act64(rows(cd, *sft[0]), "lrelu"), act64(rows(cd, *sft[2]), "lrelu")
            return x.double() * (rows(hs, *sft[1]) + 1.0) + rows(hh, *sft[3])

        def sft_conv3_f32_witness(x, cond, sft, w, b, relu, sk, y, y_r):
            """fp32 sft_conv3's SFT pass alone (t, the kernel's and the plain
            version's) and its output against float64 (information)."""
            t64 = sft64(x, cond, sft)
            t_, t_r = sft_conv3_t(x, cond, sft, w, b), _sft_t_rows(x, cond, sft, torch.float32)
            out = {"sft_pass_vs_fp64": vs_fp64(t_, t_r, t64)["vs_fp64"]}
            del t_, t_r
            ws = _s2d_slots_only(w).double().permute(3, 2, 0, 1)
            y64 = F.conv2d(t64[None].permute(0, 3, 1, 2), ws, b.double(), padding=1)[0].permute(1, 2, 0)
            del t64
            out.update(vs_fp64(y, y_r, act64(y64 if sk is None else y64 + sk.double(), "relu" if relu else None)))
            return out

        def sft_conv3_f32_faults(x, cond, sft, w, b, relu):
            """fp32 sft_conv3's s2d call on these rows against two faults of
            its plain version: the SFT pass cut to one TF32 product (reported
            with its margin) and the conv cut to one TF32 product (its
            operands rounded to TF32, big·big alone: it must break)."""
            y = fused_sft_conv3_v2(x, cond, sft, w, b, relu=relu, s2d=True)
            ws = _s2d_slots_only(w)

            def act(v):
                return torch.clamp_min(v, 0.0) if relu else v

            y_bad = act(_conv_same(sft_tf32x3_emulation(x, cond, sft, products=1), ws, b))
            planted("sft_conv3", "f32", "SFT pass cut to one TF32 product", y, y_bad, ATOL, required=False)
            y_bad = act(_conv_same(_tf32(_sft_t_rows(x, cond, sft, torch.float32)), _tf32(ws), b))
            planted("sft_conv3", "f32", "conv cut to one TF32 product", y, y_bad, ATOL)

        def resblock_f32_faults(args, up, add, y, y_r):
            """fp32 resblock's s2d call against faults of its plain version: its
            SFT passes cut to one TF32 product (reported with its margin)
            and, with a second input, the residual taken from x in place of
            xsum (it must break)."""
            x, cond, sft1, w1, b1, sft2, w2, b2 = args
            xin = x if up is None and add is None else x + (_d2s_fine(up) if up is not None else add)
            h1 = torch.clamp_min(_conv_same(sft_tf32x3_emulation(xin, cond, sft1, products=1), _s2d_slots_only(w1),
                                            b1), 0.0)
            y_bad = _conv_same(sft_tf32x3_emulation(h1, cond, sft2, products=1), _s2d_slots_only(w2), b2) + xin
            planted("resblock", "f32", "SFT passes cut to one TF32 product", y, y_bad, ATOL, required=False)
            if xin is not x:
                planted("resblock", "f32", "residual x in place of xsum", y, y_r - (xin - x), ATOL)

        def head64(xs, hargs, scale):
            """agcm_head's s2d form in float64: (fea, c0, agcm) joined."""
            mods, aw1, ab1, aw2, ab2, aw3, ab3, w_in, b_in = [p.double() for p in hargs]
            x = torch.cat([xs[:, 0], xs[:, 1]], dim=-1) if xs.ndim == 4 else xs
            hb_, wb_, _ = x.shape
            v = x.reshape(-1, 12).double() * scale

            def rows(v, w, b):
                k, n = w.shape[0] // 4, w.shape[1] // 4
                return (v.reshape(-1, k) @ w[:k, :n] + b[:n]).reshape(*v.shape[:-1], 4 * n)

            def mod(v, row, width):
                return v * (mods[row, :width] + 1.0) + mods[row + 1, :width]

            a = act64(mod(rows(v, aw1, ab1), 0, aw1.shape[1]), "relu")
            b = act64(mod(rows(a, aw2, ab2), 2, aw2.shape[1]), "relu")
            agcm = mod(rows(b, aw3, ab3), 4, 12).reshape(hb_, wb_, 12)
            nf = 128
            w = torch.cat([_s2d_slots_only(w_in[..., :nf]), _s2d_slots_only(w_in[..., nf:])], dim=-1)
            acc = F.conv2d(agcm.permute(2, 0, 1)[None], w.permute(3, 2, 0, 1), b_in, padding=1)[0].permute(1, 2, 0)
            return joined((act64(acc[..., :nf], "relu"), act64(acc[..., nf:], "lrelu"), agcm))

        def head_f32_faults(xs, hargs, scale, y):
            """fp32 agcm_head's s2d call on these rows against faults of its
            plain version: the input conv's 'same' pad taken before the
            modulation (the AGCM of a zero pixel around the image, not zero:
            it must break) and both passes cut to one TF32 product (reported
            with its margin)."""
            mods, aw1, ab1, aw2, ab2, aw3, ab3, w_in, b_in = hargs
            x = torch.cat([xs[:, 0], xs[:, 1]], dim=-1) if xs.ndim == 4 else xs
            x_pad = F.pad(x, (0, 0, 1, 1, 1, 1))  # zero pixels around the frame, then AGCM over them
            agcm_pad = fused_agcm_head_ref(x_pad, *hargs, n_first=128, scale=scale, s2d=True)[2]
            w = torch.cat([_s2d_slots_only(w_in[..., :128]), _s2d_slots_only(w_in[..., 128:])], dim=-1)
            acc = F.conv2d(agcm_pad.permute(2, 0, 1)[None], w.permute(3, 2, 0, 1), b_in)[0].permute(1, 2, 0)
            y_bad = (torch.clamp_min(acc[..., :128], 0.0), F.leaky_relu(acc[..., 128:], 0.1),
                     agcm_pad[1:-1, 1:-1])
            planted("agcm_head", "f32", "input conv's pad taken before the modulation", joined(y), joined(y_bad), ATOL)
            y_bad = agcm_head_tf32x3_emulation(xs, *hargs, n_first=128, scale=scale, products=1)
            planted("agcm_head", "f32", "both passes cut to one TF32 product", joined(y), joined(y_bad), ATOL,
                    required=False)

        def tail64(s_, up, cond, skip, targs):
            """The fp32 s2d tail in float64, unpacked: y."""
            _, _, _, sft, w_hr, b_hr, w_last, b_last = targs
            x = s_.double() + _d2s_fine(up).double()
            t64 = sft64(x, cond, sft)

            def conv64(v, w, b):
                ws = _s2d_slots_only(w).double().permute(3, 2, 0, 1)
                return F.conv2d(v.permute(2, 0, 1)[None], ws, b.double(), padding=1)[0].permute(1, 2, 0)

            return conv64(act64(conv64(t64, w_hr, b_hr), "relu"), w_last, b_last) + skip.double()

        def tail_f32_faults(s_, up, cond, skip, targs, y):
            """fp32 tail's s2d call (packed) on these rows against faults of its
            plain version: conv_last cut to one TF32 product (it must break the
            1-code check) and HR_conv2 cut so (reported with its margin)."""
            _, _, _, sft, w_hr, b_hr, w_last, b_last = targs
            sf = s_ + _d2s_fine(up)
            t_ = _sft_t_rows(sf, cond, sft, torch.float32)
            h = torch.clamp_min(_conv_same(t_, _s2d_slots_only(w_hr), b_hr), 0.0)
            y_bad = conv_last_tf32x3_emulation(h, w_last, b_last, skip, pack=True, products=1)
            planted("tail", "f32", "conv_last cut to one TF32 product", y.to(torch.int32), y_bad.to(torch.int32), 1)
            h = torch.clamp_min(_conv_same(_tf32(t_), _tf32(_s2d_slots_only(w_hr)), b_hr), 0.0)
            y_bad = conv_last_tf32x3_emulation(h, w_last, b_last, skip, pack=True)
            planted("tail", "f32", "HR_conv2 cut to one TF32 product", y.to(torch.int32), y_bad.to(torch.int32), 1,
                    required=False)

        def joined(outs):
            return torch.cat([o.reshape(-1) for o in outs])

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
        # table; fp32: the SFT on the row tile's 3×TF32 instance, the conv on the 3×TF32 tile),
        # then the dense form once (no path launches it)
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
            for s2d in (True, False):
                def call(s2d=s2d):
                    return fused_sft_conv3_v2(x, cond, sft, w, b, relu=relu, skip=sk, s2d=s2d)

                def call_plain(s2d=s2d):
                    return fused_sft_conv3_v2_ref(x, cond, sft, w, b, relu=relu, skip=sk, s2d=s2d)

                y, y_r = call(), call_plain()
                ms, plain = time_ms(call, torch), time_ms(call_plain, torch)
                split = launch_split(call, torch, SFT_CONV_PARTS)
                log(json.dumps({"sft_conv3_split": {"case": name, "dtype": dtype, "s2d": s2d, **split}}))
                extra = None
                if dtype == "f32" and s2d:
                    tiles_launched(split, "sft_conv3", F32_SFT_TILES)
                    extra = sft_conv3_f32_witness(x, cond, sft, w, b, relu, sk, y, y_r)
                    if name.startswith("L0"):
                        sft_conv3_f32_faults(x[:WITNESS_ROWS], cond[:WITNESS_ROWS], sft, w, b, relu)
                record("sft_conv3", dtype, f"{name} s2d={s2d}", per_path if s2d else (0, 0, 0), y, y_r,
                       ATOL if dtype == "f32" else 1, ms, plain, None, nbytes_of(x, cond, w, b, y, sk, *params),
                       2 * conv_macs(w, hb, wb, 1) + sft_flops(hb * wb, sft) + 3 * hb * wb * 128, unit,
                       rate="tf32x3" if dtype == "f32" and s2d else None, extra=extra)
            del x, cond, y, y_r, sk

        # resblock at L1 of a 1080p frame: x (270,480,128), cond (270,480,64). Then, in bf16, the
        # blocks of the 720p program (phase 13), launched by no path counted here: at L1
        # (180,320) and at L2 (90,160), where trunk2 and trunk4 (its x_add form) take the kernel
        # at 720p only (at 1080p L2 has 135 rows and they fall back to sft_conv3). These draw
        # their inputs from a copy of the generator's state, so the cases after them keep theirs.
        state = None
        for name, hb, wb, second, per_path in (
            ("L1 trunk1", 270, 480, None, (0, 1, 1)),
            ("L1 trunk5 + up_coarse", 270, 480, "up_coarse", (0, 1, 1)),
            ("720p L1 trunk1", 180, 320, None, (0, 0, 0)),
            ("720p L1 trunk5 + up_coarse", 180, 320, "up_coarse", (0, 0, 0)),
            ("720p L2 trunk2", 90, 160, None, (0, 0, 0)),
            ("720p L2 trunk4 + x_add", 90, 160, "x_add", (0, 0, 0)),
        ):
            if not any(per_path):
                if dtype == "f32":
                    continue
                state = rng.get_state() if state is None else state
            x = t(rng.rand(hb, wb, 128) - 0.3)
            cond = t(rng.rand(hb, wb, 64) - 0.3)
            up = t(rng.rand(hb // 2, wb // 2, 512) - 0.3) if second == "up_coarse" else None
            add = t(rng.rand(hb, wb, 128) - 0.3) if second == "x_add" else None
            sft1, sft2 = sft4(16, 32), sft4(16, 32)
            w1 = t(w_s2d_s1(rng.randn(3, 3, 32, 32).astype(np.float32) * 0.05))
            w2 = t(w_s2d_s1(rng.randn(3, 3, 32, 32).astype(np.float32) * 0.05))
            b1, b2 = f32(rng.randn(128) * 0.1), f32(rng.randn(128) * 0.1)
            args = (x, cond, sft1, w1, b1, sft2, w2, b2)
            params = [p for pair in (*sft1, *sft2) for p in pair]
            # the programs' s2d form (bf16: both SFT passes on the row tile, both convs on the
            # Hopper conv tile, conv1 storing h1 in fp32; fp32: the SFT passes on the row tile's
            # 3×TF32 instance, the convs on the 3×TF32 tile), then the dense form once
            for s2d in (True, False) if any(per_path) else (True,):
                def call(s2d=s2d):
                    return fused_resblock(*args, up_coarse=up, x_add=add, s2d=s2d)

                def call_plain(s2d=s2d):
                    return fused_resblock_ref(*args, up_coarse=up, x_add=add, s2d=s2d)

                y, y_r = call(), call_plain()
                ms, plain = time_ms(call, torch), time_ms(call_plain, torch)
                if any(per_path):
                    split = launch_split(call, torch, SFT_CONV_PARTS)
                    log(json.dumps({"resblock_split": {"case": name, "dtype": dtype, "s2d": s2d, **split}}))
                    if dtype == "f32" and s2d:
                        tiles_launched(split, "resblock", F32_SFT_TILES)
                if dtype == "f32" and s2d:
                    resblock_f32_faults(args, up, add, y, y_r)
                record("resblock", dtype, f"{name} s2d={s2d}", per_path if s2d else (0, 0, 0), y, y_r,
                       ATOL if dtype == "f32" else 2, ms, plain, None,
                       nbytes_of(x, cond, up, add, w1, b1, w2, b2, y, *params),
                       2 * (conv_macs(w1, hb, wb, 1) + conv_macs(w2, hb, wb, 1))
                       + sft_flops(hb * wb, sft1) + sft_flops(hb * wb, sft2) + 8 * hb * wb * 128, unit,
                       rate="tf32x3" if dtype == "f32" and s2d else None)
            del x, cond, up, add, y, y_r, args
        if state is not None:
            rng.set_state(state)
        hb, wb = 270, 480  # L1 of a 1080p frame again, for mix_chain below

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

        # the program's s2d form (bf16: the AGCM pass on the row tile, the input conv on its wgmma
        # tile over the slots; fp32: their 3×TF32 instances, bound at the "tf32x3" rate, which
        # the split must name), then the dense form once (no path launches it). fp32's s2d form
        # also on the first WITNESS_ROWS rows: its error and the plain version's against float64
        # (vs_fp64, information), and planted faults (head_f32_faults)
        for s2d in (True, False):
            def head(s2d=s2d):
                return fused_agcm_head(xs, *hargs, n_first=128, scale=1.0 / 255.0, packed=packed,
                                       packed_s2d=packed_s2d, s2d=s2d)

            def head_plain(s2d=s2d):
                return fused_agcm_head_ref(xs, *hargs, n_first=128, scale=1.0 / 255.0, s2d=s2d)

            y, y_r = head(), head_plain()
            if [tuple(o.shape) for o in y] != [(hb, wb, 128), (hb, wb, 256), (hb, wb, 12)]:
                raise AssertionError(f"agcm_head output shapes {[tuple(o.shape) for o in y]}")
            ms, plain = time_ms(head, torch), time_ms(head_plain, torch)
            split = launch_split(head, torch, HEAD_PARTS)
            log(json.dumps({"agcm_head_split": {"dtype": dtype, "s2d": s2d, **split}}))
            extra = None
            if dtype == "f32" and s2d:
                tiles_launched(split, "agcm_head", F32_HEAD_TILES)
                part = xs[:WITNESS_ROWS]
                y_p = fused_agcm_head(part, *hargs, n_first=128, scale=1.0 / 255.0, s2d=True)
                y_pr = fused_agcm_head_ref(part, *hargs, n_first=128, scale=1.0 / 255.0, s2d=True)
                extra = vs_fp64(joined(y_p), joined(y_pr), head64(part, hargs, 1.0 / 255.0))
                head_f32_faults(part, hargs, 1.0 / 255.0, y_p)
                del y_p, y_pr
            record("agcm_head", dtype, f"L0 u8 pair planes -> fea, c0, agcm s2d={s2d}", (0, 0, 1) if s2d else (0, 0, 0),
                   joined(y), joined(y_r), ATOL if dtype == "f32" else 2, ms, plain, None, nbytes_of(xs, *hargs, *y),
                   2 * npix * nnz(hargs[1], hargs[3], hargs[5]) + 2 * conv_macs(w_in, hb, wb, 1)
                   + 3 * npix * (256 + 256 + 12), unit, rate="tf32x3" if dtype == "f32" and s2d else None,
                   extra=extra)
        del xs, y, y_r

        # cond_chain: c0 (540,960,256) → 256 ×4 (lrelu) → 64; c and cond1 compared as one vector.
        # The program's s2d form (s2d=True: w_s2d_1x1 weights, b_s2d biases, the first quarter
        # of each drawn bias tiled; bf16: the Hopper row tile of csrc/chain_sm90.cuh; fp32 its
        # 3×TF32 instance, csrc/chain_tf32x3.cuh, bound at the "tf32x3" rate), with a
        # "cond_chain_split" line (its launch by kernel name, which must be the tile's), then the
        # dense form once (s2d=False, the drawn biases as they are; no path launches it). fp32's
        # s2d form also on the first WITNESS_ROWS image rows: its error and the plain version's
        # against the chain in float64 (vs_fp64, information), and a planted fault (the plain
        # emulation of the tile with one TF32 product in place of three), which must break its check.
        c0 = t(rng.rand(hb, wb, 256) - 0.3)
        dense = [(p11(64, n), f32(rng.randn(4 * n) * 0.1)) for n in (64, 64, 64, 64, 16)]
        for s2d in (True, False):
            weights = [(w, b[: b.shape[0] // 4].repeat(4)) for w, b in dense] if s2d else dense
            y, y_r = fused_cond_chain(c0, weights, s2d=s2d), fused_cond_chain_ref(c0, weights, s2d=s2d)
            if [tuple(o.shape) for o in y] != [(hb, wb, 256), (hb, wb, 64)]:
                raise AssertionError(f"cond_chain output shapes {[tuple(o.shape) for o in y]}")
            ms = time_ms(lambda: fused_cond_chain(c0, weights, s2d=s2d), torch)
            plain = time_ms(lambda: fused_cond_chain_ref(c0, weights, s2d=s2d), torch)
            extra = None
            if s2d:
                split = launch_split(lambda: fused_cond_chain(c0, weights, s2d=True), torch, (("chain_ms", "chain"),))
                log(json.dumps({"cond_chain_split": {"dtype": dtype, "ms": round(ms, 4), **split}}))
                tile = "cond_chain_sm90_tf32x3_kernel" if dtype == "f32" else "cond_chain_sm90_kernel"
                if not any(k.startswith(tile) for k in split["kernels"]):
                    raise AssertionError(f"cond_chain s2d {dtype} did not launch {tile}: {split['kernels']}")
            if s2d and dtype == "f32":
                part = c0[:WITNESS_ROWS]
                y_p = fused_cond_chain(part, weights, s2d=True)
                y_bad = cond_chain_tf32x3_emulation(part, weights, products=1)
                planted("cond_chain", dtype, "3xTF32 cut to one TF32 product", joined(y_p), joined(y_bad), ATOL)
                extra = vs_fp64(joined(y_p), joined(fused_cond_chain_ref(part, weights, s2d=True)),
                                joined(chain64(part, weights)))
                del y_p, y_bad
            record("cond_chain", dtype, f"L0 c0 -> c, cond1 s2d={s2d}", (0, 0, 1) if s2d else (0, 0, 0),
                   joined(y), joined(y_r), ATOL if dtype == "f32" else 1, ms, plain, None,
                   nbytes_of(c0, *y, *[p for pair in weights for p in pair]),
                   2 * npix * nnz(*[w for w, _ in weights]), unit,
                   rate="tf32x3" if dtype == "f32" and s2d else None, extra=extra)
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
        # over the slot table, conv_last on its tile over w_last's populated slots; fp32: their
        # 3×TF32 instances, bound at the "tf32x3" rate, which the split must name), then the
        # dense form once (no path launches it). fp32's s2d form also on the first WITNESS_ROWS
        # rows: its unpacked y and the plain version's against float64 (vs_fp64, information),
        # and planted faults (tail_f32_faults)
        splits = {}
        for s2d in (True, False):
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
            extra = None
            if dtype == "f32" and s2d:
                tiles_launched(splits[s2d], "tail", F32_TAIL_TILES)
                rows_ = (s_[:WITNESS_ROWS], up[:WITNESS_ROWS // 2], cond[:WITNESS_ROWS], skip[:WITNESS_ROWS])
                pargs = (rows_[0], rows_[2], rows_[3], *targs[3:])
                extra = vs_fp64(fused_tail(*pargs, pack=False, up_coarse=rows_[1], s2d=True),
                                fused_tail_ref(*pargs, pack=False, up_coarse=rows_[1], s2d=True),
                                tail64(*rows_, targs))
                tail_f32_faults(*rows_, targs, fused_tail(*pargs, pack=True, up_coarse=rows_[1], s2d=True))
            record("tail", dtype, f"L0 fea0 + up_coarse -> packed u16 s2d={s2d}",
                   {"bf16_mega": 1} if s2d else {}, y.to(torch.int32), codes, tol, ms, plain, None,
                   nbytes_of(s_, up, cond, skip, y, *params),
                   2 * (conv_macs(w_hr, hb, wb, 1) + conv_macs(w_last, hb, wb, 1)) + sft_flops(npix, sft)
                   + 4 * npix * 128 + 5 * npix * 12, rate="tf32x3" if dtype == "f32" and s2d else None, extra=extra)
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
        else:
            # h as the fp32 s2d tail computes it: relu(HR_conv2(sft(s + d2s(up)))) over the slots
            h_plain = torch.clamp_min(_conv_same(_sft_t_rows(s_ + _d2s_fine(up), cond, sft, torch.float32),
                                                 _s2d_slots_only(w_hr), targs[5]), 0.0)
        # conv_last alone at this shape (the third launch of the s2d and dense forms above, by
        # torch.profiler): its bound (h, skip and the packed output once; the populated slots'
        # products at the bf16 rate, in fp32 at the "tf32x3" rate), the plain version's time on
        # the plain h, and F.conv2d's on its conv part alone (no single PyTorch call packs)
        w_s = _s2d_slots_only(w_last)
        b_last = targs[7]

        def last_plain():
            v = (_conv_same(h_plain.float(), w_s, b_last) + skip.float()).clamp(0.0, 1.0)
            return (v * 65535.0 + 0.5).to(torch.int32).to(torch.uint16)

        h_nchw = h_plain.permute(2, 0, 1)[None].contiguous()
        w_oihw = w_last.permute(3, 2, 0, 1).contiguous()
        lb_ms, lb_by = bound(nbytes_of(h_plain, skip, w_last, b_last) + 2 * npix * 12,
                             2 * conv_macs(w_last, hb, wb, 1), "bf16" if dtype == "bf16" else "tf32x3")
        log(json.dumps({"conv_last": {
            "dtype": dtype, "ms": splits[True]["conv_last_ms"], "dense_ms": splits[False]["conv_last_ms"],
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
        plain = time_ms(lambda: pack_rgb48_ref(v), torch)
        record("pack_rgb48", dtype, f"(1080,1920,3) {dtype} -> u16", {"fp32": 1, "bf16_nomega": 1},
               u.to(torch.int32), pack_rgb48_ref(v).to(torch.int32), 0.0, ms, plain, None,
               v.numel() * (size + 2), v.numel() * 4, cold_ms=cold, extra=on_card)

        # colorimetric: the same frame through gamma, gamut, PQ and the pack; on no frame path.
        # Timed as the pack: on the input the L2 holds (ms), on the pack's ring (cold_ms), and
        # on the card (card_ms, card_cold_ms; card_smooth_ms on phase 5's smooth frame, whose
        # 256 levels a channel keep the tables' reads in few lines). Its tables are built by the
        # first call for these parameters; tables_ms is the build's device time (the tables of
        # another peak_nits built in turns with these, so that each call builds).
        u = colorimetric_pq_pack(v)
        u_r = colorimetric_pq_pack_ref(v)
        if tuple(u.shape) != (1080, 1920, 3) or u.dtype != torch.uint16:
            raise AssertionError(f"colorimetric output {tuple(u.shape)} {u.dtype}")
        ends = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], device=dev, dtype=dt)
        if not torch.equal(colorimetric_pq_pack(ends), colorimetric_pq_pack_ref(ends)):
            raise AssertionError("colorimetric: kernel and plain version differ at 0 or 1")
        ms = time_ms(lambda: colorimetric_pq_pack(v), torch)

        def color_cold():
            return colorimetric_pq_pack(ring[next(turn) % len(ring)])

        cold = time_ms(color_cold, torch)
        smooth = (torch.as_tensor(smooth_frame(np, 1080, 1920, 5), device=dev).float() / 255.0).to(dt)
        on_card = {key: launch_split(fn, torch, (("ms", "colorimetric_kernel"),))["ms"]
                   for key, fn in (("card_ms", lambda: colorimetric_pq_pack(v)), ("card_cold_ms", color_cold),
                                   ("card_smooth_ms", lambda: colorimetric_pq_pack(smooth)))}
        peaks = iter(range(1 << 62))
        on_card["tables_ms"] = launch_split(
            lambda: colorimetric_tables(dev, (1000.0, 999.0)[next(peaks) % 2], 2.4), torch,
            (("tables_ms", "colorimetric_tables"),))["tables_ms"]
        colorimetric_tables(dev, 1000.0, 2.4)
        del ring
        plain = time_ms(lambda: colorimetric_pq_pack_ref(v), torch)
        # per pixel: 3 gamma powers, a 3×3 matrix, 3 × (2 powers, a divide, ~8 more): ~60 operations;
        # by bytes either way
        record("colorimetric", dtype, f"(1080,1920,3) {dtype} -> PQ u16", {f"color_{dtype}": 1},
               u.to(torch.int32), u_r.to(torch.int32), 2, ms, plain, None,
               v.numel() * (size + 2), v.numel() * 20, cold_ms=cold, extra=on_card)
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
        # on the wgmma s8 tile over the slot table; fp32: the SFT in the int8-output mode of
        # sft_tf32x3.cuh, the conv on the s8 tile's fp32-output epilogue), then the dense form
        # once at L0 (no path launches it)
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
            dense_once = name.startswith("L0")

            def act(v, relu=relu):
                return torch.clamp_min(v, 0.0) if relu else v

            for s2d in (True, False) if dense_once else (True,):
                def call(s2d=s2d):
                    return fused_sft_conv3_v2(x, cond, sft, w, b, relu=relu, skip=sk, qargs=qa, s2d=s2d)

                def call_plain(s2d=s2d):
                    return fused_sft_conv3_v2_ref(x, cond, sft, w, b, relu=relu, skip=sk, qargs=qa, s2d=s2d)

                y, y_r = call(), call_plain()
                ms, plain = time_ms(call, torch), time_ms(call_plain, torch)
                split = launch_split(call, torch, SFT_CONV_PARTS)
                if dtype == "f32" and s2d:
                    q8_f32_route(split, "sft_conv3_w8a8", F32_Q8_SFT_TILES)
                log(json.dumps({"sft_conv3_w8a8_split": {"dtype": dtype, "case": name, "s2d": s2d, **split}}))
                record("sft_conv3_w8a8", dtype, f"{name} s2d={s2d}", per_path if s2d else {}, y, y_r,
                       flip_tol(qa, 2), ms, plain, None, nbytes_of(x, cond, y, sk, *params) + qbytes(qa),
                       2 * conv_macs(w, hb, wb, 1) + sft_flops(hb * wb, sft) + 3 * hb * wb * 128,
                       "flips", share=INT8_SHARE["sft_conv3"], rate="int8")
                if dtype == "f32" and s2d and name.startswith("L0"):
                    q8_faults("sft_conv3_w8a8", y, x, cond, sft, qa,
                              lambda acc: act(acc if sk is None else acc + sk), flip_tol(qa, 2), "flips",
                              INT8_SHARE["sft_conv3"])
            if dtype == "f32":
                def draw(g, sk=sk, act=act, relu=relu, sft=sft, w=w, b=b, qa=qa, hb=hb, wb=wb):
                    xd = torch.rand(hb, wb, 128, generator=g, device=dev) - 0.3
                    cd = torch.rand(hb, wb, 64, generator=g, device=dev) - 0.3
                    ys = [fused_sft_conv3_v2(xd, cd, sft, w, b, relu=relu, skip=sk, qargs=qa, s2d=s2d)
                          for s2d in (True, False)]
                    y_r = fused_sft_conv3_v2_ref(xd, cd, sft, w, b, relu=relu, skip=sk, qargs=qa, s2d=True)
                    y_3 = conv_q_codes(sft_q8_tf32x3_emulation(xd, cd, sft, qa, products=3), qa)
                    return (*ys, y_r, act(y_3 if sk is None else y_3 + sk))

                q8_draws("sft_conv3_w8a8", name, draw, INT8_SHARE["sft_conv3"])
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
        # tile over the slot table; fp32: the SFT in the int8-output mode of sft_tf32x3.cuh,
        # HR_conv2 on the s8 tile's fp32-output epilogue, conv_last on its fp32 tile), then the
        # dense form once (no path launches it)
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

            def tail_after(acc, skip=skip, w_last=w_last, b_last=targs[7]):
                # the plain version after HR_conv2's rescale: ReLU, conv_last over w_last's slots, skip, pack
                return _pack_u16(_conv_same(torch.clamp_min(acc, 0.0), _s2d_slots_only(w_last), b_last) + skip)

            for s2d in (True, False) if not asym else (True,):
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
                split = launch_split(call, torch, TAIL_PARTS)
                if dtype == "f32" and s2d:
                    q8_f32_route(split, "tail_w8a8", F32_Q8_TAIL_TILES)
                log(json.dumps({"tail_w8a8_split": {"dtype": dtype, "case": name, "s2d": s2d, **split}}))
                record("tail_w8a8", dtype, f"{name} s2d={s2d}", per_path if s2d else {}, y.to(torch.int32), codes,
                       tol, ms, plain, None, nbytes_of(s_, up, cond, skip, y, *params) + qbytes(qa),
                       2 * (conv_macs(targs[4], hb, wb, 1) + conv_macs(w_last, hb, wb, 1)) + sft_flops(npix, sft)
                       + 4 * npix * 128 + 5 * npix * 12, share=INT8_SHARE["tail"], rate="int8")
                if dtype == "f32" and s2d and not asym:
                    q8_faults("tail_w8a8", y.to(torch.int32), s_ + _d2s_fine(up), cond, sft, qa,
                              lambda acc: tail_after(acc).to(torch.int32), tol, "abs", INT8_SHARE["tail"])
            if dtype == "f32":
                def draw(g, targs=targs, qa=qa, tail_after=tail_after, sft=sft):
                    sd = torch.rand(hb, wb, 128, generator=g, device=dev) - 0.3
                    ud = torch.rand(hb // 2, wb // 2, 512, generator=g, device=dev) - 0.3
                    cd = torch.rand(hb, wb, 64, generator=g, device=dev) - 0.3
                    args = (sd, cd, *targs[2:])
                    ys = [fused_tail(*args, pack=True, up_coarse=ud, qargs_hr=qa, s2d=s2d) for s2d in (True, False)]
                    y_r = fused_tail_ref(*args, pack=True, up_coarse=ud, qargs_hr=qa, s2d=True)
                    codes_3 = sft_q8_tf32x3_emulation(sd + _d2s_fine(ud), cd, sft, qa, products=3)
                    return (*ys, y_r, tail_after(conv_q_codes(codes_3, qa)))

                q8_draws("tail_w8a8", name, draw, INT8_SHARE["tail"])
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
        # level has 135 rows at 1080p, which pool_out does not take. The declared route first
        # (a_sub = 1: the Hopper tiles' pooled epilogues, bf16 kEpiPool, fp32 3xTF32, int8 the
        # wgmma s8 tile after the quantize pass), counted, with a "block_conv3_pool_split" line
        # (its launches by kernel name, which must be that tile's) and a planted fault (the
        # plain version's pool window one conv pixel to the right) that must break its check;
        # then the dense route (a_sub = 0, the older tiles), logged beside it.
        hb, wb = 270, 480
        w_nat = rng.randn(3, 3, 32, 128).astype(np.float32) * 0.05
        w = t(w_s2d_s1_ps(w_nat))
        x = t(rng.rand(hb, wb, 128) * 1.2 - 0.1)
        b = f32(rng.randn(512) * 0.1)
        wq, ws = quantize_weight(w_nat)
        tq, tsc = w_s2d_s1_ps(wq), np.tile(w_ps_permute(ws.reshape(1, 1, 1, -1))[0, 0, 0], 4)
        qa = pack_qargs(tq, tsc, 1.1 / 127.0, None, (rng.randn(512) * 0.1).astype(np.float32), dev)
        wq_f = t(tq.astype(np.float32) * tsc)
        x_nchw = x[None].permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b_lib = b.to(dt)
        lib = time_ms(lambda: F.max_pool2d(F.relu(F.conv2d(x_nchw, w_oihw, b_lib, padding=1)), 2), torch)
        pool_tile = {"f32": "conv3x3_tf32x3_kernel", "bf16": "conv3x3_sm90_kernel"}[dtype]
        for int8 in (False, True):
            kernel = "block_conv3_pool_w8a8" if int8 else "block_conv3_pool"
            kw = {"relu": True, "qargs": qa} if int8 else {"relu": True}
            wt = wq_f if int8 else w
            if int8:
                y_r = fused_block_conv3_q_ref(x, qa, relu=True, pool_out=True)
                plain = time_ms(lambda: fused_block_conv3_q_ref(x, qa, relu=True, pool_out=True), torch)
                full = fused_block_conv3_q_ref(x, qa, relu=True)
            else:
                y_r = fused_block_conv3_ref(x, w, b, relu=True, pool_out=True)
                plain = time_ms(lambda: fused_block_conv3_ref(x, w, b, relu=True, pool_out=True), torch)
                full = fused_block_conv3_ref(x, w, b, relu=True)
            # the planted fault: each pooled pixel's window one conv pixel to the right
            y_bad = torch.roll(full, -1, dims=1).reshape(hb // 2, 2, wb // 2, 2, 512).amax(dim=(1, 3))
            del full
            if int8:
                tol = float(np.spacing(np.float32(max(1.0, float(y_r.float().abs().max()))))) if dtype == "f32" else 1
                unit_ = "abs" if dtype == "f32" else "steps"
            else:
                tol, unit_ = ATOL if dtype == "f32" else 1, unit
            for a_sub in (1, 0):
                def call(a_sub=a_sub, kw=kw, wt=wt):
                    return fused_block_conv3(x, wt, b, pool_out=True, a_sub=a_sub, **kw)

                y = call()
                if tuple(y.shape) != (hb // 2, wb // 2, 512):
                    raise AssertionError(f"{kernel} output {tuple(y.shape)}")
                ms = time_ms(call, torch)
                if a_sub:
                    split = launch_split(call, torch, QCONV_PARTS if int8 else (("conv_ms", "conv3x3"),))
                    tile = "conv3x3_s8_sm90_kernel" if int8 else pool_tile
                    log(json.dumps({"block_conv3_pool_split": {"dtype": dtype, "int8": int8, "a_sub": a_sub,
                                                               "ms": round(ms, 4), **split}}))
                    if not any(k.startswith(tile) for k in split["kernels"]):
                        raise AssertionError(f"{kernel} {dtype} a_sub=1 did not launch {tile}: {split['kernels']}")
                    planted(kernel, dtype, "pool window one conv pixel right", y, y_bad, tol, unit_)
                record(kernel, dtype, f"L1 up_conv3 shape + 2x2 max pool{', int8' if int8 else ''} a_sub={a_sub}",
                       {f"forms_{dtype}": 1} if a_sub else {}, y, y_r, tol, ms, plain, None if int8 else lib,
                       nbytes_of(x, y) + qbytes(qa) if int8 else nbytes_of(x, w, b, y),
                       2 * conv_macs(wt, hb, wb, 1), unit_,
                       rate="int8" if int8 else "tf32x3" if dtype == "f32" and a_sub else None)
                del y
            del y_r, y_bad
        del x, w, wq_f, x_nchw, w_oihw

        # cond_chain_w8a8: c0 (540, 960, 256) -> 256 x4 -> 64, steps 0 and 4 int8 symmetric,
        # step 2 int8 with a zero point, each calibrated on the float chain's value there; s2d
        # weights and biases. In bf16 the declared route first (s2d=True: the row tile's int8
        # instance; fp32: that of the 3×TF32 instance), counted, with a "cond_chain_w8a8_split"
        # line and a planted fault (step 2's zero-point correction dropped from its folded bias)
        # that must break its check, then the dense chain (s2d=False), logged beside it. On fp32's
        # row tile the float steps sum in another order than the plain version's, so every value
        # may differ in its last bits: its share counts those beyond ATOL, the float chain's bound
        # (the dense chain's, as before, every value that differs).
        hb, wb = 540, 960
        c0 = t(rng.rand(hb, wb, 256) - 0.3)
        nat = [quantize_weight(rng.randn(1, 1, 64, n).astype(np.float32) * 0.15) for n in (64, 64, 64, 64, 16)]
        tqs = [w_s2d_1x1(q) for q, _ in nat]
        tscs = [b_s2d(sc) for _, sc in nat]
        bnps = [b_s2d((rng.randn(q.shape[-1] // 4) * 0.1).astype(np.float32)) for q in tqs]
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
        flops = 2 * hb * wb * nnz(*[w_ for w_, _ in weights])
        wbytes = (sum(nbytes_of(w_, b_) for (w_, b_), q in zip(weights, qargs) if q is None)
                  + qbytes(*[q for q in qargs if q is not None]))
        for s2d in (True, False):
            above = ATOL if dtype == "f32" and s2d else 0.0

            def call(s2d=s2d):
                return fused_cond_chain(c0, weights, qargs=qargs, s2d=s2d)

            y = call()
            y_r = fused_cond_chain_ref(c0, weights, qargs, s2d=s2d)
            ms = time_ms(call, torch)
            plain = time_ms(lambda: fused_cond_chain_ref(c0, weights, qargs, s2d=s2d), torch)
            if s2d:
                split = launch_split(call, torch, (("chain_ms", "chain"),))
                log(json.dumps({"cond_chain_w8a8_split": {"dtype": dtype, "s2d": s2d, "ms": round(ms, 4), **split}}))
                tile = "cond_chain_sm90_tf32x3_kernel" if dtype == "f32" else "cond_chain_sm90_kernel"
                if not any(k.startswith(tile) for k in split["kernels"]):
                    raise AssertionError(f"cond_chain_w8a8 s2d did not launch {tile}: {split['kernels']}")
                unfolded = dataclasses.replace(qargs[2], bias=f32(bnps[2]))
                y_bad = fused_cond_chain_ref(c0, weights, [*qargs[:2], unfolded, *qargs[3:]], s2d=True)
                planted("cond_chain_w8a8", dtype, "step 2's zero-point correction dropped", joined(y),
                        joined(y_bad), flip_tol(qargs[4], 4), "flips", COND_CHAIN_INT8_SHARE, above)
                del y_bad
            record("cond_chain_w8a8", dtype, f"L0 c0 -> c, cond1, steps 0/2/4 int8 s2d={s2d}",
                   {f"forms_{dtype}": 1} if s2d else {}, joined(y), joined(y_r),
                   flip_tol(qargs[4], 4), ms, plain, None, nbytes_of(c0, *y) + wbytes, flops, "flips",
                   share=COND_CHAIN_INT8_SHARE, above=above,
                   rate="int8")
            del y, y_r
        del c0, weights

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
    cond_chain's int8 steps (c0 (540, 960, 256), steps 0/2/4 int8; s2d
    weights, declared: the row tile's int8 instance, in fp32 that of its
    3×TF32 instance), and
    block_conv3's pool_out form, float and int8 (L1 up_conv3's (270, 480, 128)
    -> 512, PS-folded, a_sub = 1: the Hopper tiles' pooled epilogues);
    returns the counts by drive."""
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
            bnp = b_s2d((rng.randn(n) * 0.1).astype(np.float32))
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
        c, cond1 = fused_cond_chain(c0, steps, qargs=qargs, s2d=True)
        pooled = fused_block_conv3(x, w, b, relu=True, pool_out=True, a_sub=1)
        pooled_q = fused_block_conv3(x, w, b, relu=True, qargs=qa, pool_out=True, a_sub=1)
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


# Phase 11: the quality and playback benchmarks (bench/quality.py, pipeline/compare.py,
# bench/playback.py, bench/wrapper.py, runtime/doctor.py and the CLI commands on them).
# Eight seeded 1080p frames, each a smooth texture of its own (so that adjacent frames differ
# and the ±2 offset search cannot tie), from a list-backed source; the ground truth is the
# port's fp32 program on the card over those frames, written as 10-bit 4:4:4 y4m with a
# planted lead of BENCH_OFFSET frames. The fp32 preset's rows then read the y4m's 10-bit
# quantization alone: in limited range a code step is 1/876 of Y' and 1/896 of Cb/Cr, so
# each decoded RGB channel is within half a step of Y' plus its matrix weight of half a
# chroma step (BT.2020: R 1.4746·Cr, G 0.1646·Cb + 0.5714·Cr, B 1.8814·Cb), at most
# 0.5/876 + 1.8814·0.5/896 = 1.621e-3. The crop and the area resize average values and keep
# that bound, so the fp32 rows' PSNR is at least 20·log10(1/1.621e-3) = 55.8 dB
# (QUALITY_FP32_PSNR); misaligned by one frame, it falls far below.
BENCH_SIZE = (1080, 1920)
BENCH_FRAMES = 8
BENCH_OFFSET = 1
QUALITY_FP32_PSNR = 55.8
# The presets of the quality queue: (preset key, checkpoint, the phase-4 path whose program
# process_rgb48 runs at 1080p); the counts' path name.
QUALITY_PRESETS = {
    "quality_fp32": ("FP32", WEIGHTS, "fp32"),
    "quality_bf16": ("FP16", WEIGHTS, "bf16_mega"),
    "quality_int8": ("INT8 Full (PTQ)", INT8_WEIGHTS, "int8_bf16_mega"),
}
PLAYBACK_S = 5.0
RESIDENT_FRAMES = 300
WRAPPER_BUDGET_S = (2.0, 3.0)  # the silent child's budget, and the most the kill may take
# The keys of the {"bench": ...} line (bench_line).
BENCH_KEYS = ("card", "cv2", "ffmpeg", "quality", "planted", "compare", "playback", "device_resident", "cli",
              "wrapper", "phase_s")


def bench_texture(np, h: int, w: int, seed: int):
    """A smooth u8 BGR texture of its own for each seed: three random sinusoids a channel
    over a mid-grey, no noise."""
    rng = np.random.RandomState(seed)
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        acc = np.full((h, w), 0.5, np.float32)
        for _ in range(3):
            fy, fx = rng.uniform(0.5, 5.0, 2)
            acc += rng.uniform(0.05, 0.15) * np.sin(2 * np.pi * (fy * yy + fx * xx) + rng.uniform(0, 2 * np.pi))
        img[..., c] = acc
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


class ListSource:
    """A source over a list of BGR u8 frames: the quality benchmark's seek / read_with_meta."""

    def __init__(self, frames, fps: float = 30.0):
        self.frames, self.fps, self.frame_count, self.pos = frames, fps, len(frames), 0

    def seek(self, idx: int) -> None:
        self.pos = int(idx)

    def read_with_meta(self, timeout: float = 0.0):
        if not 0 <= self.pos < len(self.frames):
            return None
        idx = self.pos
        self.pos += 1
        return self.frames[idx], idx, idx / self.fps

    def close(self) -> None:
        pass


class RecordingProcessor:
    """An HDRTVNetTorch whose process_rgb48 outputs are kept (the quality rows' hdr_convert)."""

    def __init__(self, proc):
        self.proc, self.device, self.outs = proc, proc.device, []

    def process_rgb48(self, frame):
        out = self.proc.process_rgb48(frame)
        self.outs.append(out)
        return out


def bench_line(figures: dict) -> str:
    """The {"bench": ...} line of phase 11: every key of BENCH_KEYS, nothing else."""
    missing = [k for k in BENCH_KEYS if k not in figures]
    if missing or len(figures) != len(BENCH_KEYS):
        raise AssertionError(f"bench line: missing {missing}, extra {sorted(set(figures) - set(BENCH_KEYS))}")
    return json.dumps({"bench": {k: figures[k] for k in BENCH_KEYS}})


def phase_bench(torch, np, native, smi: str, tmp: str) -> tuple[dict, dict]:
    """Phase 11: the quality queue (fp32, bf16, int8 presets) against the fp32 program's y4m
    ground truth, its planted fault, compare_frame, the playback benchmark and the
    device-resident chain at 1080p bf16, the CLI's doctor, bench --supervised and (with cv2)
    quality in subprocesses, and the wrapper's budget on a silent child. Returns the five
    paths' launch counts and the phase's figures."""
    import importlib.util
    import shutil

    from hdrtv_tpu_torch.bench.gt_sync import HDRGroundTruthReader, make_frame_map
    from hdrtv_tpu_torch.bench.playback import PlaybackRunConfig, run_device_resident, run_playback_benchmark
    from hdrtv_tpu_torch.bench.quality import QualityRunConfig, evaluate_pair, run_quality_benchmark, run_quality_queue
    from hdrtv_tpu_torch.bench.wrapper import PlaybackBenchmarkWrapper
    from hdrtv_tpu_torch.bench.y4m import Y4MWriter
    from hdrtv_tpu_torch.config import PRECISIONS
    from hdrtv_tpu_torch.pipeline.compare import compare_frame
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    t_phase = time.perf_counter()
    set_path_env({"mega": "1"})
    has_cv2 = importlib.util.find_spec("cv2") is not None
    has_ffmpeg = shutil.which("ffmpeg") is not None
    log(f"phase 11: cv2 {'present' if has_cv2 else 'absent'}, ffmpeg {'present' if has_ffmpeg else 'absent'}; "
        f"the image writers (quality artifacts, compare sheet, figures) and the CLI's quality run "
        f"{'will run' if has_cv2 else 'will not run'}")
    os.environ["HDRTVNET_CACHE_DIR"] = os.path.join(tmp, "cache")  # the playback lock
    counts, figures = {}, {"card": smi, "cv2": has_cv2, "ffmpeg": has_ffmpeg}
    h, w = BENCH_SIZE

    def make(weights, precision):
        return HDRTVNetTorch(weights, precision=precision, persistent_cache=False)

    # --- inputs: eight textures and the fp32 program's ground truth, +BENCH_OFFSET -------------
    frames = [bench_texture(np, h, w, 1100 + i) for i in range(BENCH_FRAMES)]
    lead = [bench_texture(np, h, w, 1000 + i) for i in range(BENCH_OFFSET)]
    gt_path = os.path.join(tmp, "gt.y4m")
    fp32 = make(WEIGHTS, "fp32")
    with Y4MWriter(gt_path, w, h, fps=30.0, ctag="444p10") as gw:
        for f in lead + frames:
            gw.write_rgb_unit(fp32.process_rgb48(f).astype(np.float32) / 65535.0)
    fp32.graphs.clear()
    del fp32
    src = ListSource(frames)
    gt = HDRGroundTruthReader(gt_path)
    fmap = make_frame_map(src.fps, gt.fps, 0)  # the offset not given: post-verify finds it
    ids = list(range(BENCH_FRAMES))
    log(f"phase 11: {BENCH_FRAMES} textures {h}x{w}, ground truth {gt.decode_method} with a +{BENCH_OFFSET} lead")

    # --- the quality queue ---------------------------------------------------------------------
    key_path = {spec[0]: name for name, spec in QUALITY_PRESETS.items()}
    procs, state = {}, {"key": None, "t0": 0.0}
    secs = {}

    def close_run():
        if state["key"] is not None:
            torch.cuda.synchronize()
            counts[key_path[state["key"]]] = read_counts(native)
            secs[state["key"]] = time.perf_counter() - state["t0"]

    def progress(key):
        close_run()
        torch.cuda.synchronize()
        native.reset_launch_counts()
        state["key"], state["t0"] = key, time.perf_counter()

    def make_proc(key):
        _, weights, _ = next(spec for spec in QUALITY_PRESETS.values() if spec[0] == key)
        procs[key] = RecordingProcessor(make(weights, PRECISIONS[key].precision))
        return procs[key]

    out_root = os.path.join(tmp, "quality")
    summaries = run_quality_queue(
        QualityRunConfig(resolution_key="1080p", frame_count=BENCH_FRAMES), [s[0] for s in QUALITY_PRESETS.values()],
        make_proc, src, gt, out_root, source_name="phase11", gt_frame_map=fmap, save_artifacts=has_cv2,
        progress=progress, frame_ids=ids, post_verify=True)
    close_run()
    quality, by_key = {}, {s["precision"]: s for s in summaries}
    half = {"psnr": 5e-5, "psnr_gn": 5e-5, "ssim": 5e-6, "delta_e_itp": 5e-5, "delta_e_itp_gn": 5e-5}
    for name, (key, _, path) in QUALITY_PRESETS.items():
        want = {k: 2 * v for k, v in expected_launches(path).items()}
        if counts[name] != want:
            raise AssertionError(f"{name}: the queue counted {counts[name]}, one graph capture's launches {want}")
        s, rec = by_key[key], procs[key]
        rows = s["frames"]
        if [r["frame"] for r in rows] != ids or len(rec.outs) != len(ids):
            raise AssertionError(f"{name}: rows {[r['frame'] for r in rows]}, {len(rec.outs)} outputs")
        apart, art = [], []
        for r, out in zip(rows, rec.outs):
            if r["gt_alignment_offset_frames"] != BENCH_OFFSET or r["gt_frame"] != r["frame"] + BENCH_OFFSET:
                raise AssertionError(f"{name}: frame {r['frame']} aligned to {r['gt_frame']} (offset "
                                     f"{r['gt_alignment_offset_frames']}), not +{BENCH_OFFSET}")
            if not np.array_equal(out, rec.proc.process_rgb48(frames[r["frame"]])):
                raise AssertionError(f"{name}: frame {r['frame']}'s hdr_convert differs from process_rgb48")
            if has_cv2:
                import cv2

                tiff = os.path.join(s["session_dir"], "frames", f"{r['frame']:06d}", "hdr_convert.tiff")
                art.append(np.array_equal(cv2.imread(tiff, cv2.IMREAD_UNCHANGED)[..., ::-1], out))
            pair = (out.astype(np.float32) / 65535.0, gt.read_unit_rgb(r["gt_frame"]))
            card, cpu = evaluate_pair(*pair), evaluate_pair(*pair, device="cpu")
            d = {k: abs(card[k] - cpu[k]) / (abs(cpu[k]) if k.startswith("delta") else 1.0) for k in METRIC_TOL}
            if any(d[k] > METRIC_TOL[k] for k in d) or any(abs(r[k] - card[k]) > half[k] for k in half):
                raise AssertionError(f"{name}: frame {r['frame']}: row {r}, card {card}, CPU {cpu}")
            apart.append(d)
        if not all(art):
            raise AssertionError(f"{name}: hdr_convert.tiff differs from the outputs on frames "
                                 f"{[i for i, ok in zip(ids, art) if not ok]}")
        quality[name] = {
            "preset": key, "mean_psnr": s["mean_psnr"], "mean_ssim": s["mean_ssim"],
            "mean_delta_e_itp": s["mean_delta_e_itp"], "psnr": [r["psnr"] for r in rows],
            "ms_per_frame": round(secs[key] * 1e3 / len(ids), 1),
            "card_vs_cpu_max": {k: float(f"{max(d[k] for d in apart):.3e}") for k in METRIC_TOL},
            "artifacts_equal": bool(art) and all(art),
        }
        log(f"quality {key}: {json.dumps(quality[name])}; {smi}")
    fp32_rows = by_key["FP32"]["frames"]
    low = [r["frame"] for r in fp32_rows if r["psnr"] < QUALITY_FP32_PSNR]
    if low:
        raise AssertionError(f"quality FP32: frames {low} under the 10-bit bound {QUALITY_FP32_PSNR} dB")
    for name in ("quality_bf16", "quality_int8"):
        key = QUALITY_PRESETS[name][0]
        high = [r["frame"] for r, f in zip(by_key[key]["frames"], fp32_rows) if r["psnr"] >= f["psnr"]]
        if high:
            raise AssertionError(f"quality {key}: frames {high} read no lower than FP32")

    # --- the planted fault: post-verify off, the offset not given -------------------------------
    fault = run_quality_benchmark(
        QualityRunConfig(precision_key="FP32", resolution_key="1080p", frame_count=BENCH_FRAMES), procs["FP32"],
        src, gt, out_root, source_name="phase11_planted", gt_frame_map=fmap, post_verify=False,
        save_artifacts=False, frame_ids=ids)
    planted = {"bound": QUALITY_FP32_PSNR, "psnr": [r["psnr"] for r in fault["frames"]],
               "gt_frame": [r["gt_frame"] for r in fault["frames"]]}
    log(f"planted misalignment (FP32, post-verify off): {json.dumps(planted)}")
    if len(fault["frames"]) != len(ids) or any(p >= QUALITY_FP32_PSNR for p in planted["psnr"]):
        raise AssertionError(f"planted: the misaligned rows keep the fp32 bound: {planted}")

    # --- compare_frame on the card against the quality row of the same frame --------------------
    k = BENCH_FRAMES // 2
    res = compare_frame(procs["FP16"].proc, frames[k], frame_idx=k, gt_rgb01=gt.read_unit_rgb(k + BENCH_OFFSET))
    row = by_key["FP16"]["frames"][k]
    comp = {"frame": k, "metrics": res.metrics, "row_apart": {m: abs(res.metrics[m] - row[m]) for m in half}}
    if any(comp["row_apart"][m] > half[m] for m in half):
        raise AssertionError(f"compare_frame: {res.metrics} against the quality row {row}")
    if has_cv2:
        from hdrtv_tpu_torch.pipeline.compare import write_compare_sheet

        comp["sheet"] = os.path.basename(write_compare_sheet(res, os.path.join(tmp, "compare")))
    log(f"compare: {json.dumps(comp)}")
    if has_cv2:
        # figures: the bf16 session's artifacts tone-mapped on the card, each frame's PNGs and sheet
        from hdrtv_tpu_torch.bench.figures import render_session, tone_map_pq

        t0 = time.perf_counter()
        man = render_session(by_key["FP16"]["session_dir"], os.path.join(tmp, "figures"))
        fig_s = time.perf_counter() - t0
        code01 = procs["FP16"].outs[k].astype(np.float32) / 65535.0
        # the card's tone map against the CPU's, within the CPU tests' bound against JAX
        tm_apart = float(np.abs(tone_map_pq(code01) - tone_map_pq(code01, device="cpu")).max())
        comp["figures"] = {"frames": len(man["frames"]), "s": round(fig_s, 2), "tone_map_card_vs_cpu": tm_apart}
        log(f"figures: {json.dumps(comp['figures'])}")
        if len(man["frames"]) != BENCH_FRAMES or any(len(e["outputs"]) != 4 for e in man["frames"]) or tm_apart > 1e-3:
            raise AssertionError(f"figures: {comp['figures']}; {man['frames'][:1]}")
    gt.close()
    for p in procs.values():
        p.proc.graphs.clear()
    del procs, res
    torch.cuda.empty_cache()

    # --- playback: the pipelined benchmark and the device-resident chain -----------------------
    log(f"phase 11: run_playback_benchmark 1080p FP16, realtime off, {PLAYBACK_S:g} s wall clock")
    proc = make(WEIGHTS, "fp16")
    torch.cuda.synchronize()
    native.reset_launch_counts()
    sess = os.path.join(tmp, "playback")
    pb = run_playback_benchmark(PlaybackRunConfig(resolution_key="1080p", realtime=False, duration_s=PLAYBACK_S,
                                                  wall_clock=True), proc, sess)
    torch.cuda.synchronize()
    counts["playback_bf16"] = read_counts(native)
    files = sorted(f for f in os.listdir(sess))
    playback = {"frames": pb.frames, "dropped": pb.dropped, "fps": pb.fps, "fps_1pct_low": pb.fps_1pct_low,
                "model_ms": pb.model_ms, "ring_ms": pb.ring_ms, "wall_s": pb.wall_s, "files": files}
    log(f"playback: {json.dumps(playback)}; {smi}")
    if pb.frames <= 0 or files != ["runtime_metrics.csv", "session.json", "summary.txt"]:
        raise AssertionError(f"playback: {playback}")
    proc.graphs.clear()
    proc = make(WEIGHTS, "fp16")
    torch.cuda.synchronize()
    native.reset_launch_counts()
    resident = run_device_resident(proc, "1080p", frames=RESIDENT_FRAMES)
    torch.cuda.synchronize()
    counts["device_resident_bf16"] = read_counts(native)
    log(f"device resident: {json.dumps(resident)}; {smi}")
    want = {k: 2 * v for k, v in expected_launches("bf16_mega").items()}
    for name in ("playback_bf16", "device_resident_bf16"):
        if counts[name] != want:
            raise AssertionError(f"{name}: counted {counts[name]}, one graph capture's launches {want}")
    if resident["frames"] != RESIDENT_FRAMES or not resident["device_model_ms"] > 0:
        raise AssertionError(f"device resident: {resident}")
    proc.graphs.clear()
    del proc
    torch.cuda.empty_cache()

    # --- the CLI in subprocesses -----------------------------------------------------------------
    from hdrtv_tpu_torch.models.import_npz import load_npz, load_npz_meta, npz_arch_dict
    from hdrtv_tpu_torch.tools.synth_variants import to_torch_layout, write_pt

    env = {**os.environ, "HDRTVNET_PREFS_PATH": os.path.join(tmp, "prefs.json"),
           "HDRTVNET_ENGINE_CACHE_DIR": os.path.join(tmp, "engines")}
    cli = {}

    def run_cli(label, args, extra_env=None, timeout=600):
        cmd = [sys.executable, "-m", "hdrtv_tpu_torch.cli", *args]
        log(f"phase 11: {' '.join(cmd[1:])}")
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, env={**env, **(extra_env or {})}, capture_output=True, text=True,
                           timeout=timeout)
        cli[f"{label}_s"] = round(time.perf_counter() - t0, 1)
        cli[f"{label}_rc"] = r.returncode
        for line in r.stdout.strip().splitlines()[-4:]:
            log(f"  {label}: {line}")
        return r

    # The doctor counts the presets' weight files: the shipped weights as the FP16 / FP32
    # presets' reference HR.pt in a weights root of the phase's own.
    wroot = os.path.join(tmp, "weights")
    write_pt(os.path.join(wroot, "original", "HR.pt"), to_torch_layout(load_npz(WEIGHTS)),
             dict(npz_arch_dict(load_npz_meta(WEIGHTS))))
    r = run_cli("doctor", ["doctor"], {"HDRTVNET_WEIGHTS_ROOT": wroot})
    report = json.loads(r.stdout)
    name = torch.cuda.get_device_name(0)
    if r.returncode != 0 or not report["ok"] or report["details"].get("device_name") != name:
        raise AssertionError(f"doctor: exit {r.returncode}, {report}")
    cli["doctor"] = {k: report["details"].get(k) for k in ("device_name", "capability", "nvidia_smi", "weights",
                                                           "kernels_built")}
    r = run_cli("bench_supervised", ["bench", "--supervised", "--resolution", "1080p", "--duration", "3",
                                     "--no-realtime", "--out", os.path.join(tmp, "bench_cli")])
    if r.returncode != 0 or "[wrapper] child rc=0" not in r.stdout:
        raise AssertionError(f"bench --supervised: exit {r.returncode}; {r.stdout[-2000:]} {r.stderr[-2000:]}")
    if has_cv2:
        import cv2

        clip = os.path.join(tmp, "sdr.avi")
        vw = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), 30.0, (w, h))
        for f in frames:
            vw.write(f)
        vw.release()
        r = run_cli("quality", ["quality", "--video", clip, "--gt", gt_path, "--frames", "2", "--resolution",
                                "1080p", "--no-validate-gt", "--out", os.path.join(tmp, "quality_cli")])
        if r.returncode != 0:
            raise AssertionError(f"quality: exit {r.returncode}; {r.stdout[-2000:]} {r.stderr[-2000:]}")
        cli["quality"] = "ran"
    else:
        cli["quality"] = "not run: no cv2 (the CLI's SDR source is cv2's VideoSource)"
    log(f"cli quality: {cli['quality']}")

    # --- the wrapper's budget on a child that prints nothing ------------------------------------
    budget, most = WRAPPER_BUDGET_S
    wr = PlaybackBenchmarkWrapper(argv=[sys.executable, "-c", "import time; time.sleep(60)"], budget_s=budget)
    t0 = time.perf_counter()
    rc = wr.run()
    killed = time.perf_counter() - t0
    wrapper = {"budget_s": budget, "killed_after_s": round(killed, 3), "rc": rc, "canceled": wr.canceled}
    log(f"wrapper: {json.dumps(wrapper)}")
    if not wr.canceled or rc == 0 or killed > most:
        raise AssertionError(f"wrapper: the silent child was not killed within {most} s: {wrapper}")

    figures.update(quality=quality, planted=planted, compare=comp, playback=playback, device_resident=resident,
                   cli=cli, wrapper=wrapper, phase_s=round(time.perf_counter() - t_phase, 1))
    return counts, figures


# Phase 12: quantization, QAT and the data tooling (quant/calibrate.py, quant/qat.py,
# quant/mixed.py, train.py, bench/sweep.py, data/curate.py and the CLI commands on them).
# The checks' tolerances: the fixture's activation scales within QUANT_FIXTURE_RTOL (the
# fp32 statistics of the same forward, summed in another order; tests/test_torch_quant.py);
# card against CPU at QUANT_CAL_SIZE, max and percentile scales within QUANT_CAL_RTOL (the
# card's and the CPU's fp32 convs sum in different orders; TF32 off) and kl's threshold bins
# at most QUANT_KL_BINS apart; the QAT CLI's last loss at most QUANT_LOSS_GROWTH times its
# first (tests/test_qat_cli.py's rule); the PTQ frames' int8 megakernel program against the
# natural float program on the same checkpoint at most INT8_PSNR_MARGIN under INT8_PSNR_CPU
# (phase 4's int8 bound). The QAT step at QUANT_QAT_CHECK_SIZE, card against CPU: its loss
# against the frame within QUANT_QAT_LOSS_RTOL, and the gradients of a seeded VJP through
# the fake-quantized model, every leaf, as a share of the leaf's largest magnitude: median
# within QUANT_QAT_GRAD_MEDIAN and worst within QUANT_QAT_GRAD_TOL. The size is the least at
# which the AGCM classifier's last InstanceNorm sees more than two pixels, so that its
# leaves have gradients (at 64 x 128 it normalizes two pixels to ±1 whatever its input).
# The bounds are those two CPU programs meet: the port's VJP and jax.grad of the same one,
# on the CPU at this size, lie 1.4e-6 apart at the median leaf and 6.7e-4 at the worst
# (LE.recon_trunk5.0.sft2.SFT_scale_conv0.bias: fp32 sums in two orders, and leaky ReLUs
# whose input lies within them; tests/test_torch_train.py
# test_seeded_vjp_matches_jax_at_128x256). (The L1 loss's own gradients are not compared leaf by
# leaf: a residual within the two programs' rounding flips its sign.) The QAT checkpoint:
# its int8 codes against finalize_qat of the same steps run again, at most QUANT_QAT_FLIPS
# apart; its activation scales calibrated again from the placeholders within QUANT_CAL_RTOL.
QUANT_CAL_SIZE = (270, 480)
QUANT_FIXTURE_RTOL = 1e-5
QUANT_CAL_RTOL = 1e-4
QUANT_KL_BINS = 1
QUANT_FULL_SIZE = (1080, 1920)
QUANT_FULL_FRAMES = 3  # calibration frames; one more natural frame is the int8 frame
QUANT_QAT_SIZE = (540, 960)
QUANT_QAT_STEPS = 5
QUANT_QAT_CHECK_SIZE = (128, 256)
QUANT_QAT_LOSS_RTOL = 1e-5
QUANT_QAT_GRAD_MEDIAN = 1e-5
QUANT_QAT_GRAD_TOL = 1e-3
QUANT_LOSS_GROWTH = 1.5
QUANT_QAT_FLIPS = 6  # int8 codes two runs' latent weights may round apart (tests/test_torch_train.py RUN_QAT_FLIPS)
QUANT_SWEEP_FRAMES, QUANT_SWEEP_SIZE = 3, (192, 256)  # the sweep CLI's --frames and precision_sweep's size
QUANT_SWEEP_TOL = (0.3, 4e-4, 0.03)  # PSNR dB, SSIM, ΔEITP relative: the int8 rows' bound of test_torch_curate_sweep.py
QUANT_TEACHER_FRAMES = 3
QUANT_PHASE_S = 150.0
QUANT_KEYS = ("card", "fixture", "card_vs_cpu", "ptq", "qat", "layout", "sweep", "data", "phase_s")


def quant_line(figures: dict) -> str:
    """Phase 12's {"quant": ...} line, its keys in QUANT_KEYS' order; a
    missing or an extra key fails."""
    if set(figures) != set(QUANT_KEYS):
        raise AssertionError(f"quant line: keys {sorted(figures)} != {sorted(QUANT_KEYS)}")
    return json.dumps({"quant": {k: figures[k] for k in QUANT_KEYS}})


def unit_u8(np, frame):
    """A [0, 1] float frame as u8 BGR and back as the [0, 1] RGB float a
    video source gives (the CLI's frames)."""
    u8 = (np.clip(frame, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)[..., ::-1].copy()
    return u8, u8[..., ::-1].astype(np.float32) / 255.0


def png_sequence(np, cv2, frames, folder: str) -> str:
    """Write [0, 1] frames as lossless u8 PNGs; the printf pattern cv2 (and
    so the CLI's VideoSource) opens as a video."""
    os.makedirs(folder, exist_ok=True)
    for i, f in enumerate(frames):
        if not cv2.imwrite(os.path.join(folder, f"f_{i:03d}.png"), unit_u8(np, f)[0]):
            raise AssertionError(f"cv2 could not write a PNG into {folder}")
    return os.path.join(folder, "f_%03d.png")


def quant_sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def cli_in_process(torch, args: list) -> tuple[str, float]:
    """The port's CLI in this process (on DEVICE, its stdout captured);
    exit 0 required. Returns the output and the seconds."""
    import contextlib
    import io

    from hdrtv_tpu_torch import cli

    buf = io.StringIO()
    log(f"phase 12: hdrtv_tpu_torch.cli {' '.join(args)}")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    quant_sync(torch)
    sec = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.strip().splitlines()[-3:]:
        log(f"  {args[0]}: {line}")
    if rc != 0:
        raise AssertionError(f"cli {args[0]}: exit {rc}; {out[-2000:]}")
    return out, sec


def quant_int8_frame(torch, np, native, smi: str, path: str, ckpt: str, frame, floor: bool) -> tuple[dict, dict]:
    """A checkpoint the port made, on the int8 default (megakernel) program at
    1080p: one eager frame launching what int8_bf16_mega launches (the counts
    set to 0 before it, read after), its CUDA graph replaying it bit for bit
    (phase 8's drive), and its PSNR against the natural-layout float program
    on the same (pre-dequantized) checkpoint, held to phase 4's int8 bound
    where ``floor``."""
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    set_path_env(PATHS["int8_bf16_mega"])
    proc = HDRTVNetTorch(ckpt, precision="fp16", device=DEVICE)
    if not proc.native_int8 or not proc.turbo:
        raise AssertionError(f"{path}: native_int8 {proc.native_int8}, turbo {proc.turbo}")
    h, w, _ = frame.shape
    x = proc.put_frame(frame.reshape(h, w * 3))
    proc._rgb48_eager(x)
    quant_sync(torch)
    native.reset_launch_counts()
    out = proc._rgb48_eager(x)
    quant_sync(torch)
    counts = read_counts(native)
    expected = expected_launches("int8_bf16_mega")
    log(f"{path}: launches for one frame: {counts}")
    if counts != expected:
        raise AssertionError(f"{path}: launch counts {counts} != {expected}")
    if out.shape != (h // 2, 2, w // 2, 6) or out.dtype != torch.uint16:
        raise AssertionError(f"{path}: output {tuple(out.shape)} {out.dtype}")
    graph = phase_graph(torch, native, smi, proc, x, out, expected, f"1080p {path}", 2, graph_bound("int8_bf16_mega"))
    if not graph["equal"]:
        raise AssertionError(f"{path}: the replays differ from the eager frame")
    o = proc._hw3(out.cpu().numpy()).astype(np.int64)
    nat = HDRTVNetTorch(ckpt, precision="fp16", device=DEVICE, turbo=False)
    f = eager_rgb48(nat, frame).astype(np.int64)
    p = psnr(float((((o - f) / 65535.0) ** 2).mean()))
    differ = float((o != f).mean())
    least = INT8_PSNR_CPU["int8_bf16_mega"] - INT8_PSNR_MARGIN
    log(f"{path}: int8 megakernel frame against the natural float program on the same checkpoint: PSNR {p:.2f} dB"
        + (f" (floor {least:.2f})" if floor else " (information)") + f", {differ:.3f} of the values differ; {smi}")
    if differ == 0.0 or (floor and p < least):
        raise AssertionError(f"{path}: int8 against float PSNR {p:.2f} dB, {differ} of the values differ")
    del proc, nat, x, out
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return counts, {"psnr_vs_natural_float": round(p, 3), "differ": round(differ, 4), "graph": graph}


def kl_bin(kl_scale, max_scale) -> int:
    """The KL threshold bin behind a symmetric layer's kl scale: the scale
    is (bin + 0.5) · (range / KL_BINS) / 127 on the range of the layer's
    abs-max, which is the max method's scale × 127 on the same frames."""
    from hdrtv_tpu_torch.quant.calibrate import KL_BINS

    f = float(kl_scale) * KL_BINS / float(max_scale) - 0.5
    if abs(f - round(f)) > 1e-2:
        raise AssertionError(f"a kl scale {kl_scale} that is no bin of the range {float(max_scale) * 127}")
    return round(f)


def qat_checkpoint_checks(torch, np, ckpt: dict, latent: dict, layers: list, frames) -> dict:
    """What finalize_qat and the calibration after QAT wrote. (1) The int8
    weights: finalize_qat of the latent weights that qat_step_ms's run of
    the same steps left (same frames, lr and device) against the
    checkpoint's: at most QUANT_QAT_FLIPS codes apart and every w_scale
    within QUANT_FIXTURE_RTOL. (2) The activation scales and zero points:
    the checkpoint with its placeholders restored (x_scale 1, x_zero 0, as
    quantize_params writes them), calibrated again on DEVICE on the QAT
    frames, within QUANT_CAL_RTOL of its own. (Its int8 frame's PSNR
    against the float program is printed only: the calibration's forward
    runs the placeholders' fake-quant, as the JAX package's does, and puts
    LE.HR_conv2's range at about [-16, 78] where its input lies in about
    [-0.2, 0.8]; whether the asymmetric code grid then holds 0 decides 33.5
    or 18.4 dB between two checkpoints 1e-5 apart, on the CPU's plain int8
    program too.)"""
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig
    from hdrtv_tpu_torch.quant.calibrate import calibrate
    from hdrtv_tpu_torch.quant.qat import finalize_qat

    mine = finalize_qat(latent, layers, asymmetric=True)
    codes = [k for k in ckpt if k.endswith(".weight_int8")]
    if sorted(codes) != sorted(k for k in mine if k.endswith(".weight_int8")):
        raise AssertionError("the QAT checkpoint's int8 layers differ from finalize_qat's")
    flips = sum(int((np.asarray(ckpt[k]) != mine[k]).sum()) for k in codes)
    n_codes = sum(int(np.asarray(ckpt[k]).size) for k in codes)
    w_rel = max(float(np.abs(np.asarray(ckpt[k], np.float64) / mine[k] - 1.0).max())
                for k in ckpt if k.endswith(".w_scale"))
    held = dict(ckpt)
    for k in ckpt:
        if k.endswith(".x_scale"):
            held[k] = np.float32(1.0)
        elif k.endswith(".x_zero"):
            held[k] = np.float32(0.0)
    again = calibrate(held, frames, ModelConfig(), device=DEVICE)
    scale_rel = max(abs(float(again[k]) - float(ckpt[k])) / max(abs(float(ckpt[k])), 1e-6)
                    for k in ckpt if k.endswith((".x_scale", ".x_zero")))
    out = {"code_flips": flips, "codes": n_codes, "w_scale_worst_rel": float(f"{w_rel:.3e}"),
           "recalibrated_worst_rel": float(f"{scale_rel:.3e}")}
    log(f"phase 12 (d): the QAT checkpoint against finalize_qat of the same steps run again: {flips} of {n_codes} "
        f"codes apart (bound {QUANT_QAT_FLIPS}), w_scale within {w_rel:.2e} (bound {QUANT_FIXTURE_RTOL}); its "
        f"activation scales calibrated again from the placeholders within {scale_rel:.2e} (bound {QUANT_CAL_RTOL})")
    if flips > QUANT_QAT_FLIPS or w_rel > QUANT_FIXTURE_RTOL or scale_rel > QUANT_CAL_RTOL:
        raise AssertionError(f"the QAT checkpoint: {out}")
    return out


def sweep_outputs(torch, fp32: dict, presets: dict, cfg) -> dict:
    """The sweep's programs again on DEVICE, on its frames at its size (the
    CLI's defaults): each preset's clipped outputs and, under None, the fp32
    references, as device tensors (the metrics of precision_sweep's rows
    are computed from these)."""
    from hdrtv_tpu_torch.bench.sweep import _frames
    from hdrtv_tpu_torch.models.hdrtvnet import model_apply, natural_params_to_torch
    from hdrtv_tpu_torch.models.layers import BF16, F32
    from hdrtv_tpu_torch.quant.calibrate import frame_inputs

    with torch.inference_mode():
        inputs = [frame_inputs(f, DEVICE) for f in _frames(QUANT_SWEEP_FRAMES, QUANT_SWEEP_SIZE)]
        fp = natural_params_to_torch(fp32, DEVICE, F32)
        out = {None: [model_apply(fp, img, cond, cfg, policy=F32).clamp(0, 1)[0] for img, cond in inputs]}
        for name, v in presets.items():
            policy = F32 if v["precision"] == "fp32" else BF16
            with policy.math():
                pj = natural_params_to_torch(v["params"], DEVICE, policy)
                out[name] = [model_apply(pj, img, cond, cfg, policy=policy).clamp(0, 1)[0] for img, cond in inputs]
    return out


def qat_step_ms(torch, np, fp32: dict, frames, layers: list) -> tuple[list, dict]:
    """run_qat's loop on DEVICE (the teacher's forward, then one STE
    fake-quant training step on the frame), each step's ms on the host's
    clock: the step ends with its loss read back, so the device has
    finished it (the qat CLI's own steps are not timed from outside). Also
    returns the latent weights the steps leave, as numpy."""
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig, model_apply, natural_params_to_torch
    from hdrtv_tpu_torch.quant.calibrate import frame_inputs
    from hdrtv_tpu_torch.quant.qat import make_weight_fake_quant
    from hdrtv_tpu_torch.train import init_state, make_train_step, params_to_numpy

    cfg = ModelConfig()
    teacher = natural_params_to_torch(fp32, DEVICE)
    train = make_train_step(cfg, fake_quant=make_weight_fake_quant(layers))
    state = init_state(fp32, lr=2e-6, device=DEVICE)
    out = []
    for frame in frames:
        with torch.no_grad():
            img, cond = frame_inputs(frame, DEVICE)
            t_out = model_apply(teacher, img, cond, cfg)
        quant_sync(torch)
        t0 = time.perf_counter()
        state, loss = train(state, img, cond, t_out, t_out)
        float(loss)
        out.append(round((time.perf_counter() - t0) * 1e3, 3))
    latent = params_to_numpy(state.params)
    del state, teacher
    return out, latent


def phase_quant(torch, np, native, smi: str, tmp: str) -> tuple[dict, dict]:
    """Phase 12 (its checks in the constants' comment above): (a) PTQ and max
    calibration of weights/hr_fp32.npz on the fixture's three frames
    reproduce tests/fixtures/hr_w8a8.npz; (b) max, percentile and kl
    calibration at QUANT_CAL_SIZE, half the layers asymmetric, card against
    CPU; (c) the quantize CLI on three seeded 1080p natural frames with the
    max and kl methods, timed, each checkpoint on the int8 default program
    (quant_int8_frame; paths quant_ptq_max, quant_ptq_kl); (d) one QAT step
    card against CPU (tools/qat_probe.py vjp_apart), then the qat CLI, QUANT_QAT_STEPS steps on 540p natural
    frames, asymmetric, its peak memory, run_qat's steps timed again in
    process (qat_step_ms), its checkpoint on the int8 default program (path
    quant_qat) and its weights and scales held (qat_checkpoint_checks); (e)
    layout at its CLI defaults, quantize --layout with it, sweep over that
    checkpoint and (c)'s max one: its rows against the CPU's sweep of the
    same checkpoints within QUANT_SWEEP_TOL, and the metrics of the card's
    outputs (sweep_outputs) on the CPU within METRIC_TOL of the rows; (f) a 1080p MJPG clip, teacher-pairs on it (each
    teacher PNG equal to process_rgb48 of its SDR PNG), mine-hard-frames
    over the pairs. Everything under fp32_math (main's)."""
    import cv2

    from hdrtv_tpu_torch.bench.sweep import natural_frames, precision_sweep
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig
    from hdrtv_tpu_torch.models.import_npz import load_npz
    from hdrtv_tpu_torch.ops.metrics import full_reference_metrics
    from hdrtv_tpu_torch.quant.calibrate import calibrate
    from hdrtv_tpu_torch.quant.int8 import (DEFAULT_EXCLUDE_SUFFIXES, load_mixed_layout, quantizable_layers,
                                            quantize_params, quantized_layer_summary)
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch
    from hdrtv_tpu_torch.tools.qat_probe import vjp_apart

    t_phase = time.perf_counter()
    log(f"phase 12: quantization, QAT and data tooling on the card; {smi}")
    qtmp = os.path.join(tmp, "quant")
    os.makedirs(qtmp, exist_ok=True)
    saved_env = {k: os.environ.get(k) for k in ("HDRTVNET_ENGINE_CACHE_DIR", "HDRTV_CLI_PLATFORM")}
    os.environ["HDRTVNET_ENGINE_CACHE_DIR"] = os.path.join(qtmp, "engines")
    if DEVICE == "cuda":
        os.environ.pop("HDRTV_CLI_PLATFORM", None)
    else:
        os.environ["HDRTV_CLI_PLATFORM"] = DEVICE
    cfg = ModelConfig()
    fp32 = load_npz(WEIGHTS)
    counts, figures = {}, {"card": smi}
    try:
        # (a) the fixture -------------------------------------------------------------------------
        yy, xx = np.mgrid[0:32, 0:48].astype(np.float32)
        fx_frames = [np.stack([xx / 48 * s, yy / 32 * s, np.full_like(xx, 0.2 + 0.2 * s)], -1)
                     for s in (0.6, 0.9, 1.0)]
        t0 = time.perf_counter()
        got = calibrate(quantize_params(fp32, mode="w8a8"), fx_frames, cfg, device=DEVICE)
        a_s = time.perf_counter() - t0
        with np.load(INT8_WEIGHTS) as z:
            want = {k: z[k] for k in z.files}
        if sorted(got) != sorted(want):
            raise AssertionError(f"fixture: keys differ: {sorted(set(got) ^ set(want))[:8]}")
        unequal = [k for k in want if not k.endswith(".x_scale") and not np.array_equal(np.asarray(got[k]), want[k])]
        worst = max(abs(float(got[k]) / float(want[k]) - 1.0) for k in want if k.endswith(".x_scale"))
        figures["fixture"] = {"codes_and_w_scale_equal": not unequal, "x_scale_worst_rel": float(f"{worst:.3e}"),
                              "s": round(a_s, 2)}
        log(f"phase 12 (a): the card's PTQ of {os.path.basename(WEIGHTS)} on the fixture's frames: codes and "
            f"w_scale equal {not unequal}, x_scale worst relative {worst:.3e} (bound {QUANT_FIXTURE_RTOL})")
        if unequal or worst > QUANT_FIXTURE_RTOL:
            raise AssertionError(f"fixture: {len(unequal)} code arrays differ ({unequal[:4]}), x_scale {worst}")

        # (b) card against CPU ---------------------------------------------------------------------
        cal_frames = [unit_u8(np, f)[1] for f in natural_frames(1, QUANT_CAL_SIZE)]
        q = quantize_params(fp32, mode="w8a8")
        layers = sorted(k[: -len(".x_scale")] for k in q if k.endswith(".x_scale"))
        for l in layers[::2]:
            q[f"{l}.x_zero"] = np.float32(0.0)  # half the layers asymmetric
        vs_cpu, max_of = {}, {}
        for method in ("max", "percentile", "kl"):
            t0 = time.perf_counter()
            card = calibrate(q, cal_frames, cfg, method=method, device=DEVICE)
            c_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            cpu = calibrate(q, cal_frames, cfg, method=method, device="cpu")
            p_s = time.perf_counter() - t0
            if method == "max":
                max_of = {"card": card, "cpu": cpu}
            worst, bins = 0.0, {"equal": 0, "one_apart": 0, "more": 0}
            for k in cpu:
                if not k.endswith((".x_scale", ".x_zero")):
                    continue
                layer = k.rsplit(".", 1)[0]
                if method == "kl" and f"{layer}.x_zero" not in q:
                    d = abs(kl_bin(card[k], max_of["card"][k]) - kl_bin(cpu[k], max_of["cpu"][k]))
                    bins["equal" if d == 0 else "one_apart" if d == 1 else "more"] += 1
                    continue
                c, p = float(card[k]), float(cpu[k])
                worst = max(worst, abs(c - p) / max(abs(p), 1e-6))
            vs_cpu[method] = {"worst_rel": float(f"{worst:.3e}"), "card_s": round(c_s, 2), "cpu_s": round(p_s, 2)}
            if method == "kl":
                vs_cpu[method]["kl_bins"] = bins
            log(f"phase 12 (b): {method} at {QUANT_CAL_SIZE[0]}x{QUANT_CAL_SIZE[1]}, card against CPU: "
                f"{json.dumps(vs_cpu[method])} (bound {QUANT_CAL_RTOL} relative"
                + (f", kl bins at most {QUANT_KL_BINS} apart)" if method == "kl" else ")"))
            if worst > QUANT_CAL_RTOL or bins["more"]:
                raise AssertionError(f"calibrate {method}: card against CPU {vs_cpu[method]}")
        figures["card_vs_cpu"] = vs_cpu

        # (c) the quantize CLI at 1080p -------------------------------------------------------------
        nat = natural_frames(QUANT_FULL_FRAMES + 1, QUANT_FULL_SIZE)
        seq = png_sequence(np, cv2, nat[:QUANT_FULL_FRAMES], os.path.join(qtmp, "calib"))
        int8_frame = unit_u8(np, nat[QUANT_FULL_FRAMES])[0]
        ptq, ckpts = {}, {}
        for method in ("max", "kl"):
            ckpts[method] = os.path.join(qtmp, f"ptq_{method}.npz")
            out, sec = cli_in_process(torch, ["quantize", "--model", WEIGHTS, "--out", ckpts[method], "--calib-video",
                                              seq, "--calib-frames", str(QUANT_FULL_FRAMES), "--calib-method",
                                              method])
            mix = {}
            for v in quantized_layer_summary(load_npz(ckpts[method])).values():
                mix[v] = mix.get(v, 0) + 1
            if mix != {"w8a8": len(layers), "fp": 1}:
                raise AssertionError(f"quantize {method}: layer mix {mix}")
            path = f"quant_ptq_{method}"
            counts[path], ptq[method] = quant_int8_frame(torch, np, native, smi, path, ckpts[method], int8_frame, True)
            ptq[method]["quantize_s"] = round(sec, 2)
            log(f"phase 12 (c): quantize --calib-method {method} on {QUANT_FULL_FRAMES} 1080p frames: {sec:.2f} s")
        figures["ptq"] = ptq

        # (d) QAT ----------------------------------------------------------------------------------
        default_layers = [l for l in quantizable_layers(fp32) if not l.endswith(DEFAULT_EXCLUDE_SUFFIXES)]
        check = unit_u8(np, natural_frames(1, QUANT_QAT_CHECK_SIZE)[0])[1]
        loss_rel, rel = vjp_apart(fp32, check, default_layers, DEVICE)
        grad_worst = max(rel.values())
        grad_median = sorted(rel.values())[len(rel) // 2]
        cls = max(v for k, v in rel.items() if ".classifier." in k)
        qat_check = {"size": list(QUANT_QAT_CHECK_SIZE), "loss_rel": float(f"{loss_rel:.3e}"),
                     "leaves": len(rel), "worst_rel": float(f"{grad_worst:.3e}"),
                     "median_rel": float(f"{grad_median:.3e}"), "classifier_worst_rel": float(f"{cls:.3e}")}
        log(f"phase 12 (d): one QAT step at {QUANT_QAT_CHECK_SIZE[0]}x{QUANT_QAT_CHECK_SIZE[1]}, card against CPU: "
            f"loss relative {loss_rel:.2e} (bound {QUANT_QAT_LOSS_RTOL}); a seeded VJP through the fake-quantized "
            f"model: {len(rel)} leaves, median {grad_median:.2e} (bound {QUANT_QAT_GRAD_MEDIAN}) and worst "
            f"{grad_worst:.2e} (bound {QUANT_QAT_GRAD_TOL}) of their largest magnitude "
            f"({json.dumps({k: float(f'{v:.2e}') for k, v in sorted(rel.items(), key=lambda kv: -kv[1])[:3]})}); "
            f"the classifier's leaves within {cls:.2e}")
        if (loss_rel > QUANT_QAT_LOSS_RTOL or grad_worst > QUANT_QAT_GRAD_TOL or grad_median > QUANT_QAT_GRAD_MEDIAN
                or sum(".classifier." in k for k in rel) != 20):
            raise AssertionError(f"QAT step card against CPU: {qat_check}")
        qat_frames = natural_frames(QUANT_QAT_STEPS, QUANT_QAT_SIZE)
        qseq = png_sequence(np, cv2, qat_frames, os.path.join(qtmp, "qat"))
        qat_ckpt = os.path.join(qtmp, "qat.npz")
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        out, sec = cli_in_process(torch, ["qat", "--model", WEIGHTS, "--out", qat_ckpt, "--frames-video", qseq,
                                          "--num-frames", str(QUANT_QAT_STEPS), "--steps", str(QUANT_QAT_STEPS)])
        peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
        rep = json.loads(out[out.index("{"):])
        first, last = rep["loss_first"], rep["loss_last"]
        step_ms, latent = qat_step_ms(torch, np, fp32, [unit_u8(np, f)[1] for f in qat_frames], default_layers)
        qat = {"check": qat_check, "loss_first": first, "loss_last": last, "step_ms": step_ms,
               "ms_per_step": round(sum(step_ms[1:]) / max(len(step_ms) - 1, 1), 3),
               "peak_gib": round(peak / 2**30, 3), "cli_s": round(sec, 2), "layer_mix": rep["layer_mix"]}
        log(f"phase 12 (d): qat, {QUANT_QAT_STEPS} steps at {QUANT_QAT_SIZE[0]}x{QUANT_QAT_SIZE[1]}: "
            f"{json.dumps(qat)}; {smi}")
        if (not (math.isfinite(first) and math.isfinite(last)) or last > QUANT_LOSS_GROWTH * first
                or rep["layer_mix"] != {"w8a8-asym": 127, "fp": 1}):
            raise AssertionError(f"qat: {rep}")
        counts["quant_qat"], qat["int8"] = quant_int8_frame(torch, np, native, smi, "quant_qat", qat_ckpt, int8_frame,
                                                            False)
        qat["checkpoint"] = qat_checkpoint_checks(torch, np, load_npz(qat_ckpt), latent, default_layers,
                                                  [unit_u8(np, f)[1] for f in qat_frames])
        figures["qat"] = qat

        # (e) layout, quantize --layout, sweep ------------------------------------------------------
        lay = os.path.join(qtmp, "layout.txt")
        _, lay_s = cli_in_process(torch, ["layout", "--model", WEIGHTS, "--out", lay])
        chosen = load_mixed_layout(lay)
        mixed = os.path.join(qtmp, "mixed.npz")
        _, mq_s = cli_in_process(torch, ["quantize", "--model", WEIGHTS, "--out", mixed, "--layout", lay])
        mmix = {}
        for v in quantized_layer_summary(load_npz(mixed)).values():
            mmix[v] = mmix.get(v, 0) + 1
        if len(chosen) != 29 or mmix.get("w8a8") != 29:
            raise AssertionError(f"layout: {len(chosen)} layers chosen, mixed checkpoint {mmix}")
        figures["layout"] = {"layers": chosen, "layout_s": round(lay_s, 2), "quantize_s": round(mq_s, 2),
                             "layer_mix": mmix}
        out, sw_s = cli_in_process(torch, ["sweep", "--model", WEIGHTS, "--preset-checkpoints", f"mixed={mixed}",
                                           f"ptq_max={ckpts['max']}"])
        rows = json.loads(out[out.index("["):])
        presets = {"mixed": {"params": load_npz(mixed), "precision": "bf16"},
                   "ptq_max": {"params": load_npz(ckpts["max"]), "precision": "bf16"}}
        cpu_rows = precision_sweep(fp32, cfg, presets=presets, device="cpu")
        outs = sweep_outputs(torch, fp32, presets, cfg)
        keys = ("psnr", "ssim", "delta_e_itp")
        rounding = {"psnr": 1e-3, "ssim": 1e-5, "delta_e_itp": 1e-4}  # the rows' own rounding
        program_apart, metric_apart, bad = {}, {}, []
        for row, cpu_row in zip(rows, cpu_rows):
            name = row["preset"]
            program_apart[name] = {k: abs(row[k] - getattr(cpu_row, k)) / (
                max(getattr(cpu_row, k), 1e-3) if k.startswith("delta") else 1.0) for k in keys}
            bad += [(name, k, "program") for k, tol in zip(keys, QUANT_SWEEP_TOL)
                    if program_apart[name][k] > tol + rounding[k]]
            on = {dev: [full_reference_metrics(o.to(dev), r.to(dev)) for o, r in zip(outs[name], outs[None])]
                  for dev in (DEVICE, "cpu")}
            mean = {dev: {k: float(np.mean([float(v[k]) for v in m])) for k in keys} for dev, m in on.items()}
            again = [k for k in keys if abs(mean[DEVICE][k] - row[k]) > rounding[k]]
            if again:
                raise AssertionError(f"sweep {name}: the outputs again give {mean[DEVICE]}, the CLI's row {row}")
            metric_apart[name] = {k: abs(row[k] - mean["cpu"][k]) / (abs(mean["cpu"][k]) if k.startswith("delta")
                                                                     else 1.0) for k in keys}
            bad += [(name, k, "metrics") for k in keys if metric_apart[name][k] > METRIC_TOL[k] + rounding[k]]
        log(f"phase 12 (e): sweep rows on the card {json.dumps(rows)}; the CPU's sweep on the same checkpoints, "
            f"|card - cpu| (ΔEITP relative) {json.dumps(program_apart)} (bound {QUANT_SWEEP_TOL}); the metrics of "
            f"the card's outputs on the CPU, |row - cpu| {json.dumps(metric_apart)} (bound METRIC_TOL)")
        if bad or [r["preset"] for r in rows] != ["mixed", "ptq_max"]:
            raise AssertionError(f"sweep: the card's rows beyond their bounds of the CPU's on {bad}")
        figures["sweep"] = {"rows": rows, "programs_apart": program_apart, "metrics_apart": metric_apart,
                            "cli_s": round(sw_s, 2)}

        # (f) data tooling -------------------------------------------------------------------------
        h, w = QUANT_FULL_SIZE
        clip = os.path.join(qtmp, "clip.avi")
        vw = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), 24.0, (w, h))
        for f in nat:
            vw.write(unit_u8(np, f)[0])
        vw.release()
        pairs = os.path.join(qtmp, "pairs")
        out, tp_s = cli_in_process(torch, ["teacher-pairs", "--video", clip, "--out", pairs, "--num-frames",
                                           str(QUANT_TEACHER_FRAMES)])
        with open(os.path.join(pairs, "manifest.json")) as fh:
            manifest = json.load(fh)
        proc = HDRTVNetTorch(WEIGHTS, precision="fp16", device=DEVICE, proc_resolution=(w, h))
        sdr_dir, hdr_dir = os.path.join(qtmp, "mine_sdr"), os.path.join(qtmp, "mine_hdr")
        os.makedirs(sdr_dir)
        os.makedirs(hdr_dir)
        for pair in manifest["pairs"]:
            sdr = cv2.imread(pair["sdr"], cv2.IMREAD_UNCHANGED)
            teacher = cv2.imread(pair["teacher"], cv2.IMREAD_UNCHANGED)
            if teacher is None or teacher.dtype != np.uint16 or not np.array_equal(teacher[..., ::-1],
                                                                                   proc.process_rgb48(sdr)):
                raise AssertionError(f"teacher-pairs: {pair['teacher']} is not process_rgb48 of {pair['sdr']}")
            stem = f"{pair['frame']:06d}.png"
            cv2.imwrite(os.path.join(sdr_dir, stem), sdr)
            cv2.imwrite(os.path.join(hdr_dir, stem), teacher)
        del proc
        out, mh_s = cli_in_process(torch, ["mine-hard-frames", "--sdr-dir", sdr_dir, "--hdr-dir", hdr_dir, "--out",
                                           os.path.join(qtmp, "mined"), "--top", "2"])
        mined = json.loads(out)
        figures["data"] = {"teacher_pairs": manifest["count"], "teacher_equal": True, "teacher_s": round(tp_s, 2),
                           "mined": {k: mined[k] for k in ("total_pairs", "hard_count")}, "mine_s": round(mh_s, 2)}
        log(f"phase 12 (f): teacher-pairs {manifest['count']} pairs at 1080p, each teacher PNG equal to "
            f"process_rgb48 of its SDR frame ({tp_s:.2f} s); mine-hard-frames {json.dumps(figures['data']['mined'])}")
        if manifest["count"] != QUANT_TEACHER_FRAMES or mined["total_pairs"] != QUANT_TEACHER_FRAMES:
            raise AssertionError(f"data tooling: {figures['data']}")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    figures["phase_s"] = round(time.perf_counter() - t_phase, 1)
    log(f"phase 12: {figures['phase_s']} s (bound {QUANT_PHASE_S})")
    if figures["phase_s"] > QUANT_PHASE_S:
        raise AssertionError(f"phase 12 took {figures['phase_s']} s, over {QUANT_PHASE_S}")
    return counts, figures


# Phase 13: live capture, the interactive shell, the audio attach and the tab-audio bridge
# (pipeline/live.py, capture.py, shell.py, audio.py, bridge.py; host code in front of
# PipelineRunner). (a) The synthetic grabber at LIVE_CAPTURES' sizes through LiveSource into
# the runner, realtime at LIVE_FPS for LIVE_FRAMES frames, processed at 1080p on the bf16
# default (the 720p capture letterboxed): one delivered frame in LIVE_KEEP kept, each mapped
# back to the observation it was served from and equal bit for bit to process_rgb48 of that
# capture; the observations served never go back. (b) The live CLI in a child process.
# (c) A ShellController over a running card runner, SHELL_KEYS pressed: every delivered
# frame's CRC-32 equal to process_rgb48's on the program in force (the CRC of equal bytes is
# equal; two different frames share one with odds of 2^-32), the 720p program's replay equal
# to its eager bytes (letterboxed from 1080p, and on a native 720p frame), the native
# frame (seeded noise, as phase 3's) against the same program on the CPU within phase 3's
# bf16 natural bound NAT_BF16_CODES (the CRCs and the replays hold the kernels to
# themselves; at 720p every LE resblock takes the resblock kernel, phase 2 holds it to its
# plain version at these blocks' shapes). Phase 3's bound on the s2d programs, (1536, 34.0)
# from 18.06 seen at 360 × 640, does not carry over: the 720p frame reads 510 / 34.64 codes
# while each of its kernel calls matches its plain version on its own inputs within one
# bf16 step (trunk3 2.1, within its two; tools/bf16_spread.py --per-call), and 1080p reads
# 347 / 6.63, so the spread grows outside the kernels, as the natural program's does
# (NVIDIA H100 80GB HBM3, 700 W). The frames after
# the precision swap (fp16 → the int8 token, both bf16 on the float weights) the 1080p
# program's, at most the out ring's ring + 2 frames (those in flight) after the pause and
# none in the next SHELL_PAUSE_S, one frame redrawn by the paused seek, memory allocated and
# reserved at each later swap's
# first frame at most SHELL_MEM_SLACK over the first swap's (a processor a swap dropped and did
# not free would keep its graph's pool, 0.3-1.4 GiB). (d) An AudioPlayer on a fake mpv
# and an AudioAttachment on a card runner: every gain the policy issued reaches the fake's
# IPC log. (e) AudioSyncBridge on 127.0.0.1: a session's start, keepalive and stop, and 410
# for a keepalive after the stop. Budget LIVE_PHASE_S.
LIVE_FPS = 60.0
LIVE_FRAMES = 300
LIVE_KEEP = 10
LIVE_CAPTURES = {"live_bf16": (1080, 1920), "live_letterbox": (720, 1280)}
LIVE_CLI_FRAMES = 120
SHELL_KEYS = ("p", "r", "r", "r", " ", ".", " ", "LEFT", "q")
SHELL_STEP_FRAMES = 15  # frames of the new program awaited after each key
SHELL_PAUSE_S = 0.3  # seconds for what was in flight to drain, then as long again with nothing new
SHELL_MEM_SLACK = 256 << 20  # bytes: a new size's resize matrices, cached output copies; a pool is 0.3-1.4 GiB
AUDIO_FRAMES = 240
LIVE_PHASE_S = 60.0
LIVE_KEYS = ("card", "live_bf16", "live_letterbox", "cli", "shell", "audio", "bridge", "phase_s")
# Phase 13 (d)'s fake mpv (tests/test_audio_player.py's; tests/test_torch_audio_shell.py reads
# it from here): serves the --input-ipc-server socket and appends every command line it
# receives to <socket>.log; with no socket it sleeps, as an mpv playing would.
FAKE_MPV = r"""#!{python}
import socket, sys, time
ipc = next((a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--input-ipc-server=")), None)
if ipc is None:
    time.sleep(30); sys.exit(0)
srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
srv.bind(ipc)
srv.listen(1)
conn, _ = srv.accept()
with open(ipc + ".log", "ab", buffering=0) as log:
    while True:
        data = conn.recv(4096)
        if not data:
            break
        log.write(data)
"""


def live_line(figures: dict) -> str:
    """Phase 13's {"live": ...} line, its keys in LIVE_KEYS' order; a
    missing or an extra key fails."""
    if set(figures) != set(LIVE_KEYS):
        raise AssertionError(f"live line: keys {sorted(figures)} != {sorted(LIVE_KEYS)}")
    return json.dumps({"live": {k: figures[k] for k in LIVE_KEYS}})


class ObservedGrabber:
    """A grabber that numbers what it hands out (1, 2, ... as LiveSource
    counts observations), keeps the last few frames it made to look one up
    by identity, and times each grab."""

    def __init__(self, grab, keep: int = 16):
        import collections
        import threading

        self.grab, self.n, self.ms = grab, 0, []
        self._recent = collections.deque(maxlen=keep)
        self._lock = threading.Lock()

    def __call__(self):
        t0 = time.perf_counter()
        frame = self.grab()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        if frame is not None:
            with self._lock:
                self.n += 1
                self._recent.append((self.n, frame))
        return frame

    def observation(self, frame):
        """The number of the observation ``frame`` is (None when it is not
        one of the last few)."""
        with self._lock:
            return next((n for n, f in self._recent if f is frame), None)


def served_observations(source_cls):
    """A LiveSource subclass recording, for each frame it serves, the
    number of the observation it served (its grabber an ObservedGrabber)."""

    class Traced(source_cls):
        def __init__(self, grabber, **kw):
            self.served_obs = []
            super().__init__(grabber, **kw)

        def read_with_meta(self, timeout: float = 2.0):
            meta = super().read_with_meta(timeout)
            if meta is not None:
                self.served_obs.append(self.grabber.observation(meta[0]))
            return meta

    return Traced


def check_served(served_obs: list, kept: list, fps: float) -> list:
    """The observation each kept frame (pts, frame) was served from, from
    its pts (served index / fps); fails where one is unknown or where the
    observations served go back."""
    if any(o is None for o in served_obs):
        raise AssertionError(f"served frames of unknown observation: {served_obs.count(None)}")
    if any(b < a for a, b in zip(served_obs, served_obs[1:])):
        raise AssertionError("the observations served went back")
    obs = [served_obs[int(round(pts * fps))] for pts, _ in kept]
    if any(b < a for a, b in zip(obs, obs[1:])):
        raise AssertionError(f"kept frames out of order: observations {obs}")
    return obs


def replay_vs_eager(torch, proc, frame, n: int = 30) -> dict:
    """A frame's eager program against two replays of its graph (equal
    bytes), and the replays' ms/frame over n device-resident frames."""
    x = proc.put_frame(frame.reshape(frame.shape[0], -1))
    eager = proc._rgb48_eager(x)
    replays = [proc.process_rgb48_device(x) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        proc.process_rgb48_device(x)
    torch.cuda.synchronize()
    return {"equal": all(torch.equal(r, eager) for r in replays),
            "replay_ms": round((time.perf_counter() - t0) * 1e3 / n, 3)}


def phase_live(torch, np, native, smi: str, tmp: str) -> tuple[dict, dict]:
    """Phase 13 (its checks in the constants' comment above). Returns the
    launch counts of the paths live_bf16 (the warm-up's eager run and capture,
    then 1080p replays), live_letterbox (the 720p capture's first frame: an
    eager run and a capture) and shell_swaps (each swap's new processor's
    first frame) and the phase's figures."""
    import threading
    import urllib.error
    import urllib.request
    import zlib

    from hdrtv_tpu_torch.config import processing_dims
    from hdrtv_tpu_torch.pipeline.audio import AudioAttachment, AudioPlayer, AutoMutePolicy
    from hdrtv_tpu_torch.pipeline.bridge import AudioSyncBridge
    from hdrtv_tpu_torch.cli import grabber_kind
    from hdrtv_tpu_torch.pipeline.capture import make_grabber
    from hdrtv_tpu_torch.pipeline.live import LiveSource, synthetic_grabber
    from hdrtv_tpu_torch.pipeline.runner import PipelineRunner
    from hdrtv_tpu_torch.pipeline.shell import ShellController
    from hdrtv_tpu_torch.pipeline.sinks import NullSink
    from hdrtv_tpu_torch.pipeline.source import SyntheticSource
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    t_phase = time.perf_counter()
    set_path_env({"mega": "1"})
    full = processing_dims("1080p")
    two = {k: 2 * v for k, v in expected_launches("bf16_mega").items()}
    counts, figures = {}, {"card": smi}
    mib = 1 << 20

    # --- (a) live at full width, and a 720p capture letterboxed onto 1080p ----------------
    class KeepSink:
        def __init__(self):
            self.n, self.kept, self.first = 0, [], None

        def show(self, rgb48, pts=None):
            if self.first is None:
                self.first = time.perf_counter()
            if self.n % LIVE_KEEP == 0:
                self.kept.append((pts, rgb48.copy()))
            self.n += 1

        def close(self):
            pass

    proc = HDRTVNetTorch(WEIGHTS, precision="fp16", proc_resolution=full, persistent_cache=False)
    for path, (h, w) in LIVE_CAPTURES.items():
        log(f"phase 13: live {path}: synthetic {h}x{w} capture, {LIVE_FRAMES} frames at {LIVE_FPS:g} fps, "
            f"processed at {full[1]}x{full[0]} bf16 default")
        grab = ObservedGrabber(make_grabber("synthetic", width=w, height=h))
        torch.cuda.synchronize()
        native.reset_launch_counts()
        graphs0 = len(proc.graphs)
        if path == "live_bf16":
            warm_s = proc.warmup_compile(*full)  # the CLI's warm-up: the processing size's graph
        src = served_observations(LiveSource)(grab, process_fps=LIVE_FPS)
        sink = KeepSink()
        runner = PipelineRunner(src, proc, sink, realtime=True, max_frames=LIVE_FRAMES)
        try:
            t0 = time.perf_counter()
            m = runner.run()
            wall = time.perf_counter() - t0
        finally:
            src.close()
        torch.cuda.synchronize()
        counts[path] = read_counts(native)
        if counts[path] != two:
            raise AssertionError(f"{path}: counted {counts[path]}, one frame's eager run and capture {two}")
        obs = check_served(src.served_obs, sink.kept, LIVE_FPS)
        ref = synthetic_grabber(w, h)
        bad, at = [], 0
        for o, (pts, got) in zip(obs, sink.kept):
            while at < o:
                frame, at = ref(), at + 1
            want = proc.process_rgb48(frame)
            if not np.array_equal(got.reshape(want.shape), want):
                bad.append(o)
        gm = np.asarray(grab.ms[1:] or grab.ms)
        res = {"frames": m.frames, "shown": sink.n, "kept": len(sink.kept), "fps": round(m.fps, 3),
               "fps_1pct_low": round(m.fps_1pct_low, 3), "model_ms": round(m.model_ms, 3),
               "ring_ms": round(m.ring_ms, 3), "dropped": m.dropped, "flushed": runner.flushed,
               "observed": src.frames_observed, "served": src.frames_served,
               "grab_ms": round(float(gm.mean()), 3), "grab_p99_ms": round(float(np.percentile(gm, 99)), 3),
               "first_frame_s": round(sink.first - t0, 3), "wall_s": round(wall, 2),
               "captures": len(proc.graphs) - graphs0, "wrong": len(bad)}
        if path == "live_bf16":
            res["warmup_s"] = round(warm_s, 3)
        log(f"live {path}: {json.dumps(res)}; {smi}")
        if bad or m.frames != LIVE_FRAMES or sink.n != LIVE_FRAMES or res["captures"] != 1:
            raise AssertionError(f"{path}: {res}; frames of observations {bad[:10]} differ from process_rgb48")
        figures[path] = res
        del sink, src, runner

    # --- (b) the live CLI in a child process, and what "auto" resolves to here -----------
    g = make_grabber(None)
    kind = grabber_kind(g)
    auto_shape = list(g().shape)
    if hasattr(g, "close"):
        g.close()
    env = {**os.environ, "HDRTVNET_PREFS_PATH": os.path.join(tmp, "prefs.json"),
           "HDRTVNET_ENGINE_CACHE_DIR": os.path.join(tmp, "engines"), "HDRTVNET_CACHE_DIR": os.path.join(tmp, "cache")}
    cmd = [sys.executable, "-m", "hdrtv_tpu_torch.cli", "live", "--capture", "synthetic", "--resolution", "1080p",
           "--fps", "60", "--frames", str(LIVE_CLI_FRAMES), "--display", "null"]
    log("phase 13: " + " ".join(cmd[1:]) + f"; auto resolves to {kind} {auto_shape[1]}x{auto_shape[0]}")
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    lines = res.stdout.strip().splitlines()
    for line in lines[-4:]:
        log("  cli: " + line)
    if (res.returncode != 0 or not lines or f"frames={LIVE_CLI_FRAMES} " not in lines[-1]
            or "capture synthetic: synthetic" not in lines):
        raise AssertionError(f"live cli: exit {res.returncode}; {res.stdout[-1000:]} {res.stderr[-2000:]}")
    figures["cli"] = {"rc": res.returncode, "seconds": round(cli_s, 1), "summary": lines[-1],
                      "auto": {"grabber": kind, "shape": auto_shape}}

    # --- (c) the shell under load ---------------------------------------------------------
    state = {"precision": "fp16", "res": full}

    def factory(precision=None, proc_resolution=None):
        if precision is not None:
            state["precision"] = precision
        if proc_resolution is not None:
            state["res"] = tuple(proc_resolution)
        return HDRTVNetTorch(WEIGHTS, precision=state["precision"], proc_resolution=state["res"],
                             persistent_cache=False)

    class CrcSink:
        def __init__(self):
            self.got = []  # (time, generation, pts, shape, crc, allocated, reserved)
            self.runner = None

        def show(self, rgb48, pts=None):
            self.got.append((time.perf_counter(), self.runner._generation, pts, rgb48.shape,
                             zlib.crc32(np.ascontiguousarray(rgb48)), torch.cuda.memory_allocated(),
                             torch.cuda.memory_reserved()))

        def close(self):
            pass

    shell_fps = LIVE_FPS
    sink = CrcSink()
    runner = PipelineRunner(SyntheticSource(*full, fps=shell_fps, frames=10 ** 6), proc, sink, realtime=True,
                            processor_factory=factory)
    sink.runner = runner
    ctl = ShellController(runner, runner.source, precision="fp16", resolution="1080p")
    runner.on_metrics = ctl.on_metrics
    torch.cuda.synchronize()
    mem0, reserved0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    native.reset_launch_counts()
    errors = []

    def run():
        try:
            runner.run()
        except BaseException as e:  # re-raised below, on the main thread
            errors.append(e)

    def frames_since(n0: int, pred=lambda f: True, n: int = SHELL_STEP_FRAMES, timeout: float = 60.0):
        """The first of the frames delivered after the n0-th that satisfy
        pred, once n of them have arrived (None at the timeout)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and t.is_alive():
            new = [f for f in sink.got[n0:] if pred(f)]
            if len(new) >= n:
                return new[0]
            time.sleep(0.005)
        return None

    shapes = {name: (processing_dims(name)[1], 3 * processing_dims(name)[0]) for name in ("540p", "720p", "1080p")}
    t = threading.Thread(target=run, daemon=True)
    t.start()
    steps = []
    try:
        if frames_since(0) is None:
            raise AssertionError("shell: no frames before the first key")
        for key in SHELL_KEYS:
            g0, n0, t0 = runner._generation, len(sink.got), time.perf_counter()
            action = ctl.handle_key(key)
            step = {"key": key, "action": action}
            if key in ("p", "r"):  # a new processor: the first frame of its program
                first = frames_since(n0, lambda f, _g0=g0, _s=shapes[ctl.resolution]: f[1] > _g0 and f[3] == _s)
                if first is None:
                    raise AssertionError(f"shell: no frames after {action}")
                step.update(first_frame_s=round(first[0] - t0, 3), allocated_mib=round(first[5] / mib, 1),
                            reserved_mib=round(first[6] / mib, 1))
            elif key == " " and ctl.paused:
                # what was in flight drains (at most the out ring's ring + 2 slots), then nothing
                time.sleep(SHELL_PAUSE_S)
                drained = len(sink.got) - n0
                time.sleep(SHELL_PAUSE_S)
                step.update(frames_after_pause=drained, frames_while_paused=len(sink.got) - n0 - drained)
                if drained > runner.ring + 2 or step["frames_while_paused"]:
                    raise AssertionError(f"shell: the pause did not stop the runner: {step}, ring {runner.ring}")
            elif key == ".":  # the paused seek's redraw: one frame
                if frames_since(n0, n=1, timeout=10.0) is None:
                    raise AssertionError("shell: no paused redraw after '.'")
                time.sleep(SHELL_PAUSE_S)
                step["redrawn"] = len(sink.got) - n0
                if step["redrawn"] != 1:
                    raise AssertionError(f"shell: the paused seek redrew {step['redrawn']} frames, not 1")
            elif key in (" ", "LEFT"):  # resumed, or seeking back: frames flow again
                first = frames_since(n0, lambda f, _g0=g0: f[1] > _g0 or key == " ")
                if first is None:
                    raise AssertionError(f"shell: no frames after {action}")
                step["first_frame_s"] = round(first[0] - t0, 3)
            steps.append(step)
            log(f"shell: {json.dumps(step)}")
    finally:
        runner.stop()
        t.join(timeout=60)
    if t.is_alive():
        raise AssertionError("shell: the runner did not stop")
    if errors:
        raise errors[0]
    torch.cuda.synchronize()
    counts["shell_swaps"] = read_counts(native)
    want_counts = {k: 2 * v + 2 * _BF16_MEGA_720P.get(k, 0) + 2 * int(k == "pack_rgb48") for k, v in two.items()}
    if counts["shell_swaps"] != want_counts:
        raise AssertionError(f"shell: counted {counts['shell_swaps']}, want {want_counts} (an eager run and a "
                             "capture of the bf16 default at 1080p twice and at 720p, and of the 540p natural "
                             "program)")
    # The first swap's processor comes beside the first one (kept here as the 1080p reference);
    # each later swap drops the processor before it: allocated and reserved memory (the graph
    # pools) at its first frame at most SHELL_MEM_SLACK over the first swap's.
    swaps = [st for st in steps if st["key"] in ("p", "r")]
    grew = [st for st in swaps[1:] if st["allocated_mib"] > swaps[0]["allocated_mib"] + SHELL_MEM_SLACK / mib
            or st["reserved_mib"] > swaps[0]["reserved_mib"] + SHELL_MEM_SLACK / mib]
    if grew:
        raise AssertionError(f"shell: memory grew from swap to swap: {swaps}")
    # every frame against process_rgb48 on the program its size names (all 1080p programs are
    # the bf16 default on the float weights: the precision swap's token int8 maps to bf16)
    by_shape = {}
    for f in sink.got:
        by_shape.setdefault(f[3], []).append(f)
    src = SyntheticSource(*full, fps=shell_fps, frames=10 ** 6)
    wrong, replay720 = {}, None
    for name in ("1080p", "540p", "720p"):
        frames = by_shape.pop(shapes[name], [])
        ref = proc if name == "1080p" else factory(precision="fp16", proc_resolution=processing_dims(name))
        bad = 0
        for _, _, pts, _, crc, _, _ in frames:
            src.seek(int(round(pts * shell_fps)))
            out = ref.process_rgb48(src.read_with_meta()[0])
            bad += zlib.crc32(np.ascontiguousarray(out)) != crc
        wrong[name] = [len(frames), bad]
        if name == "720p":
            # 720p's first run on the card: its replay against its eager bytes, letterboxed from
            # 1080p as the shell runs it and on a native 1280 x 720 frame (the letterbox's share)
            src.seek(0)
            native720 = HDRTVNetTorch(WEIGHTS, precision="fp16", persistent_cache=False)
            w7, h7 = processing_dims("720p")
            noise = (np.random.RandomState(720).rand(h7, w7, 3) * 255).astype(np.uint8)
            replay720 = {"letterboxed": replay_vs_eager(torch, ref, src.read_with_meta()[0]),
                         "native": replay_vs_eager(torch, native720, noise)}
            # the native frame against the same program on the CPU (plain versions, no kernel)
            t_cpu = time.perf_counter()
            cpu = HDRTVNetTorch(WEIGHTS, precision="fp16", device="cpu", persistent_cache=False).process_rgb48(noise)
            d = np.abs(eager_rgb48(native720, noise).astype(np.int64) - cpu.astype(np.int64))
            replay720["card_vs_cpu"] = {"max_codes": int(d.max()), "mean_codes": round(float(d.mean()), 3),
                                        "differ": round(float((d > 0).mean()), 4),
                                        "cpu_s": round(time.perf_counter() - t_cpu, 2)}
            native720.graphs.clear()
            del native720, cpu
        if ref is not proc:
            ref.graphs.clear()
            del ref
            torch.cuda.empty_cache()
    if by_shape:
        raise AssertionError(f"shell: frames of no program's size: {list(by_shape)}")
    shell = {"steps": steps, "frames": len(sink.got), "flushed": runner.flushed, "by_size": wrong,
             "allocated_before_mib": round(mem0 / mib, 1), "reserved_before_mib": round(reserved0 / mib, 1),
             "replay_720p": replay720}
    log(f"shell: {json.dumps({k: v for k, v in shell.items() if k != 'steps'})}; {smi}")
    if any(bad for _, bad in wrong.values()) or not all(n for n, _ in wrong.values()):
        raise AssertionError(f"shell: frames [delivered, wrong] by size {wrong}")
    if not replay720 or not all(replay720[k]["equal"] for k in ("letterboxed", "native")):
        raise AssertionError(f"shell: a 720p replay differs from its eager bytes: {replay720}")
    vs = replay720["card_vs_cpu"]
    if vs["max_codes"] > NAT_BF16_CODES[0] or vs["mean_codes"] > NAT_BF16_CODES[1]:
        raise AssertionError(f"shell: the native 720p frame, card against CPU: {vs}, bound {NAT_BF16_CODES}")
    figures["shell"] = shell
    del sink, runner, ctl

    # --- (d) the audio attach on a fake mpv -----------------------------------------------
    bindir = os.path.join(tmp, "bin")
    os.makedirs(bindir, exist_ok=True)
    fake = os.path.join(bindir, "mpv")
    with open(fake, "w") as f:
        f.write(FAKE_MPV.replace("{python}", sys.executable))
    os.chmod(fake, 0o755)
    media = os.path.join(tmp, "clip.bin")
    with open(media, "wb") as f:
        f.write(b"x")
    old_path = os.environ["PATH"]
    os.environ["PATH"] = bindir + os.pathsep + old_path
    try:
        player = AudioPlayer(media)
    finally:
        os.environ["PATH"] = old_path
    issued = []
    try:
        # every sample unstable (the floor over any fps) until muted, then a floor of 1 fps:
        # the policy mutes, then restores through its fade
        policy = AutoMutePolicy(target_fps=LIVE_FPS, min_fps=1e6, unstable_need=2, stable_need=3, hold_s=0.3)

        def set_gain(gain):
            issued.append(gain)
            return player.set_gain(gain)

        attach = AudioAttachment(policy, set_gain)

        def on_metrics(snap):
            attach.on_metrics(snap.fps)
            if policy.muted:
                policy.min_fps = 1.0

        m = PipelineRunner(SyntheticSource(*full, fps=LIVE_FPS, frames=AUDIO_FRAMES), proc, NullSink(),
                           realtime=True, on_metrics=on_metrics).run()
        log_path, cmds = player.ipc_path + ".log", []
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if os.path.exists(log_path):
                with open(log_path) as f:
                    cmds = [json.loads(x) for x in f if x.strip()]
                if len(cmds) >= len(issued):
                    break
            time.sleep(0.02)
    finally:
        player.close()
    volumes = [c["command"][2] / 100.0 for c in cmds if c["command"][:2] == ["set_property", "volume"]]
    audio = {"frames": m.frames, "fps": round(m.fps, 3), "issued": issued, "ipc_volumes": volumes}
    if volumes != issued or 0.0 not in issued or issued[-1] != 1.0:
        raise AssertionError(f"audio: the policy issued {issued}, the fake mpv received {volumes}")
    import importlib.util

    if importlib.util.find_spec("cv2") is None:
        audio["cli"] = "not run: no cv2 on this machine (the convert --audio leg needs a video)"
    else:
        audio["cli"] = live_audio_cli(np, tmp)
    log(f"audio: {json.dumps(audio)}")
    figures["audio"] = audio

    # --- (e) the tab-audio bridge -----------------------------------------------------------
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def req(url, payload):
        r = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST",
                                   headers={"Content-Type": "application/json"})
        try:
            with opener.open(r, timeout=5) as resp:
                return resp.status, json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read().decode())

    with AudioSyncBridge(host="127.0.0.1", port=0) as b:
        base = b.address()
        st_start, body = req(f"{base}/session/start", {"title": "chip_smoke", "fps": LIVE_FPS, "has_audio": True})
        sid = body.get("session_id")
        codes = [st_start, req(f"{base}/session/{sid}/keepalive", {"has_audio": True})[0],
                 req(f"{base}/session/{sid}/stop", {})[0], req(f"{base}/session/{sid}/keepalive", {})[0]]
    bridge = {"codes": codes}
    log(f"bridge: start, keepalive, stop, late keepalive: {codes}")
    if codes != [200, 200, 200, 410]:
        raise AssertionError(f"bridge: {codes}, want [200, 200, 200, 410]")
    figures["bridge"] = bridge

    proc.graphs.clear()
    del proc
    torch.cuda.empty_cache()
    figures["phase_s"] = round(time.perf_counter() - t_phase, 1)
    log(f"phase 13: {figures['phase_s']} s (budget {LIVE_PHASE_S:g})")
    if figures["phase_s"] > LIVE_PHASE_S:
        raise AssertionError(f"phase 13 took {figures['phase_s']} s, over its {LIVE_PHASE_S:g} s")
    return counts, figures


def live_audio_cli(np, tmp: str) -> str:
    """convert --audio on a short 1080p MJPG clip, in this process, with no
    mpv on the PATH: it must say "audio attach unavailable" and exit 0."""
    import contextlib
    import io
    import shutil

    import cv2

    from hdrtv_tpu_torch import cli

    clip = os.path.join(tmp, "audio_clip.avi")
    wr = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), 24, (1920, 1080))
    for i in range(8):
        wr.write(smooth_frame(np, 1080, 1920, 100 + i))
    wr.release()
    if shutil.which("mpv") is not None:
        return f"not run: an mpv is on this machine's PATH ({shutil.which('mpv')})"
    buf = io.StringIO()
    saved = {k: os.environ.get(k) for k in ("HDRTVNET_PREFS_PATH", "HDRTVNET_ENGINE_CACHE_DIR")}
    os.environ["HDRTVNET_PREFS_PATH"] = os.path.join(tmp, "prefs_audio.json")
    os.environ["HDRTVNET_ENGINE_CACHE_DIR"] = os.path.join(tmp, "engines")
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["convert", "--video", clip, "--audio", "--display", "null", "--no-realtime",
                           "--resolution", "1080p", "--prefetch", "0"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = buf.getvalue()
    if rc != 0 or "audio attach unavailable" not in out or "frames=8 " not in out:
        raise AssertionError(f"convert --audio: exit {rc}; {out[-2000:]}")
    return "ran: " + next(ln for ln in out.splitlines() if "audio attach unavailable" in ln)


# Phase 14: the mesh (hdrtv_tpu_torch/parallel/, the halo branches of models/s2d.py and
# models/hg_s2d.py). Every shard runs on the one card (cuda:0 listed n times), each a thread
# on its own stream. (a) One frame of each MESH_CHECKS case with every kernel call held
# against its plain version on the same inputs (the wrapper's own plain path, on the card),
# per call: the window shapes each kernel ran at, and the error in MESH_CALL_BOUND's units:
# bf16 steps of max(1, |plain|) (tools/bf16_spread.py --per-call's measure), fp32 the error
# over max(1, |plain|), a u16 output (packed tail, hg_tail, pack_rgb48) in codes; a
# kernel's int8 form apart (_w8a8). The bounds: phase 2's per kernel (one bf16 step, two
# for resblock and agcm_head; fp32 1e-4, trunk3 5e-4; one code for an fp32 pack) where the
# real weights keep to them, else twice the largest seen at 1080p and 4K, on one card and on
# its shards' windows alike (NVIDIA H100 80GB HBM3, 700 W): trunk3 bf16 2.5 steps, the
# int8 resblock 2.875 and sft_conv3 1.0, the packed tail 44 codes, hg_tail 61 (phase 2's
# random weights stay within 2 steps and its computed code bounds; these are the real
# checkpoint's). (b) Each MESH_PROGRAMS program at 1080p over n = 2 and 4 shards against
# the single-device program's bytes (eager both): the unequal values, the largest and the
# mean difference in u16 codes, the largest at most MESH_LSB; the launches of one sharded
# frame n times the single-device frame's (each shard runs the program once). The kernels
# sum each pixel alike wherever its window starts, and the bf16 and int8 defaults, the fp32
# program and the fp32 HG composite were bit-equal; where a torch op between the kernels
# picks its algorithm by the tensor's width, a rounding flips: the HG generator's cuDNN
# bf16 convs (by a stage-by-stage comparison of each window's result with the whole
# frame's, every one of its encoder stages parted by one bf16 step on a few hundred values a
# shard; 67 codes at the output), cuDNN's bf16 2×2 conv down_conv3 at 4K (the only stage
# apart: one step on 15-23 values a shard; 100 codes), cuBLAS's fp32 1×1 products of the
# fp32 program at 360 × 640 (1 code, tests/test_torch_cuda.py). MESH_LSB: 0 where
# bit-equal, JAX's one code for fp32, twice the largest seen for the rest. (c) The bf16
# default at 4K (2160 × 3840) over 4 shards against the single-device 4K frame, after (a)
# held every kernel of both at their 4K shapes. (d) process_rgb48_batch over a data axis of 2 (a batch
# of MESH_DP_FRAMES frames) against the same batch without a mesh (flat rows, frame after
# frame), bit for bit, and beside it (information) against process_rgb48, whose pair planes
# contract the condition image in another layout; the export farm as two host
# processes (export_video_multihost, a torch.distributed gloo group on localhost), each
# segment and the joined raw master bit-equal to process_rgb48 of the synthetic frames.
# (e) A planted fault: trunk3's halo radius one align short (8 of its 9), which must break
# (b)'s check. ms/frame of each sharded frame beside the single-device one (eager, one sync
# after MESH_FRAMES frames). At most MESH_PHASE_S.
MESH_SIZE = (1080, 1920)
MESH_4K = (2160, 3840)
MESH_NS = (2, 4)
MESH_PROGRAMS = {"mesh_bf16": "bf16_mega", "mesh_int8": "int8_bf16_mega", "mesh_hg_bf16": "hg_bf16",
                 "mesh_hg_fp32": "hg_fp32", "mesh_fp32": "fp32"}
MESH_CHECKS = (("mesh_bf16", MESH_SIZE, 2), ("mesh_bf16", MESH_SIZE, 4), ("mesh_int8", MESH_SIZE, 4),
               ("mesh_hg_bf16", MESH_SIZE, 4), ("mesh_fp32", MESH_SIZE, 4), ("mesh_bf16", MESH_4K, 1),
               ("mesh_bf16", MESH_4K, 4))
MESH_CALL_BOUND = {
    "bf16": {"fused_resblock": 2.0, "fused_trunk3": 5.0, "fused_agcm_head": 2.0, "fused_resblock_w8a8": 5.75,
             "fused_sft_conv3_v2_w8a8": 2.0},
    "f32": {"fused_trunk3": 5e-4},
    "u16_bf16": {"fused_tail": 88.0, "fused_hg_tail": 122.0, "fused_tail_w8a8": 2.0},
}
MESH_CALL_DEFAULT = {"bf16": 1.0, "f32": ATOL, "u16_bf16": 1.0, "u16_f32": 1.0}
# (b)'s bound by program (and the 4K frame), the largest difference in u16 codes
MESH_LSB = {"mesh_bf16": 0, "mesh_int8": 0, "mesh_hg_bf16": 134, "mesh_hg_fp32": 1, "mesh_fp32": 1,
            "mesh_bf16_4k": 200}
MESH_FRAMES = 3
MESH_DP_FRAMES = 4
MESH_FARM_FRAMES = 4
MESH_PHASE_S = 120.0
MESH_DEVICE = "cuda:0"  # every shard's device: the one card, listed n times
MESH_KEYS = ("card", "devices", "calls", "frames", "uhd", "dp", "farm", "fault", "phase_s")
_MESH_WRAPPERS = {"s2d": ("fused_agcm_head", "fused_cond_chain", "fused_down2", "fused_mix_chain", "fused_resblock",
                          "fused_sft_conv3_v2", "fused_tail", "fused_trunk3", "fused_block_conv3", "pack_rgb48"),
                  "hg_s2d": ("fused_hg_tail",)}


def mesh_line(figures: dict) -> str:
    """Phase 14's {"mesh": ...} line, its keys in MESH_KEYS' order."""
    if set(figures) != set(MESH_KEYS):
        raise AssertionError(f"mesh line: keys {sorted(figures)} != {sorted(MESH_KEYS)}")
    return json.dumps({"mesh": {k: figures[k] for k in MESH_KEYS}})


def call_error(torch, out, ref, dtype) -> tuple[str, float]:
    """One kernel call's output against its plain version's: a u16 output in
    codes (unit u16_<type>, ``dtype`` the call's activations'), else bf16
    steps of max(1, |plain|) (a bf16 output) or the error over max(1,
    |plain|) (an fp32 one)."""
    if out.dtype == torch.uint16:
        tag = "f32" if dtype == torch.float32 else "bf16"
        return f"u16_{tag}", float((out.to(torch.int32) - ref.to(torch.int32)).abs().max())
    tag = "f32" if out.dtype == torch.float32 else "bf16"
    e = (out.float() - ref.float()).abs()
    if tag == "f32":
        return tag, float((e / ref.float().abs().clamp_min(1.0)).max())
    return tag, float((e / (2.0 ** -7 * ref.float().abs().clamp_min(1.0))).max())


class MeshCallChecks:
    """Every kernel wrapper the frame programs call, replaced by one that
    launches the kernel, then runs the same wrapper's plain path on the same
    (card) inputs in the calling thread only (``native.on_cpu`` answers True
    there while it runs, and the int8 layers' check takes their parameters
    where they lie), and records the call: kernel, input shape, element
    type, error. The plain runs launch nothing."""

    def __init__(self, torch, native):
        import threading

        from hdrtv_tpu_torch.models import hg_s2d, s2d
        from hdrtv_tpu_torch.ops import conv_kernels, megakernel

        self.torch, self.native, self.records = torch, native, []
        self._tls, self._lock = threading.local(), threading.Lock()
        self._mods = {"s2d": s2d, "hg_s2d": hg_s2d, "native": native, "megakernel": megakernel,
                      "conv_kernels": conv_kernels}
        self._saved = {}

    def __enter__(self):
        real = self.native.on_cpu
        self._saved[("native", "on_cpu")] = real
        self.native.on_cpu = lambda *ts: True if getattr(self._tls, "plain", False) else real(*ts)
        for mod_name in ("megakernel", "conv_kernels"):
            mod = self._mods[mod_name]
            check = mod.check_qargs
            self._saved[(mod_name, "check_qargs")] = check
            mod.check_qargs = lambda name, qa, c, co, cuda, _check=check: _check(
                name, qa, c, co, qa.w.device.type == "cuda" if getattr(self._tls, "plain", False) else cuda)
        for mod_name, names in _MESH_WRAPPERS.items():
            mod = self._mods[mod_name]
            for name in names:
                fn = getattr(mod, name)
                self._saved[(mod_name, name)] = fn
                setattr(mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for (mod_name, name), fn in self._saved.items():
            setattr(self._mods[mod_name], name, fn)
        self._saved.clear()

    def _wrap(self, name, fn):
        torch = self.torch

        def call(*args, **kw):
            kernel = name + ("_w8a8" if any(kw.get(k) is not None for k in ("qargs", "qargs1", "qargs_hr")) else "")
            out = fn(*args, **kw)
            self._tls.plain = True
            try:
                ref = fn(*args, **kw)
            finally:
                self._tls.plain = False
            outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
            # the activations' type: the first float argument (agcm_head's frame is u8, its output bf16 or fp32)
            dtype = next(t.dtype for t in args if isinstance(t, torch.Tensor) and t.is_floating_point())
            unit, err, abs_err = "bf16", 0.0, 0.0
            for o, r in zip(outs, refs):
                unit, e = call_error(torch, o, r, dtype)
                err = max(err, e)
                abs_err = max(abs_err, float((o.float() - r.float()).abs().max()))
            with self._lock:
                self.records.append({"kernel": kernel, "shape": list(args[0].shape), "dtype": str(args[0].dtype),
                                     "unit": unit, "err": err, "abs_err": abs_err})
            return out
        return call

    def summary(self) -> dict:
        """Per kernel: its calls, the window shapes it ran at, the largest
        error in its unit and the largest absolute one, and its bound."""
        out: dict = {}
        for r in self.records:
            s = out.setdefault(r["kernel"], {"calls": 0, "shapes": [], "unit": r["unit"], "err": 0.0, "abs_err": 0.0})
            s["calls"] += 1
            if r["shape"] not in s["shapes"]:
                s["shapes"].append(r["shape"])
            s["err"] = max(s["err"], r["err"])
            s["abs_err"] = max(s["abs_err"], r["abs_err"])
        for name, s in out.items():
            s["bound"] = MESH_CALL_BOUND.get(s["unit"], {}).get(name, MESH_CALL_DEFAULT[s["unit"]])
        return out


def codes_vs(torch, a, b) -> dict:
    """Two u16 outputs of one frame (any layout of the same bytes): the unequal
    values and the largest difference in codes."""
    d = (a.reshape(-1).to(torch.int32) - b.reshape(-1).to(torch.int32)).abs()
    return {"unequal": int((d > 0).sum()), "max_lsb": int(d.max()), "mean_lsb": round(float(d.double().mean()), 4)}


def mesh_frame_ms(torch, proc, x, n: int) -> float:
    proc._rgb48_eager(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        proc._rgb48_eager(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


MESH_FARM_SCRIPT = r"""
import json, os, sys
sys.path.insert(0, {root!r})
import torch
from hdrtv_tpu_torch.models.layers import fp32_math
from hdrtv_tpu_torch.parallel.multihost import initialize_distributed
from hdrtv_tpu_torch.pipeline.export import ExportConfig, export_video_multihost
from hdrtv_tpu_torch.pipeline.source import SyntheticSource
from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

assert initialize_distributed(), "no process group"
with fp32_math():
    proc = HDRTVNetTorch({weights!r}, device={device!r})
    stats = export_video_multihost(None, proc, ExportConfig(output={out!r}, codec="raw"), hosts=2,
                                   host_id=int(os.environ["RANK"]),
                                   source=SyntheticSource({w}, {h}, fps=30, frames={frames}))
torch.distributed.destroy_process_group()
print("FARM " + json.dumps(stats), flush=True)
"""


def phase_mesh(torch, np, native, smi: str, hg_weights: dict, tmp: str) -> tuple[dict, dict]:
    """Phase 14 (its checks in the constants' comment above). Returns the
    launch counts of the paths mesh_<program>_n<n> (one eager sharded 1080p
    frame each), mesh_4k_bf16_n4 and mesh_dp_bf16 (the batch over the data
    axis), and the phase's figures."""
    import socket

    from hdrtv_tpu_torch.parallel import halo
    from hdrtv_tpu_torch.parallel.mesh import Mesh, spatial_mesh
    from hdrtv_tpu_torch.parallel.multihost import segment_paths
    from hdrtv_tpu_torch.pipeline.source import SyntheticSource
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    t_phase = time.perf_counter()
    dev = torch.device(MESH_DEVICE)
    figures: dict = {"card": smi, "devices": {}, "calls": {}, "frames": {}}
    counts: dict = {}

    def weights_of(path):
        return path_weights(PATHS[path], hg_weights)

    def frame_of(path, h, w):
        spec = PATHS[path]
        if spec["hg"] or spec.get("int8"):
            return smooth_frame(np, h, w, h)
        return (np.random.RandomState(h).rand(h, w, 3) * 255).astype(np.uint8)

    def processors(path, n):
        spec = PATHS[path]
        set_path_env(spec)
        single = HDRTVNetTorch(weights_of(path), precision=spec["precision"], device=dev)
        mesh = spatial_mesh(n, devices=[dev] * n) if n > 1 else None
        sharded = HDRTVNetTorch(weights_of(path), precision=spec["precision"], device=dev, mesh=mesh) if mesh else None
        return single, sharded

    # (a) every kernel call of one frame against its plain version, at the windows' shapes
    log("phase 14: the mesh; shards on " + ", ".join(f"shard {k} -> {dev}" for k in range(max(MESH_NS))))
    for name, (h, w), n in MESH_CHECKS:
        path = MESH_PROGRAMS[name]
        single, sharded = processors(path, n)
        proc = sharded or single
        frame = frame_of(path, h, w)
        x = proc.put_frame(frame.reshape(h, w * 3))
        with MeshCallChecks(torch, native) as checks:
            proc._rgb48_eager(x)
            torch.cuda.synchronize()
        summary = checks.summary()
        key = f"{name}_{h}p_n{n}"
        figures["calls"][key] = {k: {"calls": s["calls"], "err": round(s["err"], 4), "bound": s["bound"],
                                     "shapes": s["shapes"]} for k, s in summary.items()}
        log(json.dumps({"mesh_calls": key, **figures["calls"][key]}))
        if n > 1:
            figures["devices"][key] = {f"shard{k}": str(d) for k, d in enumerate(proc.mesh.row(0))}
        bad = {k: (s["err"], s["bound"]) for k, s in summary.items() if s["err"] > s["bound"]}
        if bad or not summary:
            raise AssertionError(f"{key}: kernel calls beyond their bounds against the plain versions: {bad}")
        del single, sharded, proc, x
        torch.cuda.empty_cache()

    # (b) the sharded programs against the single-device bytes at 1080p; (c) 4K
    def run(name, path, h, w, ns):
        single, _ = processors(path, 1)
        frame = frame_of(path, h, w)
        xs = single.put_frame(frame.reshape(h, w * 3))
        ref = single._rgb48_eager(xs)
        native.reset_launch_counts()
        single._rgb48_eager(xs)
        torch.cuda.synchronize()
        one = read_counts(native)
        ms_single = mesh_frame_ms(torch, single, xs, MESH_FRAMES)
        row = {"single_ms": round(ms_single, 3), "single_launches": {k: v for k, v in one.items() if v}}
        for n in ns:
            _, sharded = processors(path, n)
            xm = sharded.put_frame(frame.reshape(h, w * 3))
            out = sharded._rgb48_eager(xm)
            native.reset_launch_counts()
            out = sharded._rgb48_eager(xm)
            torch.cuda.synchronize()
            got = read_counts(native)
            key = name if (h, w) == MESH_SIZE else f"{name}_4k"
            label = f"{key}_n{n}"
            counts[label] = got
            want = {k: n * v for k, v in one.items()}
            apart = codes_vs(torch, out, ref)
            ms = mesh_frame_ms(torch, sharded, xm, MESH_FRAMES)
            row[f"n{n}"] = {"ms": round(ms, 3), **apart}
            log(f"phase 14: {label} {h}x{w}: {ms:.3f} ms/frame sharded against {ms_single:.3f} single-device "
                f"(eager); {apart['unequal']} unequal values, max {apart['max_lsb']} codes, mean "
                f"{apart['mean_lsb']}; {smi}")
            if got != want:
                raise AssertionError(f"{label}: launches {got} != {n} x the single-device frame's {want}")
            if not any(got.values()) or apart["max_lsb"] > MESH_LSB[key]:
                raise AssertionError(f"{label}: {apart} against the single-device frame "
                                     f"(bound {MESH_LSB[key]} codes)")
            del sharded, xm, out
        del single, xs, ref
        torch.cuda.empty_cache()
        return row

    for name, path in MESH_PROGRAMS.items():
        figures["frames"][name] = run(name, path, *MESH_SIZE, MESH_NS)
    figures["uhd"] = run("mesh_bf16", "bf16_mega", *MESH_4K, (4,))

    # (d) the batch over a data axis of 2, and the export farm as two host processes
    single, _ = processors("bf16_mega", 1)
    h, w = MESH_SIZE
    frames = np.stack([frame_of("bf16_mega", h, w)] + [
        (np.random.RandomState(s).rand(h, w, 3) * 255).astype(np.uint8) for s in range(MESH_DP_FRAMES - 1)])
    plain_batch = single.process_rgb48_batch(frames)  # no mesh: every frame as flat rows, one after another
    native.reset_launch_counts()
    t0 = time.perf_counter()
    batch = single.process_rgb48_batch(frames, mesh=Mesh([[dev], [dev]]))
    dp_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    counts["mesh_dp_bf16"] = read_counts(native)
    expected = {k: len(frames) * v for k, v in expected_launches("bf16_mega").items()}
    dp_equal = bool(np.array_equal(batch, plain_batch))
    # information: process_rgb48 ships pair planes, whose condition image contracts another layout
    vs_rgb48 = [codes_vs(torch, torch.from_numpy(batch[i].astype(np.int32)),
                         torch.from_numpy(single.process_rgb48(frames[i]).astype(np.int32)))["max_lsb"]
                for i in range(len(frames))]
    figures["dp"] = {"frames": len(frames), "data": 2, "ms_per_frame": round(dp_ms, 3), "bit_equal": dp_equal,
                     "vs_process_rgb48_max_lsb": max(vs_rgb48)}
    log(f"phase 14: process_rgb48_batch over data = 2: {json.dumps(figures['dp'])}")
    if not dp_equal or counts["mesh_dp_bf16"] != expected:
        raise AssertionError(f"data-parallel batch: bit-equal {dp_equal}, launches {counts['mesh_dp_bf16']}")

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = os.path.join(tmp, "farm.mov")
    script = MESH_FARM_SCRIPT.format(root=ROOT, weights=WEIGHTS, device=str(dev), out=out, w=w, h=h,
                                     frames=MESH_FARM_FRAMES)
    procs = []
    t0 = time.perf_counter()
    for rank in (1, 0):
        env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": "2",
               "RANK": str(rank), "PYTHONPATH": ROOT}
        procs.append(subprocess.Popen([sys.executable, "-c", script], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    farm_s = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        raise AssertionError("farm hosts failed:\n" + "\n".join(t[-3000:] for t in texts))
    stats = [json.loads(next(ln for ln in t.splitlines() if ln.startswith("FARM "))[5:]) for t in texts]
    src = SyntheticSource(w, h, fps=30, frames=MESH_FARM_FRAMES)
    want = np.stack([single.process_rgb48(src.read_with_meta()[0]) for _ in range(MESH_FARM_FRAMES)])
    segs = [np.fromfile(p + ".rgb48", np.uint16) for p in segment_paths(out, 2)]
    master = np.fromfile(out + ".rgb48", np.uint16)
    cut = stats[1]["frame_range"][1]
    farm_equal = (np.array_equal(segs[0], want[:cut].reshape(-1)) and np.array_equal(segs[1], want[cut:].reshape(-1))
                  and np.array_equal(master, want.reshape(-1)))
    figures["farm"] = {"hosts": 2, "frames": MESH_FARM_FRAMES, "ranges": [st["frame_range"] for st in stats[::-1]],
                       "bit_equal": farm_equal, "seconds": round(farm_s, 1)}
    log(f"phase 14: export farm, two host processes: {json.dumps(figures['farm'])}")
    if not farm_equal or not stats[1].get("concatenated"):
        raise AssertionError(f"export farm: {figures['farm']}")
    del single, batch, plain_batch

    # (e) the planted fault: trunk3's radius one align short must break (b)'s check
    single, sharded = processors("bf16_mega", 4)
    frame = frame_of("bf16_mega", h, w)
    ref = single._rgb48_eager(single.put_frame(frame.reshape(h, w * 3)))
    orig = halo.pick_radius

    def short(w_local, need, **kw):
        r = orig(w_local, need, **kw)
        return r - kw.get("align", 2) if need == 9 else r

    halo.pick_radius = short
    try:
        bad = sharded._rgb48_eager(sharded.put_frame(frame.reshape(h, w * 3)))
    finally:
        halo.pick_radius = orig
    figures["fault"] = {"planted": "trunk3 radius one align short", **codes_vs(torch, bad, ref)}
    log(f"phase 14: planted fault: {json.dumps(figures['fault'])}")
    if figures["fault"]["max_lsb"] <= MESH_LSB["mesh_bf16"]:
        raise AssertionError(f"the planted fault passed the sharded frame's check: {figures['fault']}")
    del single, sharded, ref, bad
    torch.cuda.empty_cache()
    set_path_env(PATHS["bf16_mega"])
    figures["phase_s"] = round(time.perf_counter() - t_phase, 1)
    log(f"phase 14: {figures['phase_s']} s (budget {MESH_PHASE_S:g})")
    if figures["phase_s"] > MESH_PHASE_S:
        raise AssertionError(f"phase 14 took {figures['phase_s']} s, over its {MESH_PHASE_S:g} s")
    return counts, figures


# Phase 15: the double-s2d mode (models/dd.py ensemble_dd; no runtime option or CLI flag
# drives it, in either package) at 1080p in bf16 and fp32, on the shipped weights and a
# seeded noise frame. (a) Every kernel call of one dd frame against its plain version on the
# same inputs at its own shape (MeshCallChecks), within phase 2's bound: bf16 one step (two
# for resblock), fp32 1e-4 absolute; down2 runs at down_conv2 and at CondNet3.2 and CondNet4.2
# with a_sub = 1 on their own inputs (the s2d program reads those two as windows of the
# consolidated CondNet down conv: shapes no other path launches). (b) The frame against the
# same program with every kernel wrapper on its plain version on the card (native.on_cpu
# answering True), in u16 codes, within DD_FRAME_CODES: phase 3's card-against-CPU frame bound,
# which phase 4's frames are held to (fp32 4 codes; bf16 max 1536, mean 34); a planted fault,
# down_conv1's w_dd_s2 weight with its two row taps swapped (its Δ one row off), run through
# the kernels, must break it. (c) The frame against the port's ensemble_s2d of the same frame
# (in bf16 its megakernel program), max abs and u16 codes: fp32 within DD_VS_S2D_FP32 codes
# (phase 3's fp32 frame bound); bf16 printed (another program, rounding elsewhere). (d) One
# eager frame's launches, counts set to 0 before and read after, equal to DD_LAUNCHES (paths
# dd_bf16, dd_fp32 of the kernels line). (e) ms/frame over DD_FRAMES frames (one sync) and,
# under torch.profiler, the frame's device ms split between the port's kernels and the torch
# ops (tools/profile_frame.py's groups), and the DD_TOP kernels by device time. (f) The
# per-device launcher caches: a fresh process whose two threads, each on its own stream, make
# the first launch of block_conv3's bf16 Hopper tile and then of its fp32 3×TF32 tile at once;
# every launch must succeed, the two threads' outputs equal bit for bit and within one bf16
# step / 1e-4 of the plain version, a repeat must add no cache, and the device ordinals the
# launchers cached for are printed (hdrtv_launcher_caches). At most DD_PHASE_S.
DD_SIZE = (1080, 1920)
DD_DEVICE = "cuda"
DD_POLICY = {"dd_bf16": "bf16", "dd_fp32": "fp32"}
DD_LAUNCHES = {"dd_bf16": {"down2": 3, "resblock": 2, "sft_conv3": 4, "block_conv3": 2},
               "dd_fp32": {"down2": 3, "block_conv3": 10}}
DD_CALL_BOUND = {"fused_resblock": 2.0}  # bf16 steps; 1 for the others; fp32: ATOL absolute
DD_FRAME_CODES = {"fp32": (4, None), "bf16": (1536, 34.0)}
DD_VS_S2D_FP32 = 4
DD_FRAMES = {"dd_bf16": 10, "dd_fp32": 3}
DD_PROFILE_FRAMES = 3
DD_TOP = 8  # kernels by device time printed with (e)
DD_PHASE_S = 90.0
DD_KEYS = ("card", "calls", "launches", "vs_plain", "fault", "vs_s2d", "time", "launchers", "phase_s")
DD_LAUNCHER_SCRIPT = r"""
import json, sys, threading
sys.path.insert(0, {root!r})
import torch
from hdrtv_tpu_torch.models.layers import fp32_math
from hdrtv_tpu_torch.models.s2d import w_s2d_s1_ps
from hdrtv_tpu_torch.ops import native
from hdrtv_tpu_torch.ops.conv_kernels import fused_block_conv3, fused_block_conv3_ref

native.lib()
report = {{"before": native.launcher_caches(), "rounds": {{}}}}
g = torch.Generator().manual_seed(15)
dev = torch.device("cuda:0")
w_nat = (torch.randn(3, 3, 32, 128, generator=g) * 0.05).numpy()
w32 = torch.from_numpy(w_s2d_s1_ps(w_nat)).to(dev)  # up_conv2's form: 128 -> 512 s2d channels
b = (torch.randn(512, generator=g) * 0.1).to(dev)
x32 = torch.rand(135, 240, 128, generator=g).to(dev)
with fp32_math():
    for tag, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        x, w = x32.to(dt), w32.to(dt)
        outs, errs, barrier = [None, None], [None, None], threading.Barrier(2)

        def shard(k):
            try:
                with torch.cuda.stream(torch.cuda.Stream(dev)):
                    barrier.wait()
                    outs[k] = fused_block_conv3(x, w, b, a_sub=1)
                    torch.cuda.current_stream(dev).synchronize()
            except Exception as e:
                errs[k] = repr(e)

        threads = [threading.Thread(target=shard, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        if any(errs):
            report["rounds"][tag] = {{"errors": errs}}
            continue
        first = native.launcher_caches()
        fused_block_conv3(x, w, b, a_sub=1)
        torch.cuda.synchronize()
        ref = fused_block_conv3_ref(x, w, b).float()
        e = (outs[0].float() - ref).abs()
        err = float((e / (2.0 ** -7 * ref.abs().clamp_min(1.0))).max()) if tag == "bf16" else float(e.max())
        report["rounds"][tag] = {{"errors": errs, "equal": bool(torch.equal(outs[0], outs[1])), "err": err,
                                 "caches": first, "after_repeat": native.launcher_caches()}}
report["after"] = native.launcher_caches()
report["device_count"] = torch.cuda.device_count()
print("LAUNCHERS " + json.dumps(report), flush=True)
"""


def dd_line(figures: dict) -> str:
    """Phase 15's {"dd": ...} line, its keys in DD_KEYS' order."""
    if set(figures) != set(DD_KEYS):
        raise AssertionError(f"dd line: keys {sorted(figures)} != {sorted(DD_KEYS)}")
    return json.dumps({"dd": {k: figures[k] for k in DD_KEYS}})


def dd_planted_fault(tree: dict) -> dict:
    """(b)'s planted fault: a dd tree whose down_conv1 weight (w_dd_s2: a
    2×2 conv, row taps Δ = −1, 0) has its two row taps swapped, so the
    L1→L2 transition reads one dd row off."""
    bad = dict(tree)
    bad["LE.down_conv1.weight"] = tree["LE.down_conv1.weight"][::-1].copy()
    return bad


def frame_apart(torch, y, ref) -> dict:
    """Two float frames in [0, 1]: the largest absolute difference, and the
    u16 codes they pack to (clamp, ·65535, +0.5, as pack_rgb48) apart."""
    def codes(v):
        return (v.float().clamp(0.0, 1.0) * 65535.0 + 0.5).to(torch.int32)

    d = (codes(y) - codes(ref)).abs()
    return {"max_abs": float((y.float() - ref.float()).abs().max()), "max_codes": int(d.max()),
            "mean_codes": round(float(d.double().mean()), 4), "unequal": int((d > 0).sum())}


class PlainOnCard:
    """Every kernel wrapper on its plain version for CUDA tensors while
    inside (``native.on_cpu`` answering True); the program's torch ops stay
    as they are. Nothing launches a kernel of the library."""

    def __init__(self, native):
        self.native = native

    def __enter__(self):
        self._saved = self.native.on_cpu
        self.native.on_cpu = lambda *ts: True
        return self

    def __exit__(self, *exc):
        self.native.on_cpu = self._saved


def phase_dd(torch, np, native, smi: str, tmp: str) -> tuple[dict, dict]:
    """Phase 15 (its checks in the constants' comment above). Returns the
    launch counts of the paths dd_bf16 and dd_fp32 (one eager 1080p frame
    each) and the phase's figures."""
    from torch.profiler import ProfilerActivity, profile

    from hdrtv_tpu_torch.models.dd import dd_params_to_torch, dd_transform_params, ensemble_dd
    from hdrtv_tpu_torch.models.import_npz import load_npz
    from hdrtv_tpu_torch.models.layers import BF16, F32
    from hdrtv_tpu_torch.models.s2d import ensemble_s2d, params_to_torch, s2d_transform_params
    from hdrtv_tpu_torch.ops.resize import downsample_quarter_aa
    from hdrtv_tpu_torch.tools.profile_frame import device_us, group_of

    t_phase = time.perf_counter()
    dev = torch.device(DD_DEVICE)
    natural = load_npz(WEIGHTS)
    tree, s2d_tree = dd_transform_params(natural), s2d_transform_params(natural)
    h, w = DD_SIZE
    u8 = (np.random.RandomState(h + 15).rand(h, w, 3) * 255).astype(np.uint8)
    img = torch.from_numpy(u8).to(dev)[None].float() * (1.0 / 255.0)
    cond = downsample_quarter_aa(img)
    figures: dict = {"card": smi, "calls": {}, "launches": {}, "vs_plain": {}, "fault": {}, "vs_s2d": {}, "time": {}}
    counts: dict = {}
    log(f"phase 15: the double-s2d mode (ensemble_dd) at {h}x{w}, bf16 and fp32; {smi}")
    for path, pname in DD_POLICY.items():
        policy = F32 if pname == "fp32" else BF16
        p = dd_params_to_torch(tree, dev, policy)

        def run(params=p, policy=policy):
            return ensemble_dd(params, img, cond, policy=policy)

        with torch.inference_mode():
            # (a) every kernel call against its plain version at its own shape
            with MeshCallChecks(torch, native) as checks:
                out = run()
                torch.cuda.synchronize()
            summary = checks.summary()
            calls = {}
            for name, c in summary.items():
                if pname == "fp32":
                    err, bnd, unit = c["abs_err"], ATOL, "abs"
                else:
                    err, bnd, unit = c["err"], DD_CALL_BOUND.get(name, 1.0), "bf16 steps"
                calls[name] = {"calls": c["calls"], "shapes": c["shapes"], "err": err, "bound": bnd, "unit": unit}
            figures["calls"][path] = calls
            log(json.dumps({"dd_calls": path, **calls}))
            bad = {k: (c["err"], c["bound"]) for k, c in calls.items() if c["err"] > c["bound"]}
            if bad or not calls:
                raise AssertionError(f"{path}: kernel calls beyond phase 2's bounds against the plain versions: {bad}")

            # (d) one eager frame's launches
            native.reset_launch_counts()
            out = run()
            torch.cuda.synchronize()
            got = read_counts(native)
            counts[path] = got
            want = {k: DD_LAUNCHES[path].get(k, 0) for k in KERNEL_INFO}
            figures["launches"][path] = {k: v for k, v in got.items() if v}
            log(f"phase 15: {path} launches for one frame: {figures['launches'][path]}")
            if got != want:
                raise AssertionError(f"{path}: launches {got} != {want}")
            if tuple(out.shape) != (1, h, w, 3) or not bool(torch.isfinite(out.float()).all()):
                raise AssertionError(f"{path}: output {tuple(out.shape)} {out.dtype}, finite "
                                     f"{bool(torch.isfinite(out.float()).all())}")

            # (b) against the same program on the plain versions, and the planted fault
            native.reset_launch_counts()
            with PlainOnCard(native):
                plain = run()
            torch.cuda.synchronize()
            if any(read_counts(native).values()):
                raise AssertionError(f"{path}: the plain program launched {read_counts(native)}")
            max_codes, mean_codes = DD_FRAME_CODES[pname]
            apart = frame_apart(torch, out, plain)
            faulty = run(dd_params_to_torch(dd_planted_fault(tree), dev, policy))
            fault = frame_apart(torch, faulty, plain)
            figures["vs_plain"][path] = {**apart, "bound": [max_codes, mean_codes]}
            figures["fault"][path] = {"planted": "down_conv1's w_dd_s2 row taps swapped", **fault}
            log(f"phase 15: {path} against its plain versions: {json.dumps(apart)} (bound {max_codes} codes, "
                f"mean {mean_codes}); planted fault {json.dumps(fault)}")
            if apart["max_codes"] > max_codes or (mean_codes is not None and apart["mean_codes"] > mean_codes):
                raise AssertionError(f"{path}: the dd frame and its plain program apart by {apart}")
            if fault["max_codes"] <= max_codes and (mean_codes is None or fault["mean_codes"] <= mean_codes):
                raise AssertionError(f"{path}: the planted fault passed the frame's check: {fault}")
            del plain, faulty

            # (c) against the port's s2d program on the same frame
            s2 = ensemble_s2d(params_to_torch(s2d_tree, dev, policy), img, cond, policy=policy)
            vs = frame_apart(torch, out, s2)
            figures["vs_s2d"][path] = {**vs, "bound_codes": DD_VS_S2D_FP32 if pname == "fp32" else None}
            log(f"phase 15: {path} against ensemble_s2d: {json.dumps(vs)}"
                + (f" (bound {DD_VS_S2D_FP32} codes)" if pname == "fp32" else " (another program: printed)"))
            if pname == "fp32" and vs["max_codes"] > DD_VS_S2D_FP32:
                raise AssertionError(f"{path}: the dd frame and ensemble_s2d apart by {vs}")
            del s2

            # (e) ms/frame, and the device time split by torch.profiler
            n = DD_FRAMES[path]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                out = run()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / n
            for attempt in range(1, SPLIT_ATTEMPTS + 1):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(DD_PROFILE_FRAMES):
                        run()
                    torch.cuda.synchronize()
                groups: dict = {}
                by_name: dict = {}
                for e in prof.key_averages():
                    us = device_us(e)
                    if us:
                        g = group_of(e.key)
                        groups[g] = groups.get(g, 0.0) + us / 1e3 / DD_PROFILE_FRAMES
                        name = e.key.split("(anonymous namespace)::", 1)[-1].split("(")[0][:60]
                        by_name[name] = by_name.get(name, 0.0) + us / 1e3 / DD_PROFILE_FRAMES
                if groups.get("port kernels", 0.0) > 0:
                    break
            else:
                raise AssertionError(f"{path}: the profiler saw no device time of the port's kernels: {groups}")
            kernel_ms = sum(groups.values())
            port_ms = groups.get("port kernels", 0.0)
            figures["time"][path] = {"ms_per_frame": round(ms, 3), "frames": n, "device_ms": round(kernel_ms, 4),
                                     "port_kernels_ms": round(port_ms, 4),
                                     "torch_ops_ms": round(kernel_ms - port_ms, 4),
                                     "groups_ms": {k: round(v, 4) for k, v in sorted(groups.items())},
                                     "top_ms": {k: round(v, 4) for k, v in
                                                sorted(by_name.items(), key=lambda kv: -kv[1])[:DD_TOP]},
                                     "attempts": attempt}
            log(f"phase 15: {path} {ms:.3f} ms/frame eager over {n} frames; device {kernel_ms:.3f} ms a frame = "
                f"port kernels {port_ms:.3f} + torch ops {kernel_ms - port_ms:.3f} "
                f"({json.dumps(figures['time'][path]['groups_ms'])}); {smi}")
        del p, out
        torch.cuda.empty_cache()

    # (f) the per-device launcher caches, in a fresh process
    script = DD_LAUNCHER_SCRIPT.format(root=ROOT)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=180,
                         env={**os.environ, "PYTHONPATH": ROOT})
    line = next((ln for ln in res.stdout.splitlines() if ln.startswith("LAUNCHERS ")), None)
    if res.returncode or line is None:
        raise AssertionError(f"launcher check failed (rc {res.returncode}):\n{res.stdout[-2000:]}\n"
                             f"{res.stderr[-3000:]}")
    rep = json.loads(line[len("LAUNCHERS "):])
    figures["launchers"] = rep
    log(f"phase 15: first launches from two threads on two streams at once: {json.dumps(rep)}")
    for tag in ("bf16", "fp32"):
        r = rep["rounds"].get(tag, {})
        bnd = 1.0 if tag == "bf16" else ATOL
        if any(r.get("errors", ["missing"])) or not r.get("equal") or r["err"] > bnd:
            raise AssertionError(f"launchers, {tag}: {r}")
        if r["after_repeat"] != r["caches"]:
            raise AssertionError(f"launchers, {tag}: a repeat launch added a cache: {r}")
    if rep["before"] or set(rep["after"]) != {"0"} or rep["after"]["0"] < 2:
        raise AssertionError(f"launchers: cached for ordinals {rep['after']} (before any launch {rep['before']})")
    log(f"phase 15: the launchers cached for device ordinal(s) {sorted(rep['after'])}: "
        f"{rep['after']} caches in a process that launched on {rep['device_count']} card(s)")
    figures["phase_s"] = round(time.perf_counter() - t_phase, 1)
    log(f"phase 15: {figures['phase_s']} s (budget {DD_PHASE_S:g})")
    if figures["phase_s"] > DD_PHASE_S:
        raise AssertionError(f"phase 15 took {figures['phase_s']} s, over its {DD_PHASE_S:g} s")
    return counts, figures


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
            bench_counts, bench = phase_bench(torch, np, native, smi, tmp)
            counts.update(bench_counts)
            quant_counts, quant = phase_quant(torch, np, native, smi, tmp)
            counts.update(quant_counts)
            live_counts, live = phase_live(torch, np, native, smi, tmp)
            counts.update(live_counts)
            mesh_counts, mesh = phase_mesh(torch, np, native, smi, hg_weights, tmp)
            counts.update(mesh_counts)
            dd_counts, dd = phase_dd(torch, np, native, smi, tmp)
            counts.update(dd_counts)
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
                src = {"source": OFF_PATH_SOURCE[name]} if name in OFF_PATH_SOURCE else {}
                k["off_path"] = {"dtype": "f32", **src, **entry(name, "f32", path)}
            kernels.append(k)
    if len(kernels) != 33:
        raise AssertionError(f"{len(kernels)} kernel entries, expected 33: {[k['name'] for k in kernels]}")
    log(json.dumps({"graphs": graphs, "runtime": runtime}))
    log(json.dumps({"pipeline": pipeline}))
    log(json.dumps({"models": models}))
    log(bench_line(bench))
    log(quant_line(quant))
    log(live_line(live))
    log(mesh_line(mesh))
    log(dd_line(dd))
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
