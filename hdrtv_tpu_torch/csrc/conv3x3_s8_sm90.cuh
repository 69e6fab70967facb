// The native-int8 (W8A8) 3×3 convolution written for Hopper (sm_90a): s8 ×
// s8 → s32 on wgmma, fed by TMA through a ring of stages, walking the s2d
// slot table. Two forms:
// - stride 1, 'same', C = 128: the int8 convs of the s2d forms of
//   sft_conv3_w8a8, tail_w8a8 and resblock_w8a8 (the Pallas bodies behind
//   `quant` in hdrtv_tpu/ops/megakernel.py: fused_sft_conv3_v2 :852-855,
//   fused_tail :468-469, fused_resblock :988-1004, all on _taps_conv_q
//   :1358) when the caller declares the weights s2d (ops/megakernel.py,
//   s2d=True), and block_conv3_w8a8's when it declares a_sub = 1
//   (hdrtv_tpu/ops/conv_kernels.py :180-227; ops/conv_kernels.py), in bf16
//   and, the int8 fp32 program's twelve calls, in fp32, and its pool_out
//   form (the POOL instance: each row's column pairs maxed by a shuffle and
//   staged, the block's max of the two staged rows, one TMA store of the
//   pooled row; launched from block_conv3.cu);
// - stride 2, pad (1,0), C = 256: down2_w8a8's (the Pallas _down2_kernel's
//   `quant` body, hdrtv_tpu/ops/megakernel.py:608-705) when the caller
//   declares a_sub ≥ 1 (1, or 3 for the consolidated CondNet down conv,
//   whose branches each have their own code plane, weights, yscale, bias and
//   pad code).
// The dense int8 forms stay on the mma.sync tile of conv3x3_s8.cuh.
//
// What it computes, per output pixel and channel n (ops/w8a8.py):
//   y = act(float(Σ code · w_int8) · yscale[n] + bias[n] (+ skip))
// with the int32 sum exact, the rescale and the bias add rounded apart
// (__fmul_rn, __fadd_rn: no contraction into an FMA), then the skip added
// (__fadd_rn), the activation, one rounding to bf16; or, in the fp32-output
// form (resblock_w8a8's conv1, whose h1 the Pallas body carries into SFT2
// in fp32, and block_conv3_w8a8 in fp32, whose trunk conv2s add an fp32
// skip), no rounding: y stored as fp32. Where the codes
// agree the result equals the plain version bit for bit: an s32 sum has no
// order.
//
// Why a table. The weight w_s2d_s1(w) or w_s2d_s2(w) is 3/4 exact zeros:
// output sub-position so reads 9 of the 36 (tap, input sub-position) slots
// (models/s2d.py s2d_slots(stride)). A K chunk is the 32 channels (32 bytes
// of codes) of one slot at one tap, one wgmma k32 step; the table the
// wrapper passes (ops/conv_kernels.py sm90_table, entry tap | c0 << 4) lists
// each output sub-position's chunks, so a block whose output channels lie
// in one sub-position multiplies its 9 (C = 128) or 18 (C = 256) chunks
// instead of the dense 36 or 72. The skipped products are exact zeros where
// the int8 weight has the structure the caller declares
// (tests/test_torch_s2d_int8.py and tests/test_torch_s2d_down2_mix.py hold
// the checkpoint to it), so the int32 sum is the dense one.
//
// The block: two warpgroups (256 threads), two blocks per SM, persistent. Its
// N tile is BN output channels, all in one output sub-position so and one
// branch: 32 at stride 1, 64 at stride 2 (a whole sub-position of the
// CondNet convs, so each A box is loaded once per sub-position, not twice);
// its pixel tile 2 rows × 64 columns of output pixels, warpgroup g owning
// tile row g (one m64 tile), s32 accumulators in registers (BN/2 a thread).
// Block b keeps N tile b % groups (its plan, chunk list, biases and yscales
// copied to shared memory) and walks the pixel tiles b / groups, + gridDim /
// groups, ...
//
// Steps. What bounds the loads is their count of requests, not bytes: one
// 32-channel box per chunk would be 9 rows of 32 bytes per pixel, which L2
// serves at ≈ 0.4 requests a cycle per SM, no faster than the bf16 tile's 9
// rows of 64 bytes (PERF.md §6). So the launcher groups each list's chunks
// by tap and 128-byte span (s8_sm90_plan): at stride 1 so's 9 slots are 4
// taps, a center one with all 4 input sub-positions (one 128-byte box row),
// an edge one with 2 adjacent ones (64 bytes), an edge one with 2 apart (the
// whole 128) and a corner one (32): 4 boxes, 4 requests a pixel. At stride 2
// a slot is 64 bytes and a tap's sub-positions span up to 256, wider than a
// swizzle span: the center tap takes two 128-byte boxes, the edge with 2
// adjacent sub-positions one, the edge with 2 apart two 64-byte ones and the
// corner one 64-byte box: 6 boxes of exactly the 576 bytes the list needs. A
// step waits for its box, multiplies its 1–4 chunks (k32 slices of the box
// row, each by its resident weight chunk) and moves on.
//
// Operands. 8-bit wgmma takes both operands K-major from shared memory. A:
// the step's TMA box, (32, 64 or 128 channels, 64 columns, 2 rows) of the
// codes at the tap's offset (every second pixel and row at stride 2: the
// map's element strides, as the bf16 tile of conv3x3_sm90.cuh reads down2),
// written with the swizzle of its row's span (32, 64 or 128 bytes); a
// slice's descriptor starts 32 bytes further along the row for each chunk
// before it. B: the block's chunks of weight rows, (BN output channels × 32
// bytes) each, K-contiguous as QArgs stores them ((Co, 9·C): no transpose),
// copied once by cp.async into the 32-byte swizzle and kept resident (18 KB
// at stride 1 beside a ring of 6 stages, 36 KB at stride 2 beside 4).
//
// The pad code. TMA fills out-of-image pixels with code 0, the pad code of a
// symmetric layer only. For an asymmetric layer (pad ≠ 0) each thread, after
// the stage's bytes arrive and before the block meets, rewrites its half of
// a box row (one pixel) with the pad code where that pixel lies outside the
// image (at stride 2 only global row −1 and column −1, the (1,0) pad); only
// tiles touching the image's edge look. A row is one swizzle span, so a row
// filled with one byte value is the same swizzled or not. The generic-proxy
// writes are made visible to wgmma with fence.proxy.async before the
// meeting.
//
// The ring: NS stages of A, one mbarrier each. At step k every thread waits
// for stage k's bytes, fills the pad rows, and all meet; thread 0 then
// refills the stage step k − 2 used with step k + NS − 2's box (everyone
// finished step k − 2's products before meeting), the warpgroups issue step
// k's wgmmas and wait for their step k − 1. A tile's first wgmma starts
// from zero (scale-d 0): nothing but the wgmmas writes the accumulators in
// the loop, else ptxas waits for each step's products before the next.
//
// Epilogue, after a tile's last step: all its products done, each thread
// takes its pairs (acc·yscale, then + bias, + skip, its 4-byte bf16 or
// 8-byte fp32 pairs read before the wait for the tile's products,
// the activation, one rounding) and writes them into the stage, in the
// swizzle of the output's TMA map (s8_stage_out): 64 bytes a pixel (BN = 32
// bf16) or 128 (BN = 64 bf16, and the fp32 form's 32 channels); thread 0
// stores the tile's two rows by TMA after the next step's meeting, clipped
// at the image's edges, and waits for their reads before that stage is
// refilled. (16-byte stores after a quad shuffle, as the bf16 tile's
// epilogue does, took half of this tile's cycles.) A row of 128 bytes a
// pixel, 2 × 64 × 128 bytes, fills the whole stage. So a list's last step
// is a 128-byte box (s8_sm90_plan moves one there; every list of both
// strides has one, a center tap's), and warpgroup wg stages its outputs
// over its own box row, wg · 64 · 128 bytes in, which only its own wgmmas
// read: over a narrower box it would write the other warpgroup's A rows
// while those products may still run.
//
// Bound on this card: bytes. HR_conv2 at 1080p reads 66 MB of codes and
// writes 133 MB of h (0.059 ms at 3.35 TB/s), against 38 GOP of non-zero
// int8 products (0.019 ms at 1979 TOPS); resblock_w8a8's conv1 at L1 reads
// 17 MB and writes 66 MB of fp32 h1; block_conv3_w8a8's up_conv3 reads 17
// MB and writes 133 MB (266 MB in fp32: the int8 fp32 program's twelve
// calls move 2.3 GB a frame, 0.69 ms); down2_w8a8's consolidated CondNet down conv reads
// three code planes, 398 MB, and writes 199 MB (0.178 ms), against 115 GOP.
// Where the time goes: tools/sm90_phases.py, PERF.md §5.
//
// Requirements (the launchers return cudaErrorInvalidValue otherwise):
// stride 1: C = 128, natural 32 channels, Co/4 a multiple of 32 (128 → 128
// and the PS-folded 128 → 512), one branch;
// stride 2: C = 256, natural 64 channels, a_sub 1 or 3, Co/(4·a_sub) a
// multiple of 64, 1 or a_sub branches, even H and W, bf16 output without a
// skip. Both: the table's four lists of 9·C/128 chunks, 16-byte aligned
// tensors. Any output size: TMA clips the boxes at the image's edges, and an
// odd output height (up_conv2's and CondNet3.2/4.2's 135 rows) leaves the
// last tile's second row out of the image, not stored.
#pragma once

#include "conv3x3_s8.cuh"
#include "conv3x3_sm90.cuh"

namespace hdrtv {
namespace {

constexpr int kS8Sm90BK = 32;         // bytes (channels) of one K chunk: one wgmma k32 step
constexpr int kS8Sm90BH = 2;          // tile rows: one m64 row per warpgroup
constexpr int kS8Sm90StageBytes = kS8Sm90BH * kSm90TW * 128;  // the widest box: 128-byte rows
constexpr int kS8Sm90ListMax = 18;    // chunks (and steps) of one list: C = 256 at stride 2

// The tile of stride S: its N tile, ring stages and chunks a list.
template <int S>
struct S8Sm90Cfg {
  static constexpr int BN = S == 1 ? 32 : 64;          // output channels of a block's N tile
  static constexpr int NS = S == 1 ? 6 : 4;            // ring stages: two blocks an SM
  static constexpr int C = S == 1 ? 128 : 256;         // input channels
  static constexpr int LIST = 9 * C / 4 / kS8Sm90BK;   // chunks of one list
  static constexpr int B_CHUNK = BN * kS8Sm90BK;       // weight codes of a chunk
  // shared memory: [1024-byte alignment][A ring][B: the block's chunks][NS barriers]
  // [yscale, bias of its BN channels][its plan][its chunk list]
  static constexpr int SMEM = 1024 + NS * kS8Sm90StageBytes + LIST * B_CHUNK + 8 * NS + 8 * BN + 8 * LIST + 4 * LIST;
  static_assert(SMEM <= kSm90Smem, "two blocks an SM");
};

// A step loads one box of one tap, kind k: channels [c0, c0 + 32·2^k) (32,
// 64 or 128 bytes a pixel, in the swizzle of that span), and multiplies its
// n ≤ 4 slices: plan word 0 = tap | k << 4 | c0 << 8 | n << 20; word 1 holds
// slice s at bits 8s: its 32-byte piece of the box row (2 bits) | its chunk
// of the list << 2.
struct S8Sm90Args {
  CUtensorMap amap[3 * kMaxBranches];  // branch bi's codes as (H, W, C) u8, box (32·2^k, 64·S, 2·S) for kind k
                                       // at 3·bi + k
  CUtensorMap ymap;  // y as (Ho, Wo, Co), box (BN, 64, 1): bf16 in the 64-byte (BN = 32) or 128-byte (BN = 64)
                     // swizzle, fp32 in the 128-byte one; the stores
  const int8_t* w[kMaxBranches];       // branch bi's (Co/nb, 9·C): QArgs.w
  const float* yscale[kMaxBranches];   // (Co/nb)
  const float* bias[kMaxBranches];     // (Co/nb): the folded bias
  int pad[kMaxBranches];               // branch bi's pad code
  const void* skip;     // (Ho, Wo, Co) or nullptr: bf16, fp32 in the fp32-output form
  int H, W, Ho, Wo, C, Co, act;
  int co_br;            // output channels of one branch, Co / nb
  int co_blk;           // of one s2d block, Co / a_sub
  int co_nat;           // of one output sub-position, co_blk / 4
  int per_list;         // chunks in each of the four lists
  int steps[4];         // steps of each list
#ifdef HDRTV_SM90_PHASES
  unsigned long long* phases = nullptr;  // tools/sm90_phases.py: 8 clock64() sums per warpgroup
#endif
  int chunk[4 * kS8Sm90ListMax];     // list so at [so·per_list, (so+1)·per_list): tap | c0 << 4
  int plan[4 * 2 * kS8Sm90ListMax];  // list so's steps at so·2·kS8Sm90ListMax, two words each
};

// Thread 0's TMA load of one box into `dst`, completing on `bar` with `bytes`.
__device__ __forceinline__ void tma_load_box(const CUtensorMap* map, unsigned dst, unsigned bar, int c, int w, int h,
                                             int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h)
      : "memory");
}

// Where warpgroup wg stages its output row (64 pixels × 64 or 128 bytes) in
// the stage of a tile's last step: over its own row of that step's 128-byte
// box (s8_sm90_plan), which only its wgmmas read.
__device__ __forceinline__ int s8_stage_out(int wg) { return wg * kSm90TW * 128; }

// bf16x2 or fp32 pairs: the larger of each, in place (the pooled epilogue's row max; exact).
template <bool F32>
__device__ __forceinline__ uint4 max16(uint4 x, uint4 y) {
  unsigned a[4] = {x.x, x.y, x.z, x.w};
  const unsigned b[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (F32) {
      a[i] = __float_as_uint(fmaxf(__uint_as_float(a[i]), __uint_as_float(b[i])));
    } else {
      const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[i]));
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b[i]));
      a[i] = pack_bf16(fmaxf(u.x, v.x), fmaxf(u.y, v.y));
    }
  }
  return make_uint4(a[0], a[1], a[2], a[3]);
}

template <int S, bool SKIP, bool F32OUT, bool POOL = false>
__global__ void __launch_bounds__(kSm90Threads, 2) conv3x3_s8_sm90_kernel(const __grid_constant__ S8Sm90Args a) {
  using Cfg = S8Sm90Cfg<S>;
  constexpr int BH = kS8Sm90BH, BN = Cfg::BN, NS = Cfg::NS, D = NS - 2, NJ = BN / 8;
  static_assert(!F32OUT || BN == 32, "the fp32 output rows are 128 bytes: 32 channels");
  static_assert(!POOL || (S == 1 && !SKIP), "the pooled form: stride 1, its skip read in the epilogue");
  extern __shared__ unsigned char smem_raw[];
  const unsigned base = (static_cast<unsigned>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - static_cast<unsigned>(__cvta_generic_to_shared(smem_raw)));
  unsigned char* const Bsm = smem + NS * kS8Sm90StageBytes;
  const unsigned bars = base + NS * kS8Sm90StageBytes + a.per_list * Cfg::B_CHUNK;
  float* const ys_s = reinterpret_cast<float*>(smem + (bars - base) + 8 * NS);
  float* const bias_s = ys_s + BN;
  int* const plan = reinterpret_cast<int*>(bias_s + BN);
  int* const chunks = plan + 2 * Cfg::LIST;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int groups = a.Co / BN;
  const int n0 = (blockIdx.x % groups) * BN;
  const int bi = n0 / a.co_br, nl = n0 - bi * a.co_br;  // the block's branch, its first channel there
  const int so = (n0 % a.co_blk) / a.co_nat;          // the block's output sub-position, its list
  const CUtensorMap* const amap = a.amap + 3 * bi;
  const int t0 = blockIdx.x / groups, tstride = gridDim.x / groups;
  const int tw = (a.Wo + kSm90TW - 1) / kSm90TW;
  const int tiles = ((a.Ho + BH - 1) / BH) * tw;
  const int KS = a.steps[so];
  const int steps = t0 < tiles ? ((tiles - 1 - t0) / tstride + 1) * KS : 0;
  for (int i = tid; i < a.per_list; i += kSm90Threads) chunks[i] = a.chunk[so * a.per_list + i];
  for (int i = tid; i < 2 * KS; i += kSm90Threads) plan[i] = a.plan[so * 2 * kS8Sm90ListMax + i];
  for (int i = tid; i < BN; i += kSm90Threads) {
    ys_s[i] = a.yscale[bi][nl + i];
    bias_s[i] = a.bias[bi][nl + i];
  }
  __syncthreads();

  // B: chunk k's BN weight rows of 32 bytes, row n's 16-byte half hk at
  // n·32 + (hk ^ bit 2 of n)·16 (the 32-byte swizzle).
  const long long K = 9LL * a.C;
  const int8_t* const wb = a.w[bi] + static_cast<long long>(nl) * K;
  for (int idx = tid; idx < a.per_list * BN * 2; idx += kSm90Threads) {
    const int k = idx / (2 * BN), n = (idx >> 1) % BN, hk = idx & 1;
    const int e = chunks[k];
    const int tap = e & 15, c0 = e >> 4;
    cp_async16(Bsm + k * Cfg::B_CHUNK + n * 32 + ((hk ^ (n >> 2)) & 1) * 16,
               wb + n * K + tap * a.C + c0 + hk * 16);
  }
  cp_async_commit();

  // A of the next step (thread 0 keeps its step pk, tile pt and the tile's
  // first input pixel): one TMA box of the step's tap and channels.
  int pk = 0, pt = t0, pw = S * (t0 % tw) * kSm90TW - 1, ph = S * (t0 / tw) * BH - 1;
  auto load_a = [&](int stage) {
    const int e = plan[2 * pk];
    const int tap = e & 15, kind = (e >> 4) & 3, dI = tap / 3;
    tma_load_box(&amap[kind], base + stage * kS8Sm90StageBytes, bars + 8 * stage, (e >> 8) & 0xfff,
                 pw + tap - 3 * dI, ph + dI, BH * kSm90TW * (32 << kind));
    if (++pk == KS) {
      pk = 0;
      pt += tstride;
      pw = S * (pt % tw) * kSm90TW - 1;
      ph = S * (pt / tw) * BH - 1;
    }
  };

#ifdef HDRTV_SM90_PHASES
  unsigned long long t_start = clock64(), t_phase[8] = {0, 0, 0, 0, 0, 0, 0, 0}, t_mark = 0;
#define PHASE(i) (t_phase[i] += clock64() - t_mark, t_mark = clock64());
#else
#define PHASE(i)
#endif
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int g = 0; g < D && g < steps; ++g) load_a(g);

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  const int warp = (tid >> 5) & 3, lane = tid & 31, q = lane & 3;
  // this thread's yscale and bias pairs: channels 8j + 2q, + 1
  float2 ysr[NJ], bsr[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    ysr[j] = *reinterpret_cast<const float2*>(ys_s + j * 8 + q * 2);
    bsr[j] = *reinterpret_cast<const float2*>(bias_s + j * 8 + q * 2);
  }
  const int pad = a.pad[bi];
  const unsigned padw = static_cast<unsigned>(pad & 0xff) * 0x01010101u;
  const uint4 padv = make_uint4(padw, padw, padw, padw);
  const int my_half = tid & 1;  // this thread's half of box row tid / 2 (pad filling)
  int ks = 0, tile = 0, stage = 0, phase = 0, fill = D % NS;
  // the staged output of a tile not yet stored (its stage, -1 for none) and
  // its first pixel; thread 0's stage of a store that may still read it
  int out_stage = -1, out_h0 = 0, out_w0 = 0, stored_stage = -1;
  // Thread 0's TMA stores of the staged tile: one box (BN channels, 64
  // pixels, 1 row) per tile row, clipped at the image's edges; POOL: one
  // box (BN channels, 32 pooled pixels, 1 row).
  auto store_out = [&]() {
    const unsigned st = base + out_stage * kS8Sm90StageBytes;
#pragma unroll
    for (int r = 0; r < (POOL ? 1 : BH); ++r)
      asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n"
                   ::"l"(reinterpret_cast<uint64_t>(&a.ymap)), "r"(n0), "r"(out_w0), "r"(out_h0 + r),
                   "r"(st + s8_stage_out(r))
                   : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  };
  // The pooled epilogue (POOL, block_conv3_w8a8's pool_out), after a tile's
  // last step in its stage: each conv pixel's (acc·yscale, + bias, + skip)
  // and activation in fp32; lanes l and l ^ 4 hold a pooled pixel's two
  // columns, and one shuffle a pair leaves lane l the larger of its pair h =
  // bit 2 of l, pooled column 8·warp + 4h + l/8, which it writes (rounded in
  // bf16: rounding is monotonic) over its warpgroup's own box row as the
  // unpooled form does, in the swizzle of a box of 32 pixels. The block
  // meets, and its threads write the larger of the two rows' 16-byte pieces
  // over row 0's, which thread 0 stores as one box at the pooled row h0/2.
  // (Warp 0 taking that max after the next step's meeting, without this
  // meeting, measured 2% slower on an H100 at up_conv3's shape.)
  auto pool_epilogue = [&](int h0, int w0) {
    using ST = typename std::conditional<F32OUT, float, bf16>::type;
    constexpr int PX = F32OUT ? 128 : 64;  // bytes of a staged pooled pixel
    const int hk = (lane >> 2) & 1, pc = warp * 8 + hk * 4 + (lane >> 3);
    unsigned char* const st = smem + stage * kS8Sm90StageBytes;
    unsigned char* const mine = st + s8_stage_out(wg);
    const int ho = h0 + wg;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float2 v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int wo = w0 + warp * 16 + h * 8 + (lane >> 2);
        v[h] = make_float2(__fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), ysr[j].x), bsr[j].x),
                           __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), ysr[j].y), bsr[j].y));
        if (a.skip && ho < a.Ho && wo < a.Wo) {
          const float2 sk = load2<ST>(static_cast<const ST*>(a.skip) +
                                      (static_cast<long long>(ho) * a.Wo + wo) * a.Co + n0 + j * 8 + q * 2);
          v[h] = make_float2(__fadd_rn(v[h].x, sk.x), __fadd_rn(v[h].y, sk.y));
        }
        v[h] = make_float2(apply_act(v[h].x, a.act), apply_act(v[h].y, a.act));
      }
      const float2 send = hk ? v[0] : v[1], keep = hk ? v[1] : v[0];
      const float2 got = make_float2(__shfl_xor_sync(0xffffffffu, send.x, 4), __shfl_xor_sync(0xffffffffu, send.y, 4));
      const float2 m = make_float2(fmaxf(keep.x, got.x), fmaxf(keep.y, got.y));
      if constexpr (F32OUT)
        *reinterpret_cast<float2*>(mine + pc * PX + (((2 * j + (q >> 1)) ^ (pc & 7)) << 4) + (q & 1) * 8) = m;
      else
        *reinterpret_cast<unsigned*>(mine + pc * PX + q * 4 + ((j ^ ((pc >> 1) & 3)) << 4)) = pack_bf16(m.x, m.y);
    }
    __syncthreads();
    for (int i = tid; i < kSm90TW / 2 * PX / 16; i += kSm90Threads) {
      uint4* const p0 = reinterpret_cast<uint4*>(st + s8_stage_out(0)) + i;
      *p0 = max16<F32OUT>(*p0, reinterpret_cast<const uint4*>(st + s8_stage_out(1))[i]);
    }
    // the staged row, written by the generic proxy, is read by TMA's async
    // proxy: thread 0 stores it after the next step's meeting
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    out_stage = stage;
    out_h0 = h0 >> 1;
    out_w0 = w0 >> 1;
  };
  for (int g = 0; g < steps; ++g) {
#ifdef HDRTV_SM90_PHASES
    t_mark = clock64();
#endif
    if (g == 0) {
      cp_async_wait<0>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    const int e0 = plan[2 * ks], e1 = plan[2 * ks + 1];
    const int kind = (e0 >> 4) & 3, row = 32 << kind;
    PHASE(1)
    mbar_wait(bars + 8 * stage, phase);
    PHASE(2)
    const int t = t0 + tile * tstride;
    const int h0 = (t / tw) * BH, w0 = (t % tw) * kSm90TW;
    if (pad && (h0 == 0 || h0 + BH >= a.Ho || w0 == 0 || w0 + kSm90TW >= a.Wo)) {
      // the pad code into this thread's half of box row r = tid / 2 where its pixel is out of the image
      const int r = tid >> 1, tap = e0 & 15;
      const int hi = S * (h0 + r / kSm90TW) - 1 + tap / 3, wi = S * (w0 + r % kSm90TW) - 1 + tap % 3;
      if (hi < 0 || hi >= a.H || wi < 0 || wi >= a.W) {
        uint4* const dst = reinterpret_cast<uint4*>(smem + stage * kS8Sm90StageBytes + r * row + my_half * (row / 2));
        for (int i = 0; i < row / 32; ++i) dst[i] = padv;
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
    }
    __syncthreads();
    PHASE(3)
    if (tid == 0) {
      if (out_stage >= 0) {
        store_out();
        stored_stage = out_stage;
      }
      if (g + D < steps) {
        // the stage to refill may hold a stored tile: wait until its store has read it
        if (fill == stored_stage) {
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          stored_stage = -1;
        }
        load_a(fill);
      }
    }
    out_stage = -1;
    // warpgroup wg multiplies box row wg (its m64 tile) by each slice's chunk
    const unsigned As = base + stage * kS8Sm90StageBytes + wg * kSm90TW * row;
    const unsigned Bs = static_cast<unsigned>(__cvta_generic_to_shared(Bsm));
    const int n = (e0 >> 20) & 7;
    // A tile's first product starts its sums from zero: nothing but the
    // wgmmas writes acc inside the loop, or ptxas waits for every step's
    // products before the next (it would have to move the registers).
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (s < n) {
        const int sl = (e1 >> (8 * s)) & 0xff;
        WgmmaS8<BN>::mma(acc, desc_kmajor(As + (sl & 3) * kS8Sm90BK, kind),
                         desc_kmajor(Bs + (sl >> 2) * Cfg::B_CHUNK, 0), s > 0 || ks > 0);
      }
    wgmma_commit();
    if (ks + 1 < KS) {
      wgmma_wait<1>();
      PHASE(4)
    } else {
      // The tile's last step: finish its products, store, start the next
      // tile from zero. The next tile's first loads are in flight meanwhile.
      // This thread's skip pairs are read before the products' wait, so
      // that their latency runs under it (read in the epilogue, one pair
      // at a time, they doubled the fp32 trunk conv2's time).
      using ST = typename std::conditional<F32OUT, float, bf16>::type;
      [[maybe_unused]] float2 skv[2][NJ];
      if constexpr (SKIP) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = warp * 16 + h * 8 + (lane >> 2);
          const bool ok = h0 + wg < a.Ho && w0 + p < a.Wo;
          const ST* const sp = static_cast<const ST*>(a.skip) +
                               (static_cast<long long>(h0 + wg) * a.Wo + w0 + p) * a.Co + n0 + q * 2;
#pragma unroll
          for (int j = 0; j < NJ; ++j) skv[h][j] = ok ? load2<ST>(sp + j * 8) : make_float2(0.f, 0.f);
        }
      }
      wgmma_wait<0>();
      fence_iregs(acc);
      PHASE(4)
      if constexpr (POOL) {
        pool_epilogue(h0, w0);
        PHASE(5)
      } else {
        // A thread holds columns p = 16·warp + lane/4 (+ 8) of its warpgroup's
        // row and of each 8-channel group j the pair (lane % 4)·2. It writes
        // them, rounded, into this stage (s8_stage_out) in the swizzle of the
        // TMA store: BN = 32, 64 bytes a pixel, 16-byte piece j of pixel p at
        // j ^ (p/2 % 4); BN = 64, 128 bytes, at j ^ (p % 8); so that the eight
        // pixels of a store instruction fall in distinct banks; in fp32,
        // unrounded, 128 bytes: piece 2j + q/2 of pixel p at (2j + q/2) ^ (p %
        // 8), the pair at byte 8·(q % 2) of it.
        unsigned char* const st = smem + stage * kS8Sm90StageBytes + s8_stage_out(wg);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = warp * 16 + h * 8 + (lane >> 2);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            float2 v = make_float2(__fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), ysr[j].x), bsr[j].x),
                                   __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), ysr[j].y), bsr[j].y));
            if constexpr (SKIP) v = make_float2(__fadd_rn(v.x, skv[h][j].x), __fadd_rn(v.y, skv[h][j].y));
            if constexpr (F32OUT) {
              *reinterpret_cast<float2*>(st + p * 128 + (((2 * j + (q >> 1)) ^ (p & 7)) << 4) + (q & 1) * 8) =
                  make_float2(apply_act(v.x, a.act), apply_act(v.y, a.act));
            } else if constexpr (BN == 64) {
              *reinterpret_cast<__nv_bfloat162*>(st + p * 128 + q * 4 + ((j ^ (p & 7)) << 4)) =
                  __floats2bfloat162_rn(apply_act(v.x, a.act), apply_act(v.y, a.act));
            } else {
              *reinterpret_cast<__nv_bfloat162*>(st + p * 64 + q * 4 + ((j ^ ((p >> 1) & 3)) << 4)) =
                  __floats2bfloat162_rn(apply_act(v.x, a.act), apply_act(v.y, a.act));
            }
          }
        }
        // the staged rows, written by the generic proxy, are read by TMA's
        // async proxy: thread 0 stores them after the next step's meeting
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        out_stage = stage;
        out_h0 = h0;
        out_w0 = w0;
        PHASE(5)
      }
    }
    if (++ks == KS) ks = 0, ++tile;
    if (++stage == NS) stage = 0, phase ^= 1;
    if (++fill == NS) fill = 0;
    PHASE(6)
  }
  __syncthreads();
  if (tid == 0) {
    if (out_stage >= 0) store_out();
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
  cp_async_wait<0>();
#ifdef HDRTV_SM90_PHASES
  t_phase[0] = clock64() - t_start;
  t_phase[7] = steps;
  if (a.phases && (tid & 127) == 0)
    for (int i = 0; i < 8; ++i) a.phases[(blockIdx.x * 2 + wg) * 8 + i] = t_phase[i];
#endif
#undef PHASE
}

// The codes' TMA map for boxes of kind k at stride S: (C, W, H) bytes
// innermost first, a box of 32·2^k channels × 64·S columns × 2·S rows read
// at element stride S (64 × 2 pixels), written with the swizzle of its
// row's span (32, 64 or 128 bytes) that the tile's descriptors read;
// out-of-image pixels read as code 0.
inline cudaError_t encode_codes_map(CUtensorMap* map, const void* q, int H, int W, int C, int kind, int S) {
  static const CUtensorMapSwizzle swizzle[3] = {CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_SWIZZLE_64B,
                                                CU_TENSOR_MAP_SWIZZLE_128B};
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W) * C};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(32 << kind), static_cast<cuuint32_t>(kSm90TW * S),
                             static_cast<cuuint32_t>(kS8Sm90BH * S)};
  const cuuint32_t estr[3] = {1, static_cast<cuuint32_t>(S), static_cast<cuuint32_t>(S)};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(q), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle[kind], CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// y's TMA map for the stores: (Co, Wo, Ho) bf16 (fp32 with f32), a box of bn
// channels × `px` pixels (64, or 32 pooled ones) × 1 row in the swizzle the
// tile stages it in (its row's span: 64 bytes for 32 bf16 channels, else
// 128); boxes are clipped at the image's edges.
inline cudaError_t encode_s8_out_map(CUtensorMap* map, void* y, int Ho, int Wo, int Co, int bn, bool f32,
                                     int px = kSm90TW) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t es = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Co), static_cast<cuuint64_t>(Wo), static_cast<cuuint64_t>(Ho)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Co) * es, static_cast<cuuint64_t>(Wo) * Co * es};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(bn), static_cast<cuuint32_t>(px), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  if (encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, y, dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, bn * es == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The steps of one list of the slot table (per_list entries tap | c0 << 4):
// its chunks grouped by tap and 128-byte span, each group one box of the
// narrowest kind whose aligned span holds it, the last 128-byte step moved
// to the end (the tile stages its outputs there). Returns the number of
// steps, 0 for a list it cannot walk.
inline int s8_sm90_plan(const int* list, int per_list, int* plan) {
  int tap_of[kS8Sm90ListMax], span_of[kS8Sm90ListMax], lo[kS8Sm90ListMax], hi[kS8Sm90ListMax];
  int members[kS8Sm90ListMax][4], count[kS8Sm90ListMax];
  int nsteps = 0;
  if (per_list > kS8Sm90ListMax) return 0;
  for (int i = 0; i < per_list; ++i) {
    const int tap = list[i] & 15, c0 = list[i] >> 4, span = c0 / 128;
    int s = 0;
    while (s < nsteps && (tap_of[s] != tap || span_of[s] != span)) ++s;
    if (s == nsteps) {
      tap_of[s] = tap;
      span_of[s] = span;
      lo[s] = c0;
      hi[s] = c0 + kS8Sm90BK;
      count[s] = 0;
      ++nsteps;
    }
    if (count[s] == 4 || c0 % kS8Sm90BK || c0 >= 4096) return 0;
    members[s][count[s]++] = i;
    lo[s] = std::min(lo[s], c0);
    hi[s] = std::max(hi[s], c0 + kS8Sm90BK);
  }
  for (int s = 0; s < nsteps; ++s) {
    int k = 0;
    while (lo[s] / (32 << k) != (hi[s] - 1) / (32 << k)) ++k;
    const int c0 = lo[s] / (32 << k) * (32 << k);
    int w1 = 0;
    for (int m = 0; m < count[s]; ++m) {
      const int i = members[s][m];
      w1 |= (((list[i] >> 4) - c0) / kS8Sm90BK | i << 2) << (8 * m);
    }
    plan[2 * s] = tap_of[s] | k << 4 | c0 << 8 | count[s] << 20;
    plan[2 * s + 1] = w1;
  }
  int s = nsteps - 1;
  while (s >= 0 && ((plan[2 * s] >> 4) & 3) != 2) --s;
  if (s < 0) return 0;
  for (int w = 0; w < 2; ++w) {
    const int v = plan[2 * s + w];
    for (int i = s; i + 1 < nsteps; ++i) plan[2 * i + w] = plan[2 * (i + 1) + w];
    plan[2 * (nsteps - 1) + w] = v;
  }
  return nsteps;
}

// The arguments of a launch at stride S, checked (cudaErrorInvalidValue for
// a shape the tile does not take): q the nb code planes (plane bytes
// apart), p the nb branches' layers, each for Co/nb output channels, a_sub
// the s2d blocks along Co, table the four lists, per_list entries each;
// pool: the pooled form's output map, y (H/2, W/2, Co) (stride 1, H and W
// even).
template <int S>
cudaError_t s8_sm90_setup(S8Sm90Args& a, const void* q, long long plane, const QuantParams* p, int nb,
                          const void* skip, void* y, int H, int W, int C, int Co, int a_sub, int act,
                          const int* table, int per_list, bool f32_out, bool pool = false) {
  using Cfg = S8Sm90Cfg<S>;
  if (!table || C != Cfg::C || per_list != Cfg::LIST || a_sub < 1 || Co % (4 * a_sub * Cfg::BN) || nb < 1 ||
      nb > kMaxBranches || (nb != 1 && nb != a_sub) || H < 1 || W < 1 || H % S || W % S ||
      (pool && (S != 1 || H % 2 || W % 2)) ||
      (S == 2 && (skip || f32_out || (a_sub != 1 && a_sub != 3))) || (S == 1 && (a_sub != 1 || nb != 1)))
    return cudaErrorInvalidValue;
  for (int bi = 0; bi < nb; ++bi) {
    a.w[bi] = p[bi].w;
    a.yscale[bi] = p[bi].yscale;
    a.bias[bi] = p[bi].bias;
    a.pad[bi] = p[bi].pad;
  }
  a.skip = skip;
  a.H = H;
  a.W = W;
  a.Ho = H / S;
  a.Wo = W / S;
  a.C = C;
  a.Co = Co;
  a.act = act;
  a.co_br = Co / nb;
  a.co_blk = Co / a_sub;
  a.co_nat = a.co_blk / 4;
  a.per_list = per_list;
  for (int so = 0; so < 4; ++so) {
    for (int i = 0; i < per_list; ++i) a.chunk[so * per_list + i] = table[so * per_list + i];
    a.steps[so] = s8_sm90_plan(table + so * per_list, per_list, a.plan + so * 2 * kS8Sm90ListMax);
    if (!a.steps[so]) return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSuccess;
  for (int bi = 0; bi < nb && err == cudaSuccess; ++bi)
    for (int k = 0; k < 3 && err == cudaSuccess; ++k)
      err = encode_codes_map(&a.amap[3 * bi + k], static_cast<const int8_t*>(q) + bi * plane, H, W, C, k, S);
  if (err == cudaSuccess)
    err = pool ? encode_s8_out_map(&a.ymap, y, a.Ho / 2, a.Wo / 2, Co, Cfg::BN, f32_out, kSm90TW / 2)
               : encode_s8_out_map(&a.ymap, y, a.Ho, a.Wo, Co, Cfg::BN, f32_out);
  return err;
}

// One launch of instance <S, SKIP, F32OUT, POOL> (its resident blocks
// counted once per device).
template <int S, bool SKIP, bool F32OUT, bool POOL = false>
cudaError_t launch_s8_sm90(const S8Sm90Args& a, cudaStream_t stream) {
  using Cfg = S8Sm90Cfg<S>;
  auto kernel = conv3x3_s8_sm90_kernel<S, SKIP, F32OUT, POOL>;
  static DeviceCache cache;
  int resident = 0;
  const cudaError_t err = resident_blocks(cache, kernel, kSm90Smem, &resident);
  if (err != cudaSuccess) return err;
  kernel<<<sm90_grid(a.Ho, a.Wo, a.Co, Cfg::BN, kS8Sm90BH, resident), kSm90Threads, Cfg::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// The int8 'same' conv of codes q (H, W, C) with the layer p, s2d form: y =
// act(conv + bias (+ skip)) in bf16, or with f32_out in fp32 (skip fp32
// too), walking `table` (four lists, one per output sub-position,
// per_list entries each). `args`: where to build the launch's arguments
// (tools/sm90_s8_phases.cu passes its own, with the timers' array set); by
// default on the stack.
inline cudaError_t conv3x3_s8_sm90(const void* q, const QuantParams& p, const void* skip, void* y, int H, int W,
                                   int C, int Co, int act, const int* table, int per_list, cudaStream_t stream,
                                   S8Sm90Args* args = nullptr, bool f32_out = false) {
  S8Sm90Args own;
  S8Sm90Args& a = args ? *args : own;
  const cudaError_t err = s8_sm90_setup<1>(a, q, 0, &p, 1, skip, y, H, W, C, Co, 1, act, table, per_list, f32_out);
  if (err != cudaSuccess) return err;
  if (f32_out) return skip ? launch_s8_sm90<1, true, true>(a, stream) : launch_s8_sm90<1, false, true>(a, stream);
  return skip ? launch_s8_sm90<1, true, false>(a, stream) : launch_s8_sm90<1, false, false>(a, stream);
}

// down2_w8a8's stride-2 conv, (1,0) pad, of the nb code planes q (each (H, W,
// C), plane bytes apart) with the branches p[0 .. nb): y (H/2, W/2, Co) =
// act(conv + bias) in bf16, output channels [bi·Co/nb, (bi+1)·Co/nb) from
// branch bi's plane and layer; a_sub s2d blocks along Co, `table` the four
// lists of s2d_slots(2). `args` as above.
inline cudaError_t conv3x3_s8_sm90_s2(const void* q, long long plane, const QuantParams* p, int nb, void* y, int H,
                                      int W, int C, int Co, int a_sub, int act, const int* table, int per_list,
                                      cudaStream_t stream, S8Sm90Args* args = nullptr) {
  S8Sm90Args own;
  S8Sm90Args& a = args ? *args : own;
  const cudaError_t err =
      s8_sm90_setup<2>(a, q, plane, p, nb, nullptr, y, H, W, C, Co, a_sub, act, table, per_list, false);
  if (err != cudaSuccess) return err;
  return launch_s8_sm90<2, false, false>(a, stream);
}

}  // namespace
}  // namespace hdrtv
