// The fp32 instance of chain_sm90.cuh's SFT pass (sft_sm90), sm_90a: the SFT
// pass of the fp32 s2d forms of sft_conv3 (sft_conv3.cu) and resblock
// (resblock.cu), whose 3×3 convs run the 3×TF32 tile of conv3x3_tf32x3.cuh
// over the stride-1 slot table. With those convs it replaces, in fp32 on s2d
// weights, the Pallas kernels fused_sft_conv3_v2
// (hdrtv_tpu/ops/megakernel.py:866, body _sft_conv_kernel) and
// fused_resblock (:1012, body _resblock_kernel).
//
// Per row of natural pixels, the (4·npix, 16) rows of cond and the (4·npix,
// 32) rows of x:
//   hidden = lrelu([cond·W0s + b0s | cond·W0h + b0h])   (2·CC = 32)
//   t      = x · (hidden_s·W1s + b1s + 1) + hidden_h·W1h + b1h
// every value fp32, as the Pallas body in fp32: nothing is narrowed; sums,
// biases and the leaky ReLU are fp32; the multiply and the add of t are
// rounded apart (no fma). x may have a second input, the fine x_add (rows
// contiguous) or the coarse up tensor un-folded on read: x is then x + add
// in fp32, written to xsum as well (resblock's residual). resblock's SFT2
// takes the fp32 h1 as x.
//
// Products: 3×TF32 on wgmma m64nNk8 as in chain_tf32x3.cuh (each operand
// split by cvt.rna into big and small TF32 halves; small·big + big·small +
// big·big), each 16 deep: one chunk, summed in the tensor cores from zero.
// The first product runs both branches side by side (m64n32 over [W0s |
// W0h]); its accumulators, biased, activated and split, are in place the A
// fragments of the two second products (m64n32 each, issued together): the
// blocks are staged with chain_kpos's order of K, so that column 8j + 2q of
// an accumulator is k = q of k8 step j and column 8j + 2q + 1 is k = q + 4.
// The first product's A is read from the staged cond rows in that order, and
// x and add in the accumulators' layout, so t is formed where the products
// leave their sums and stored from registers (a quad writes 32 contiguous
// bytes of a row: whole sectors), as are xsum's rows.
//
// Weights: the four blocks split once per block into shared memory, K-major
// in the 128-byte swizzle, rows of 32 positions of which the first 16 hold
// K, big then small (24 KB). One block per SM, persistent, of three
// warpgroups (tiles 3·block + warpgroup, + 3·gridDim), each with a ring of
// two stages of 64 rows of cond, x and add (26 KB a stage; rows padded by 32
// bytes, free of bank conflicts), filled by 16-byte cp.async (rows past the
// end zero-filled, their outputs not stored). A stage is read into
// registers at the start of its tile and refilled at once: two tiles'
// bytes are in flight while one is computed.
//
// Bound on this card: bytes. At 1080p L0 (540 × 960 s2d pixels, sft_conv3's
// call) cond, x and t move 0.66 GB, 0.20 ms at 3.35 TB/s; the 6.4 GFLOP of
// non-zero products take 0.04 ms at a third of the dense TF32 rate (494.7
// TFLOP/s), 0.10 ms at the FMA units' 67. resblock's SFT1 at L1 with up
// reads 0.13 GB more and writes xsum. Times: PERF.md §6.
//
// The int8-output mode (sft_q8_f32_kernel, below): the same row tile for the
// SFT pass of the fp32 s2d forms of tail_w8a8 and sft_conv3_w8a8, t
// quantized in registers and written as 1-byte codes, its products as fp32
// FMA chains in the plain version's order.
#pragma once

#include "chain_tf32x3.cuh"

namespace hdrtv {
namespace {

struct SftF32Args {
  const float* cond;  // (rows, CC)
  const float* x;     // (rows, C)
  const float* add;   // nullptr, the fine (rows, C) x_add, or (coarse) the (H/2, W/2, 16·C) up tensor
  float* xsum;        // nullptr, or (rows, C): x + add
  float* t;           // (rows, C)
  const float* w[4];  // scale0, scale1, shift0, shift1 (s2d weights; the block at the top left, row pitch ld)
  const float* b[4];
  int ld[4];
  long long rows;
  int W;       // s2d pixels per image row (the un-fold of a coarse add)
  int coarse;  // add is the coarse tensor
  // the int8-output mode (sft_q8_f32_kernel): (rows, C) codes of t in place of t, for
  // a layer of scale qs (qinv = 1/qs rounded, the host's division), zero qz
  int8_t* q = nullptr;
  float qs = 1.f, qinv = 1.f, qz = 0.f;
  int qasym = 0;
#ifdef HDRTV_SM90_PHASES
  unsigned long long* phases = nullptr;  // tools/sm90_phases.py: 8 clock64() sums per warpgroup
#endif
};

struct SftTf32Cfg {
  static constexpr int CC = 16, C = 32;              // natural widths: cond, x and t
  static constexpr int WGS = 3;                       // warpgroups a block
  static constexpr int NS = 2;                        // ring stages per warpgroup
  static constexpr int BLOCK = 2 * 32 * 128;          // a staged block: 32 rows of 128 bytes, big then small
  static constexpr int W_BYTES = 3 * BLOCK;           // [W0s | W0h], W1s, W1h
  static constexpr int BIAS_BYTES = (2 * CC + 2 * C) * 4;
  static constexpr int CPITCH = (CC + 8) * 4;         // a staged row of cond: 32 bytes of pad
  static constexpr int XPITCH = (C + 8) * 4;          // of x or add
  static constexpr int STAGE = kRowBM * (CPITCH + 2 * XPITCH);
  static constexpr int RING_OFF = W_BYTES + BIAS_BYTES;
  static constexpr int SMEM = 1024 + RING_OFF + WGS * NS * STAGE;  // 1024: the swizzle's alignment
  static_assert(SMEM <= 227 * 1024, "one block per SM");
  static_assert(BLOCK % 1024 == 0 && RING_OFF % 16 == 0 && STAGE % 16 == 0, "alignment of the blocks and stages");
};

// A tile's rows from r0 into the stage st (cond, x, add, rows of Cfg::CPITCH,
// XPITCH and XPITCH bytes), by the warpgroup's thread t: 16-byte cp.async,
// rows past the end zero-filled; a coarse add un-folded on read.
template <typename Cfg>
__device__ __forceinline__ void sft_f32_load(const SftF32Args& a, unsigned char* st, long long r0, int t) {
  constexpr int CC = Cfg::CC, C = Cfg::C, CP = CC / 4, XP = C / 4;  // 16-byte pieces of a row
  unsigned char* const xs = st + kRowBM * Cfg::CPITCH;
  unsigned char* const as = xs + kRowBM * Cfg::XPITCH;
#pragma unroll
  for (int idx = t; idx < kRowBM * CP; idx += 128) {
    const int r = idx / CP, c = idx % CP;
    const bool ok = r0 + r < a.rows;
    cp_async16_or_zero(st + r * Cfg::CPITCH + c * 16, a.cond + (ok ? (r0 + r) * CC + c * 4 : 0), ok);
  }
#pragma unroll
  for (int idx = t; idx < kRowBM * XP; idx += 128) {
    const int r = idx / XP, c = idx % XP;
    const bool ok = r0 + r < a.rows;
    cp_async16_or_zero(xs + r * Cfg::XPITCH + c * 16, a.x + (ok ? (r0 + r) * C + c * 4 : 0), ok);
  }
  if (a.add) {
    const long long half_w = a.W >> 1;
#pragma unroll
    for (int idx = t; idx < kRowBM * XP; idx += 128) {
      const int r = idx / XP, c = idx % XP;
      const long long row = r0 + r;
      const bool ok = row < a.rows;
      long long src = 0;
      if (ok && a.coarse) {
        // fine pixel p = (i, j) of sub-position sub: coarse pixel (i/2, j/2),
        // channel block (2·(i%2) + j%2)·4C + sub·C
        const long long p = row >> 2;
        const int sub = static_cast<int>(row & 3);
        const long long pi = p / a.W, pj = p - pi * a.W;
        src = ((pi >> 1) * half_w + (pj >> 1)) * (16LL * C) + ((pi & 1) * 2 + (pj & 1)) * (4 * C) + sub * C + c * 4;
      } else if (ok) {
        src = row * C + c * 4;
      }
      cp_async16_or_zero(as + r * Cfg::XPITCH + c * 16, a.add + src, ok);
    }
  }
}

// The 16-deep product of the split fragments (ab, as: k8 steps 0 and 1)
// with the staged block at shared address wb into d (32 columns), from zero:
// issued only, the caller commits and waits.
__device__ __forceinline__ void sft_product_tf32x3(float (&d)[16], const uint32_t (&ab)[2][4],
                                                   const uint32_t (&as)[2][4], unsigned wb) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const unsigned big = wb + j * 32, small = big + 32 * 128;
    WgmmaTf32<32>::mma(d, as[j], desc_sw128(big), j > 0);
    WgmmaTf32<32>::mma(d, ab[j], desc_sw128(small));
    WgmmaTf32<32>::mma(d, ab[j], desc_sw128(big));
  }
}

__global__ void __launch_bounds__(128 * SftTf32Cfg::WGS, 1) sft_tf32x3_kernel(const __grid_constant__ SftF32Args a) {
  using Cfg = SftTf32Cfg;
  constexpr int CC = Cfg::CC, C = Cfg::C, NS = Cfg::NS, WGS = Cfg::WGS;
  extern __shared__ __align__(16) unsigned char row_smem[];
  unsigned char* const smem =
      row_smem + ((1024u - (static_cast<unsigned>(__cvta_generic_to_shared(row_smem)) & 1023u)) & 1023u);
  float* const b0 = reinterpret_cast<float*>(smem + Cfg::W_BYTES);  // [b0s | b0h]
  float* const b1s = b0 + 2 * CC;
  float* const b1h = b1s + C;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = tid & 31, q = lane & 3;
  unsigned char* const ring = smem + Cfg::RING_OFF + wg * NS * Cfg::STAGE;

  // each block 32 rows of one 32-position chunk, K = 16 (big at its start, small 32·128 bytes after)
  stage_b_tf32x3(smem, CC, a.w[0], a.ld[0], CC, 0, 2 * CC);
  stage_b_tf32x3(smem, CC, a.w[2], a.ld[2], CC, CC, 2 * CC);
  stage_b_tf32x3(smem + Cfg::BLOCK, C, a.w[1], a.ld[1], CC);
  stage_b_tf32x3(smem + 2 * Cfg::BLOCK, C, a.w[3], a.ld[3], CC);
  for (int i = tid; i < CC; i += 128 * WGS) {
    b0[i] = a.b[0][i];
    b0[CC + i] = a.b[2][i];
  }
  for (int i = tid; i < C; i += 128 * WGS) {
    b1s[i] = a.b[1][i];
    b1h[i] = a.b[3][i];
  }
  // the weights, written by the generic proxy, are read by wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const RowTiles tiles(a.rows, wg, WGS);
  auto load = [&](int i) { sft_f32_load<Cfg>(a, ring + (i % NS) * Cfg::STAGE, tiles.row0(i), t); };
  for (int i = 0; i < NS; ++i) {
    if (i < tiles.n) load(i);
    cp_async_commit();
  }

  const unsigned w0 = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned w1s = w0 + Cfg::BLOCK, w1h = w1s + Cfg::BLOCK;
  const int rl = warp * 16 + (lane >> 2);  // this thread's rows in the tile: rl, rl + 8
#ifdef HDRTV_SM90_PHASES
  // Cycles per phase of a tile (the wait for its rows and the refill; the
  // first product's A split from the staged cond, x and add read, xsum
  // stored; the products and their waits; the hand-off of the hidden into
  // the second products' A; t and its stores), summed by each warpgroup's
  // first thread.
  unsigned long long t_start = clock64(), t_phase[8] = {0, 0, 0, 0, 0, 0, 0, 0}, t_mark = 0;
#define PHASE(i) (t_phase[i] += clock64() - t_mark, t_mark = clock64());
#else
#define PHASE(i)
#endif
  for (int i = 0; i < tiles.n; ++i) {
#ifdef HDRTV_SM90_PHASES
    t_mark = clock64();
#endif
    // tile i's rows arrived (this thread's copies, then everyone's)
    cp_async_wait<NS - 1>();
    warpgroup_sync(wg);
    PHASE(1)
    const unsigned char* const st = ring + (i % NS) * Cfg::STAGE;
    const unsigned char* const xs = st + kRowBM * Cfg::CPITCH;
    const unsigned char* const as = xs + kRowBM * Cfg::XPITCH;
    uint32_t cb[2][4], cs[2][4];
#pragma unroll
    for (int j = 0; j < CC / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = *reinterpret_cast<const float2*>(st + (rl + 8 * h) * Cfg::CPITCH + (8 * j + 2 * q) * 4);
        split_pair(v.x, v.y, cb, cs, j, h);
      }
    float2 xv[C / 8][2];  // x (+ add) at columns 8j + 2q, + 1 of rows rl + 8h
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = (rl + 8 * h) * Cfg::XPITCH + (8 * j + 2 * q) * 4;
        xv[j][h] = *reinterpret_cast<const float2*>(xs + off);
        if (a.add) {
          const float2 u = *reinterpret_cast<const float2*>(as + off);
          xv[j][h] = make_float2(xv[j][h].x + u.x, xv[j][h].y + u.y);
        }
      }
    PHASE(2)
    // everyone has read the stage: it takes tile i + NS
    warpgroup_sync(wg);
    if (i + NS < tiles.n) load(i + NS);
    cp_async_commit();
    PHASE(1)

    const long long r0 = tiles.row0(i);
    if (a.xsum) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = r0 + rl + 8 * h;
#pragma unroll
        for (int j = 0; j < C / 8; ++j)
          if (row < a.rows) *reinterpret_cast<float2*>(a.xsum + row * C + 8 * j + 2 * q) = xv[j][h];
      }
    }
    PHASE(2)
    float d0[2 * CC / 2];  // m64n32: the two branches' hidden side by side
    wgmma_fence();
    sft_product_tf32x3(d0, cb, cs, w0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d0);
    fence_frags(cb);
    fence_frags(cs);
    PHASE(3)
    uint32_t hb[2][2][4], hs[2][2][4];  // [0]: the scale branch's hidden, [1]: the shift branch's
#pragma unroll
    for (int j = 0; j < 2 * CC / 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(b0 + 8 * j + 2 * q);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        split_pair(apply_act(d0[4 * j + 2 * h] + bb.x, ACT_LRELU), apply_act(d0[4 * j + 2 * h + 1] + bb.y, ACT_LRELU),
                   hb[j >> 1], hs[j >> 1], j & 1, h);
    }
    PHASE(4)
    float sc[C / 2], sh[C / 2];
    wgmma_fence();
    sft_product_tf32x3(sc, hb[0], hs[0], w1s);
    sft_product_tf32x3(sh, hb[1], hs[1], w1h);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(sh);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      fence_frags(hb[k]);
      fence_frags(hs[k]);
    }
    PHASE(3)
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int n = 8 * j + 2 * q;
      const float2 bs = *reinterpret_cast<const float2*>(b1s + n);
      const float2 bh = *reinterpret_cast<const float2*>(b1h + n);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = r0 + rl + 8 * h;
        const float s0 = sc[4 * j + 2 * h] + bs.x, s1 = sc[4 * j + 2 * h + 1] + bs.y;
        const float h0 = sh[4 * j + 2 * h] + bh.x, h1 = sh[4 * j + 2 * h + 1] + bh.y;
        // multiply and add rounded apart, as the Pallas body (no contraction into an fma)
        const float t0 = __fadd_rn(__fmul_rn(xv[j][h].x, s0 + 1.f), h0);
        const float t1 = __fadd_rn(__fmul_rn(xv[j][h].y, s1 + 1.f), h1);
        if (row < a.rows) *reinterpret_cast<float2*>(a.t + row * C + n) = make_float2(t0, t1);
      }
    }
    PHASE(5)
  }
  cp_async_wait<0>();
#ifdef HDRTV_SM90_PHASES
  t_phase[0] = clock64() - t_start;
  t_phase[7] = tiles.n;
  if (a.phases && t == 0)
    for (int k = 0; k < 8; ++k) a.phases[(blockIdx.x * WGS + wg) * 8 + k] = t_phase[k];
#endif
#undef PHASE
}

// ---------------------------------------------------------------------------
// The int8-output mode (sft_q8_f32_kernel): the SFT pass of the fp32 s2d
// forms of tail_w8a8 and sft_conv3_w8a8 (tail.cu, sft_conv3.cu), whose int8
// 3×3 conv then runs the wgmma s8 tile of conv3x3_s8_sm90.cuh through its
// fp32-output epilogue. Replaces, with that tile, the int8 bodies of the
// Pallas kernels fused_tail (hdrtv_tpu/ops/megakernel.py:468-469) and
// fused_sft_conv3_v2 (:852-855) in fp32 on s2d weights.
//
// The float mode's row tile: one block an SM of three warpgroups, each with
// two ring stages of 64 rows of cond, x and add (sft_f32_load: the coarse up
// tensor un-folded on read, x + add summed in fp32, no sum written). t is
// formed as the float mode forms it, x·(scale + 1) then + shift rounded
// apart, but never stored: it is quantized in registers and written as the
// conv's 1-byte codes, the (rows, C) code rows being byte for byte the
// (npix, 4·C) s2d codes the s8 tile reads.
//
// Products: fp32 FMA chains, each output's 16 products summed from zero in
// the order of K, then + bias: the order of the plain version's fp32
// matmul, so that t equals the plain version's t bit for bit and the codes
// equal its codes. A code flips where t / s lies on a half-integer and t
// differs in its last bit: the float mode's 3×TF32 products move t's last
// bit in a share of the values, and the plain version on their emulation
// (ops/megakernel.py sft_q8_tf32x3_emulation, products = 3) moves 8 to 50
// times sft_conv3's bound of the conv's outputs on the card (PERF.md §6). The
// 6.4 GFLOP of the L0 call take 0.10 ms at the FMA units' 67 TFLOP/s, under
// the pass's 0.14-0.22 ms of bytes.
//
// Layout: a warp's lanes share their columns, so that every weight read is
// one address for the whole warp (a broadcast). Warp w owns columns 8w ..
// 8w + 7 of the hidden [hs | hh] and of t, lane l rows l and l + 32 of the
// tile; the rows are staged at pitches (80 and 144 bytes) whose 16-byte
// reads, a row a lane, are free of bank conflicts. The first product reads
// its rows' whole cond; the hidden goes through the warpgroup's hidden tile
// so that the second products read whole hidden rows; the codes, 8 bytes a
// lane and row, through its code tile, from which each thread stores one
// 16-byte piece (a warp 16 rows, 512 contiguous bytes). Weights (plain fp32,
// 6 KB) and biases are resident in shared memory. An earlier version owned
// a quad's row pair and columns 4q .. and 16 + 4q .. (every weight read four
// addresses): 0.357 ms against 0.27 at the L0 call (PERF.md §6).
//
// Quantizing. quantize_code_fast first, for every value without a branch
// (the multiply by qinv), noting the groups of four in the band around a
// half-integer where only the IEEE division decides; where any is (rare),
// those groups again by quantize_code: quantize_code's codes bit for bit.
// ---------------------------------------------------------------------------

struct SftQ8Cfg {
  static constexpr int CC = SftTf32Cfg::CC, C = SftTf32Cfg::C, WGS = SftTf32Cfg::WGS, NS = SftTf32Cfg::NS;
  static constexpr int CPITCH = (CC + 4) * 4;      // a staged row of cond
  static constexpr int XPITCH = (C + 4) * 4;       // of x or add
  static constexpr int STAGE = kRowBM * (CPITCH + 2 * XPITCH);
  static constexpr int W_BYTES = 3 * CC * 32 * 4;  // [W0s | W0h], W1s, W1h: 16 rows of 32 floats each
  static constexpr int BIAS_BYTES = 3 * 32 * 4;    // [b0s | b0h], b1s, b1h
  static constexpr int HPITCH = C + 4;             // floats a row of the hidden tile
  static constexpr int HID = kRowBM * HPITCH * 4;  // a warpgroup's hidden tile
  static constexpr int QPITCH = C + 16;            // bytes a row of the code tile
  static constexpr int CODES = kRowBM * QPITCH;
  static constexpr int HID_OFF = W_BYTES + BIAS_BYTES;
  static constexpr int CODE_OFF = HID_OFF + WGS * HID;
  static constexpr int RING_OFF = CODE_OFF + WGS * CODES;
  static constexpr int SMEM = RING_OFF + WGS * NS * STAGE;
  static_assert(2 * CC == 32 && C == 32, "the weight rows: 32 floats, a warp's columns 8 of them");
  static_assert(SMEM <= 227 * 1024, "one block per SM");
  static_assert(HID_OFF % 16 == 0 && CODE_OFF % 16 == 0 && RING_OFF % 16 == 0 && STAGE % 16 == 0 &&
                    CPITCH % 16 == 0 && XPITCH % 16 == 0 && QPITCH % 16 == 0,
                "16-byte alignment");
};

__device__ __forceinline__ void unpack4(float* d, float4 v) {
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

__global__ void __launch_bounds__(128 * SftQ8Cfg::WGS, 1) sft_q8_f32_kernel(const __grid_constant__ SftF32Args a) {
  using Cfg = SftQ8Cfg;
  constexpr int CC = Cfg::CC, C = Cfg::C, NS = Cfg::NS, WGS = Cfg::WGS;
  extern __shared__ __align__(16) unsigned char row_smem[];
  float* const w0 = reinterpret_cast<float*>(row_smem);  // row k: [W0s | W0h]
  float* const w1s = w0 + CC * 32;
  float* const w1h = w1s + CC * 32;
  float* const b0 = w1h + CC * 32;  // [b0s | b0h]
  float* const b1s = b0 + 32;
  float* const b1h = b1s + 32;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = tid & 31;
  float* const hid = reinterpret_cast<float*>(row_smem + Cfg::HID_OFF + wg * Cfg::HID);
  unsigned char* const codes = row_smem + Cfg::CODE_OFF + wg * Cfg::CODES;
  unsigned char* const ring = row_smem + Cfg::RING_OFF + wg * NS * Cfg::STAGE;

  // the blocks at the top left of the s2d weights, and the biases' first quarters
  for (int i = tid; i < CC * 32; i += 128 * WGS) {
    const int k = i >> 5, n = i & 31;
    w0[i] = n < CC ? a.w[0][k * a.ld[0] + n] : a.w[2][k * a.ld[2] + n - CC];
    w1s[i] = a.w[1][k * a.ld[1] + n];
    w1h[i] = a.w[3][k * a.ld[3] + n];
  }
  for (int i = tid; i < 32; i += 128 * WGS) {
    b0[i] = i < CC ? a.b[0][i] : a.b[2][i - CC];
    b1s[i] = a.b[1][i];
    b1h[i] = a.b[3][i];
  }
  __syncthreads();

  const RowTiles tiles(a.rows, wg, WGS);
  auto load = [&](int i) { sft_f32_load<Cfg>(a, ring + (i % NS) * Cfg::STAGE, tiles.row0(i), t); };
  for (int i = 0; i < NS; ++i) {
    if (i < tiles.n) load(i);
    cp_async_commit();
  }

  const int col0 = 8 * warp;  // this warp's columns of [hs | hh] and of t; this lane's rows: lane, lane + 32
#ifdef HDRTV_SM90_PHASES
  // Cycles per phase of a tile (the wait for its rows and the refill; cond,
  // x and add read from the stage; the first product with its bias and leaky
  // ReLU, the hidden tile's stores and the meeting; the second products; t,
  // its codes and the code tile's stores; the meeting and the stores),
  // summed by each warpgroup's first thread.
  unsigned long long t_start = clock64(), t_phase[8] = {0, 0, 0, 0, 0, 0, 0, 0}, t_mark = 0;
#define PHASE(i) (t_phase[i] += clock64() - t_mark, t_mark = clock64());
#else
#define PHASE(i)
#endif
  for (int i = 0; i < tiles.n; ++i) {
#ifdef HDRTV_SM90_PHASES
    t_mark = clock64();
#endif
    // tile i's rows arrived (this thread's copies, then everyone's)
    cp_async_wait<NS - 1>();
    warpgroup_sync(wg);
    PHASE(1)
    const unsigned char* const st = ring + (i % NS) * Cfg::STAGE;
    const unsigned char* const xs = st + kRowBM * Cfg::CPITCH;
    const unsigned char* const as = xs + kRowBM * Cfg::XPITCH;
    float cv[2][CC], xv[2][8];  // cond rows lane, lane + 32; x (+ add) at the warp's columns
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
#pragma unroll
      for (int c4 = 0; c4 < CC / 4; ++c4)
        unpack4(cv[h] + 4 * c4, *reinterpret_cast<const float4*>(st + r * Cfg::CPITCH + c4 * 16));
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int off = r * Cfg::XPITCH + (col0 + 4 * g) * 4;
        float4 v = *reinterpret_cast<const float4*>(xs + off);
        if (a.add) {
          const float4 u = *reinterpret_cast<const float4*>(as + off);
          v = make_float4(__fadd_rn(v.x, u.x), __fadd_rn(v.y, u.y), __fadd_rn(v.z, u.z), __fadd_rn(v.w, u.w));
        }
        unpack4(xv[h] + 4 * g, v);
      }
    }
    PHASE(2)
    // everyone has read the stage: it takes tile i + NS
    warpgroup_sync(wg);
    if (i + NS < tiles.n) load(i + NS);
    cp_async_commit();
    PHASE(1)

    // hidden = lrelu(cond·[W0s | W0h] + [b0s | b0h]) at the warp's columns
    float hv[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) hv[h][j] = 0.f;
#pragma unroll
    for (int k = 0; k < CC; ++k) {
      float wv[8];
      unpack4(wv, *reinterpret_cast<const float4*>(w0 + k * 32 + col0));
      unpack4(wv + 4, *reinterpret_cast<const float4*>(w0 + k * 32 + col0 + 4));
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j) hv[h][j] = fmaf(cv[h][k], wv[j], hv[h][j]);
    }
    {
      float bv[8];
      unpack4(bv, *reinterpret_cast<const float4*>(b0 + col0));
      unpack4(bv + 4, *reinterpret_cast<const float4*>(b0 + col0 + 4));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < 8; ++j) hv[h][j] = apply_act(__fadd_rn(hv[h][j], bv[j]), ACT_LRELU);
        float* const row = hid + (lane + 32 * h) * Cfg::HPITCH + col0;
        *reinterpret_cast<float4*>(row) = make_float4(hv[h][0], hv[h][1], hv[h][2], hv[h][3]);
        *reinterpret_cast<float4*>(row + 4) = make_float4(hv[h][4], hv[h][5], hv[h][6], hv[h][7]);
      }
    }
    // every warp's columns of the hidden rows are in the tile (and everyone
    // has stored the last tile's codes)
    warpgroup_sync(wg);
    PHASE(3)
    // scale and shift at the warp's columns: hs·W1s, hh·W1h
    float sc[2][8], sh[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[h][j] = sh[h][j] = 0.f;
#pragma unroll
    for (int k4 = 0; k4 < CC / 4; ++k4) {
      float hs[2][4], hh[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* const row = hid + (lane + 32 * h) * Cfg::HPITCH;
        unpack4(hs[h], *reinterpret_cast<const float4*>(row + 4 * k4));
        unpack4(hh[h], *reinterpret_cast<const float4*>(row + CC + 4 * k4));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = 4 * k4 + kk;
        float ws[8], wh[8];
        unpack4(ws, *reinterpret_cast<const float4*>(w1s + k * 32 + col0));
        unpack4(ws + 4, *reinterpret_cast<const float4*>(w1s + k * 32 + col0 + 4));
        unpack4(wh, *reinterpret_cast<const float4*>(w1h + k * 32 + col0));
        unpack4(wh + 4, *reinterpret_cast<const float4*>(w1h + k * 32 + col0 + 4));
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            sc[h][j] = fmaf(hs[h][kk], ws[j], sc[h][j]);
            sh[h][j] = fmaf(hh[h][kk], wh[j], sh[h][j]);
          }
      }
    }
    PHASE(4)
    // t, multiply and add rounded apart as the Pallas body, then its codes
    unsigned cw[4];     // codes of row lane + 32h, columns col0 + 4g .. + 3, at 2h + g (byte e: column + e)
    unsigned near = 0;  // bit 2h + g: a value of that group lies in quantize_code_fast's band
    float tv[2][8];
    {
      float bs[8], bh[8];
      unpack4(bs, *reinterpret_cast<const float4*>(b1s + col0));
      unpack4(bs + 4, *reinterpret_cast<const float4*>(b1s + col0 + 4));
      unpack4(bh, *reinterpret_cast<const float4*>(b1h + col0));
      unpack4(bh + 4, *reinterpret_cast<const float4*>(b1h + col0 + 4));
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          bool nr = false;
          unsigned w = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * g + e;
            const float s = __fadd_rn(sc[h][j], bs[j]), hsh = __fadd_rn(sh[h][j], bh[j]);
            tv[h][j] = __fadd_rn(__fmul_rn(xv[h][j], __fadd_rn(s, 1.f)), hsh);
            w |= static_cast<unsigned>(quantize_code_fast(tv[h][j], a.qinv, a.qz, a.qasym, nr) & 0xff) << (8 * e);
          }
          cw[2 * h + g] = w;
          near |= static_cast<unsigned>(nr) << (2 * h + g);
        }
    }
    if (near)
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (near >> p & 1u) {
          unsigned w = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w |= static_cast<unsigned>(quantize_code(tv[p >> 1][4 * (p & 1) + e], a.qs, a.qz, a.qasym) & 0xff)
                 << (8 * e);
          cw[p] = w;
        }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint2*>(codes + (lane + 32 * h) * Cfg::QPITCH + col0) = make_uint2(cw[2 * h], cw[2 * h + 1]);
    PHASE(5)
    // every warp's codes are in the tile: thread t stores piece t % 2 of row t / 2
    warpgroup_sync(wg);
    const long long row = tiles.row0(i) + (t >> 1);
    if (row < a.rows)
      *reinterpret_cast<uint4*>(a.q + row * C + 16 * (t & 1)) =
          *reinterpret_cast<const uint4*>(codes + (t >> 1) * Cfg::QPITCH + 16 * (t & 1));
    PHASE(6)
  }
  cp_async_wait<0>();
#ifdef HDRTV_SM90_PHASES
  t_phase[0] = clock64() - t_start;
  t_phase[7] = tiles.n;
  if (a.phases && t == 0)
    for (int k = 0; k < 8; ++k) a.phases[(blockIdx.x * WGS + wg) * 8 + k] = t_phase[k];
#endif
#undef PHASE
}

// The fp32 SFT pass over s2d weights, as sft_sm90 takes it (H × W s2d
// pixels of C and CC channels; add nullptr, fine (coarse = 0) or coarse
// (coarse = 1, H and W even); xsum (with add only) nullptr or the sum's
// destination; sft: the eight pointers w, b of scale0, scale1, shift0,
// shift1, whose blocks lie at the top left of weights of row pitch CC, C,
// CC, C). q: the int8-output mode (sft_q8_f32_kernel), t written as the
// codes of the layer q (no xsum). The natural widths CC = 16 and C = 32 are
// the ones it takes; anything else is refused. `phases`
// (tools/sm90_s8_phases.cu): the timers' array, else null.
inline cudaError_t sft_tf32x3(const void* x, const void* add, int coarse, void* xsum, const void* cond, void* t,
                              const void* const* sft, int H, int W, int C, int CC, cudaStream_t stream,
                              const QuantParams* q = nullptr, unsigned long long* phases = nullptr) {
  using Cfg = SftTf32Cfg;
  if (C != 4 * Cfg::C || CC != 4 * Cfg::CC || (add && coarse && (H % 2 || W % 2)) || (xsum && !add) || (xsum && q))
    return cudaErrorInvalidValue;
  SftF32Args a;
  a.cond = static_cast<const float*>(cond);
  a.x = static_cast<const float*>(x);
  a.add = static_cast<const float*>(add);
  a.xsum = static_cast<float*>(xsum);
  a.t = q ? nullptr : static_cast<float*>(t);
  const int ld[4] = {CC, C, CC, C};
  for (int i = 0; i < 4; ++i) {
    a.w[i] = static_cast<const float*>(sft[2 * i]);
    a.b[i] = static_cast<const float*>(sft[2 * i + 1]);
    a.ld[i] = ld[i];
  }
  a.rows = 4LL * H * W;
  a.W = W;
  a.coarse = coarse;
#ifdef HDRTV_SM90_PHASES
  a.phases = phases;
#else
  (void)phases;
#endif
  int resident = 0;
  if (q) {
    a.q = static_cast<int8_t*>(t);
    a.qs = q->s;
    a.qinv = 1.f / q->s;
    a.qz = q->z;
    a.qasym = q->asym;
    static DeviceCache qcache;
    const cudaError_t err = resident_blocks(qcache, sft_q8_f32_kernel, SftQ8Cfg::SMEM, &resident, 128 * SftQ8Cfg::WGS);
    if (err != cudaSuccess) return err;
    sft_q8_f32_kernel<<<row_blocks(a.rows, resident, SftQ8Cfg::WGS), 128 * SftQ8Cfg::WGS, SftQ8Cfg::SMEM, stream>>>(a);
    return cudaGetLastError();
  }
  static DeviceCache cache;
  const cudaError_t err = resident_blocks(cache, sft_tf32x3_kernel, Cfg::SMEM, &resident, 128 * Cfg::WGS);
  if (err != cudaSuccess) return err;
  sft_tf32x3_kernel<<<row_blocks(a.rows, resident, Cfg::WGS), 128 * Cfg::WGS, Cfg::SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace hdrtv
