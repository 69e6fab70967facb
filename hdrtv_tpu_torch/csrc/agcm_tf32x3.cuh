// agcm_tf32x3_kernel: the fp32 instance of agcm_sm90 (chain_sm90.cuh),
// agcm_head's AGCM pass in its fp32 s2d form (agcm_head.cu, s2d=True in
// fp32): the frame's (4·npix, 3) natural rows through the three 1×1s'
// diagonal blocks, 3 → 64 → 64 → 3,
//   a = relu(mod0(x·W1 + b1)), b = relu(mod1(a·W2 + b2)), y = mod2(b·W3 + b3)
// each modulated at the row's own sub-position, as the bf16 tile; every value
// fp32, as the Pallas body in fp32: x = u8 · scale (or the fp32 frame ·
// scale), the modulation's multiply and add rounded apart, fp32 biases,
// nothing narrowed; y written in fp32.
//
// Products: 3×TF32 on wgmma m64nNk8, as cond_chain's instance
// (chain_tf32x3.cuh). K = 3 is
// padded to 8 (one k8 step: 3 products), the hidden steps' K = 64 summed as
// two 32-channel chunks (12 products each, from zero, added in fp32:
// chain_step_tf32x3), N = 3 padded to 8 (m64n8k8). The hidden layers go from
// accumulator to the next step's A in registers, in chain_kpos order (the
// blocks staged so); step 0's A is this thread's k = q and q + 4 of K = 8,
// channels 2q and 2q + 1 of the row (only 0 .. 2 exist), loaded straight
// into registers two tiles ahead and split under the last step's products
// of the tile before.
//
// Weights: the three blocks split once into shared memory (K-major, the
// 128-byte swizzle, big then small): W1 16 KB, W2 32 KB, W3 4 KB, in each
// block. Two blocks per SM, persistent, of two warpgroups (tiles 2·block +
// warpgroup, + 2·gridDim), at 120 registers a thread: one block of three
// warpgroups at 166 took 0.365 ms against 0.343 (PERF.md §6).
//
// Bound on this card: operations at a third of the TF32 rate. At 1080p the
// 2.07 M rows need 18.6 GFLOP of block products (0.113 ms at 494.7 / 3
// TFLOP/s; 0.28 ms at the FMA units' 67), against 6.2 MB in (u8 pair planes)
// and 24.9 MB out (0.0093 ms). Times: PERF.md §6.
#pragma once

#include "chain_tf32x3.cuh"

namespace hdrtv {
namespace {

struct AgcmF32Args {
  const void* x;      // the frame: fp32 (npix, 12), u8 (npix, 12) or u8 pair planes (Hb, 2, Wb, 6)
  int kind;           // AgcmFrameKind (kAgcmFrameBf16: the frame in the element type, fp32 here)
  float scale;
  const float* mods;  // (6, mw)
  int mw;
  const float* w[3];  // the blocks, row-major, padded: (16, 64), (64, 64), (64, 16)
  const float* b[3];  // s2d biases: their first 64, 64 and 3 values are the blocks'
  float* y;           // (rows, 3): the AGCM result, (npix, 12) s2d
  long long rows;     // 4·npix
  int W;              // s2d pixels of an image row (pair planes)
#ifdef HDRTV_SM90_PHASES
  unsigned long long* phases = nullptr;  // tools/sm90_phases.py: 8 clock64() sums per warpgroup
#endif
};

struct AgcmTf32Cfg {
  static constexpr int N = 64, NL = 8, ML = 16;  // hidden width, the last step's padded N, its mods lanes
  static constexpr int WGS = 2;                  // warpgroups a block, two blocks an SM
  static constexpr int W1 = 2 * N * 32 * 4;      // K = 8 in one 32-position chunk, big then small
  static constexpr int W2 = 2 * N * N * 4;
  static constexpr int W3 = 2 * NL * N * 4;
  static constexpr int W_BYTES = W1 + W2 + W3;
  static constexpr int MP = N + 8;                        // floats of a sub-position's lanes: conflict-free pairs
  static constexpr int MOD_FLOATS = 4 * 4 * MP + 2 * ML;  // rows 0-3 by sub-position; rows 4-5 (12 lanes of 16)
  static constexpr int BIAS_FLOATS = 2 * N + ML;
  static constexpr int YST = 16 * 3 * 4;                  // a warp's staged rows of y
  static constexpr int SMEM = 1024 + W_BYTES + (MOD_FLOATS + BIAS_FLOATS) * 4 + 4 * WGS * YST;
  static_assert(W1 % 1024 == 0 && W2 % 1024 == 0 && W3 % 1024 == 0, "the blocks' swizzle alignment");
  static_assert(2 * (SMEM + 1024) <= 228 * 1024, "two blocks per SM");
};

// Element e of the frame, widened to fp32.
__device__ __forceinline__ float agcm_f32_frame_value(const AgcmF32Args& a, unsigned e) {
  if (a.kind == kAgcmFrameBf16) return static_cast<const float*>(a.x)[e];
  return static_cast<float>(static_cast<const uint8_t*>(a.x)[e]);
}

__global__ void __launch_bounds__(128 * AgcmTf32Cfg::WGS, 2) agcm_tf32x3_kernel(const __grid_constant__ AgcmF32Args a) {
  using Cfg = AgcmTf32Cfg;
  constexpr int N = Cfg::N, NL = Cfg::NL, ML = Cfg::ML, MP = Cfg::MP, WGS = Cfg::WGS;
  extern __shared__ __align__(16) unsigned char row_smem[];
  unsigned char* const smem =
      row_smem + ((1024u - (static_cast<unsigned>(__cvta_generic_to_shared(row_smem)) & 1023u)) & 1023u);
  float* const mod = reinterpret_cast<float*>(smem + Cfg::W_BYTES);  // [row 0-3][so][MP], rows 0, 2 as s + 1
  float* const modl = mod + 4 * 4 * MP;                              // [row 4-5][so·3 + n], row 4 as s + 1
  float* const bias = modl + 2 * ML;                                 // b1 | b2 | b3 (3 of 16)
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = tid & 31, q = lane & 3;
  float* const yst = bias + Cfg::BIAS_FLOATS + (tid >> 5) * (Cfg::YST / 4);

  stage_b_tf32x3(smem, N, a.w[0], N, 8);
  stage_b_tf32x3(smem + Cfg::W1, N, a.w[1], N, N);
  stage_b_tf32x3(smem + Cfg::W1 + Cfg::W2, NL, a.w[2], ML, N);
  // the scale rows staged as s + 1 (the same fp32 value the modulation forms)
  for (int i = tid; i < 4 * 4 * N; i += 128 * WGS) {
    const int row = i / (4 * N), l = i % (4 * N);  // l = so·64 + n
    const float m = a.mods[static_cast<long long>(row) * a.mw + l];
    mod[row * 4 * MP + (l / N) * MP + l % N] = row % 2 ? m : m + 1.f;
  }
  for (int i = tid; i < 2 * ML; i += 128 * WGS)
    modl[i] = i % ML < 12 ? a.mods[static_cast<long long>(4 + i / ML) * a.mw + i % ML] + (i < ML ? 1.f : 0.f) : 0.f;
  for (int i = tid; i < Cfg::BIAS_FLOATS; i += 128 * WGS)
    bias[i] = i < 2 * N ? a.b[i / N][i % N] : (i - 2 * N < 3 ? a.b[2][i - 2 * N] : 0.f);
  // the weights, written by the generic proxy, are read by wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const RowTiles tiles(a.rows, wg, WGS);
  const int rl = warp * 16 + (lane >> 2);  // this thread's rows in the tile: rl, rl + 8
  const int so = (lane >> 2) & 3;          // their sub-position (tiles start at multiples of 64)
  // this thread's values of step 0's A: rows rl + 8h, channels 2q + e (q
  // 0: channels 0, 1; q 1: channel 2; q 2, 3: none)
  const float inv_w = 1.f / static_cast<float>(a.W);
  auto fetch = [&](int i, float (&v)[4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = tiles.row0(i) + rl + 8 * h;
      v[2 * h] = v[2 * h + 1] = 0.f;
      if (q < 2 && r < a.rows) {
        const unsigned e = agcm_row_start(a, static_cast<unsigned>(r), so, inv_w) + 2 * q;
        v[2 * h] = agcm_f32_frame_value(a, e);
        if (q == 0) v[2 * h + 1] = agcm_f32_frame_value(a, e + 1);
      }
    }
  };
  // a hidden step's epilogue: bias, the modulation of mods rows `row` (s + 1)
  // and row + 1 (shift), ReLU, split into the next step's A fragments
  auto hidden = [&](const float (&d)[N / 2], const float* bs, int row, uint32_t (&ab)[8][4], uint32_t (&as)[8][4]) {
    const float* const sc = mod + row * 4 * MP + so * MP;
    const float* const sh = sc + 4 * MP;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int n = 8 * j + 2 * q;
      const float2 bb = *reinterpret_cast<const float2*>(bs + n);
      const float2 s = *reinterpret_cast<const float2*>(sc + n);
      const float2 hh = *reinterpret_cast<const float2*>(sh + n);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        split_pair(fmaxf(__fadd_rn(__fmul_rn(d[4 * j + 2 * h] + bb.x, s.x), hh.x), 0.f),
                   fmaxf(__fadd_rn(__fmul_rn(d[4 * j + 2 * h + 1] + bb.y, s.y), hh.y), 0.f), ab, as, j, h);
    }
  };
  // the last step's constants of this thread's columns 2q + c (< 3)
  float lb[2], ls[2], lh[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int n = 2 * q + c < 3 ? 2 * q + c : 0;
    lb[c] = bias[2 * N + n];
    ls[c] = modl[so * 3 + n];
    lh[c] = modl[ML + so * 3 + n];
  }

  const unsigned w1 = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned w2 = w1 + Cfg::W1, w3 = w2 + Cfg::W2;
#ifdef HDRTV_SM90_PHASES
  // Cycles per phase of a tile (the last step's issue with the next tile's
  // split and fetch under it; the three steps' products (step 2: its wait);
  // the two hidden hand-offs; the output), summed by each warpgroup's first
  // thread.
  unsigned long long t_start = clock64(), t_phase[8] = {0, 0, 0, 0, 0, 0, 0, 0}, t_mark = 0;
#define PHASE(i) (t_phase[i] += clock64() - t_mark, t_mark = clock64());
#else
#define PHASE(i)
#endif
  // step 0's A of the next tile, split from its frame values (nxt), which
  // are loaded a tile ahead of that
  float nxt[4];
  uint32_t xb[1][4], xs[1][4];
  auto split_x = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      split_pair(__fmul_rn(nxt[2 * h], a.scale), __fmul_rn(nxt[2 * h + 1], a.scale), xb, xs, 0, h);
  };
  if (tiles.n > 0) {
    fetch(0, nxt);
    split_x();
  }
  if (tiles.n > 1) fetch(1, nxt);
  for (int i = 0; i < tiles.n; ++i) {
#ifdef HDRTV_SM90_PHASES
    t_mark = clock64();
#endif
    float d[N / 2];
    wgmma_fence();
    WgmmaTf32<N>::mma(d, xs[0], desc_sw128(w1), 0);
    WgmmaTf32<N>::mma(d, xb[0], desc_sw128(w1 + N * 32 * 4));
    WgmmaTf32<N>::mma(d, xb[0], desc_sw128(w1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    fence_frags(xb);
    fence_frags(xs);
    PHASE(2)
    uint32_t ab[8][4], as[8][4];
    hidden(d, bias, 0, ab, as);
    PHASE(3)
    chain_step_tf32x3<N>(d, ab, as, w2);
    fence_frags(ab);
    fence_frags(as);
    PHASE(4)
    hidden(d, bias + N, 2, ab, as);
    PHASE(5)
    // the last step's products run while the next tile's A is split and the
    // one after it fetched
    float e[NL / 2], pe[NL / 2];
    chain_issue_tf32x3<NL>(e, pe, ab, as, w3);
    if (i + 1 < tiles.n) split_x();
    if (i + 2 < tiles.n) fetch(i + 2, nxt);
    PHASE(1)
    wgmma_wait<0>();
    fence_regs(e);
    fence_regs(pe);
    fence_frags(ab);
    fence_frags(as);
#pragma unroll
    for (int k = 0; k < NL / 2; ++k) e[k] += pe[k];
    PHASE(6)
    // columns 2q, 2q + 1 (e[2h], e[2h + 1]) of rows rl + 8h; 0 .. 2 exist
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = 2 * q + c;
        if (n < 3) yst[((lane >> 2) + 8 * h) * 3 + n] = __fadd_rn(__fmul_rn(e[2 * h + c] + lb[c], ls[c]), lh[c]);
      }
    __syncwarp();
    // the warp's 16 rows are 48 consecutive values
    const long long r0 = tiles.row0(i) + warp * 16;
    for (int k = lane; k < 48; k += 32)
      if (r0 * 3 + k < a.rows * 3) a.y[r0 * 3 + k] = yst[k];
    __syncwarp();
    PHASE(7)
  }
#ifdef HDRTV_SM90_PHASES
  t_phase[0] = clock64() - t_start;
  if (a.phases && t == 0)
    for (int k = 0; k < 8; ++k) a.phases[(blockIdx.x * WGS + wg) * 8 + k] = t_phase[k];
#endif
#undef PHASE
}

// The AGCM pass of agcm_head's fp32 s2d form (arguments: AgcmF32Args).
inline cudaError_t agcm_tf32x3(const AgcmF32Args& a, cudaStream_t stream) {
  static DeviceCache cache;
  int resident = 0;
  const cudaError_t err =
      resident_blocks(cache, agcm_tf32x3_kernel, AgcmTf32Cfg::SMEM, &resident, 128 * AgcmTf32Cfg::WGS);
  if (err != cudaSuccess) return err;
  agcm_tf32x3_kernel<<<row_blocks(a.rows, resident, AgcmTf32Cfg::WGS), 128 * AgcmTf32Cfg::WGS, AgcmTf32Cfg::SMEM,
                       stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace hdrtv
