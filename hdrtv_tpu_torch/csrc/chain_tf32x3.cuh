// The fp32 instance of chain_sm90.cuh's row tile, sm_90a: cond_chain's fp32
// s2d form (cond_chain.cu), its five 1×1 steps 64 → 64 ×4 → 16 over the
// (4·npix, 64) natural rows of c0, each multiplying its weight's first
// diagonal block; float steps as 3×TF32 on wgmma m64nNk8, int8 steps
// (cond_chain_w8a8, the Q instance) on the s8 wgmma as in the bf16 Q
// instance. Replaces, with the bf16 tile, the Pallas kernel fused_cond_chain
// (hdrtv_tpu/ops/megakernel.py:352, body _cond_chain_kernel :294) in fp32.
//
// Rounding as the Pallas kernel's in fp32: the running value is never
// narrowed; sums, bias and leaky ReLU are fp32; c (after step 2) and cond1
// are written as they are.
//
// Float steps. Each operand is split, big = tf32(x) and small = tf32(x −
// big) (cvt.rna.tf32.f32, as conv3x3_tf32x3.cuh), and the tile sums small·big
// + big·small + big·big: fp32 accuracy at a third of the TF32 rate. The sum
// of a step runs as two tensor-core sums of 32 channels each (12 products,
// each from zero) added in fp32 registers, as the 3×TF32 conv tile sums a
// chunk: one tensor-core sum over a long K drifts toward zero.
//
// A in registers, from step to step. tf32's register A of m64nNk8 holds,
// for rows r and r + 8 of the warp, k = q and k = q + 4 (q = lane % 4); the
// fp32 accumulator of m64nN holds columns 8j + 2q and 8j + 2q + 1 of the same
// rows. So k8 step j takes channels 8j + 2q (as its k = q) and 8j + 2q + 1
// (its k = q + 4): each step's output, activated and split, is the next
// step's A without leaving the thread, and the weight blocks are staged with
// that order of K (chain_kpos). The first step's A comes from the staged c0
// rows in the same order (float2 reads; rows of 64 floats + 8 of pad, free of
// bank conflicts).
//
// Weights. The five blocks, split once per block into shared memory: K-major
// (row n of a block holds output n's 64 inputs), as two 32-channel chunks of
// N rows × 128 bytes in the 128-byte swizzle, big then small, 139,264 bytes
// (an int8 step's codes block takes its step's slot). So one block per SM,
// persistent, of three warpgroups (tiles 3·block + warpgroup, + 3·gridDim),
// each with one 64-row stage of c0 (18,432 bytes): a stage is read into
// registers at the start of its tile and refilled at once, so the next tile
// is in flight while this one is computed. The third warpgroup (at most 168
// registers a thread) keeps the tensor cores busier than two warpgroups of
// two stages did: 0.766 against 0.822 ms all float, 1.33 against 1.66 with
// int8 steps (PERF.md §6). c and cond1 are stored from registers: a quad
// writes 32 contiguous bytes of a row, whole sectors.
//
// Int8 steps (Q): the codes are quantized from the fp32 running value in
// registers into the warpgroup's code tile and multiplied by the step's int8
// block (chain_step_s8), then ·yscale, + the folded bias, rounded apart, and
// the leaky ReLU but on the last step. A thread first writes the codes of
// its 64 values by quantize_code_rcp's multiply alone, without a branch
// (put_codes_fast), noting which pairs lie in the band where only the IEEE
// division decides; then, where any does (about 1.5% of a thread's passes),
// writes those pairs again by put_codes, bit for bit quantize_code's. With a
// branch per value the compiler ran the values one after the other.
//
// Bound on this card (1080p, 540 × 960 s2d pixels): 1.19 GB of fp32 moved,
// 0.357 ms; 72 GFLOP of block products, each three TF32 products at the
// dense TF32 rate (494.7 TFLOP/s), 0.44 ms (1.08 ms at the FMA units' 67).
// Measured on an H100 (PERF.md §6): 0.766 ms all float, the products half a
// warpgroup's cycles and the hand-off 28%; 1.33 ms with steps 0, 2 and 4
// int8, the hand-off (quantizing, splitting) half.
#pragma once

#include "chain_sm90.cuh"
#include "conv3x3_tf32x3.cuh"

namespace hdrtv {
namespace {

using ChainF32Args = ChainRowsArgs<float>;

template <bool Q>
struct ChainTf32Cfg {
  static constexpr int K = 64, NL = 16, HID = 4;
  static constexpr int WGS = 3;                         // warpgroups a block
  static constexpr int NS = 1;                          // ring stages per warpgroup
  static constexpr int SLOT = 2 * K * K * 4;            // a 64 × 64 step's big and small blocks
  static constexpr int W_BYTES = HID * SLOT + 2 * K * NL * 4;
  static constexpr int BIAS_BYTES = (HID * K + NL) * 4;  // the biases (Q: the yscales after them)
  static constexpr int PITCH = (K + 8) * 4;             // a staged row of c0: 32 bytes of pad
  static constexpr int STAGE = kRowBM * PITCH;
  static constexpr int CODE = kRowBM * K;               // Q: a warpgroup's code tile
  static constexpr int CODE_OFF = (W_BYTES + 2 * BIAS_BYTES + 1023) / 1024 * 1024;
  static constexpr int RING_OFF = CODE_OFF + (Q ? WGS * CODE : 0);
  static constexpr int SMEM = 1024 + RING_OFF + WGS * NS * STAGE;  // 1024: the swizzles' alignment
  static_assert(SMEM <= 227 * 1024, "one block per SM");
  static_assert(SLOT % 1024 == 0 && STAGE % 16 == 0, "alignment of the blocks and stages");
};

// Where channel c of a 32-channel chunk lies along K in the chunk's 128-byte
// rows: k8 step c / 8, at k = 4·(c % 2) + (c % 8) / 2 (see the header).
__device__ __forceinline__ int chain_kpos(int c) { return (c & 24) + 4 * (c & 1) + ((c & 7) >> 1); }

// Rows k < K, columns n < N of an fp32 weight block (row pitch ld), split
// into rows r = n0 + n of a staged block of NB rows (NB = N by default):
// big at dst and small at dst + NB·K'·4 (K' = K rounded up to a whole chunk
// of 32), chunk k / 32 at (k / 32)·NB·128, row r at r·128, position p =
// chain_kpos(k % 32) in 16-byte group p / 4, swizzled by r % 8. Every
// thread of the block takes part; reads run along n.
__device__ __forceinline__ void stage_b_tf32x3(unsigned char* dst, int N, const float* src, int ld, int K,
                                               int n0 = 0, int NB = 0) {
  if (!NB) NB = N;
  const int small_off = NB * ((K + 31) & ~31) * 4;
  for (int idx = threadIdx.x; idx < K * N; idx += blockDim.x) {
    const int k = idx / N, n = idx - k * N, r = n0 + n, p = chain_kpos(k & 31);
    uint32_t big, small;
    split_tf32(src[static_cast<long long>(k) * ld + n], big, small);
    const int off = (k >> 5) * NB * 128 + r * 128 + (((p >> 2) ^ (r & 7)) << 4) + (p & 3) * 4;
    *reinterpret_cast<uint32_t*>(dst + off) = big;
    *reinterpret_cast<uint32_t*>(dst + small_off + off) = small;
  }
}

// A float step of N outputs, issued and committed: the 64-deep product of
// the split fragments (ab, as: k8 step j's register A) with the block
// staged at shared address wb, as two chunk sums (k8 steps 0-3 into d, 4-7
// into p, each from zero); the caller waits and adds them.
template <int N>
__device__ __forceinline__ void chain_issue_tf32x3(float (&d)[N / 2], float (&p)[N / 2], const uint32_t (&ab)[8][4],
                                                   const uint32_t (&as)[8][4], unsigned wb) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned big = wb + (j >> 2) * N * 128 + (j & 3) * 32, small = big + N * 64 * 4;
    if (j < 4) {
      WgmmaTf32<N>::mma(d, as[j], desc_sw128(big), j > 0);
      WgmmaTf32<N>::mma(d, ab[j], desc_sw128(small));
      WgmmaTf32<N>::mma(d, ab[j], desc_sw128(big));
    } else {
      WgmmaTf32<N>::mma(p, as[j], desc_sw128(big), j > 4);
      WgmmaTf32<N>::mma(p, ab[j], desc_sw128(small));
      WgmmaTf32<N>::mma(p, ab[j], desc_sw128(big));
    }
  }
  wgmma_commit();
}

// chain_issue_tf32x3's step, waited for, its two chunk sums added in fp32 into d.
template <int N>
__device__ __forceinline__ void chain_step_tf32x3(float (&d)[N / 2], const uint32_t (&ab)[8][4],
                                                  const uint32_t (&as)[8][4], unsigned wb) {
  float p[N / 2];
  chain_issue_tf32x3<N>(d, p, ab, as, wb);
  wgmma_wait<0>();
  fence_regs(d);
  fence_regs(p);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] += p[i];
}

// x's columns 8j + 2q, + 1 of one row, split into k8 step j's register A
// (h: the row's half of the fragment, rows r or r + 8).
template <int S>
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t (&ab)[S][4], uint32_t (&as)[S][4], int j,
                                           int h) {
  split_tf32(v0, ab[j][h], as[j][h]);
  split_tf32(v1, ab[j][2 + h], as[j][2 + h]);
}

// put_codes by quantize_code_fast: true where the pair must be written again
// by put_codes.
__device__ __forceinline__ bool put_codes_fast(unsigned char* codes, int r, int c, float v0, float v1,
                                               const ChainF32Args& a, int s) {
  bool near = false;
  const unsigned pair = (quantize_code_fast(v0, a.qinv[s], a.qz[s], a.qa[s], near) & 0xff) |
                        (quantize_code_fast(v1, a.qinv[s], a.qz[s], a.qa[s], near) & 0xff) << 8;
  *code_pair(codes, r, c) = static_cast<unsigned short>(pair);
  return near;
}

template <bool Q>
__global__ void __launch_bounds__(128 * ChainTf32Cfg<Q>::WGS, 1)
    cond_chain_sm90_tf32x3_kernel(const __grid_constant__ ChainF32Args a) {
  using Cfg = ChainTf32Cfg<Q>;
  constexpr int K = Cfg::K, NL = Cfg::NL, HID = Cfg::HID, NS = Cfg::NS, WGS = Cfg::WGS;
  extern __shared__ __align__(16) unsigned char row_smem[];
  unsigned char* const smem =
      row_smem + ((1024u - (static_cast<unsigned>(__cvta_generic_to_shared(row_smem)) & 1023u)) & 1023u);
  float* const bias = reinterpret_cast<float*>(smem + Cfg::W_BYTES);
  float* const ysc = bias + HID * K + NL;  // Q: the int8 steps' yscales
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = tid & 31, q = lane & 3;
  unsigned char* const ring = smem + Cfg::RING_OFF + wg * NS * Cfg::STAGE;
  unsigned char* const codes = smem + Cfg::CODE_OFF + wg * Cfg::CODE;  // Q: this warpgroup's code tile

  for (int s = 0; s <= HID; ++s) {
    const int n = s < HID ? K : NL;
    if (Q && a.qw[s]) {
      stage_b_s8(smem + s * Cfg::SLOT, n, a.qw[s], a.qld[s], K);
      for (int i = tid; i < n; i += 128 * WGS) {
        bias[s * K + i] = a.qb[s][i];
        ysc[s * K + i] = a.ys[s][i];
      }
    } else {
      stage_b_tf32x3(smem + s * Cfg::SLOT, n, a.w[s], a.ld[s], K);
      for (int i = tid; i < n; i += 128 * WGS) bias[s * K + i] = a.b[s][i];
    }
  }
  // the weights, written by the generic proxy, are read by wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const RowTiles tiles(a.rows, wg, WGS);
  auto load = [&](int i) {
    const long long r0 = tiles.row0(i);
    unsigned char* const st = ring + (i % NS) * Cfg::STAGE;
    constexpr int PIECES = K / 4;
#pragma unroll
    for (int idx = t; idx < kRowBM * PIECES; idx += 128) {
      const int r = idx / PIECES, c = idx % PIECES;
      const long long row = r0 + r;
      const bool ok = row < a.rows;
      cp_async16_or_zero(st + r * Cfg::PITCH + c * 16,
                         a.x + (ok ? (row >> 2) * a.cf + a.ch0 + (row & 3) * K + c * 4 : 0), ok);
    }
  };
  for (int i = 0; i < NS; ++i) {
    if (i < tiles.n) load(i);
    cp_async_commit();
  }

  const unsigned wbase = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned cbase = static_cast<unsigned>(__cvta_generic_to_shared(codes));
  const int rl = warp * 16 + (lane >> 2);  // this thread's rows in the tile: rl, rl + 8
#ifdef HDRTV_SM90_PHASES
  // Cycles per phase of a tile (the wait for its rows and the refill, the
  // float steps' products, the int8 steps' meeting, products and rescale,
  // the hand-off of each step's values: activation, then splitting or
  // quantizing, and c's stores; the last step's epilogue and stores; the
  // first step's A from the stage), summed by each warpgroup's first thread.
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
    uint32_t ab[8][4], as[8][4];
    unsigned near = 0;  // Q: the pairs (bit 2j + h) whose codes put_codes writes again
    auto staged = [&](int j, int h) {
      return *reinterpret_cast<const float2*>(st + (rl + 8 * h) * Cfg::PITCH + (8 * j + 2 * q) * 4);
    };
#pragma unroll
    for (int j = 0; j < K / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = staged(j, h);
        if (Q && a.qw[0])  // the first step is int8
          near |= static_cast<unsigned>(put_codes_fast(codes, rl + 8 * h, 8 * j + 2 * q, v.x, v.y, a, 0)) << (2 * j + h);
        else
          split_pair(v.x, v.y, ab, as, j, h);
      }
    if (Q && near)
#pragma unroll
      for (int j = 0; j < K / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (near >> (2 * j + h) & 1u) {
            const float2 v = staged(j, h);
            put_codes(codes, rl + 8 * h, 8 * j + 2 * q, v.x, v.y, a, 0);
          }
    PHASE(6)
    // everyone has read the stage: it takes tile i + NS
    warpgroup_sync(wg);
    if (i + NS < tiles.n) load(i + NS);
    cp_async_commit();
    PHASE(1)

    const long long r0 = tiles.row0(i);
    float d[K / 2];
    // one copy of the step's code for the four hidden steps: unrolled four
    // times, the kernel took 2.61 ms with int8 steps and 0.98 all float,
    // against 1.62 and 0.83 (the same code, four times the instructions to
    // fetch; PERF.md §6)
#pragma unroll 1
    for (int s = 0; s < HID; ++s) {
      const bool sq = Q && a.qw[s];
      if (sq) {
        chain_step_s8<K, K>(d, cbase, wbase + s * Cfg::SLOT, ysc + s * K, bias + s * K, wg, q);
        PHASE(3)
      } else {
        chain_step_tf32x3<K>(d, ab, as, wbase + s * Cfg::SLOT);
        fence_frags(ab);
        fence_frags(as);
        PHASE(2)
      }
      const bool next_q = Q && a.qw[s + 1];
      // the step's output at columns 8j + 2q, + 1 of row rl + 8h (an int8 step's d holds its bias already)
      auto out = [&](int j, int h) {
        const float2 bb = sq ? make_float2(0.f, 0.f) : *reinterpret_cast<const float2*>(bias + s * K + 8 * j + 2 * q);
        return make_float2(apply_act(d[4 * j + 2 * h] + bb.x, ACT_LRELU),
                           apply_act(d[4 * j + 2 * h + 1] + bb.y, ACT_LRELU));
      };
      near = 0;
#pragma unroll
      for (int j = 0; j < K / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v = out(j, h);
          if (next_q)
            near |= static_cast<unsigned>(put_codes_fast(codes, rl + 8 * h, 8 * j + 2 * q, v.x, v.y, a, s + 1))
                    << (2 * j + h);
          else
            split_pair(v.x, v.y, ab, as, j, h);
          const long long row = r0 + rl + 8 * h;
          if (s == 1 && row < a.rows) *reinterpret_cast<float2*>(a.mid + row * K + 8 * j + 2 * q) = v;
        }
      if (next_q && near)
#pragma unroll
        for (int j = 0; j < K / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (near >> (2 * j + h) & 1u) {
              const float2 v = out(j, h);
              put_codes(codes, rl + 8 * h, 8 * j + 2 * q, v.x, v.y, a, s + 1);
            }
      PHASE(4)
    }
    float e[NL / 2];
    const bool lq = Q && a.qw[HID];
    if (lq) {
      chain_step_s8<NL, K>(e, cbase, wbase + HID * Cfg::SLOT, ysc + HID * K, bias + HID * K, wg, q);
      PHASE(3)
    } else {
      chain_step_tf32x3<NL>(e, ab, as, wbase + HID * Cfg::SLOT);
      fence_frags(ab);
      fence_frags(as);
      PHASE(2)
    }
#pragma unroll
    for (int j = 0; j < NL / 8; ++j) {
      const float2 bb = lq ? make_float2(0.f, 0.f) : *reinterpret_cast<const float2*>(bias + HID * K + 8 * j + 2 * q);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = r0 + rl + 8 * h;
        if (row < a.rows)
          *reinterpret_cast<float2*>(a.y + row * NL + 8 * j + 2 * q) =
              make_float2(e[4 * j + 2 * h] + bb.x, e[4 * j + 2 * h + 1] + bb.y);
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

// cond_chain's fp32 s2d form (arguments as cond_chain_sm90_args takes them),
// its Q instance when a step is int8.
inline cudaError_t cond_chain_tf32x3(const void* c0, void* c, void* cond1, const void* const* w,
                                     const void* const* b, const int* k, const int* n, int npix, cudaStream_t stream,
                                     const QuantParams* const* q) {
  ChainF32Args a;
  bool quant = false;
  const cudaError_t err = cond_chain_sm90_args(a, c0, c, cond1, w, b, k, n, npix, q, &quant);
  if (err != cudaSuccess) return err;
  static DeviceCache cache, qcache;
  if (quant)
    return launch_chain_sm90(cond_chain_sm90_tf32x3_kernel<true>, ChainTf32Cfg<true>::SMEM, qcache, a, stream,
                             ChainTf32Cfg<true>::WGS);
  return launch_chain_sm90(cond_chain_sm90_tf32x3_kernel<false>, ChainTf32Cfg<false>::SMEM, cache, a, stream,
                           ChainTf32Cfg<false>::WGS);
}

}  // namespace
}  // namespace hdrtv
