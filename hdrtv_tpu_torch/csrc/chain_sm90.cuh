// 1×1 chains over the rows of an s2d tensor, written for Hopper (sm_90a):
// bf16 × bf16 → fp32 on wgmma with A in registers, the block-diagonal s2d
// weights reduced to their one diagonal block and kept in shared memory.
// It runs the bf16 forms of cond_chain (cond_chain_sm90_kernel, launched
// from cond_chain.cu; its int8 steps, cond_chain_w8a8, in the Q instance:
// s8 wgmma on codes made in registers), of
// mix_chain, the CondNet2 tail (mix_chain_sm90, on a channel window read in
// place), and the SFT passes (sft_sm90) of the tail, sft_conv3 and resblock,
// and in its int8-output mode those of tail_w8a8, sft_conv3_w8a8 and
// resblock_w8a8, when the caller declares the weights s2d
// (ops/megakernel.py, s2d=True); agcm_head's AGCM pass (agcm_sm90) and
// trunk3's SFT passes (sft_sm90_natural) too. cond_chain's fp32 s2d form,
// float and int8 steps, runs the tile's fp32 instance (chain_tf32x3.cuh:
// the same rows and ring, 3×TF32 products), and the SFT passes of the fp32
// s2d forms of sft_conv3 and resblock its fp32 SFT instance
// (sft_tf32x3.cuh). The dense forms stay on chain.cuh and pointwise.cuh.
//
// Why rows. A 1×1 weight of the s2d program is w_s2d_1x1(w) (models/s2d.py):
// (4·K, 4·N), block-diagonal with four equal K × N blocks, one per
// sub-position, and its bias b_s2d(b) is b four times. The s2d channels of a
// pixel are sub-position-major (channel (2a + b)·K + k), so an (npix, 4·K)
// tensor is, byte for byte, the (4·npix, K) matrix of natural pixels, and the
// 1×1 conv is that matrix times the one K × N block: a quarter of the dense
// product's operations, and a weight a sixteenth of the dense one's bytes,
// small enough to stay in shared memory for the whole launch. The block is
// read at the top left of the s2d weight (row pitch 4·N); a weight without
// the declared structure gives another result, which the plain versions
// reproduce (they multiply that block too).
//
// The block: two warpgroups (256 threads), two blocks per SM, persistent.
// The weights (and biases) go to shared memory once per block, in wgmma's
// MN-major layout without swizzle (conv3x3_sm90.cuh's B: 16-byte rows of 8
// columns of one k, (k/8)·N + col + k%8, read transposed). Each warpgroup
// walks its own tiles of 64 rows (one m64 wgmma tile): tile
// 2·block + warpgroup, + 2·gridDim, ... It keeps a ring of NS stages of its
// own in shared memory, filled by 16-byte cp.async of whole rows (a tile of
// input rows is contiguous bytes, or for mix_chain's window contiguous by
// pixel, four rows at a time; rows past the end are zero-filled), with
// NS − 1 tiles in flight while it computes one; its 128 threads meet on a
// named barrier of their own, so the two warpgroups never wait for each
// other.
//
// A tile: each warp loads its 16 rows' A fragments with ldmatrix (the staged
// rows have a 16-byte pad: conflict-free), then the steps run in registers:
// wgmma.m64nNk16 with A from registers, one per 16 of K, fp32 accumulators;
// the epilogue adds the fp32 bias, applies the activation, and rounds once to
// bf16, packing the pairs straight into the next step's A fragments (the
// accumulator layout of m64nN, row lane/4 (+ 8) and columns 8j + 2·(lane%4),
// is the register-A layout of m64nNk16 over k = 16·(j/2) ..: the pair of
// columns 8j + 2q is A register 2·(j%2) + h of chunk j/2). No intermediate
// leaves the registers. Rounding points as in the Pallas kernels: each
// product's input rounded to bf16 (the stored middle output is that rounded
// value), sums, biases and activations fp32.
//
// Stores. An output is written as bf16 pairs into the tile's stage (whose
// input this warp's rows no longer need; the output rows of a warp are its
// input rows, so no other warp is still reading them), then, after the
// warpgroup meets, copied out in 16-byte pieces: consecutive threads write
// consecutive 16 bytes of consecutive rows, rows past the end skipped. The
// next tiles' loads run meanwhile.
//
// Bound on this card: bytes. cond_chain at 1080p reads c0 (265 MB) and
// writes c (265 MB) and cond1 (66 MB): 0.178 ms at 3.35 TB/s, against
// 72 GFLOP of block products, 0.073 ms at the bf16 rate; mix_chain reads
// its window (66 MB) and writes 17 MB: 0.025 ms. The tail's SFT pass
// reads s, up and cond1 and writes t: 465 MB, 0.139 ms, 13 GFLOP; resblock's
// SFT2 at L1 reads h1 (fp32) and cond and writes t: 116 MB, 0.035 ms.
#pragma once

#include "conv3x3_sm90.cuh"

namespace hdrtv {
namespace {

constexpr int kRowThreads = kSm90Threads;  // two warpgroups
constexpr int kRowBM = 64;        // rows of a tile: one m64 wgmma tile

// wgmma.m64nNk16, bf16 × bf16 + fp32, A from registers (the four registers
// of m16n8k16's A fragment, for this warp's 16 rows), B MN-major from shared
// memory (imm-trans-b = 1); accumulate 0 starts the sum from zero.
template <int N>
struct WgmmaRA;

template <>
struct WgmmaRA<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const unsigned (&a)[4], uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

template <>
struct WgmmaRA<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const unsigned (&a)[4], uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

template <>
struct WgmmaRA<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const unsigned (&a)[4], uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

template <>
struct WgmmaRA<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], const unsigned (&a)[4], uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

// Keeps A fragments live (their registers unchanged) until the wgmmas that
// read them have been waited for.
template <int C>
__device__ __forceinline__ void fence_frags(unsigned (&a)[C][4]) {
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[c][i])::"memory");
}

// The descriptor of k chunk kk (16 rows of K) of a K × N operand staged by stage_b at `addr`.
__device__ __forceinline__ uint64_t desc_rows_b(unsigned addr, int N, int kk) {
  return desc_b(addr + kk * N * 32, N * 16, 128);
}

// 16 bytes from global memory into shared memory, or 16 zero bytes where !ok
// (the source is then not read).
__device__ __forceinline__ void cp_async16_or_zero(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(ok ? 16 : 0) : "memory");
}

// The 128 threads of warpgroup wg meet (named barrier wg + 1; 0 is __syncthreads').
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// Rows k < K, columns [0, n) of src (row pitch ld elements) into columns
// [n0, n0 + n) of a K × N operand in wgmma's MN-major layout without
// swizzle: 16-byte row (k/8)·N + col + k%8 holds columns col .. col + 7 of
// row k. Every thread of the block takes part.
__device__ __forceinline__ void stage_b(unsigned char* dst, int N, int n0, const bf16* src, int ld, int K, int n) {
  const int groups = n / 8;
  for (int idx = threadIdx.x; idx < K * groups; idx += blockDim.x) {
    const int k = idx / groups, g = idx - k * groups;
    const uint4 v = *reinterpret_cast<const uint4*>(src + static_cast<long long>(k) * ld + g * 8);
    *reinterpret_cast<uint4*>(dst + ((k >> 3) * N + n0 + g * 8 + (k & 7)) * 16) = v;
  }
}

// Copy `bytes_per_row` of each of a tile's 64 staged rows (pitch `pitch`)
// to rows r0 .. of dst (row pitch bytes_per_row), rows ≥ rows skipped; the
// 128 threads of a warpgroup (index t) take consecutive 16-byte pieces.
__device__ __forceinline__ void store_rows(void* dst, const unsigned char* st, int pitch, int bytes_per_row,
                                           long long r0, long long rows, int t) {
  const int pieces = bytes_per_row / 16;
  for (int idx = t; idx < kRowBM * pieces; idx += 128) {
    const int r = idx / pieces, c = idx - r * pieces;
    if (r0 + r < rows)
      *reinterpret_cast<uint4*>(static_cast<unsigned char*>(dst) + (r0 + r) * bytes_per_row + c * 16) =
          *reinterpret_cast<const uint4*>(st + r * pitch + c * 16);
  }
}

// The tiles of warpgroup wg of this block (of `groups`): first, first +
// stride, ... (n of them).
struct RowTiles {
  long long first, stride;
  int n;
  __device__ RowTiles(long long rows, int wg, int groups = 2) {
    const long long tiles = (rows + kRowBM - 1) / kRowBM;
    first = static_cast<long long>(blockIdx.x) * groups + wg;
    stride = static_cast<long long>(gridDim.x) * groups;
    n = first < tiles ? static_cast<int>((tiles - 1 - first) / stride + 1) : 0;
  }
  __device__ long long row0(int i) const { return (first + i * stride) * kRowBM; }
};

// ---------------------------------------------------------------------------
// Chains of K-wide rows: HID steps K → K (lrelu each), then K → NL (no
// activation), written as y; with MID the value after step 1 is written as
// mid too. cond_chain (HID = 4, MID: c) reads c0, (rows, K) contiguous.
// mix_chain (HID = 1), the CondNet2 tail, reads the window [ch0, ch0 + 4·K)
// of a wider s2d tensor in place: row r, sub-position r % 4 of pixel r / 4,
// is K channels at (r / 4)·cf + ch0 + (r % 4)·K (cond_chain: cf = 4·K,
// ch0 = 0). At 1080p K = 64, NL = 16; rows = 4·540·960 (cond_chain) or
// 4·270·480 (mix_chain, whose pixels lie cf = 768 channels apart).
// ---------------------------------------------------------------------------

// T: the element type of x, mid, y and the weights (bf16; float for the
// fp32 instance of chain_tf32x3.cuh).
template <typename T>
struct ChainRowsArgs {
  const T* x;   // row r at (r / 4)·cf + ch0 + (r % 4)·K
  T* mid;       // (rows, K): c, after step 1 (MID)
  T* y;         // (rows, NL): cond1, or mix_chain's output
  const T* w[5];  // the s2d weights; the K × N block at the top left, row pitch ld
  const float* b[5];
  int ld[5];
  long long rows;
  long long cf;    // channels from one pixel of x to the next
  int ch0;         // the window's first channel
  // cond_chain's int8 steps (the Q instance): step s is int8 where qw[s] is
  // set, its QArgs codes (4·N, 4·K), whose N × K block at the top left is
  // read at row pitch qld = 4·K, with the first N of its yscale ys and
  // folded bias qb, and its input's quantization qs, qz, qa (qinv: 1/qs
  // rounded to nearest, the host's division).
  const int8_t* qw[5] = {};
  const float* ys[5] = {};
  const float* qb[5] = {};
  float qs[5] = {}, qinv[5] = {}, qz[5] = {};
  int qa[5] = {};
  int qld[5] = {};
#ifdef HDRTV_SM90_PHASES
  unsigned long long* phases = nullptr;  // tools/sm90_phases.py: 8 clock64() sums per warpgroup
#endif
};
using ChainSm90Args = ChainRowsArgs<bf16>;

// The launch's shared memory. Q (cond_chain's int8 steps): laid out from a
// 1024-byte boundary (the int8 operands' swizzles), a step's weight slot
// holding its bf16 block or its int8 one, the int8 steps' yscales beside the
// biases, each warpgroup's code tile (64 rows of K codes), and two ring
// stages a warpgroup so that two blocks still fit an SM.
template <int K, int NL, int HID, bool Q = false>
struct ChainSm90Cfg {
  static constexpr int NS = Q ? 2 : 3;                    // ring stages per warpgroup
  static constexpr int W_BYTES = (HID * K * K + K * NL) * 2;
  static constexpr int BIAS_BYTES = (HID * K + NL) * 4;
  static constexpr int PITCH = (K + 8) * 2;               // a staged row of x or mid: 16 bytes of pad
  static constexpr int YPITCH = (NL + 8) * 2;             // a staged row of y
  static constexpr int STAGE = kRowBM * (PITCH + YPITCH);
  static constexpr int CODE = kRowBM * K;                 // Q: a warpgroup's code tile
  static constexpr int CODE_OFF = Q ? (W_BYTES + 2 * BIAS_BYTES + 1023) / 1024 * 1024 : 0;
  static constexpr int RING_OFF = Q ? CODE_OFF + 2 * CODE : W_BYTES + BIAS_BYTES;
  static constexpr int SMEM = RING_OFF + 2 * NS * STAGE + (Q ? 1024 : 0);
  static_assert(K % 16 == 0 && NL % 16 == 0 && K <= 64 && NL <= 64, "widths of the register tile");
  static_assert(W_BYTES % 16 == 0 && BIAS_BYTES % 16 == 0 && STAGE % 16 == 0, "16-byte alignment");
  static_assert(!Q || K == 64, "int8 steps: code rows of 64 bytes, one 64-byte swizzle span");
  static_assert(2 * (SMEM + 1024) <= 228 * 1024, "two blocks per SM");
};

// Rows n < N of an int8 weight block (K codes each, row pitch ld bytes) into
// K/32 chunks of wgmma's K-major operand: chunk kk, row n's 16-byte half hk
// at kk·N·32 + n·32 + (hk ^ bit 2 of n)·16 (the 32-byte swizzle, as the s8
// conv tile keeps its weights). Every thread of the block takes part.
__device__ __forceinline__ void stage_b_s8(unsigned char* dst, int N, const int8_t* src, int ld, int K) {
  const int pieces = K / 16;
  for (int idx = threadIdx.x; idx < N * pieces; idx += blockDim.x) {
    const int n = idx / pieces, pc = idx - n * pieces, kk = pc >> 1, hk = pc & 1;
    *reinterpret_cast<uint4*>(dst + kk * N * 32 + n * 32 + ((hk ^ (n >> 2)) & 1) * 16) =
        *reinterpret_cast<const uint4*>(src + static_cast<long long>(n) * ld + pc * 16);
  }
}

// Where the codes of row r, columns c and c + 1 lie in a code tile of
// 64-byte rows in the 64-byte swizzle the wgmma reads (16-byte piece p of row
// r at p ^ (r/2 % 4)).
__device__ __forceinline__ unsigned short* code_pair(unsigned char* codes, int r, int c) {
  return reinterpret_cast<unsigned short*>(codes + r * 64 + (((c >> 4) ^ ((r >> 1) & 3)) << 4) + (c & 15));
}

// The codes of the pair (v0, v1), an int8 step's fp32 input at row r,
// columns c and c + 1, at code_pair: step s's quantize_code, bit for bit, by
// quantize_code_rcp (its IEEE division only near a half-integer). Where the
// row tile's int8 form spends its time
// (tools/sm90_phases.py --only chain): two variants measured slower on an
// H100, rounding by adding 1.5·2^23 in place of rintf and the conversion
// (+5%), and the division moved after a warp vote (+30%).
template <typename T>
__device__ __forceinline__ void put_codes(unsigned char* codes, int r, int c, float v0, float v1,
                                          const ChainRowsArgs<T>& a, int s) {
  const unsigned pair = (quantize_code_rcp(v0, a.qs[s], a.qinv[s], a.qz[s], a.qa[s]) & 0xff) |
                        (quantize_code_rcp(v1, a.qs[s], a.qinv[s], a.qz[s], a.qa[s]) & 0xff) << 8;
  *code_pair(codes, r, c) = static_cast<unsigned short>(pair);
}

// An int8 step of N outputs over the warpgroup's code tile (at shared
// address `code`; every thread has written its codes) and the step's
// staged int8 block (at `wb`): the exact int32 sums on wgmma m64nNk32, then
// float(acc)·yscale and + the folded bias rounded apart, into d in the
// accumulator layout of a float step.
template <int N, int K>
__device__ __forceinline__ void chain_step_s8(float (&d)[N / 2], unsigned code, unsigned wb, const float* ys,
                                              const float* qb, int wg, int q) {
  // the codes, written by the generic proxy, are read by wgmma's async proxy: everyone's
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(wg);
  int acc[N / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 32; ++kk)
    WgmmaS8<N>::mma(acc, desc_kmajor(code + kk * 32, 1), desc_kmajor(wb + kk * N * 32, 0), kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_iregs(acc);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 y2 = *reinterpret_cast<const float2*>(ys + 8 * j + 2 * q);
    const float2 b2 = *reinterpret_cast<const float2*>(qb + 8 * j + 2 * q);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      d[4 * j + 2 * h] = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), y2.x), b2.x);
      d[4 * j + 2 * h + 1] = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), y2.y), b2.y);
    }
  }
}

// Q: any step may be int8 (ChainSm90Args qw). A float step is as above; an
// int8 step's input, the fp32 value of the step before (or c0's staged rows
// for the first), is quantized by each thread in registers into the
// warpgroup's code tile in place of the next A fragments, then chain_step_s8
// multiplies it by the step's int8 block and rescales; its output is handed
// on as a float step's. The rows the middle output is staged in and the
// store are the float form's.
template <int K, int NL, int HID, bool MID, bool Q = false>
__device__ __forceinline__ void chain_rows_sm90(const ChainSm90Args& a) {
  using Cfg = ChainSm90Cfg<K, NL, HID, Q>;
  constexpr int NS = Cfg::NS, KC = K / 16;
  extern __shared__ __align__(16) unsigned char row_smem[];
  unsigned char* const smem =
      Q ? row_smem + ((1024u - (static_cast<unsigned>(__cvta_generic_to_shared(row_smem)) & 1023u)) & 1023u)
        : row_smem;
  float* const bias = reinterpret_cast<float*>(smem + Cfg::W_BYTES);
  float* const ysc = bias + HID * K + NL;  // Q: the int8 steps' yscales
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = tid & 31, q = lane & 3;
  unsigned char* const ring = smem + Cfg::RING_OFF + wg * NS * Cfg::STAGE;
  unsigned char* const codes = smem + Cfg::CODE_OFF + wg * Cfg::CODE;  // Q: this warpgroup's code tile

  for (int s = 0; s <= HID; ++s) {
    const int n = s < HID ? K : NL;
    if (Q && a.qw[s]) {
      stage_b_s8(smem + s * K * K * 2, n, a.qw[s], a.qld[s], K);
      for (int i = tid; i < n; i += kRowThreads) {
        bias[s * K + i] = a.qb[s][i];
        ysc[s * K + i] = a.ys[s][i];
      }
    } else {
      stage_b(smem + s * K * K * 2, n, 0, a.w[s], a.ld[s], K, n);
      for (int i = tid; i < n; i += kRowThreads) bias[s * K + i] = a.b[s][i];
    }
  }
  // the weights, written by the generic proxy, are read by wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const RowTiles tiles(a.rows, wg);
  auto load = [&](int i) {
    const long long r0 = tiles.row0(i);
    unsigned char* const st = ring + (i % NS) * Cfg::STAGE;
    constexpr int PIECES = K / 8;
#pragma unroll
    for (int idx = t; idx < kRowBM * PIECES; idx += 128) {
      const int r = idx / PIECES, c = idx % PIECES;
      const long long row = r0 + r;
      const bool ok = row < a.rows;
      cp_async16_or_zero(st + r * Cfg::PITCH + c * 16,
                         a.x + (ok ? (row >> 2) * a.cf + a.ch0 + (row & 3) * K + c * 8 : 0), ok);
    }
  };
  for (int i = 0; i < NS - 1; ++i) {
    if (i < tiles.n) load(i);
    cp_async_commit();
  }

  const unsigned wbase = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned cbase = static_cast<unsigned>(__cvta_generic_to_shared(codes));
  const int rl = warp * 16 + (lane >> 2);  // this thread's rows in the tile: rl, rl + 8
#ifdef HDRTV_SM90_PHASES
  // Cycles per phase of a tile (the wait for its rows, the float steps'
  // products, the int8 steps' meeting, products and rescale, the hand-off of
  // each step's values: activation and rounding or quantizing, the last
  // step's epilogue and the stores), summed by each warpgroup's first thread.
  unsigned long long t_start = clock64(), t_phase[8] = {0, 0, 0, 0, 0, 0, 0, 0}, t_mark = 0;
#define PHASE(i) (t_phase[i] += clock64() - t_mark, t_mark = clock64());
#else
#define PHASE(i)
#endif
  for (int i = 0; i < tiles.n; ++i) {
#ifdef HDRTV_SM90_PHASES
    t_mark = clock64();
#endif
    // tile i's rows arrived (this thread's copies, then everyone's); everyone
    // is done with tile i − 1's stage, which tile i + NS − 1 refills
    cp_async_wait<NS - 2>();
    warpgroup_sync(wg);
    if (i + NS - 1 < tiles.n) load(i + NS - 1);
    cp_async_commit();
    PHASE(1)

    unsigned char* const st = ring + (i % NS) * Cfg::STAGE;
    unsigned char* const yst = st + kRowBM * Cfg::PITCH;
    unsigned af[KC][4];
    if (Q && a.qw[0]) {
      // the first step is int8: the codes of this thread's staged c0 values
#pragma unroll
      for (int j = 0; j < K / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rl + 8 * h;
          const float2 v = load2<bf16>(reinterpret_cast<const bf16*>(st + r * Cfg::PITCH) + 8 * j + 2 * q);
          put_codes(codes, r, 8 * j + 2 * q, v.x, v.y, a, 0);
        }
    } else {
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
        ldmatrix_x4(af[kk], st + (warp * 16 + (lane & 15)) * Cfg::PITCH + kk * 32 + (lane >> 4) * 16);
    }
    PHASE(4)

    float d[K / 2];
#pragma unroll
    for (int s = 0; s < HID; ++s) {
      const float* const bs = bias + s * K;
      const bool sq = Q && a.qw[s];
      if (sq) {
        chain_step_s8<K, K>(d, cbase, wbase + s * K * K * 2, ysc + s * K, bs, wg, q);
        PHASE(3)
      } else {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KC; ++kk)
          WgmmaRA<K>::mma(d, af[kk], desc_rows_b(wbase + s * K * K * 2, K, kk), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(d);
        fence_frags(af);
        PHASE(2)
      }
      const bool next_q = Q && a.qw[s + 1];
#pragma unroll
      for (int j = 0; j < K / 8; ++j) {
        // an int8 step's d holds its bias already
        const float2 bb = sq ? make_float2(0.f, 0.f) : *reinterpret_cast<const float2*>(bs + 8 * j + 2 * q);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = apply_act(d[4 * j + 2 * h] + bb.x, ACT_LRELU);
          const float v1 = apply_act(d[4 * j + 2 * h + 1] + bb.y, ACT_LRELU);
          const unsigned u = pack_bf16(v0, v1);
          if (next_q)
            put_codes(codes, rl + 8 * h, 8 * j + 2 * q, v0, v1, a, s + 1);
          else
            af[j / 2][2 * (j % 2) + h] = u;
          if (MID && s == 1) *reinterpret_cast<unsigned*>(st + (rl + 8 * h) * Cfg::PITCH + (8 * j + 2 * q) * 2) = u;
        }
      }
      PHASE(4)
    }
    float e[NL / 2];
    const bool lq = Q && a.qw[HID];
    if (lq) {
      chain_step_s8<NL, K>(e, cbase, wbase + HID * K * K * 2, ysc + HID * K, bias + HID * K, wg, q);
      PHASE(3)
    } else {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) WgmmaRA<NL>::mma(e, af[kk], desc_rows_b(wbase + HID * K * K * 2, NL, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(e);
      fence_frags(af);
      PHASE(2)
    }
#pragma unroll
    for (int j = 0; j < NL / 8; ++j) {
      const float2 bb = lq ? make_float2(0.f, 0.f) : *reinterpret_cast<const float2*>(bias + HID * K + 8 * j + 2 * q);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<unsigned*>(yst + (rl + 8 * h) * Cfg::YPITCH + (8 * j + 2 * q) * 2) =
            pack_bf16(e[4 * j + 2 * h] + bb.x, e[4 * j + 2 * h + 1] + bb.y);
    }
    warpgroup_sync(wg);
    const long long r0 = tiles.row0(i);
    if (MID) store_rows(a.mid, st, Cfg::PITCH, K * 2, r0, a.rows, t);
    store_rows(a.y, yst, Cfg::YPITCH, NL * 2, r0, a.rows, t);
    PHASE(5)
  }
  cp_async_wait<0>();
#ifdef HDRTV_SM90_PHASES
  t_phase[0] = clock64() - t_start;
  t_phase[7] = tiles.n;
  if (a.phases && t == 0)
    for (int k = 0; k < 8; ++k) a.phases[(blockIdx.x * 2 + wg) * 8 + k] = t_phase[k];
#endif
#undef PHASE
}

template <int K, int NL, bool Q>
__global__ void __launch_bounds__(kRowThreads, 2) cond_chain_sm90_kernel(const __grid_constant__ ChainSm90Args a) {
  chain_rows_sm90<K, NL, 4, true, Q>(a);
}

template <int K, int NL>
__global__ void __launch_bounds__(kRowThreads, 2) mix_chain_sm90_kernel(const __grid_constant__ ChainSm90Args a) {
  chain_rows_sm90<K, NL, 1, false>(a);
}

// Persistent blocks: as many as the card holds (`resident`, from
// conv3x3_sm90.cuh's resident_blocks), capped at one per `groups` tiles
// (its warpgroups: two but in the fp32 chain).
inline unsigned row_blocks(long long rows, int resident, int groups = 2) {
  const long long tiles = (rows + kRowBM - 1) / kRowBM;
  return static_cast<unsigned>(std::max(1LL, std::min(static_cast<long long>(resident), (tiles + groups - 1) / groups)));
}

// One launch of a chain kernel of `groups` warpgroups with SMEM bytes (its
// resident blocks counted once per device, in the caller's cache).
template <typename Kernel, typename T>
cudaError_t launch_chain_sm90(Kernel kernel, int smem, DeviceCache& cache, const ChainRowsArgs<T>& a,
                              cudaStream_t stream, int groups = 2) {
  int resident = 0;
  const cudaError_t err = resident_blocks(cache, kernel, smem, &resident, 128 * groups);
  if (err != cudaSuccess) return err;
  kernel<<<row_blocks(a.rows, resident, groups), 128 * groups, smem, stream>>>(a);
  return cudaGetLastError();
}

// The arguments of cond_chain's s2d form, bf16 or (T = float) fp32, over
// s2d weights (as cond_chain.cu takes them: s2d widths k, n per step, npix
// s2d pixels; q null, or five pointers to the steps' QuantParams, null for
// a float step), the launch in cond_chain.cu (tools/sm90_s8_phases.cu builds
// its own). The chain the frame programs run, natural widths 64 → 64 ×4 →
// 16, is the one it takes; anything else is refused. *quant: whether a step
// is int8 (then the Q instance runs, each int8 block read at the top left of
// the QArgs codes, row pitch k[s]).
template <typename T>
inline cudaError_t cond_chain_sm90_args(ChainRowsArgs<T>& a, const void* c0, void* c, void* cond1,
                                        const void* const* w, const void* const* b, const int* k, const int* n,
                                        int npix, const QuantParams* const* q, bool* quant) {
  constexpr int K = 64, NL = 16;
  for (int s = 0; s < 5; ++s)
    if (k[s] != 4 * K || n[s] != 4 * (s < 4 ? K : NL)) return cudaErrorInvalidValue;
  a.x = static_cast<const T*>(c0);
  a.mid = static_cast<T*>(c);
  a.y = static_cast<T*>(cond1);
  *quant = false;
  for (int s = 0; s < 5; ++s) {
    a.w[s] = static_cast<const T*>(w[s]);
    a.b[s] = static_cast<const float*>(b[s]);
    a.ld[s] = n[s];
    const QuantParams* qp = q ? q[s] : nullptr;
    if (qp) {
      *quant = true;
      a.qw[s] = qp->w;
      a.ys[s] = qp->yscale;
      a.qb[s] = qp->bias;
      a.qs[s] = qp->s;
      a.qinv[s] = 1.f / qp->s;
      a.qz[s] = qp->z;
      a.qa[s] = qp->asym;
      a.qld[s] = k[s];
    }
  }
  a.rows = 4LL * npix;
  a.cf = 4 * K;
  a.ch0 = 0;
  return cudaSuccess;
}

// mix_chain's bf16 form over s2d weights (arguments as mix_chain.cu takes
// them: s2d widths k, n and activations per step; npix s2d pixels of x, cf
// channels apart, the window from ch0). The chain the frame programs run,
// the CondNet2 tail, natural widths 64 → 64 (lrelu) → 16, is the one it
// takes; anything else is refused.
inline cudaError_t mix_chain_sm90(const void* x, void* y, const void* const* w, const void* const* b, const int* k,
                                  const int* n, const int* act, int steps, int npix, int cf, int ch0,
                                  cudaStream_t stream) {
  constexpr int K = 64, NL = 16;
  if (steps != 2 || k[0] != 4 * K || n[0] != 4 * K || k[1] != 4 * K || n[1] != 4 * NL || act[0] != ACT_LRELU ||
      act[1] != ACT_NONE || cf % 8 || ch0 % 8 || ch0 < 0 || ch0 + 4 * K > cf)
    return cudaErrorInvalidValue;
  ChainSm90Args a;
  a.x = static_cast<const bf16*>(x);
  a.mid = nullptr;
  a.y = static_cast<bf16*>(y);
  for (int s = 0; s < 2; ++s) {
    a.w[s] = static_cast<const bf16*>(w[s]);
    a.b[s] = static_cast<const float*>(b[s]);
    a.ld[s] = n[s];
  }
  a.rows = 4LL * npix;
  a.cf = cf;
  a.ch0 = ch0;
  static DeviceCache cache;
  return launch_chain_sm90(mix_chain_sm90_kernel<K, NL>, ChainSm90Cfg<K, NL, 1>::SMEM, cache, a, stream);
}

// ---------------------------------------------------------------------------
// The SFT pass of the s2d forms of the tail, sft_conv3 and resblock: per row,
// with cond (CC) and x (C),
//   hidden = lrelu([cond·W0s + b0s | cond·W0h + b0h])   (2·CC, rounded to bf16)
//   t      = x · (hidden_s·W1s + b1s + 1) + hidden_h·W1h + b1h
// t rounded once and written. x is bf16 (s, or resblock's input), or fp32
// (XT = float: resblock's h1, which enters the epilogue only). A bf16 x may
// have a second input `add` (the fine x_add, rows contiguous, or the coarse
// up tensor, un-folded on read): x becomes the sum rounded to bf16, which
// is also written to xsum when that is set (resblock's residual). At 1080p
// CC = 16, C = 32, rows = 4·540·960 (tail, L0 sft_conv3), 4·270·480
// (resblock) or 4·135·240 (L2 sft_conv3). The scale and shift branches'
// first products run as one m64n32k16 over the two weights side by side;
// the hidden's two halves are the A fragments of the two second products.
// ---------------------------------------------------------------------------

struct SftSm90Args {
  const bf16* cond;  // (rows, CC)
  const void* x;     // (rows, C) of XT
  const bf16* add;   // nullptr, the fine (rows, C) x_add, or (coarse) the (H/2, W/2, 16·C) tensor whose block d2s has x's shape
  bf16* xsum;        // nullptr, or (rows, C): x + add, rounded
  bf16* t;           // (rows, C)
  const bf16* w[4];  // scale0, scale1, shift0, shift1 (s2d weights; the block at the top left, row pitch ld)
  const float* b[4];
  int ld[4];
  long long rows;
  int W;       // s2d pixels per image row (the un-fold of a coarse add)
  int coarse;  // add is the coarse tensor
  int8_t* q = nullptr;  // the int8-output mode: (rows, C) codes of t, written in place of t
  float qs = 1.f, qz = 0.f;
  int qasym = 0;
#ifdef HDRTV_SM90_PHASES
  unsigned long long* phases = nullptr;  // tools/sm90_phases.py: 8 clock64() sums per warpgroup
#endif
};

// A stage holds a tile's rows of cond, x and a bf16 side area: the second
// input, overwritten by the rounded sum (bf16 x), or t (fp32 x; bf16 x
// writes t over x). Two blocks a SM: four stages a warpgroup with bf16 x,
// three with fp32 x (its rows are twice the bytes).
//
// The int8-output mode (Q8; the s2d forms of tail_w8a8, sft_conv3_w8a8 and
// resblock_w8a8): t = x·(scale + 1) then + shift in fp32 with the _rn
// intrinsics, as pointwise.cuh's int8-output mode forms it, never rounded
// to bf16, quantized by quantize_code (IEEE division, round half to even)
// and written as 1-byte codes: the (rows, C) code rows are, byte for byte,
// the (npix, 4·C) s2d codes the int8 conv reads. x is bf16 (with a second
// input: resblock_w8a8's SFT1, whose rounded sum goes to xsum as in the
// float form: it lies in the side area, which the codes never touch) or
// fp32 (resblock_w8a8's SFT2 on h1, which enters t only). A warp's codes go
// over its own x rows in the stage once all its lanes have read them
// (__syncwarp: 32 bytes of a 80- or 160-byte row), then out in 16-byte
// pieces as t does.
template <int CC, int C, typename XT>
struct SftSm90Cfg {
  static constexpr bool F32X = std::is_same<XT, float>::value;
  static constexpr int NS = F32X ? 3 : 4;
  static constexpr int W0_BYTES = CC * 2 * CC * 2;  // [W0s | W0h], CC × 2·CC
  static constexpr int W1_BYTES = CC * C * 2;       // W1s, W1h: CC × C each
  static constexpr int W_BYTES = W0_BYTES + 2 * W1_BYTES;
  static constexpr int BIAS_BYTES = (2 * CC + 2 * C) * 4;
  static constexpr int CPITCH = (CC + 8) * 2;
  static constexpr int XPITCH = (C + 8) * static_cast<int>(sizeof(XT));  // pads: conflict-free pair reads
  static constexpr int APITCH = (C + 8) * 2;
  static constexpr int STAGE = kRowBM * (CPITCH + XPITCH + APITCH);
  static constexpr int SMEM = W_BYTES + BIAS_BYTES + 2 * NS * STAGE;
  static_assert(CC == 16 && C % 16 == 0 && C <= 64, "widths of the register tile");
  static_assert(W_BYTES % 16 == 0 && BIAS_BYTES % 16 == 0 && STAGE % 16 == 0, "16-byte alignment");
  static_assert(2 * (SMEM + 1024) <= 228 * 1024, "two blocks per SM");
};

template <int CC, int C, typename XT, bool Q8>
__global__ void __launch_bounds__(kRowThreads, 2) sft_sm90_kernel(const __grid_constant__ SftSm90Args a) {
  using Cfg = SftSm90Cfg<CC, C, XT>;
  constexpr int NS = Cfg::NS;
  constexpr bool F32X = Cfg::F32X;
  extern __shared__ __align__(16) unsigned char row_smem[];
  unsigned char* const smem = row_smem;
  float* const b0 = reinterpret_cast<float*>(smem + Cfg::W_BYTES);  // [b0s | b0h]
  float* const b1s = b0 + 2 * CC;
  float* const b1h = b1s + C;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = tid & 31, q = lane & 3;
  unsigned char* const ring = smem + Cfg::W_BYTES + Cfg::BIAS_BYTES + wg * NS * Cfg::STAGE;

  stage_b(smem, 2 * CC, 0, a.w[0], a.ld[0], CC, CC);
  stage_b(smem, 2 * CC, CC, a.w[2], a.ld[2], CC, CC);
  stage_b(smem + Cfg::W0_BYTES, C, 0, a.w[1], a.ld[1], CC, C);
  stage_b(smem + Cfg::W0_BYTES + Cfg::W1_BYTES, C, 0, a.w[3], a.ld[3], CC, C);
  for (int i = tid; i < CC; i += kRowThreads) {
    b0[i] = a.b[0][i];
    b0[CC + i] = a.b[2][i];
  }
  for (int i = tid; i < C; i += kRowThreads) {
    b1s[i] = a.b[1][i];
    b1h[i] = a.b[3][i];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const RowTiles tiles(a.rows, wg);
  const long long half_w = a.W >> 1;
  const unsigned char* const xg = static_cast<const unsigned char*>(a.x);
  auto load = [&](int i) {
    const long long r0 = tiles.row0(i);
    unsigned char* const st = ring + (i % NS) * Cfg::STAGE;
    unsigned char* const xs = st + kRowBM * Cfg::CPITCH;
    unsigned char* const as = xs + kRowBM * Cfg::XPITCH;
    constexpr int CP = CC / 8, XP = C * static_cast<int>(sizeof(XT)) / 16, AP = C / 8;
    for (int idx = t; idx < kRowBM * CP; idx += 128) {
      const int r = idx / CP, c = idx % CP;
      const bool ok = r0 + r < a.rows;
      cp_async16_or_zero(st + r * Cfg::CPITCH + c * 16, a.cond + (ok ? (r0 + r) * CC + c * 8 : 0), ok);
    }
    for (int idx = t; idx < kRowBM * XP; idx += 128) {
      const int r = idx / XP, c = idx % XP;
      const bool ok = r0 + r < a.rows;
      cp_async16_or_zero(xs + r * Cfg::XPITCH + c * 16, xg + (ok ? (r0 + r) * C * sizeof(XT) + c * 16 : 0), ok);
    }
    if (a.add)
      for (int idx = t; idx < kRowBM * AP; idx += 128) {
        const int r = idx / AP, c = idx % AP;
        const long long row = r0 + r;
        const bool ok = row < a.rows;
        long long src = 0;
        if (ok && a.coarse) {
          // fine pixel p = (i, j) of sub-position sub: coarse pixel (i/2, j/2),
          // channel block (2·(i%2) + j%2)·4C + sub·C
          const long long p = row >> 2;
          const int sub = static_cast<int>(row & 3);
          const long long pi = p / a.W, pj = p - pi * a.W;
          src = ((pi >> 1) * half_w + (pj >> 1)) * (16LL * C) + ((pi & 1) * 2 + (pj & 1)) * (4 * C) + sub * C + c * 8;
        } else if (ok) {
          src = row * C + c * 8;
        }
        cp_async16_or_zero(as + r * Cfg::APITCH + c * 16, a.add + src, ok);
      }
  };
  for (int i = 0; i < NS - 1; ++i) {
    if (i < tiles.n) load(i);
    cp_async_commit();
  }

  const unsigned w0 = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned w1s = w0 + Cfg::W0_BYTES, w1h = w1s + Cfg::W1_BYTES;
  const int rl = warp * 16 + (lane >> 2);
#ifdef HDRTV_SM90_PHASES
  // Cycles per phase of a tile (the wait for its rows, the products with
  // their hidden epilogue, t, its quantization, the output), summed by each
  // warpgroup's first thread.
  unsigned long long t_start = clock64(), t_phase[8] = {0, 0, 0, 0, 0, 0, 0, 0}, t_mark = 0;
#define PHASE(i) (t_phase[i] += clock64() - t_mark, t_mark = clock64());
#else
#define PHASE(i)
#endif
  for (int i = 0; i < tiles.n; ++i) {
#ifdef HDRTV_SM90_PHASES
    t_mark = clock64();
#endif
    cp_async_wait<NS - 2>();
    warpgroup_sync(wg);
    if (i + NS - 1 < tiles.n) load(i + NS - 1);
    cp_async_commit();

    unsigned char* const st = ring + (i % NS) * Cfg::STAGE;
    unsigned char* const xs = st + kRowBM * Cfg::CPITCH;
    unsigned char* const as = xs + kRowBM * Cfg::XPITCH;
    PHASE(1)
    unsigned ac[1][4];
    ldmatrix_x4(ac[0], st + (warp * 16 + (lane & 15)) * Cfg::CPITCH + (lane >> 4) * 16);

    float d0[CC];  // m64n(2·CC): the two hidden branches side by side
    wgmma_fence();
    WgmmaRA<2 * CC>::mma(d0, ac[0], desc_rows_b(w0, 2 * CC, 0), 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d0);
    fence_frags(ac);
    unsigned ah[2][4];  // chunk 0: the scale branch's hidden, 1: the shift branch's
#pragma unroll
    for (int j = 0; j < 2 * CC / 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(b0 + 8 * j + 2 * q);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ah[j / 2][2 * (j % 2) + h] = pack_bf16(apply_act(d0[4 * j + 2 * h] + bb.x, ACT_LRELU),
                                               apply_act(d0[4 * j + 2 * h + 1] + bb.y, ACT_LRELU));
    }
    float sc[C / 2], sh[C / 2];
    wgmma_fence();
    WgmmaRA<C>::mma(sc, ah[0], desc_rows_b(w1s, C, 0), 0);
    WgmmaRA<C>::mma(sh, ah[1], desc_rows_b(w1h, C, 0), 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(sh);
    fence_frags(ah);
    PHASE(2)
    float tv[Q8 ? C / 8 : 1][2][2];  // Q8: t of this thread's pairs, fp32
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int n = 8 * j + 2 * q;
      const float2 bs = *reinterpret_cast<const float2*>(b1s + n);
      const float2 bh = *reinterpret_cast<const float2*>(b1h + n);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rl + 8 * h;
        bf16* const pa = reinterpret_cast<bf16*>(as + r * Cfg::APITCH) + n;  // add, then the sum; or t
        bf16* pt = pa;
        float2 xv;
        if constexpr (F32X) {
          xv = *reinterpret_cast<const float2*>(xs + r * Cfg::XPITCH + n * 4);
        } else {
          pt = reinterpret_cast<bf16*>(xs + r * Cfg::XPITCH) + n;
          xv = load2<bf16>(pt);
          if (a.add) {
            const float2 u = load2<bf16>(pa);
            xv = make_float2(round_to<bf16>(xv.x + u.x), round_to<bf16>(xv.y + u.y));
            store2<bf16>(pa, xv);  // exact: already on the bf16 grid
          }
        }
        const float s0 = sc[4 * j + 2 * h] + bs.x, s1 = sc[4 * j + 2 * h + 1] + bs.y;
        const float h0 = sh[4 * j + 2 * h] + bh.x, h1 = sh[4 * j + 2 * h + 1] + bh.y;
        // multiply and add rounded apart, as the Pallas body (no contraction into an fma)
        const float t0 = __fadd_rn(__fmul_rn(xv.x, s0 + 1.f), h0), t1 = __fadd_rn(__fmul_rn(xv.y, s1 + 1.f), h1);
        if constexpr (Q8) {
          tv[j][h][0] = t0;
          tv[j][h][1] = t1;
        } else {
          store2<bf16>(pt, make_float2(t0, t1));
        }
      }
    }
    PHASE(3)
    if constexpr (Q8) {
      unsigned short codes[C / 8][2];
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          codes[j][h] = static_cast<unsigned short>(
              (quantize_code(tv[j][h][0], a.qs, a.qz, a.qasym) & 0xff) |
              (quantize_code(tv[j][h][1], a.qs, a.qz, a.qasym) & 0xff) << 8);
      PHASE(4)
      __syncwarp();  // every lane of the warp has read its x rows
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<unsigned short*>(xs + (rl + 8 * h) * Cfg::XPITCH + 8 * j + 2 * q) = codes[j][h];
    }
    warpgroup_sync(wg);
    const long long r0 = tiles.row0(i);
    if constexpr (Q8) {
      store_rows(a.q, xs, Cfg::XPITCH, C, r0, a.rows, t);
      if (a.xsum) store_rows(a.xsum, as, Cfg::APITCH, C * 2, r0, a.rows, t);
    } else if constexpr (F32X) {
      store_rows(a.t, as, Cfg::APITCH, C * 2, r0, a.rows, t);
    } else {
      store_rows(a.t, xs, Cfg::XPITCH, C * 2, r0, a.rows, t);
      if (a.xsum) store_rows(a.xsum, as, Cfg::APITCH, C * 2, r0, a.rows, t);
    }
    PHASE(5)
  }
  cp_async_wait<0>();
#ifdef HDRTV_SM90_PHASES
  t_phase[0] = clock64() - t_start;
  t_phase[7] = tiles.n;
  if (a.phases && t == 0)
    for (int k = 0; k < 8; ++k) a.phases[(blockIdx.x * 2 + wg) * 8 + k] = t_phase[k];
#endif
#undef PHASE
}

// Launches the SFT pass on a.rows rows of natural CC = 16 and C = 32
// channels (the widths every SFT of the checkpoint has), weights read at
// their block's pitch a.ld; Q8: the int8-output mode (a.q set).
template <typename XT, bool Q8 = false>
inline cudaError_t launch_sft_sm90(const SftSm90Args& a, cudaStream_t stream) {
  using Cfg = SftSm90Cfg<16, 32, XT>;
  auto kernel = sft_sm90_kernel<16, 32, XT, Q8>;
  static DeviceCache cache;  // once per instantiation and device
  int resident = 0;
  const cudaError_t err = resident_blocks(cache, kernel, Cfg::SMEM, &resident);
  if (err != cudaSuccess) return err;
  kernel<<<row_blocks(a.rows, resident), kRowThreads, Cfg::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// sft: the eight pointers w, b of scale0, scale1, shift0, shift1, whose
// blocks (CC, CC), (CC, C), (CC, CC), (CC, C) lie at the top left of
// weights of row pitch ld = cc, c, cc, c.
inline void set_sft_sm90_params(SftSm90Args& a, const void* const* sft, int cc, int c) {
  const int ld[4] = {cc, c, cc, c};
  for (int i = 0; i < 4; ++i) {
    a.w[i] = static_cast<const bf16*>(sft[2 * i]);
    a.b[i] = static_cast<const float*>(sft[2 * i + 1]);
    a.ld[i] = ld[i];
  }
}

// The SFT pass over s2d weights: H × W s2d pixels of C and CC channels, x
// of XT (bf16 or float), add (bf16 x only) nullptr, fine (coarse = 0) or
// coarse (coarse = 1, H and W even), xsum (with add only) nullptr or the
// rounded sum's destination; sft: the eight pointers w, b of scale0,
// scale1, shift0, shift1. q: the int8-output mode, t written as the codes
// of the layer q (bf16 x with or without add and xsum, or fp32 x). The
// widths the frame programs run, natural CC = 16 and C = 32, are the ones
// it takes; anything else is refused. `phases` (tools/sm90_phases.cu): the timers' array, else null.
template <typename XT>
inline cudaError_t sft_sm90(const void* x, const void* add, int coarse, void* xsum, const void* cond1, void* t,
                            const void* const* sft, int H, int W, int C, int CC, cudaStream_t stream,
                            const QuantParams* q = nullptr, unsigned long long* phases = nullptr) {
  if (C != 4 * 32 || CC != 4 * 16 || (add && coarse && (H % 2 || W % 2)) || (add && SftSm90Cfg<16, 32, XT>::F32X) ||
      (xsum && !add))
    return cudaErrorInvalidValue;
  SftSm90Args a;
  a.cond = static_cast<const bf16*>(cond1);
  a.x = x;
  a.add = static_cast<const bf16*>(add);
  a.xsum = static_cast<bf16*>(xsum);
  a.t = static_cast<bf16*>(t);
  set_sft_sm90_params(a, sft, CC, C);
  a.rows = 4LL * H * W;
  a.W = W;
  a.coarse = coarse;
#ifdef HDRTV_SM90_PHASES
  a.phases = phases;
#else
  (void)phases;
#endif
  if (q) {
    a.t = nullptr;
    a.q = static_cast<int8_t*>(t);
    a.qs = q->s;
    a.qz = q->z;
    a.qasym = q->asym;
    return launch_sft_sm90<XT, true>(a, stream);
  }
  return launch_sft_sm90<XT>(a, stream);
}

// The SFT pass over natural tensors (trunk3's): npix rows of x (bf16, C)
// and cond (CC), natural weights; C = 32 and CC = 16 only.
inline cudaError_t sft_sm90_natural(const void* x, const void* cond, void* t, const void* const* sft, long long npix,
                                    int C, int CC, cudaStream_t stream) {
  if (C != 32 || CC != 16) return cudaErrorInvalidValue;
  SftSm90Args a;
  a.cond = static_cast<const bf16*>(cond);
  a.x = x;
  a.add = nullptr;
  a.xsum = nullptr;
  a.t = static_cast<bf16*>(t);
  set_sft_sm90_params(a, sft, CC, C);
  a.rows = npix;
  a.W = 0;
  a.coarse = 0;
  return launch_sft_sm90<bf16>(a, stream);
}

// ---------------------------------------------------------------------------
// agcm_head's AGCM pass, its s2d form (agcm_head.cu, s2d=True): the frame's
// (npix, 12) s2d pixels are the (4·npix, 3) rows of natural pixels (channel
// so·3 + c of a pixel is channel c of its sub-position so's row), and each
// 1×1 w_s2d_1x1(w) is those rows times w's block:
//   a = relu(mod0(x·W1 + b1)), b = relu(mod1(a·W2 + b2)), y = mod2(b·W3 + b3)
// with mod_k(v) = v·(s_k + 1) + h_k, multiply and add rounded apart, s_k and
// h_k the fp32 modulation rows of mods at the row's own sub-position (lanes
// so·64 + n of rows 0-3; so·3 + n of rows 4-5): mods need no structure. x is
// the frame widened to fp32, scaled (__fmul_rn) and rounded to bf16; a and b
// are rounded once into the next step's A fragments, y once on store.
// Widths 3 → 64 → 64 → 3: the blocks come padded from the wrapper's pack,
// W1 to K = 16 rows and W3 to N = 16 columns, with zeros.
//
// A natural row is 3 values, and pair planes hold a pixel's parity as 6
// bytes: the rows cannot be 16-byte cp.async copies. Each thread loads its
// own values of step 0's A fragment (rows rl, rl + 8; channels 2q, 2q + 1
// of K = 16, of which only 0 .. 2 exist) straight into registers, the next
// tile's while this tile's steps run. Per tile three wgmma steps
// (m64n64k16 ×1, ×4; m64n16k16 ×4); a warp stages its 16 rows' 3 values
// (96 contiguous bytes) and writes them as 4-byte words. Both warpgroups
// walk their tiles apart, as the row tiles above.
//
// Bound on this card: bytes (at 1080p 6.2 MB in as u8 pair planes, 12.4 MB
// out: 0.0056 ms), against 25 GFLOP of padded products (0.025 ms).
// ---------------------------------------------------------------------------

enum AgcmFrameKind : int { kAgcmFrameBf16 = 0, kAgcmFrameU8 = 1, kAgcmFramePairs = 2 };

struct AgcmSm90Args {
  const void* x;      // the frame: bf16 (npix, 12), u8 (npix, 12) or u8 pair planes (Hb, 2, Wb, 6)
  int kind;           // AgcmFrameKind
  float scale;
  const float* mods;  // (6, mw) fp32
  int mw;
  const bf16* w[3];   // the blocks, row-major, padded: (16, 64), (64, 64), (64, 16)
  const float* b[3];  // s2d biases: their first 64, 64 and 3 values are the blocks'
  bf16* y;            // (rows, 3): the AGCM result, (npix, 12) s2d
  long long rows;     // 4·npix
  int W;              // s2d pixels of an image row (pair planes)
#ifdef HDRTV_SM90_PHASES
  unsigned long long* phases = nullptr;  // tools/sm90_phases.py: 8 clock64() sums per warpgroup
#endif
};

struct AgcmSm90Cfg {
  static constexpr int K0 = 16, N = 64, NL = 16;
  static constexpr int W1 = K0 * N * 2, W2 = N * N * 2, W3 = N * NL * 2;
  static constexpr int W_BYTES = W1 + W2 + W3;
  static constexpr int MP = N + 8;                        // floats of a sub-position's lanes: conflict-free pairs
  static constexpr int MOD_FLOATS = 4 * 4 * MP + 2 * NL;  // rows 0-3 by sub-position; rows 4-5 (12 lanes of 16)
  static constexpr int BIAS_FLOATS = 2 * N + NL;
  static constexpr int YST = 16 * 3 * 2;                  // a warp's staged rows of y
  static constexpr int SMEM = W_BYTES + (MOD_FLOATS + BIAS_FLOATS) * 4 + 8 * YST;
  static_assert(W_BYTES % 16 == 0 && (MOD_FLOATS + BIAS_FLOATS) % 4 == 0, "16-byte alignment");
};

// Where natural row r (sub-position so = r % 4) starts in the frame, in
// elements: rows are 3 consecutive values of (npix, 12) frames; in pair
// planes sub-position so = 2·(row parity) + column parity of s2d pixel (i,
// j) is x[i, row parity, j, 3·(column parity) ..]. 32-bit arithmetic (the
// wrapper keeps 12·npix < 2^31); the row i = p / W from the fp32
// reciprocal of W, corrected by one step either way (p < 2^24).
// (Args: AgcmSm90Args, or the fp32 instance's AgcmF32Args of agcm_tf32x3.cuh.)
template <typename Args>
__device__ __forceinline__ unsigned agcm_row_start(const Args& a, unsigned r, int so, float inv_w) {
  if (a.kind != kAgcmFramePairs) return r * 3;
  const unsigned p = r >> 2, w = static_cast<unsigned>(a.W);
  unsigned i = __float2uint_rz(__uint2float_rn(p) * inv_w);
  if (i * w > p) --i;
  if ((i + 1) * w <= p) ++i;
  return ((2 * i + (so >> 1)) * w + p - i * w) * 6 + (so & 1) * 3;
}

// Element e of the frame, widened to fp32.
__device__ __forceinline__ float agcm_frame_value(const AgcmSm90Args& a, unsigned e) {
  if (a.kind == kAgcmFrameBf16) return __bfloat162float(static_cast<const bf16*>(a.x)[e]);
  return static_cast<float>(static_cast<const uint8_t*>(a.x)[e]);
}

__global__ void __launch_bounds__(kRowThreads, 2) agcm_sm90_kernel(const __grid_constant__ AgcmSm90Args a) {
  using Cfg = AgcmSm90Cfg;
  constexpr int N = Cfg::N, NL = Cfg::NL, MP = Cfg::MP;
  extern __shared__ __align__(16) unsigned char row_smem[];
  unsigned char* const smem = row_smem;
  float* const mod = reinterpret_cast<float*>(smem + Cfg::W_BYTES);  // [row 0-3][so][MP], rows 0, 2 as s + 1
  float* const modl = mod + 4 * 4 * MP;                              // [row 4-5][so·3 + n], row 4 as s + 1
  float* const bias = modl + 2 * NL;                                 // b1 | b2 | b3 (3 of 16)
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = tid & 31, q = lane & 3;
  unsigned char* const yst = smem + Cfg::W_BYTES + (Cfg::MOD_FLOATS + Cfg::BIAS_FLOATS) * 4 + (tid >> 5) * Cfg::YST;

  stage_b(smem, N, 0, a.w[0], N, Cfg::K0, N);
  stage_b(smem + Cfg::W1, N, 0, a.w[1], N, N, N);
  stage_b(smem + Cfg::W1 + Cfg::W2, NL, 0, a.w[2], NL, N, NL);
  // the scale rows staged as s + 1 (the same fp32 value the modulation forms)
  for (int i = tid; i < 4 * 4 * N; i += kRowThreads) {
    const int row = i / (4 * N), l = i % (4 * N);  // l = so·64 + n
    const float m = a.mods[static_cast<long long>(row) * a.mw + l];
    mod[row * 4 * MP + (l / N) * MP + l % N] = row % 2 ? m : m + 1.f;
  }
  for (int i = tid; i < 2 * NL; i += kRowThreads)
    modl[i] = i % NL < 12 ? a.mods[static_cast<long long>(4 + i / NL) * a.mw + i % NL] + (i < NL ? 1.f : 0.f) : 0.f;
  for (int i = tid; i < Cfg::BIAS_FLOATS; i += kRowThreads)
    bias[i] = i < 2 * N ? a.b[i / N][i % N] : (i - 2 * N < 3 ? a.b[2][i - 2 * N] : 0.f);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const RowTiles tiles(a.rows, wg);
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
        v[2 * h] = agcm_frame_value(a, e);
        if (q == 0) v[2 * h + 1] = agcm_frame_value(a, e + 1);
      }
    }
  };
  // a hidden step's epilogue: bias, the modulation of mods rows `row` (s + 1)
  // and row + 1 (shift), ReLU, rounded into the next step's A fragments
  auto hidden = [&](float (&d)[N / 2], const float* bs, int row, unsigned (&af)[N / 16][4]) {
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
        af[j / 2][2 * (j % 2) + h] = pack_bf16(fmaxf(__fadd_rn(__fmul_rn(d[4 * j + 2 * h] + bb.x, s.x), hh.x), 0.f),
                                               fmaxf(__fadd_rn(__fmul_rn(d[4 * j + 2 * h + 1] + bb.y, s.y), hh.y), 0.f));
    }
  };
  // the last step's constants of this thread's columns 2q + c (< 3)
  float lb[2], ls[2], lh[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int n = 2 * q + c < 3 ? 2 * q + c : 0;
    lb[c] = bias[2 * N + n];
    ls[c] = modl[so * 3 + n];
    lh[c] = modl[NL + so * 3 + n];
  }

  const unsigned w1 = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned w2 = w1 + Cfg::W1, w3 = w2 + Cfg::W2;
#ifdef HDRTV_SM90_PHASES
  // Cycles per phase of a tile (fetch, the three steps' products and the two
  // hidden epilogues, the output), summed by each warpgroup's first thread.
  unsigned long long t_start = clock64(), t_phase[8] = {0, 0, 0, 0, 0, 0, 0, 0}, t_mark = 0;
#define PHASE(i) (t_phase[i] += clock64() - t_mark, t_mark = clock64());
#else
#define PHASE(i)
#endif
  float nxt[4];
  if (tiles.n > 0) fetch(0, nxt);
  for (int i = 0; i < tiles.n; ++i) {
#ifdef HDRTV_SM90_PHASES
    t_mark = clock64();
#endif
    unsigned ax[1][4];
    ax[0][0] = pack_bf16(__fmul_rn(nxt[0], a.scale), __fmul_rn(nxt[1], a.scale));
    ax[0][1] = pack_bf16(__fmul_rn(nxt[2], a.scale), __fmul_rn(nxt[3], a.scale));
    ax[0][2] = 0u;
    ax[0][3] = 0u;
    if (i + 1 < tiles.n) fetch(i + 1, nxt);
    PHASE(1)

    float d[N / 2];
    unsigned af[N / 16][4];
    wgmma_fence();
    WgmmaRA<N>::mma(d, ax[0], desc_rows_b(w1, N, 0), 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    fence_frags(ax);
    PHASE(2)
    hidden(d, bias, 0, af);
    PHASE(3)

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) WgmmaRA<N>::mma(d, af[kk], desc_rows_b(w2, N, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    fence_frags(af);
    PHASE(4)
    hidden(d, bias + N, 2, af);
    PHASE(5)

    float e[NL / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) WgmmaRA<NL>::mma(e, af[kk], desc_rows_b(w3, NL, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(e);
    fence_frags(af);
    PHASE(6)
    // columns 2q, 2q + 1 of the first 8 (e[2h], e[2h + 1]); 0 .. 2 exist
    bf16* const ys = reinterpret_cast<bf16*>(yst);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = 2 * q + c;
        if (n < 3)
          ys[((lane >> 2) + 8 * h) * 3 + n] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(e[2 * h + c] + lb[c], ls[c]), lh[c]));
      }
    __syncwarp();
    // the warp's 16 rows are 48 consecutive values: 24 words (rows come in
    // fours, so a word never straddles the end)
    const long long r0 = tiles.row0(i) + warp * 16;
    if (lane < 24 && r0 * 3 + 2 * lane < a.rows * 3)
      reinterpret_cast<unsigned*>(a.y + r0 * 3)[lane] = reinterpret_cast<const unsigned*>(yst)[lane];
    __syncwarp();
    PHASE(7)
  }
#ifdef HDRTV_SM90_PHASES
  t_phase[0] = clock64() - t_start;
  if (a.phases && t == 0)
    for (int k = 0; k < 8; ++k) a.phases[(blockIdx.x * 2 + wg) * 8 + k] = t_phase[k];
#endif
#undef PHASE
}

// The AGCM pass of agcm_head's s2d form (arguments: AgcmSm90Args).
inline cudaError_t agcm_sm90(const AgcmSm90Args& a, cudaStream_t stream) {
  static DeviceCache cache;
  int resident = 0;
  const cudaError_t err = resident_blocks(cache, agcm_sm90_kernel, AgcmSm90Cfg::SMEM, &resident);
  if (err != cudaSuccess) return err;
  agcm_sm90_kernel<<<row_blocks(a.rows, resident), kRowThreads, AgcmSm90Cfg::SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace hdrtv
