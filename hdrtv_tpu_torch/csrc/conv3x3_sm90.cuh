// A 3×3 convolution tile written for Hopper (sm_90a): bf16 × bf16 → fp32 on
// wgmma, fed by TMA through a ring of stages, whose K walk is a table of
// chunks. It runs the bf16 float forms of block_conv3 (stride 1, 'same') and
// down2 (stride 2, pad (1,0), a channel window of a wider input read in
// place), and the 3×3 convs of the s2d forms of sft_conv3, resblock and the
// tail (stride 1); block_conv3's and down2's fp32 float forms run its 3×TF32
// sibling (conv3x3_tf32x3.cuh), which shares the table, the arguments and the
// TMA map built here; the other forms and kernels keep conv3x3.cuh's tiles.
//
// Why a table. Every weight these kernels get on the frame programs is an
// s2d transform (models/s2d.py w_s2d_s1, its PS fold, w_s2d_s2, or a_sub of
// them side by side along Co), and such a weight is 3/4 exact zeros: output
// sub-position so reads 9 of the 36 (tap, input sub-position) slots
// (models/s2d.py s2d_slots). A K chunk is 32 channels of one slot at one tap,
// and the wrapper hands the kernel, per output sub-position, the list of its
// chunks (ops/conv_kernels.py conv_chunks, entry tap | c0 << 4): a block
// whose N tile lies inside one sub-position loads and multiplies only its
// own chunks, a quarter of the dense product's; the skipped products are
// exact zeros. The dense product (a_sub = 0, right for any weight) is one
// list of all 9·C/32 chunks.
//
// The block: two warpgroups (256 threads), two blocks per SM. Its N tile is
// BN = 128, 64 or 32 channels (the largest that divides the sub-position's
// width co_nat = Co/(4·a_sub), or Co when dense), its pixel tile BH = 2·MT
// rows × 64 columns of output pixels (MT = 2 for BN = 32, else 1); warpgroup
// g owns tile rows [g·MT, (g+1)·MT), one wgmma.m64nBNk16 per row and 16
// channels, fp32 accumulators in registers. Blocks are persistent: as many
// as the card holds, a whole number per N tile; block b keeps N tile
// b % groups (its chunk list and biases copied to shared memory) and walks
// the pixel tiles b / groups, + gridDim / groups, ...
//
// Loads. A: one TMA box per chunk, (32 channels, 64·S columns, BH·S rows) of
// x with element stride S, i.e. the tap's input pixels of the whole tile;
// TMA fills out-of-image pixels with zeros (the 'same' pad, and the (1,0) pad
// of stride 2), reads the channel window at its channel coordinate, and
// writes the 64-byte swizzle that wgmma's K-major SW64 descriptor reads.
// B: the chunk's (32, BN) weight rows by 16-byte cp.async into wgmma's
// MN-major layout without swizzle (core matrices of 8 channels × 8 rows:
// N-adjacent 128 bytes apart, K-adjacent BN·16), read transposed
// (imm-trans-b = 1). When the block's chunks fit in 72 KB (every 1080p shape
// of the frame programs) they stay resident, loaded once; else each ring
// stage carries its chunk's B.
//
// The ring: NS stages (4 with resident weights), one mbarrier each. At step
// k every thread waits for stage k's bytes and all meet; thread 0 then
// refills the stage step k − 2 used with chunk k + NS − 2 (everyone finished
// step k − 2's products before meeting), the warpgroups issue step k's
// wgmmas and wait for their step k − 1. The copy runs under the products.
//
// Sums. BN = 128 and 64 sum a tile's whole K in the tensor cores' fp32
// accumulator. BN = 32 (the instances of chained stages: trunk3's convs,
// sft_conv3's and resblock's) sums each chunk from zero in the tensor cores
// (scale-d = 0 on its first wgmma) and adds the chunk sums into registers
// in fp32, rounding to nearest; the warpgroups wait for step k − 1 before
// issuing step k, its products having run under step k's waits. The
// tensor cores' sum truncates at each of its 2·KT steps: one sum over the
// whole K put a bf16 rounding apart from a float64-summed conv's about
// twice as often as cuDNN's fp32 conv, and down trunk3's 9-conv chain the
// flips reached 7.4% of a small frame's outputs where the plain version
// had 0.01% (tools/trunk3_flips.py, PERF.md). Chunk sums flip as often as
// cuDNN's, for 2–8% more device time in these instances at 1080p
// (tools/profile_frame.py).
//
// Epilogue, after a tile's last chunk: all its products done, ((acc + b) +
// skip), the activation (none, relu, lrelu 0.1), one rounding to bf16; the
// four lanes of a quad swap their pairs so that each stores one 8-channel
// group's 16 bytes (a warp writes 64 contiguous bytes of each of 8 pixels);
// pixels past the image's edge are not stored. The next tile's first chunks
// are in flight meanwhile. Two more forms, each a template instance of its
// own (EPI; a run-time branch raised the BN = 128 instance from 118 to 128
// registers and block_conv3's bf16 time a frame in chip_smoke.py from 0.213
// to 0.243 ms), built for BN = 32 with resident weights at stride 1, the
// convs of sft_conv3 and resblock: kEpiF32 (resblock's conv1, whose h1
// stays fp32) rounds nothing: the quad swaps the two halves of its fp32
// pairs the same way and each lane stores one group's 32 bytes as two
// 16-byte pieces (a warp writes 128 contiguous bytes of each of 8 pixels);
// kEpiBf16Skip (a call with a skip) swaps the fp32 sums first, so that each
// lane reads its group's 8 skip values as one 16-byte piece instead of four
// 4-byte pairs, then adds, activates, rounds and stores as kEpiBf16;
// kEpiBf16Skip2 (trunk3's last conv2: x + conv2(t), then the stage skip)
// rounds that sum, adds a second skip read the same way, activates and
// rounds again: two roundings, as the TPU kernel stores x before adding fea3.
// kEpiPool (block_conv3's pool_out with a_sub ≥ 1, launched from
// block_conv3.cu, every N tile and weights' place) takes the 2×2 max of the
// activated fp32 sums before its one rounding and stores (Ho/2, Wo/2, Co)
// (sm90_pool_epilogue).
//
// What bounds it (in-kernel clock64() timers, PERF.md §5): at up_conv3's
// shape the epilogue takes half a block's time, the products and their
// waits a fifth. Two alternatives measured slower: one block per SM with a
// TMA-store epilogue from staged shared memory, and two blocks per SM with
// that epilogue and streamed weights (no room for the staging beside
// resident weights).
//
// Requirements (ops/conv_kernels.py sm90_table checks them; the launcher
// returns an error otherwise): a slot of a multiple of 32 channels (C/4 with
// a_sub, C dense), BN | co_nat, cf and ch0 whole 16-byte groups (multiples
// of 8 bf16 values), 16-byte aligned tensors, 9·C/32 ≤ kSm90MaxChunks.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include <algorithm>
#include <type_traits>

#include "conv3x3.cuh"

namespace hdrtv {
namespace {

constexpr int kSm90BK = 32;            // channels of one K chunk
constexpr int kSm90MaxChunks = 288;    // chunk entries of one launch
constexpr int kSm90Threads = 256;      // two warpgroups
constexpr int kSm90Smem = 113 * 1024;  // dynamic shared memory of a block: two blocks per SM
constexpr int kSm90TW = 64;            // output pixels of a tile row: one m64 wgmma tile

// The launch's arguments, T the element type (bf16 here, float for the
// 3×TF32 tile).
template <typename T>
struct Sm90Args {
  CUtensorMap tmap;   // x as (H, W, cf), box (32 channels, 64·S columns, BH·S rows), stride S, swizzled
  const T* w;         // (3, 3, C, Co)
  const float* b;     // (Co)
  const T* skip;      // (Ho, Wo, Co) or nullptr
  const T* skip2;     // (Ho, Wo, Co): the kEpiBf16Skip2 instance's second skip, else nullptr
  T* y;               // (Ho, Wo, Co); float in the bf16 tile's F32OUT instance
  int Ho, Wo;
  int ch0, C, Co;
  int act;
  int lists;          // 1 (dense) or 4 (one per output sub-position)
  int per_list;       // chunks in each list
  int co_blk;         // channels of one s2d block, Co / a_sub (dense: Co)
  int co_nat;         // channels of one output sub-position, co_blk / 4 (dense: Co)
#ifdef HDRTV_SM90_PHASES
  unsigned long long* phases = nullptr;  // tools/sm90_phases.py: 8 clock64() sums per warpgroup
#endif
  int chunk[kSm90MaxChunks];  // list l at [l·per_list, (l+1)·per_list): tap | c0 << 4
};

// The block's shape for an N tile of BN channels and the weight's place:
// RES, the block keeps its N tile's weight chunks resident in shared memory
// (loaded once; the ring carries A alone); otherwise each ring stage carries
// the chunk's B beside its A. A tile is BH rows × 64 columns of output pixels.
template <int BN, bool RES>
struct Sm90Cfg {
  static constexpr int MT = BN == 32 ? 2 : 1;  // m64 tiles (tile rows) per warpgroup
  static constexpr int BH = 2 * MT;
  static constexpr int BM = BH * kSm90TW;
  static constexpr int A_BYTES = BM * kSm90BK * 2;  // a multiple of 1024
  static constexpr int B_CHUNK = BN * kSm90BK * 2;
  static constexpr int NS = RES ? 4 : (kSm90Smem - 1024 - 128) / (A_BYTES + B_CHUNK);
  static_assert(NS >= 3, "the ring needs three stages");
  // shared memory: [1024-byte alignment][A ring][B: resident chunks or ring][NS barriers]
  // [the block's BN biases][its chunk list]
  static int smem(int per_list) {
    return 1024 + NS * A_BYTES + (RES ? per_list : NS) * B_CHUNK + 8 * NS + 4 * per_list + 4 * BN;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Thread 0's TMA load of A into `dst`, completing on `bar` with its bytes.
__device__ __forceinline__ void tma_load_a(const CUtensorMap* map, unsigned dst, unsigned bar, int c, int w, int h,
                                           int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Shared-memory matrix descriptors: A K-major with the 64-byte swizzle TMA
// wrote (8-row groups 512 bytes apart; the leading offset unused, 1), B
// MN-major without swizzle (leading = K-direction and stride = N-direction
// core-matrix offsets). Fields in 16-byte units.
__device__ __forceinline__ uint64_t desc_a_sw64(unsigned addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3fff) | (1ull << 16) | (static_cast<uint64_t>(512 >> 4) << 32) |
         (2ull << 62);
}
__device__ __forceinline__ uint64_t desc_b(unsigned addr, int lbo, int sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3fff) | (static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32);
}

// wgmma.m64nNk16, bf16 × bf16 + fp32, A K-major and B MN-major from shared
// memory (imm-trans-a 0, imm-trans-b 1), accumulating into d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// A K-major operand whose rows are 32·2^kind bytes in the swizzle of that
// span (32, 64 or 128 bytes): 8-row groups 8 rows apart (the leading offset
// unused, 1). A k32 slice starts 32 bytes further along the row. Fields in
// 16-byte units.
__device__ __forceinline__ uint64_t desc_kmajor(unsigned addr, int kind) {
  const int row = 32 << kind;
  return static_cast<uint64_t>((addr >> 4) & 0x3fff) | (1ull << 16) | (static_cast<uint64_t>(row / 2) << 32) |
         (static_cast<uint64_t>(3 - kind) << 62);
}

// wgmma.m64nBNk32, s8 × s8 + s32, both operands K-major from shared memory;
// accumulate 0 starts the sum from zero.
template <int BN>
struct WgmmaS8;

template <>
struct WgmmaS8<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct WgmmaS8<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct WgmmaS8<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <int R>
__device__ __forceinline__ void fence_iregs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The four lanes of a quad hold u[i] of 8-channel group 4·jg + i each; after
// the swap (a 4 × 4 transpose in three shuffles) lane q holds, in w[s],
// lane s's u[q]: the four pairs of group 4·jg + q. The kEpiF32 and
// kEpiBf16Skip epilogues swap with it; kEpiBf16 keeps its loop inline, as
// written before the other forms existed (a factored version raised the
// BN = 128 instance from 118 to 127 registers).
__device__ __forceinline__ void quad_swap(const unsigned (&u)[4], unsigned (&w)[4], int lane) {
  const int q = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int send = (q - r) & 3, from = (q + r) & 3;
    const unsigned val = send == 0 ? u[0] : send == 1 ? u[1] : send == 2 ? u[2] : u[3];
    const unsigned got = __shfl_sync(0xffffffffu, val, (lane & ~3) | from);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (from == i) w[i] = got;
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&r);
}

// Keeps the compiler from touching accumulators across an asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The epilogue's forms (see the header).
enum Sm90Epi { kEpiBf16 = 0, kEpiBf16Skip = 1, kEpiF32 = 2, kEpiBf16Skip2 = 3, kEpiPool = 4 };

// The pooled epilogue (kEpiPool, block_conv3's pool_out): each conv pixel's
// (acc + b) (+ skip) and activation in fp32, the max of a pooled pixel's
// four, one rounding to bf16; y is (Ho/2, Wo/2, Co). A thread holds columns
// 16·warp + lane/4 and + 8 of its tile rows, so lanes l and l ^ 4 hold a
// pooled pixel's two columns: one shuffle a pair leaves lane l the pooled
// column of its pair h = bit 2 of l. The two rows: at MT = 2 (BN = 32) a
// warpgroup's two tile rows, in the thread's registers; at MT = 1 the two
// warpgroups' rows, exchanged through `xchg`, the stage of the tile's last
// chunk (each warpgroup's half of it, its own tile row of A, is read by no
// product after its wgmma_wait, and TMA refills the stage two steps
// later): warpgroup g writes, rounded, the half of the channels that the
// other stores, 32-bit words thread-major (conflict-free), the block meets,
// and each takes the max of its half (rounding is monotonic, so the max of
// the rounded values is the rounded max). Then a quad's lanes swap their
// pairs (quad_swap) and store whole 16-byte groups, inside the image.
template <int BN, int MT>
__device__ __forceinline__ void sm90_pool_epilogue(float (&acc)[MT][BN / 2], const float* bias_s,
                                                   const Sm90Args<bf16>& a, int h0, int w0, int n0, int tid,
                                                   unsigned* xchg) {
  constexpr int NJ = BN / 8;                      // 8-channel groups of the N tile
  constexpr int NK = MT == 2 ? NJ : NJ / 2;       // groups this thread stores
  constexpr int HALF = kSm90TW * kSm90BK * 2 / 4;  // words of one tile row of A
  static_assert(NK % 4 == 0, "a quad stores four groups at a time");
  const int wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = tid & 31, q = lane & 3;
  const int hk = (lane >> 2) & 1;  // the column pair h this lane keeps
  float2 r[MT][NJ];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int ho = h0 + wg * MT + mt;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = 8 * j + 2 * q;
      const float2 bias = *reinterpret_cast<const float2*>(bias_s + n);
      float2 v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int wo = w0 + warp * 16 + h * 8 + (lane >> 2);
        v[h] = make_float2(acc[mt][4 * j + 2 * h] + bias.x, acc[mt][4 * j + 2 * h + 1] + bias.y);
        if (a.skip && ho < a.Ho && wo < a.Wo) {
          const float2 sk = load2<bf16>(a.skip + (static_cast<long long>(ho) * a.Wo + wo) * a.Co + n0 + n);
          v[h] = make_float2(v[h].x + sk.x, v[h].y + sk.y);
        }
        v[h] = make_float2(apply_act(v[h].x, a.act), apply_act(v[h].y, a.act));
      }
      const float2 send = hk ? v[0] : v[1], keep = hk ? v[1] : v[0];
      const float2 got = make_float2(__shfl_xor_sync(0xffffffffu, send.x, 4), __shfl_xor_sync(0xffffffffu, send.y, 4));
      r[mt][j] = make_float2(fmaxf(keep.x, got.x), fmaxf(keep.y, got.y));
    }
  }
  const int j0 = MT == 2 ? 0 : wg * NK;  // this thread's first stored group
  unsigned u[NK];
  if constexpr (MT == 2) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) u[j] = pack_bf16(fmaxf(r[0][j].x, r[1][j].x), fmaxf(r[0][j].y, r[1][j].y));
  } else {
    unsigned* const mine = xchg + wg * HALF;
    const unsigned* const other = xchg + (1 - wg) * HALF;
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const float2 o = wg ? r[0][k] : r[0][NK + k];  // selects: no local memory
      mine[k * 128 + t] = pack_bf16(o.x, o.y);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const unsigned ow = other[k * 128 + t];
      const float2 o = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow));
      const float2 m = wg ? r[0][NK + k] : r[0][k];
      u[k] = pack_bf16(fmaxf(m.x, o.x), fmaxf(m.y, o.y));
    }
    // the stage's generic-proxy accesses before TMA's next writes into it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  const int Hp = a.Ho >> 1, Wp = a.Wo >> 1;
  const int pho = (h0 >> 1) + (MT == 2 ? wg : 0), pwo = (w0 >> 1) + warp * 8 + hk * 4 + (lane >> 3);
  const long long row = (static_cast<long long>(pho) * Wp + pwo) * a.Co + n0;
#pragma unroll
  for (int jb = 0; jb < NK / 4; ++jb) {
    const unsigned g4[4] = {u[4 * jb], u[4 * jb + 1], u[4 * jb + 2], u[4 * jb + 3]};
    unsigned w4[4];
    quad_swap(g4, w4, lane);
    if (pho < Hp && pwo < Wp)
      *reinterpret_cast<uint4*>(a.y + row + (j0 + 4 * jb + q) * 8) = make_uint4(w4[0], w4[1], w4[2], w4[3]);
  }
}

template <int BN, int S, bool RES, int EPI>
__global__ void __launch_bounds__(kSm90Threads, 2) conv3x3_sm90_kernel(const __grid_constant__ Sm90Args<bf16> a) {
  using Cfg = Sm90Cfg<BN, RES>;
  constexpr int MT = Cfg::MT, BH = Cfg::BH, NS = Cfg::NS, D = NS - 2;
  extern __shared__ unsigned char smem_raw[];
  // TMA's 64-byte swizzle repeats every 512 bytes: align the ring to 1024.
  const unsigned base = (static_cast<unsigned>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - static_cast<unsigned>(__cvta_generic_to_shared(smem_raw)));
  unsigned char* const Bsm = smem + NS * Cfg::A_BYTES;  // RES: KT chunks; else NS stages
  const unsigned bars = base + NS * Cfg::A_BYTES + (RES ? a.per_list : NS) * Cfg::B_CHUNK;
  float* const bias_s = reinterpret_cast<float*>(smem + (bars - base) + 8 * NS);
  int* const chunks = reinterpret_cast<int*>(bias_s + BN);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  // Persistent blocks: block b keeps N tile b % groups and walks the pixel
  // tiles b / groups, + gridDim.x / groups, ... (tile t: rows BH·(t / tw)
  // .., columns 64·(t % tw) ..).
  const int groups = a.Co / BN;
  const int n0 = (blockIdx.x % groups) * BN;
  const int t0 = blockIdx.x / groups, tstride = gridDim.x / groups;
  const int tw = (a.Wo + kSm90TW - 1) / kSm90TW;
  const int tiles = ((a.Ho + BH - 1) / BH) * tw;
  const int KT = a.per_list;
  const int steps = t0 < tiles ? ((tiles - 1 - t0) / tstride + 1) * KT : 0;
  {
    const int* list = a.chunk + (a.lists == 1 ? 0 : (n0 % a.co_blk) / a.co_nat) * a.per_list;
    for (int i = tid; i < KT; i += kSm90Threads) chunks[i] = list[i];
    for (int i = tid; i < BN; i += kSm90Threads) bias_s[i] = a.b[n0 + i];
  }

  // B of chunk kt: 16-byte row idx = (k / 8)·BN + (channel group)·8 + k % 8.
  auto load_b = [&](int kt, unsigned char* Bs) {
    const int e = chunks[kt];
    const int tap = e & 15, c0 = e >> 4;
#pragma unroll
    for (int idx = tid; idx < 4 * BN; idx += kSm90Threads) {
      const int k = (idx / BN) * 8 + (idx & 7);
      const int n = n0 + ((idx >> 3) % (BN / 8)) * 8;
      cp_async16(Bs + idx * 16, a.w + static_cast<long long>(tap * a.C + c0 + k) * a.Co + n);
    }
  };
  // A of the next step (thread 0 keeps its chunk pk, tile pt and the
  // tile's first input pixel): one TMA box of the tap's input pixels,
  // out-of-image ones zero-filled.
  int pk = 0, pt = t0, pw = S * (t0 % tw) * kSm90TW - 1, ph = S * (t0 / tw) * BH - 1;
  auto load_a = [&](int stage) {
    const int e = chunks[pk];
    const int tap = e & 15, c0 = e >> 4;
    const int dI = tap / 3;
    tma_load_a(&a.tmap, base + stage * Cfg::A_BYTES, bars + 8 * stage, a.ch0 + c0, pw + tap - 3 * dI, ph + dI,
               Cfg::A_BYTES);
    if (++pk == KT) {
      pk = 0;
      pt += tstride;
      pw = S * (pt % tw) * kSm90TW - 1;
      ph = S * (pt / tw) * BH - 1;
    }
  };

#ifdef HDRTV_SM90_PHASES
  // Cycles per phase of the step loop, summed by every thread and written by
  // each warpgroup's first (tools/sm90_phases.py reads them).
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
  if (RES) {
    for (int kt = 0; kt < KT; ++kt) load_b(kt, Bsm + kt * Cfg::B_CHUNK);
    cp_async_commit();
  } else {
#pragma unroll
    for (int g = 0; g < D; ++g) {
      if (g < steps) load_b(g % KT, Bsm + g * Cfg::B_CHUNK);
      cp_async_commit();
    }
  }

  float acc[MT][BN / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;
  // BN = 32: each chunk summed from zero in part, added into acc in fp32
  // (see the header's "Sums").
  constexpr bool CS = BN == 32;
  float part[MT][BN / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) part[mt][i] = 0.f;
  auto add_part = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      fence_regs(part[mt]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mt][i] += part[mt][i];
    }
  };

  const int warp = (tid >> 5) & 3, lane = tid & 31;
  // Step g is chunk kt of the block's tile number `tile`, in ring stage
  // `stage`, whose barrier's phase of parity `phase` it waits for; `fill`
  // is the stage step g + NS − 2 loads into.
  int kt = 0, tile = 0, stage = 0, phase = 0, fill = D % NS;
  for (int g = 0; g < steps; ++g) {
#ifdef HDRTV_SM90_PHASES
    t_mark = clock64();
#endif
    // B: this thread's copies (cp.async, the generic proxy) made visible to
    // wgmma (the async proxy), then everyone's; A: TMA's bytes arrived.
    if (!RES || g == 0) {
      if (RES)
        cp_async_wait<0>();
      else
        cp_async_wait<D - 1>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    PHASE(1)
    mbar_wait(bars + 8 * stage, phase);
    PHASE(2)
    __syncthreads();
    PHASE(3)
    // Refill the stage step g − 2 used (every thread is past its products:
    // they met here after finishing step g − 2); the copy runs under this
    // step's products.
    if (tid == 0 && g + D < steps) load_a(fill);
    const unsigned As = base + stage * Cfg::A_BYTES;
    const unsigned Bs = static_cast<unsigned>(__cvta_generic_to_shared(Bsm)) + (RES ? kt : stage) * Cfg::B_CHUNK;
    if constexpr (CS) {
      // the previous chunk's sum (its products ran under this step's waits)
      if (kt > 0) {
        wgmma_wait<0>();
        add_part();
      }
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const uint64_t db = desc_b(Bs + s * BN * 32, BN * 16, 128);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        Wgmma<BN>::mma(CS ? part[mt] : acc[mt], desc_a_sw64(As + (wg * MT + mt) * kSm90TW * 64 + s * 32), db,
                       CS && s == 0 ? 0 : 1);
    }
    wgmma_commit();
    if (kt + 1 < KT) {
      if constexpr (!CS) wgmma_wait<1>();
      PHASE(4)
    } else {
      // The tile's last chunk: finish its products, store, start the next
      // tile from zero. The next tile's first loads are in flight meanwhile.
      wgmma_wait<0>();
      if constexpr (CS) add_part();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
      const int t = t0 + tile * tstride;
      const int h0 = (t / tw) * BH, w0 = (t % tw) * kSm90TW;
      // A thread holds, of each m64 tile (tile row wg·MT + mt), columns
      // 16·warp + lane/4 (+ 8) and of each 8-channel group the pair
      // (lane % 4)·2. The four lanes of a quad hold a pixel's 8 channels of
      // a group between them: over four groups they swap their pairs
      // (quad_swap) so that each lane stores one group: 16 bytes of
      // rounded bf16, or 32 of fp32 (kEpiF32).
      if constexpr (EPI == kEpiPool) {
        sm90_pool_epilogue<BN, MT>(acc, bias_s, a, h0, w0, n0, tid,
                                   reinterpret_cast<unsigned*>(smem + stage * Cfg::A_BYTES));
      } else {
        const int q = lane & 3;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ho = h0 + wg * MT + mt, wo = w0 + warp * 16 + h * 8 + (lane >> 2);
            const bool ok = ho < a.Ho && wo < a.Wo;
            const long long row = (static_cast<long long>(ho) * a.Wo + wo) * a.Co + n0;
#pragma unroll
            for (int jg = 0; jg < BN / 32; ++jg) {
              if constexpr (EPI != kEpiBf16) {
                unsigned lo[4], hi[4];
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                  const int j = 4 * jg + jj;
                  const int n = j * 8 + q * 2;
                  const float2 bias = *reinterpret_cast<const float2*>(bias_s + n);
                  float2 v = make_float2(acc[mt][4 * j + 2 * h] + bias.x, acc[mt][4 * j + 2 * h + 1] + bias.y);
                  if constexpr (EPI == kEpiF32) {
                    if (a.skip && ok) {
                      const float2 sk = load2<bf16>(a.skip + row + n);
                      v = make_float2(v.x + sk.x, v.y + sk.y);
                    }
                    v = make_float2(apply_act(v.x, a.act), apply_act(v.y, a.act));
                  }
                  lo[jj] = __float_as_uint(v.x);
                  hi[jj] = __float_as_uint(v.y);
                }
                // Lane q ends with group g = 4·jg + q: channels 8·g + 2s (wl[s]) and 8·g + 2s + 1 (wh[s]).
                unsigned wl[4], wh[4];
                quad_swap(lo, wl, lane);
                quad_swap(hi, wh, lane);
                const long long at = row + (4 * jg + q) * 8;
                if (ok) {
                  if constexpr (EPI == kEpiF32) {
                    uint4* const dst = reinterpret_cast<uint4*>(reinterpret_cast<float*>(a.y) + at);
                    dst[0] = make_uint4(wl[0], wh[0], wl[1], wh[1]);
                    dst[1] = make_uint4(wl[2], wh[2], wl[3], wh[3]);
                  } else {
                    const uint4 sk = *reinterpret_cast<const uint4*>(a.skip + at);
                    const unsigned skw[4] = {sk.x, sk.y, sk.z, sk.w};
                    uint4 sk2 = make_uint4(0u, 0u, 0u, 0u);
                    if constexpr (EPI == kEpiBf16Skip2) sk2 = *reinterpret_cast<const uint4*>(a.skip2 + at);
                    const unsigned sk2w[4] = {sk2.x, sk2.y, sk2.z, sk2.w};
                    unsigned o[4];
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                      const float2 sv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&skw[e]));
                      float2 v = make_float2(__uint_as_float(wl[e]) + sv.x, __uint_as_float(wh[e]) + sv.y);
                      if constexpr (EPI == kEpiBf16Skip2) {
                        const float2 s1 = __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
                        const float2 s2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&sk2w[e]));
                        v = make_float2(s1.x + s2.x, s1.y + s2.y);
                      }
                      const __nv_bfloat162 r = __floats2bfloat162_rn(apply_act(v.x, a.act), apply_act(v.y, a.act));
                      o[e] = *reinterpret_cast<const unsigned*>(&r);
                    }
                    *reinterpret_cast<uint4*>(a.y + at) = make_uint4(o[0], o[1], o[2], o[3]);
                  }
                }
              } else {
                unsigned u[4];
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                  const int j = 4 * jg + jj;
                  const int n = j * 8 + q * 2;
                  const float2 bias = *reinterpret_cast<const float2*>(bias_s + n);
                  float2 v = make_float2(acc[mt][4 * j + 2 * h] + bias.x, acc[mt][4 * j + 2 * h + 1] + bias.y);
                  if (a.skip && ok) {
                    const float2 sk = load2<bf16>(a.skip + row + n);
                    v = make_float2(v.x + sk.x, v.y + sk.y);
                  }
                  const __nv_bfloat162 r = __floats2bfloat162_rn(apply_act(v.x, a.act), apply_act(v.y, a.act));
                  u[jj] = *reinterpret_cast<const unsigned*>(&r);
                }
                // Lane q ends with group 4·jg + q: w[s] = lane s's u[q].
                unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                  const int send = (q - r) & 3, from = (q + r) & 3;
                  const unsigned val = send == 0 ? u[0] : send == 1 ? u[1] : send == 2 ? u[2] : u[3];
                  const unsigned got = __shfl_sync(0xffffffffu, val, (lane & ~3) | from);
#pragma unroll
                  for (int i = 0; i < 4; ++i)
                    if (from == i) w[i] = got;
                }
                if (ok) *reinterpret_cast<uint4*>(a.y + row + (4 * jg + q) * 8) = make_uint4(w[0], w[1], w[2], w[3]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;
      PHASE(5)
    }
    if (!RES) {
      if (g + D < steps) load_b((g + D) % KT, Bsm + fill * Cfg::B_CHUNK);
      cp_async_commit();
    }
    PHASE(6)
    if (++kt == KT) kt = 0, ++tile;
    if (++stage == NS) stage = 0, phase ^= 1;
    if (++fill == NS) fill = 0;
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

// cuTensorMapEncodeTiled, looked up through the runtime's entry points (no -lcuda).
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// x's TMA map for a tile of BH output rows: (cf, W, H) innermost first; the
// box reads 32 channels of 64 output columns × BH output rows of one tap,
// every S-th input pixel, and writes them with the swizzle whose span is one
// 32-channel row (64 bytes of bf16, 128 of fp32), as the tile's descriptors
// read it.
template <typename T>
cudaError_t encode_a_map(CUtensorMap* map, const void* x, int H, int W, int cf, int S, int BH) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  constexpr bool f32 = std::is_same<T, float>::value;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cf), static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cf) * sizeof(T), static_cast<cuuint64_t>(W) * cf * sizeof(T)};
  const cuuint32_t box[3] = {kSm90BK, static_cast<cuuint32_t>(kSm90TW * S), static_cast<cuuint32_t>(BH * S)};
  const cuuint32_t estr[3] = {1, static_cast<cuuint32_t>(S), static_cast<cuuint32_t>(S)};
  if (encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             f32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// How many blocks of `kernel` the current device holds at once (block size
// `threads`, `smem` bytes of dynamic shared memory, which it also allows the
// kernel on that device), computed once per device and kept in `cache`.
template <typename K>
cudaError_t resident_blocks(DeviceCache& cache, K kernel, int smem, int* resident, int threads = kSm90Threads) {
  return per_device(cache, resident, [&](int dev, int* v) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err == cudaSuccess) *v = std::max(per_sm, 1) * sms;
    return err;
  });
}

// Persistent blocks: as many as the card holds, a whole number per N tile.
inline int sm90_grid(int Ho, int Wo, int Co, int BN, int BH, int resident) {
  const int groups = Co / BN;
  const int tiles = ((Ho + BH - 1) / BH) * ((Wo + kSm90TW - 1) / kSm90TW);
  return groups * std::max(1, std::min(tiles, resident / groups));
}

template <int BN, int S, bool RES, int EPI = kEpiBf16>
cudaError_t launch_sm90(Sm90Args<bf16>& a, const void* x, int H, int W, int cf, cudaStream_t stream) {
  using Cfg = Sm90Cfg<BN, RES>;
  auto kernel = conv3x3_sm90_kernel<BN, S, RES, EPI>;
  static DeviceCache cache;  // once per instantiation and device
  int resident = 0;
  cudaError_t err = resident_blocks(cache, kernel, kSm90Smem, &resident);
  if (err != cudaSuccess) return err;
  const int smem = Cfg::smem(a.per_list);
  if (smem > kSm90Smem) return cudaErrorInvalidValue;
  err = encode_a_map<bf16>(&a.tmap, x, H, W, cf, S, Cfg::BH);
  if (err != cudaSuccess) return err;
  kernel<<<sm90_grid(a.Ho, a.Wo, a.Co, BN, Cfg::BH, resident), kSm90Threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The arguments both Hopper tiles take, checked (cudaErrorInvalidValue for
// a shape they do not take): S the stride (Ho = H/S), a_sub 0 (dense, one
// list of 9·C/32 chunks) or the s2d blocks along Co (four lists, one per
// output sub-position), table the lists back to back, per_list entries each;
// the pixel pitch cf and the window start ch0 whole 16-byte groups.
template <typename T>
cudaError_t sm90_setup(Sm90Args<T>& a, const void* w, const float* b, const void* skip, void* y, int H, int W,
                       int S, int cf, int ch0, int C, int Co, int act, int a_sub, const int* table, int per_list) {
  a.w = static_cast<const T*>(w);
  a.b = b;
  a.skip = static_cast<const T*>(skip);
  a.skip2 = nullptr;
  a.y = static_cast<T*>(y);
  a.Ho = H / S;
  a.Wo = W / S;
  a.ch0 = ch0;
  a.C = C;
  a.Co = Co;
  a.act = act;
  a.lists = a_sub ? 4 : 1;
  a.per_list = per_list;
  a.co_blk = a_sub ? Co / a_sub : Co;
  a.co_nat = a_sub ? a.co_blk / 4 : Co;
  const int slot = a_sub ? C / 4 : C;
  constexpr int group = 16 / sizeof(T);
  if (a_sub < 0 || !table || per_list < 1 || a.lists * per_list > kSm90MaxChunks ||
      a.lists * per_list != 9 * C / kSm90BK || slot % kSm90BK || (a_sub && Co % (4 * a_sub)) ||
      a.co_nat % 32 || cf % group || ch0 % group || ch0 + C > cf || H % S || W % S)
    return cudaErrorInvalidValue;
  for (int i = 0; i < a.lists * per_list; ++i) a.chunk[i] = table[i];
  return cudaSuccess;
}

// The N tile (BN, the largest of 128, 64, 32 that divides co_nat) and the
// weights' place (resident where the block's chunks fit beside the ring) of
// a launch whose arguments are set, and the launch of instance EPI there.
template <int S, int EPI>
cudaError_t launch_sm90_fit(Sm90Args<bf16>& a, const void* x, int H, int W, int cf, cudaStream_t stream) {
  const int bn = a.co_nat % 128 == 0 ? 128 : a.co_nat % 64 == 0 ? 64 : 32;
  const bool res = (bn == 128 ? Sm90Cfg<128, true>::smem(a.per_list)
                    : bn == 64 ? Sm90Cfg<64, true>::smem(a.per_list)
                               : Sm90Cfg<32, true>::smem(a.per_list)) <= kSm90Smem;
  if (bn == 128)
    return res ? launch_sm90<128, S, true, EPI>(a, x, H, W, cf, stream)
               : launch_sm90<128, S, false, EPI>(a, x, H, W, cf, stream);
  if (bn == 64)
    return res ? launch_sm90<64, S, true, EPI>(a, x, H, W, cf, stream)
               : launch_sm90<64, S, false, EPI>(a, x, H, W, cf, stream);
  return res ? launch_sm90<32, S, true, EPI>(a, x, H, W, cf, stream)
             : launch_sm90<32, S, false, EPI>(a, x, H, W, cf, stream);
}

// The bf16 float conv of block_conv3, sft_conv3, resblock and the tail (S =
// 1: Ho = H) or down2 (S = 2: Ho = H/2) on the Hopper tile (arguments:
// sm90_setup). `args`: where to build the launch's arguments
// (tools/sm90_phases.cu passes its own, with the timers' array set); by
// default on the stack. `f32_out`: y is float, stored unrounded (kEpiF32:
// stride 1, 32-channel N tiles, resident weights; others refuse). A skip
// takes kEpiBf16Skip where that is built (the same shapes), else kEpiBf16.
// `skip2` (with a skip): kEpiBf16Skip2, the sum with the skip rounded, the
// second skip added and rounded again (the same shapes; others refuse).
template <int S>
cudaError_t conv3x3_sm90(const void* x, const void* w, const float* b, const void* skip, void* y, int H,
                         int W, int cf, int ch0, int C, int Co, int act, int a_sub, const int* table,
                         int per_list, cudaStream_t stream, Sm90Args<bf16>* args = nullptr, bool f32_out = false,
                         const void* skip2 = nullptr) {
  Sm90Args<bf16> own;
  Sm90Args<bf16>& a = args ? *args : own;
  const cudaError_t err = sm90_setup(a, w, b, skip, y, H, W, S, cf, ch0, C, Co, act, a_sub, table, per_list);
  if (err != cudaSuccess) return err;
  a.skip2 = static_cast<const bf16*>(skip2);
  const bool res32 = a.co_nat % 64 && Sm90Cfg<32, true>::smem(per_list) <= kSm90Smem;
  if constexpr (S == 1) {
    if (res32 && f32_out && !skip2) return launch_sm90<32, 1, true, kEpiF32>(a, x, H, W, cf, stream);
    if (res32 && skip && skip2) return launch_sm90<32, 1, true, kEpiBf16Skip2>(a, x, H, W, cf, stream);
    if (res32 && skip && !skip2) return launch_sm90<32, 1, true, kEpiBf16Skip>(a, x, H, W, cf, stream);
  }
  if (f32_out || skip2) return cudaErrorInvalidValue;
  return launch_sm90_fit<S, kEpiBf16>(a, x, H, W, cf, stream);
}

}  // namespace
}  // namespace hdrtv
