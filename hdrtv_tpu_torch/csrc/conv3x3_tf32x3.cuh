// The fp32 instance of the Hopper conv tile (conv3x3_sm90.cuh), sm_90a: the
// same chunk-table K walk over the s2d slots, TMA ring and persistent blocks,
// with its products run as 3×TF32 on wgmma (m64nNk8, fp32 += tf32 × tf32).
// It runs the fp32 float forms of block_conv3 and down2 with a_sub ≥ 1, the
// 3×3 convs of the fp32 s2d forms of sft_conv3 and resblock (the stride-1
// slot table), and trunk3's nine 32-channel convs dense (a_sub = 0: one
// list of 9 chunks, which trunk3 asks ops/conv_kernels.py sm90_table for by
// name); block_conv3's and down2's dense products stay on conv3x3.cuh's FMA
// tile.
//
// Why 3×TF32. One TF32 product keeps 11 significant bits of each operand,
// about 2^-11 relative error per product: too coarse for the fp32 program,
// the one every other precision is held against. Each operand is split,
// big = tf32(x) and small = tf32(x − big), rounded to nearest with ties
// away from zero by cvt.rna.tf32.f32 (the hardware is not relied on to drop
// the low 13 bits), so that big + small is x to 2^-22·|x|, and the tile
// sums small·big + big·small + big·big (small·small, below 2^-22 of the
// product, is dropped; taking it changed nothing measurable): fp32
// accuracy at a third of the tensor cores' TF32 rate, 2.5× the fp32 FMA
// units' 67 TFLOP/s. The sums: each chunk's 12 products in the tensor
// cores from zero, the chunk sums added in fp32 registers. One tensor-core
// sum over the whole K (the first version) drifted toward zero, three times
// as far from the plain version at the consolidated CondNet down conv, and
// the drift flipped enough of the int8 fp32 program's codes to fail its
// frame check; a sum per chunk cost no time (PERF.md §6).
//
// The block: two warpgroups (256 threads), one block per SM (its split
// weights take most of the 227 KB). Its N tile is BN = 64 or 32 channels
// inside one output sub-position (64 where it divides co_nat and the
// weights fit), its pixel tile 2 rows × 64 columns; warpgroup g owns tile
// row g, fp32 accumulators in registers. Persistent blocks as in the bf16
// tile: block b keeps N tile b % groups and walks the pixel tiles
// b / groups, + gridDim / groups, ...
//
// Operands. wgmma takes tf32 K-major only (imm-trans exists for 16-bit
// types alone), so both are K-major with the 128-byte swizzle a 32-channel
// fp32 row spans, and share an order of the chunk's channels along K
// (k_of) that puts each thread's 8 values of a pixel in 32 contiguous bytes.
// - A: one TMA box per chunk (32 channels, 64·S columns, 2·S rows, element
//   stride S; zero fill for the pads, the channel window at its channel
//   coordinate), written with the 128-byte swizzle. Each thread reads its
//   fragments of the chunk's four k8 steps with four 16-byte loads (free of
//   bank conflicts under the swizzle), splits them in registers and issues
//   the three products with A from registers: A has one copy in shared
//   memory.
// - B: split once. A block reads its N tile's resident chunks from the fp32
//   weight in global memory (three chunks' reads in flight together) and writes
//   B_big and B_small, each BN rows (output channels) of 32 channels, 128
//   bytes, swizzled as TMA would, into shared memory; every later tile reads
//   them through descriptors. No host-side weight preparation.
//
// The ring: NS = 4 stages of A (16 KB each), one mbarrier each. Step k
// issues chunk k's 12 wgmmas (4 k8 steps × 3 products) on the fragments
// split during step k − 1, then waits for stage k + 1 and splits its
// fragments into the other set of registers while the products run, waits
// for them, adds the chunk's sum, and everyone meets; thread 0 then
// refills stage k with chunk k + NS. The fragments' split, a quarter of
// the tile's cycles (phases in PERF.md §5), runs under the tensor cores.
//
// Epilogue, after a tile's last chunk: ((acc + b) + skip), the activation,
// fp32 out; the skip's values are read first, all at once; lanes q and
// q ^ 1 of a quad swap one 8-byte pair so that each stores a whole 16-byte
// group of 4 channels (a quad writes 64 contiguous bytes of a pixel);
// pixels past the image's edge are not stored. The SK2 instance (trunk3's
// last conv2, BN = 32 at stride 1) adds a second skip after the first,
// (((acc + b) + skip) + skip2), as the TPU kernel adds the stage skip fea3
// to the running x after its last resblock; its values are read with the
// first's. A skip may be the output itself (trunk3's running x, updated in
// place): each value is read before the quad's shuffle and written after
// it, by a lane of the same quad. The POOL instance (block_conv3's fp32
// pool_out with a_sub ≥ 1, launched from block_conv3.cu) takes the 2×2 max
// of the activated sums and stores (Ho/2, Wo/2, Co), as the bf16 tile's
// kEpiPool does.
//
// Shared memory: 1 KB alignment + 4 × 16 KB ring + 2 · per_list · BN · 128
// bytes of split weights + barriers, biases, chunk list ≤ 227 KB: per_list
// ≤ 18 at BN = 32 (the program's C = 256 slots), ≤ 9 at BN = 64
// (kTf32MaxList; ops/conv_kernels.py sm90_table refuses more).
//
// What bounds it: operations. At 1080p the fp32 programs' down2 calls need
// 146 GFLOP of non-zero products a frame and block_conv3's 171, three
// products each at the 494.7 TFLOP/s dense TF32 rate: 0.89 and 1.04 ms.
// Measured (PERF.md §6) about three times that: the split of A, the
// per-step meeting and, at BN = 32, A re-read from L2 for each N tile.
#pragma once

#include "conv3x3_sm90.cuh"

namespace hdrtv {
namespace {

constexpr int kTf32Smem = 227 * 1024;  // dynamic shared memory of a block: one block per SM
constexpr int kTf32MaxList = 18;       // chunks of a list whose split weights stay resident (at BN = 32)

template <int BN>
struct Tf32Cfg {
  static constexpr int BH = 2;  // tile rows: one m64 tile per warpgroup
  static constexpr int A_BYTES = BH * kSm90TW * kSm90BK * 4;  // 16 KB, a multiple of 1024
  static constexpr int B_HALF = BN * kSm90BK * 4;  // big or small of one chunk: BN rows of 128 bytes
  static constexpr int NS = 4;
  // shared memory: [1024-byte alignment][A ring][per chunk: B_big, B_small][NS barriers]
  // [the block's BN biases][its chunk list]
  static int smem(int per_list) {
    return 1024 + NS * A_BYTES + 2 * per_list * B_HALF + 8 * NS + 4 * BN + 4 * per_list;
  }
};

// tf32(x): round to nearest, ties away from zero, on the low 13 bits.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// The order of a chunk's 32 channels along K, which A and B share: k8 step
// ks, position k (0..7) holds channel 8·(k % 4) + 2·ks + k / 4, so that the
// thread with k = q and q + 4 in every step reads channels 8q .. 8q + 7 of a
// pixel, 32 contiguous bytes. k_of(c) is where channel c lies (8·ks + k).
__device__ __forceinline__ int k_of(int c) { return 8 * ((c & 7) >> 1) + (c >> 3) + 4 * (c & 1); }

// K-major operand with the 128-byte swizzle: 8-row groups 1024 bytes apart
// (the leading offset unused, 1). Fields in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(unsigned addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3fff) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// wgmma.m64nNk8, tf32 × tf32 + fp32, A from registers (a[0..3]: rows r and
// r + 8 at k = q, then at k = q + 4, r = 16·warp + lane/4, q = lane % 4), B
// K-major from shared memory, accumulating into d.
template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<48> {
  static __device__ __forceinline__ void mma(float (&d)[24], const uint32_t (&a)[4], uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <int N>
__device__ __forceinline__ void fence_tf32_frags(uint32_t (&a)[4][N]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

template <int BN, int S, bool SK2, bool POOL>
__global__ void __launch_bounds__(kSm90Threads, 1) conv3x3_tf32x3_kernel(const __grid_constant__ Sm90Args<float> a) {
  using Cfg = Tf32Cfg<BN>;
  constexpr int NS = Cfg::NS, BH = Cfg::BH;
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the ring and B to it.
  const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(smem_raw));
  const unsigned base = (raw + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);
  const unsigned bsm = base + NS * Cfg::A_BYTES;  // chunk kt: B_big at 2·kt·B_HALF, B_small after it
  const unsigned bars = bsm + 2 * a.per_list * Cfg::B_HALF;
  float* const bias_s = reinterpret_cast<float*>(smem + (bars - base) + 8 * NS);
  int* const chunks = reinterpret_cast<int*>(bias_s + BN);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
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
  // A of the next step (thread 0 keeps its chunk pk, tile pt and the tile's
  // first input pixel): one TMA box of the tap's input pixels, out-of-image
  // ones zero-filled.
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
  // Cycles per phase, summed by every thread and written by each
  // warpgroup's first (tools/sm90_phases.py reads them): 1 loading and
  // splitting the next step's A, 2 waiting for it, 3 meeting and the
  // refill, 4 issuing the products and waiting for them, 5 epilogue, 6
  // loading and splitting B.
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
    for (int g = 0; g < NS && g < steps; ++g) load_a(g);
#ifdef HDRTV_SM90_PHASES
  t_mark = clock64();
#endif
  // B: the block's chunks, split once and kept (row n = output channel n0 +
  // n, channel c at K position k_of(c), its 16-byte groups swizzled by
  // n % 8). Reads run along Co, coalesced, three chunks' all in flight at
  // once (a short conv, trunk3's, waits for them before its first product).
  if (steps) {
    constexpr int PER = kSm90BK * BN / kSm90Threads, G = 3;
    for (int kt0 = 0; kt0 < KT; kt0 += G) {
      float v[G][PER];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (kt0 + g >= KT) break;
        const int e = chunks[kt0 + g];
        const float* wk = a.w + static_cast<long long>((e & 15) * a.C + (e >> 4)) * a.Co + n0;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int idx = i * kSm90Threads + tid;
          v[g][i] = wk[static_cast<long long>(idx / BN) * a.Co + idx % BN];
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (kt0 + g >= KT) break;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int idx = i * kSm90Threads + tid;
          const int n = idx % BN, k = k_of(idx / BN);
          uint32_t big, small;
          split_tf32(v[g][i], big, small);
          const int off = (bsm - base) + (kt0 + g) * 2 * Cfg::B_HALF + n * 128 + (((k >> 2) ^ (n & 7)) << 4) +
                          (k & 3) * 4;
          *reinterpret_cast<uint32_t*>(smem + off) = big;
          *reinterpret_cast<uint32_t*>(smem + off + Cfg::B_HALF) = small;
        }
      }
    }
  }
  // The stores above (generic proxy) made visible to wgmma (async proxy),
  // everyone's before any product.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  PHASE(6)

  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f, part[i] = 0.f;

  // This thread's fragment rows in a stage: pixels 64·wg + 16·warp + lane/4
  // (+ 8), 128 bytes each; of every k8 step its k = q and q + 4 (q = lane %
  // 4), which k_of places at channels 8q .. 8q + 7: the 16-byte groups 2q and
  // 2q + 1, swizzled by the row mod 8 = lane/4 (both rows). Four 16-byte
  // loads a step, free of bank conflicts.
  const int q4 = lane & 3, sw = lane >> 2;
  const int arow = (wg * kSm90TW + warp * 16 + sw) * 128;
  const int g0 = ((2 * q4) ^ sw) * 16, g1 = ((2 * q4 + 1) ^ sw) * 16;
  // The fragments of a stage's four k8 steps, split: a[0], a[1] (rows r, r +
  // 8) at k = q, channel 8q + 2·ks; a[2], a[3] at k = q + 4, channel 8q +
  // 2·ks + 1.
  auto frags = [&](int stg, uint32_t (&ab)[4][4], uint32_t (&as)[4][4]) {
    const unsigned char* As = smem + stg * Cfg::A_BYTES + arow;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 lo = *reinterpret_cast<const float4*>(As + h * 8 * 128 + g0);
      const float4 hi = *reinterpret_cast<const float4*>(As + h * 8 * 128 + g1);
      const float c[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        split_tf32(c[2 * ks], ab[ks][h], as[ks][h]);
        split_tf32(c[2 * ks + 1], ab[ks][2 + h], as[ks][2 + h]);
      }
    }
  };
  // Chunk kt's 12 products (4 k8 steps × small·big, big·small, big·big)
  // into `part`, from zero; the step adds it to acc after their wait.
  auto products = [&](int kt, const uint32_t (&ab)[4][4], const uint32_t (&as)[4][4]) {
    const unsigned Bb = bsm + kt * 2 * Cfg::B_HALF;
    uint64_t dbig[4], dsmall[4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      dbig[ks] = desc_sw128(Bb + ks * 32);
      dsmall[ks] = desc_sw128(Bb + Cfg::B_HALF + ks * 32);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      WgmmaTf32<BN>::mma(part, as[ks], dbig[ks], ks > 0);  // the chunk's sum starts from zero
      WgmmaTf32<BN>::mma(part, ab[ks], dsmall[ks]);
      WgmmaTf32<BN>::mma(part, ab[ks], dbig[ks]);
    }
    wgmma_commit();
  };
  // The pooled store (POOL, block_conv3's pool_out), as the bf16 tile's
  // kEpiPool (conv3x3_sm90.cuh sm90_pool_epilogue) in fp32: each conv
  // pixel's ((acc + b) + skip) and activation, one shuffle to a pooled
  // column (lanes l and l ^ 4 hold its two), the two tile rows' warpgroups
  // exchanging the halves of the channels the other stores through the
  // stage of the tile's last chunk (its fragments were read a step before,
  // and it is refilled after this step's meeting), the max, fp32 out: lanes
  // q and q ^ 1 swap one pair so that each stores 16 bytes, inside the
  // image; y is (Ho/2, Wo/2, Co).
  auto pool_epilogue = [&](int h0, int w0, int stg) {
    constexpr int NK = BN / 16;                   // groups a warpgroup stores
    constexpr int HALF = kSm90TW * kSm90BK / 2;   // float2 of one tile row of A
    const int q = lane & 3, t = tid & 127, hk = (lane >> 2) & 1;
    const int ho = h0 + wg;
    float2 r[BN / 8];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 bias = *reinterpret_cast<const float2*>(bias_s + j * 8 + q * 2);
      float2 v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int wo = w0 + warp * 16 + h * 8 + (lane >> 2);
        v[h] = make_float2(acc[4 * j + 2 * h] + bias.x, acc[4 * j + 2 * h + 1] + bias.y);
        if (a.skip && ho < a.Ho && wo < a.Wo) {
          const float2 sk = *reinterpret_cast<const float2*>(
              a.skip + (static_cast<long long>(ho) * a.Wo + wo) * a.Co + n0 + j * 8 + q * 2);
          v[h] = make_float2(v[h].x + sk.x, v[h].y + sk.y);
        }
        v[h] = make_float2(apply_act(v[h].x, a.act), apply_act(v[h].y, a.act));
      }
      const float2 send = hk ? v[0] : v[1], keep = hk ? v[1] : v[0];
      const float2 got = make_float2(__shfl_xor_sync(0xffffffffu, send.x, 4), __shfl_xor_sync(0xffffffffu, send.y, 4));
      r[j] = make_float2(fmaxf(keep.x, got.x), fmaxf(keep.y, got.y));
    }
    float2* const xchg = reinterpret_cast<float2*>(smem + stg * Cfg::A_BYTES);
#pragma unroll
    for (int k = 0; k < NK; ++k) xchg[wg * HALF + k * 128 + t] = wg ? r[k] : r[NK + k];  // selects: no local memory
    __syncthreads();
    float2 p[NK];
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const float2 o = xchg[(1 - wg) * HALF + k * 128 + t], m = wg ? r[NK + k] : r[k];
      p[k] = make_float2(fmaxf(m.x, o.x), fmaxf(m.y, o.y));
    }
    // the stage's generic-proxy accesses before TMA's next writes into it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const bool odd = q & 1;
    const int Hp = a.Ho >> 1, Wp = a.Wo >> 1;
    const int pho = h0 >> 1, pwo = (w0 >> 1) + warp * 8 + hk * 4 + (lane >> 3);
    const long long row = (static_cast<long long>(pho) * Wp + pwo) * a.Co + n0;
#pragma unroll
    for (int jp = 0; jp < NK / 2; ++jp) {
      const int j = wg * NK + 2 * jp;
      const float2 send = odd ? p[2 * jp] : p[2 * jp + 1];
      const float2 got = make_float2(__shfl_xor_sync(0xffffffffu, send.x, 1), __shfl_xor_sync(0xffffffffu, send.y, 1));
      const float4 out = odd ? make_float4(got.x, got.y, p[2 * jp + 1].x, p[2 * jp + 1].y)
                             : make_float4(p[2 * jp].x, p[2 * jp].y, got.x, got.y);
      const int n = odd ? (j + 1) * 8 + 2 * (q - 1) : j * 8 + 2 * q;
      if (pho < Hp && pwo < Wp) *reinterpret_cast<float4*>(a.y + row + n) = out;
    }
  };
  // A tile's store, after its last chunk's products (the chunk's stage
  // `stg`); then its sums restart from zero.
  auto epilogue = [&](int tile, int stg) {
    const int t = t0 + tile * tstride;
    const int h0 = (t / tw) * BH, w0 = (t % tw) * kSm90TW;
    if constexpr (POOL) {
      pool_epilogue(h0, w0, stg);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      return;
    }
    // A thread holds, of its tile row, columns 16·warp + lane/4 (+ 8) and of
    // each 8-channel group the pair (lane % 4)·2. Over a pair of groups
    // lanes q and q ^ 1 swap one pair, so that an even q stores channels
    // 2q .. 2q + 3 of the first group and an odd q channels 2(q − 1) .. of
    // the second: 16 bytes a lane. The skip's pairs are read first, all at
    // once.
    const int q = lane & 3;
    const bool odd = q & 1;
    const int ho = h0 + wg;
    float2 sk[2][BN / 8], sk2[2][SK2 ? BN / 8 : 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int wo = w0 + warp * 16 + h * 8 + (lane >> 2);
      const long long row = (static_cast<long long>(ho) * a.Wo + wo) * a.Co + n0;
      const bool ok = a.skip && ho < a.Ho && wo < a.Wo;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        sk[h][j] = ok ? *reinterpret_cast<const float2*>(a.skip + row + j * 8 + q * 2) : make_float2(0.f, 0.f);
        if constexpr (SK2)
          sk2[h][j] = ok ? *reinterpret_cast<const float2*>(a.skip2 + row + j * 8 + q * 2) : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int wo = w0 + warp * 16 + h * 8 + (lane >> 2);
      const bool ok = ho < a.Ho && wo < a.Wo;
      const long long row = (static_cast<long long>(ho) * a.Wo + wo) * a.Co + n0;
#pragma unroll
      for (int jp = 0; jp < BN / 16; ++jp) {
        float2 v[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * jp + jj;
          const float2 bias = *reinterpret_cast<const float2*>(bias_s + j * 8 + q * 2);
          v[jj] = make_float2(acc[4 * j + 2 * h] + bias.x, acc[4 * j + 2 * h + 1] + bias.y);
          v[jj] = make_float2(v[jj].x + sk[h][j].x, v[jj].y + sk[h][j].y);
          if constexpr (SK2) v[jj] = make_float2(v[jj].x + sk2[h][j].x, v[jj].y + sk2[h][j].y);
          v[jj] = make_float2(apply_act(v[jj].x, a.act), apply_act(v[jj].y, a.act));
        }
        const float2 send = odd ? v[0] : v[1];
        const float2 got = make_float2(__shfl_xor_sync(0xffffffffu, send.x, 1),
                                       __shfl_xor_sync(0xffffffffu, send.y, 1));
        const float4 out = odd ? make_float4(got.x, got.y, v[1].x, v[1].y)
                               : make_float4(v[0].x, v[0].y, got.x, got.y);
        const int n = odd ? (2 * jp + 1) * 8 + 2 * (q - 1) : 2 * jp * 8 + 2 * q;
        if (ok) *reinterpret_cast<float4*>(a.y + row + n) = out;
      }
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  };

  // Step g is chunk kt of the block's tile number `tile`, in ring stage
  // `stage`, whose barrier's phase of parity `phase` it waits for. Each
  // step: issue its products on the fragments split the step before, split
  // the next step's fragments into the other registers while they run, wait
  // for them (the epilogue after a tile's last chunk), meet (everyone has
  // read the stages of steps g and g + 1), and thread 0 refills step g's
  // stage with step g + NS.
  int kt = 0, tile = 0, stage = 0, phase = 0;
  {
    uint32_t fa[4][4], fs[4][4];
    uint32_t ga[4][4], gs[4][4];
    int g = 0;
    auto step = [&](uint32_t (&cur)[4][4], uint32_t (&cus)[4][4], uint32_t (&nxt)[4][4],
                    uint32_t (&nxs)[4][4]) {
#ifdef HDRTV_SM90_PHASES
      t_mark = clock64();
#endif
      products(kt, cur, cus);
      PHASE(4)
      const int nstage = stage + 1 == NS ? 0 : stage + 1, nphase = stage + 1 == NS ? phase ^ 1 : phase;
      if (g + 1 < steps) {
        mbar_wait(bars + 8 * nstage, nphase);
        PHASE(2)
        frags(nstage, nxt, nxs);
        PHASE(1)
      }
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(part);
      fence_tf32_frags(cur);  // the products read them until here
      fence_tf32_frags(cus);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
      PHASE(4)
      if (kt + 1 == KT) {
        epilogue(tile, stage);
        PHASE(5)
      }
      __syncthreads();
      if (tid == 0 && g + NS < steps) load_a(stage);
      PHASE(3)
      if (++kt == KT) kt = 0, ++tile;
      stage = nstage;
      phase = nphase;
      ++g;
    };
    if (steps) {
      mbar_wait(bars, 0);
      frags(0, fa, fs);
    }
    while (g < steps) {
      step(fa, fs, ga, gs);
      if (g < steps) step(ga, gs, fa, fs);
    }
  }
#ifdef HDRTV_SM90_PHASES
  t_phase[0] = clock64() - t_start;
  t_phase[7] = steps;
  if (a.phases && (tid & 127) == 0)
    for (int i = 0; i < 8; ++i) a.phases[(blockIdx.x * 2 + wg) * 8 + i] = t_phase[i];
#endif
#undef PHASE
}

template <int BN, int S, bool SK2 = false, bool POOL = false>
cudaError_t launch_tf32x3(Sm90Args<float>& a, const void* x, int H, int W, int cf, cudaStream_t stream) {
  using Cfg = Tf32Cfg<BN>;
  auto kernel = conv3x3_tf32x3_kernel<BN, S, SK2, POOL>;
  static DeviceCache cache;  // once per instantiation and device
  int resident = 0;
  cudaError_t err = resident_blocks(cache, kernel, kTf32Smem, &resident);
  if (err != cudaSuccess) return err;
  const int smem = Cfg::smem(a.per_list);
  if (smem > kTf32Smem) return cudaErrorInvalidValue;
  err = encode_a_map<float>(&a.tmap, x, H, W, cf, S, Cfg::BH);
  if (err != cudaSuccess) return err;
  kernel<<<sm90_grid(a.Ho, a.Wo, a.Co, BN, Cfg::BH, resident), kSm90Threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The N tile of a launch whose arguments are set (64 where it divides
// co_nat and the split weights fit, else 32), and the launch of instance
// POOL there.
template <int S, bool POOL>
cudaError_t launch_tf32x3_fit(Sm90Args<float>& a, const void* x, int H, int W, int cf, cudaStream_t stream) {
  if (a.co_nat % 64 == 0 && Tf32Cfg<64>::smem(a.per_list) <= kTf32Smem)
    return launch_tf32x3<64, S, false, POOL>(a, x, H, W, cf, stream);
  return launch_tf32x3<32, S, false, POOL>(a, x, H, W, cf, stream);
}

// The fp32 float conv of block_conv3 (S = 1) or down2 (S = 2), or one of
// trunk3's dense convs, on the 3×TF32 tile; arguments as conv3x3_sm90
// (sm90_setup), and the split weights of a list must fit in shared memory
// (per_list ≤ kTf32MaxList). `skip2` (with a skip; stride 1, a 32-channel N
// tile): the SK2 instance, the second skip added after the first.
template <int S>
cudaError_t conv3x3_tf32x3(const void* x, const void* w, const float* b, const void* skip, void* y, int H,
                           int W, int cf, int ch0, int C, int Co, int act, int a_sub, const int* table,
                           int per_list, cudaStream_t stream, Sm90Args<float>* args = nullptr,
                           const void* skip2 = nullptr) {
  Sm90Args<float> own;
  Sm90Args<float>& a = args ? *args : own;
  const cudaError_t err = sm90_setup(a, w, b, skip, y, H, W, S, cf, ch0, C, Co, act, a_sub, table, per_list);
  if (err != cudaSuccess) return err;
  if (per_list > kTf32MaxList) return cudaErrorInvalidValue;
  if (skip2) {
    a.skip2 = static_cast<const float*>(skip2);
    if constexpr (S == 1) {
      if (skip && a.co_nat % 64) return launch_tf32x3<32, 1, true>(a, x, H, W, cf, stream);
    }
    return cudaErrorInvalidValue;
  }
  return launch_tf32x3_fit<S, false>(a, x, H, W, cf, stream);
}

}  // namespace
}  // namespace hdrtv
