// conv_last — the tail's third launch (csrc/tail.cu; TPU kernel
// hdrtv_tpu/ops/megakernel.py:489, its body _tail_kernel :432, the pack at
// :478-480):
//     y   = conv3x3_same(h, w_last) + b_last + skip     (fp32 sum over h, w in T)
//     out = pack ? u16(int(clip(y, 0, 1)·65535 + 0.5)) as (H, 2, W, Cl/2) : y in T
// h (H, W, C) is zero outside the image, w_last (3, 3, C, Cl), b_last (Cl)
// fp32, skip (H, W, Cl). With pack, channel 6a + k of pixel (i, j) goes to
// out[i, a, j, k]. Rounding points: the sum and the adds in fp32, the pack's
// multiply and add rounded apart (no FMA moves the +0.5 boundary), one
// rounding to T unpacked.
//
// conv_last_kernel: the dense form (without the s2d declaration in either
// type, and the fp32 int8 body's; no frame program launches it; the s2d
// forms run conv_last_sm90_kernel in bf16 and conv_last_tf32x3_kernel in
// fp32, below). 12 output channels
// would use a tenth of the 128-wide conv tile, so it has its own. A block
// owns 8 rows × 16 columns of pixels, stages their one-pixel halo of h
// (10 × 18 pixels × C) and the whole weight (9·C × Cl, padded to 16 columns)
// in shared memory once, and each of its eight warps computes one row of 16
// pixels × 16 channels over the nine taps with no further barrier: bf16 on
// the tensor cores (mma.sync.m16n8k16, the A fragments read from the halo at
// the tap's offset with ldmatrix), fp32 on the FMA units (a lane owns one
// pixel and 8 channels). What holds it (tools/sm90_phases.py, PERF.md §5):
// the synchronous staging, h read 1.41 times and the whole weight re-read
// by each of a 1080p call's 4080 blocks, under no products.
#pragma once

#include <utility>

#include "conv3x3_sm90.cuh"
#include "conv3x3_tf32x3.cuh"
#include "pointwise.cuh"

namespace hdrtv {
namespace {

constexpr int kLastRows = 8, kLastCols = 16;  // pixels of a block; one row per warp
constexpr int kLastHalo = (kLastRows + 2) * (kLastCols + 2);
constexpr int kLastN = 16;  // output channels, padded

struct LastArgs {
  const void* h;     // (H, W, C) T
  const void* w;     // (3, 3, C, Cl) T
  const float* b;    // (Cl)
  const void* skip;  // (H, W, Cl) T
  void* out;         // (H, 2, W, Cl/2) u16 when pack, else (H, W, Cl) T
  int H, W, C, Cl, pack;
#ifdef HDRTV_SM90_PHASES
  unsigned long long* phases = nullptr;  // tools/sm90_phases.py: 8 clock64() sums per warp
#endif
};

template <typename T>
size_t conv_last_smem(int C) {
  return (static_cast<size_t>(kLastHalo) * (C + pw_pad<T>()) +
          static_cast<size_t>(9) * C * (kLastN + pw_pad<T>())) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kLastRows * 32) conv_last_kernel(LastArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
#ifdef HDRTV_SM90_PHASES
  unsigned long long t_start = clock64(), t_phase[8] = {0, 0, 0, 0, 0, 0, 0, 1}, t_mark = t_start;
#define LAST_PHASE(i) (t_phase[i] += clock64() - t_mark, t_mark = clock64());
#else
#define LAST_PHASE(i)
#endif
  const int pitch = a.C + pw_pad<T>();          // elements per halo pixel
  constexpr int wpitch = kLastN + pw_pad<T>();  // elements per weight row
  T* halo = reinterpret_cast<T*>(smem);
  T* ws = halo + kLastHalo * pitch;
  const T* h = static_cast<const T*>(a.h);
  const T* w = static_cast<const T*>(a.w);
  const int r0 = blockIdx.y * kLastRows;
  const int c0 = blockIdx.x * kLastCols;

  const int quads = a.C / 4;
  for (int idx = threadIdx.x; idx < kLastHalo * quads; idx += blockDim.x) {
    const int px = idx / quads;
    const int q = idx - px * quads;
    const int gi = r0 + px / (kLastCols + 2) - 1;
    const int gj = c0 + px % (kLastCols + 2) - 1;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gi >= 0 && gi < a.H && gj >= 0 && gj < a.W)
      v = load4<T>(h + (static_cast<long long>(gi) * a.W + gj) * a.C + q * 4);
    store4<T>(halo + px * pitch + q * 4, v);
  }
  for (int idx = threadIdx.x; idx < 9 * a.C * (kLastN / 4); idx += blockDim.x) {
    const int k = idx / (kLastN / 4);
    const int q = idx - k * (kLastN / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q * 4 < a.Cl) v = load4<T>(w + static_cast<long long>(k) * a.Cl + q * 4);
    store4<T>(ws + k * wpitch + q * 4, v);
  }
  __syncthreads();
  LAST_PHASE(1)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gi = r0 + warp;

  // y for the channel pair (n, n + 1) of pixel column px of this warp's row.
  auto emit = [&](int px, int n, float v0, float v1) {
    const int gj = c0 + px;
    if (gi >= a.H || gj >= a.W || n >= a.Cl) return;
    const long long m = static_cast<long long>(gi) * a.W + gj;
    const float2 bias = *reinterpret_cast<const float2*>(a.b + n);
    const float2 sk = load2<T>(static_cast<const T*>(a.skip) + m * a.Cl + n);
    const float y0 = (v0 + bias.x) + sk.x;
    const float y1 = (v1 + bias.y) + sk.y;
    if (!a.pack) {
      store2<T>(static_cast<T*>(a.out) + m * a.Cl + n, make_float2(y0, y1));
      return;
    }
    const int half = a.Cl / 2;
    const int par = n / half;
    ushort2 u;
    u.x = static_cast<unsigned short>(
        static_cast<int>(__fadd_rn(__fmul_rn(fminf(fmaxf(y0, 0.f), 1.f), 65535.f), 0.5f)));
    u.y = static_cast<unsigned short>(
        static_cast<int>(__fadd_rn(__fmul_rn(fminf(fmaxf(y1, 0.f), 1.f), 65535.f), 0.5f)));
    uint16_t* out = static_cast<uint16_t*>(a.out);
    *reinterpret_cast<ushort2*>(out + ((static_cast<long long>(gi) * 2 + par) * a.W + gj) * half +
                                n - par * half) = u;
  };

  if constexpr (std::is_same<T, bf16>::value) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int tap = 0; tap < 9; ++tap) {
      const T* arow = halo + ((warp + tap / 3) * (kLastCols + 2) + tap % 3 + lane % 16) * pitch +
                      (lane / 16) * 8;
      const T* brow = ws + (tap * a.C + lane % 8 + ((lane / 8) % 2) * 8) * wpitch + (lane / 16) * 8;
      for (int kk = 0; kk < a.C; kk += 16) {
        unsigned af[4], bf[4];
        ldmatrix_x4(af, arow + kk);
        ldmatrix_x4_trans(bf, brow + kk * wpitch);
        mma_bf16_16816(acc[0], af, bf[0], bf[1]);
        mma_bf16_16816(acc[1], af, bf[2], bf[3]);
      }
    }
#ifdef HDRTV_SM90_PHASES
    // the products' results, before the epilogue reads them
    asm volatile("" ::"f"(acc[0][0]), "f"(acc[1][3]) : "memory");
#endif
    LAST_PHASE(2)
    // Of each 16 × 8 result a lane holds rows lane/4 and lane/4 + 8, column pair (lane%4)·2.
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        emit(lane / 4 + hh * 8, nt * 8 + (lane % 4) * 2, acc[nt][2 * hh], acc[nt][2 * hh + 1]);
  } else {
    const int px = lane % 16;
    const int n0 = (lane / 16) * 8;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int tap = 0; tap < 9; ++tap) {
      const T* arow = halo + ((warp + tap / 3) * (kLastCols + 2) + tap % 3 + px) * pitch;
      const T* brow = ws + tap * a.C * wpitch + n0;
      for (int kk = 0; kk < a.C; kk += 4) {
        const float4 xv = load4<T>(arow + kk);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 w0 = load4<T>(brow + (kk + j) * wpitch);
          const float4 w1 = load4<T>(brow + (kk + j) * wpitch + 4);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = fmaf(xs[j], wv[e], acc[e]);
        }
      }
    }
    LAST_PHASE(2)
#pragma unroll
    for (int e = 0; e < 8; e += 2) emit(px, n0 + e, acc[e], acc[e + 1]);
  }
  LAST_PHASE(3)
#ifdef HDRTV_SM90_PHASES
  t_phase[0] = clock64() - t_start;
  if (a.phases && lane == 0)
    for (int i = 0; i < 8; ++i)
      a.phases[((static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * kLastRows + warp) * 8 + i] =
          t_phase[i];
#endif
#undef LAST_PHASE
}

template <typename T>
cudaError_t launch_conv_last(const LastArgs& a, cudaStream_t stream) {
  static DeviceCache cache;
  const cudaError_t attr = allow_large_smem(cache, conv_last_kernel<T>);
  if (attr != cudaSuccess) return attr;
  const size_t bytes = conv_last_smem<T>(a.C);
  if (bytes > kMaxDynSmem || a.C % 16 || a.Cl % 4 || a.Cl > kLastN) return cudaErrorInvalidValue;
  const dim3 grid((a.W + kLastCols - 1) / kLastCols, (a.H + kLastRows - 1) / kLastRows);
  conv_last_kernel<T><<<grid, kLastRows * 32, bytes, stream>>>(a);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// conv_last_sm90_kernel: the s2d form in bf16 (the tail's s2d=True calls, the
// frame programs' float and int8 bodies, packed and unpacked), C = 128, Cl =
// 12. w_last is a w_s2d_s1 transform: output sub-position so (its 3
// channels 3·so + rgb) reads 9 of the 36 (tap, input sub-position) slots of
// models/s2d.py s2d_slots(1), 288 of the dense 1152 K. Over the four
// sub-positions 16 slots are populated: the centre tap's 4 feed all four,
// each edge tap's 2 feed two, each corner tap's 1 feeds one (36 (slot, so)
// pairs). The kernel's K walks exactly those 16 slots (ops/megakernel.py
// conv_last_walk hands it the list with each slot's sub-positions; the
// launcher refuses another).
//
// Bound on this card: bytes. A 1080p call reads h once (540 × 960 × 128
// bf16, 133 MB) and the skip (12 MB) and writes 12 MB: 0.047 ms at 3.35
// TB/s, against 3.6 GFLOP of non-zero products. So the design spends its
// effort on reading h once, early, and in large pieces, and on spending
// few tensor-core instructions: on an H100 mma.sync's products, not the
// loads, hold an N tile of 8 per sub-position (72 mma.sync a warp and row,
// 0.077 ms a 1080p call; tools/sm90_phases.py: the products still draining
// in the epilogue's 46% of a warp's cycles). N tiles by row parity (below)
// take 48 and 0.069 ms (PERF.md §6).
// mma.sync rather than wgmma: a warp's 16 pixels are one m16 tile, so the
// centre tap's A fragments, loaded once by ldmatrix, feed both parities'
// products from registers.
//
// Blocks: 4 warps, two blocks per SM, persistent. The frame is cut into
// bands of 64 s2d columns; the (band, row) steps in band-major order are
// split into as many contiguous ranges as blocks, so a block walks down one
// band (or the end of one and the top of the next), one output row of 64
// pixels a step, warp w owning pixels [16w, 16w + 16).
//
// Loads. A step needs input rows r − 1, r, r + 1 of its band with one halo
// column each side: a ring of NS = 5 stages, one input row each, filled by
// TMA (two boxes of 64 channels × 66 columns, 128-byte rows in the 128-byte
// swizzle, one mbarrier a stage). Rows and columns outside the image read
// as zero (TMA's fill: the 'same' padding, and h is zero there by the
// contract). Each row is loaded once per run down the band, so h is read
// (66/64)·(1 + 2/run) ≈ 1.1 times at 1080p. While a step multiplies, the
// next two rows are in flight; thread 0 refills the stage of the window's
// top row after the step's meeting.
//
// N tiles: one a row parity a, its 8 columns the 6 channels 6a + n (n < 6:
// sub-positions 2a and 2a + 1, RGB each; the packed output's parity row)
// and 2 of padding. A slot feeds parity a where it feeds either of its
// sub-positions: 24 (slot, parity) pairs; where it feeds only one of the
// two, the other's 3 columns hold zeros, as the padding does.
//
// Weights: at the start each block copies the populated slots' weight rows
// (16 slots × 32 channels × 12 outputs, 12 KB, 768 contiguous bytes a slot)
// into shared memory, and each lane then keeps its B fragments of the 24
// pairs in registers (two k16 steps a pair: 96 registers), so the loop
// reads only h from shared memory.
//
// Products: for each of the 16 slots and its two k16 halves one ldmatrix.x4
// of 16 pixels × 16 channels at the tap's row stage and column shift (the
// 128-byte swizzle's XOR applied in each lane's row address: a one-pixel
// shift is one 128-byte box row), then one mma.sync.m16n8k16 per parity
// the slot feeds, into that parity's accumulator: 48 a warp and row. Each
// output channel sums the same slots in the same order as with one tile a
// sub-position.
//
// Epilogue: the skip row of the next step is copied into shared memory by
// 8-byte cp.async under this step's products (any W: a pixel's 24 bytes are
// 8-aligned); each lane computes (acc + b) + skip in fp32 for its pixels
// and channel pairs, packs (multiply and add rounded apart, truncated) or
// rounds to bf16, and writes the staged output row; after the next meeting all
// threads store it with 16-byte stores (4-byte where the row is not 16-byte
// aligned), one contiguous run of 64 pixels per row parity packed (768
// bytes each) or unpacked (1536 bytes). Pixels past the image's edge are
// not stored.
// ---------------------------------------------------------------------------

constexpr int kLastSm90TW = 64;                          // output pixels of a band row: 4 warps × 16
constexpr int kLastSm90Threads = 128;
constexpr int kLastSm90BoxBytes = (kLastSm90TW + 2) * 128;  // one box: 66 pixels × 64 channels
constexpr int kLastSm90Box = 9 * 1024;                   // a box's place, 1024-aligned for the swizzle
constexpr int kLastSm90Stage = 2 * kLastSm90Box;         // one input row of a band: channels [0, 64), [64, 128)
constexpr int kLastSm90NS = 5;                           // the window's 3 rows and 2 ahead
constexpr int kLastSm90Slots = 16;                       // populated (tap, input sub-position) slots
constexpr int kLastSm90Pairs = 24;                       // (slot, row parity) pairs the slots feed
constexpr int kLastSm90Row = kLastSm90TW * 12 * 2;       // a band row of skip or output: 1536 bytes
constexpr int kLastSm90SlotBytes = 32 * 12 * 2;          // a slot's weight rows: 768 bytes
constexpr int kLastSm90WBytes = kLastSm90Slots * kLastSm90SlotBytes;
// shared memory: [1024-byte alignment][the ring][the weights, then 2 skip and 2 output rows][NS barriers]
constexpr int kLastSm90Smem = 1024 + kLastSm90NS * kLastSm90Stage + kLastSm90WBytes + 8 * kLastSm90NS;
static_assert(4 * kLastSm90Row <= kLastSm90WBytes, "the skip and output rows take the weights' place");

// The output sub-positions (bit so) that read input sub-position si at tap
// 3·(δI + 1) + δJ + 1: the natural offset 2δ + a_in − a_out lies in [−1, 1]
// along both axes (models/s2d.py _s2d_taps(1)).
__host__ __device__ constexpr int last_so_mask(int tap, int si) {
  int m = 0;
  for (int so = 0; so < 4; ++so) {
    const int di = 2 * (tap / 3 - 1) + si / 2 - so / 2, dj = 2 * (tap % 3 - 1) + si % 2 - so % 2;
    if (di >= -1 && di <= 1 && dj >= -1 && dj <= 1) m |= 1 << so;
  }
  return m;
}

// 4·tap + si of the walk's slot s, in (tap, si) order.
__host__ __device__ constexpr int last_slot_key(int s) {
  for (int key = 0, n = 0; key < 36; ++key)
    if (last_so_mask(key / 4, key % 4) && n++ == s) return key;
  return -1;
}

__host__ __device__ constexpr int last_popc(int m) { return (m & 1) + (m >> 1 & 1) + (m >> 2 & 1) + (m >> 3 & 1); }

// The row parities (bit a: sub-positions 2a, 2a + 1) slot s feeds.
__host__ __device__ constexpr int last_par_mask(int s) {
  const int m = last_so_mask(last_slot_key(s) / 4, last_slot_key(s) % 4);
  return ((m & 3) ? 1 : 0) | ((m & 12) ? 2 : 0);
}

// The register slot of pair (slot s, parity a): the pairs before it in the walk.
__host__ __device__ constexpr int last_pair(int s, int a) {
  int n = 0;
  for (int t = 0; t < s; ++t) n += last_popc(last_par_mask(t));
  return n + last_popc(last_par_mask(s) & ((1 << a) - 1));
}

// The walk's entry for slot s as ops/megakernel.py conv_last_walk encodes it: tap | si << 4 | so mask << 8.
__host__ __device__ constexpr int last_walk_entry(int s) {
  return last_slot_key(s) / 4 | (last_slot_key(s) % 4) << 4 | last_so_mask(last_slot_key(s) / 4, last_slot_key(s) % 4)
                                                                   << 8;
}

static_assert(last_pair(kLastSm90Slots - 1, 1) == kLastSm90Pairs - 1 && last_slot_key(kLastSm90Slots) == -1,
              "16 slots, 24 pairs");

struct LastSm90Args {
  CUtensorMap hmap;  // h as (H, W, 128) bf16, box (64 channels, 66 columns, 1 row), 128-byte swizzle
  const bf16* w;     // (3, 3, 128, 12)
  const float* b;    // (12)
  const bf16* skip;  // (H, W, 12)
  void* out;         // (H, 2, W, 6) u16 packed, or (H, W, 12) bf16
  int H, W, pack, bands;
#ifdef HDRTV_SM90_PHASES
  unsigned long long* phases = nullptr;  // tools/sm90_phases.py: 8 clock64() sums per warp
#endif
};

__device__ __forceinline__ void ldmatrix_x4_at(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Thread 0's TMA load of one box (its bytes counted by the stage's expect_tx).
__device__ __forceinline__ void tma_load_3d(const CUtensorMap* map, unsigned dst, unsigned bar, int c, int w, int h) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h)
      : "memory");
}

// B fragments of pair (slot S, parity A) from the staged weight rows: k16
// step f / 2, half f % 2 (its rows 8·(f % 2)..), this lane's k pair
// (lane % 4)·2 and column n = lane / 4, channel 6A + n (zero for the
// padding and for a sub-position the slot does not feed).
template <int S, int A>
__device__ __forceinline__ void last_load_b_pair(unsigned (&bw)[kLastSm90Pairs][4], const bf16* ws, int lane) {
  if constexpr ((last_par_mask(S) >> A) & 1) {
    constexpr int P = last_pair(S, A);
    constexpr int m = last_so_mask(last_slot_key(S) / 4, last_slot_key(S) % 4);
    const int n = lane >> 2, k0 = (lane & 3) * 2;
    const bool live = n < 6 && ((m >> (2 * A + n / 3)) & 1);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int k = (f >> 1) * 16 + (f & 1) * 8 + k0;
      unsigned v = 0;
      if (live) {
        const unsigned short lo = __bfloat16_as_ushort(ws[(S * 32 + k) * 12 + A * 6 + n]);
        const unsigned short hi = __bfloat16_as_ushort(ws[(S * 32 + k + 1) * 12 + A * 6 + n]);
        v = static_cast<unsigned>(lo) | static_cast<unsigned>(hi) << 16;
      }
      bw[P][f] = v;
    }
  }
}

template <int... S>
__device__ __forceinline__ void last_load_b(unsigned (&bw)[kLastSm90Pairs][4], const bf16* ws, int lane,
                                            std::integer_sequence<int, S...>) {
  ((last_load_b_pair<S, 0>(bw, ws, lane), last_load_b_pair<S, 1>(bw, ws, lane)), ...);
}

template <int S, int A, int KS>
__device__ __forceinline__ void last_mma(float (&acc)[2][4], const unsigned (&af)[4],
                                         const unsigned (&bw)[kLastSm90Pairs][4]) {
  if constexpr ((last_par_mask(S) >> A) & 1) {
    constexpr int P = last_pair(S, A);
    mma_bf16_16816(acc[A], af, bw[P][2 * KS], bw[P][2 * KS + 1]);
  }
}

// Slot S's products: its two k16 halves, each one ldmatrix.x4 of the
// warp's 16 pixels at the tap's row stage row[δI + 1] and column shift
// (px, xr: this lane's box row offset and swizzle XOR at shift δJ + 1),
// multiplied into every parity the slot feeds.
template <int S, int KS>
__device__ __forceinline__ void last_slot_half(float (&acc)[2][4], const unsigned (&bw)[kLastSm90Pairs][4],
                                               const unsigned (&row)[3], const int (&px)[3], const int (&xr)[3]) {
  constexpr int tap = last_slot_key(S) / 4, si = last_slot_key(S) % 4;
  constexpr int c0 = (si & 1) * 4 + KS * 2;  // the 16-byte piece of the box row: channels (si % 2)·32 + 16·KS
  unsigned af[4];
  ldmatrix_x4_at(af, row[tap / 3] + (si >> 1) * kLastSm90Box + px[tap % 3] + ((c0 ^ xr[tap % 3]) << 4));
  last_mma<S, 0, KS>(acc, af, bw);
  last_mma<S, 1, KS>(acc, af, bw);
}

template <int... S>
__device__ __forceinline__ void last_products(float (&acc)[2][4], const unsigned (&bw)[kLastSm90Pairs][4],
                                              const unsigned (&row)[3], const int (&px)[3], const int (&xr)[3],
                                              std::integer_sequence<int, S...>) {
  ((last_slot_half<S, 0>(acc, bw, row, px, xr), last_slot_half<S, 1>(acc, bw, row, px, xr)), ...);
}

// n bytes from shared to global memory by the block: 16 bytes a thread
// where dst and n allow, else 4.
__device__ __forceinline__ void last_store_row(const unsigned char* src, unsigned char* dst, int n, int tid,
                                               int threads = kLastSm90Threads) {
  if (((reinterpret_cast<uintptr_t>(dst) | static_cast<uintptr_t>(n)) & 15) == 0) {
    for (int i = tid * 16; i < n; i += threads * 16)
      *reinterpret_cast<uint4*>(dst + i) = *reinterpret_cast<const uint4*>(src + i);
  } else {
    for (int i = tid * 4; i < n; i += threads * 4)
      *reinterpret_cast<unsigned*>(dst + i) = *reinterpret_cast<const unsigned*>(src + i);
  }
}

__global__ void __launch_bounds__(kLastSm90Threads, 2) conv_last_sm90_kernel(const __grid_constant__ LastSm90Args a) {
  constexpr int NS = kLastSm90NS;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(smem_raw));
  const unsigned base = (raw + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);
  unsigned char* const wsm = smem + NS * kLastSm90Stage;  // the weights; then skip rows 0, 1 and output rows 0, 1
  const unsigned bars = base + NS * kLastSm90Stage + kLastSm90WBytes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#ifdef HDRTV_SM90_PHASES
  unsigned long long t_start = clock64(), t_phase[8] = {0, 0, 0, 0, 0, 0, 0, 0}, t_mark = t_start;
#define LAST_PHASE(i) (t_phase[i] += clock64() - t_mark, t_mark = clock64());
#else
#define LAST_PHASE(i)
#endif

  // this block's steps: (band, row) g in [g0, g1) of the band-major walk
  const int total = a.bands * a.H;
  const int g0 = static_cast<int>(static_cast<long long>(blockIdx.x) * total / gridDim.x);
  const int g1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * total / gridDim.x);

  for (int idx = tid; idx < kLastSm90Slots * (kLastSm90SlotBytes / 16); idx += kLastSm90Threads) {
    const int s = idx / (kLastSm90SlotBytes / 16), piece = idx - s * (kLastSm90SlotBytes / 16);
    const int key = last_slot_key(s);
    cp_async16(wsm + s * kLastSm90SlotBytes + piece * 16,
               reinterpret_cast<const unsigned char*>(a.w) + ((key / 4) * 128 + (key % 4) * 32) * 24 + piece * 16);
  }
  cp_async_commit();
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0's loads: ordinal pn into stage pn % NS; input row pr of band pb,
  // the current run's rows ending at pend (its last output row + 1).
  int pn = 0, pb = g0 / a.H, pr = g0 % a.H - 1, pend = min(g1 - pb * a.H, a.H);
  auto produce = [&](int limit) {
    while (pn < limit && pb >= 0) {
      const int stage = pn % NS;
      const unsigned bar = bars + 8 * stage, dst = base + stage * kLastSm90Stage;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(2 * kLastSm90BoxBytes)
                   : "memory");
      tma_load_3d(&a.hmap, dst, bar, 0, pb * kLastSm90TW - 1, pr);
      tma_load_3d(&a.hmap, dst + kLastSm90Box, bar, 64, pb * kLastSm90TW - 1, pr);
      ++pn;
      if (++pr > pend) {
        if ((pb + 1) * a.H < g1) {
          ++pb;
          pr = -1;
          pend = min(g1 - pb * a.H, a.H);
        } else {
          pb = -1;
        }
      }
    }
  };
  if (tid == 0) produce(NS);

  unsigned bw[kLastSm90Pairs][4];
  cp_async_wait<0>();
  __syncthreads();
  last_load_b(bw, reinterpret_cast<const bf16*>(wsm), lane, std::make_integer_sequence<int, kLastSm90Slots>{});
  const int q = lane & 3;
  float bias[2][2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias[t][e] = q < 3 ? a.b[t * 6 + 2 * q + e] : 0.f;
  // this lane's ldmatrix row: pixel 16·warp + lane % 16 of the band, at column shift dj ∈ {0, 1, 2}
  int px[3], xr[3];
#pragma unroll
  for (int dj = 0; dj < 3; ++dj) {
    const int p = warp * 16 + (lane & 15) + dj;
    px[dj] = p * 128;
    xr[dj] = (lane >> 4) ^ (p & 7);
  }
  __syncthreads();  // the weights are in registers: their place takes the skip and output rows

  // The skip row of step g into skip row buf, 8 bytes a piece.
  auto prefetch_skip = [&](int g, int buf) {
    const int band = g / a.H, r = g - band * a.H, j0 = band * kLastSm90TW, valid = min(kLastSm90TW, a.W - j0);
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(a.skip) + (static_cast<long long>(r) * a.W + j0) * 24;
    unsigned char* dst = wsm + buf * kLastSm90Row;
    for (int i = tid; i < valid * 3; i += kLastSm90Threads) cp_async8(dst + i * 8, src + i * 8);
    cp_async_commit();
  };
  // The staged output row buf of step g to device memory.
  auto store_out = [&](int g, int buf) {
    const int band = g / a.H, r = g - band * a.H, j0 = band * kLastSm90TW, valid = min(kLastSm90TW, a.W - j0);
    const unsigned char* src = wsm + (2 + buf) * kLastSm90Row;
    unsigned char* out = static_cast<unsigned char*>(a.out);
    if (a.pack) {
      for (int par = 0; par < 2; ++par)
        last_store_row(src + par * (kLastSm90Row / 2), out + ((static_cast<long long>(r) * 2 + par) * a.W + j0) * 12,
                       valid * 12, tid);
    } else {
      last_store_row(src, out + (static_cast<long long>(r) * a.W + j0) * 24, valid * 24, tid);
    }
  };
  if (g0 < g1) prefetch_skip(g0, 0);
  LAST_PHASE(1)

  int top = 0;  // the load ordinal of the window's top row
  for (int g = g0; g < g1; ++g) {
    const int k = g - g0, buf = k & 1;
    const int r = g % a.H;
    unsigned row[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int l = top + d;
      mbar_wait(bars + 8 * (l % NS), (l / NS) & 1);
      row[d] = base + (l % NS) * kLastSm90Stage;
    }
    LAST_PHASE(2)
    float acc[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    last_products(acc, bw, row, px, xr, std::make_integer_sequence<int, kLastSm90Slots>{});
#ifdef HDRTV_SM90_PHASES
    asm volatile("" ::"f"(acc[0][0]), "f"(acc[1][3]) : "memory");
#endif
    LAST_PHASE(3)
    // This step's skip row is in; the window's top row is read; the last step's output row is staged.
    cp_async_wait<0>();
    __syncthreads();
    top += r + 1 == a.H ? 3 : 1;  // a new band starts a new run: its top halo row and its first row
    if (tid == 0) produce(top + NS);
    if (g + 1 < g1) prefetch_skip(g + 1, buf ^ 1);
    LAST_PHASE(4)
    if (g > g0) store_out(g - 1, buf ^ 1);
    // (acc + b) + skip for this lane's pixels 16·warp + lane/4 (+ 8) and channels 6t + 2q (+ 1) of parity t, q < 3
    if (q < 3) {
      const bf16* sk = reinterpret_cast<const bf16*>(wsm + buf * kLastSm90Row);
      unsigned char* ob = wsm + (2 + buf) * kLastSm90Row;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = warp * 16 + (lane >> 2) + 8 * hh, ch = t * 6 + 2 * q;
          const float2 sv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sk + p * 12 + ch));
          const float y0 = __fadd_rn(__fadd_rn(acc[t][2 * hh], bias[t][0]), sv.x);
          const float y1 = __fadd_rn(__fadd_rn(acc[t][2 * hh + 1], bias[t][1]), sv.y);
          if (a.pack) {
            ushort2 u;
            u.x = static_cast<unsigned short>(
                static_cast<int>(__fadd_rn(__fmul_rn(fminf(fmaxf(y0, 0.f), 1.f), 65535.f), 0.5f)));
            u.y = static_cast<unsigned short>(
                static_cast<int>(__fadd_rn(__fmul_rn(fminf(fmaxf(y1, 0.f), 1.f), 65535.f), 0.5f)));
            *reinterpret_cast<ushort2*>(ob + t * (kLastSm90Row / 2) + (p * 6 + 2 * q) * 2) = u;
          } else {
            *reinterpret_cast<__nv_bfloat162*>(ob + (p * 12 + ch) * 2) = __floats2bfloat162_rn(y0, y1);
          }
        }
    }
    LAST_PHASE(5)
  }
  __syncthreads();
  if (g1 > g0) store_out(g1 - 1, (g1 - 1 - g0) & 1);
#ifdef HDRTV_SM90_PHASES
  t_phase[0] = clock64() - t_start;
  t_phase[7] = g1 - g0;
  if (a.phases && lane == 0)
    for (int i = 0; i < 8; ++i) a.phases[(static_cast<long long>(blockIdx.x) * 4 + warp) * 8 + i] = t_phase[i];
#endif
#undef LAST_PHASE
}

// h's TMA map: (128, W, H) bf16 innermost first, a box of 64 channels × 66
// columns × 1 row in the 128-byte swizzle; out-of-image pixels read as zero.
inline cudaError_t encode_last_h_map(CUtensorMap* map, const void* h, int H, int W) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {128, static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H)};
  const cuuint64_t strides[2] = {256, static_cast<cuuint64_t>(W) * 256};
  const cuuint32_t box[3] = {64, kLastSm90TW + 2, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(h), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// conv_last's s2d form: h (H, W, 128), w (3, 3, 128, 12) bf16, b (12) fp32,
// skip (H, W, 12) bf16 → out, packed or bf16. `walk`: the 16 slots it is
// to walk (tap | si << 4 | so mask << 8); any other list, or other widths,
// is refused (cudaErrorInvalidValue). `args` as conv3x3_s8_sm90's.
inline cudaError_t conv_last_sm90(const void* h, const void* w, const float* b, const void* skip, void* out, int H,
                                  int W, int C, int Cl, int pack, const int* walk, cudaStream_t stream,
                                  LastSm90Args* args = nullptr) {
  if (C != 128 || Cl != 12 || H < 1 || W < 1 || !walk) return cudaErrorInvalidValue;
  for (int s = 0; s < kLastSm90Slots; ++s)
    if (walk[s] != last_walk_entry(s)) return cudaErrorInvalidValue;
  LastSm90Args own;
  LastSm90Args& a = args ? *args : own;
  a.w = static_cast<const bf16*>(w);
  a.b = b;
  a.skip = static_cast<const bf16*>(skip);
  a.out = out;
  a.H = H;
  a.W = W;
  a.pack = pack;
  a.bands = (W + kLastSm90TW - 1) / kLastSm90TW;
  cudaError_t err = encode_last_h_map(&a.hmap, h, H, W);
  static DeviceCache cache;
  int resident = 0;
  if (err == cudaSuccess) err = resident_blocks(cache, conv_last_sm90_kernel, kLastSm90Smem, &resident,
                                                kLastSm90Threads);
  if (err != cudaSuccess) return err;
  const int grid = std::min(a.bands * H, resident);
  conv_last_sm90_kernel<<<grid, kLastSm90Threads, kLastSm90Smem, stream>>>(a);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// conv_last_tf32x3_kernel: the s2d form in fp32 (the tail's fp32 s2d=True
// calls, packed and unpacked), C = 128, Cl = 12, the same 16 slots and 24
// (slot, row parity) pairs as conv_last_sm90_kernel, and its plan: persistent
// blocks walking down bands of 64 columns, one output row a step, h's rows
// fed once by TMA through a ring (one mbarrier a stage), the skip row of the
// next step prefetched by cp.async under this step's products, the output
// row staged and stored in 16-byte pieces after the next meeting.
//
// Where fp32 differs from the bf16 tile:
// - A pixel of h is 512 bytes: a stage (one input row of the band) is four
//   boxes of 32 fp32 channels × 66 columns, one per input sub-position si,
//   128-byte rows in the 128-byte swizzle (36 KB with the boxes' 1024-byte
//   alignment). A ring of NS = 4 (the window's three rows and one ahead)
//   beside the weights below takes 213 KB: one block per SM. Two would need
//   stages of a quarter of that (32-column bands), whose halo columns and
//   per-block weights cost more than the second block's warps bring.
// - Products: 3×TF32 on mma.sync.m16n8k8 (fp32 += tf32 × tf32): each
//   operand split by cvt.rna into big and small TF32 halves (split_tf32, as
//   the 3×TF32 conv tile), small·big + big·small + big·big. mma.sync, as the
//   bf16 tile: a warp's 16 pixels are one m16 tile, and a slot's A
//   fragments, loaded once, feed both parities' products. Per slot, per k8
//   step j (channels 8j .. 8j + 7 of sub-position si), one ldmatrix.x4
//   reads the warp's 16 pixels × 8 channels at the tap's row stage and
//   column shift (32-bit elements are pairs of b16: the four 8 × 8 b16
//   matrices are pixels 0-7 and 8-15 of 16-byte chunks 2j and 2j + 1, which
//   is m16n8k8's tf32 A fragment), split in registers. Tried on wgmma
//   m64n16k8 (one warpgroup, N = 16 over both parities, 192 wgmmas a row):
//   0.401 ms, 0.413 with four slots' chains interleaved, against this
//   form's 0.268 (PERF.md §6): a small-N wgmma costs about as much as a
//   large one.
// - Eight warps, K split in two: warp w < 4 walks slots 0-7 and warp w + 4
//   slots 8-15 of the same 16 pixels (12 of the 24 pairs each). With four
//   warps (one a scheduler) the tile ran at 0.357 ms. After the products
//   the halves trade one parity's sums through shared memory (two buffers,
//   by step), and warp w finishes parity 0, warp w + 4 parity 1: y = (slots
//   0-7) + (slots 8-15), in fp32. What holds it now: tf32 mma.sync's rate
//   (144 a warp and row, two warps a scheduler; tools/sm90_phases.py).
// - Sums: each slot's 32 channels (4 k8 steps × 3 products, for each parity
//   it feeds) are summed in the tensor cores from zero and the slot sums
//   added to the half's accumulator in fp32, in the walk's order.
// - Weights: the B fragments no longer fit in registers (their TF32 big and
//   small halves would take 384 a lane), so each block splits them once
//   into shared memory in fragment order: per (pair, k8 step) 16 bytes a
//   lane (b0, b1 big; b0, b1 small), 48 KB, one conflict-free 16-byte load
//   a lane per (pair, k8 step); the slots' keys and pair numbers come in the
//   arguments.
// - The skip is fp32 (a pixel's 48 bytes, 16-byte pieces), and the unpacked
//   output fp32.
// Rounding as conv_last_kernel's: (acc + b) + skip in fp32, the pack's
// multiply and add rounded apart, truncated.
//
// Products against the FMA units: the 3.6 GFLOP of non-zero products at
// 1080p take 0.054 ms at the FMA rate, but an FMA tile reads a weight for
// every one or two multiply-adds from shared memory (a lane owns one pixel;
// the weights do not fit its registers), which its shared-memory port
// would not sustain; here a 16-byte fragment load feeds 3 mma.sync of
// 16 × 8 × 8. Bound on this card: bytes (h 265 MB, skip 25 MB and the
// packed 12 MB once, 0.090 ms at 3.35 TB/s); the non-zero products at a
// third of the TF32 rate take 0.022 ms, the padded ones (24 pairs × 8
// columns) 0.039 ms. Times: PERF.md §6.
// ---------------------------------------------------------------------------

constexpr int kLastF32Threads = 256;                       // 8 warps: 4 pixel groups × 2 halves of the slots
constexpr int kLastF32BoxBytes = (kLastSm90TW + 2) * 128;  // one box: 66 pixels × 32 fp32 channels
constexpr int kLastF32Box = 9 * 1024;                      // a box's place, 1024-aligned for the swizzle
constexpr int kLastF32Stage = 4 * kLastF32Box;             // one input row: sub-positions 0 .. 3
constexpr int kLastF32NS = 4;                              // the window's 3 rows and 1 ahead
constexpr int kLastF32BBytes = kLastSm90Pairs * 4 * 32 * 16;  // B fragments: (pair, k8 step, lane) 16 bytes
constexpr int kLastF32Row = kLastSm90TW * 12 * 4;            // a band row of fp32 skip or output: 3072 bytes
constexpr int kLastF32Xchg = 8 * 32 * 16;                    // one step's traded sums: a float4 per lane
constexpr int kLastF32Mid = 8;                               // the slots of the first half: 0 .. 7
static_assert(last_pair(kLastF32Mid, 0) == kLastSm90Pairs / 2, "the halves hold 12 pairs each");
// shared memory: [1024-byte alignment][the ring][B fragments][2 skip rows][2 output rows][2 trades][NS barriers]
constexpr int kLastF32Smem =
    1024 + kLastF32NS * kLastF32Stage + kLastF32BBytes + 4 * kLastF32Row + 2 * kLastF32Xchg + 8 * kLastF32NS;
static_assert(kLastF32Smem <= 227 * 1024, "one block per SM");

struct LastF32Args {
  CUtensorMap hmap;   // h as (H, W, 128) fp32, box (32 channels, 66 columns, 1 row), 128-byte swizzle
  const float* w;     // (3, 3, 128, 12)
  const float* b;     // (12)
  const float* skip;  // (H, W, 12)
  void* out;          // (H, 2, W, 6) u16 packed, or (H, W, 12) fp32
  int H, W, pack, bands;
  int key[kLastSm90Slots];      // slot s's 4·tap + si
  int pair[kLastSm90Slots][2];  // its pair of parity p, or −1 where it feeds none of p's sub-positions
#ifdef HDRTV_SM90_PHASES
  unsigned long long* phases = nullptr;  // tools/sm90_phases.py: 8 clock64() sums per warp
#endif
};

// d += a·b on mma.sync.m16n8k8, tf32 operands, fp32 accumulator. Not
// volatile: a function of its registers, which the compiler may schedule
// among the (volatile, ordered) ldmatrix loads.
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Slot S's products for parity A at k8 step J into part[A], if S feeds A:
// small·big, big·small, big·big, the fragment of (pair, J) read for this lane.
template <int S, int A>
__device__ __forceinline__ void last_f32_mma(float (&part)[2][4], const uint32_t (&ab)[4], const uint32_t (&as)[4],
                                             const unsigned char* bfrag, int j, int lane) {
  if constexpr ((last_par_mask(S) >> A) & 1) {
    constexpr int P = last_pair(S, A);
    const uint4 f = *reinterpret_cast<const uint4*>(bfrag + ((P * 4 + j) * 32 + lane) * 16);
    mma_tf32_1688(part[A], as, f.x, f.y);
    mma_tf32_1688(part[A], ab, f.z, f.w);
    mma_tf32_1688(part[A], ab, f.x, f.y);
  }
}

// Slot S: its 32 channels (4 k8 steps) for each parity it feeds, summed from
// zero in the tensor cores, then added to acc in fp32. The A fragments of
// step j: ldmatrix.x4 of the warp's 16 pixels at the tap's row stage
// row[δI + 1], column shift (px, xr: this lane's box row offset and swizzle
// XOR at shift δJ + 1), 16-byte chunks 2j + lane / 16 of box si.
template <int S>
__device__ __forceinline__ void last_f32_slot(float (&acc)[2][4], const unsigned char* bfrag, const unsigned (&row)[3],
                                              const int (&px)[3], const int (&xr)[3], int lane) {
  constexpr int tap = last_slot_key(S) / 4, si = last_slot_key(S) % 4;
  float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    unsigned af[4];
    ldmatrix_x4_at(af, row[tap / 3] + si * kLastF32Box + px[tap % 3] + (((2 * j) ^ xr[tap % 3]) << 4));
    uint32_t ab[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(af[i]), ab[i], as[i]);
    last_f32_mma<S, 0>(part, ab, as, bfrag, j, lane);
    last_f32_mma<S, 1>(part, ab, as, bfrag, j, lane);
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
    if ((last_par_mask(S) >> a) & 1)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[a][i] += part[a][i];
}

// Slots Off + S... in order.
template <int Off, int... S>
__device__ __forceinline__ void last_f32_products(float (&acc)[2][4], const unsigned char* bfrag,
                                                  const unsigned (&row)[3], const int (&px)[3], const int (&xr)[3],
                                                  int lane, std::integer_sequence<int, S...>) {
  (last_f32_slot<Off + S>(acc, bfrag, row, px, xr, lane), ...);
}

__global__ void __launch_bounds__(kLastF32Threads, 1) conv_last_tf32x3_kernel(const __grid_constant__ LastF32Args a) {
  constexpr int NS = kLastF32NS, T = kLastF32Threads;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(smem_raw));
  const unsigned base = (raw + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);
  unsigned char* const bfrag = smem + NS * kLastF32Stage;
  unsigned char* const rows = bfrag + kLastF32BBytes;  // skip rows 0, 1, then output rows 0, 1
  float4* const xchg = reinterpret_cast<float4*>(rows + 4 * kLastF32Row);  // [step & 1][warp][lane]
  const unsigned bars = base + NS * kLastF32Stage + kLastF32BBytes + 4 * kLastF32Row + 2 * kLastF32Xchg;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = warp >> 2, pw = warp & 3;  // slots 8·half .. 8·half + 7 of pixels [16·pw, 16·pw + 16)
#ifdef HDRTV_SM90_PHASES
  unsigned long long t_start = clock64(), t_phase[8] = {0, 0, 0, 0, 0, 0, 0, 0}, t_mark = t_start;
#define LAST_PHASE(i) (t_phase[i] += clock64() - t_mark, t_mark = clock64());
#else
#define LAST_PHASE(i)
#endif

  // this block's steps: (band, row) g in [g0, g1) of the band-major walk
  const int total = a.bands * a.H;
  const int g0 = static_cast<int>(static_cast<long long>(blockIdx.x) * total / gridDim.x);
  const int g1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * total / gridDim.x);

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0's loads: ordinal pn into stage pn % NS; input row pr of band pb,
  // the current run's rows ending at pend (its last output row + 1).
  int pn = 0, pb = g0 / a.H, pr = g0 % a.H - 1, pend = min(g1 - pb * a.H, a.H);
  auto produce = [&](int limit) {
    while (pn < limit && pb >= 0) {
      const int stage = pn % NS;
      const unsigned bar = bars + 8 * stage, dst = base + stage * kLastF32Stage;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(4 * kLastF32BoxBytes)
                   : "memory");
#pragma unroll
      for (int si = 0; si < 4; ++si) tma_load_3d(&a.hmap, dst + si * kLastF32Box, bar, si * 32, pb * kLastSm90TW - 1, pr);
      ++pn;
      if (++pr > pend) {
        if ((pb + 1) * a.H < g1) {
          ++pb;
          pr = -1;
          pend = min(g1 - pb * a.H, a.H);
        } else {
          pb = -1;
        }
      }
    }
  };
  if (tid == 0) produce(NS);

  // The B fragments, split once: pair P = (slot s, parity p), k8 step j,
  // lane l (n = l / 4, k = l % 4): b0 = W[8j + k][n], b1 = W[8j + k + 4][n],
  // W[c][n] the weight of input channel si·32 + c at the slot's tap into
  // output channel 6p + n, zero for the padding (n ≥ 6) and for a
  // sub-position the slot does not feed.
#pragma unroll 4
  for (int idx = tid; idx < kLastSm90Slots * 2 * 4 * 32; idx += T) {
    const int s = idx >> 8, p = (idx >> 7) & 1, j = (idx >> 5) & 3, l = idx & 31;
    const int pair = a.pair[s][p];
    if (pair < 0) continue;
    const int tap = a.key[s] / 4, si = a.key[s] % 4, m = last_so_mask(tap, si);
    const int n = l >> 2, k = 8 * j + (l & 3);
    const bool live = n < 6 && ((m >> (2 * p + n / 3)) & 1);
    const float* const wk = a.w + (static_cast<long long>(tap) * 128 + si * 32 + k) * 12 + 6 * p + n;
    uint32_t b0, s0, b1, s1;
    split_tf32(live ? wk[0] : 0.f, b0, s0);
    split_tf32(live ? wk[4 * 12] : 0.f, b1, s1);
    *reinterpret_cast<uint4*>(bfrag + ((pair * 4 + j) * 32 + l) * 16) = make_uint4(b0, b1, s0, s1);
  }
  const int q = lane & 3;
  float bias[2];  // this warp's parity `half`: channels 6·half + 2q (+ 1)
#pragma unroll
  for (int e = 0; e < 2; ++e) bias[e] = q < 3 ? a.b[half * 6 + 2 * q + e] : 0.f;
  // this lane's ldmatrix row: pixel 16·pw + lane % 16 of the band, at column shift dj ∈ {0, 1, 2}
  int px[3], xr[3];
#pragma unroll
  for (int dj = 0; dj < 3; ++dj) {
    const int p = pw * 16 + (lane & 15) + dj;
    px[dj] = p * 128;
    xr[dj] = (lane >> 4) ^ (p & 7);
  }

  // The skip row of step g into skip row buf, 16 bytes a piece (a pixel's 48).
  auto prefetch_skip = [&](int g, int buf) {
    const int band = g / a.H, r = g - band * a.H, j0 = band * kLastSm90TW, valid = min(kLastSm90TW, a.W - j0);
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(a.skip) + (static_cast<long long>(r) * a.W + j0) * 48;
    unsigned char* dst = rows + buf * kLastF32Row;
    for (int i = tid; i < valid * 3; i += T) cp_async16(dst + i * 16, src + i * 16);
    cp_async_commit();
  };
  // The staged output row buf of step g to device memory.
  auto store_out = [&](int g, int buf) {
    const int band = g / a.H, r = g - band * a.H, j0 = band * kLastSm90TW, valid = min(kLastSm90TW, a.W - j0);
    const unsigned char* src = rows + (2 + buf) * kLastF32Row;
    unsigned char* out = static_cast<unsigned char*>(a.out);
    if (a.pack) {
      for (int par = 0; par < 2; ++par)
        last_store_row(src + par * (kLastSm90Row / 2), out + ((static_cast<long long>(r) * 2 + par) * a.W + j0) * 12,
                       valid * 12, tid, T);
    } else {
      last_store_row(src, out + (static_cast<long long>(r) * a.W + j0) * 48, valid * 48, tid, T);
    }
  };
  if (g0 < g1) prefetch_skip(g0, 0);
  __syncthreads();  // the B fragments are staged
  LAST_PHASE(1)

  int top = 0;  // the load ordinal of the window's top row
  for (int g = g0; g < g1; ++g) {
    const int k = g - g0, buf = k & 1;
    const int r = g % a.H;
    unsigned row[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int l = top + d;
      mbar_wait(bars + 8 * (l % NS), (l / NS) & 1);
      row[d] = base + (l % NS) * kLastF32Stage;
    }
    LAST_PHASE(2)
    float acc[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    if (half == 0)
      last_f32_products<0>(acc, bfrag, row, px, xr, lane, std::make_integer_sequence<int, kLastF32Mid>{});
    else
      last_f32_products<kLastF32Mid>(acc, bfrag, row, px, xr, lane,
                                     std::make_integer_sequence<int, kLastSm90Slots - kLastF32Mid>{});
    // the other half's parity to it: half 0 hands parity 1, half 1 parity 0
    const float* const give = acc[1 - half];
    xchg[(buf * 8 + warp) * 32 + lane] = make_float4(give[0], give[1], give[2], give[3]);
    LAST_PHASE(3)
    // This step's skip row is in; the window's top row is read; the trades
    // are written; the last step's output row is staged.
    cp_async_wait<0>();
    __syncthreads();
    top += r + 1 == a.H ? 3 : 1;  // a new band starts a new run: its top halo row and its first row
    if (tid == 0) produce(top + NS);
    if (g + 1 < g1) prefetch_skip(g + 1, buf ^ 1);
    LAST_PHASE(4)
    if (g > g0) store_out(g - 1, buf ^ 1);
    // parity `half` = (slots 0-7) + (slots 8-15), its pixels 16·pw + lane/4 (+ 8), channels 6·half + 2q (+ 1), q < 3
    const float4 got = xchg[(buf * 8 + (warp ^ 4)) * 32 + lane];
    const float y4[4] = {got.x + acc[half][0], got.y + acc[half][1], got.z + acc[half][2], got.w + acc[half][3]};
    if (q < 3) {
      const float* sk = reinterpret_cast<const float*>(rows + buf * kLastF32Row);
      unsigned char* ob = rows + (2 + buf) * kLastF32Row;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = pw * 16 + (lane >> 2) + 8 * hh, ch = half * 6 + 2 * q;
        const float2 sv = *reinterpret_cast<const float2*>(sk + p * 12 + ch);
        const float y0 = __fadd_rn(__fadd_rn(y4[2 * hh], bias[0]), sv.x);
        const float y1 = __fadd_rn(__fadd_rn(y4[2 * hh + 1], bias[1]), sv.y);
        if (a.pack) {
          ushort2 u;
          u.x = static_cast<unsigned short>(
              static_cast<int>(__fadd_rn(__fmul_rn(fminf(fmaxf(y0, 0.f), 1.f), 65535.f), 0.5f)));
          u.y = static_cast<unsigned short>(
              static_cast<int>(__fadd_rn(__fmul_rn(fminf(fmaxf(y1, 0.f), 1.f), 65535.f), 0.5f)));
          *reinterpret_cast<ushort2*>(ob + half * (kLastSm90Row / 2) + (p * 6 + 2 * q) * 2) = u;
        } else {
          *reinterpret_cast<float2*>(ob + (p * 12 + ch) * 4) = make_float2(y0, y1);
        }
      }
    }
    LAST_PHASE(5)
  }
  __syncthreads();
  if (g1 > g0) store_out(g1 - 1, (g1 - 1 - g0) & 1);
#ifdef HDRTV_SM90_PHASES
  t_phase[0] = clock64() - t_start;
  t_phase[7] = g1 - g0;
  if (a.phases && lane == 0)
    for (int i = 0; i < 8; ++i) a.phases[(static_cast<long long>(blockIdx.x) * 8 + warp) * 8 + i] = t_phase[i];
#endif
#undef LAST_PHASE
}

// h's fp32 TMA map: (128, W, H) innermost first, a box of 32 channels × 66
// columns × 1 row in the 128-byte swizzle; out-of-image pixels read as zero.
inline cudaError_t encode_last_h_map_f32(CUtensorMap* map, const void* h, int H, int W) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {128, static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H)};
  const cuuint64_t strides[2] = {512, static_cast<cuuint64_t>(W) * 512};
  const cuuint32_t box[3] = {32, kLastSm90TW + 2, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(h), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// conv_last's s2d form in fp32: h (H, W, 128), w (3, 3, 128, 12), b (12),
// skip (H, W, 12), all fp32 → out, packed or fp32. `walk` and the widths
// are checked as conv_last_sm90's (another list or width:
// cudaErrorInvalidValue). `args`: the timers' build passes its own (phases).
inline cudaError_t conv_last_tf32x3(const void* h, const void* w, const float* b, const void* skip, void* out, int H,
                                    int W, int C, int Cl, int pack, const int* walk, cudaStream_t stream,
                                    LastF32Args* args = nullptr) {
  if (C != 128 || Cl != 12 || H < 1 || W < 1 || !walk) return cudaErrorInvalidValue;
  for (int s = 0; s < kLastSm90Slots; ++s)
    if (walk[s] != last_walk_entry(s)) return cudaErrorInvalidValue;
  LastF32Args own;
  LastF32Args& a = args ? *args : own;
  a.w = static_cast<const float*>(w);
  a.b = b;
  a.skip = static_cast<const float*>(skip);
  a.out = out;
  a.H = H;
  a.W = W;
  a.pack = pack;
  a.bands = (W + kLastSm90TW - 1) / kLastSm90TW;
  for (int s = 0; s < kLastSm90Slots; ++s) {
    a.key[s] = last_slot_key(s);
    for (int p = 0; p < 2; ++p) a.pair[s][p] = (last_par_mask(s) >> p) & 1 ? last_pair(s, p) : -1;
  }
  cudaError_t err = encode_last_h_map_f32(&a.hmap, h, H, W);
  static DeviceCache cache;
  int resident = 0;
  if (err == cudaSuccess)
    err = resident_blocks(cache, conv_last_tf32x3_kernel, kLastF32Smem, &resident, kLastF32Threads);
  if (err != cudaSuccess) return err;
  const int grid = std::min(a.bands * H, resident);
  conv_last_tf32x3_kernel<<<grid, kLastF32Threads, kLastF32Smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace hdrtv
