// hg_tail — replaces the Pallas kernel fused_hg_tail
// (hdrtv_tpu/ops/megakernel.py:1435, body _hg_tail_kernel :1403): the output
// slice of the HG composite over s2d tensors,
//     u10  = [up5 ‖ c1] · W10 + b10          1×1, K = Cu + Cc → 12
//     out  = [u10 ‖ img] · Wlast + blast     1×1, K = 24 → 12
//     comp = mask · out + img                the mask of sub-position s on channels 3s..3s+2
//     pack = u16(clip(comp, 0, 1) · 65535 + 0.5) as (Hb, 2, Wb, 6)
// The output's flat layout is the natural (2Hb, 2Wb, 3) RGB48 frame: channel
// 6a + k of block (i, j) goes to out[i, a, j, k].
//
// Bound on this card: bytes. A 1080p call (544 × 960 blocks, Cu = Cc = 256)
// reads up5 and c1 once, 2 × 267 MB in bf16 (2 × 535 MB in fp32), plus 22 MB
// (37 MB) of img, mask and output; the products are 13 GFLOP dense, a tenth of
// the time the bytes take on either unit. So the design is about reading up5
// and c1 exactly once, in full sectors, with many loads in flight, and
// nothing else: no concat, no u10 or out in device memory, no separate pack.
// Measured at that shape on an H100 80GB HBM3 at 700 W: 0.23 ms in bf16 (its
// bytes take 0.17 ms at 3.35 TB/s), 0.63 ms in fp32 (0.33 ms).
//
// Design, one launch. A warp owns 16 consecutive pixels at a time.
//   - bf16 (hg_tail_mma_kernel): the K → 12 product runs on the tensor cores
//     (mma.sync.m16n8k16, two 8-column tiles, fp32 accumulation) with the A
//     fragments loaded straight from device memory: the sum over k does not
//     care about the order of k, so a lane reads 16 contiguous bytes (8
//     channels) of its two pixel rows per 32-channel chunk and uses them as
//     the fragments of two k-steps; the weights sit in shared memory in
//     exactly that permuted fragment order (one 8-byte read per MMA). Four
//     lanes cover 64 contiguous bytes of a row, so every sector is used whole.
//     Needs Cu % 32 == 0 and Cc % 32 == 0.
//   - fp32, and bf16 at other widths (hg_tail_fma_kernel): lane (p, half)
//     owns six outputs of pixel p and walks the pixel's row four channels at
//     a time on the FMA units, the weights in shared memory as fp32 (two
//     distinct addresses per warp read, so they broadcast).
// Both hand u10 to the same finish: lane (p, half) has the pixel's twelve
// u10 (bias added in fp32, rounded to the element type, as the TPU body casts
// it), computes its six outputs of conv_last from u10 and img on the FMA
// units, composites with the mask in fp32 and writes its six u16 (one row
// parity of the block: 12 contiguous bytes). The pack's multiply and add are
// rounded separately, so no FMA contraction moves the +0.5 boundary.
#include "pointwise.cuh"

namespace hdrtv {
namespace {

constexpr int kHgThreads = 256;           // 8 warps
constexpr int kHgTile = 16;               // pixels a warp owns at a time
constexpr int kHgN = 12;                  // s2d channels of an RGB frame
constexpr int kHgSmall = 2 * kHgN * kHgN + 2 * kHgN;  // Wlast (24 × 12), b10, blast as fp32

struct HgTailArgs {
  const void* up;     // (npix, Cu) T
  const void* c1;     // (npix, Cc) T
  const void* img;    // (npix, 12) T
  const void* mask;   // (npix, 4) T
  const void* w10;    // (Cu + Cc, 12) T
  const float* b10;   // (12)
  const void* wlast;  // (24, 12) T
  const float* blast; // (12)
  uint16_t* out;      // (H, 2, W, 6)
  int npix, W, Cu, Cc;
};

// Wlast, b10 and blast into shared memory as fp32: [24][12], [12], [12].
template <typename T>
__device__ __forceinline__ void stage_small(const HgTailArgs& a, float* small) {
  const T* wl = static_cast<const T*>(a.wlast);
  for (int i = threadIdx.x; i < 2 * kHgN * kHgN; i += blockDim.x) small[i] = to_float<T>(wl[i]);
  for (int i = threadIdx.x; i < kHgN; i += blockDim.x) {
    small[2 * kHgN * kHgN + i] = a.b10[i];
    small[2 * kHgN * kHgN + kHgN + i] = a.blast[i];
  }
}

// Lane (p, half) finishes pixel m: u holds the pixel's twelve u10 values,
// bias added and rounded to T. Writes out[i, half, j, 0..5].
template <typename T>
__device__ __forceinline__ void hg_finish(const HgTailArgs& a, const float* small, long long m,
                                          int half, const float (&u)[kHgN]) {
  const float* wl = small;
  const float* bl = small + 2 * kHgN * kHgN + kHgN;
  const T* img = static_cast<const T*>(a.img) + m * kHgN;
  float x[kHgN];
#pragma unroll
  for (int q = 0; q < kHgN / 4; ++q) {
    const float4 v = load4<T>(img + q * 4);
    x[q * 4] = v.x;
    x[q * 4 + 1] = v.y;
    x[q * 4 + 2] = v.z;
    x[q * 4 + 3] = v.w;
  }
  // Rows 0..11 of Wlast multiply u10, rows 12..23 img; a lane reads its six
  // columns of a row as three 8-byte pieces.
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 2 * kHgN; ++k) {
    const float v = k < kHgN ? u[k % kHgN] : x[k % kHgN];
    const float2* wk = reinterpret_cast<const float2*>(wl + k * kHgN + half * 6);
    const float2 w0 = wk[0], w1 = wk[1], w2 = wk[2];
    acc[0] = fmaf(v, w0.x, acc[0]);
    acc[1] = fmaf(v, w0.y, acc[1]);
    acc[2] = fmaf(v, w1.x, acc[2]);
    acc[3] = fmaf(v, w1.y, acc[3]);
    acc[4] = fmaf(v, w2.x, acc[4]);
    acc[5] = fmaf(v, w2.y, acc[5]);
  }
  const float2 mk = load2<T>(static_cast<const T*>(a.mask) + m * 4 + half * 2);
  unsigned short code[6];
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const float o = acc[e] + bl[half * 6 + e];
    const float comp = __fadd_rn(__fmul_rn(e < 3 ? mk.x : mk.y, o), half ? x[6 + e] : x[e]);
    code[e] = static_cast<unsigned short>(
        static_cast<int>(__fadd_rn(__fmul_rn(fminf(fmaxf(comp, 0.f), 1.f), 65535.f), 0.5f)));
  }
  const long long i = m / a.W;
  const long long j = m - i * a.W;
  unsigned* dst = reinterpret_cast<unsigned*>(a.out + ((i * 2 + half) * a.W + j) * 6);
  dst[0] = code[0] | (static_cast<unsigned>(code[1]) << 16);
  dst[1] = code[2] | (static_cast<unsigned>(code[3]) << 16);
  dst[2] = code[4] | (static_cast<unsigned>(code[5]) << 16);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

// Shared memory: the B fragments of W10, one uint2 per (chunk, k-step, column
// tile, lane); then the small fp32 block; then a 16 × 12 fp32 scratch per warp.
__global__ void __launch_bounds__(kHgThreads) hg_tail_mma_kernel(HgTailArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunks_u = a.Cu / 32;
  const int chunks = chunks_u + a.Cc / 32;
  uint2* bfrag = reinterpret_cast<uint2*>(smem);
  float* small = reinterpret_cast<float*>(bfrag + chunks * 4 * 32);
  float* scratch = small + kHgSmall + (threadIdx.x / 32) * (kHgTile * kHgN);

  // Lane (g = lane / 4, q = lane % 4) of k-step s of a chunk reads channels
  // chunk·32 + q·8 + 4s + {0, 1} as the MMA's k = 2q, 2q + 1 and + {2, 3} as
  // k = 2q + 8, 2q + 9; the B fragment holds the same rows of W10, column
  // t·8 + g (columns ≥ 12 are zero).
  const bf16* w10 = static_cast<const bf16*>(a.w10);
  for (int idx = threadIdx.x; idx < chunks * 4 * 32; idx += blockDim.x) {
    const int lane = idx % 32;
    const int t = (idx / 32) % 2;
    const int s = (idx / 64) % 2;
    const int chunk = idx / 128;
    const int n = t * 8 + lane / 4;
    const int row = chunk * 32 + (lane % 4) * 8 + 4 * s;
    unsigned short v[4] = {0, 0, 0, 0};
    if (n < kHgN) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = *reinterpret_cast<const unsigned short*>(w10 + static_cast<long long>(row + e) * kHgN + n);
    }
    bfrag[idx] = make_uint2(v[0] | (static_cast<unsigned>(v[1]) << 16),
                            v[2] | (static_cast<unsigned>(v[3]) << 16));
  }
  stage_small<bf16>(a, small);
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int warps = gridDim.x * (kHgThreads / 32);
  const int tiles = (a.npix + kHgTile - 1) / kHgTile;
  const float* b10 = small + 2 * kHgN * kHgN;
  const bf16* up = static_cast<const bf16*>(a.up);
  const bf16* c1 = static_cast<const bf16*>(a.c1);

  for (int tile = blockIdx.x * (kHgThreads / 32) + threadIdx.x / 32; tile < tiles; tile += warps) {
    const long long m0 = static_cast<long long>(tile) * kHgTile;
    // Rows past the end read the last pixel; their results are not stored.
    const long long r0 = min(m0 + g, static_cast<long long>(a.npix) - 1);
    const long long r1 = min(m0 + g + 8, static_cast<long long>(a.npix) - 1);
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

    auto run = [&](const bf16* src, int C, int chunk0) {
      const uint4* p0 = reinterpret_cast<const uint4*>(src + r0 * C + q * 8);
      const uint4* p1 = reinterpret_cast<const uint4*>(src + r1 * C + q * 8);
      const int n = C / 32;
#pragma unroll 4
      for (int c = 0; c < n; ++c) {
        const uint4 v0 = p0[c * 4];  // 32 channels on: 4 × 16 bytes
        const uint4 v1 = p1[c * 4];
        const uint2* bf = bfrag + (chunk0 + c) * 128 + lane;
        const unsigned a_lo[4] = {v0.x, v1.x, v0.y, v1.y};
        const unsigned a_hi[4] = {v0.z, v1.z, v0.w, v1.w};
        const uint2 b00 = bf[0], b01 = bf[32], b10f = bf[64], b11 = bf[96];
        mma_bf16_16816(acc[0], a_lo, b00.x, b00.y);
        mma_bf16_16816(acc[1], a_lo, b01.x, b01.y);
        mma_bf16_16816(acc[0], a_hi, b10f.x, b10f.y);
        mma_bf16_16816(acc[1], a_hi, b11.x, b11.y);
      }
    };
    run(up, a.Cu, 0);
    run(c1, a.Cc, chunks_u);

    // Of each 16 × 8 result a lane holds rows g and g + 8, columns 2q, 2q + 1.
    __syncwarp();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int n = t * 8 + 2 * q;
      if (n < kHgN) {
        scratch[g * kHgN + n] = round_to<bf16>(acc[t][0] + b10[n]);
        scratch[g * kHgN + n + 1] = round_to<bf16>(acc[t][1] + b10[n + 1]);
        scratch[(g + 8) * kHgN + n] = round_to<bf16>(acc[t][2] + b10[n]);
        scratch[(g + 8) * kHgN + n + 1] = round_to<bf16>(acc[t][3] + b10[n + 1]);
      }
    }
    __syncwarp();
    const int p = lane / 2;
    float u[kHgN];
#pragma unroll
    for (int k = 0; k < kHgN; ++k) u[k] = scratch[p * kHgN + k];
    if (m0 + p < a.npix) hg_finish<bf16>(a, small, m0 + p, lane % 2, u);
  }
}

// ---------------------------------------------------------------------------
// FMA form: fp32, and bf16 at widths the MMA form does not take
// ---------------------------------------------------------------------------

// Shared memory: W10 as fp32 [(Cu + Cc)][12], then the small fp32 block.
template <typename T>
__global__ void __launch_bounds__(kHgThreads) hg_tail_fma_kernel(HgTailArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = a.Cu + a.Cc;
  float* w10 = reinterpret_cast<float*>(smem);
  float* small = w10 + K * kHgN;
  const T* w = static_cast<const T*>(a.w10);
  for (int i = threadIdx.x; i < K * kHgN; i += blockDim.x) w10[i] = to_float<T>(w[i]);
  stage_small<T>(a, small);
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int p = lane / 2;
  const int half = lane % 2;
  const int warps = gridDim.x * (kHgThreads / 32);
  const int tiles = (a.npix + kHgTile - 1) / kHgTile;
  const float* b10 = small + 2 * kHgN * kHgN;

  for (int tile = blockIdx.x * (kHgThreads / 32) + threadIdx.x / 32; tile < tiles; tile += warps) {
    const long long m0 = static_cast<long long>(tile) * kHgTile;
    const long long m = min(m0 + p, static_cast<long long>(a.npix) - 1);
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

    auto run = [&](const T* src, int C, const float* wrow) {
      const T* row = src + m * C;
      for (int k = 0; k < C; k += 4) {
        const float4 v = load4<T>(row + k);
        const float xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2* wk = reinterpret_cast<const float2*>(wrow + (k + j) * kHgN + half * 6);
          const float2 w0 = wk[0], w1 = wk[1], w2 = wk[2];
          acc[0] = fmaf(xs[j], w0.x, acc[0]);
          acc[1] = fmaf(xs[j], w0.y, acc[1]);
          acc[2] = fmaf(xs[j], w1.x, acc[2]);
          acc[3] = fmaf(xs[j], w1.y, acc[3]);
          acc[4] = fmaf(xs[j], w2.x, acc[4]);
          acc[5] = fmaf(xs[j], w2.y, acc[5]);
        }
      }
    };
    run(static_cast<const T*>(a.up), a.Cu, w10);
    run(static_cast<const T*>(a.c1), a.Cc, w10 + a.Cu * kHgN);

    // The pixel's other six u10 come from the neighbouring lane.
    float u[kHgN];
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const float mine = round_to<T>(acc[e] + b10[half * 6 + e]);
      const float other = __shfl_xor_sync(0xffffffffu, mine, 1);
      u[e] = half ? other : mine;
      u[6 + e] = half ? mine : other;
    }
    if (m0 + p < a.npix) hg_finish<T>(a, small, m0 + p, half, u);
  }
}

// Enough blocks to fill the card a few times over, not more than the work.
inline unsigned hg_blocks(int npix) {
  const int tiles = (npix + kHgTile - 1) / kHgTile;
  const int want = (tiles + kHgThreads / 32 - 1) / (kHgThreads / 32);
  return static_cast<unsigned>(want < 132 * 8 ? (want > 0 ? want : 1) : 132 * 8);
}

template <typename T>
int hg_tail(const void* up, const void* c1, const void* img, const void* mask, const void* w10,
            const void* b10, const void* wlast, const void* blast, void* out, int H, int W, int Cu,
            int Cc, void* stream) {
  if (H <= 0 || W <= 0 || Cu <= 0 || Cc <= 0 || Cu % 4 || Cc % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  HgTailArgs a;
  a.up = up;
  a.c1 = c1;
  a.img = img;
  a.mask = mask;
  a.w10 = w10;
  a.b10 = static_cast<const float*>(b10);
  a.wlast = wlast;
  a.blast = static_cast<const float*>(blast);
  a.out = static_cast<uint16_t*>(out);
  a.npix = H * W;
  a.W = W;
  a.Cu = Cu;
  a.Cc = Cc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = hg_blocks(a.npix);
  if constexpr (std::is_same<T, bf16>::value) {
    if (Cu % 32 == 0 && Cc % 32 == 0) {
      static DeviceCache cache;
      const cudaError_t attr = allow_large_smem(cache, hg_tail_mma_kernel);
      if (attr != cudaSuccess) return static_cast<int>(attr);
      const size_t bytes = static_cast<size_t>((Cu + Cc) / 32) * 128 * sizeof(uint2) +
                           (kHgSmall + (kHgThreads / 32) * kHgTile * kHgN) * sizeof(float);
      if (bytes > kMaxDynSmem) return static_cast<int>(cudaErrorInvalidValue);
      hg_tail_mma_kernel<<<blocks, kHgThreads, bytes, st>>>(a);
      return static_cast<int>(cudaGetLastError());
    }
  }
  static DeviceCache cache;
  const cudaError_t attr = allow_large_smem(cache, hg_tail_fma_kernel<T>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t bytes = (static_cast<size_t>(Cu + Cc) * kHgN + kHgSmall) * sizeof(float);
  if (bytes > kMaxDynSmem) return static_cast<int>(cudaErrorInvalidValue);
  hg_tail_fma_kernel<T><<<blocks, kHgThreads, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hdrtv

// up (H, W, Cu), c1 (H, W, Cc), img (H, W, 12), mask (H, W, 4), w10 (Cu + Cc, 12)
// and wlast (24, 12) in the element type; b10, blast (12) fp32; out (H, 2, W, 6) u16.
extern "C" int hdrtv_hg_tail_f32(const void* up, const void* c1, const void* img, const void* mask,
                                 const void* w10, const void* b10, const void* wlast,
                                 const void* blast, void* out, int H, int W, int Cu, int Cc,
                                 void* stream) {
  return hdrtv::hg_tail<float>(up, c1, img, mask, w10, b10, wlast, blast, out, H, W, Cu, Cc, stream);
}

extern "C" int hdrtv_hg_tail_bf16(const void* up, const void* c1, const void* img, const void* mask,
                                  const void* w10, const void* b10, const void* wlast,
                                  const void* blast, void* out, int H, int W, int Cu, int Cc,
                                  void* stream) {
  return hdrtv::hg_tail<hdrtv::bf16>(up, c1, img, mask, w10, b10, wlast, blast, out, H, W, Cu, Cc,
                                     stream);
}
