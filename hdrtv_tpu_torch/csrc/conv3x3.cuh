// Direct 3×3 convolution over NHWC as an implicit GEMM, on the fp32 FMA units
// (conv3x3_kernel, any element types) or on the tensor cores
// (conv3x3_mma_kernel below, bf16 inputs and weights): the core shared by
// block_conv3.cu (stride 1, 'same'; its dense fp32 and pool_out forms),
// down2.cu (stride 2, pad (1,0); its dense fp32 form) and the per-conv steps
// of sft_conv3.cu and resblock.cu. The float forms of block_conv3 and down2
// with a_sub ≥ 1, and trunk3's convs, run conv3x3_sm90.cuh's tile (bf16) and
// its 3×TF32 sibling conv3x3_tf32x3.cuh (fp32).
//
// Element types: the input is TX, the weight TW, the output and the residuals
// TY, each float or bf16. In the FMA tile every product is taken on operands
// widened to fp32 and summed in fp32 (a bf16×bf16 product is exact in fp32),
// so any mix of types runs the same body; only loads and the final store
// differ. launch_conv3x3 sends bf16 × bf16 to the tensor-core tile.
//
//   M = output pixels (Ho·Wo, row-major), N = output channels Co,
//   K = 9 taps × C input channels, with the taps ordered (dI, dJ) row-major
//   and the weight stored HWIO, i.e. a (9·C, Co) row-major matrix.
//
// Output pixel (ho, wo) and tap (dI, dJ) read input pixel
// (S·ho + dI − 1, S·wo + dJ − 1); reads outside [0,H)×[0,W) are zero. With
// S = 1 that is 'same' padding, with S = 2 the (1,0) padding of the
// s2d-domain stride-2 convs (the bottom/right taps never leave the image).
// The input pixel holds `cf` channels and the conv reads the window
// [ch0, ch0 + C), in place: a channel slice never becomes a copy.
//
// Tiling of the FMA tile: a block of 256 threads owns 128 pixels × 128 output
// channels and walks K in chunks of 16 (one tap, 16 channels): both tiles are
// staged in shared memory (16 KB), the next chunk is fetched into registers
// while the current one is multiplied, and each thread accumulates an 8×8
// sub-tile in fp32 registers. The epilogue adds bias, a residual and the
// activation, in that order, and writes TY. Co is masked, so narrower outputs
// run on the same tiles.
//
// With `pool` (stride 1; Ho and Wo even) the tile also takes the 2×2 max
// pool of fused_block_conv3's pool_out form (conv_kernels.py:259-266) in its
// epilogue, after the activation: the output is (Ho/2, Wo/2, Co) and the
// full-resolution result never reaches device memory. A 2×2 window would
// span two tiles of row-major pixels, so in this mode the tile's M index
// runs over pooled pixels first: m = 4·p + s, pooled pixel p (row-major over
// the (Ho/2, Wo/2) grid) and sub-position s = 2a + b, conv pixel
// (2·(p / (Wo/2)) + a, 2·(p % (Wo/2)) + b). The four conv pixels of a pooled
// one are then four consecutive rows of the tile: in the FMA tile rows of
// one thread, in the MMA tiles rows that four lanes of one warp hold
// (lane/4 = 4j..4j+3), reduced with two shuffles. The residual is read at
// conv resolution; zero fill and masking work on conv pixels as before.
//
// Requirements (the wrappers check them): C % 16 == 0, Co % 4 == 0,
// cf % 4 == 0, ch0 % 4 == 0, and 16-byte aligned tensors.
#pragma once

#include "common.cuh"

namespace hdrtv {
namespace {

struct ConvArgs {
  const void* x;      // (H, W, cf) TX
  const void* w;      // (3, 3, C, Co) TW
  const float* b;     // (Co) fp32
  const void* skip;   // (Ho, Wo, Co) TY or nullptr; may alias y
  void* y;            // (Ho, Wo, Co) TY
  int H, W, Ho, Wo;
  int cf, ch0, C, Co;
  int act;
  int pool = 0;       // 1: 2×2 max pool after the activation, y (Ho/2, Wo/2, Co)
};

// The conv output pixel of the tile's row m: row-major, or with pool the
// pooled-pixel-major order described above.
__device__ __forceinline__ void out_pixel(long long m, int Wo, int pool, int& ho, int& wo) {
  if (pool) {
    const long long p = m >> 2;
    const int s = static_cast<int>(m & 3);
    const int wp = Wo >> 1;
    ho = 2 * static_cast<int>(p / wp) + (s >> 1);
    wo = 2 * static_cast<int>(p % wp) + (s & 1);
  } else {
    ho = static_cast<int>(m / Wo);
    wo = static_cast<int>(m % Wo);
  }
}

// Where a result pair of the MMA tiles' fragment layout goes: with pool, the
// max over the four lanes that hold one pooled pixel's four conv pixels
// (lane/4 = 4j..4j+3, i.e. lanes l ^ 4, l ^ 8), stored by the first of
// them. Every lane of the warp must call it (ok false for a masked pair, whose
// v is then 0: the four lanes of a pooled pixel agree on ok, since M is a
// multiple of 4 and they hold the same columns).
template <typename TY>
__device__ __forceinline__ void store_result2(TY* y, float2 v, long long m, int n, int Co, bool ok,
                                              int pool) {
  if (pool) {
#pragma unroll
    for (int o = 4; o <= 8; o <<= 1) {
      v.x = fmaxf(v.x, __shfl_xor_sync(0xffffffffu, v.x, o));
      v.y = fmaxf(v.y, __shfl_xor_sync(0xffffffffu, v.y, o));
    }
    if (ok && (threadIdx.x & 12) == 0) store2<TY>(y + (m >> 2) * Co + n, v);
  } else if (ok) {
    store2<TY>(y + m * Co + n, v);
  }
}

constexpr int kBM = 128, kBN = 128, kBK = 16, kThreads = 256, kTM = 8, kTN = 8;

template <typename TX, typename TW, typename TY, int S>
__global__ void __launch_bounds__(kThreads) conv3x3_kernel(ConvArgs a) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const TX* __restrict__ x = static_cast<const TX*>(a.x);
  const TW* __restrict__ w = static_cast<const TW*>(a.w);
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // N direction
  const int ty = tid / 16;  // M direction
  const long long M = static_cast<long long>(a.Ho) * a.Wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // Each thread stages two float4 of the A tile (pixel idx/4, channel quad
  // idx%4) and two of the B tile (row idx/32, column quad idx%32). The A
  // tile's pixels are fixed for the whole K walk: decode them once.
  int a_ho[2], a_wo[2];
  bool a_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int idx = tid + r * kThreads;
    const long long m = m0 + (idx >> 2);
    a_ok[r] = m < M;
    out_pixel(a_ok[r] ? m : 0, a.Wo, a.pool, a_ho[r], a_wo[r]);
  }

  const int kc = a.C / kBK;  // channel chunks per tap
  const int KT = 9 * kc;
  float4 ra[2], rb[2];

  auto fetch = [&](int kt) {
    const int tap = kt / kc;
    const int c0 = (kt - tap * kc) * kBK;
    const int dI = tap / 3, dJ = tap % 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = tid + r * kThreads;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (a_ok[r]) {
        const int hi = S * a_ho[r] + dI - 1;
        const int wi = S * a_wo[r] + dJ - 1;
        if (hi >= 0 && hi < a.H && wi >= 0 && wi < a.W) {
          v = load4<TX>(x + (static_cast<long long>(hi) * a.W + wi) * a.cf + a.ch0 + c0 +
                        (idx & 3) * 4);
        }
      }
      ra[r] = v;
      const int k = idx >> 5;
      const int n = n0 + (idx & 31) * 4;
      float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < a.Co) {
        u = load4<TW>(w + static_cast<long long>(tap * a.C + c0 + k) * a.Co + n);
      }
      rb[r] = u;
    }
  };

  auto stage = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = tid + r * kThreads;
      const int pl = idx >> 2;
      const int q = (idx & 3) * 4;
      As[q + 0][pl] = ra[r].x;
      As[q + 1][pl] = ra[r].y;
      As[q + 2][pl] = ra[r].z;
      As[q + 3][pl] = ra[r].w;
      *reinterpret_cast<float4*>(&Bs[idx >> 5][(idx & 31) * 4]) = rb[r];
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  fetch(0);
  stage();
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) fetch(kt + 1);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * kTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * kTM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * kTN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][tx * kTN + 4]);
      const float av[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    if (kt + 1 < KT) {
      stage();
      __syncthreads();
    }
  }

  // Epilogue: (acc + b) + skip, then the activation. skip may be
  // the output buffer itself: each element is read before it is written, by
  // the same thread. With pool, rows 4j..4j+3 of a thread (one pooled pixel)
  // are reduced in registers and stored once.
  const TY* skip = static_cast<const TY*>(a.skip);
  TY* y = static_cast<TY*>(a.y);
  float4 pmax[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + ty * kTM + i;
    if (m >= M) continue;
    int ho, wo;
    out_pixel(m, a.Wo, a.pool, ho, wo);
    const long long pix = static_cast<long long>(ho) * a.Wo + wo;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + tx * kTN + h * 4;
      if (n >= a.Co) continue;
      const float4 bias = *reinterpret_cast<const float4*>(a.b + n);
      float4 v = make_float4(acc[i][h * 4 + 0] + bias.x, acc[i][h * 4 + 1] + bias.y,
                             acc[i][h * 4 + 2] + bias.z, acc[i][h * 4 + 3] + bias.w);
      const long long off = pix * a.Co + n;
      if (skip) v = add4(v, load4<TY>(skip + off));
      v.x = apply_act(v.x, a.act);
      v.y = apply_act(v.y, a.act);
      v.z = apply_act(v.z, a.act);
      v.w = apply_act(v.w, a.act);
      if (!a.pool) {
        store4<TY>(y + off, v);
        continue;
      }
      pmax[h] = (i % 4) ? make_float4(fmaxf(pmax[h].x, v.x), fmaxf(pmax[h].y, v.y), fmaxf(pmax[h].z, v.z),
                                      fmaxf(pmax[h].w, v.w))
                        : v;
      if (i % 4 == 3) store4<TY>(y + (m >> 2) * a.Co + n, pmax[h]);
    }
  }
}

// ---------------------------------------------------------------------------
// The same tile on the tensor cores, for bf16 inputs and bf16 weights.
//
// Same grid, same 128 × 128 output tile, same K order (tap by tap), but a K
// chunk is one tap × 32 channels and the products run as
// mma.sync.m16n8k16 (bf16 × bf16, fp32 accumulate). The eight warps form a
// 2 (pixels) × 4 (channels) grid; a warp owns 64 pixels × 32 channels, i.e.
// 4 × 4 MMA tiles and 64 fp32 accumulators per thread. Both operand tiles are
// staged in shared memory as bf16, as they lie in device memory (A: pixel
// rows of 32 channels, B: 32 weight rows of 128 channels), with 16-byte loads
// and stores, and read back with ldmatrix (.trans for B, which the MMA wants
// column-major); row pitches of 80 and 272 bytes keep ldmatrix free of bank
// conflicts. The next chunk is fetched into registers during the MMAs.
// The epilogue is that of the FMA tile: (acc + b) + skip, activation, one
// store in TY.
//
// Requirements beyond the FMA tile's: C % 32 == 0, Co % 8 == 0, cf % 8 == 0,
// ch0 % 8 == 0 (16-byte loads); launch_conv3x3 falls back to the FMA tile
// where they do not hold.
// ---------------------------------------------------------------------------

constexpr int kMmaBK = 32;
constexpr int kMmaAPitch = kMmaBK + 8;  // bf16 elements: 80-byte rows
constexpr int kMmaBPitch = kBN + 8;     // 272-byte rows

template <typename TY, int S>
__global__ void __launch_bounds__(kThreads) conv3x3_mma_kernel(ConvArgs a) {
  __shared__ __align__(16) bf16 As[kBM][kMmaAPitch];
  __shared__ __align__(16) bf16 Bs[kMmaBK][kMmaBPitch];

  const bf16* __restrict__ x = static_cast<const bf16*>(a.x);
  const bf16* __restrict__ w = static_cast<const bf16*>(a.w);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wm = (tid / 32) / 4;  // warp row: pixels [wm·64, wm·64 + 64)
  const int wn = (tid / 32) % 4;  // warp column: channels [wn·32, wn·32 + 32)
  const long long M = static_cast<long long>(a.Ho) * a.Wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // Each thread stages two 16-byte pieces of the A tile (pixel idx/4, channel
  // octet idx%4) and two of the B tile (row idx/16, column octet idx%16).
  int a_ho[2], a_wo[2];
  bool a_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int idx = tid + r * kThreads;
    const long long m = m0 + (idx >> 2);
    a_ok[r] = m < M;
    out_pixel(a_ok[r] ? m : 0, a.Wo, a.pool, a_ho[r], a_wo[r]);
  }

  const int kc = a.C / kMmaBK;  // channel chunks per tap
  const int KT = 9 * kc;
  uint4 ra[2], rb[2];

  auto fetch = [&](int kt) {
    const int tap = kt / kc;
    const int c0 = (kt - tap * kc) * kMmaBK;
    const int dI = tap / 3, dJ = tap % 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = tid + r * kThreads;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (a_ok[r]) {
        const int hi = S * a_ho[r] + dI - 1;
        const int wi = S * a_wo[r] + dJ - 1;
        if (hi >= 0 && hi < a.H && wi >= 0 && wi < a.W) {
          v = *reinterpret_cast<const uint4*>(x + (static_cast<long long>(hi) * a.W + wi) * a.cf +
                                              a.ch0 + c0 + (idx & 3) * 8);
        }
      }
      ra[r] = v;
      const int n = n0 + (idx & 15) * 8;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (n < a.Co) {
        u = *reinterpret_cast<const uint4*>(
            w + static_cast<long long>(tap * a.C + c0 + (idx >> 4)) * a.Co + n);
      }
      rb[r] = u;
    }
  };

  auto stage = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = tid + r * kThreads;
      *reinterpret_cast<uint4*>(&As[idx >> 2][(idx & 3) * 8]) = ra[r];
      *reinterpret_cast<uint4*>(&Bs[idx >> 4][(idx & 15) * 8]) = rb[r];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  fetch(0);
  stage();
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) fetch(kt + 1);
#pragma unroll
    for (int ks = 0; ks < kMmaBK; ks += 16) {
      unsigned af[4][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], &As[wm * 64 + mt * 16 + (lane % 16)][ks + (lane / 16) * 8]);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(bf[np], &Bs[ks + (lane % 8) + ((lane / 8) % 2) * 8]
                                     [wn * 32 + np * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16_16816(acc[mt][nt], af[mt], bf[nt / 2][(nt % 2) * 2], bf[nt / 2][(nt % 2) * 2 + 1]);
    }
    __syncthreads();
    if (kt + 1 < KT) {
      stage();
      __syncthreads();
    }
  }

  // A thread holds, of each 16 × 8 MMA tile, rows lane/4 and lane/4 + 8 and
  // the column pair (lane%4)·2.
  const TY* skip = static_cast<const TY*>(a.skip);
  TY* y = static_cast<TY*>(a.y);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm * 64 + mt * 16 + h * 8 + lane / 4;
      int ho, wo;
      out_pixel(m < M ? m : 0, a.Wo, a.pool, ho, wo);
      const long long pix = static_cast<long long>(ho) * a.Wo + wo;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + (lane % 4) * 2;
        const bool ok = m < M && n < a.Co;
        float2 v = make_float2(0.f, 0.f);
        if (ok) {
          const float2 bias = *reinterpret_cast<const float2*>(a.b + n);
          v = make_float2(acc[mt][nt][2 * h] + bias.x, acc[mt][nt][2 * h + 1] + bias.y);
          const long long off = pix * a.Co + n;
          if (skip) {
            const float2 s = load2<TY>(skip + off);
            v = make_float2(v.x + s.x, v.y + s.y);
          }
          v = make_float2(apply_act(v.x, a.act), apply_act(v.y, a.act));
        }
        store_result2<TY>(y, v, m, n, a.Co, ok, a.pool);
      }
    }
  }
}

template <typename TX, typename TW, typename TY, int S>
cudaError_t launch_conv3x3(const ConvArgs& a, cudaStream_t stream) {
  const long long M = static_cast<long long>(a.Ho) * a.Wo;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  static_cast<unsigned>((a.Co + kBN - 1) / kBN));
  if constexpr (std::is_same<TX, bf16>::value && std::is_same<TW, bf16>::value) {
    if (a.C % kMmaBK == 0 && a.Co % 8 == 0 && a.cf % 8 == 0 && a.ch0 % 8 == 0) {
      conv3x3_mma_kernel<TY, S><<<grid, kThreads, 0, stream>>>(a);
      return cudaGetLastError();
    }
  }
  conv3x3_kernel<TX, TW, TY, S><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// Stride-1 'same' conv over a dense (H, W, C) tensor: the form every fused
// sequence here (sft_conv3, resblock) launches; block_conv3 also with pool.
template <typename TX, typename TW, typename TY>
cudaError_t conv_same(const void* x, const void* w, const float* b, const void* skip, void* y, int H, int W,
                      int C, int Co, int act, cudaStream_t stream, int pool = 0) {
  ConvArgs a;
  a.x = x;
  a.w = w;
  a.b = b;
  a.skip = skip;
  a.y = y;
  a.H = H;
  a.W = W;
  a.Ho = H;
  a.Wo = W;
  a.cf = C;
  a.ch0 = 0;
  a.C = C;
  a.Co = Co;
  a.act = act;
  a.pool = pool;
  return launch_conv3x3<TX, TW, TY, 1>(a, stream);
}

}  // namespace
}  // namespace hdrtv
