// Per-pixel (1×1) matrix products, and the SFT pass built on them: the core
// shared by chain.cuh (mix_chain.cu, cond_chain.cu), agcm_head.cu,
// sft_conv3.cu, resblock.cu and tail.cu.
//
// A block of 256 threads owns a tile of 64 pixels. Its input rows sit in
// shared memory as [pixel][channel] in the element type T (float or bf16),
// with a pitch of K + 16 bytes so that the pixel rows a warp reads together
// fall into different banks (and every row stays 16-byte aligned).
// tile_gemm() multiplies such a tile by a (K, N) row-major weight in device
// memory, 128 output columns at a time: the weight streams through a
// 16-row stage (the next chunk is fetched into registers while the current
// one is multiplied; the weights are a few hundred KB and stay in L2), and
// each thread accumulates 16 column pairs in fp32. What a step produces goes
// back to shared memory in T, so a chain of steps never touches device memory
// between its first read and its last write, and the rounding to T between
// steps is the one the TPU kernels make when they cast a step's input to the
// compute dtype.
//
// Two forms of the product, chosen per kernel by the template flag MMA:
//   - FMA (any T): the stage holds fp32, a thread owns 4 pixels × 8 columns;
//   - MMA (T = bf16): the stage holds bf16, the eight warps form a 2 × 4 grid
//     of 32 pixels × 32 columns each and multiply with mma.sync.m16n8k16
//     (operands read with ldmatrix), fp32 accumulation.
// Either way a thread ends up with 16 pairs of neighbouring columns; Own<MMA>
// says which (row, column) pair p is, so the epilogues are written once.
//
// Requirements (the wrappers check them): K % 16 == 0, N % 4 == 0 (FMA) or
// N % 8 == 0 (MMA), 16-byte aligned tensors.
#pragma once

#include "common.cuh"

namespace hdrtv {
namespace {

constexpr int kPwThreads = 256, kPwBM = 64, kPwBN = 128, kPwBK = 16, kPwPairs = 16;
constexpr int kPwStageBytes = kPwBK * kPwBN * static_cast<int>(sizeof(float));
constexpr int kPwBPitch = kPwBN + 8;  // bf16 stage rows: 272 bytes
constexpr int kMaxDynSmem = 232448;   // what one block may use on sm_90

// Elements of padding per shared row of T: 16 bytes.
template <typename T>
__host__ __device__ constexpr int pw_pad() {
  return 16 / static_cast<int>(sizeof(T));
}

// Which element pair of the block's 64 × 128 product a thread's pair p is.
template <bool MMA>
struct Own;
template <>
struct Own<false> {  // 16 × 16 threads, 4 rows × 8 columns each
  __device__ static int row(int p) { return (threadIdx.x / 16) * 4 + p / 4; }
  __device__ static int col(int p) { return (threadIdx.x % 16) * 8 + (p % 4) * 2; }
};
template <>
struct Own<true> {  // p = (mt·2 + h)·4 + nt of the warp's 2 × 4 MMA tiles
  __device__ static int row(int p) {
    return (threadIdx.x / 128) * 32 + (p / 8) * 16 + ((p / 4) % 2) * 8 + (threadIdx.x % 32) / 4;
  }
  __device__ static int col(int p) {
    return ((threadIdx.x / 32) % 4) * 32 + (p % 4) * 8 + (threadIdx.x % 4) * 2;
  }
};

// acc[p] = Σ_k A[row(p)][k] · W[k][n0 + col(p) + {0, 1}], columns ≥ N read as
// 0. Every thread of the block must call it; it ends on a barrier, and has
// one between its first write of the stage and its first read of A.
template <typename T, bool MMA>
__device__ __forceinline__ void tile_gemm(const T* As, int lda, int K, const T* __restrict__ W,
                                          int N, int n0, void* stage_mem,
                                          float (&acc)[kPwPairs][2]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int p = 0; p < kPwPairs; ++p) acc[p][0] = acc[p][1] = 0.f;
  const int KT = K / kPwBK;

  if constexpr (MMA) {
    static_assert(std::is_same<T, bf16>::value, "the MMA form multiplies bf16");
    bf16(*Bs)[kPwBPitch] = reinterpret_cast<bf16(*)[kPwBPitch]>(stage_mem);
    const int lane = tid % 32;
    const int wm = tid / 128;
    const int wn = (tid / 32) % 4;
    // One 16-byte piece of the 16 × 128 stage per thread.
    const int bk = tid / 16;
    const int bn = n0 + (tid % 16) * 8;
    uint4 rb;
    auto fetch = [&](int kt) {
      rb = bn < N ? *reinterpret_cast<const uint4*>(
                        W + static_cast<long long>(kt * kPwBK + bk) * N + bn)
                  : make_uint4(0u, 0u, 0u, 0u);
    };
    auto stage = [&]() { *reinterpret_cast<uint4*>(&Bs[bk][(tid % 16) * 8]) = rb; };

    fetch(0);
    stage();
    __syncthreads();
    for (int kt = 0; kt < KT; ++kt) {
      if (kt + 1 < KT) fetch(kt + 1);
      unsigned af[2][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(af[mt], As + (wm * 32 + mt * 16 + lane % 16) * lda + kt * kPwBK + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(bf[np], &Bs[lane % 8 + ((lane / 8) % 2) * 8][wn * 32 + np * 16 + (lane / 16) * 8]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          // The MMA's four results are the pairs of rows lane/4 and lane/4 + 8.
          float d[4] = {acc[mt * 8 + nt][0], acc[mt * 8 + nt][1], acc[mt * 8 + 4 + nt][0],
                        acc[mt * 8 + 4 + nt][1]};
          mma_bf16_16816(d, af[mt], bf[nt / 2][(nt % 2) * 2], bf[nt / 2][(nt % 2) * 2 + 1]);
          acc[mt * 8 + nt][0] = d[0];
          acc[mt * 8 + nt][1] = d[1];
          acc[mt * 8 + 4 + nt][0] = d[2];
          acc[mt * 8 + 4 + nt][1] = d[3];
        }
      __syncthreads();
      if (kt + 1 < KT) {
        stage();
        __syncthreads();
      }
    }
  } else {
    float(*Bs)[kPwBN] = reinterpret_cast<float(*)[kPwBN]>(stage_mem);
    const int tx = tid % 16;
    const int ty = tid / 16;
    float4 rb[2];
    auto fetch = [&](int kt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int idx = tid + r * kPwThreads;
        const int n = n0 + (idx & 31) * 4;
        rb[r] = n < N ? load4<T>(W + static_cast<long long>(kt * kPwBK + (idx >> 5)) * N + n)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    auto stage = [&]() {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int idx = tid + r * kPwThreads;
        *reinterpret_cast<float4*>(&Bs[idx >> 5][(idx & 31) * 4]) = rb[r];
      }
    };

    fetch(0);
    stage();
    __syncthreads();
    for (int kt = 0; kt < KT; ++kt) {
      if (kt + 1 < KT) fetch(kt + 1);
#pragma unroll
      for (int k4 = 0; k4 < kPwBK; k4 += 4) {
        float av[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = load4<T>(As + (ty * 4 + i) * lda + kt * kPwBK + k4);
          av[i][0] = v.x;
          av[i][1] = v.y;
          av[i][2] = v.z;
          av[i][3] = v.w;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k4 + kk][tx * 8]);
          const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k4 + kk][tx * 8 + 4]);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i * 4 + j / 2][j % 2] = fmaf(av[i][kk], bv[j], acc[i * 4 + j / 2][j % 2]);
        }
      }
      __syncthreads();
      if (kt + 1 < KT) {
        stage();
        __syncthreads();
      }
    }
  }
}

// Copy rows [m0, m0 + 64) of a (npix, cf) tensor, channels [ch0, ch0 + K),
// into a shared tile; rows past npix are zero.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int npix, int cf, int ch0,
                                           int K, long long m0, T* dst, int lda) {
  const int quads = K / 4;
  for (int idx = threadIdx.x; idx < kPwBM * quads; idx += kPwThreads) {
    const int m = idx / quads;
    const int c4 = (idx - m * quads) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + m < npix) v = load4<T>(src + (m0 + m) * cf + ch0 + c4);
    store4<T>(dst + m * lda + c4, v);
  }
}

__device__ __forceinline__ float2 bias_act2(const float (&acc)[2], const float* b, int act) {
  const float2 bias = *reinterpret_cast<const float2*>(b);
  return make_float2(apply_act(acc[0] + bias.x, act), apply_act(acc[1] + bias.y, act));
}

// ---------------------------------------------------------------------------
// SFT: t = x · (scale + 1) + shift, with
//   scale = lrelu(cond · w0s + b0s) · w1s + b1s   (cond: CC channels → CC → C)
//   shift = lrelu(cond · w0h + b0h) · w1h + b1h
// and, optionally, x replaced by round_T(x + add) first, with that sum
// written out where the caller wants it (it is the residual of the resblock). `add` is either a tensor
// of x's shape or the coarse (H/2, W/2, 4C) tensor whose block d2s has x's
// shape: fine[2i+a, 2j+b, k] = coarse[i, j, (2a+b)·C + k], un-folded on read.
// Rounding points as in the TPU kernels (_sft_mix, _sft_conv_kernel): the
// hidden activations are stored in T; scale, shift and the combination are
// fp32; t is stored in T. x may be fp32 whatever T is (the resblock's h1).
//
// Int8-output mode (q set; the W8A8 forms of the kernels, conv3x3_s8.cuh):
// t is computed in fp32 with the explicit _rn intrinsics, x·(scale+1) then
// + shift, never rounded to T, and quantized to the next conv's int8 codes
// (quantize_code) in place of the store: one byte a value instead of T's.
// ---------------------------------------------------------------------------

struct SftArgs {
  const void* x;     // (npix, C) TX
  const void* cond;  // (npix, CC) T
  const void* add;   // nullptr, (npix, C) T, or (H/2, W/2, 4C) T when coarse
  void* xsum;        // (npix, C) T or nullptr: the sum, written when add != nullptr
  void* t;           // (npix, C) T; unused in int8-output mode
  const void* w[4];  // scale0 (CC,CC), scale1 (CC,C), shift0 (CC,CC), shift1 (CC,C), T
  const float* b[4];
  int npix, W, C, CC, coarse;
  int8_t* q = nullptr;  // (npix, C) codes: int8-output mode
  float qs = 1.f, qz = 0.f;
  int qasym = 0;
};

template <typename T, typename TX, bool MMA>
__global__ void __launch_bounds__(kPwThreads) sft_kernel(SftArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = a.CC + pw_pad<T>();
  T* cond_s = reinterpret_cast<T*>(smem + kPwStageBytes);
  T* hid[2] = {cond_s + kPwBM * lda, cond_s + 2 * kPwBM * lda};
  const long long m0 = static_cast<long long>(blockIdx.x) * kPwBM;

  stage_rows<T>(static_cast<const T*>(a.cond), a.npix, a.CC, 0, a.CC, m0, cond_s, lda);

  float acc[kPwPairs][2];
#pragma unroll
  for (int br = 0; br < 2; ++br) {
    const T* w0 = static_cast<const T*>(a.w[2 * br]);
    const float* b0 = a.b[2 * br];
    for (int n0 = 0; n0 < a.CC; n0 += kPwBN) {
      tile_gemm<T, MMA>(cond_s, lda, a.CC, w0, a.CC, n0, smem, acc);
#pragma unroll
      for (int p = 0; p < kPwPairs; ++p) {
        const int n = n0 + Own<MMA>::col(p);
        if (n < a.CC)
          store2<T>(hid[br] + Own<MMA>::row(p) * lda + n, bias_act2(acc[p], b0 + n, ACT_LRELU));
      }
    }
  }

  const TX* x = static_cast<const TX*>(a.x);
  const T* add = static_cast<const T*>(a.add);
  T* xsum = static_cast<T*>(a.xsum);
  T* t = static_cast<T*>(a.t);
  float scale[kPwPairs][2];
  for (int n0 = 0; n0 < a.C; n0 += kPwBN) {
    tile_gemm<T, MMA>(hid[0], lda, a.CC, static_cast<const T*>(a.w[1]), a.C, n0, smem, scale);
    tile_gemm<T, MMA>(hid[1], lda, a.CC, static_cast<const T*>(a.w[3]), a.C, n0, smem, acc);
#pragma unroll
    for (int p = 0; p < kPwPairs; ++p) {
      const long long m = m0 + Own<MMA>::row(p);
      const int n = n0 + Own<MMA>::col(p);
      if (m >= a.npix || n >= a.C) continue;
      const float2 sc = bias_act2(scale[p], a.b[1] + n, ACT_NONE);
      const float2 sh = bias_act2(acc[p], a.b[3] + n, ACT_NONE);
      const long long off = m * a.C + n;
      float2 xv = load2<TX>(x + off);
      if (add) {
        long long src = off;
        if (a.coarse) {
          const int r = static_cast<int>(m / a.W);
          const int c = static_cast<int>(m - static_cast<long long>(r) * a.W);
          src = (static_cast<long long>(r >> 1) * (a.W >> 1) + (c >> 1)) * (4LL * a.C) +
                ((r & 1) * 2 + (c & 1)) * a.C + n;
        }
        const float2 u = load2<T>(add + src);
        xv = make_float2(round_to<T>(xv.x + u.x), round_to<T>(xv.y + u.y));
        if (xsum) store2<T>(xsum + off, xv);
      }
      if (a.q) {
        const float t0 = __fadd_rn(__fmul_rn(xv.x, __fadd_rn(sc.x, 1.f)), sh.x);
        const float t1 = __fadd_rn(__fmul_rn(xv.y, __fadd_rn(sc.y, 1.f)), sh.y);
        *reinterpret_cast<char2*>(a.q + off) =
            make_char2(static_cast<signed char>(quantize_code(t0, a.qs, a.qz, a.qasym)),
                       static_cast<signed char>(quantize_code(t1, a.qs, a.qz, a.qasym)));
        continue;
      }
      store2<T>(t + off, make_float2(xv.x * (sc.x + 1.f) + sh.x, xv.y * (sc.y + 1.f) + sh.y));
    }
  }
}

// Kernels here take more than the 48 KB of shared memory a launch gets by
// default: raise the limit once per kernel.
template <typename K>
cudaError_t allow_large_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
}

template <typename T, typename TX, bool MMA>
cudaError_t launch_sft_as(const SftArgs& a, cudaStream_t stream) {
  static const cudaError_t attr = allow_large_smem(sft_kernel<T, TX, MMA>);
  if (attr != cudaSuccess) return attr;
  const size_t bytes =
      kPwStageBytes + 3 * static_cast<size_t>(kPwBM) * (a.CC + pw_pad<T>()) * sizeof(T);
  if (bytes > kMaxDynSmem || a.CC % kPwBK || a.C % 4 || (a.coarse && (a.W & 1)))
    return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((a.npix + kPwBM - 1) / kPwBM);
  sft_kernel<T, TX, MMA><<<blocks, kPwThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// bf16 takes the MMA form where its widths allow 16-byte weight loads.
template <typename T, typename TX>
cudaError_t launch_sft(const SftArgs& a, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (a.CC % 8 == 0 && a.C % 8 == 0) return launch_sft_as<T, TX, true>(a, stream);
  }
  return launch_sft_as<T, TX, false>(a, stream);
}

// The four (w, b) pairs of an SFT as the wrappers pass them: eight pointers,
// w then b, in the order scale0, scale1, shift0, shift1.
inline void set_sft_params(SftArgs& a, const void* const* p) {
  for (int i = 0; i < 4; ++i) {
    a.w[i] = p[2 * i];
    a.b[i] = static_cast<const float*>(p[2 * i + 1]);
  }
}

// Where an SFT pass puts t: stored in T at out, or, for the int8 layer q
// (non-null), as that layer's codes at out (the int8-output mode).
inline void set_sft_out(SftArgs& a, void* out, const QuantParams* q) {
  a.t = q ? nullptr : out;
  a.q = q ? static_cast<int8_t*>(out) : nullptr;
  if (q) {
    a.qs = q->s;
    a.qz = q->z;
    a.qasym = q->asym;
  }
}

}  // namespace
}  // namespace hdrtv
