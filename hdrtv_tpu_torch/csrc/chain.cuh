// A chain of 1×1 convs over an s2d block tensor, kept in shared memory:
// v ← act_k(v · w_k + b_k) for each step k, reading the channel window
// [ch0, ch0 + cin) of a wider input in place. The core shared by mix_chain.cu
// (one output, the last step's) and cond_chain.cu (which also writes one
// step in the middle).
//
// Design: one launch; a block stages its 64 pixels' window in shared memory,
// runs every step there with the tile product of pointwise.cuh (mma.sync for
// bf16, FMA for fp32; weights streamed by 16-row chunks, they stay in L2),
// keeps each step's result in a second shared buffer in the element type,
// and stores the last step straight from registers. Between the read of x and
// the write of y nothing reaches device memory, which is what the TPU kernels
// buy with their VMEM tile. Rounding points as in _mix_chain_kernel and
// _cond_chain_kernel: a step's input is cast to the element type, the sum,
// the fp32 bias and the activation are fp32, and what is written out is
// rounded once on store (a middle output is the value the next step reads).
#pragma once

#include "pointwise.cuh"

namespace hdrtv {
namespace {

constexpr int kMaxSteps = 5;

struct ChainArgs {
  const void* x;  // (npix, cf) T
  void* y;        // (npix, n[steps-1]) T
  void* y_mid;    // (npix, n[mid_step]) T, or nullptr
  const void* w[kMaxSteps];  // (k[s], n[s]) T
  const float* b[kMaxSteps];
  int k[kMaxSteps], n[kMaxSteps], act[kMaxSteps];
  int steps, mid_step, npix, cf, ch0, lda;
};

template <typename T, bool MMA>
__global__ void __launch_bounds__(kPwThreads) chain_kernel(ChainArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* in = reinterpret_cast<T*>(smem + kPwStageBytes);
  T* out = in + kPwBM * a.lda;

  const long long m0 = static_cast<long long>(blockIdx.x) * kPwBM;
  stage_rows<T>(static_cast<const T*>(a.x), a.npix, a.cf, a.ch0, a.k[0], m0, in, a.lda);

  T* y = static_cast<T*>(a.y);
  T* y_mid = static_cast<T*>(a.y_mid);
  float acc[kPwPairs][2];
  for (int s = 0; s < a.steps; ++s) {
    const bool last = s + 1 == a.steps;
    const bool mid = y_mid != nullptr && s == a.mid_step;
    const int N = a.n[s];
    for (int n0 = 0; n0 < N; n0 += kPwBN) {
      tile_gemm<T, MMA>(in, a.lda, a.k[s], static_cast<const T*>(a.w[s]), N, n0, smem, acc);
#pragma unroll
      for (int p = 0; p < kPwPairs; ++p) {
        const int row = Own<MMA>::row(p);
        const int n = n0 + Own<MMA>::col(p);
        if (n >= N) continue;
        const float2 v = bias_act2(acc[p], a.b[s] + n, a.act[s]);
        const bool inside = m0 + row < a.npix;
        if (!last) {
          store2<T>(out + row * a.lda + n, v);
          if (mid && inside) store2<T>(y_mid + (m0 + row) * N + n, v);
        } else if (inside) {
          store2<T>(y + (m0 + row) * N + n, v);
        }
      }
    }
    T* tmp = in;
    in = out;
    out = tmp;
  }
}

template <typename T, bool MMA>
cudaError_t launch_chain(const ChainArgs& a, cudaStream_t stream) {
  static const cudaError_t attr = allow_large_smem(chain_kernel<T, MMA>);
  if (attr != cudaSuccess) return attr;
  const size_t bytes = kPwStageBytes + 2 * static_cast<size_t>(kPwBM) * a.lda * sizeof(T);
  if (bytes > kMaxDynSmem) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((a.npix + kPwBM - 1) / kPwBM);
  chain_kernel<T, MMA><<<blocks, kPwThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// y_mid: where step mid_step's result is also written, or nullptr. A block
// holds two buffers of 64 × (widest width + 4) elements beside the 8 KB
// weight stage; a chain too wide for that is refused.
template <typename T>
int chain(const void* x, void* y, void* y_mid, int mid_step, const void* const* w,
          const void* const* b, const int* k, const int* n, const int* act, int steps, int npix,
          int cf, int ch0, void* stream) {
  if (steps < 1 || steps > kMaxSteps || cf % 4 || ch0 % 4 ||
      (y_mid && (mid_step < 0 || mid_step + 1 >= steps)))
    return static_cast<int>(cudaErrorInvalidValue);
  ChainArgs a;
  a.x = x;
  a.y = y;
  a.y_mid = y_mid;
  a.mid_step = mid_step;
  a.steps = steps;
  a.npix = npix;
  a.cf = cf;
  a.ch0 = ch0;
  int widest = k[0];
  bool mma = std::is_same<T, bf16>::value;  // bf16, and every width fit for 16-byte weight loads
  for (int s = 0; s < steps; ++s) {
    if (k[s] % kPwBK || n[s] % 4 || (s && k[s] != n[s - 1]))
      return static_cast<int>(cudaErrorInvalidValue);
    a.w[s] = w[s];
    a.b[s] = static_cast<const float*>(b[s]);
    a.k[s] = k[s];
    a.n[s] = n[s];
    a.act[s] = act[s];
    if (s + 1 < steps && n[s] > widest) widest = n[s];
    mma = mma && n[s] % 8 == 0;
  }
  a.lda = widest + pw_pad<T>();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, bf16>::value) {
    if (mma) return static_cast<int>(launch_chain<T, true>(a, st));
  }
  return static_cast<int>(launch_chain<T, false>(a, st));
}

}  // namespace
}  // namespace hdrtv
