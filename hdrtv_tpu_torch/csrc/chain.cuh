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
//
// An int8 (W8A8) step (cond_chain's qargs, the `qflags` steps of
// _cond_chain_kernel): the TPU kernel quantizes its fp32 running value per
// tensor, never rounded to the element type, so here the step before it (or
// the staging of x, for the first step) quantizes its fp32 result with the
// int8 step's scale and zero point in place of the store, into the same
// shared buffer as codes (one byte a value; a code buffer's pitch ldq fits in
// the element buffer's). The step multiplies codes by its (N, K) int8 weight
// with tile_gemm_s8 (exact int32 sums), then float(acc) · yscale and + bias
// (the zero-point term folded in) as two rounded ops, then its activation.
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
  // int8 steps: wq[s] non-null (the (n[s], k[s]) codes; b[s] is then the
  // folded bias), with yscale ys[s] and the activation quantization qs, qz, qa.
  const int8_t* wq[kMaxSteps] = {};
  const float* ys[kMaxSteps] = {};
  float qs[kMaxSteps] = {}, qz[kMaxSteps] = {};
  int qa[kMaxSteps] = {};
  int ldq = 0;  // bytes per row of a code buffer
};

template <typename T, bool MMA>
__global__ void __launch_bounds__(kPwThreads) chain_kernel(ChainArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* in = reinterpret_cast<T*>(smem + kPwStageBytes);
  T* out = in + kPwBM * a.lda;

  const long long m0 = static_cast<long long>(blockIdx.x) * kPwBM;
  if (a.wq[0]) {
    stage_codes<T>(static_cast<const T*>(a.x), a.npix, a.cf, a.ch0, a.k[0], m0,
                   reinterpret_cast<int8_t*>(in), a.ldq, a.qs[0], a.qz[0], a.qa[0]);
  } else {
    stage_rows<T>(static_cast<const T*>(a.x), a.npix, a.cf, a.ch0, a.k[0], m0, in, a.lda);
  }

  T* y = static_cast<T*>(a.y);
  T* y_mid = static_cast<T*>(a.y_mid);
  for (int s = 0; s < a.steps; ++s) {
    const bool last = s + 1 == a.steps;
    const bool mid = y_mid != nullptr && s == a.mid_step;
    const bool next_q = !last && a.wq[s + 1] != nullptr;
    const int N = a.n[s];
    // Where the step's result pair (fp32, activated) for tile row `row`,
    // columns n, n + 1 goes: the next step's input (its codes when it is an
    // int8 step), the middle output, or the last.
    auto put = [&](float2 v, int row, int n) {
      const bool inside = m0 + row < a.npix;
      if (!last) {
        if (next_q) {
          *reinterpret_cast<char2*>(reinterpret_cast<int8_t*>(out) + row * a.ldq + n) = make_char2(
              static_cast<signed char>(quantize_code(v.x, a.qs[s + 1], a.qz[s + 1], a.qa[s + 1])),
              static_cast<signed char>(quantize_code(v.y, a.qs[s + 1], a.qz[s + 1], a.qa[s + 1])));
        } else {
          store2<T>(out + row * a.lda + n, v);
        }
        if (mid && inside) store2<T>(y_mid + (m0 + row) * N + n, v);
      } else if (inside) {
        store2<T>(y + (m0 + row) * N + n, v);
      }
    };
    for (int n0 = 0; n0 < N; n0 += kPwBN) {
      if (a.wq[s]) {
        int acc[kPwPairs][2];
        tile_gemm_s8(reinterpret_cast<const int8_t*>(in), a.ldq, a.k[s], a.wq[s], N, n0, smem, acc);
#pragma unroll
        for (int p = 0; p < kPwPairs; ++p) {
          const int n = n0 + Own<true>::col(p);
          if (n >= N) continue;
          const float2 ys = *reinterpret_cast<const float2*>(a.ys[s] + n);
          const float2 bias = *reinterpret_cast<const float2*>(a.b[s] + n);
          const float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[p][0]), ys.x), bias.x);
          const float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[p][1]), ys.y), bias.y);
          put(make_float2(apply_act(v0, a.act[s]), apply_act(v1, a.act[s])), Own<true>::row(p), n);
        }
      } else {
        float acc[kPwPairs][2];
        tile_gemm<T, MMA>(in, a.lda, a.k[s], static_cast<const T*>(a.w[s]), N, n0, smem, acc);
#pragma unroll
        for (int p = 0; p < kPwPairs; ++p) {
          const int n = n0 + Own<MMA>::col(p);
          if (n >= N) continue;
          put(bias_act2(acc[p], a.b[s] + n, a.act[s]), Own<MMA>::row(p), n);
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
  static DeviceCache cache;
  const cudaError_t attr = allow_large_smem(cache, chain_kernel<T, MMA>);
  if (attr != cudaSuccess) return attr;
  const size_t bytes = kPwStageBytes + 2 * static_cast<size_t>(kPwBM) * a.lda * sizeof(T);
  if (bytes > kMaxDynSmem) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((a.npix + kPwBM - 1) / kPwBM);
  chain_kernel<T, MMA><<<blocks, kPwThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// y_mid: where step mid_step's result is also written, or nullptr. q: null,
// or steps pointers to the int8 steps' QuantParams (null for a float step;
// w and b of an int8 step unused). A block holds two buffers of 64 × (widest
// width + 4) elements beside the 8 KB weight stage; a chain too wide for that
// is refused.
template <typename T>
int chain(const void* x, void* y, void* y_mid, int mid_step, const void* const* w,
          const void* const* b, const int* k, const int* n, const int* act, int steps, int npix,
          int cf, int ch0, void* stream, const QuantParams* const* q = nullptr) {
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
    const QuantParams* qp = q ? q[s] : nullptr;
    if (qp) {
      if (k[s] % 32 || n[s] % 8) return static_cast<int>(cudaErrorInvalidValue);
      a.wq[s] = qp->w;
      a.ys[s] = qp->yscale;
      a.b[s] = qp->bias;
      a.qs[s] = qp->s;
      a.qz[s] = qp->z;
      a.qa[s] = qp->asym;
    }
    if (s + 1 < steps && n[s] > widest) widest = n[s];
    mma = mma && n[s] % 8 == 0;
  }
  a.lda = widest + pw_pad<T>();
  a.ldq = widest + 16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, bf16>::value) {
    if (mma) return static_cast<int>(launch_chain<T, true>(a, st));
  }
  return static_cast<int>(launch_chain<T, false>(a, st));
}

}  // namespace
}  // namespace hdrtv
