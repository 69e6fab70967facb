// pack_rgb48 — replaces the Pallas kernel pack_rgb48
// (hdrtv_tpu/ops/pack.py:71): the RGB48 delivery pack
// u16 = (int)(clip(x, 0, 1) · 65535 + 0.5), truncating.
//
// Bound on this card: bytes. A 1080p frame reads 24.9 MB of fp32 (12.4 MB of
// bf16) and writes 12.4 MB of u16, ~11 µs (~7 µs) at 3.35 TB/s; there is no
// reuse to exploit. A bf16 input is widened to fp32 first, as the TPU kernel
// does, so the pack is exact for both element types.
// Design: one thread per element, neighbouring threads on neighbouring
// addresses. The multiply and the add are rounded separately (__fmul_rn,
// __fadd_rn) so the compiler cannot contract them into one FMA: the +0.5
// boundary then rounds exactly as the two-step reference does.
#include "common.cuh"

namespace hdrtv {
namespace {

template <typename T>
__global__ void pack_rgb48_kernel(const T* __restrict__ x, uint16_t* __restrict__ y,
                                  long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = fminf(fmaxf(to_float<T>(x[i]), 0.f), 1.f);
  y[i] = static_cast<uint16_t>(static_cast<int>(__fadd_rn(__fmul_rn(v, 65535.f), 0.5f)));
}

template <typename T>
int pack_rgb48(const void* x, void* y, long long n, void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  pack_rgb48_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<uint16_t*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hdrtv

extern "C" int hdrtv_pack_rgb48_f32(const void* x, void* y, long long n, void* stream) {
  return hdrtv::pack_rgb48<float>(x, y, n, stream);
}

extern "C" int hdrtv_pack_rgb48_bf16(const void* x, void* y, long long n, void* stream) {
  return hdrtv::pack_rgb48<hdrtv::bf16>(x, y, n, stream);
}

extern "C" const char* hdrtv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
