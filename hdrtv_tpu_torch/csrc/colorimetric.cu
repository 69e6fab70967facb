// colorimetric — replaces the Pallas kernel colorimetric_pq_pack
// (hdrtv_tpu/ops/pack.py:146, body _colorimetric_kernel :104): the explicit
// colour-managed output slice of an SDR [0,1] RGB image,
//     lin  = clip(x, 0, 1) ^ gamma                 display-referred linearisation
//     rgb' = M · lin                               BT.709 → BT.2020, 3 × 3
//     y    = clip(rgb' · peak_nits / 10000, 0, 1)
//     pq   = ((c1 + c2·y^m1) / max(1 + c3·y^m1, 1e-12)) ^ m2     ST 2084 OETF
//     u16  = (int)(pq · 65535 + 0.5)
//
// Bound on this card: bytes. A 1080p frame reads 24.9 MB of fp32 (12.4 MB of
// bf16) and writes 12.4 MB of u16, ~11 µs (~7 µs) at 3.35 TB/s. The nine
// powers of a pixel (powf with a runtime exponent) cost more than the bytes:
// 63 µs measured in either type on an H100 80GB HBM3 at 700 W.
// Design: one pass, one thread per pixel: three values in, the 3 × 3 matrix
// in registers, three values out. (The TPU kernel keeps RGB interleaved along
// its lanes and builds the matrix from lane rolls, because a minor dimension
// of 3 would pad to 128 lanes there; a thread here simply owns a pixel.)
// Neighbouring threads read neighbouring 12-byte (6-byte) triplets, so a warp
// covers whole sectors. powf, not __powf: the PQ exponent 78.84 multiplies
// the relative error of its base, and the fast form's error would show as
// several codes. The matrix, the PQ constants, peak_nits / 10000 and gamma are
// arguments (the port keeps them in ops/color.py). The pack's multiply and add
// are rounded separately, as in pack.cu.
#include "common.cuh"

namespace hdrtv {
namespace {

struct ColorArgs {
  float m[9];                // BT.709 → BT.2020, row-major
  float m1, m2, c1, c2, c3;  // ST 2084
  float peak_norm, gamma;
};

__device__ __forceinline__ uint16_t pq_code(float lin2020, const ColorArgs& a) {
  const float y = fminf(fmaxf(__fmul_rn(lin2020, a.peak_norm), 0.f), 1.f);
  const float ym = powf(y, a.m1);
  const float base = (a.c1 + a.c2 * ym) / fmaxf(1.f + a.c3 * ym, 1e-12f);
  const float pq = powf(base, a.m2);
  return static_cast<uint16_t>(static_cast<int>(__fadd_rn(__fmul_rn(pq, 65535.f), 0.5f)));
}

template <typename T>
__global__ void colorimetric_kernel(const T* __restrict__ x, uint16_t* __restrict__ y,
                                    long long npix, ColorArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= npix) return;
  float lin[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    lin[c] = powf(fminf(fmaxf(to_float<T>(x[i * 3 + c]), 0.f), 1.f), a.gamma);
#pragma unroll
  for (int r = 0; r < 3; ++r)
    y[i * 3 + r] = pq_code(a.m[3 * r] * lin[0] + a.m[3 * r + 1] * lin[1] + a.m[3 * r + 2] * lin[2], a);
}

template <typename T>
int colorimetric(const void* x, void* y, long long npix, const ColorArgs& a, void* stream) {
  if (npix <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long long blocks = (npix + threads - 1) / threads;
  colorimetric_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<uint16_t*>(y), npix, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hdrtv

#define HDRTV_COLOR_PARAMS                                                                       \
  float m00, float m01, float m02, float m10, float m11, float m12, float m20, float m21,       \
      float m22, float pq_m1, float pq_m2, float pq_c1, float pq_c2, float pq_c3, float peak_norm, \
      float gamma
#define HDRTV_COLOR_ARGS                                                                   \
  hdrtv::ColorArgs {                                                                       \
    {m00, m01, m02, m10, m11, m12, m20, m21, m22}, pq_m1, pq_m2, pq_c1, pq_c2, pq_c3, peak_norm, \
        gamma                                                                              \
  }

// x: (npix, 3) in the element type; y: (npix, 3) u16.
extern "C" int hdrtv_colorimetric_f32(const void* x, void* y, long long npix, HDRTV_COLOR_PARAMS,
                                      void* stream) {
  return hdrtv::colorimetric<float>(x, y, npix, HDRTV_COLOR_ARGS, stream);
}

extern "C" int hdrtv_colorimetric_bf16(const void* x, void* y, long long npix, HDRTV_COLOR_PARAMS,
                                       void* stream) {
  return hdrtv::colorimetric<hdrtv::bf16>(x, y, npix, HDRTV_COLOR_ARGS, stream);
}
