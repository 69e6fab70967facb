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
// bf16) and writes 12.4 MB of u16, ~11 µs (~7 µs) at 3.35 TB/s. The first
// design, nine accurate powf a pixel (two and a divide per PQ channel, three
// for the gamma), took 61–63 µs in either type on an H100: bound by its
// arithmetic. This one issues no accurate power on the frame:
//
// - The PQ code is that of the exact curve: floor(PQ(y)·65535 + 0.5) with
//   PQ evaluated in fp64, y = clip(rgb'·peak_nits / 10000) in fp32 as before.
//   Its 65,536 thresholds T[k], the least fp32 rgb' whose code is ≥ k, are a
//   table. The kernel computes pq·65535 + 0.5 to a few hundredths of a code
//   (pq_value: y^m1 from lg2 and ex2 .approx; log(base) as 2·atanh(w),
//   w = (base − 1)/(base + 1), in fp64, where the exponent m2 = 78.84 would
//   multiply an fp32 rounding of base or of its log to half a code; the
//   power as 2^n · ex2.approx(f)). Its floor is the code unless the value
//   lies within kColorMargin = 1/8 of a code boundary; there one threshold
//   decides between the two codes beside it (a quarter of the values).
// - The gamma in bf16: the 16,257 bf16 values in [0, 1] looked up in a
//   table of powf(x, gamma), bit-equal to the first design. In fp32 the
//   power from lg2 and ex2 .approx: a relative error of a few 2^-22 in lin,
//   a few thousandths of a code after the PQ curve.
// - Memory: a thread takes 8 pixels, 24 values in 16-byte loads (fp32 six,
//   bf16 three) and 48 bytes of codes in three 16-byte stores (the frame's
//   last pixels one by one).
//
// The tables (thresholds 256 KB, gamma 64 KB) are built on the device by
// colorimetric_tables_kernel (one thread per threshold, a bisection over the
// fp32 bit patterns with the curve in fp64; one per gamma entry), by the
// caller once per device and (peak_nits, gamma) (ops/pack.py), and read
// through the L1. Against the plain version (torch.pow in fp32, whose base
// rounding alone moves a code near the top by up to ~0.4) the codes stay
// within one code. Measured on an H100 (PERF.md §6): 0.035 ms fp32, 0.030
// bf16, the same hot and cold: the fp64 series and its conversions hold it,
// not the bytes (the threshold loads 0.004 ms of it).
//
// The matrix, the PQ constants, peak_nits / 10000 and gamma are arguments
// (the port keeps them in ops/color.py). The pack's multiply and add are
// rounded separately, as in pack.cu.
#include "common.cuh"

namespace hdrtv {
namespace {

constexpr int kCodes = 65536;        // u16 codes: thresholds T[0 .. 65535], then T[65536] = +inf
constexpr int kGammaEntries = 0x3F81;  // bf16 bit patterns of [0, 1]: 0x0000 .. 0x3F80
constexpr int kColorPix = 8;         // pixels a thread
constexpr unsigned kInfBits = 0x7F800000u;  // +inf

struct ColorArgs {
  float m[9];                // BT.709 → BT.2020, row-major
  float m1, m2, c1, c2, c3;  // ST 2084
  float peak_norm, gamma;
};

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// y = clip(lin2020·peak_norm, 0, 1) as the kernel forms it.
__device__ __forceinline__ float pq_y(float lin2020, const ColorArgs& a) {
  return fminf(fmaxf(__fmul_rn(lin2020, a.peak_norm), 0.f), 1.f);
}

// The code of y on the exact curve: PQ in fp64.
__device__ __forceinline__ int pq_code_exact(float y, const ColorArgs& a) {
  const double ym = pow(static_cast<double>(y), static_cast<double>(a.m1));
  const double base = (static_cast<double>(a.c1) + static_cast<double>(a.c2) * ym) /
                      (1.0 + static_cast<double>(a.c3) * ym);
  return static_cast<int>(floor(pow(base, static_cast<double>(a.m2)) * 65535.0 + 0.5));
}

// thr[k] (1 ≤ k < kCodes): the least non-negative fp32 lin2020 whose code is
// ≥ k, by bisection over the bit patterns 0 (+0: code 0) .. 0x7F800000 (+inf:
// code 65535); thr[0] = −inf, thr[kCodes] = +inf. gam[u]: powf of the bf16
// value with bits u, u ≤ 0x3F80.
__global__ void colorimetric_tables_kernel(float* __restrict__ thr, float* __restrict__ gam, ColorArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < kCodes) {
    unsigned lo = 0u, hi = kInfBits;  // code(lo) < i ≤ code(hi)
    while (i > 0 && hi - lo > 1u) {
      const unsigned mid = lo + (hi - lo) / 2u;
      if (pq_code_exact(pq_y(__uint_as_float(mid), a), a) >= i)
        hi = mid;
      else
        lo = mid;
    }
    thr[i] = __uint_as_float(i > 0 ? hi : kInfBits | 0x80000000u);
    if (i == 0) thr[kCodes] = __uint_as_float(kInfBits);
  } else if (i < kCodes + kGammaEntries) {
    const unsigned u = static_cast<unsigned>(i - kCodes);
    gam[u] = powf(__uint_as_float(u << 16), a.gamma);
  }
}

// clip(x, 0, 1) ^ gamma: from the table in bf16 (x a bf16 value, so its
// clipped fp32 bits are a table index << 16), by lg2 and ex2 in fp32.
template <typename T>
__device__ __forceinline__ float linearize(float x, const ColorArgs& a, const float* gam);
template <>
__device__ __forceinline__ float linearize<bf16>(float x, const ColorArgs& a, const float* gam) {
  const float v = fminf(fmaxf(x, 0.f), 1.f);
  return __ldg(gam + (v > 0.f ? __float_as_uint(v) >> 16 : 0u));  // gam[0] = 0; −0 has the sign bit
}
template <>
__device__ __forceinline__ float linearize<float>(float x, const ColorArgs& a, const float*) {
  return ex2_approx(a.gamma * lg2_approx(fminf(fmaxf(x, 0.f), 1.f)));
}

__device__ __forceinline__ double rcp_approx_f64(double x) {
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;\n" : "=d"(y) : "d"(x));
  return y;
}

// PQ(y)·65535 + 0.5 to a few hundredths of a code (see the header): ym from
// the approximate instructions (its error moves the code least), then in
// fp64 w = (base − 1)/(base + 1) = (c1 − 1 + (c2 − c3)·ym) / (c1 + 1 + (c2 +
// c3)·ym) (a reciprocal refined twice: no branch), ln(base) = 2·atanh(w) by
// its series (|w| ≤ 0.09 for ST 2084: w^13/13 is below 2^-45), and 2^e for
// e = m2·log2(base) as 2^n · ex2.approx(e − n).
__device__ __forceinline__ float pq_value(float y, const ColorArgs& a) {
  const double ym = ex2_approx(a.m1 * lg2_approx(y));
  const double c1 = a.c1, c2 = a.c2, c3 = a.c3;
  const double den = (c1 + 1.0) + (c2 + c3) * ym;
  double r = rcp_approx_f64(den);
  r = fma(r, fma(-den, r, 1.0), r);
  r = fma(r, fma(-den, r, 1.0), r);
  const double w = ((c1 - 1.0) + (c2 - c3) * ym) * r, w2 = w * w;
  const double ath = w * (1.0 + w2 * (1.0 / 3 + w2 * (1.0 / 5 + w2 * (1.0 / 7 + w2 * (1.0 / 9 + w2 / 11)))));
  const double e = (2.0 / 0.69314718055994530942) * static_cast<double>(a.m2) * ath;
  const double n = rint(e);  // e ≤ 0, n ≥ −126 for any y > 0 on ST 2084's curve
  const float scale = __int_as_float((static_cast<int>(fmax(n, -126.0)) + 127) << 23);
  return __fmaf_rn(ex2_approx(static_cast<float>(e - n)) * scale, 65535.f, 0.5f);
}

constexpr float kColorMargin = 0.125f;  // codes: a value this near a boundary reads its threshold

// The codes of n pixels' values v (3n, interleaved RGB) into u: every value's
// lin2020 and pq_value first; then, for the values within kColorMargin of a
// code boundary, the boundary's threshold, all these loads issued together
// (predicated, no branch: with a branch per value the kernel took 0.043 ms
// against 0.035 on an H100); then each code: the floor, or the side of its
// threshold.
template <typename T, int N>
__device__ __forceinline__ void color_values(const float (&v)[3 * N], unsigned (&u)[3 * N], const ColorArgs& a,
                                             const float* thr, const float* gam) {
  float l[3 * N], t[3 * N];
  int c[3 * N], side[3 * N];  // side: −1 the boundary below c, +1 the one above, 0 neither near
#pragma unroll
  for (int p = 0; p < N; ++p) {
    float lin[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) lin[k] = linearize<T>(v[3 * p + k], a, gam);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int i = 3 * p + r;
      l[i] = a.m[3 * r] * lin[0] + a.m[3 * r + 1] * lin[1] + a.m[3 * r + 2] * lin[2];
      const float pv = pq_value(pq_y(l[i], a), a);
      c[i] = min(__float2int_rd(pv), kCodes - 1);
      const float f = pv - static_cast<float>(c[i]);
      side[i] = f < kColorMargin ? -1 : f > 1.f - kColorMargin ? 1 : 0;
    }
  }
#pragma unroll
  for (int i = 0; i < 3 * N; ++i) {
    t[i] = 0.f;
    if (side[i]) t[i] = __ldg(thr + c[i] + (side[i] > 0));  // thr[0] = −inf, thr[kCodes] = +inf
  }
#pragma unroll
  for (int i = 0; i < 3 * N; ++i)
    u[i] = static_cast<unsigned>(c[i] - (side[i] < 0 && l[i] < t[i]) + (side[i] > 0 && l[i] >= t[i]));
}

template <typename T>
__device__ __forceinline__ void load_values(const T* x, float (&v)[3 * kColorPix]);
template <>
__device__ __forceinline__ void load_values<float>(const float* x, float (&v)[3 * kColorPix]) {
#pragma unroll
  for (int i = 0; i < 3 * kColorPix / 4; ++i) {
    const float4 f = __ldcs(reinterpret_cast<const float4*>(x) + i);
    v[4 * i] = f.x, v[4 * i + 1] = f.y, v[4 * i + 2] = f.z, v[4 * i + 3] = f.w;
  }
}
template <>
__device__ __forceinline__ void load_values<bf16>(const bf16* x, float (&v)[3 * kColorPix]) {
#pragma unroll
  for (int i = 0; i < 3 * kColorPix / 8; ++i) {
    const uint4 g = __ldcs(reinterpret_cast<const uint4*>(x) + i);
    const unsigned w[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[8 * i + 2 * k] = __uint_as_float(w[k] << 16);
      v[8 * i + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

template <typename T>
__global__ void colorimetric_kernel(const T* __restrict__ x, uint16_t* __restrict__ y, long long npix, ColorArgs a,
                                    const float* __restrict__ thr, const float* __restrict__ gam) {
  const long long p0 = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kColorPix;
  if (p0 >= npix) return;
  if (p0 + kColorPix <= npix) {
    float v[3 * kColorPix];
    load_values<T>(x + p0 * 3, v);
    unsigned u[3 * kColorPix];
    color_values<T, kColorPix>(v, u, a, thr, gam);
#pragma unroll
    for (int i = 0; i < 3 * kColorPix / 8; ++i)
      __stcs(reinterpret_cast<uint4*>(y + p0 * 3) + i,
             make_uint4(u[8 * i] | u[8 * i + 1] << 16, u[8 * i + 2] | u[8 * i + 3] << 16,
                        u[8 * i + 4] | u[8 * i + 5] << 16, u[8 * i + 6] | u[8 * i + 7] << 16));
    return;
  }
  for (long long p = p0; p < npix; ++p) {  // the frame's last pixels
    const float px[3] = {to_float<T>(x[p * 3]), to_float<T>(x[p * 3 + 1]), to_float<T>(x[p * 3 + 2])};
    unsigned c[3];
    color_values<T, 1>(px, c, a, thr, gam);
    for (int r = 0; r < 3; ++r) y[p * 3 + r] = static_cast<uint16_t>(c[r]);
  }
}

template <typename T>
int colorimetric(const void* x, void* y, long long npix, const ColorArgs& a, const void* thr, const void* gam,
                 void* stream) {
  if (npix <= 0 || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long long groups = (npix + kColorPix - 1) / kColorPix;
  const long long blocks = (groups + threads - 1) / threads;
  colorimetric_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<uint16_t*>(y), npix, a, static_cast<const float*>(thr),
      static_cast<const float*>(gam));
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

// The tables of one (peak_nits, gamma): thr (65537) fp32 thresholds, gam
// (0x3F81) fp32 powers.
extern "C" int hdrtv_colorimetric_tables_f32(void* thr, void* gam, HDRTV_COLOR_PARAMS, void* stream) {
  const int threads = 256, blocks = (hdrtv::kCodes + hdrtv::kGammaEntries + threads - 1) / threads;
  hdrtv::colorimetric_tables_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(thr), static_cast<float*>(gam), HDRTV_COLOR_ARGS);
  return static_cast<int>(cudaGetLastError());
}

// x: (npix, 3) in the element type; y: (npix, 3) u16; both 16-byte aligned;
// thr, gam: the tables of the same parameters.
extern "C" int hdrtv_colorimetric_f32(const void* x, void* y, long long npix, HDRTV_COLOR_PARAMS, const void* thr,
                                      const void* gam, void* stream) {
  return hdrtv::colorimetric<float>(x, y, npix, HDRTV_COLOR_ARGS, thr, gam, stream);
}

extern "C" int hdrtv_colorimetric_bf16(const void* x, void* y, long long npix, HDRTV_COLOR_PARAMS, const void* thr,
                                       const void* gam, void* stream) {
  return hdrtv::colorimetric<hdrtv::bf16>(x, y, npix, HDRTV_COLOR_ARGS, thr, gam, stream);
}
