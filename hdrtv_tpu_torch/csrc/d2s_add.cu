// d2s_add — replaces the Pallas probe kernel _kernel of
// tools/proto_d2s_kernel.py (:34, pallas_call :49): the depth-to-space of a
// coarse (hbc, wbc, 4C) bf16 tensor into fine (2·hbc, 2·wbc, C) rows, plus a
// fine tensor, in fp32, rounded once to bf16:
//
//   out[2r+i, 2x+j, c] = bf16(f32(coarse[r, x, (2i+j)·C + c]) + f32(fine[2r+i, 2x+j, c]))
//
// (the probe's lane slice, minor split and stack; the same index map as
// reshape(hbc, wbc, 2, 2, C).transpose(0, 2, 1, 3, 4)). bf16 only, as the probe.
//
// Bound on this card: bytes. Each element is read once from each input and
// written once: 6 bytes per output element, 398 MB at the 1080p up_coarse
// shape (coarse 270 × 480 × 512, fine 540 × 960 × 128), ≈ 0.12 ms at
// 3.35 TB/s. There is no reuse, so the design is a grid-stride elementwise
// pass whose every thread moves 16 bytes of each tensor: eight channels of
// one fine pixel. Neighbouring threads take neighbouring channel groups, then
// neighbouring fine columns, so the fine read and the store are contiguous
// and the coarse read runs in 2·C-long stretches (both j of one coarse pixel).
// The TPU kernel's (tc | hbc) row tiling is not part of the contract.
#include "common.cuh"

namespace hdrtv {
namespace {

__global__ void d2s_add_kernel(const bf16* __restrict__ coarse, const bf16* __restrict__ fine,
                               bf16* __restrict__ out, int wbc, int c, long long groups) {
  const int cg_per_px = c / 8;
  const long long wf = 2LL * wbc;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups;
       g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long px = g / cg_per_px;  // fine pixel, row-major
    const int c8 = static_cast<int>(g - px * cg_per_px) * 8;
    const long long rf = px / wf;
    const long long xf = px - rf * wf;
    const long long r = rf >> 1, x = xf >> 1;
    const int sub = static_cast<int>(((rf & 1) << 1) | (xf & 1));  // 2i + j
    const long long src = (r * wbc + x) * 4LL * c + static_cast<long long>(sub) * c + c8;
    const uint4 a = *reinterpret_cast<const uint4*>(coarse + src);
    const uint4 b = *reinterpret_cast<const uint4*>(fine + px * c + c8);
    const unsigned* ua = reinterpret_cast<const unsigned*>(&a);
    const unsigned* ub = reinterpret_cast<const unsigned*>(&b);
    uint4 o;
    unsigned* uo = reinterpret_cast<unsigned*>(&o);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // bf16 is the upper half of an fp32: widen exactly, add once, round once.
      const float lo = __fadd_rn(__uint_as_float(ua[k] << 16), __uint_as_float(ub[k] << 16));
      const float hi = __fadd_rn(__uint_as_float(ua[k] & 0xffff0000u), __uint_as_float(ub[k] & 0xffff0000u));
      const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
      uo[k] = *reinterpret_cast<const unsigned*>(&v);
    }
    *reinterpret_cast<uint4*>(out + px * c + c8) = o;
  }
}

}  // namespace
}  // namespace hdrtv

// coarse (hbc, wbc, 4c), fine and out (2·hbc, 2·wbc, c), bf16, contiguous and
// 16-byte aligned; c a multiple of 8.
extern "C" int hdrtv_d2s_add_bf16(const void* coarse, const void* fine, void* out, int hbc, int wbc,
                                  int c, void* stream) {
  if (hbc <= 0 || wbc <= 0 || c <= 0 || c % 8) return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = 4LL * hbc * wbc * (c / 8);
  const int threads = 256;
  const long long want = (groups + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132LL * 16 ? want : 132LL * 16);  // 16 blocks per SM, then grid-stride
  hdrtv::d2s_add_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const hdrtv::bf16*>(coarse), static_cast<const hdrtv::bf16*>(fine),
      static_cast<hdrtv::bf16*>(out), wbc, c, groups);
  return static_cast<int>(cudaGetLastError());
}
