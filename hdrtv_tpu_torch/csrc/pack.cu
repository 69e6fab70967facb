// pack_rgb48 — replaces the Pallas kernel pack_rgb48
// (hdrtv_tpu/ops/pack.py:71): the RGB48 delivery pack
// u16 = (int)(clip(x, 0, 1) · 65535 + 0.5), truncating.
//
// Bound on this card: bytes. A 1080p frame reads 24.9 MB of fp32 (12.4 MB of
// bf16) and writes 12.4 MB of u16, ~11 µs (~7 µs) at 3.35 TB/s; there is no
// reuse to exploit. A bf16 input is widened to fp32 first, as the TPU kernel
// does, so the pack is exact for both element types.
// Design: a streaming pass over groups of 8 elements, each one 16-byte u16
// store from one 16-byte load (8 bf16) or two (8 fp32), loads marked
// evict-first (__ldcs: read once), in a grid-stride loop over a few waves of
// blocks a multiprocessor, two groups in flight a thread: an eighth of the
// memory instructions of a pass with one thread an element, whose count, not
// its bytes, holds such a pass back. The groups start where input and output are
// both 16-byte aligned; the elements before (a scalar head of at most 7) and
// after them (a tail of at most 7) are packed one at a time by the same
// launch. ops/pack.py places the output as many elements past a 16-byte
// boundary as the input (a view at an odd offset: the pack takes any
// contiguous tensor), so both reach one at the same element; a pair that
// never does is packed one element at a time.
// The multiply and the add are rounded separately (__fmul_rn, __fadd_rn) so
// the compiler cannot contract them into one FMA: the +0.5 boundary then
// rounds exactly as the two-step reference does.
#include "common.cuh"

#include <algorithm>
#include <cstdint>

namespace hdrtv {
namespace {

constexpr int kPackThreads = 256;
constexpr int kPackWaves = 16;  // blocks a multiprocessor: two waves of 8 resident 256-thread blocks

__device__ __forceinline__ unsigned pack1(float x) {
  const float v = fminf(fmaxf(x, 0.f), 1.f);
  return static_cast<unsigned>(static_cast<int>(__fadd_rn(__fmul_rn(v, 65535.f), 0.5f))) & 0xffffu;
}
__device__ __forceinline__ unsigned pack2(float lo, float hi) { return pack1(lo) | (pack1(hi) << 16); }

// Eight consecutive elements from a 16-byte aligned address, widened to fp32.
template <typename T>
struct Group8;

template <>
struct Group8<float> {
  static __device__ __forceinline__ uint4 pack(const float* x) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(x));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(x) + 1);
    return make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y), pack2(b.z, b.w));
  }
};

template <>
struct Group8<bf16> {
  // bf16 → fp32 is exact: the 16 bits are the high half of the float.
  static __device__ __forceinline__ float lo(unsigned w) { return __uint_as_float(w << 16); }
  static __device__ __forceinline__ float hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
  static __device__ __forceinline__ uint4 pack(const bf16* x) {
    const uint4 a = __ldcs(reinterpret_cast<const uint4*>(x));
    return make_uint4(pack2(lo(a.x), hi(a.x)), pack2(lo(a.y), hi(a.y)), pack2(lo(a.z), hi(a.z)),
                      pack2(lo(a.w), hi(a.w)));
  }
};

// Elements [0, head) and [head + 8·groups, n) one at a time, the groups of 8
// from `head` on, where x + head and y + head are both 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kPackThreads) pack_rgb48_kernel(const T* __restrict__ x,
                                                                  uint16_t* __restrict__ y, long long n,
                                                                  long long head, long long groups) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tail = head + 8 * groups;
  for (long long i = tid; i < head + (n - tail); i += stride) {
    const long long e = i < head ? i : tail + (i - head);
    y[e] = static_cast<uint16_t>(pack1(to_float<T>(x[e])));
  }
  const T* xg = x + head;
  uint4* yg = reinterpret_cast<uint4*>(y + head);
  // two groups in flight: both loads issued before either store
  for (long long g = tid; g < groups; g += 2 * stride) {
    const uint4 a = Group8<T>::pack(xg + 8 * g);
    if (g + stride < groups) {
      const uint4 b = Group8<T>::pack(xg + 8 * (g + stride));
      yg[g] = a;
      yg[g + stride] = b;
    } else {
      yg[g] = a;
    }
  }
}

template <typename T>
int pack_rgb48(const void* x, void* y, long long n, void* stream) {
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The first element from which both pointers are 16-byte aligned, if any
  // lies within 8 (x holds whole elements, y whole u16).
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), ya = reinterpret_cast<uintptr_t>(y);
  long long head = n, groups = 0;
  for (long long h = 0; h < 8 && h < n; ++h)
    if ((xa + h * sizeof(T)) % 16 == 0 && (ya + 2 * h) % 16 == 0) {
      head = h;
      groups = (n - h) / 8;
      break;
    }
  const long long work = std::max(groups, head + (n - head - 8 * groups));
  const long long blocks =
      std::max(1LL, std::min((work + kPackThreads - 1) / kPackThreads, static_cast<long long>(sms) * kPackWaves));
  pack_rgb48_kernel<T><<<static_cast<unsigned>(blocks), kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<uint16_t*>(y), n, head, groups);
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

// How many launcher caches (csrc/common.cuh DeviceCache) device ordinal dev
// has filled in this process: one per launcher instance launched there.
extern "C" int hdrtv_launcher_caches(int dev) {
  if (dev < 0 || dev >= hdrtv::kMaxDevices) return -1;
  return hdrtv::g_device_caches[dev].load();
}
