// Shared helpers for the hdrtv_tpu_torch kernels: element-type loads and
// stores widened to fp32 (the accumulator type of every kernel here). The
// element type T is float or __nv_bfloat16; a store to bf16 rounds to nearest
// even, as a cast does in PyTorch and in JAX.
//
// Everything lives in an anonymous namespace so that each translation unit
// carries its own copy of any template it instantiates: the .cu files are
// compiled separately and linked into one shared library without relocatable
// device code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hdrtv {
namespace {

enum Act : int { ACT_NONE = 0, ACT_RELU = 1, ACT_LRELU = 2 };

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_LRELU) return v >= 0.f ? v : v * 0.1f;
  return v;
}

// The int8 code of an fp32 activation t for a layer quantized per tensor
// (conv3x3_s8.cuh): symmetric clamp(round(t / s), −128, 127), asymmetric
// clamp(round((t − z) / s), 0, 255) − 128; IEEE division, round half to even.
__device__ __forceinline__ int quantize_code(float t, float s, float z, int asym) {
  const float r = rintf(__fdiv_rn(__fsub_rn(t, z), s));
  if (asym) return static_cast<int>(fminf(fmaxf(r, 0.f), 255.f)) - 128;
  return static_cast<int>(fminf(fmaxf(r, -128.f), 127.f));
}

// What the wrappers pass for an int8 layer (a ctypes Structure of the same
// layout in ops/native.py), by host pointer: null runs a kernel's float form.
struct QuantParams {
  const int8_t* w;       // (Co, 9·C): row n holds the taps (dI, dJ) row-major, then the channel
  const float* yscale;   // (Co) x_scale · w_scale
  const float* bias;     // (Co) bias + zero-point term
  float s, z;            // x_scale; x_zero (0 when symmetric)
  int asym;              // 1: asymmetric (codes u − 128), 0: symmetric
  int pad;               // the code of an out-of-image tap
};

// The C interface passes a layer's QuantParams as an untyped host pointer.
inline const QuantParams* quant_params(const void* p) { return static_cast<const QuantParams*>(p); }

// Four consecutive elements of T, widened to fp32. The pointer must be
// aligned to four elements.
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  return make_float4(static_cast<float>(p[0]), static_cast<float>(p[1]),
                     static_cast<float>(p[2]), static_cast<float>(p[3]));
}
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v) {
  p[0] = static_cast<T>(v.x);
  p[1] = static_cast<T>(v.y);
  p[2] = static_cast<T>(v.z);
  p[3] = static_cast<T>(v.w);
}
template <>
__device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

using bf16 = __nv_bfloat16;

// bf16 is the upper half of an fp32: four of them are one 8-byte load.
template <>
__device__ __forceinline__ float4 load4<bf16>(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
template <>
__device__ __forceinline__ void store4<bf16>(bf16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T>
__device__ __forceinline__ float to_float(T v) {
  return static_cast<float>(v);
}
template <>
__device__ __forceinline__ float to_float<bf16>(bf16 v) {
  return __bfloat162float(v);
}

// The value a store to T and a load back would give: where the TPU kernels
// carry an intermediate in the compute dtype, the fp32 registers here hold
// the rounded value.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <typename T>
__device__ __forceinline__ float4 round4(float4 v) {
  return make_float4(round_to<T>(v.x), round_to<T>(v.y), round_to<T>(v.z), round_to<T>(v.w));
}

// ---------------------------------------------------------------------------
// Tensor-core building blocks for the bf16 instances: ldmatrix loads four
// 8 × 8 bf16 matrices from shared memory in the register layout
// mma.sync.m16n8k16 wants (.trans for an operand stored k-major, as B is),
// and the MMA itself multiplies bf16 × bf16 exactly and accumulates in fp32.
// Every row address handed to ldmatrix must be 16-byte aligned.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                               unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two consecutive elements of T, widened to fp32 (the pointer aligned to two
// elements), and back.
template <typename T>
__device__ __forceinline__ float2 load2(const T* p);
template <>
__device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 load2<bf16>(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <typename T>
__device__ __forceinline__ void store2(T* p, float2 v);
template <>
__device__ __forceinline__ void store2<float>(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

}  // namespace
}  // namespace hdrtv
