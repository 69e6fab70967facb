// Native-int8 (W8A8) 3×3 'same' convolution on the int8 tensor cores, and the
// activation quantization it reads: the core of the int8 forms of
// block_conv3.cu, sft_conv3.cu, resblock.cu and tail.cu (the Pallas bodies
// behind `quant` in hdrtv_tpu/ops/conv_kernels.py:180-227 and
// hdrtv_tpu/ops/megakernel.py _taps_conv_q, :1358).
//
// A layer's activations are quantized per tensor, its weights per output
// channel (ops/w8a8.py QArgs, prepared once at load):
//   symmetric:  code = clamp(round(t / s), −128, 127)
//   asymmetric: code = clamp(round((t − z) / s), 0, 255) − 128
// with IEEE division and round-half-to-even, and
//   y = float(Σ_taps code · w_int8) · yscale[n] + bias[n]      (int32 sum)
// where yscale = s · w_scale and bias already holds the zero-point term
// (z + 128·s) · Σ w_int8·w_scale. An out-of-image tap reads the layer's pad
// code (the code of t = 0: 0 when symmetric), as the TPU body quantizes its
// zeroed halo rows and pads its shifted tap views with that code.
//
// The tile: the grid and the 128 pixels × 128 output channels of
// conv3x3_mma_kernel (conv3x3.cuh), eight warps as 2 (pixels) × 4 (channels),
// a warp 64 × 32 as 4 × 4 tiles of mma.sync.m16n8k32 (s8 × s8, s32
// accumulation: 64 int32 accumulators a thread). A K chunk is one tap × 64
// channels: 64 bytes of each of the 128 pixel rows (A) and of the 128 weight
// rows (B), staged in shared memory with 16-byte loads and an 80-byte pitch,
// which keeps ldmatrix free of bank conflicts. The weight is stored
// (Co, 9·C), K-contiguous per output channel, so B's fragments come from
// ldmatrix without a transpose (ldmatrix has none for 8-bit elements). The
// next chunk is fetched into registers during the MMAs.
//
// The epilogue converts, scales and adds with the explicit _rn intrinsics, so
// nvcc cannot contract them into an FMA and the kernel equals its plain
// version wherever the codes agree: y = (float(acc) · yscale) + bias, then
// + skip, then the activation, one store in TY.
//
// Requirements (the wrappers check them): C % 64 == 0, Co % 8 == 0, 16-byte
// aligned tensors.
#pragma once

#include <algorithm>

#include "conv3x3.cuh"

namespace hdrtv {
namespace {

// The plain quantization pass: (n) T → (n) int8 codes, four at a time.
template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x, char4* __restrict__ q, long long n4, float s,
                                float z, int asym) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float4 v = load4<T>(x + 4 * i);
    q[i] = make_char4(static_cast<signed char>(quantize_code(v.x, s, z, asym)),
                      static_cast<signed char>(quantize_code(v.y, s, z, asym)),
                      static_cast<signed char>(quantize_code(v.z, s, z, asym)),
                      static_cast<signed char>(quantize_code(v.w, s, z, asym)));
  }
}

template <typename T>
cudaError_t quantize(const void* x, void* q, long long n, const QuantParams& p, cudaStream_t stream) {
  if (n % 4) return cudaErrorInvalidValue;
  const long long n4 = n / 4;
  const unsigned blocks = static_cast<unsigned>(std::min<long long>((n4 + 255) / 256, 132LL * 16));
  quantize_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const T*>(x), static_cast<char4*>(q), n4,
                                                   p.s, p.z, p.asym);
  return cudaGetLastError();
}

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct ConvS8Args {
  const int8_t* q;   // (H, W, C) codes
  QuantParams p;
  const void* skip;  // (H, W, Co) TY or nullptr
  void* y;           // (H, W, Co) TY
  int H, W, C, Co, act;
};

constexpr int kS8BK = 64;             // channels (bytes) of a K chunk
constexpr int kS8Pitch = kS8BK + 16;  // 80-byte shared rows

template <typename TY>
__global__ void __launch_bounds__(kThreads) conv3x3_s8_kernel(ConvS8Args a) {
  __shared__ __align__(16) int8_t As[kBM][kS8Pitch];
  __shared__ __align__(16) int8_t Bs[kBN][kS8Pitch];

  const int8_t* __restrict__ q = a.q;
  const int8_t* __restrict__ w = a.p.w;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wm = (tid / 32) / 4;  // warp row: pixels [wm·64, wm·64 + 64)
  const int wn = (tid / 32) % 4;  // warp column: channels [wn·32, wn·32 + 32)
  const long long M = static_cast<long long>(a.H) * a.W;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const long long K = 9LL * a.C;

  // Each thread stages two 16-byte pieces of the A tile (pixel idx/4, bytes
  // (idx%4)·16) and two of the B tile (output channel idx/4, the same bytes).
  int a_ho[2], a_wo[2];
  bool a_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long m = m0 + ((tid + r * kThreads) >> 2);
    a_ok[r] = m < M;
    a_ho[r] = a_ok[r] ? static_cast<int>(m / a.W) : 0;
    a_wo[r] = a_ok[r] ? static_cast<int>(m % a.W) : 0;
  }
  const unsigned padw = (static_cast<unsigned>(a.p.pad) & 0xffu) * 0x01010101u;

  const int kc = a.C / kS8BK;  // channel chunks per tap
  const int KT = 9 * kc;
  uint4 ra[2], rb[2];

  auto fetch = [&](int kt) {
    const int tap = kt / kc;
    const int c0 = (kt - tap * kc) * kS8BK;
    const int dI = tap / 3, dJ = tap % 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = tid + r * kThreads;
      const int off = (idx & 3) * 16;
      uint4 v = make_uint4(padw, padw, padw, padw);
      const int hi = a_ho[r] + dI - 1;
      const int wi = a_wo[r] + dJ - 1;
      if (a_ok[r] && hi >= 0 && hi < a.H && wi >= 0 && wi < a.W)
        v = *reinterpret_cast<const uint4*>(q + (static_cast<long long>(hi) * a.W + wi) * a.C + c0 + off);
      ra[r] = v;
      const int n = n0 + (idx >> 2);
      rb[r] = n < a.Co ? *reinterpret_cast<const uint4*>(w + n * K + tap * a.C + c0 + off)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  auto stage = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = tid + r * kThreads;
      *reinterpret_cast<uint4*>(&As[idx >> 2][(idx & 3) * 16]) = ra[r];
      *reinterpret_cast<uint4*>(&Bs[idx >> 2][(idx & 3) * 16]) = rb[r];
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  fetch(0);
  stage();
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) fetch(kt + 1);
#pragma unroll
    for (int ks = 0; ks < kS8BK; ks += 32) {
      unsigned af[4][4], bf[2][4];
      // A: matrices (rows 0-7, k 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31)
      // = a0..a3 of m16n8k32.
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], &As[wm * 64 + mt * 16 + (lane % 16)][ks + (lane / 16) * 16]);
      // B (rows = output channels): matrices (n-tile 2np, k 0-15), (2np, 16-31),
      // (2np+1, 0-15), (2np+1, 16-31) = b0, b1 of two n-tiles.
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(bf[np], &Bs[wn * 32 + np * 16 + (lane / 16) * 8 + (lane % 8)]
                               [ks + ((lane / 8) % 2) * 16]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8_16832(acc[mt][nt], af[mt], bf[nt / 2][(nt % 2) * 2], bf[nt / 2][(nt % 2) * 2 + 1]);
    }
    __syncthreads();
    if (kt + 1 < KT) {
      stage();
      __syncthreads();
    }
  }

  // A thread holds, of each 16 × 8 tile, rows lane/4 and lane/4 + 8 and the
  // column pair (lane%4)·2.
  const TY* skip = static_cast<const TY*>(a.skip);
  TY* y = static_cast<TY*>(a.y);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm * 64 + mt * 16 + h * 8 + lane / 4;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + (lane % 4) * 2;
        if (n >= a.Co) continue;
        const float2 ys = *reinterpret_cast<const float2*>(a.p.yscale + n);
        const float2 bias = *reinterpret_cast<const float2*>(a.p.bias + n);
        float2 v = make_float2(__fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h]), ys.x), bias.x),
                               __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h + 1]), ys.y), bias.y));
        const long long off = m * a.Co + n;
        if (skip) {
          const float2 s = load2<TY>(skip + off);
          v = make_float2(__fadd_rn(v.x, s.x), __fadd_rn(v.y, s.y));
        }
        store2<TY>(y + off, make_float2(apply_act(v.x, a.act), apply_act(v.y, a.act)));
      }
    }
  }
}

// The int8 conv of codes q (H, W, C) with the layer p: y = act(conv + bias
// (+ skip)), stored in TY.
template <typename TY>
cudaError_t conv_s8(const void* q, const QuantParams& p, const void* skip, void* y, int H, int W,
                    int C, int Co, int act, cudaStream_t stream) {
  if (C % kS8BK || Co % 8) return cudaErrorInvalidValue;
  ConvS8Args a;
  a.q = static_cast<const int8_t*>(q);
  a.p = p;
  a.skip = skip;
  a.y = y;
  a.H = H;
  a.W = W;
  a.C = C;
  a.Co = Co;
  a.act = act;
  const long long M = static_cast<long long>(H) * W;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), static_cast<unsigned>((Co + kBN - 1) / kBN));
  conv3x3_s8_kernel<TY><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The 3×3 conv of a kernel's float or int8 form: without q, the float tile
// on the T tensor `in` with w and b; with q, the int8 tile on the codes `in`.
template <typename T, typename TY>
cudaError_t conv3x3_or_s8(const void* in, const void* w, const void* b, const QuantParams* q,
                          const void* skip, void* y, int H, int W, int C, int Co, int act,
                          cudaStream_t stream) {
  if (q) return conv_s8<TY>(in, *q, skip, y, H, W, C, Co, act, stream);
  return conv_same<T, T, TY>(in, w, static_cast<const float*>(b), skip, nullptr, y, H, W, C, Co, act,
                             stream);
}

}  // namespace
}  // namespace hdrtv
