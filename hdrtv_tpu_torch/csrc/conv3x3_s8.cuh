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
// The same tile also runs the stride-2, (1,0)-padded s2d down conv of
// fused_down2's int8 body in fp32 and with a_sub = 0 (down2.cu; stride as in
// conv3x3.cuh), with one quantization of the shared input per branch
// (below), and takes the 2×2 max pool of block_conv3's pool_out form
// (conv3x3.cuh, `pool`). The bf16 int8 down2 with a_sub ≥ 1 quantizes once
// for every branch (quantize_planes, below) and runs conv3x3_s8_sm90.cuh.
//
// Requirements (the wrappers check them): C % 64 == 0, Co % 8 == 0, 16-byte
// aligned tensors.
#pragma once

#include <algorithm>

#include "conv3x3.cuh"

namespace hdrtv {
namespace {

// The plain quantization pass: the channel window [ch0, ch0 + cin) of each of
// npix pixels of cf channels, T → int8 codes (npix, cin), four at a time.
template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x, char4* __restrict__ q, long long npix, int cf,
                                int ch0, int cin, float s, float z, int asym) {
  const int quads = cin / 4;
  const long long n4 = npix * quads;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long pix = i / quads;
    const float4 v = load4<T>(x + pix * cf + ch0 + 4 * (i - pix * quads));
    q[i] = make_char4(static_cast<signed char>(quantize_code(v.x, s, z, asym)),
                      static_cast<signed char>(quantize_code(v.y, s, z, asym)),
                      static_cast<signed char>(quantize_code(v.z, s, z, asym)),
                      static_cast<signed char>(quantize_code(v.w, s, z, asym)));
  }
}

template <typename T>
cudaError_t quantize_window(const void* x, void* q, long long npix, int cf, int ch0, int cin,
                            const QuantParams& p, cudaStream_t stream) {
  if (cin % 4 || cf % 4 || ch0 % 4 || ch0 + cin > cf) return cudaErrorInvalidValue;
  const long long n4 = npix * (cin / 4);
  const unsigned blocks = static_cast<unsigned>(std::min<long long>((n4 + 255) / 256, 132LL * 16));
  quantize_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const T*>(x), static_cast<char4*>(q), npix, cf,
                                                   ch0, cin, p.s, p.z, p.asym);
  return cudaGetLastError();
}

// All n values of x (n % 4 == 0).
template <typename T>
cudaError_t quantize(const void* x, void* q, long long n, const QuantParams& p, cudaStream_t stream) {
  if (n % 4) return cudaErrorInvalidValue;
  return quantize_window<T>(x, q, n / 4, 4, 0, 4, p, stream);
}

// Branches: the consolidated CondNet down conv (fused_down2 with a_sub = 3
// and per-branch x_scales) quantizes its one input once per branch, with
// that branch's scale, zero point and pad code, and output channels
// [bi·m, bi·m + m) read branch bi's codes and its QuantParams (its weight
// rows, yscale and bias). m is a multiple of the tile's 128 channels, so a
// block never straddles two branches. One branch is the plain layer.
constexpr int kMaxBranches = 4;

// The branches' activation quantization, by value (the kernel's argument).
struct QuantPlanes {
  float s[kMaxBranches], inv[kMaxBranches], z[kMaxBranches];  // inv: 1/s rounded to nearest (the host's division)
  int asym[kMaxBranches];
  int nb;
  long long plane;  // bytes from one branch's codes to the next
};

// One pass over the bf16 window [ch0, ch0 + cin) of npix pixels of cf
// channels: each value's code under every branch's scale and zero point
// into that branch's plane (npix, cin), equal to what quantize_window's pass
// writes for that branch (quantize_code_rcp). It reads the window once where
// quantize_window passes read it once a branch. Thread t of a block takes
// the 16-byte channel group t % G (G = cin / 8 groups a pixel) of pixel
// t / G of each slab of 256 / G pixels, two slabs a step (two loads in
// flight), so no index is divided in the loop. An IEEE division for every
// value and branch (398 M at the 1080p consolidated conv) and a 64-bit
// index division a group made the first version bound by its arithmetic:
// 0.53 ms for its 665 MB on an H100 (PERF.md §6).
__global__ void quantize_planes_kernel(const bf16* __restrict__ x, int8_t* __restrict__ q, long long npix, int cf,
                                       int ch0, int cin, QuantPlanes p) {
  const int groups = cin / 8;
  const int slab = blockDim.x / groups;  // pixels a block takes a step, per load
  const int g = threadIdx.x % groups;
  const long long stride = static_cast<long long>(gridDim.x) * slab;
  for (long long pix0 = blockIdx.x * static_cast<long long>(slab) + threadIdx.x / groups; pix0 < npix;
       pix0 += 2 * stride) {
    uint4 raw[2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (pix0 + u * stride < npix)
        raw[u] = *reinterpret_cast<const uint4*>(x + (pix0 + u * stride) * cf + ch0 + 8 * g);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const long long pix = pix0 + u * stride;
      if (pix >= npix) break;
      const unsigned words[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
      float v[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[e]));
        v[2 * e] = f.x;
        v[2 * e + 1] = f.y;
      }
#pragma unroll
      for (int bi = 0; bi < kMaxBranches; ++bi) {
        if (bi < p.nb) {
          unsigned c[2] = {0u, 0u};
#pragma unroll
          for (int e = 0; e < 8; ++e)
            c[e / 4] |= (static_cast<unsigned>(quantize_code_rcp(v[e], p.s[bi], p.inv[bi], p.z[bi], p.asym[bi])) &
                         0xffu) << (8 * (e % 4));
          *reinterpret_cast<uint2*>(q + bi * p.plane + pix * cin + 8 * g) = make_uint2(c[0], c[1]);
        }
      }
    }
  }
}

// quantize_planes_kernel for the nb branches p (planes H·W·cin bytes apart
// in q, plane = npix·cin); the window and pitch whole 16-byte groups, cin/8
// a divisor of 256 (256 threads a block).
inline cudaError_t quantize_planes(const void* x, void* q, long long npix, int cf, int ch0, int cin,
                                   const QuantParams* p, int nb, cudaStream_t stream) {
  if (cin < 8 || cin % 8 || 256 % (cin / 8) || cf % 8 || ch0 % 8 || ch0 + cin > cf || nb < 1 || nb > kMaxBranches)
    return cudaErrorInvalidValue;
  QuantPlanes qp;
  for (int bi = 0; bi < kMaxBranches; ++bi) {
    qp.s[bi] = bi < nb ? p[bi].s : 1.f;
    qp.inv[bi] = 1.f / qp.s[bi];
    qp.z[bi] = bi < nb ? p[bi].z : 0.f;
    qp.asym[bi] = bi < nb ? p[bi].asym : 0;
  }
  qp.nb = nb;
  qp.plane = npix * cin;
  const long long slabs = (npix + 256 / (cin / 8) - 1) / (256 / (cin / 8));
  const unsigned blocks = static_cast<unsigned>(std::min<long long>((slabs + 1) / 2, 132LL * 16));
  quantize_planes_kernel<<<blocks, 256, 0, stream>>>(static_cast<const bf16*>(x), static_cast<int8_t*>(q), npix, cf,
                                                      ch0, cin, qp);
  return cudaGetLastError();
}

struct ConvS8Args {
  const int8_t* q;               // (nb, H, W, C) codes: one plane per branch
  long long qstride;             // H·W·C: from one branch's plane to the next
  QuantParams p[kMaxBranches];   // branch bi's layer (w, yscale, bias for its m channels)
  int nb, m;                     // branches; output channels per branch (nb·m = Co)
  const void* skip;              // (Ho, Wo, Co) TY or nullptr
  void* y;                       // (Ho, Wo, Co) TY, or (Ho/2, Wo/2, Co) with pool
  int H, W, Ho, Wo, C, Co, act, pool;
};

constexpr int kS8BK = 64;             // channels (bytes) of a K chunk
constexpr int kS8Pitch = kS8BK + 16;  // 80-byte shared rows

// Stride S: output pixel (ho, wo) and tap (dI, dJ) read input pixel
// (S·ho + dI − 1, S·wo + dJ − 1), as in conv3x3.cuh: 'same' for S = 1, the
// (1,0) padding of the s2d stride-2 convs for S = 2.
template <typename TY, int S>
__global__ void __launch_bounds__(kThreads) conv3x3_s8_kernel(ConvS8Args a) {
  __shared__ __align__(16) int8_t As[kBM][kS8Pitch];
  __shared__ __align__(16) int8_t Bs[kBN][kS8Pitch];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wm = (tid / 32) / 4;  // warp row: pixels [wm·64, wm·64 + 64)
  const int wn = (tid / 32) % 4;  // warp column: channels [wn·32, wn·32 + 32)
  const long long M = static_cast<long long>(a.Ho) * a.Wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const long long K = 9LL * a.C;
  // This block's branch, its codes and its layer; nl0: its first channel there.
  const int bi = n0 / a.m;
  const int nl0 = n0 - bi * a.m;
  const QuantParams& p = a.p[bi];
  const int8_t* __restrict__ q = a.q + bi * a.qstride;
  const int8_t* __restrict__ w = p.w;

  // Each thread stages two 16-byte pieces of the A tile (pixel idx/4, bytes
  // (idx%4)·16) and two of the B tile (output channel idx/4, the same bytes).
  int a_ho[2], a_wo[2];
  bool a_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long m = m0 + ((tid + r * kThreads) >> 2);
    a_ok[r] = m < M;
    out_pixel(a_ok[r] ? m : 0, a.Wo, a.pool, a_ho[r], a_wo[r]);
  }
  const unsigned padw = (static_cast<unsigned>(p.pad) & 0xffu) * 0x01010101u;

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
      const int hi = S * a_ho[r] + dI - 1;
      const int wi = S * a_wo[r] + dJ - 1;
      if (a_ok[r] && hi >= 0 && hi < a.H && wi >= 0 && wi < a.W)
        v = *reinterpret_cast<const uint4*>(q + (static_cast<long long>(hi) * a.W + wi) * a.C + c0 + off);
      ra[r] = v;
      const int nl = nl0 + (idx >> 2);
      rb[r] = nl < a.m ? *reinterpret_cast<const uint4*>(w + nl * K + tap * a.C + c0 + off)
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
      int ho, wo;
      out_pixel(m < M ? m : 0, a.Wo, a.pool, ho, wo);
      const long long pix = static_cast<long long>(ho) * a.Wo + wo;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + (lane % 4) * 2;
        const int nl = n - bi * a.m;
        const bool ok = m < M && n < a.Co;
        float2 v = make_float2(0.f, 0.f);
        if (ok) {
          const float2 ys = *reinterpret_cast<const float2*>(p.yscale + nl);
          const float2 bias = *reinterpret_cast<const float2*>(p.bias + nl);
          v = make_float2(__fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h]), ys.x), bias.x),
                          __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h + 1]), ys.y), bias.y));
          if (skip) {
            const float2 s = load2<TY>(skip + pix * a.Co + n);
            v = make_float2(__fadd_rn(v.x, s.x), __fadd_rn(v.y, s.y));
          }
          v = make_float2(apply_act(v.x, a.act), apply_act(v.y, a.act));
        }
        store_result2<TY>(y, v, m, n, a.Co, ok, a.pool);
      }
    }
  }
}

template <typename TY, int S>
cudaError_t launch_conv_s8(const ConvS8Args& a, cudaStream_t stream) {
  if (a.C % kS8BK || a.Co % 8 || a.nb < 1 || a.nb > kMaxBranches || a.nb * a.m != a.Co ||
      (a.nb > 1 && a.m % kBN))
    return cudaErrorInvalidValue;
  const long long M = static_cast<long long>(a.Ho) * a.Wo;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), static_cast<unsigned>((a.Co + kBN - 1) / kBN));
  conv3x3_s8_kernel<TY, S><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The int8 'same' conv of codes q (H, W, C) with the layer p: y = act(conv +
// bias (+ skip)), stored in TY; with pool, its 2×2 max pool (H/2, W/2, Co).
template <typename TY>
cudaError_t conv_s8(const void* q, const QuantParams& p, const void* skip, void* y, int H, int W,
                    int C, int Co, int act, cudaStream_t stream, int pool = 0) {
  ConvS8Args a;
  a.q = static_cast<const int8_t*>(q);
  a.qstride = 0;
  a.p[0] = p;
  a.nb = 1;
  a.m = Co;
  a.skip = skip;
  a.y = y;
  a.H = H;
  a.W = W;
  a.Ho = H;
  a.Wo = W;
  a.C = C;
  a.Co = Co;
  a.act = act;
  a.pool = pool;
  return launch_conv_s8<TY, 1>(a, stream);
}

// The 3×3 conv of a kernel's float or int8 form: without q, the float tile
// on the T tensor `in` with w and b; with q, the int8 tile on the codes `in`.
template <typename T, typename TY>
cudaError_t conv3x3_or_s8(const void* in, const void* w, const void* b, const QuantParams* q,
                          const void* skip, void* y, int H, int W, int C, int Co, int act,
                          cudaStream_t stream, int pool = 0) {
  if (q) return conv_s8<TY>(in, *q, skip, y, H, W, C, Co, act, stream, pool);
  return conv_same<T, T, TY>(in, w, static_cast<const float*>(b), skip, y, H, W, C, Co, act,
                             stream, pool);
}

}  // namespace
}  // namespace hdrtv
