// tail — replaces the Pallas kernel fused_tail
// (hdrtv_tpu/ops/megakernel.py:489): the LE output slice over s2d tensors,
//     t   = SFT_layer2(s, cond1)        x·(scale+1)+shift, s = fea0 (+ d2s(up_coarse))
//     h   = relu(HR_conv2(t))           3×3 'same'
//     y   = conv_last(h) + b + skip     3×3 'same' to 12 channels + the long skip
//     out = pack ? u16(clip(y, 0, 1)·65535 + 0.5) as (Hb, 2, Wb, 6) : y
// With pack the output's flat layout is the natural (2Hb, 2Wb, 3) RGB48
// frame: channel 6a + k of block (i, j) goes to out[i, a, j, k].
//
// Bound on this card: bytes in bf16 (344 MB in, 12 MB out per 1080p call;
// 193 GFLOP dense on the tensor cores), operations in fp32. Design, first
// version: three launches from one host call.
//   1. the SFT pass of pointwise.cuh: un-folds up_coarse on read, rounds the
//      sum to the element type (it is not written: nothing else needs it) and
//      writes t once;
//   2. HR_conv2 + bias + ReLU on the conv tile of conv3x3.cuh → h;
//   3. conv_last_kernel, below: conv_last + bias + skip + pack in one pass.
// Both convs read zero for out-of-image taps, and t and h are stored only
// inside the image: that is the TPU kernel's rule that t and h are zero
// outside the image (it masks the halo rows it recomputes; relu(bias) there
// would be wrong). Where it falls short of the TPU kernel: t and h make one
// round trip each through device memory (2 × 265 MB per call in bf16); the
// d2s transpose, the add pass, y and the separate pack do not exist. Rounding
// points as in _tail_kernel: the summed s, the SFT's hidden activations, t
// and h are each stored in the element type; scale, shift, sums, biases and
// the skip add are fp32; the pack's multiply and add are rounded separately,
// so no FMA contraction moves the +0.5 boundary.
//
// conv_last_kernel: 12 output channels would use a tenth of the 128-wide conv
// tile, so it has its own. A block owns 8 rows × 16 columns of pixels, stages
// their one-pixel halo of h (10 × 18 pixels × C) and the whole weight
// (9·C × 12, padded to 16 columns) in shared memory once, and each of its
// eight warps computes one row of 16 pixels × 16 channels over the nine taps
// with no further barrier: bf16 on the tensor cores (mma.sync.m16n8k16, the
// A fragments read from the halo at the tap's offset with ldmatrix), fp32 on
// the FMA units (a lane owns one pixel and 8 channels).
//
// The native-int8 body (`quant`, megakernel.py:468-469, `qargs_hr`; the
// wrapper counts it as tail_w8a8), when the call passes HR_conv2's
// QuantParams: step 1 runs the SFT pass in its int8-output mode (t in fp32,
// quantized, never rounded to the element type), step 2 HR_conv2 on the int8
// tile of conv3x3_s8.cuh (folded bias, ReLU, h stored in the element type,
// as in the float body), step 3 conv_last_kernel as above. Bound on this
// card: bytes.
#include "conv3x3_s8.cuh"
#include "pointwise.cuh"

namespace hdrtv {
namespace {

constexpr int kLastRows = 8, kLastCols = 16;  // pixels of a block; one row per warp
constexpr int kLastHalo = (kLastRows + 2) * (kLastCols + 2);
constexpr int kLastN = 16;  // output channels, padded

struct LastArgs {
  const void* h;     // (H, W, C) T
  const void* w;     // (3, 3, C, Cl) T
  const float* b;    // (Cl)
  const void* skip;  // (H, W, Cl) T
  void* out;         // (H, 2, W, Cl/2) u16 when pack, else (H, W, Cl) T
  int H, W, C, Cl, pack;
};

template <typename T>
size_t conv_last_smem(int C) {
  return (static_cast<size_t>(kLastHalo) * (C + pw_pad<T>()) +
          static_cast<size_t>(9) * C * (kLastN + pw_pad<T>())) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kLastRows * 32) conv_last_kernel(LastArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = a.C + pw_pad<T>();          // elements per halo pixel
  constexpr int wpitch = kLastN + pw_pad<T>();  // elements per weight row
  T* halo = reinterpret_cast<T*>(smem);
  T* ws = halo + kLastHalo * pitch;
  const T* h = static_cast<const T*>(a.h);
  const T* w = static_cast<const T*>(a.w);
  const int r0 = blockIdx.y * kLastRows;
  const int c0 = blockIdx.x * kLastCols;

  const int quads = a.C / 4;
  for (int idx = threadIdx.x; idx < kLastHalo * quads; idx += blockDim.x) {
    const int px = idx / quads;
    const int q = idx - px * quads;
    const int gi = r0 + px / (kLastCols + 2) - 1;
    const int gj = c0 + px % (kLastCols + 2) - 1;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gi >= 0 && gi < a.H && gj >= 0 && gj < a.W)
      v = load4<T>(h + (static_cast<long long>(gi) * a.W + gj) * a.C + q * 4);
    store4<T>(halo + px * pitch + q * 4, v);
  }
  for (int idx = threadIdx.x; idx < 9 * a.C * (kLastN / 4); idx += blockDim.x) {
    const int k = idx / (kLastN / 4);
    const int q = idx - k * (kLastN / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q * 4 < a.Cl) v = load4<T>(w + static_cast<long long>(k) * a.Cl + q * 4);
    store4<T>(ws + k * wpitch + q * 4, v);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gi = r0 + warp;

  // y for the channel pair (n, n + 1) of pixel column px of this warp's row.
  auto emit = [&](int px, int n, float v0, float v1) {
    const int gj = c0 + px;
    if (gi >= a.H || gj >= a.W || n >= a.Cl) return;
    const long long m = static_cast<long long>(gi) * a.W + gj;
    const float2 bias = *reinterpret_cast<const float2*>(a.b + n);
    const float2 sk = load2<T>(static_cast<const T*>(a.skip) + m * a.Cl + n);
    const float y0 = (v0 + bias.x) + sk.x;
    const float y1 = (v1 + bias.y) + sk.y;
    if (!a.pack) {
      store2<T>(static_cast<T*>(a.out) + m * a.Cl + n, make_float2(y0, y1));
      return;
    }
    const int half = a.Cl / 2;
    const int par = n / half;
    ushort2 u;
    u.x = static_cast<unsigned short>(
        static_cast<int>(__fadd_rn(__fmul_rn(fminf(fmaxf(y0, 0.f), 1.f), 65535.f), 0.5f)));
    u.y = static_cast<unsigned short>(
        static_cast<int>(__fadd_rn(__fmul_rn(fminf(fmaxf(y1, 0.f), 1.f), 65535.f), 0.5f)));
    uint16_t* out = static_cast<uint16_t*>(a.out);
    *reinterpret_cast<ushort2*>(out + ((static_cast<long long>(gi) * 2 + par) * a.W + gj) * half +
                                n - par * half) = u;
  };

  if constexpr (std::is_same<T, bf16>::value) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int tap = 0; tap < 9; ++tap) {
      const T* arow = halo + ((warp + tap / 3) * (kLastCols + 2) + tap % 3 + lane % 16) * pitch +
                      (lane / 16) * 8;
      const T* brow = ws + (tap * a.C + lane % 8 + ((lane / 8) % 2) * 8) * wpitch + (lane / 16) * 8;
      for (int kk = 0; kk < a.C; kk += 16) {
        unsigned af[4], bf[4];
        ldmatrix_x4(af, arow + kk);
        ldmatrix_x4_trans(bf, brow + kk * wpitch);
        mma_bf16_16816(acc[0], af, bf[0], bf[1]);
        mma_bf16_16816(acc[1], af, bf[2], bf[3]);
      }
    }
    // Of each 16 × 8 result a lane holds rows lane/4 and lane/4 + 8, column pair (lane%4)·2.
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        emit(lane / 4 + hh * 8, nt * 8 + (lane % 4) * 2, acc[nt][2 * hh], acc[nt][2 * hh + 1]);
  } else {
    const int px = lane % 16;
    const int n0 = (lane / 16) * 8;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int tap = 0; tap < 9; ++tap) {
      const T* arow = halo + ((warp + tap / 3) * (kLastCols + 2) + tap % 3 + px) * pitch;
      const T* brow = ws + tap * a.C * wpitch + n0;
      for (int kk = 0; kk < a.C; kk += 4) {
        const float4 xv = load4<T>(arow + kk);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 w0 = load4<T>(brow + (kk + j) * wpitch);
          const float4 w1 = load4<T>(brow + (kk + j) * wpitch + 4);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = fmaf(xs[j], wv[e], acc[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 8; e += 2) emit(px, n0 + e, acc[e], acc[e + 1]);
  }
}

template <typename T>
cudaError_t launch_conv_last(const LastArgs& a, cudaStream_t stream) {
  static const cudaError_t attr = allow_large_smem(conv_last_kernel<T>);
  if (attr != cudaSuccess) return attr;
  const size_t bytes = conv_last_smem<T>(a.C);
  if (bytes > kMaxDynSmem || a.C % 16 || a.Cl % 4 || a.Cl > kLastN) return cudaErrorInvalidValue;
  const dim3 grid((a.W + kLastCols - 1) / kLastCols, (a.H + kLastRows - 1) / kLastRows);
  conv_last_kernel<T><<<grid, kLastRows * 32, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int tail(const void* s, const void* up, const void* cond1, const void* skip,
         const void* const* sft, const void* w_hr, const void* b_hr, const QuantParams* q_hr,
         const void* w_last, const void* b_last, void* out, void* t, void* h, int H, int W, int C,
         int CC, int Cl, int pack, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SftArgs f;
  f.x = s;
  f.cond = cond1;
  f.add = up;
  f.xsum = nullptr;
  set_sft_out(f, t, q_hr);
  set_sft_params(f, sft);
  f.npix = H * W;
  f.W = W;
  f.C = C;
  f.CC = CC;
  f.coarse = up != nullptr;
  LastArgs l;
  l.h = h;
  l.w = w_last;
  l.b = static_cast<const float*>(b_last);
  l.skip = skip;
  l.out = out;
  l.H = H;
  l.W = W;
  l.C = C;
  l.Cl = Cl;
  l.pack = pack;
  cudaError_t err = launch_sft<T, T>(f, st);
  if (err == cudaSuccess)
    err = conv3x3_or_s8<T, T>(t, w_hr, b_hr, q_hr, nullptr, h, H, W, C, C, ACT_RELU, st);
  if (err == cudaSuccess) err = launch_conv_last<T>(l, st);
  return static_cast<int>(err);
}

}  // namespace
}  // namespace hdrtv

// up: nullptr, or up_coarse (H/2, W/2, 4C). sft: eight pointers, (w, b) of
// scale0, scale1, shift0, shift1. q_hr: null for the float form, else
// HR_conv2's int8 parameters (w_hr and b_hr unused). Scratch: t H·W·C elements
// (bytes, codes, with q_hr) and h H·W·C elements.
extern "C" int hdrtv_tail_f32(const void* s, const void* up, const void* cond1, const void* skip,
                              const void* const* sft, const void* w_hr, const void* b_hr,
                              const void* q_hr, const void* w_last, const void* b_last, void* out,
                              void* t, void* h, int H, int W, int C, int CC, int Cl, int pack,
                              void* stream) {
  return hdrtv::tail<float>(s, up, cond1, skip, sft, w_hr, b_hr, hdrtv::quant_params(q_hr), w_last,
                            b_last, out, t, h, H, W, C, CC, Cl, pack, stream);
}

extern "C" int hdrtv_tail_bf16(const void* s, const void* up, const void* cond1, const void* skip,
                               const void* const* sft, const void* w_hr, const void* b_hr,
                               const void* q_hr, const void* w_last, const void* b_last, void* out,
                               void* t, void* h, int H, int W, int C, int CC, int Cl, int pack,
                               void* stream) {
  return hdrtv::tail<hdrtv::bf16>(s, up, cond1, skip, sft, w_hr, b_hr, hdrtv::quant_params(q_hr),
                                  w_last, b_last, out, t, h, H, W, C, CC, Cl, pack, stream);
}
