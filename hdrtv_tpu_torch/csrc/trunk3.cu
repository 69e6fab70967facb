// trunk3 — replaces the Pallas kernel fused_trunk3
// (hdrtv_tpu/ops/megakernel.py:1161): the natural-layout /8 stage of the LE
// UNet. Four SFT resblocks
//     t = sft1(x, cond); h = relu(conv1(t)); t = sft2(h, cond);
//     x = x + conv2(t)
// then the stage skip out = x + fea3 and relu(up_conv1(out)), over
// fea3 (H, W, 32), cond (H, W, 16) → (H, W, Co). The SFT of one branch is
// conv1(lrelu(conv0(cond))) with 1×1 convs (16→16→32); t = x·(scale+1)+shift.
// 'same' padding applies to the SFT output that feeds each conv: the conv's
// out-of-image taps read zero, as the TPU kernel's row mask makes them.
//
// Bound on this card: operations, but the stage is small: at 1080p
// (135×240) it is ~7 GFLOP and every intermediate is 4.1 MB, so the whole
// chain lives in the 50 MB L2. Design: one host call launches a fixed
// sequence of 17 kernels (8 SFT passes, 9 convs on the implicit-GEMM tile
// of conv3x3.cuh) through three scratch buffers, instead of one launch with
// a 9-conv halo that would not fit shared memory at 240 columns × 32
// channels. The residual add and the stage skip ride in the conv epilogue;
// the running x is updated in place. A 32-channel conv uses a quarter of a
// 128-wide tile (Co is masked). Both element types run the FMA tile: the
// weights come from the fp32 parameter block.
//
// Element types: fea3, cond, the output and the three scratch buffers are T
// (float or bf16); the parameter block is fp32 for both (for bf16 it holds
// weights already rounded to bf16, so every product is the TPU kernel's).
// Rounding points as in _trunk3_kernel: the SFT's hidden activations, t, h,
// the running x after each resblock, and the stage-skip sum before up_conv1
// are each stored in T; sums are fp32.
//
// Parameter block (fp32, packed by ops/megakernel.py trunk3_pack), for each
// of the 4 resblocks: sft1, conv1 w (3,3,C,C), conv1 b (C), sft2, conv2 w,
// conv2 b; then up_conv1 w (3,3,C,Co) and b (Co). An sft is
//     w0s (CC,CC) b0s (CC) w1s (CC,C) b1s (C) w0h (CC,CC) b0h (CC) w1h (CC,C) b1h (C)
// (the scale branch, then the shift branch; 1×1 weights as (in, out)).
#include "conv3x3.cuh"

namespace hdrtv {
namespace {

constexpr int kCC = 16;  // cond channels
constexpr int kC = 32;   // trunk channels

__host__ __device__ constexpr long long sft_floats(int cc, int c) { return 2LL * (cc * cc + cc + cc * c + c); }
__host__ __device__ constexpr long long conv_floats(int c, int co) { return 9LL * c * co + co; }

template <typename T, int CC, int C>
__global__ void sft_kernel(const T* __restrict__ x, const T* __restrict__ cond,
                           const float* __restrict__ prm, T* __restrict__ t, int npix) {
  constexpr int kN = static_cast<int>(sft_floats(CC, C));
  __shared__ float sp[kN];
  for (int i = threadIdx.x; i < kN; i += blockDim.x) sp[i] = prm[i];
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;

  constexpr int kBranch = CC * CC + CC + CC * C + C;
  float cv[CC];
#pragma unroll
  for (int i = 0; i < CC; ++i) cv[i] = to_float<T>(cond[static_cast<long long>(p) * CC + i]);
  float hid[2][CC];
#pragma unroll
  for (int br = 0; br < 2; ++br) {
    const float* w0 = sp + br * kBranch;
    const float* b0 = w0 + CC * CC;
#pragma unroll
    for (int j = 0; j < CC; ++j) {
      float v = b0[j];
#pragma unroll
      for (int i = 0; i < CC; ++i) v = fmaf(cv[i], w0[i * CC + j], v);
      hid[br][j] = round_to<T>(v >= 0.f ? v : v * 0.1f);
    }
  }
  const float* w1s = sp + CC * CC + CC;
  const float* b1s = w1s + CC * C;
  const float* w1h = sp + kBranch + CC * CC + CC;
  const float* b1h = w1h + CC * C;
  for (int n = 0; n < C; ++n) {
    float scale = b1s[n], shift = b1h[n];
#pragma unroll
    for (int j = 0; j < CC; ++j) {
      scale = fmaf(hid[0][j], w1s[j * C + n], scale);
      shift = fmaf(hid[1][j], w1h[j * C + n], shift);
    }
    const long long o = static_cast<long long>(p) * C + n;
    t[o] = static_cast<T>(to_float<T>(x[o]) * (scale + 1.f) + shift);
  }
}

template <typename T>
cudaError_t launch_sft(const T* x, const T* cond, const float* prm, T* t, int npix,
                       cudaStream_t stream) {
  const int threads = 128;
  sft_kernel<T, kCC, kC><<<(npix + threads - 1) / threads, threads, 0, stream>>>(x, cond, prm,
                                                                                 t, npix);
  return cudaGetLastError();
}

template <typename T>
cudaError_t conv(const T* x, const float* w, const T* skip, const T* skip2, T* y, int H, int W,
                 int C, int Co, int act, cudaStream_t stream) {
  return conv_same<T, float, T>(x, w, w + 9LL * C * Co, skip, skip2, y, H, W, C, Co, act, stream);
}

// scratch: 3 · H · W · C elements of T (t, h and the running x).
template <typename T>
int trunk3(const void* fea3, const void* cond, const void* params, void* y, void* scratch, int H,
           int W, int C, int CC, int Co, void* stream) {
  if (C != kC || CC != kCC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int npix = H * W;
  const T* f = static_cast<const T*>(fea3);
  const T* c = static_cast<const T*>(cond);
  const float* prm = static_cast<const float*>(params);
  T* t = static_cast<T*>(scratch);
  T* h = t + static_cast<long long>(npix) * C;
  T* xr = h + static_cast<long long>(npix) * C;
  const long long sft_n = sft_floats(CC, C);
  const long long conv_n = conv_floats(C, C);

  const T* xin = f;
  cudaError_t err = cudaSuccess;
  for (int blk = 0; blk < 4 && err == cudaSuccess; ++blk) {
    const float* sft1 = prm;
    const float* conv1 = sft1 + sft_n;
    const float* sft2 = conv1 + conv_n;
    const float* conv2 = sft2 + sft_n;
    prm = conv2 + conv_n;
    err = launch_sft<T>(xin, c, sft1, t, npix, s);
    if (err == cudaSuccess) err = conv<T>(t, conv1, nullptr, nullptr, h, H, W, C, C, ACT_RELU, s);
    if (err == cudaSuccess) err = launch_sft<T>(h, c, sft2, t, npix, s);
    // x = x + conv2(t); the last block also adds the stage skip fea3.
    if (err == cudaSuccess)
      err = conv<T>(t, conv2, xin, blk == 3 ? f : nullptr, xr, H, W, C, C, ACT_NONE, s);
    xin = xr;
  }
  if (err == cudaSuccess)
    err = conv<T>(xr, prm, nullptr, nullptr, static_cast<T*>(y), H, W, C, Co, ACT_RELU, s);
  return static_cast<int>(err);
}

}  // namespace
}  // namespace hdrtv

// Floats in the packed parameter block for (C, CC, Co); 0 when this build
// has no instance for those widths.
extern "C" long long hdrtv_trunk3_param_floats(int C, int CC, int Co) {
  if (C != hdrtv::kC || CC != hdrtv::kCC) return 0;
  return 4 * (2 * hdrtv::sft_floats(CC, C) + 2 * hdrtv::conv_floats(C, C)) +
         hdrtv::conv_floats(C, Co);
}

extern "C" int hdrtv_trunk3_f32(const void* fea3, const void* cond, const void* params, void* y,
                                void* scratch, int H, int W, int C, int CC, int Co,
                                void* stream) {
  return hdrtv::trunk3<float>(fea3, cond, params, y, scratch, H, W, C, CC, Co, stream);
}

extern "C" int hdrtv_trunk3_bf16(const void* fea3, const void* cond, const void* params, void* y,
                                 void* scratch, int H, int W, int C, int CC, int Co,
                                 void* stream) {
  return hdrtv::trunk3<hdrtv::bf16>(fea3, cond, params, y, scratch, H, W, C, CC, Co, stream);
}
