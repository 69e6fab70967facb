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
// (135×240) it is ~7 GFLOP and every intermediate is 2.1 MB in bf16, so the
// whole chain lives in the 50 MB L2. Design: one host call launches a fixed
// sequence of 17 kernels (8 SFT passes, 9 convs) through three scratch
// buffers, instead of one launch with a 9-conv halo that would not fit
// shared memory at 240 columns × 32 channels. The residual add and the stage
// skip ride in the conv epilogue; the running x is updated in place.
//
// fp32: the SFT passes one thread per pixel, the convs on the FMA tile of
// conv3x3.cuh (a 32-channel conv uses a quarter of a 128-wide tile, Co
// masked), weights from the fp32 parameter block.
//
// bf16: the same 17 stages on the Hopper tiles, weights from the bf16 pack:
//   - the 8 SFT passes on chain_sm90.cuh's row tile (sft_sm90_natural): the
//     H·W natural rows of x (the running x, or h) and cond against the
//     natural 1×1 weights, resident, on wgmma; t written once;
//   - the 9 convs on conv3x3_sm90.cuh's tile, dense (a_sub = 0: C = 32 is
//     one 9-chunk list, the table the wrapper passes), weights resident, TMA
//     zero-filling t outside the image (135 rows are not a multiple of the
//     tile's 4: the masked stores hold the edge): conv1 BN = 32 with ReLU;
//     conv2 BN = 32 through the skip epilogue (x + conv2(t)), the fourth one
//     through the two-skip epilogue (x + conv2(t) rounded, then + fea3 and
//     rounded again, as _trunk3_kernel stores x before the stage skip);
//     up_conv1 BN = 128 with ReLU.
// What holds it then: 17 launches of a few µs each.
//
// Rounding points as in _trunk3_kernel: the SFT's hidden activations, t, h,
// the running x after each resblock, and the stage-skip sum before up_conv1
// are each stored in T; sums are fp32.
//
// Parameter block (fp32, packed by ops/megakernel.py trunk3_pack), for each
// of the 4 resblocks: sft1, conv1 w (3,3,C,C), conv1 b (C), sft2, conv2 w,
// conv2 b; then up_conv1 w (3,3,C,Co) and b (Co). An sft is
//     w0s (CC,CC) b0s (CC) w1s (CC,C) b1s (C) w0h (CC,CC) b0h (CC) w1h (CC,C) b1h (C)
// (the scale branch, then the shift branch; 1×1 weights as (in, out)). The
// bf16 pack (trunk3_pack_bf16) is the same order split in two: the weights
// in bf16, the biases in fp32.
#include "chain_sm90.cuh"

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
  static_assert(std::is_same<T, float>::value, "bf16 runs trunk3_sm90");
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

// The bf16 form on the Hopper tiles: weights (bf16) and biases (fp32) in
// trunk3_pack's order; table: the dense 9-chunk list (per_list 9) of a
// 32-channel conv; scratch as above.
int trunk3_sm90(const void* fea3, const void* cond, const void* weights, const void* biases, void* y,
                void* scratch, int H, int W, int C, int CC, int Co, const int* table, int per_list,
                void* stream) {
  if (C != kC || CC != kCC || !table || !biases) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long npix = static_cast<long long>(H) * W;
  const bf16* f = static_cast<const bf16*>(fea3);
  const bf16* wp = static_cast<const bf16*>(weights);
  const float* bp = static_cast<const float*>(biases);
  bf16* t = static_cast<bf16*>(scratch);
  bf16* h = t + npix * C;
  bf16* xr = h + npix * C;
  // the next SFT's eight pointers, w and b of scale0, scale1, shift0, shift1
  auto sft = [&](const void* (&p)[8]) {
    const int wn[4] = {CC * CC, CC * C, CC * CC, CC * C}, bn[4] = {CC, C, CC, C};
    for (int i = 0; i < 4; ++i) {
      p[2 * i] = wp;
      p[2 * i + 1] = bp;
      wp += wn[i];
      bp += bn[i];
    }
  };
  auto conv = [&](const bf16* x, const void* skip, const void* skip2, bf16* out, int co, int act) {
    const bf16* w = wp;
    const float* b = bp;
    wp += 9LL * C * co;
    bp += co;
    return conv3x3_sm90<1>(x, w, b, skip, out, H, W, C, 0, C, co, act, 0, table, per_list, s, nullptr, false, skip2);
  };

  const bf16* xin = f;
  cudaError_t err = cudaSuccess;
  for (int blk = 0; blk < 4 && err == cudaSuccess; ++blk) {
    const void* p1[8];
    const void* p2[8];
    sft(p1);
    err = sft_sm90_natural(xin, cond, t, p1, npix, C, CC, s);
    if (err == cudaSuccess) err = conv(t, nullptr, nullptr, h, C, ACT_RELU);
    sft(p2);
    if (err == cudaSuccess) err = sft_sm90_natural(h, cond, t, p2, npix, C, CC, s);
    // x = x + conv2(t); the last block also adds the stage skip fea3, rounding twice
    if (err == cudaSuccess) err = conv(t, xin, blk == 3 ? f : nullptr, xr, C, ACT_NONE);
    xin = xr;
  }
  if (err == cudaSuccess) err = conv(xr, nullptr, nullptr, static_cast<bf16*>(y), Co, ACT_RELU);
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

// params: fp32, the parameter block (biases, table and per_list unused);
// bf16, the pack's weights, with its biases and the conv tile's table.
extern "C" int hdrtv_trunk3_f32(const void* fea3, const void* cond, const void* params, const void* biases,
                                void* y, void* scratch, int H, int W, int C, int CC, int Co,
                                const int* table, int per_list, void* stream) {
  return hdrtv::trunk3<float>(fea3, cond, params, y, scratch, H, W, C, CC, Co, stream);
}

extern "C" int hdrtv_trunk3_bf16(const void* fea3, const void* cond, const void* params, const void* biases,
                                 void* y, void* scratch, int H, int W, int C, int CC, int Co,
                                 const int* table, int per_list, void* stream) {
  return hdrtv::trunk3_sm90(fea3, cond, params, biases, y, scratch, H, W, C, CC, Co, table, per_list,
                            stream);
}
