// sft_conv3 — replaces the Pallas kernel fused_sft_conv3_v2
// (hdrtv_tpu/ops/megakernel.py:866): y = act(conv3x3(sft(x, cond)) + b + skip)
// over s2d block tensors, x (Hb, Wb, C), cond (Hb, Wb, CC) → (Hb, Wb, Co);
// the SFT is two 1×1 branches (CC → CC, lrelu, → C) and t = x·(scale+1)+shift.
// 'same' padding applies to t: an out-of-image tap reads zero, not the SFT of
// a zero (the TPU kernel masks its halo rows after the SFT).
//
// Bound on this card: operations in fp32 (153 GFLOP dense for the conv and
// 25 GFLOP for the SFT per L0 call at 1080p, on the FMA units), bytes in bf16
// (0.33 GB per L0 call; both products run on the tensor cores). Design, first
// version: two launches from one host call. The SFT pass of pointwise.cuh writes t once,
// in the element type, into scratch the wrapper allocates; the implicit-GEMM
// tile of conv3x3.cuh reads it with zero-filled out-of-image taps, which
// gives the padding rule for free, and adds bias, skip and ReLU in its
// epilogue. Where it falls short of the TPU kernel: t makes one round trip
// through device memory (2·Hb·Wb·C elements per call; the scale and shift
// tensors and the hidden activations never leave the chip). A single launch
// that keeps t in shared memory with a one-pixel halo is later work.
#include "conv3x3.cuh"
#include "pointwise.cuh"

namespace {

template <typename T>
int sft_conv3(const void* x, const void* cond, const void* const* sft, const void* w,
              const void* b, const void* skip, void* y, void* t, int H, int W, int C, int CC,
              int Co, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  hdrtv::SftArgs a;
  a.x = x;
  a.cond = cond;
  a.add = nullptr;
  a.xsum = nullptr;
  a.t = t;
  hdrtv::set_sft_params(a, sft);
  a.npix = H * W;
  a.W = W;
  a.C = C;
  a.CC = CC;
  a.coarse = 0;
  cudaError_t err = hdrtv::launch_sft<T, T>(a, s);
  if (err == cudaSuccess)
    err = hdrtv::conv_same<T, T, T>(t, w, static_cast<const float*>(b), skip, nullptr, y, H, W, C,
                                    Co, relu ? hdrtv::ACT_RELU : hdrtv::ACT_NONE, s);
  return static_cast<int>(err);
}

}  // namespace

// sft: eight pointers, (w, b) of scale0, scale1, shift0, shift1; t: Hb·Wb·C
// elements of scratch.
extern "C" int hdrtv_sft_conv3_f32(const void* x, const void* cond, const void* const* sft,
                                   const void* w, const void* b, const void* skip, void* y,
                                   void* t, int H, int W, int C, int CC, int Co, int relu,
                                   void* stream) {
  return sft_conv3<float>(x, cond, sft, w, b, skip, y, t, H, W, C, CC, Co, relu, stream);
}

extern "C" int hdrtv_sft_conv3_bf16(const void* x, const void* cond, const void* const* sft,
                                    const void* w, const void* b, const void* skip, void* y,
                                    void* t, int H, int W, int C, int CC, int Co, int relu,
                                    void* stream) {
  return sft_conv3<hdrtv::bf16>(x, cond, sft, w, b, skip, y, t, H, W, C, CC, Co, relu, stream);
}
