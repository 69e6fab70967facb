// resblock — replaces the Pallas kernel fused_resblock
// (hdrtv_tpu/ops/megakernel.py:1012): ResBlock_with_SFT over s2d block tensors,
//     out = xin + conv2(sft2(relu(conv1(sft1(xin, cond))), cond)),
// with xin = x, or round(x + x_add), or round(x + d2s(up_coarse)) for the
// up path (up_coarse is (Hb/2, Wb/2, 4C); its block d2s has x's shape).
//
// Bound on this card: operations in fp32 (two dense 3×3 convs, 77 GFLOP per
// L1 call at 1080p, and two SFTs, on the FMA units), bytes in bf16 (every
// product on the tensor cores). Design, first version: a fixed sequence of four
// launches from one host call, on the shared tiles:
//   1. SFT1 (pointwise.cuh): reads x (and un-folds up_coarse or reads x_add on
//      the way, writing the rounded sum once: it is also the residual) → t;
//   2. conv1 + bias + ReLU (conv3x3.cuh) → h1, kept in fp32 whatever the
//      element type, as the TPU kernel carries it into SFT2;
//   3. SFT2 on the fp32 h1 → t;
//   4. conv2 + bias + residual → out.
// Out-of-image taps of both convs read zero (the TPU kernel's row masks on
// t1 and t2). Where it falls short of the TPU kernel: t (twice), h1 and the
// summed input make a round trip through device memory; the d2s transpose and
// the separate add pass do not exist. One launch with a two-pixel halo is
// later work. The kernel takes any Hb; the TPU kernel's even-row rule is its
// tiling.
//
// The native-int8 body (`quant`, megakernel.py:988-1004; the wrapper counts
// it as resblock_w8a8), when the call passes both convs' QuantParams: the
// same four launches with both convs on the int8 tile of conv3x3_s8.cuh and
// both SFT passes in their int8-output mode, so t1 and t2 travel as codes
// (1 byte a value) and are never rounded to the element type:
//   1. SFT1 (summed input written once as before) → codes of t1;
//   2. int8 conv1 + folded bias + ReLU → h1 in fp32;
//   3. SFT2 on the fp32 h1 → codes of t2;
//   4. int8 conv2 + folded bias + the summed input → out.
// Out-of-image taps read each conv's pad code. Bound on this card: bytes.
#include "conv3x3_s8.cuh"
#include "pointwise.cuh"

namespace {

template <typename T>
int resblock(const void* x, const void* cond, const void* const* sft1, const void* w1,
             const void* b1, const hdrtv::QuantParams* q1, const void* const* sft2, const void* w2,
             const void* b2, const hdrtv::QuantParams* q2, const void* add, int coarse, void* y,
             void* t, void* h1, void* xsum, int H, int W, int C, int CC, void* stream) {
  using hdrtv::ACT_NONE;
  using hdrtv::ACT_RELU;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  hdrtv::SftArgs a;
  a.x = x;
  a.cond = cond;
  a.add = add;
  a.xsum = xsum;
  hdrtv::set_sft_out(a, t, q1);
  hdrtv::set_sft_params(a, sft1);
  a.npix = H * W;
  a.W = W;
  a.C = C;
  a.CC = CC;
  a.coarse = coarse;
  if ((add && !xsum) || !q1 != !q2) return static_cast<int>(cudaErrorInvalidValue);
  const void* xin = add ? xsum : x;

  cudaError_t err = hdrtv::launch_sft<T, T>(a, s);
  if (err == cudaSuccess)
    err = hdrtv::conv3x3_or_s8<T, float>(t, w1, b1, q1, nullptr, h1, H, W, C, C, ACT_RELU, s);
  a.x = h1;
  a.add = nullptr;
  a.xsum = nullptr;
  a.coarse = 0;
  hdrtv::set_sft_out(a, t, q2);
  hdrtv::set_sft_params(a, sft2);
  if (err == cudaSuccess) err = hdrtv::launch_sft<T, float>(a, s);
  if (err == cudaSuccess)
    err = hdrtv::conv3x3_or_s8<T, T>(t, w2, b2, q2, xin, y, H, W, C, C, ACT_NONE, s);
  return static_cast<int>(err);
}

}  // namespace

// sft1, sft2: eight pointers each, (w, b) of scale0, scale1, shift0, shift1.
// q1, q2: both null for the float form, else the two convs' int8 parameters
// (w1, b1, w2, b2 unused). add: nullptr, x_add (coarse = 0) or up_coarse
// (coarse = 1). Scratch: t Hb·Wb·C elements (bytes, codes, with q1 and q2), h1
// Hb·Wb·C floats, xsum Hb·Wb·C elements when add is set.
extern "C" int hdrtv_resblock_f32(const void* x, const void* cond, const void* const* sft1,
                                  const void* w1, const void* b1, const void* q1,
                                  const void* const* sft2, const void* w2, const void* b2,
                                  const void* q2, const void* add, int coarse, void* y, void* t,
                                  void* h1, void* xsum, int H, int W, int C, int CC, void* stream) {
  return resblock<float>(x, cond, sft1, w1, b1, hdrtv::quant_params(q1), sft2, w2, b2,
                         hdrtv::quant_params(q2), add, coarse, y, t, h1, xsum, H, W, C, CC, stream);
}

extern "C" int hdrtv_resblock_bf16(const void* x, const void* cond, const void* const* sft1,
                                   const void* w1, const void* b1, const void* q1,
                                   const void* const* sft2, const void* w2, const void* b2,
                                   const void* q2, const void* add, int coarse, void* y, void* t,
                                   void* h1, void* xsum, int H, int W, int C, int CC, void* stream) {
  return resblock<hdrtv::bf16>(x, cond, sft1, w1, b1, hdrtv::quant_params(q1), sft2, w2, b2,
                               hdrtv::quant_params(q2), add, coarse, y, t, h1, xsum, H, W, C, CC,
                               stream);
}
