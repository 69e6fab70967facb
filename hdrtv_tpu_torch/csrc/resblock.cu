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
// it as resblock_w8a8), when the call passes both convs' QuantParams, dense
// (s2d = 0, and fp32): the same four launches with both convs on the
// mma.sync int8 tile of conv3x3_s8.cuh and both SFT passes of pointwise.cuh
// in their int8-output mode, so t1 and t2 travel as codes (1 byte a value)
// and are never rounded to the element type:
//   1. SFT1 (summed input written once as before) → codes of t1;
//   2. int8 conv1 + folded bias + ReLU → h1 in fp32;
//   3. SFT2 on the fp32 h1 → codes of t2;
//   4. int8 conv2 + folded bias + the summed input → out.
// Out-of-image taps read each conv's pad code. Bound on this card: bytes.
//
// The s2d form (the wrapper's s2d=True: every SFT weight w_s2d_1x1, its bias
// b_s2d, w1 and w2 w_s2d_s1, as the frame programs' are), in bf16 with float
// convs: the same four launches, all on Hopper tiles:
//   1. SFT1 on chain_sm90.cuh's row tile (sft_sm90): x, with x_add's rows or
//      up_coarse un-folded on read, the sum rounded once, written to xsum
//      from the tile's stage and fed to the SFT → t;
//   2. conv1 on conv3x3_sm90.cuh's tile over the stride-1 slot table
//      (ops/conv_kernels.py sm90_table; a quarter of the dense product),
//      bias and ReLU in its fp32-output epilogue → h1, unrounded, stored
//      inside the image;
//   3. SFT2 on the row tile with the fp32 h1 as x (it enters only the
//      epilogue x·(scale+1)+shift; three stages a warpgroup, so two blocks
//      still fit an SM) → t;
//   4. conv2 on the Hopper tile, bias + the residual (x or xsum, read in
//      16-byte pieces by its skip epilogue) → out.
// TMA's zero fill reads t as zero outside the image in both convs. Rounding
// points as in the float body. Bound on this card: bytes (0.10 GB per L1
// call, 0.030 ms). Times: PERF.md §5-§6.
//
// The s2d form in fp32 with float convs (the float body; fp32 calls with
// QuantParams keep the dense kernels above): the same four launches on the
// tiles' fp32 instances, every value fp32:
//   1. SFT1 on sft_tf32x3.cuh's 3×TF32 row tile: x, with x_add's rows or
//      up_coarse un-folded on read, the sum in fp32 written to xsum from
//      registers and fed to the SFT → t;
//   2. conv1 on conv3x3_tf32x3.cuh's 3×TF32 tile over the slot table, bias
//      and ReLU in its epilogue → h1;
//   3. SFT2 on the 3×TF32 row tile with h1 as x → t;
//   4. conv2 on the 3×TF32 tile, bias + the residual (x or xsum) as its
//      skip → out.
// TMA's zero fill reads t as zero outside the image in both convs; each
// 32-channel chunk of a conv, and each 16-deep SFT product, is summed in
// the tensor cores from zero, the chunk sums added in fp32. Bound on this
// card: operations at a third of the TF32 rate (the convs). Times: PERF.md
// §6.
//
// The int8 body's s2d form in bf16 (s2d=True with both QuantParams): the
// same four launches on the Hopper tiles in their int8 forms, as
// sft_conv3_w8a8's and tail_w8a8's:
//   1. SFT1 on the row tile in its int8-output mode: x, with x_add's rows or
//      up_coarse un-folded on read, the sum rounded once to bf16 and written
//      to xsum, t1 formed in fp32 from it and written as conv1's codes;
//   2. conv1 on conv3x3_s8_sm90.cuh's wgmma s8 tile over the slot table,
//      its fp32-output epilogue (acc·yscale, + folded bias, ReLU) storing h1
//      unrounded inside the image;
//   3. SFT2 on the row tile in its int8-output mode with the fp32 h1 as x
//      → conv2's codes;
//   4. conv2 on the s8 tile, + the residual (x or xsum) in its skip
//      epilogue, one rounding → out.
// Out-of-image taps of both convs read each layer's pad code (written over
// the box rows TMA zero-fills). Scratch as the dense form's. Bound on this
// card: bytes (0.10 GB per L1 call, 0.060 ms with the codes and h1).
#include "chain_sm90.cuh"
#include "conv3x3_s8.cuh"
#include "conv3x3_s8_sm90.cuh"
#include "pointwise.cuh"
#include "sft_tf32x3.cuh"

namespace {

template <typename T>
int resblock(const void* x, const void* cond, const void* const* sft1, const void* w1,
             const void* b1, const hdrtv::QuantParams* q1, const void* const* sft2, const void* w2,
             const void* b2, const hdrtv::QuantParams* q2, const void* add, int coarse, void* y,
             void* t, void* h1, void* xsum, int H, int W, int C, int CC, int s2d, const int* table,
             int per_list, void* stream) {
  using hdrtv::ACT_NONE;
  using hdrtv::ACT_RELU;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (s2d) {
    if constexpr (std::is_same<T, hdrtv::bf16>::value) {
      if (!q1 != !q2 || !table || (add && !xsum)) return static_cast<int>(cudaErrorInvalidValue);
      if (q1) {
        cudaError_t err = hdrtv::sft_sm90<hdrtv::bf16>(x, add, coarse, add ? xsum : nullptr, cond, t, sft1, H, W, C,
                                                       CC, s, q1);
        if (err == cudaSuccess)
          err = hdrtv::conv3x3_s8_sm90(t, *q1, nullptr, h1, H, W, C, C, ACT_RELU, table, per_list, s, nullptr, true);
        if (err == cudaSuccess)
          err = hdrtv::sft_sm90<float>(h1, nullptr, 0, nullptr, cond, t, sft2, H, W, C, CC, s, q2);
        if (err == cudaSuccess)
          err = hdrtv::conv3x3_s8_sm90(t, *q2, add ? xsum : x, y, H, W, C, C, ACT_NONE, table, per_list, s);
        return static_cast<int>(err);
      }
      const float* const bias1 = static_cast<const float*>(b1);
      const float* const bias2 = static_cast<const float*>(b2);
      cudaError_t err = hdrtv::sft_sm90<hdrtv::bf16>(x, add, coarse, add ? xsum : nullptr, cond, t, sft1, H, W, C,
                                                     CC, s);
      if (err == cudaSuccess)
        err = hdrtv::conv3x3_sm90<1>(t, w1, bias1, nullptr, h1, H, W, C, 0, C, C, ACT_RELU, 1, table, per_list, s,
                                     nullptr, true);
      if (err == cudaSuccess) err = hdrtv::sft_sm90<float>(h1, nullptr, 0, nullptr, cond, t, sft2, H, W, C, CC, s);
      if (err == cudaSuccess)
        err = hdrtv::conv3x3_sm90<1>(t, w2, bias2, add ? xsum : x, y, H, W, C, 0, C, C, ACT_NONE, 1, table,
                                     per_list, s);
      return static_cast<int>(err);
    } else {
      // fp32: the float body only (the int8 body keeps its dense kernels)
      if (q1 || q2 || !table || (add && !xsum)) return static_cast<int>(cudaErrorInvalidValue);
      const float* const bias1 = static_cast<const float*>(b1);
      const float* const bias2 = static_cast<const float*>(b2);
      cudaError_t err = hdrtv::sft_tf32x3(x, add, coarse, add ? xsum : nullptr, cond, t, sft1, H, W, C, CC, s);
      if (err == cudaSuccess)
        err = hdrtv::conv3x3_tf32x3<1>(t, w1, bias1, nullptr, h1, H, W, C, 0, C, C, ACT_RELU, 1, table, per_list, s);
      if (err == cudaSuccess) err = hdrtv::sft_tf32x3(h1, nullptr, 0, nullptr, cond, t, sft2, H, W, C, CC, s);
      if (err == cudaSuccess)
        err = hdrtv::conv3x3_tf32x3<1>(t, w2, bias2, add ? xsum : x, y, H, W, C, 0, C, C, ACT_NONE, 1, table,
                                       per_list, s);
      return static_cast<int>(err);
    }
  }
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
// Hb·Wb·C floats, xsum Hb·Wb·C elements when add is set. s2d: 1 for the s2d
// form (bf16 float or int8; fp32 float), whose convs walk `table` (per_list
// entries per output sub-position; null otherwise), else 0.
extern "C" int hdrtv_resblock_f32(const void* x, const void* cond, const void* const* sft1,
                                  const void* w1, const void* b1, const void* q1,
                                  const void* const* sft2, const void* w2, const void* b2,
                                  const void* q2, const void* add, int coarse, void* y, void* t,
                                  void* h1, void* xsum, int H, int W, int C, int CC, int s2d,
                                  const int* table, int per_list, void* stream) {
  return resblock<float>(x, cond, sft1, w1, b1, hdrtv::quant_params(q1), sft2, w2, b2,
                         hdrtv::quant_params(q2), add, coarse, y, t, h1, xsum, H, W, C, CC, s2d, table,
                         per_list, stream);
}

extern "C" int hdrtv_resblock_bf16(const void* x, const void* cond, const void* const* sft1,
                                   const void* w1, const void* b1, const void* q1,
                                   const void* const* sft2, const void* w2, const void* b2,
                                   const void* q2, const void* add, int coarse, void* y, void* t,
                                   void* h1, void* xsum, int H, int W, int C, int CC, int s2d,
                                   const int* table, int per_list, void* stream) {
  return resblock<hdrtv::bf16>(x, cond, sft1, w1, b1, hdrtv::quant_params(q1), sft2, w2, b2,
                               hdrtv::quant_params(q2), add, coarse, y, t, h1, xsum, H, W, C, CC, s2d,
                               table, per_list, stream);
}
