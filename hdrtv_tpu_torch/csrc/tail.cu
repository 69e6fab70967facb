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
//   3. conv_last + bias + skip + pack in one pass: conv_last.cuh's
//      conv_last_kernel (fp32, and the dense form in bf16).
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
// The s2d form (the wrapper's s2d=True: the SFT weights w_s2d_1x1, their
// biases b_s2d, w_hr and w_last w_s2d_s1, as the frame programs' are), in
// bf16 with the float HR_conv2: the same three launches, all on Hopper
// tiles.
//   1. the SFT pass on chain_sm90.cuh's row tile (sft_sm90): the (4·npix, 16)
//      rows of cond1 and (4·npix, 32) rows of s (up_coarse un-folded on read)
//      against the weights' diagonal blocks, resident in shared memory, on
//      wgmma; t written once;
//   2. HR_conv2 on conv3x3_sm90.cuh's tile, walking the stride-1 s2d slot
//      table the wrapper passes (ops/conv_kernels.py sm90_table): a quarter
//      of the dense product; TMA's zero fill reads t as zero outside the
//      image, the epilogue adds the bias, applies the ReLU and stores only
//      inside it;
//   3. conv_last on its own tile (conv_last.cuh conv_last_sm90_kernel):
//      persistent blocks walking down bands of 64 columns, h's rows fed once
//      by TMA through a ring, only the 16 populated (tap, sub-position)
//      slots of w_last multiplied (the walk the wrapper passes), their
//      weights in registers, the skip row prefetched and the output row
//      staged and stored in 16-byte pieces.
// Rounding points as in the float body. Times: PERF.md §5-§6.
//
// The native-int8 body (`quant`, megakernel.py:468-469, `qargs_hr`; the
// wrapper counts it as tail_w8a8), when the call passes HR_conv2's
// QuantParams: step 1 runs the SFT pass in its int8-output mode (t in fp32,
// quantized, never rounded to the element type), step 2 HR_conv2 on the int8
// tile of conv3x3_s8.cuh (folded bias, ReLU, h stored in the element type,
// as in the float body), step 3 conv_last_kernel as above. Bound on this
// card: bytes. Its s2d form in bf16 (s2d=True, as the megakernel program
// calls it) runs the Hopper tiles instead:
//   1. the SFT pass on chain_sm90.cuh's row tile in its int8-output mode
//      (up_coarse un-folded on read; t quantized from fp32, 1-byte codes);
//   2. HR_conv2 on conv3x3_s8_sm90.cuh's wgmma s8 tile over the slot table:
//      9 of the 36 (tap, sub-position) slots per output sub-position, the
//      exact int32 sum, out-of-image taps reading the layer's pad code,
//      folded bias and ReLU rounded apart, h stored in bf16 inside the image;
//   3. conv_last on its Hopper tile, as in the float body's s2d form.
// Bound on this card: bytes (0.1065 ms a 1080p call). Times: PERF.md §5-§6.
//
// The float body's s2d form in fp32 (s2d=True without q_hr): the same three
// launches on the tiles' fp32 instances, as fp32 sft_conv3's (sft_conv3.cu):
//   1. the SFT pass on sft_tf32x3.cuh's 3×TF32 row tile, up_coarse
//      un-folded on read (s + d2s(up) in fp32, no sum written); t once;
//   2. HR_conv2 on conv3x3_tf32x3.cuh's 3×TF32 tile over the same slot
//      table, bias and ReLU in its epilogue, h stored inside the image, TMA's
//      zero fill reading t as zero outside it;
//   3. conv_last on its fp32 tile (conv_last.cuh conv_last_tf32x3_kernel):
//      the bf16 tile's plan, h's fp32 rows by TMA in four 32-channel boxes,
//      the 16 slots' products as 3×TF32 on mma.sync, eight warps splitting
//      them, A by ldmatrix split in registers, the split weights' fragments
//      in shared memory.
// Every value fp32: the Pallas body in fp32 narrows nothing. Bound on this
// card: bytes for the SFT pass and conv_last, operations at a third of the
// TF32 rate for HR_conv2. Times: PERF.md §6.
//
// The int8 body's s2d form in fp32 (s2d=True with q_hr, tail_w8a8): three
// launches, t never leaving the SFT pass but as codes, h fp32:
//   1. the SFT pass in the int8-output mode of sft_tf32x3.cuh
//      (sft_q8_f32_kernel: up_coarse un-folded on read, s + d2s(up) in
//      fp32; the products fp32 FMA chains in the plain version's order, t
//      quantized in registers, 1-byte codes stored in 16-byte pieces);
//   2. HR_conv2 on conv3x3_s8_sm90.cuh's wgmma s8 tile over the slot table
//      through its fp32-output epilogue: the exact int32 sum over the 9
//      populated slots, out-of-image taps reading the pad code, yscale and
//      the folded bias rounded apart, the ReLU, h stored in fp32 inside the
//      image;
//   3. conv_last on its fp32 tile, as in the float body's fp32 form.
// Bound on this card: bytes (1080p: 0.21 ms). Times: PERF.md §6.
#include "chain_sm90.cuh"
#include "conv3x3_s8.cuh"
#include "conv3x3_s8_sm90.cuh"
#include "conv_last.cuh"
#include "pointwise.cuh"
#include "sft_tf32x3.cuh"

namespace hdrtv {
namespace {

template <typename T>
int tail(const void* s, const void* up, const void* cond1, const void* skip,
         const void* const* sft, const void* w_hr, const void* b_hr, const QuantParams* q_hr,
         const void* w_last, const void* b_last, const int* last_walk, void* out, void* t, void* h, int H,
         int W, int C, int CC, int Cl, int pack, int s2d, const int* table, int per_list, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (s2d) {
    if constexpr (std::is_same<T, bf16>::value) {
      if (!table) return static_cast<int>(cudaErrorInvalidValue);
      err = sft_sm90<bf16>(s, up, 1, nullptr, cond1, t, sft, H, W, C, CC, st, q_hr);
      if (err == cudaSuccess && q_hr)
        err = conv3x3_s8_sm90(t, *q_hr, nullptr, h, H, W, C, C, ACT_RELU, table, per_list, st);
      else if (err == cudaSuccess)
        err = conv3x3_sm90<1>(t, w_hr, static_cast<const float*>(b_hr), nullptr, h, H, W, C, 0, C, C, ACT_RELU, 1,
                              table, per_list, st);
    } else {
      if (!table) return static_cast<int>(cudaErrorInvalidValue);
      err = sft_tf32x3(s, up, 1, nullptr, cond1, t, sft, H, W, C, CC, st, q_hr);
      if (err == cudaSuccess && q_hr)
        err = conv3x3_s8_sm90(t, *q_hr, nullptr, h, H, W, C, C, ACT_RELU, table, per_list, st, nullptr, true);
      else if (err == cudaSuccess)
        err = conv3x3_tf32x3<1>(t, w_hr, static_cast<const float*>(b_hr), nullptr, h, H, W, C, 0, C, C, ACT_RELU, 1,
                                table, per_list, st);
      if (err == cudaSuccess)
        err = conv_last_tf32x3(h, w_last, static_cast<const float*>(b_last), skip, out, H, W, C, Cl, pack, last_walk,
                               st);
      return static_cast<int>(err);
    }
  } else {
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
    err = launch_sft<T, T>(f, st);
    if (err == cudaSuccess)
      err = conv3x3_or_s8<T, T>(t, w_hr, b_hr, q_hr, nullptr, h, H, W, C, C, ACT_RELU, st);
  }
  if (s2d) {
    if (err == cudaSuccess)
      err = conv_last_sm90(h, w_last, static_cast<const float*>(b_last), skip, out, H, W, C, Cl, pack, last_walk,
                           st);
    return static_cast<int>(err);
  }
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
  if (err == cudaSuccess) err = launch_conv_last<T>(l, st);
  return static_cast<int>(err);
}

}  // namespace
}  // namespace hdrtv

// up: nullptr, or up_coarse (H/2, W/2, 4C). sft: eight pointers, (w, b) of
// scale0, scale1, shift0, shift1. q_hr: null for the float form, else
// HR_conv2's int8 parameters (w_hr and b_hr unused). Scratch: t H·W·C elements
// (bytes, codes, with q_hr) and h H·W·C elements. s2d: 1 for the s2d form
// (float or int8, bf16 or fp32), whose HR_conv2 walks `table`
// (per_list entries per output sub-position; null otherwise) and whose
// conv_last walks `last_walk` (ops/megakernel.py conv_last_walk; null
// otherwise), else 0.
extern "C" int hdrtv_tail_f32(const void* s, const void* up, const void* cond1, const void* skip,
                              const void* const* sft, const void* w_hr, const void* b_hr,
                              const void* q_hr, const void* w_last, const void* b_last,
                              const int* last_walk, void* out, void* t, void* h, int H, int W, int C,
                              int CC, int Cl, int pack, int s2d, const int* table, int per_list,
                              void* stream) {
  return hdrtv::tail<float>(s, up, cond1, skip, sft, w_hr, b_hr, hdrtv::quant_params(q_hr), w_last,
                            b_last, last_walk, out, t, h, H, W, C, CC, Cl, pack, s2d, table, per_list, stream);
}

extern "C" int hdrtv_tail_bf16(const void* s, const void* up, const void* cond1, const void* skip,
                               const void* const* sft, const void* w_hr, const void* b_hr,
                               const void* q_hr, const void* w_last, const void* b_last,
                               const int* last_walk, void* out, void* t, void* h, int H, int W, int C,
                               int CC, int Cl, int pack, int s2d, const int* table, int per_list,
                               void* stream) {
  return hdrtv::tail<hdrtv::bf16>(s, up, cond1, skip, sft, w_hr, b_hr, hdrtv::quant_params(q_hr),
                                  w_last, b_last, last_walk, out, t, h, H, W, C, CC, Cl, pack, s2d, table,
                                  per_list, stream);
}
