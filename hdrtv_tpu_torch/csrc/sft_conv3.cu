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
//
// The native-int8 body (`quant`, megakernel.py:852-855; the wrapper counts it
// as sft_conv3_w8a8), when the call passes the conv's QuantParams: the SFT
// pass in its int8-output mode computes t in fp32 and writes the conv's
// codes (1 byte a value, half of bf16 t's round trip), then the int8 tile of
// conv3x3_s8.cuh adds the folded bias, skip and ReLU. Bound on this card:
// bytes (0.33 GB per L0 call in bf16; 38 GOP of non-zero int8 conv products
// and 25 GFLOP of bf16 SFT products are a few µs at the tensor-core rates).
//
// The s2d form (the wrapper's s2d=True: the SFT weights w_s2d_1x1, their
// biases b_s2d, w w_s2d_s1, as the frame programs' are), in bf16 with the
// float conv: the same two launches, both on Hopper tiles, as the tail's
// first two (tail.cu):
//   1. the SFT pass on chain_sm90.cuh's row tile (sft_sm90): the (4·npix, 16)
//      rows of cond and (4·npix, 32) rows of x against the weights' diagonal
//      blocks, resident in shared memory, on wgmma; t written once;
//   2. the conv on conv3x3_sm90.cuh's tile over the stride-1 slot table the
//      wrapper passes (ops/conv_kernels.py sm90_table): a quarter of the
//      dense product; TMA's zero fill reads t as zero outside the image; the
//      epilogue adds the bias and the skip, applies the ReLU, rounds once and
//      stores only inside the image.
// Rounding points as in the float body. Bound on this card: bytes (0.33 GB
// per L0 call, 0.099 ms). Times: PERF.md §5-§6.
//
// The s2d form in fp32 with the float conv (the float body): the same two
// launches on the tiles' fp32 instances:
//   1. the SFT pass on sft_tf32x3.cuh's 3×TF32 row tile: every value fp32,
//      the three 16-deep products per tile on wgmma m64n32k8 (small·big +
//      big·small + big·big), the hidden handed from the first product's
//      accumulators to the second products' A in registers; t written once;
//   2. the conv on conv3x3_tf32x3.cuh's 3×TF32 tile over the same slot
//      table (each 32-channel chunk summed in the tensor cores from zero,
//      the chunk sums added in fp32), bias, skip and ReLU in its epilogue,
//      TMA's zero fill reading t as zero outside the image.
// Bound on this card: operations at a third of the TF32 rate for the conv,
// bytes for the SFT pass (0.66 GB per L0 call, 0.20 ms). Times: PERF.md §6.
//
// The int8 body's s2d form in bf16 (s2d=True with the conv's QuantParams):
// the same two launches on the Hopper tiles in their int8 forms, as the
// tail's (tail.cu):
//   1. the SFT pass on the row tile in its int8-output mode: t in fp32,
//      quantized (IEEE division), written as 1-byte codes;
//   2. the conv on conv3x3_s8_sm90.cuh's wgmma s8 tile over the slot table:
//      the exact int32 sum over the 9 populated slots of each output
//      sub-position, out-of-image taps reading the layer's pad code, then
//      yscale, the folded bias, the skip (each rounded apart), the ReLU and
//      one rounding, stored inside the image.
// Bound on this card: bytes, as the float form's.
//
// The int8 body's s2d form in fp32 (s2d=True with the conv's QuantParams):
// the same two launches, both fp32 throughout:
//   1. the SFT pass in the int8-output mode of sft_tf32x3.cuh
//      (sft_q8_f32_kernel: the products fp32 FMA chains in the plain
//      version's order, t quantized in registers, 1-byte codes);
//   2. the conv on the wgmma s8 tile over the slot table through its
//      fp32-output epilogue: yscale, the folded bias and the fp32 skip
//      rounded apart, the ReLU, y stored in fp32 inside the image.
// Bound on this card: bytes (0.46 GB per L0 call at 1080p, 0.14 ms).
#include "chain_sm90.cuh"
#include "conv3x3_s8.cuh"
#include "conv3x3_s8_sm90.cuh"
#include "pointwise.cuh"
#include "sft_tf32x3.cuh"

namespace {

template <typename T>
int sft_conv3(const void* x, const void* cond, const void* const* sft, const void* w,
              const void* b, const hdrtv::QuantParams* q, const void* skip, void* y, void* t,
              int H, int W, int C, int CC, int Co, int relu, int s2d, const int* table, int per_list,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int act = relu ? hdrtv::ACT_RELU : hdrtv::ACT_NONE;
  if (s2d) {
    if constexpr (std::is_same<T, hdrtv::bf16>::value) {
      if (!table) return static_cast<int>(cudaErrorInvalidValue);
      cudaError_t err = hdrtv::sft_sm90<hdrtv::bf16>(x, nullptr, 0, nullptr, cond, t, sft, H, W, C, CC, s, q);
      if (err == cudaSuccess && q)
        err = hdrtv::conv3x3_s8_sm90(t, *q, skip, y, H, W, C, Co, act, table, per_list, s);
      else if (err == cudaSuccess)
        err = hdrtv::conv3x3_sm90<1>(t, w, static_cast<const float*>(b), skip, y, H, W, C, 0, C, Co, act, 1,
                                     table, per_list, s);
      return static_cast<int>(err);
    } else {
      if (!table) return static_cast<int>(cudaErrorInvalidValue);
      cudaError_t err = hdrtv::sft_tf32x3(x, nullptr, 0, nullptr, cond, t, sft, H, W, C, CC, s, q);
      if (err == cudaSuccess && q)
        err = hdrtv::conv3x3_s8_sm90(t, *q, skip, y, H, W, C, Co, act, table, per_list, s, nullptr, true);
      else if (err == cudaSuccess)
        err = hdrtv::conv3x3_tf32x3<1>(t, w, static_cast<const float*>(b), skip, y, H, W, C, 0, C, Co, act, 1, table,
                                       per_list, s);
      return static_cast<int>(err);
    }
  }
  hdrtv::SftArgs a;
  a.x = x;
  a.cond = cond;
  a.add = nullptr;
  a.xsum = nullptr;
  hdrtv::set_sft_out(a, t, q);
  hdrtv::set_sft_params(a, sft);
  a.npix = H * W;
  a.W = W;
  a.C = C;
  a.CC = CC;
  a.coarse = 0;
  cudaError_t err = hdrtv::launch_sft<T, T>(a, s);
  if (err == cudaSuccess)
    err = hdrtv::conv3x3_or_s8<T, T>(t, w, b, q, skip, y, H, W, C, Co, act, s);
  return static_cast<int>(err);
}

}  // namespace

// sft: eight pointers, (w, b) of scale0, scale1, shift0, shift1. q: null for
// the float form, else the conv's int8 parameters (w and b unused). t:
// scratch of Hb·Wb·C elements, or of Hb·Wb·C bytes (codes) with q. s2d: 1
// for the s2d form (float or int8, bf16 or fp32), whose conv walks
// `table` (per_list entries per output sub-position; null otherwise), else 0.
extern "C" int hdrtv_sft_conv3_f32(const void* x, const void* cond, const void* const* sft,
                                   const void* w, const void* b, const void* q, const void* skip,
                                   void* y, void* t, int H, int W, int C, int CC, int Co, int relu,
                                   int s2d, const int* table, int per_list, void* stream) {
  return sft_conv3<float>(x, cond, sft, w, b, hdrtv::quant_params(q), skip, y, t, H, W, C, CC, Co,
                          relu, s2d, table, per_list, stream);
}

extern "C" int hdrtv_sft_conv3_bf16(const void* x, const void* cond, const void* const* sft,
                                    const void* w, const void* b, const void* q, const void* skip,
                                    void* y, void* t, int H, int W, int C, int CC, int Co, int relu,
                                    int s2d, const int* table, int per_list, void* stream) {
  return sft_conv3<hdrtv::bf16>(x, cond, sft, w, b, hdrtv::quant_params(q), skip, y, t, H, W, C, CC,
                                Co, relu, s2d, table, per_list, stream);
}
