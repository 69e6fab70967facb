// block_conv3 — replaces the Pallas kernel fused_block_conv3
// (hdrtv_tpu/ops/conv_kernels.py:271): a 3×3 'same' conv over an s2d block
// tensor (Hb, Wb, C) → (Hb, Wb, Co) with the epilogue relu(conv + b + skip).
//
// Bound on this card: operations. At 1080p a call is 38–153 GFLOP (dense)
// over at most 0.5 GB of activations; in fp32 without tensor cores the
// H100's FMA rate (67 TFLOP/s) is the limit, ~14× above the memory roof.
// Design: the implicit-GEMM tile of conv3x3.cuh (128 pixels × 128 channels
// per block, fp32 accumulation in registers, 16 KB shared memory), which
// keeps every input element read ~9 times from shared memory rather than
// from HBM. The TPU kernel's a_sub zero-tap skip and its int8 and pool_out
// forms are not ported; the dense product gives the same result on the
// s2d-transformed weights. The bf16 instance (bf16 x, w, skip, y; fp32 bias)
// runs the same tile on the tensor cores (conv3x3_mma_kernel: mma.sync bf16,
// fp32 accumulation), where the card's bf16 rate puts the call's bound at its
// bytes; what holds it back there is the tile's one-stage operand staging.
#include "conv3x3.cuh"

namespace {

template <typename T>
int block_conv3(const void* x, const void* w, const void* b, const void* skip, void* y, int H,
                int W, int C, int Co, int relu, void* stream) {
  return static_cast<int>(hdrtv::conv_same<T, T, T>(
      x, w, static_cast<const float*>(b), skip, nullptr, y, H, W, C, Co,
      relu ? hdrtv::ACT_RELU : hdrtv::ACT_NONE, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" int hdrtv_block_conv3_f32(const void* x, const void* w, const void* b,
                                     const void* skip, void* y, int H, int W, int C, int Co,
                                     int relu, void* stream) {
  return block_conv3<float>(x, w, b, skip, y, H, W, C, Co, relu, stream);
}

extern "C" int hdrtv_block_conv3_bf16(const void* x, const void* w, const void* b,
                                      const void* skip, void* y, int H, int W, int C, int Co,
                                      int relu, void* stream) {
  return block_conv3<hdrtv::bf16>(x, w, b, skip, y, H, W, C, Co, relu, stream);
}
