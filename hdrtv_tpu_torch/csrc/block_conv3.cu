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
//
// The native-int8 (W8A8) body of the same Pallas kernel (`quant`,
// conv_kernels.py:180-227; the wrapper counts it as block_conv3_w8a8), when
// the call passes the layer's QuantParams: x quantized per tensor, the conv as
// int8 × int8 → int32 dots, rescaled per output channel, then bias, skip and
// ReLU. Bound on this card: bytes (a 1080p call needs at most 38 GOP of
// non-zero int8 products, 0.02 ms at the 1979 TOPS int8 rate, less than its
// activations take at 3.35 TB/s). Design, first version: two launches from one host
// call, a quantize pass that writes x's codes once (1 byte a value) into
// scratch the wrapper allocates, then the int8 tile of conv3x3_s8.cuh, which
// fills out-of-image taps with the layer's pad code. Quantizing on load
// inside the tile, which saves the codes' round trip, is later work.
#include "conv3x3_s8.cuh"

namespace {

template <typename T>
int block_conv3(const void* x, const void* w, const void* b, const hdrtv::QuantParams* q,
                const void* skip, void* y, void* codes, int H, int W, int C, int Co, int relu,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (q) err = hdrtv::quantize<T>(x, codes, static_cast<long long>(H) * W * C, *q, s);
  if (err == cudaSuccess)
    err = hdrtv::conv3x3_or_s8<T, T>(q ? codes : x, w, b, q, skip, y, H, W, C, Co,
                                     relu ? hdrtv::ACT_RELU : hdrtv::ACT_NONE, s);
  return static_cast<int>(err);
}

}  // namespace

// q: null for the float form, else the layer's int8 parameters (w and b
// unused; codes: H·W·C bytes of scratch, unused without q).
extern "C" int hdrtv_block_conv3_f32(const void* x, const void* w, const void* b, const void* q,
                                     const void* skip, void* y, void* codes, int H, int W, int C,
                                     int Co, int relu, void* stream) {
  return block_conv3<float>(x, w, b, hdrtv::quant_params(q), skip, y, codes, H, W, C, Co, relu,
                            stream);
}

extern "C" int hdrtv_block_conv3_bf16(const void* x, const void* w, const void* b, const void* q,
                                      const void* skip, void* y, void* codes, int H, int W, int C,
                                      int Co, int relu, void* stream) {
  return block_conv3<hdrtv::bf16>(x, w, b, hdrtv::quant_params(q), skip, y, codes, H, W, C, Co,
                                  relu, stream);
}
