// cond_chain — replaces the Pallas kernel fused_cond_chain
// (hdrtv_tpu/ops/megakernel.py:352): the five L0 1×1 convs of the condition
// network in one pass, c0 (Hb, Wb, C) → c (after lrelu(cond_first.2),
// lrelu(cond_first.4)) and cond1 (after lrelu(CondNet1.0), lrelu(CondNet1.2),
// CondNet1.4). At 1080p: (540, 960, 256) → 256 ×4 → 64.
//
// Bound on this card: bytes in bf16 (265 MB in, 332 MB out per call at
// 1080p; 289 GFLOP dense, of which the block-diagonal s2d weights need a
// quarter), operations in fp32. Design: the shared-memory chain of chain.cuh,
// one launch: c0 is read once, the four intermediate activations never leave
// the chip, and c is written from the same registers that feed the third
// step. The product is dense: right for any weight. Rounding points as in
// _cond_chain_kernel: the running value is rounded to the element type at
// each product (the stored c is that rounded value), sums, biases and the
// leaky ReLU (slope 0.1) are fp32.
//
// The int8 (W8A8) steps of the same Pallas kernel (`qargs`, `qflags`
// :294-381; the wrapper counts a launch with any as cond_chain_w8a8): a
// flagged step quantizes the fp32 running value per tensor (symmetric or
// with a zero point), multiplies int8 × int8 → int32 on the tensor cores
// (tile_gemm_s8, mma.sync.m16n8k32), then · yscale, + the folded bias and the
// leaky ReLU (not on the last step), as chain.cuh describes: the codes are
// made in the epilogue of the step before and never leave shared memory.
// No frame program of the JAX package passes qargs here; bound on this card
// as the float form (bytes: the chain's input and two outputs).
#include "chain.cuh"

namespace {

template <typename T>
int cond_chain(const void* c0, void* c, void* cond1, const void* const* w, const void* const* b,
               const int* k, const int* n, const void* const* q, int npix, void* stream) {
  using hdrtv::ACT_LRELU;
  const int act[5] = {ACT_LRELU, ACT_LRELU, ACT_LRELU, ACT_LRELU, hdrtv::ACT_NONE};
  return hdrtv::chain<T>(c0, cond1, c, 1, w, b, k, n, act, 5, npix, k[0], 0, stream,
                         reinterpret_cast<const hdrtv::QuantParams* const*>(q));
}

}  // namespace

// w, b: five pointers each; k, n: the five steps' input and output widths;
// q: null (every step float) or five pointers to QuantParams, null for a
// float step (the int8 step's w and b then unused).
extern "C" int hdrtv_cond_chain_f32(const void* c0, void* c, void* cond1, const void* const* w,
                                    const void* const* b, const int* k, const int* n,
                                    const void* const* q, int npix, void* stream) {
  return cond_chain<float>(c0, c, cond1, w, b, k, n, q, npix, stream);
}

extern "C" int hdrtv_cond_chain_bf16(const void* c0, void* c, void* cond1, const void* const* w,
                                     const void* const* b, const int* k, const int* n,
                                     const void* const* q, int npix, void* stream) {
  return cond_chain<hdrtv::bf16>(c0, c, cond1, w, b, k, n, q, npix, stream);
}
