// mix_chain — replaces the Pallas kernel fused_mix_chain
// (hdrtv_tpu/ops/megakernel.py:1259): a chain of 1×1 convs over an s2d block
// tensor, v ← act_k(v · w_k + b_k) for each step k, reading the channel
// window [ch0, ch0 + cin) of a wider input in place and writing only the
// last step's result. On the bf16 frame programs it is the CondNet2 tail at
// L1: (270, 480, 768) window 256 → 256 (lrelu) → 64.
//
// Bound on this card: bytes in bf16 (66 MB in, 17 MB out, 21 GFLOP dense per
// call at 1080p, on the tensor cores), operations in fp32 (the FMA units).
// Design: the shared-memory chain of chain.cuh, one launch.
#include "chain.cuh"

// Steps one launch takes.
extern "C" int hdrtv_mix_chain_max_steps() { return hdrtv::kMaxSteps; }

extern "C" int hdrtv_mix_chain_f32(const void* x, void* y, const void* const* w,
                                   const void* const* b, const int* k, const int* n,
                                   const int* act, int steps, int npix, int cf, int ch0,
                                   void* stream) {
  return hdrtv::chain<float>(x, y, nullptr, -1, w, b, k, n, act, steps, npix, cf, ch0, stream);
}

extern "C" int hdrtv_mix_chain_bf16(const void* x, void* y, const void* const* w,
                                    const void* const* b, const int* k, const int* n,
                                    const int* act, int steps, int npix, int cf, int ch0,
                                    void* stream) {
  return hdrtv::chain<hdrtv::bf16>(x, y, nullptr, -1, w, b, k, n, act, steps, npix, cf, ch0,
                                   stream);
}
