// mix_chain — replaces the Pallas kernel fused_mix_chain
// (hdrtv_tpu/ops/megakernel.py:1259): a chain of 1×1 convs over an s2d block
// tensor, v ← act_k(v · w_k + b_k) for each step k, reading the channel
// window [ch0, ch0 + cin) of a wider input in place and writing only the
// last step's result. Rounding points as in _mix_chain_kernel: each step's
// input rounded to the weight's type, the sum, the fp32 bias and the
// activation fp32, the last result rounded once. On the bf16 frame programs
// it is the CondNet2 tail at L1: (270, 480, 768) window 256 → 256 (lrelu) →
// 64, once a frame.
//
// The s2d form (the wrapper's s2d=True: every weight w_s2d_1x1(w), every
// bias b_s2d(b), as models/s2d.py's CondNet tails pass them), in bf16:
// chain_sm90.cuh's Hopper row tile (mix_chain_sm90), which reads the window
// as (4·npix, 64) rows of natural pixels, each pixel's four rows 1536 bytes
// from the next one's, and multiplies them by each weight's one diagonal
// block on wgmma, the middle value rounded to bf16 into the next product's
// A fragments: the chain the program runs, natural widths 64 → 64 → 16;
// another step list is refused. Bound on this card: bytes (66 MB in, 17 MB
// out at 1080p, 0.025 ms at 3.35 TB/s; 5 GFLOP of block products). The
// dense form (s2d=False, any weights) and the fp32 instance keep the
// shared-memory chain of chain.cuh (21 GFLOP dense at 1080p, on the tensor
// cores in bf16 and the FMA units in fp32), one launch. Times: PERF.md §6.
#include "chain.cuh"
#include "chain_sm90.cuh"

namespace {

template <typename T>
int mix_chain(const void* x, void* y, const void* const* w, const void* const* b, const int* k, const int* n,
              const int* act, int steps, int npix, int cf, int ch0, int s2d, void* stream) {
  if (s2d) {
    if constexpr (std::is_same<T, hdrtv::bf16>::value)
      return static_cast<int>(hdrtv::mix_chain_sm90(x, y, w, b, k, n, act, steps, npix, cf, ch0,
                                                    static_cast<cudaStream_t>(stream)));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return hdrtv::chain<T>(x, y, nullptr, -1, w, b, k, n, act, steps, npix, cf, ch0, stream);
}

}  // namespace

// Steps one launch takes.
extern "C" int hdrtv_mix_chain_max_steps() { return hdrtv::kMaxSteps; }

// s2d: 1 for the s2d form (bf16; the row tile of chain_sm90.cuh), else 0.
extern "C" int hdrtv_mix_chain_f32(const void* x, void* y, const void* const* w,
                                   const void* const* b, const int* k, const int* n,
                                   const int* act, int steps, int npix, int cf, int ch0, int s2d,
                                   void* stream) {
  return mix_chain<float>(x, y, w, b, k, n, act, steps, npix, cf, ch0, s2d, stream);
}

extern "C" int hdrtv_mix_chain_bf16(const void* x, void* y, const void* const* w,
                                    const void* const* b, const int* k, const int* n,
                                    const int* act, int steps, int npix, int cf, int ch0, int s2d,
                                    void* stream) {
  return mix_chain<hdrtv::bf16>(x, y, w, b, k, n, act, steps, npix, cf, ch0, s2d, stream);
}
