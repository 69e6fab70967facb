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
// The s2d form (the wrapper's s2d=True: every weight w_s2d_1x1(w), every
// bias b_s2d(b), as the frame programs' are): chain_sm90.cuh's Hopper row
// tile, which multiplies the (4·npix, 64) rows of c0 by each weight's one
// diagonal block on wgmma, the blocks resident in shared memory, the steps
// chained in registers (PERF.md §6); with int8 steps its Q instance (below).
// In fp32 the tile's 3×TF32 instance (chain_tf32x3.cuh): the same rows, the
// blocks split once into TF32 halves, float and int8 steps.
//
// The int8 (W8A8) steps of the same Pallas kernel (`qargs`, `qflags`
// :294-381; the wrapper counts a launch with any as cond_chain_w8a8): a
// flagged step quantizes the fp32 running value per tensor (symmetric or
// with a zero point), multiplies int8 × int8 → int32 on the tensor cores,
// then · yscale, + the folded bias and the leaky ReLU (not on the last
// step). Dense (s2d=False): tile_gemm_s8, mma.sync.m16n8k32, as
// chain.cuh describes: the codes are made in the epilogue of the step before
// and never leave shared memory. s2d in bf16: the row tile's Q instance,
// whose step before quantizes its fp32 values in registers into the
// warpgroup's 64-row code tile, multiplied on wgmma m64nNk32 by the step's
// int8 diagonal block, read at the top left of the QArgs codes (the skipped
// products are zero codes: the same int32 sums); s2d in fp32 the same on the
// 3×TF32 instance, the codes made from the fp32 running value. No frame
// program of the JAX package passes qargs here; bound on this card as the
// float form (bytes: the chain's input and two outputs, 0.178 ms at 1080p in
// bf16, 0.357 in fp32).
#include "chain.cuh"
#include "chain_sm90.cuh"
#include "chain_tf32x3.cuh"

namespace hdrtv {
namespace {

// cond_chain's bf16 form over s2d weights (arguments: cond_chain_sm90_args)
// on the row tile of chain_sm90.cuh; with an int8 step its Q instance.
inline cudaError_t cond_chain_sm90(const void* c0, void* c, void* cond1, const void* const* w, const void* const* b,
                                   const int* k, const int* n, int npix, cudaStream_t stream,
                                   const QuantParams* const* q) {
  ChainSm90Args a;
  bool quant = false;
  const cudaError_t err = cond_chain_sm90_args(a, c0, c, cond1, w, b, k, n, npix, q, &quant);
  if (err != cudaSuccess) return err;
  static DeviceCache cache, qcache;
  if (quant)
    return launch_chain_sm90(cond_chain_sm90_kernel<64, 16, true>, ChainSm90Cfg<64, 16, 4, true>::SMEM, qcache, a,
                             stream);
  return launch_chain_sm90(cond_chain_sm90_kernel<64, 16, false>, ChainSm90Cfg<64, 16, 4>::SMEM, cache, a, stream);
}

}  // namespace
}  // namespace hdrtv

namespace {

template <typename T>
int cond_chain(const void* c0, void* c, void* cond1, const void* const* w, const void* const* b,
               const int* k, const int* n, const void* const* q, int npix, int s2d, void* stream) {
  if (s2d) {
    const auto qp = reinterpret_cast<const hdrtv::QuantParams* const*>(q);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if constexpr (std::is_same<T, hdrtv::bf16>::value)
      return static_cast<int>(hdrtv::cond_chain_sm90(c0, c, cond1, w, b, k, n, npix, st, qp));
    else
      return static_cast<int>(hdrtv::cond_chain_tf32x3(c0, c, cond1, w, b, k, n, npix, st, qp));
  }
  using hdrtv::ACT_LRELU;
  const int act[5] = {ACT_LRELU, ACT_LRELU, ACT_LRELU, ACT_LRELU, hdrtv::ACT_NONE};
  return hdrtv::chain<T>(c0, cond1, c, 1, w, b, k, n, act, 5, npix, k[0], 0, stream,
                         reinterpret_cast<const hdrtv::QuantParams* const*>(q));
}

}  // namespace

// w, b: five pointers each; k, n: the five steps' input and output widths;
// q: null (every step float) or five pointers to QuantParams, null for a
// float step (the int8 step's w and b then unused). s2d: 1 for the s2d
// form (the row tile of chain_sm90.cuh; fp32: its 3×TF32 instance), else 0.
extern "C" int hdrtv_cond_chain_f32(const void* c0, void* c, void* cond1, const void* const* w,
                                    const void* const* b, const int* k, const int* n,
                                    const void* const* q, int npix, int s2d, void* stream) {
  return cond_chain<float>(c0, c, cond1, w, b, k, n, q, npix, s2d, stream);
}

extern "C" int hdrtv_cond_chain_bf16(const void* c0, void* c, void* cond1, const void* const* w,
                                     const void* const* b, const int* k, const int* n,
                                     const void* const* q, int npix, int s2d, void* stream) {
  return cond_chain<hdrtv::bf16>(c0, c, cond1, w, b, k, n, q, npix, s2d, stream);
}
