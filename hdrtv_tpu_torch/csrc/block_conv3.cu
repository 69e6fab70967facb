// block_conv3 — replaces the Pallas kernel fused_block_conv3
// (hdrtv_tpu/ops/conv_kernels.py:271): a 3×3 'same' conv over an s2d block
// tensor (Hb, Wb, C) → (Hb, Wb, Co) with the epilogue relu(conv + b + skip).
//
// The bf16 float form (bf16 x, w, skip, y; fp32 bias), the one the bf16
// frame programs launch (up_conv2/3), runs the Hopper tile of
// conv3x3_sm90.cuh: wgmma fed by TMA through a ring of stages, persistent
// blocks, and a K walk over a chunk table. With a_sub ≥ 1 (conv_s1 passes it:
// every weight there is a w_s2d_s1 transform or its PS fold) the table lists
// only each output sub-position's 9 non-zero (tap, input sub-position) slots,
// a quarter of the dense product, which the Pallas kernel computes in part
// (its a_sub skips a third of the row taps); a_sub = 0 is the dense product.
// Bound on this card: bytes (a 1080p call moves 166 MB against 38 GFLOP of
// non-zero products: 0.050 ms against 0.039 at the bf16 rate); what holds
// the tile back is its epilogue's stores (tools/sm90_phases.py). Times:
// PERF.md §6.
//
// The fp32 float form with a_sub ≥ 1 (the fp32 programs' twelve calls) runs
// the 3×TF32 sibling of that tile (conv3x3_tf32x3.cuh): the same table and
// TMA boxes in fp32, products split into big·big + small·big + big·small on
// the tensor cores. Bound on this card: operations (171 GFLOP of non-zero
// products a 1080p frame, ×3 at the 494.7 TFLOP/s TF32 rate, 1.04 ms). The
// dense fp32 product (a_sub = 0) runs the implicit-GEMM tile of conv3x3.cuh
// (128 pixels × 128 channels per block, fp32 FMA).
//
// The native-int8 (W8A8) body of the same Pallas kernel (`quant`,
// conv_kernels.py:180-227; the wrapper counts it as block_conv3_w8a8), when
// the call passes the layer's QuantParams: x quantized per tensor, the conv as
// int8 × int8 → int32 dots, rescaled per output channel, then bias, skip and
// ReLU. Bound on this card: bytes (a 1080p call needs at most 38 GOP of
// non-zero int8 products, 0.02 ms at the 1979 TOPS int8 rate, less than its
// activations take at 3.35 TB/s). Two launches from one host call: a
// quantize pass that writes x's codes once (1 byte a value) into scratch the
// wrapper allocates, then the conv. Dense (a_sub = 0): the mma.sync int8
// tile of conv3x3_s8.cuh, which fills out-of-image taps with the layer's
// pad code. a_sub = 1 (conv_s1 passes it; s2d C = 128 → Co = 128 or 512):
// the wgmma s8 tile of conv3x3_s8_sm90.cuh over the slot table the wrapper
// passes, 4 N tiles of 32 per output sub-position, the pad code written
// over out-of-image box rows, bias, skip and ReLU in its epilogue, stored
// by TMA inside the image (up_conv2's odd 135 rows included): in bf16 the
// int8 programs' up_conv2.0 at L2 and up_conv3.0 at L1 (PS-folded); in
// fp32 all twelve calls of the int8 fp32 program (HR_conv1/2, the trunk
// convs, the up convs), through the tile's fp32-output epilogue (y and the
// trunk conv2s' skip in fp32, 128-byte output rows staged in its 128-byte
// swizzle).
// Quantizing on load inside the tile, which saves the codes' round trip, is
// later work.
//
// The pool_out form (conv_kernels.py:259-266, :342-346; counted as
// block_conv3_pool, with q block_conv3_pool_w8a8): the 2×2 max pool of the
// result, after the ReLU, taken in the epilogue of the tile that runs, so
// the full-resolution output (4× the pooled bytes) never reaches device
// memory: y is (H/2, W/2, Co), H and W even. With a_sub ≥ 1 the call walks
// the unpooled call's table on the same Hopper tile, in a pooled instance
// of its epilogue (the launchers below): bf16 conv3x3_sm90.cuh's kEpiPool,
// fp32 the 3×TF32 tile's POOL, int8 (a_sub = 1, C = 128, either type) the
// wgmma s8 tile's POOL after the quantize pass. A tile row is 64 conv
// pixels, so a pooled pixel's two columns sit in lanes l and l ^ 4 of one
// warp (one shuffle), and its two rows in one thread (the bf16 tile's BN =
// 32 instance), or in the two warpgroups, which exchange half their
// channels through the stage of the tile's last chunk (bf16, 3×TF32), or
// in the s8 tile's two staged output rows, which the block maxes before one
// TMA store of the pooled row. Bound on this card at L1 up_conv3's shape
// (270 × 480 × 128 → 512, 38 GFLOP of non-zero products): bf16 operations
// (0.039 ms at the bf16 rate, 68 MB), fp32 operations at the tile's rate
// (×3 at 494.7 TFLOP/s, 0.23 ms; 0.57 at the FMA rate), int8 bytes (0.020
// ms bf16, 0.040 fp32). The dense product (a_sub = 0) keeps the old tiles,
// which walk pooled pixels (conv3x3.cuh): the four conv pixels of a pooled
// one in one thread's registers (fp32 FMA) or in four lanes of one warp
// (bf16 and int8 mma.sync). Times: PERF.md §6.
#include "conv3x3_s8.cuh"
#include "conv3x3_s8_sm90.cuh"
#include "conv3x3_tf32x3.cuh"

namespace hdrtv {
namespace {

// block_conv3's bf16 pool_out form (stride 1; arguments as conv3x3_sm90,
// the input pitch C): the kEpiPool instance at the N tile and weights'
// place the unpooled call takes, y (H/2, W/2, Co); H and W even.
inline cudaError_t conv3x3_sm90_pool(const void* x, const void* w, const float* b, const void* skip, void* y,
                                     int H, int W, int C, int Co, int act, int a_sub, const int* table,
                                     int per_list, cudaStream_t stream) {
  Sm90Args<bf16> a;
  const cudaError_t err = sm90_setup(a, w, b, skip, y, H, W, 1, C, 0, C, Co, act, a_sub, table, per_list);
  if (err != cudaSuccess) return err;
  return launch_sm90_fit<1, kEpiPool>(a, x, H, W, C, stream);
}

// block_conv3's fp32 pool_out form (stride 1; arguments as conv3x3_tf32x3,
// the input pitch C): the POOL instance at the N tile the unpooled call
// takes, y (H/2, W/2, Co); H and W even.
inline cudaError_t conv3x3_tf32x3_pool(const void* x, const void* w, const float* b, const void* skip, void* y,
                                       int H, int W, int C, int Co, int act, int a_sub, const int* table,
                                       int per_list, cudaStream_t stream) {
  Sm90Args<float> a;
  const cudaError_t err = sm90_setup(a, w, b, skip, y, H, W, 1, C, 0, C, Co, act, a_sub, table, per_list);
  if (err != cudaSuccess) return err;
  if (per_list > kTf32MaxList) return cudaErrorInvalidValue;
  return launch_tf32x3_fit<1, true>(a, x, H, W, C, stream);
}

// block_conv3_w8a8's pool_out form: as conv3x3_s8_sm90, then the 2×2 max
// pool of the result in the epilogue (the POOL instance, its skip read
// there), y (H/2, W/2, Co); H and W even.
inline cudaError_t conv3x3_s8_sm90_pool(const void* q, const QuantParams& p, const void* skip, void* y, int H,
                                        int W, int C, int Co, int act, const int* table, int per_list,
                                        cudaStream_t stream, bool f32_out) {
  S8Sm90Args a;
  const cudaError_t err =
      s8_sm90_setup<1>(a, q, 0, &p, 1, skip, y, H, W, C, Co, 1, act, table, per_list, f32_out, true);
  if (err != cudaSuccess) return err;
  return f32_out ? launch_s8_sm90<1, false, true, true>(a, stream) : launch_s8_sm90<1, false, false, true>(a, stream);
}

}  // namespace
}  // namespace hdrtv

namespace {

template <typename T>
int block_conv3(const void* x, const void* w, const void* b, const hdrtv::QuantParams* q,
                const void* skip, void* y, void* codes, int H, int W, int C, int Co, int relu,
                int pool, int a_sub, const int* table, int per_list, void* stream) {
  if (pool && (H % 2 || W % 2)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table) {
    const int act = relu ? hdrtv::ACT_RELU : hdrtv::ACT_NONE;
    constexpr bool f32 = std::is_same<T, float>::value;
    if (q) {
      cudaError_t err = hdrtv::quantize<T>(x, codes, static_cast<long long>(H) * W * C, *q, s);
      if (err == cudaSuccess)
        err = pool ? hdrtv::conv3x3_s8_sm90_pool(codes, *q, skip, y, H, W, C, Co, act, table, per_list, s, f32)
                   : hdrtv::conv3x3_s8_sm90(codes, *q, skip, y, H, W, C, Co, act, table, per_list, s, nullptr, f32);
      return static_cast<int>(err);
    }
    const float* bf = static_cast<const float*>(b);
    if constexpr (f32)
      return static_cast<int>(
          pool ? hdrtv::conv3x3_tf32x3_pool(x, w, bf, skip, y, H, W, C, Co, act, a_sub, table, per_list, s)
               : hdrtv::conv3x3_tf32x3<1>(x, w, bf, skip, y, H, W, C, 0, C, Co, act, a_sub, table, per_list, s));
    else
      return static_cast<int>(
          pool ? hdrtv::conv3x3_sm90_pool(x, w, bf, skip, y, H, W, C, Co, act, a_sub, table, per_list, s)
               : hdrtv::conv3x3_sm90<1>(x, w, bf, skip, y, H, W, C, 0, C, Co, act, a_sub, table, per_list, s));
  }
  cudaError_t err = cudaSuccess;
  if (q) err = hdrtv::quantize<T>(x, codes, static_cast<long long>(H) * W * C, *q, s);
  if (err == cudaSuccess)
    err = hdrtv::conv3x3_or_s8<T, T>(q ? codes : x, w, b, q, skip, y, H, W, C, Co,
                                     relu ? hdrtv::ACT_RELU : hdrtv::ACT_NONE, s, pool);
  return static_cast<int>(err);
}

}  // namespace

// q: null for the float form, else the layer's int8 parameters (w and b
// unused; codes: H·W·C bytes of scratch, unused without q). pool: 1 for the
// pool_out form, y (H/2, W/2, Co). table: null, or the chunk lists of
// conv3x3_sm90.cuh for a_sub, per_list entries each, which send the call
// (pooled or not) to the Hopper tile (bf16) or its 3×TF32 sibling (fp32),
// or with q (a_sub = 1, either type) to the wgmma s8 tile.
extern "C" int hdrtv_block_conv3_f32(const void* x, const void* w, const void* b, const void* q,
                                     const void* skip, void* y, void* codes, int H, int W, int C,
                                     int Co, int relu, int pool, int a_sub, const int* table,
                                     int per_list, void* stream) {
  return block_conv3<float>(x, w, b, hdrtv::quant_params(q), skip, y, codes, H, W, C, Co, relu,
                            pool, a_sub, table, per_list, stream);
}

extern "C" int hdrtv_block_conv3_bf16(const void* x, const void* w, const void* b, const void* q,
                                      const void* skip, void* y, void* codes, int H, int W, int C,
                                      int Co, int relu, int pool, int a_sub, const int* table,
                                      int per_list, void* stream) {
  return block_conv3<hdrtv::bf16>(x, w, b, hdrtv::quant_params(q), skip, y, codes, H, W, C, Co,
                                  relu, pool, a_sub, table, per_list, stream);
}
