// agcm_head — replaces the Pallas kernel fused_agcm_head
// (hdrtv_tpu/ops/megakernel.py:209): AGCM, three 1×1 convs each followed by
// the frame's global modulation v·(s+1)+sh (ReLU after the first two), and
// the fused LE input conv (conv_first‖cond_first.0, 3×3 'same' over the
// 12-channel AGCM result) with its relu / lrelu halves. Reads the s2d frame
// once, as u8 row-pair planes (Hb, 2, Wb, 6), u8 (Hb, Wb, 12) or the element
// type; writes fea (Hb, Wb, Cf), c0 (Hb, Wb, Cc) and the AGCM result
// (Hb, Wb, 12), the LE long skip.
//
// Bound on this card: bytes in bf16 (6 MB in, 411 MB out per 1080p call;
// 117 GFLOP dense on the tensor cores), operations in fp32. Design: two
// launches from one host call, both on the 64-pixel tile product of
// pointwise.cuh.
//   1. agcm_kernel: a block widens its 64 pixels (u8 → fp32, · scale, rounded
//      to the element type, 12 channels padded to 16 with zeros) into shared
//      memory and runs the three products there (K = 16, C1, C2); the two
//      hidden activations stay in shared memory, only the 12-channel result
//      is written. The modulation is fp32 with the fp32 mods, multiply and
//      add rounded separately.
//   2. in_conv_kernel: a block gathers its 64 pixels' nine taps of the AGCM
//      result into one shared (64, 9·12 → 112) tile, out-of-image taps zero,
//      and multiplies it by the (112, Cf + Cc) weight: one K = 112 product in
//      place of nine K = 12 ones, as the TPU kernel concatenates its taps.
// The zero taps are the 'same' padding of the input conv, applied to the
// AGCM result after the modulation (AGCM of a zero pixel is not zero): the
// TPU kernel masks its halo rows, here nothing outside the image is ever
// stored or read. Where it falls short of the TPU kernel: the 12-channel
// result makes one round trip through device memory (12 MB in bf16, and it
// is an output anyway). Rounding points as in _agcm_head_kernel: x, a, b and
// the AGCM result are each rounded to the element type, sums and biases are
// fp32, the leaky slope is 0.1 in fp32.
//
// The host pads once (ops/megakernel.py agcm_head_pack): aw1 (12 → 16, C1),
// aw3 (C2, 12 → 16), w_in as (108 → 112, Co).
#include "pointwise.cuh"

namespace hdrtv {
namespace {

constexpr int kCin = 12, kCinP = 16;  // s2d channels of an RGB frame, padded for the tile product
constexpr int kKcat = 112;            // 9 taps × 12 channels, padded to a multiple of 16
constexpr int kCatQuads = kKcat / 4;  // 27 quads of taps, one of padding

enum FrameKind : int { FRAME_T = 0, FRAME_U8 = 1, FRAME_U8_PAIRS = 2 };

struct AgcmArgs {
  const void* x;  // the frame, see FrameKind
  int kind;
  float scale;
  const float* mods;  // (6, mw) fp32
  int mw;
  const void* w[3];  // aw1 (16, c1), aw2 (c1, c2), aw3 (c2, 16), T
  const float* b[3];
  void* agcm;  // (npix, 12) T
  int npix, W, c1, c2, lda;
};

// Channel ch of pixel m of the frame, widened to fp32. Pair planes hold the
// two row parities apart: channel 6a + k of block (i, j) is x[i, a, j, k].
template <typename T>
__device__ __forceinline__ float frame_value(const AgcmArgs& a, long long m, int ch) {
  if (a.kind == FRAME_T) return to_float<T>(static_cast<const T*>(a.x)[m * kCin + ch]);
  const uint8_t* x = static_cast<const uint8_t*>(a.x);
  if (a.kind == FRAME_U8) return static_cast<float>(x[m * kCin + ch]);
  const long long i = m / a.W;
  const long long j = m - i * a.W;
  const int par = ch / (kCin / 2);
  return static_cast<float>(x[((i * 2 + par) * a.W + j) * (kCin / 2) + ch - par * (kCin / 2)]);
}

// out[row][n] = T(act(mod(in · w + b))) for the block's 64 rows, with the
// modulation rows mrow (scale) and mrow + 1 (shift) of mods.
template <typename T, bool MMA>
__device__ __forceinline__ void mod_layer(const AgcmArgs& a, const T* in, int ldin, int K,
                                          int layer, int N, int mrow, T* out, void* stage) {
  float acc[kPwPairs][2];
  const float* sc = a.mods + static_cast<long long>(mrow) * a.mw;
  const float* sh = sc + a.mw;
  for (int n0 = 0; n0 < N; n0 += kPwBN) {
    tile_gemm<T, MMA>(in, ldin, K, static_cast<const T*>(a.w[layer]), N, n0, stage, acc);
#pragma unroll
    for (int p = 0; p < kPwPairs; ++p) {
      const int n = n0 + Own<MMA>::col(p);
      if (n >= N) continue;
      const float2 v = bias_act2(acc[p], a.b[layer] + n, ACT_NONE);
      const float2 s = *reinterpret_cast<const float2*>(sc + n);
      const float2 h = *reinterpret_cast<const float2*>(sh + n);
      store2<T>(out + Own<MMA>::row(p) * a.lda + n,
                make_float2(fmaxf(__fadd_rn(__fmul_rn(v.x, s.x + 1.f), h.x), 0.f),
                            fmaxf(__fadd_rn(__fmul_rn(v.y, s.y + 1.f), h.y), 0.f)));
    }
  }
}

template <typename T, bool MMA>
__global__ void __launch_bounds__(kPwThreads) agcm_kernel(AgcmArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ldx = kCinP + pw_pad<T>();
  T* xs = reinterpret_cast<T*>(smem + kPwStageBytes);
  T* buf_a = xs + kPwBM * ldx;
  T* buf_b = buf_a + kPwBM * a.lda;
  const long long m0 = static_cast<long long>(blockIdx.x) * kPwBM;

  for (int idx = threadIdx.x; idx < kPwBM * kCinP; idx += kPwThreads) {
    const int m = idx / kCinP;
    const int ch = idx - m * kCinP;
    float v = 0.f;
    if (ch < kCin && m0 + m < a.npix) v = __fmul_rn(frame_value<T>(a, m0 + m, ch), a.scale);
    xs[m * ldx + ch] = static_cast<T>(v);
  }

  mod_layer<T, MMA>(a, xs, ldx, kCinP, 0, a.c1, 0, buf_a, smem);
  mod_layer<T, MMA>(a, buf_a, a.lda, a.c1, 1, a.c2, 2, buf_b, smem);

  // The last product has 12 real columns of the padded 16; no ReLU.
  float acc[kPwPairs][2];
  tile_gemm<T, MMA>(buf_b, a.lda, a.c2, static_cast<const T*>(a.w[2]), kCinP, 0, smem, acc);
  const float* sc = a.mods + 4LL * a.mw;
  const float* sh = sc + a.mw;
  T* agcm = static_cast<T*>(a.agcm);
#pragma unroll
  for (int p = 0; p < kPwPairs; ++p) {
    const long long m = m0 + Own<MMA>::row(p);
    const int n = Own<MMA>::col(p);
    if (n >= kCin || m >= a.npix) continue;
    const float2 v = bias_act2(acc[p], a.b[2] + n, ACT_NONE);
    const float2 s = *reinterpret_cast<const float2*>(sc + n);
    const float2 h = *reinterpret_cast<const float2*>(sh + n);
    store2<T>(agcm + m * kCin + n, make_float2(__fadd_rn(__fmul_rn(v.x, s.x + 1.f), h.x),
                                               __fadd_rn(__fmul_rn(v.y, s.y + 1.f), h.y)));
  }
}

struct InConvArgs {
  const void* agcm;  // (H, W, 12) T
  const void* wcat;  // (112, Co) T
  const float* b;    // (Co)
  void* fea;         // (H·W, nfirst) T: relu
  void* c0;          // (H·W, Co − nfirst) T: lrelu
  int H, W, Co, nfirst;
};

template <typename T, bool MMA>
__global__ void __launch_bounds__(kPwThreads) in_conv_kernel(InConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int lda = kKcat + pw_pad<T>();
  T* taps = reinterpret_cast<T*>(smem + kPwStageBytes);
  const T* agcm = static_cast<const T*>(a.agcm);
  const long long npix = static_cast<long long>(a.H) * a.W;
  const long long m0 = static_cast<long long>(blockIdx.x) * kPwBM;

  // Quad r of a pixel's 112 columns is channels [4q, 4q + 4) of tap r / 3
  // (q = r % 3), taps in (dI, dJ) row-major order; quad 27 is padding.
  for (int idx = threadIdx.x; idx < kPwBM * (kCatQuads + 1); idx += kPwThreads) {
    const int m = idx / (kCatQuads + 1);
    const int r = idx - m * (kCatQuads + 1);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < kCatQuads && m0 + m < npix) {
      const int tap = r / 3;
      const int i = static_cast<int>((m0 + m) / a.W) + tap / 3 - 1;
      const int j = static_cast<int>((m0 + m) % a.W) + tap % 3 - 1;
      if (i >= 0 && i < a.H && j >= 0 && j < a.W)
        v = load4<T>(agcm + (static_cast<long long>(i) * a.W + j) * kCin + (r - tap * 3) * 4);
    }
    store4<T>(taps + m * lda + r * 4, v);
  }

  T* fea = static_cast<T*>(a.fea);
  T* c0 = static_cast<T*>(a.c0);
  const int ncond = a.Co - a.nfirst;
  float acc[kPwPairs][2];
  for (int n0 = 0; n0 < a.Co; n0 += kPwBN) {
    tile_gemm<T, MMA>(taps, lda, kKcat, static_cast<const T*>(a.wcat), a.Co, n0, smem, acc);
#pragma unroll
    for (int p = 0; p < kPwPairs; ++p) {
      const long long m = m0 + Own<MMA>::row(p);
      const int n = n0 + Own<MMA>::col(p);
      if (n >= a.Co || m >= npix) continue;
      if (n < a.nfirst) {
        store2<T>(fea + m * a.nfirst + n, bias_act2(acc[p], a.b + n, ACT_RELU));
      } else {
        store2<T>(c0 + m * ncond + n - a.nfirst, bias_act2(acc[p], a.b + n, ACT_LRELU));
      }
    }
  }
}

template <typename T, bool MMA>
cudaError_t launch_head(const AgcmArgs& g, const InConvArgs& c, cudaStream_t stream) {
  static const cudaError_t attr = allow_large_smem(agcm_kernel<T, MMA>);
  if (attr != cudaSuccess) return attr;
  const size_t agcm_bytes =
      kPwStageBytes + static_cast<size_t>(kPwBM) * (kCinP + pw_pad<T>() + 2 * g.lda) * sizeof(T);
  if (agcm_bytes > kMaxDynSmem) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((g.npix + kPwBM - 1) / kPwBM);
  agcm_kernel<T, MMA><<<blocks, kPwThreads, agcm_bytes, stream>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t conv_bytes =
      kPwStageBytes + static_cast<size_t>(kPwBM) * (kKcat + pw_pad<T>()) * sizeof(T);
  in_conv_kernel<T, MMA><<<blocks, kPwThreads, conv_bytes, stream>>>(c);
  return cudaGetLastError();
}

template <typename T>
int agcm_head(const void* x, int kind, float scale, const void* mods, int mw, const void* aw1,
              const void* ab1, const void* aw2, const void* ab2, const void* aw3, const void* ab3,
              const void* wcat, const void* b_in, void* fea, void* c0, void* agcm, int H, int W,
              int c1, int c2, int co, int nfirst, void* stream) {
  if (kind < FRAME_T || kind > FRAME_U8_PAIRS || c1 % kPwBK || c2 % kPwBK || co % 8 ||
      nfirst % 8 || nfirst <= 0 || nfirst >= co || mw % 2 || mw < c1 || mw < c2 || mw < kCin)
    return static_cast<int>(cudaErrorInvalidValue);
  AgcmArgs g;
  g.x = x;
  g.kind = kind;
  g.scale = scale;
  g.mods = static_cast<const float*>(mods);
  g.mw = mw;
  g.w[0] = aw1;
  g.w[1] = aw2;
  g.w[2] = aw3;
  g.b[0] = static_cast<const float*>(ab1);
  g.b[1] = static_cast<const float*>(ab2);
  g.b[2] = static_cast<const float*>(ab3);
  g.agcm = agcm;
  g.npix = H * W;
  g.W = W;
  g.c1 = c1;
  g.c2 = c2;
  g.lda = (c1 > c2 ? c1 : c2) + pw_pad<T>();
  InConvArgs c;
  c.agcm = agcm;
  c.wcat = wcat;
  c.b = static_cast<const float*>(b_in);
  c.fea = fea;
  c.c0 = c0;
  c.H = H;
  c.W = W;
  c.Co = co;
  c.nfirst = nfirst;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, bf16>::value) return static_cast<int>(launch_head<T, true>(g, c, st));
  return static_cast<int>(launch_head<T, false>(g, c, st));
}

}  // namespace
}  // namespace hdrtv

// kind: 0 the frame in the element type (Hb, Wb, 12), 1 u8 (Hb, Wb, 12),
// 2 u8 row-pair planes (Hb, 2, Wb, 6). aw1, aw3 and wcat are the padded forms.
extern "C" int hdrtv_agcm_head_f32(const void* x, int kind, float scale, const void* mods, int mw,
                                   const void* aw1, const void* ab1, const void* aw2,
                                   const void* ab2, const void* aw3, const void* ab3,
                                   const void* wcat, const void* b_in, void* fea, void* c0,
                                   void* agcm, int H, int W, int c1, int c2, int co, int nfirst,
                                   void* stream) {
  return hdrtv::agcm_head<float>(x, kind, scale, mods, mw, aw1, ab1, aw2, ab2, aw3, ab3, wcat,
                                 b_in, fea, c0, agcm, H, W, c1, c2, co, nfirst, stream);
}

extern "C" int hdrtv_agcm_head_bf16(const void* x, int kind, float scale, const void* mods, int mw,
                                    const void* aw1, const void* ab1, const void* aw2,
                                    const void* ab2, const void* aw3, const void* ab3,
                                    const void* wcat, const void* b_in, void* fea, void* c0,
                                    void* agcm, int H, int W, int c1, int c2, int co, int nfirst,
                                    void* stream) {
  return hdrtv::agcm_head<hdrtv::bf16>(x, kind, scale, mods, mw, aw1, ab1, aw2, ab2, aw3, ab3,
                                       wcat, b_in, fea, c0, agcm, H, W, c1, c2, co, nfirst,
                                       stream);
}
