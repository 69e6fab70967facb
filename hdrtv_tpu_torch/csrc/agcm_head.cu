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
//
// The s2d form (the wrapper's s2d=True, bf16: the AGCM 1×1s w_s2d_1x1, their
// biases b_s2d, w_in = w_s2d_s1(conv_first) ‖ w_s2d_s1(cond_first.0), as the
// frame programs' are; hdrtv_agcm_head_s2d_bf16), two launches on Hopper
// tiles:
//   1. the AGCM pass on chain_sm90.cuh's row tile (agcm_sm90): the frame's
//      (4·npix, 3) natural rows through the three 1×1s' diagonal blocks on
//      wgmma, the modulation at each row's own sub-position; writes agcm;
//   2. in_conv_sm90_kernel, the input conv, store-bound: a block (one
//      warpgroup, two per SM, persistent) takes 64 consecutive s2d pixels
//      of one row, stages their agcm halo (3 rows × 66 columns × 12
//      channels, zero outside the image: the 'same' pad after the
//      modulation) by cp.async, the next tile's while this one computes,
//      and per output sub-position so runs one m64 pass: A is the 64
//      pixels × so's 9 slots of models/s2d.py s2d_slots(1) × 3 channels (27
//      of K = 32), gathered from the stage into registers; B is so's own
//      (32, 96) weight, 32 fea and 64 c0 columns (agcm_head_pack_s2d),
//      resident; two wgmma.m64n96k16. A quarter of the dense product's
//      operations, none of the 3/4 zeros of the s2d weight. The epilogue
//      adds the fp32 bias, applies ReLU (fea) or leaky ReLU 0.1 (c0),
//      rounds once and stages the tile's whole (64, 128 ‖ 256) output in
//      six 128-byte-swizzled boxes of 64 pixels × 64 channels (fea two, c0
//      four); one thread writes them out by TMA stores through 3-D maps of
//      fea and c0, (C, W, H), which clip a box at the row's end.
// Bound on this card: bytes, the 398 MB of fea and c0 at 1080p (0.12 ms);
// 12.7 GFLOP of slot products (0.013 ms).
//
// The s2d form in fp32 (s2d=True in fp32; hdrtv_agcm_head_s2d_f32), two
// launches on the 3×TF32 instances of those tiles (below): the AGCM pass on
// agcm_tf32x3.cuh's agcm_tf32x3_kernel (every value fp32, nothing
// narrowed), then in_conv_tf32x3_kernel, one sub-position's output staged
// and stored by TMA at a time, under the next one's products. The dense
// form (agcm_kernel, in_conv_kernel) stays for s2d=False in either type.
#include "agcm_tf32x3.cuh"
#include "chain_sm90.cuh"
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
  static DeviceCache cache;
  const cudaError_t attr = allow_large_smem(cache, agcm_kernel<T, MMA>);
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

// ---------------------------------------------------------------------------
// The s2d form's input conv (see the header).
// ---------------------------------------------------------------------------

struct InConvSm90Args {
  CUtensorMap fea_map, c0_map;  // fea (128, W, H) and c0 (256, W, H), box (64, 64, 1), 128-byte swizzle
  const bf16* agcm;  // (H, W, 12)
  const bf16* w;     // (4, 32, 96): so's rows 3·k + c (slot k of so, channel c; 27 of 32), fea ‖ c0 columns
  const float* b;    // (4, 96)
  bf16* fea;         // (H, W, 4·32)
  bf16* c0;          // (H, W, 4·64)
  int H, W;
  int slot[36];      // so's 9 slots (s2d_slots(1), its order) at [9·so, 9·so + 9): tap | si << 4
};

// The staged output goes out by TMA: six boxes of 64 channels × 64 pixels
// (fea two, c0 four), the stage in the boxes' 128-byte swizzle, clipped at
// the row's end by the maps.
struct InConvSm90Cfg {
  static constexpr int CF = 32, CC = 64, N = CF + CC;  // one sub-position's fea and c0 columns
  static constexpr int K = 32;                         // 9 slots × 3 channels, padded
  static constexpr int TW = 64;                        // pixels of a tile: one m64 tile
  static constexpr int HC = TW + 2;                    // halo columns
  static constexpr int PIX = 12 * 2;                   // bytes of an agcm pixel
  static constexpr int HALO = 3 * HC * PIX;
  static constexpr int W_BYTES = 4 * K * N * 2;
  static constexpr int BIAS_BYTES = 4 * N * 4;
  static constexpr int OFF_BYTES = 4 * K * 2;
  static constexpr int BOX = TW * 128;            // a TMA box: 64 pixels × 64 channels
  static constexpr int STAGE = 6 * BOX;
  static constexpr int SMEM = 1024 + STAGE + W_BYTES + BIAS_BYTES + OFF_BYTES + 2 * HALO;
  static_assert(STAGE % 16 == 0 && (W_BYTES + BIAS_BYTES + OFF_BYTES) % 16 == 0, "16-byte alignment");
  static_assert(2 * (SMEM + 1024) <= 228 * 1024, "two blocks per SM");
};

// 8 bytes from global memory into shared memory, or 8 zero bytes where !ok.
__device__ __forceinline__ void cp_async8_or_zero(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem), "r"(ok ? 8 : 0) : "memory");
}

// Byte offset of bf16 channel ch (of 64·boxes) of pixel px in the stage: box
// ch / 64, its 128-byte row px, the row's 16-byte chunks swizzled by px % 8
// (conflict-free pair stores: the 8 pixels of a quad row hit 8 chunks).
__device__ __forceinline__ int tma_stage_at(int px, int ch) {
  const int byte = (ch & 63) * 2;
  return (ch >> 6) * (64 * 128) + px * 128 + (((byte >> 4) ^ (px & 7)) << 4) + (byte & 15);
}

__global__ void __launch_bounds__(128, 2) in_conv_sm90_kernel(const __grid_constant__ InConvSm90Args a) {
  using Cfg = InConvSm90Cfg;
  constexpr int K = Cfg::K, N = Cfg::N, TW = Cfg::TW, HC = Cfg::HC;
  extern __shared__ __align__(16) unsigned char conv_smem[];
  // the stage's swizzle repeats every 1024 bytes: align it to 1024
  const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(conv_smem));
  unsigned char* const stage = conv_smem + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* const smem = stage + Cfg::STAGE;
  float* const bias = reinterpret_cast<float*>(smem + Cfg::W_BYTES);
  short* const offs = reinterpret_cast<short*>(smem + Cfg::W_BYTES + Cfg::BIAS_BYTES);
  unsigned char* const halo = smem + Cfg::W_BYTES + Cfg::BIAS_BYTES + Cfg::OFF_BYTES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, q = lane & 3, g = lane >> 2;

  for (int so = 0; so < 4; ++so) stage_b(smem + so * K * N * 2, N, 0, a.w + so * K * N, N, K, N);
  for (int i = tid; i < 4 * N; i += blockDim.x) bias[i] = a.b[i];
  // Column k of so's A is the stage element offs[so·K + k] + 12·px for pixel
  // px: slot k / 3 at tap (dI, dJ) (halo row dI, column px + dJ), input
  // sub-position si, channel k % 3; −1 for the padding.
  for (int i = tid; i < 4 * K; i += blockDim.x) {
    const int so = i / K, k = i % K;
    short o = -1;
    if (k < 27) {
      const int e = a.slot[so * 9 + k / 3], tap = e & 15, si = e >> 4;
      o = static_cast<short>((tap / 3) * HC * 12 + (tap % 3) * 12 + si * 3 + k % 3);
    }
    offs[i] = o;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int tw = (a.W + TW - 1) / TW;
  const int tiles = a.H * tw;
  // tile t: row t / tw, pixels 64·(t % tw) ..; its halo rows i − 1 .. i + 1,
  // columns j0 − 1 .. j0 + 64, each pixel three 8-byte pieces
  auto load_halo = [&](int tile, int buf) {
    const int i = tile / tw, j0 = (tile % tw) * TW;
    unsigned char* const hs = halo + buf * Cfg::HALO;
    for (int idx = tid; idx < 3 * HC * 3; idx += blockDim.x) {
      const int r = idx / (HC * 3), rem = idx - r * (HC * 3), col = rem / 3, piece = rem - col * 3;
      const int gi = i + r - 1, gj = j0 + col - 1;
      const bool ok = gi >= 0 && gi < a.H && gj >= 0 && gj < a.W;
      const bf16* const src = a.agcm + (ok ? (static_cast<long long>(gi) * a.W + gj) * 12 + piece * 4 : 0);
      cp_async8_or_zero(hs + (r * HC + col) * Cfg::PIX + piece * 8, src, ok);
    }
  };

  const unsigned wbase = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (blockIdx.x < tiles) load_halo(blockIdx.x, 0);
  cp_async_commit();
  int k = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++k) {
    // this tile's halo arrived (everyone's copies); everyone is done with
    // the last tile's halo, which the next tile's copy refills
    if (tile + gridDim.x < tiles) load_halo(tile + gridDim.x, (k + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned short* const hs = reinterpret_cast<const unsigned short*>(halo + (k & 1) * Cfg::HALO);
#pragma unroll 1
    for (int so = 0; so < 4; ++so) {
      // A fragments of warp rows 16·warp + g (+ 8), columns 16·kc + 2q (+ 8), pairs packed
      unsigned af[2][4];
      const short* const of = offs + so * K;
#pragma unroll
      for (int kc = 0; kc < 2; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int px = warp * 16 + g + 8 * (r & 1);
          const int kk = 16 * kc + 2 * q + 8 * (r >> 1);
          const int o0 = of[kk], o1 = of[kk + 1];
          const unsigned lo = o0 < 0 ? 0u : hs[o0 + px * 12];
          const unsigned hi = o1 < 0 ? 0u : hs[o1 + px * 12];
          af[kc][r] = lo | hi << 16;
        }
      float d[N / 2];
      const unsigned wb = wbase + so * K * N * 2;
      wgmma_fence();
      WgmmaRA<N>::mma(d, af[0], desc_rows_b(wb, N, 0), 0);
      WgmmaRA<N>::mma(d, af[1], desc_rows_b(wb, N, 1), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(d);
      fence_frags(af);
      if (so == 0) {
        // the last tile's store has read the stage (it ran under this tile's first products)
        if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        __syncthreads();
      }
      const float* const bs = bias + so * N;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int n = 8 * j + 2 * q;
        const float2 bb = *reinterpret_cast<const float2*>(bs + n);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = warp * 16 + g + 8 * h;
          const float v0 = d[4 * j + 2 * h] + bb.x, v1 = d[4 * j + 2 * h + 1] + bb.y;
          const bool f = j < Cfg::CF / 8;
          const unsigned u = f ? pack_bf16(apply_act(v0, ACT_RELU), apply_act(v1, ACT_RELU))
                               : pack_bf16(apply_act(v0, ACT_LRELU), apply_act(v1, ACT_LRELU));
          *reinterpret_cast<unsigned*>(stage + (f ? tma_stage_at(px, so * Cfg::CF + n)
                                                  : 2 * Cfg::BOX + tma_stage_at(px, so * Cfg::CC + n - Cfg::CF))) = u;
        }
      }
    }
    // the stage, written by the generic proxy, is read by TMA's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      const int i = tile / tw, j0 = (tile % tw) * TW;
      const unsigned st = static_cast<unsigned>(__cvta_generic_to_shared(stage));
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        const CUtensorMap* const map = b < 2 ? &a.fea_map : &a.c0_map;
        asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n"
                     ::"l"(reinterpret_cast<uint64_t>(map)), "r"((b < 2 ? b : b - 2) * 64), "r"(j0), "r"(i),
                     "r"(st + b * Cfg::BOX)
                     : "memory");
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  cp_async_wait<0>();
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// An output's TMA map: (C, W, H) bf16 (or fp32 with f32), box (128 bytes
// of channels: 64 bf16 or 32 fp32; 64 pixels; 1 row), the 128-byte swizzle
// the stage is written in; out-of-image boxes clipped.
cudaError_t encode_out_map(CUtensorMap* map, void* y, int H, int W, int C, bool f32 = false) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t size = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(C) * size, static_cast<cuuint64_t>(W) * C * size};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / size), 64, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  if (encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, y, dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// agcm_head's s2d form in bf16 (see the header); the natural widths the
// frame programs run, AGCM 3 → 64 → 64 → 3 and the input conv 3 → 32 ‖ 64,
// are the ones it takes (the wrapper checks them).
cudaError_t agcm_head_s2d(const AgcmSm90Args& g, InConvSm90Args& c, cudaStream_t stream) {
  using Cfg = InConvSm90Cfg;
  cudaError_t err = agcm_sm90(g, stream);
  static DeviceCache cache;
  int resident = 0;
  if (err == cudaSuccess) err = resident_blocks(cache, in_conv_sm90_kernel, Cfg::SMEM, &resident, 128);
  if (err == cudaSuccess) err = encode_out_map(&c.fea_map, c.fea, c.H, c.W, 4 * Cfg::CF);
  if (err == cudaSuccess) err = encode_out_map(&c.c0_map, c.c0, c.H, c.W, 4 * Cfg::CC);
  if (err != cudaSuccess) return err;
  const int tiles = c.H * ((c.W + Cfg::TW - 1) / Cfg::TW);
  in_conv_sm90_kernel<<<std::max(1, std::min(tiles, resident)), 128, Cfg::SMEM, stream>>>(c);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The s2d form in fp32 (the wrapper's s2d=True in fp32; see the header): the
// AGCM pass on agcm_tf32x3.cuh's agcm_tf32x3_kernel, then
// in_conv_tf32x3_kernel, the 3×TF32 instance of in_conv_sm90_kernel.
//
// Per tile (64 consecutive s2d pixels of one row) and output sub-position
// so: one m64 pass over so's 9 slots × 3 channels (K = 27 of 32: four k8
// steps, small·big + big·small + big·big each, summed in the tensor cores
// from zero: one 32-position chunk), into so's 32 fea columns (m64n32k8) and
// 64 c0 columns (m64n64k8). A is gathered from the staged agcm halo (fp32,
// 3 rows × 66 columns × 12 channels, zero outside the image: the 'same' pad
// after the modulation; cp.async, the next tile's while this one computes)
// into registers in chain_kpos order and split there; B, so's (32, 96)
// weight of agcm_head_pack_s2d in fp32, is split once per block into shared
// memory (K-major, the 128-byte swizzle, big then small: 24 KB a
// sub-position, 96 KB in all), resident.
//
// Two warpgroups a block, both on the same 64 pixels: warpgroup g takes
// so's columns [48g, 48g + 48) (m64n48k8), each gathering and splitting the
// same A. With one warpgroup taking all 96 columns the epilogue, serialized
// behind the products on one warp a scheduler, took 38% of its cycles
// (0.383 ms at 1080p; PERF.md §6).
//
// The epilogue adds the fp32 bias, applies ReLU (fea) or leaky ReLU 0.1
// (c0) and stages so's (64, 32 ‖ 64) fp32 output in three boxes of 64
// pixels × 32 channels in their 128-byte swizzle (24 KB); one thread stores
// them by TMA through 3-D fp32 maps of fea and c0, (C, W, H), which clip a
// box at the row's end. The bf16 tile stages a tile's whole output (48 KB;
// 96 KB in fp32): here two such per-sub-position stages alternate, so the
// store of one runs under the next sub-position's work, and a stage is
// written again only once its store has read it
// (cp.async.bulk.wait_group.read 1). Shared memory 165 KB: one block per
// SM.
//
// Bound on this card: bytes, the 0.80 GB of fea and c0 at 1080p (0.24 ms);
// 38 GFLOP of padded slot products (K = 32) at a third of the TF32 rate,
// 0.23 ms (10.7 GFLOP non-zero, 0.065 ms). Times: PERF.md §6.
// ---------------------------------------------------------------------------

struct InConvF32Args {
  CUtensorMap fea_map, c0_map;  // fea (128, W, H) and c0 (256, W, H) fp32, box (32, 64, 1), 128-byte swizzle
  const float* agcm;  // (H, W, 12)
  const float* w;     // (4, 32, 96): so's rows 3·k + c (slot k of so, channel c; 27 of 32), fea ‖ c0 columns
  const float* b;     // (4, 96)
  float* fea;         // (H, W, 4·32)
  float* c0;          // (H, W, 4·64)
  int H, W;
  int slot[36];       // so's 9 slots (s2d_slots(1), its order) at [9·so, 9·so + 9): tap | si << 4
#ifdef HDRTV_SM90_PHASES
  unsigned long long* phases = nullptr;  // tools/sm90_phases.py: 8 clock64() sums per block
#endif
};

struct InConvF32Cfg {
  static constexpr int CF = 32, CC = 64, N = CF + CC;  // one sub-position's fea and c0 columns
  static constexpr int K = 32;                         // 9 slots × 3 channels, padded: one chunk
  static constexpr int TW = 64;                        // pixels of a tile: one m64 tile
  static constexpr int HC = TW + 2;                    // halo columns
  static constexpr int PIX = 12 * 4;                   // bytes of an agcm pixel
  static constexpr int HALO = 3 * HC * PIX;
  static constexpr int BOX = TW * 128;                 // a TMA box: 64 pixels × 32 fp32 channels
  static constexpr int OUT = 3 * BOX;                  // one sub-position's stage: fea, c0 [0, 32), c0 [32, 64)
  static constexpr int W_HALF = N * K * 4;             // big or small of one sub-position's weight
  static constexpr int W_BYTES = 4 * 2 * W_HALF;
  static constexpr int BIAS_BYTES = 4 * N * 4;
  static constexpr int OFF_BYTES = 4 * K * 2;
  // shared memory: [1024-byte alignment][2 stages][weights][biases][offsets][2 halos]
  static constexpr int SMEM = 1024 + 2 * OUT + W_BYTES + BIAS_BYTES + OFF_BYTES + 2 * HALO;
  static_assert(OUT % 1024 == 0 && W_HALF % 1024 == 0 && (BIAS_BYTES + OFF_BYTES) % 16 == 0, "alignment");
  static_assert(SMEM <= 227 * 1024, "one block per SM");
};

__global__ void __launch_bounds__(256, 1) in_conv_tf32x3_kernel(const __grid_constant__ InConvF32Args a) {
  using Cfg = InConvF32Cfg;
  constexpr int K = Cfg::K, N = Cfg::N, TW = Cfg::TW, HC = Cfg::HC, CF = Cfg::CF, NH = N / 2;
  extern __shared__ __align__(16) unsigned char conv_smem[];
  const unsigned raw = static_cast<unsigned>(__cvta_generic_to_shared(conv_smem));
  unsigned char* const stage = conv_smem + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* const wsm = stage + 2 * Cfg::OUT;
  float* const bias = reinterpret_cast<float*>(wsm + Cfg::W_BYTES);
  short* const offs = reinterpret_cast<short*>(wsm + Cfg::W_BYTES + Cfg::BIAS_BYTES);
  unsigned char* const halo = wsm + Cfg::W_BYTES + Cfg::BIAS_BYTES + Cfg::OFF_BYTES;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, q = lane & 3, g = lane >> 2;
#ifdef HDRTV_SM90_PHASES
  // Cycles per phase (the halo's wait and meeting; gathering and splitting
  // A; the products and their wait; the wait for a stage's last store; the
  // epilogue and the stores' issue), summed by thread 0 over its steps.
  unsigned long long t_start = clock64(), t_phase[8] = {0, 0, 0, 0, 0, 0, 0, 0}, t_mark = t_start;
#define PHASE(i) (t_phase[i] += clock64() - t_mark, t_mark = clock64());
#else
#define PHASE(i)
#endif

  for (int so = 0; so < 4; ++so) stage_b_tf32x3(wsm + so * 2 * Cfg::W_HALF, N, a.w + so * K * N, N, K);
  for (int i = tid; i < 4 * N; i += blockDim.x) bias[i] = a.b[i];
  // Column k of so's K is the halo element offs[so·K + k] + 12·px (floats)
  // for pixel px: slot k / 3 at tap (dI, dJ) (halo row dI, column px + dJ),
  // input sub-position si, channel k % 3; −1 for the padding.
  for (int i = tid; i < 4 * K; i += blockDim.x) {
    const int so = i / K, k = i % K;
    short o = -1;
    if (k < 27) {
      const int e = a.slot[so * 9 + k / 3], tap = e & 15, si = e >> 4;
      o = static_cast<short>((tap / 3) * HC * 12 + (tap % 3) * 12 + si * 3 + k % 3);
    }
    offs[i] = o;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int tw = (a.W + TW - 1) / TW;
  const int tiles = a.H * tw;
  // tile t: row t / tw, pixels 64·(t % tw) ..; its halo rows i − 1 .. i + 1,
  // columns j0 − 1 .. j0 + 64, each pixel three 16-byte pieces
  auto load_halo = [&](int tile, int buf) {
    const int i = tile / tw, j0 = (tile % tw) * TW;
    unsigned char* const hs = halo + buf * Cfg::HALO;
    for (int idx = tid; idx < 3 * HC * 3; idx += blockDim.x) {
      const int r = idx / (HC * 3), rem = idx - r * (HC * 3), col = rem / 3, piece = rem - col * 3;
      const int gi = i + r - 1, gj = j0 + col - 1;
      const bool ok = gi >= 0 && gi < a.H && gj >= 0 && gj < a.W;
      const float* const src = a.agcm + (ok ? (static_cast<long long>(gi) * a.W + gj) * 12 + piece * 4 : 0);
      cp_async16_or_zero(hs + (r * HC + col) * Cfg::PIX + piece * 16, src, ok);
    }
  };
  // The byte offset of channel n (< 32) of pixel px in a 128-byte-swizzled box.
  auto at = [](int px, int n) { return px * 128 + ((((n >> 2) ^ (px & 7))) << 4) + (n & 3) * 4; };

  const unsigned wbase = static_cast<unsigned>(__cvta_generic_to_shared(wsm));
  const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(stage));
  if (blockIdx.x < tiles) load_halo(blockIdx.x, 0);
  cp_async_commit();
  int k = 0, ob = 0;  // this block's tile count; the stage the next sub-position writes
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++k) {
#ifdef HDRTV_SM90_PHASES
    t_mark = clock64();
#endif
    // this tile's halo arrived (everyone's copies); everyone is done with
    // the last tile's halo (read before its last sub-position's stores),
    // which the next tile's copy refills
    if (tile + gridDim.x < tiles) load_halo(tile + gridDim.x, (k + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    PHASE(1)
    const int ti = tile / tw, j0 = (tile % tw) * TW;
    const float* const hs = reinterpret_cast<const float*>(halo + (k & 1) * Cfg::HALO);
#pragma unroll 1
    for (int so = 0; so < 4; ++so) {
      // A (the same in both warpgroups): rows 16·warp + g (+ 8); k8 step j's
      // k = q and q + 4 are so's columns 8j + 2q and 8j + 2q + 1 (chain_kpos), split
      uint32_t ab[4][4], as[4][4];
      const short* const of = offs + so * K;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = warp * 16 + g + 8 * h;
          const int o0 = of[8 * j + 2 * q], o1 = of[8 * j + 2 * q + 1];
          split_pair(o0 < 0 ? 0.f : hs[o0 + px * 12], o1 < 0 ? 0.f : hs[o1 + px * 12], ab, as, j, h);
        }
      PHASE(2)
      // this warpgroup's 48 of so's 96 columns (fea ‖ c0): rows 48·wg .. of so's weight
      float d[NH / 2];
      const unsigned wb = wbase + so * 2 * Cfg::W_HALF + wg * NH * 128;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        WgmmaTf32<NH>::mma(d, as[j], desc_sw128(wb + j * 32), j > 0);
        WgmmaTf32<NH>::mma(d, ab[j], desc_sw128(wb + Cfg::W_HALF + j * 32));
        WgmmaTf32<NH>::mma(d, ab[j], desc_sw128(wb + j * 32));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(d);
      fence_frags(ab);
      fence_frags(as);
      PHASE(3)
      // the store two sub-positions back has read this stage
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      __syncthreads();
      PHASE(4)
      unsigned char* const st = stage + ob * Cfg::OUT;
      const float* const bs = bias + so * N;
#pragma unroll
      for (int jj = 0; jj < NH / 8; ++jj) {
        const int n = wg * NH + 8 * jj + 2 * q;  // so's column: fea below CF, c0 from CF
        const float2 bb = *reinterpret_cast<const float2*>(bs + n);
        const bool f = n < CF;
        const int act = f ? ACT_RELU : ACT_LRELU;
        // fea: box 0, channel n; c0: box 1 + (n − 32) / 32, channel (n − 32) % 32
        const int box = f ? 0 : 1 + ((n - CF) >> 5), nn = f ? n : (n - CF) & 31;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = warp * 16 + g + 8 * h;
          *reinterpret_cast<float2*>(st + box * Cfg::BOX + at(px, nn)) =
              make_float2(apply_act(d[4 * jj + 2 * h] + bb.x, act), apply_act(d[4 * jj + 2 * h + 1] + bb.y, act));
        }
      }
      // the stage, written by the generic proxy, is read by TMA's async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (tid == 0) {
        const unsigned src = sbase + ob * Cfg::OUT;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const CUtensorMap* const map = b == 0 ? &a.fea_map : &a.c0_map;
          const int c = b == 0 ? so * CF : so * Cfg::CC + (b - 1) * 32;
          asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n"
                       ::"l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(j0), "r"(ti), "r"(src + b * Cfg::BOX)
                       : "memory");
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      ob ^= 1;
      PHASE(5)
    }
  }
  cp_async_wait<0>();
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
#ifdef HDRTV_SM90_PHASES
  t_phase[0] = clock64() - t_start;
  t_phase[7] = k;
  if (a.phases && tid == 0)
    for (int i = 0; i < 8; ++i) a.phases[blockIdx.x * 8 + i] = t_phase[i];
#endif
#undef PHASE
}

// The fp32 s2d form's input conv (arguments: InConvF32Args, its maps encoded here).
cudaError_t in_conv_tf32x3(InConvF32Args& c, cudaStream_t stream) {
  using Cfg = InConvF32Cfg;
  static DeviceCache cache;
  int resident = 0;
  cudaError_t err = resident_blocks(cache, in_conv_tf32x3_kernel, Cfg::SMEM, &resident, 256);
  if (err == cudaSuccess) err = encode_out_map(&c.fea_map, c.fea, c.H, c.W, 4 * Cfg::CF, true);
  if (err == cudaSuccess) err = encode_out_map(&c.c0_map, c.c0, c.H, c.W, 4 * Cfg::CC, true);
  if (err != cudaSuccess) return err;
  const int tiles = c.H * ((c.W + Cfg::TW - 1) / Cfg::TW);
  in_conv_tf32x3_kernel<<<std::max(1, std::min(tiles, resident)), 256, Cfg::SMEM, stream>>>(c);
  return cudaGetLastError();
}

// agcm_head's s2d form in fp32; the natural widths of the bf16 form, which
// the wrapper checks.
cudaError_t agcm_head_s2d_f32(const AgcmF32Args& g, InConvF32Args& c, cudaStream_t stream) {
  const cudaError_t err = agcm_tf32x3(g, stream);
  return err == cudaSuccess ? in_conv_tf32x3(c, stream) : err;
}

// The arguments of the fp32 s2d form's two launches (the exported function's, below).
void agcm_head_s2d_f32_args(AgcmF32Args& g, InConvF32Args& c, const void* x, int kind, float scale, const void* mods,
                            int mw, const void* w1, const void* b1, const void* w2, const void* b2, const void* w3,
                            const void* b3, const void* w_in, const void* b_in, const int* slots, void* fea, void* c0,
                            void* agcm, int H, int W) {
  g.x = x;
  g.kind = kind;
  g.scale = scale;
  g.mods = static_cast<const float*>(mods);
  g.mw = mw;
  g.w[0] = static_cast<const float*>(w1);
  g.w[1] = static_cast<const float*>(w2);
  g.w[2] = static_cast<const float*>(w3);
  g.b[0] = static_cast<const float*>(b1);
  g.b[1] = static_cast<const float*>(b2);
  g.b[2] = static_cast<const float*>(b3);
  g.y = static_cast<float*>(agcm);
  g.rows = 4LL * H * W;
  g.W = W;
  c.agcm = static_cast<const float*>(agcm);
  c.w = static_cast<const float*>(w_in);
  c.b = static_cast<const float*>(b_in);
  c.fea = static_cast<float*>(fea);
  c.c0 = static_cast<float*>(c0);
  c.H = H;
  c.W = W;
  for (int i = 0; i < 36; ++i) c.slot[i] = slots[i];
}

}  // namespace
}  // namespace hdrtv

// The s2d form in fp32, arguments as hdrtv_agcm_head_s2d_bf16's (kind 0: the
// frame in fp32; every pack and output fp32).
extern "C" int hdrtv_agcm_head_s2d_f32(const void* x, int kind, float scale, const void* mods, int mw,
                                       const void* w1, const void* b1, const void* w2, const void* b2,
                                       const void* w3, const void* b3, const void* w_in, const void* b_in,
                                       const int* slots, void* fea, void* c0, void* agcm, int H, int W,
                                       void* stream) {
  using namespace hdrtv;
  if (kind < kAgcmFrameBf16 || kind > kAgcmFramePairs || mw < 256 || !slots || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  AgcmF32Args g;
  InConvF32Args c;
  agcm_head_s2d_f32_args(g, c, x, kind, scale, mods, mw, w1, b1, w2, b2, w3, b3, w_in, b_in, slots, fea, c0, agcm, H,
                         W);
  return static_cast<int>(agcm_head_s2d_f32(g, c, static_cast<cudaStream_t>(stream)));
}

// The s2d form in bf16. kind as below; w1, w2, w3: the AGCM blocks, padded
// (16, 64), (64, 64), (64, 16); b1, b2, b3 the s2d biases; w_in (4, 32, 96)
// and b_in (4, 96) the input conv gathered per output sub-position; slots:
// 36 entries tap | si << 4, so's 9 at [9·so, 9·so + 9); mods (6, mw ≥ 256).
extern "C" int hdrtv_agcm_head_s2d_bf16(const void* x, int kind, float scale, const void* mods, int mw,
                                        const void* w1, const void* b1, const void* w2, const void* b2,
                                        const void* w3, const void* b3, const void* w_in, const void* b_in,
                                        const int* slots, void* fea, void* c0, void* agcm, int H, int W,
                                        void* stream) {
  using namespace hdrtv;
  if (kind < kAgcmFrameBf16 || kind > kAgcmFramePairs || mw < 256 || !slots || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  AgcmSm90Args g;
  g.x = x;
  g.kind = kind;
  g.scale = scale;
  g.mods = static_cast<const float*>(mods);
  g.mw = mw;
  g.w[0] = static_cast<const bf16*>(w1);
  g.w[1] = static_cast<const bf16*>(w2);
  g.w[2] = static_cast<const bf16*>(w3);
  g.b[0] = static_cast<const float*>(b1);
  g.b[1] = static_cast<const float*>(b2);
  g.b[2] = static_cast<const float*>(b3);
  g.y = static_cast<bf16*>(agcm);
  g.rows = 4LL * H * W;
  g.W = W;
  InConvSm90Args c;
  c.agcm = static_cast<const bf16*>(agcm);
  c.w = static_cast<const bf16*>(w_in);
  c.b = static_cast<const float*>(b_in);
  c.fea = static_cast<bf16*>(fea);
  c.c0 = static_cast<bf16*>(c0);
  c.H = H;
  c.W = W;
  for (int i = 0; i < 36; ++i) c.slot[i] = slots[i];
  return static_cast<int>(agcm_head_s2d(g, c, static_cast<cudaStream_t>(stream)));
}

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
