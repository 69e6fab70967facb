// trunk3 — replaces the Pallas kernel fused_trunk3
// (hdrtv_tpu/ops/megakernel.py:1161): the natural-layout /8 stage of the LE
// UNet. Four SFT resblocks
//     t = sft1(x, cond); h = relu(conv1(t)); t = sft2(h, cond);
//     x = x + conv2(t)
// then the stage skip out = x + fea3 and relu(up_conv1(out)), over
// fea3 (H, W, 32), cond (H, W, 16) → (H, W, Co). The SFT of one branch is
// conv1(lrelu(conv0(cond))) with 1×1 convs (16→16→32); t = x·(scale+1)+shift.
// 'same' padding applies to the SFT output that feeds each conv: the conv's
// out-of-image taps read zero, as the TPU kernel's row mask makes them.
//
// Bound on this card: operations, but the stage is small: at 1080p
// (135×240) it is ~7 GFLOP and every intermediate is 2.1 MB in bf16, so the
// whole chain lives in the 50 MB L2. Design: one host call launches a fixed
// sequence of 17 kernels (8 SFT passes, 9 convs) through three scratch
// buffers, instead of one launch with a 9-conv halo that would not fit
// shared memory at 240 columns × 32 channels. The residual add and the stage
// skip ride in the conv epilogue; the running x is updated in place.
//
// fp32: the same 17 stages, weights from the fp32 parameter block:
//   - the 8 SFT passes on sft_rows_f32_kernel (below): lanes over channels,
//     so that a warp loads and stores whole 128-byte rows of x and t; rows of
//     x and cond staged through shared memory by cp.async, two tiles of 64
//     pixels in flight a block; the 16 → 16 → 32 1×1s on the FMA units in
//     fp32, each lane's weight columns in registers (staged through shared
//     memory once a block), cond and the hidden row read from shared memory
//     as broadcasts;
//   - the 9 convs on the 3×TF32 tile of conv3x3_tf32x3.cuh, dense (a_sub =
//     0, the one 9-chunk list of a 32-channel conv that trunk3 asks
//     sm90_table for), per-chunk sums in fp32: conv1 BN = 32 with ReLU,
//     conv2 BN = 32 through the skip epilogue, the fourth through the
//     two-skip one (x + conv2(t), then + fea3), up_conv1 BN = 64 with ReLU;
//     TMA zero-fills t outside the image and the masked stores hold the
//     edges (135 rows are not a multiple of the tile's 2, 240 columns not
//     of 64).
//   Bound: operations, 7.1 GFLOP of convs at a third of the TF32 rate plus
//   0.8 of SFT at the FMA rate, ≈ 0.055 ms at 1080p; 17 launches of a few µs.
//
// bf16: the same 17 stages on the Hopper tiles, weights from the bf16 pack:
//   - the 8 SFT passes on chain_sm90.cuh's row tile (sft_sm90_natural): the
//     H·W natural rows of x (the running x, or h) and cond against the
//     natural 1×1 weights, resident, on wgmma; t written once;
//   - the 9 convs on conv3x3_sm90.cuh's tile, dense (a_sub = 0: C = 32 is
//     one 9-chunk list, the table the wrapper passes), weights resident, TMA
//     zero-filling t outside the image (135 rows are not a multiple of the
//     tile's 4: the masked stores hold the edge): conv1 BN = 32 with ReLU;
//     conv2 BN = 32 through the skip epilogue (x + conv2(t)), the fourth one
//     through the two-skip epilogue (x + conv2(t) rounded, then + fea3 and
//     rounded again, as _trunk3_kernel stores x before the stage skip);
//     up_conv1 BN = 128 with ReLU.
// What holds it then: 17 launches of a few µs each.
//
// Rounding points as in _trunk3_kernel: the SFT's hidden activations, t, h,
// the running x after each resblock, and the stage-skip sum before up_conv1
// are each stored in T; sums are fp32.
//
// Parameter block (fp32, packed by ops/megakernel.py trunk3_pack), for each
// of the 4 resblocks: sft1, conv1 w (3,3,C,C), conv1 b (C), sft2, conv2 w,
// conv2 b; then up_conv1 w (3,3,C,Co) and b (Co). An sft is
//     w0s (CC,CC) b0s (CC) w1s (CC,C) b1s (C) w0h (CC,CC) b0h (CC) w1h (CC,C) b1h (C)
// (the scale branch, then the shift branch; 1×1 weights as (in, out)). The
// bf16 pack (trunk3_pack_bf16) is the same order split in two: the weights
// in bf16, the biases in fp32.
#include "chain_sm90.cuh"
#include "conv3x3_tf32x3.cuh"

namespace hdrtv {
namespace {

constexpr int kCC = 16;  // cond channels
constexpr int kC = 32;   // trunk channels

__host__ __device__ constexpr long long sft_floats(int cc, int c) { return 2LL * (cc * cc + cc + cc * c + c); }
__host__ __device__ constexpr long long conv_floats(int c, int co) { return 9LL * c * co + co; }

// The fp32 SFT pass, one tile of kSftTP pixels at a time, persistent
// blocks. Lane l holds, of the hidden layer, branch l / 16's unit l % 16
// (its conv0 column and bias), and of the output, channel l (both branches'
// conv1 columns and biases): 51 weights in registers. Per pixel the lane
// sums its hidden unit over the 16 cond values (read as broadcasts from the
// staged row), lrelu, stores it to the warp's hidden row; after the warp
// meets, sums scale and shift over the 16 hidden units of each branch (read
// as broadcasts) and writes t = x·(scale + 1) + shift, x from the staged
// row: one 128-byte store a pixel and warp. fp32 sums in the order of the
// other instances' passes.
constexpr int kSftTP = 64;       // pixels of a tile
constexpr int kSftThreads = 256;  // 8 warps, kSftTP / 8 pixels each

template <int CC, int C>
struct SftRowsSmem {
  float x[2][kSftTP * C];
  float cond[2][kSftTP * CC];
  float hid[kSftThreads / 32][kSftTP / (kSftThreads / 32)][2 * CC];
  float prm[2 * (CC * CC + CC + CC * C + C)];
};

template <int CC, int C>
__global__ void __launch_bounds__(kSftThreads) sft_rows_f32_kernel(const float* __restrict__ x,
                                                                   const float* __restrict__ cond,
                                                                   const float* __restrict__ prm,
                                                                   float* __restrict__ t, int npix) {
  static_assert(C == 32 && 2 * CC == 32, "a lane per channel and per hidden unit");
  using Smem = SftRowsSmem<CC, C>;
  constexpr int kN = static_cast<int>(sft_floats(CC, C)), kBranch = CC * CC + CC + CC * C + C;
  constexpr int PW = kSftTP / (kSftThreads / 32);  // pixels of a warp in a tile
  extern __shared__ __align__(16) unsigned char sft_smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(sft_smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = (npix + kSftTP - 1) / kSftTP;

  // A tile's rows into stage st: x (kSftTP·C floats) and cond (kSftTP·CC),
  // 16 bytes a copy, pixels past the end zero-filled.
  auto load = [&](int tile, int st) {
    const long long p0 = static_cast<long long>(tile) * kSftTP;
    for (int i = tid; i < kSftTP * C / 4; i += kSftThreads) {
      const long long p = p0 + i / (C / 4);
      cp_async16_or_zero(&sm.x[st][i * 4], x + (p < npix ? p0 * C + i * 4 : 0), p < npix);
    }
    for (int i = tid; i < kSftTP * CC / 4; i += kSftThreads) {
      const long long p = p0 + i / (CC / 4);
      cp_async16_or_zero(&sm.cond[st][i * 4], cond + (p < npix ? p0 * CC + i * 4 : 0), p < npix);
    }
    cp_async_commit();
  };
  int tile = blockIdx.x;
  if (tile < tiles) load(tile, 0);
  for (int i = tid; i < kN; i += kSftThreads) sm.prm[i] = prm[i];
  __syncthreads();
  const int br = lane / CC, j = lane % CC;
  float w0[CC], w1s[CC], w1h[CC];
  const float* p0w = sm.prm + br * kBranch;
#pragma unroll
  for (int i = 0; i < CC; ++i) w0[i] = p0w[i * CC + j];
  const float b0 = p0w[CC * CC + j];
  const float* w1s_ = sm.prm + CC * CC + CC;
  const float* w1h_ = sm.prm + kBranch + CC * CC + CC;
#pragma unroll
  for (int i = 0; i < CC; ++i) {
    w1s[i] = w1s_[i * C + lane];
    w1h[i] = w1h_[i * C + lane];
  }
  const float b1s = w1s_[CC * C + lane], b1h = w1h_[CC * C + lane];

  for (int st = 0; tile < tiles; tile += gridDim.x, st ^= 1) {
    const int next = tile + gridDim.x;
    if (next < tiles) {
      load(next, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const long long p0 = static_cast<long long>(tile) * kSftTP + warp * PW;
    const float* xs = sm.x[st] + warp * PW * C;
    const float* cs = sm.cond[st] + warp * PW * CC;
    float(&hid)[PW][2 * CC] = sm.hid[warp];
#pragma unroll
    for (int p = 0; p < PW; ++p) {
      float v = b0;
#pragma unroll
      for (int i4 = 0; i4 < CC / 4; ++i4) {
        const float4 c4 = *reinterpret_cast<const float4*>(cs + p * CC + 4 * i4);
        v = fmaf(c4.x, w0[4 * i4], v);
        v = fmaf(c4.y, w0[4 * i4 + 1], v);
        v = fmaf(c4.z, w0[4 * i4 + 2], v);
        v = fmaf(c4.w, w0[4 * i4 + 3], v);
      }
      hid[p][lane] = v >= 0.f ? v : v * 0.1f;
    }
    __syncwarp();
#pragma unroll
    for (int p = 0; p < PW; ++p) {
      float scale = b1s, shift = b1h;
#pragma unroll
      for (int i4 = 0; i4 < CC / 4; ++i4) {
        const float4 s4 = *reinterpret_cast<const float4*>(&hid[p][4 * i4]);
        const float4 h4 = *reinterpret_cast<const float4*>(&hid[p][CC + 4 * i4]);
        scale = fmaf(s4.x, w1s[4 * i4], scale);
        shift = fmaf(h4.x, w1h[4 * i4], shift);
        scale = fmaf(s4.y, w1s[4 * i4 + 1], scale);
        shift = fmaf(h4.y, w1h[4 * i4 + 1], shift);
        scale = fmaf(s4.z, w1s[4 * i4 + 2], scale);
        shift = fmaf(h4.z, w1h[4 * i4 + 2], shift);
        scale = fmaf(s4.w, w1s[4 * i4 + 3], scale);
        shift = fmaf(h4.w, w1h[4 * i4 + 3], shift);
      }
      if (p0 + p < npix) t[(p0 + p) * C + lane] = xs[p * C + lane] * (scale + 1.f) + shift;
    }
    // everyone is done with this stage (and the warp with its hidden rows)
    // before the next iteration's load refills it
    __syncthreads();
  }
}

cudaError_t launch_sft_rows(const float* x, const float* cond, const float* prm, float* t, int npix,
                            cudaStream_t stream) {
  auto kernel = sft_rows_f32_kernel<kCC, kC>;
  constexpr int smem = static_cast<int>(sizeof(SftRowsSmem<kCC, kC>));
  static DeviceCache cache;
  int resident = 0;
  const cudaError_t err = resident_blocks(cache, kernel, smem, &resident, kSftThreads);
  if (err != cudaSuccess) return err;
  const int tiles = (npix + kSftTP - 1) / kSftTP;
  kernel<<<std::max(1, std::min(tiles, resident)), kSftThreads, smem, stream>>>(x, cond, prm, t, npix);
  return cudaGetLastError();
}

// The fp32 form: weights and biases from trunk3_pack's block; table: the
// dense 9-chunk list (per_list 9) of a 32-channel conv, as sm90_table gives
// it for trunk3; scratch: 3 · H · W · C floats (t, h and the running x).
int trunk3_f32(const void* fea3, const void* cond, const void* params, void* y, void* scratch, int H, int W,
               int C, int CC, int Co, const int* table, int per_list, void* stream) {
  if (C != kC || CC != kCC || !table) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int npix = H * W;
  const float* f = static_cast<const float*>(fea3);
  const float* c = static_cast<const float*>(cond);
  const float* prm = static_cast<const float*>(params);
  float* t = static_cast<float*>(scratch);
  float* h = t + static_cast<long long>(npix) * C;
  float* xr = h + static_cast<long long>(npix) * C;
  const long long sft_n = sft_floats(CC, C);
  const long long conv_n = conv_floats(C, C);
  auto conv = [&](const float* x, const float* w, const float* skip, const float* skip2, float* out, int co,
                  int act) {
    return conv3x3_tf32x3<1>(x, w, w + 9LL * C * co, skip, out, H, W, C, 0, C, co, act, 0, table, per_list, s,
                             nullptr, skip2);
  };

  const float* xin = f;
  cudaError_t err = cudaSuccess;
  for (int blk = 0; blk < 4 && err == cudaSuccess; ++blk) {
    const float* sft1 = prm;
    const float* conv1 = sft1 + sft_n;
    const float* sft2 = conv1 + conv_n;
    const float* conv2 = sft2 + sft_n;
    prm = conv2 + conv_n;
    err = launch_sft_rows(xin, c, sft1, t, npix, s);
    if (err == cudaSuccess) err = conv(t, conv1, nullptr, nullptr, h, C, ACT_RELU);
    if (err == cudaSuccess) err = launch_sft_rows(h, c, sft2, t, npix, s);
    // x = x + conv2(t); the last block also adds the stage skip fea3.
    if (err == cudaSuccess) err = conv(t, conv2, xin, blk == 3 ? f : nullptr, xr, C, ACT_NONE);
    xin = xr;
  }
  if (err == cudaSuccess) err = conv(xr, prm, nullptr, nullptr, static_cast<float*>(y), Co, ACT_RELU);
  return static_cast<int>(err);
}

// The bf16 form on the Hopper tiles: weights (bf16) and biases (fp32) in
// trunk3_pack's order; table: the dense 9-chunk list (per_list 9) of a
// 32-channel conv; scratch as above.
int trunk3_sm90(const void* fea3, const void* cond, const void* weights, const void* biases, void* y,
                void* scratch, int H, int W, int C, int CC, int Co, const int* table, int per_list,
                void* stream) {
  if (C != kC || CC != kCC || !table || !biases) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long npix = static_cast<long long>(H) * W;
  const bf16* f = static_cast<const bf16*>(fea3);
  const bf16* wp = static_cast<const bf16*>(weights);
  const float* bp = static_cast<const float*>(biases);
  bf16* t = static_cast<bf16*>(scratch);
  bf16* h = t + npix * C;
  bf16* xr = h + npix * C;
  // the next SFT's eight pointers, w and b of scale0, scale1, shift0, shift1
  auto sft = [&](const void* (&p)[8]) {
    const int wn[4] = {CC * CC, CC * C, CC * CC, CC * C}, bn[4] = {CC, C, CC, C};
    for (int i = 0; i < 4; ++i) {
      p[2 * i] = wp;
      p[2 * i + 1] = bp;
      wp += wn[i];
      bp += bn[i];
    }
  };
  auto conv = [&](const bf16* x, const void* skip, const void* skip2, bf16* out, int co, int act) {
    const bf16* w = wp;
    const float* b = bp;
    wp += 9LL * C * co;
    bp += co;
    return conv3x3_sm90<1>(x, w, b, skip, out, H, W, C, 0, C, co, act, 0, table, per_list, s, nullptr, false, skip2);
  };

  const bf16* xin = f;
  cudaError_t err = cudaSuccess;
  for (int blk = 0; blk < 4 && err == cudaSuccess; ++blk) {
    const void* p1[8];
    const void* p2[8];
    sft(p1);
    err = sft_sm90_natural(xin, cond, t, p1, npix, C, CC, s);
    if (err == cudaSuccess) err = conv(t, nullptr, nullptr, h, C, ACT_RELU);
    sft(p2);
    if (err == cudaSuccess) err = sft_sm90_natural(h, cond, t, p2, npix, C, CC, s);
    // x = x + conv2(t); the last block also adds the stage skip fea3, rounding twice
    if (err == cudaSuccess) err = conv(t, xin, blk == 3 ? f : nullptr, xr, C, ACT_NONE);
    xin = xr;
  }
  if (err == cudaSuccess) err = conv(xr, nullptr, nullptr, static_cast<bf16*>(y), Co, ACT_RELU);
  return static_cast<int>(err);
}

}  // namespace
}  // namespace hdrtv

// Floats in the packed parameter block for (C, CC, Co); 0 when this build
// has no instance for those widths.
extern "C" long long hdrtv_trunk3_param_floats(int C, int CC, int Co) {
  if (C != hdrtv::kC || CC != hdrtv::kCC) return 0;
  return 4 * (2 * hdrtv::sft_floats(CC, C) + 2 * hdrtv::conv_floats(C, C)) +
         hdrtv::conv_floats(C, Co);
}

// params: fp32, the parameter block (biases unused); bf16, the pack's
// weights, with its biases. table, per_list: the conv tiles' dense 9-chunk
// list.
extern "C" int hdrtv_trunk3_f32(const void* fea3, const void* cond, const void* params, const void* biases,
                                void* y, void* scratch, int H, int W, int C, int CC, int Co,
                                const int* table, int per_list, void* stream) {
  return hdrtv::trunk3_f32(fea3, cond, params, y, scratch, H, W, C, CC, Co, table, per_list, stream);
}

extern "C" int hdrtv_trunk3_bf16(const void* fea3, const void* cond, const void* params, const void* biases,
                                 void* y, void* scratch, int H, int W, int C, int CC, int Co,
                                 const int* table, int per_list, void* stream) {
  return hdrtv::trunk3_sm90(fea3, cond, params, biases, y, scratch, H, W, C, CC, Co, table, per_list,
                            stream);
}
