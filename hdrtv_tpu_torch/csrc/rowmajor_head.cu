// rowmajor_head — replaces the two Pallas probe kernels of
// tools/proto_rowmajor_head.py, _kernel_raw (:35, pallas_call :66) and
// _kernel_pre (:45, pallas_call :77): the AGCM first conv's shape on raw
// frame bytes. Per output pixel (r, x) of a (Hb, Wb) grid, the twelve inputs
// are row 2r's six bytes at 6x..6x+5, then row 2r+1's six (the probe's
// concatenate of the two row parities);
//
//   v_k = bf16(f32(u8_k) · f32(1/255))            (a multiply, not a division)
//   out[r, x, n] = bf16(Σ_k f32(v_k) · f32(w[k, n]))   k = 0..11, fp32 sum
//
// with w (12, Co) bf16 and Co a multiple of 8; no BGR flip (the probe has
// none). One kernel body serves both Pallas calls through two launchers: raw
// reads (H, 3W) byte rows, pre reads (Hb, 2, Wb, 6) row-pair planes. On this
// card the two are the same bytes in the same order (row 2r + a, byte 6x + m
// sits at (2r + a)·6Wb + 6x + m in both), so the launchers differ only in how
// they read the shape; on the TPU the pre form needed XLA to materialise a
// lane-padded copy first, which is what the probe timed.
//
// Bound on this card: bytes, and almost all of them stores. A 1080p frame
// reads 6.2 MB of u8 and writes 265 MB of bf16 (540 × 960 × 256), ≈ 0.08 ms
// at 3.35 TB/s; its 12 × 256 MACs per pixel are 3.2 GFLOP, ≈ 0.05 ms of the
// FMA units. K = 12 is below one mma.sync k-step of 16 and the tensor cores
// would idle behind the store stream, so the design is a plain FMA loop: each
// thread keeps its eight output channels' 12 × 8 weights in registers and
// writes those eight channels of a pixel as one 16-byte store; a warp covers
// 32 × 8 = 256 channels, so a pixel's row of Co = 256 outputs is one 512-byte
// store. A block takes a tile of HEAD_TILE pixels of one row pair: its threads
// first turn the tile's bytes into the twelve bf16-rounded values per pixel
// in shared memory, then each warp runs the products of its pixels from
// there: a warp that read its pixel's bytes from device memory itself would
// wait on those loads before every pixel's products (0.2425 ms at 1080p
// against 0.151 with the tile, on the H100).
#include "common.cuh"

namespace hdrtv {
namespace {

constexpr int HEAD_K = 12;
constexpr int HEAD_TILE = 64;

__global__ void __launch_bounds__(256, 2)
    rowmajor_head_kernel(const uint8_t* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out,
                         int hb, int wb, int co, long long row_stride) {
  __shared__ __align__(16) float vs[HEAD_TILE][HEAD_K];
  const int c8 = threadIdx.x * 8;
  float wr[HEAD_K][8];
#pragma unroll
  for (int k = 0; k < HEAD_K; ++k) {
#pragma unroll
    for (int j = 0; j < 8; ++j) wr[k][j] = __bfloat162float(w[k * co + c8 + j]);
  }
  const float inv255 = 1.0f / 255.0f;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int tiles_per_row = (wb + HEAD_TILE - 1) / HEAD_TILE;
  const long long ntiles = static_cast<long long>(hb) * tiles_per_row;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long r = tile / tiles_per_row;
    const int x0 = static_cast<int>(tile - r * tiles_per_row) * HEAD_TILE;
    const int np = min(HEAD_TILE, wb - x0);
    // Stage: value k of pixel p is byte 6(x0 + p) + k % 6 of row 2r + k / 6.
    const uint8_t* rows = x + 2 * r * row_stride + 6LL * x0;
    for (int i = tid; i < np * HEAD_K; i += nthreads) {
      const int p = i / HEAD_K, k = i - p * HEAD_K;
      const int a = k >= 6;
      vs[p][k] = round_to<bf16>(__fmul_rn(static_cast<float>(rows[a * row_stride + 6 * p + k - 6 * a]), inv255));
    }
    __syncthreads();
    for (int p = threadIdx.y; p < np; p += blockDim.y) {
      float v[HEAD_K];
#pragma unroll
      for (int q = 0; q < HEAD_K / 4; ++q) {
        const float4 f = *reinterpret_cast<const float4*>(&vs[p][4 * q]);
        v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z, v[4 * q + 3] = f.w;
      }
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
      // bf16 × bf16 products are exact in fp32: each FMA rounds only the sum.
#pragma unroll
      for (int k = 0; k < HEAD_K; ++k) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = __fmaf_rn(v[k], wr[k][j], acc[j]);
      }
      uint4 o;
      unsigned* uo = reinterpret_cast<unsigned*>(&o);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 pr = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
        uo[j] = *reinterpret_cast<const unsigned*>(&pr);
      }
      *reinterpret_cast<uint4*>(out + (r * wb + x0 + p) * co + c8) = o;
    }
    __syncthreads();
  }
}

int launch_rowmajor_head(const void* x, const void* w, void* out, int hb, int wb, int co, void* stream) {
  if (hb <= 0 || wb <= 0 || co <= 0 || co % 8 || co / 8 > 256) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = co / 8;
  const dim3 block(groups, 256 / groups);  // about 256 threads: pixel rows of a tile in y
  const long long ntiles = static_cast<long long>(hb) * ((wb + HEAD_TILE - 1) / HEAD_TILE);
  const int blocks = static_cast<int>(ntiles < 132LL * 8 ? ntiles : 132LL * 8);  // then grid-stride
  rowmajor_head_kernel<<<blocks, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(out), hb, wb, co,
      6LL * wb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hdrtv

// raw: x (h, w3) u8 byte rows, h even, w3 = 3·W with W even; out (h/2, w3/6, co) bf16.
extern "C" int hdrtv_rowmajor_head_raw_bf16(const void* x, const void* w, void* out, int h, int w3, int co,
                                            void* stream) {
  if (h % 2 || w3 % 6) return static_cast<int>(cudaErrorInvalidValue);
  return hdrtv::launch_rowmajor_head(x, w, out, h / 2, w3 / 6, co, stream);
}

// pre: x (hb, 2, wb, 6) u8 row-pair planes; out (hb, wb, co) bf16.
extern "C" int hdrtv_rowmajor_head_pre_bf16(const void* x, const void* w, void* out, int hb, int wb, int co,
                                            void* stream) {
  return hdrtv::launch_rowmajor_head(x, w, out, hb, wb, co, stream);
}
