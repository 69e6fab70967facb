// down2 — replaces the Pallas kernel fused_down2
// (hdrtv_tpu/ops/megakernel.py:706): the s2d-domain stride-2 3×3 conv with
// (1,0) padding, (Hb, Wb, C) → (Hb/2, Wb/2, Co), fused bias and activation
// (none, relu or lrelu 0.1), reading the channel window [ch0, ch0 + cin) of
// a wider input in place.
//
// Bound on this card: operations. At 1080p the consolidated CondNet down
// conv is 459 GFLOP dense over 0.5 GB in and 0.4 GB out; fp32 FMA throughput
// is the limit. Design: the implicit-GEMM tile of conv3x3.cuh with stride 2;
// the window is an offset and a row pitch in the A-tile address, so the
// slice the TPU kernel keeps out of HBM with its BlockSpecs never exists
// here either. The product is dense: right for any weight, where the TPU
// kernel relies on w_s2d_s2's structural zeros to skip a third of its taps.
// The bf16 instance runs the tile on the tensor cores (conv3x3_mma_kernel).
//
// The native-int8 (W8A8) body of the same Pallas kernel (`quant`,
// megakernel.py:608-705; the wrapper counts it as down2_w8a8), when the call
// passes the layer's QuantParams, one per branch: the window is quantized
// per tensor (a quantize pass over the window, in place, into scratch the
// wrapper allocates: one code plane per branch, since the consolidated
// CondNet down conv quantizes its shared input once per branch with that
// branch's scale and zero point), then the int8 tile of conv3x3_s8.cuh with
// stride 2, whose output channel block bi reads branch bi's codes and
// parameters and whose out-of-image taps (global row −1, column −1) carry
// that branch's pad code, as the TPU body quantizes its zeroed halo row and
// pads its shifted column view with the code of 0. Epilogue: float(acc) ·
// yscale, + bias (the zero-point term folded in), as two rounded ops, then
// the activation. Bound on this card: bytes (at 1080p the consolidated conv
// needs 114 GOP of non-zero int8 products, 0.06 ms at 1979 TOPS, against
// 0.27 GB in and 0.2 GB out in bf16); the codes' round trip through device
// memory, 1 byte a value per branch, is this first version's cost.
#include "conv3x3_s8.cuh"

namespace {

template <typename T>
int down2(const void* x, const void* w, const void* b, const hdrtv::QuantParams* q, int nb, void* y,
          void* codes, int H, int W, int cf, int ch0, int cin, int Co, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q) {
    if (nb < 1 || nb > hdrtv::kMaxBranches || Co % nb) return static_cast<int>(cudaErrorInvalidValue);
    hdrtv::ConvS8Args a;
    a.q = static_cast<const int8_t*>(codes);
    a.qstride = static_cast<long long>(H) * W * cin;
    a.nb = nb;
    a.m = Co / nb;
    for (int bi = 0; bi < nb; ++bi) {
      a.p[bi] = q[bi];
      const cudaError_t err = hdrtv::quantize_window<T>(
          x, static_cast<int8_t*>(codes) + bi * a.qstride, static_cast<long long>(H) * W, cf, ch0, cin, q[bi], s);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    a.skip = nullptr;
    a.y = y;
    a.H = H;
    a.W = W;
    a.Ho = H / 2;
    a.Wo = W / 2;
    a.C = cin;
    a.Co = Co;
    a.act = act;
    a.pool = 0;
    return static_cast<int>(hdrtv::launch_conv_s8<T, 2>(a, s));
  }
  hdrtv::ConvArgs a;
  a.x = x;
  a.w = w;
  a.b = static_cast<const float*>(b);
  a.skip = nullptr;
  a.skip2 = nullptr;
  a.y = y;
  a.H = H;
  a.W = W;
  a.Ho = H / 2;
  a.Wo = W / 2;
  a.cf = cf;
  a.ch0 = ch0;
  a.C = cin;
  a.Co = Co;
  a.act = act;
  return static_cast<int>(hdrtv::launch_conv3x3<T, T, T, 2>(a, s));
}

}  // namespace

// q: null for the float form, else an array of nb QuantParams, branch bi's
// layer for output channels [bi·Co/nb, (bi+1)·Co/nb) (w and b unused;
// codes: nb·H·W·cin bytes of scratch, unused without q).
extern "C" int hdrtv_down2_f32(const void* x, const void* w, const void* b, const void* q, int nb,
                               void* y, void* codes, int H, int W, int cf, int ch0, int cin, int Co,
                               int act, void* stream) {
  return down2<float>(x, w, b, hdrtv::quant_params(q), nb, y, codes, H, W, cf, ch0, cin, Co, act, stream);
}

extern "C" int hdrtv_down2_bf16(const void* x, const void* w, const void* b, const void* q, int nb,
                                void* y, void* codes, int H, int W, int cf, int ch0, int cin, int Co,
                                int act, void* stream) {
  return down2<hdrtv::bf16>(x, w, b, hdrtv::quant_params(q), nb, y, codes, H, W, cf, ch0, cin, Co, act,
                            stream);
}
