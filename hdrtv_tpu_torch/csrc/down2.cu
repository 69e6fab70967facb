// down2 — replaces the Pallas kernel fused_down2
// (hdrtv_tpu/ops/megakernel.py:706): the s2d-domain stride-2 3×3 conv with
// (1,0) padding, (Hb, Wb, C) → (Hb/2, Wb/2, Co), fused bias and activation
// (none, relu or lrelu 0.1), reading the channel window [ch0, ch0 + cin) of
// a wider input in place.
//
// The bf16 float form, the one every bf16 frame program launches five times
// (the consolidated CondNet down conv, CondNet3.2/4.2 on its output's
// windows, down_conv1/2), runs the Hopper tile of conv3x3_sm90.cuh with
// stride 2: its TMA boxes read every second input pixel, fill the (1,0)
// pad's row and column −1 with zeros and take the window at their channel
// coordinate, so the slice never exists in device memory. a_sub (conv_s2
// passes 3 for the consolidated conv, 1 elsewhere) declares the weight
// w_s2d_s2-structured, as the Pallas kernel requires, and the tile walks
// each output sub-position's 9 non-zero (tap, input sub-position) slots
// only; a_sub = 0 is the dense product, right for any weight. Bound on this
// card: bytes at every 1080p shape (the consolidated conv: 115 GFLOP of
// non-zero products, 0.116 ms at the bf16 rate, against 0.27 GB in and
// 0.20 GB out, 0.139 ms); its epilogue's stores hold it back
// (tools/sm90_phases.py).
// Times: PERF.md §6.
//
// The fp32 float form with a_sub ≥ 1 (the fp32 programs' five calls) runs
// the 3×TF32 sibling of that tile (conv3x3_tf32x3.cuh): the same table and
// TMA boxes in fp32, products split into big·big + small·big + big·small on
// the tensor cores. Bound on this card: operations (146 GFLOP of non-zero
// products a 1080p frame, ×3 at the 494.7 TFLOP/s TF32 rate, 0.89 ms). The
// dense fp32 product (a_sub = 0) runs the implicit-GEMM FMA tile of
// conv3x3.cuh with stride 2.
//
// The native-int8 (W8A8) body of the same Pallas kernel (`quant`,
// megakernel.py:608-705; the wrapper counts it as down2_w8a8), when the call
// passes the layer's QuantParams, one per branch (the consolidated CondNet
// down conv quantizes its shared input once per branch with that branch's
// scale and zero point; one branch is the plain layer). The window is
// quantized per tensor into scratch the wrapper allocates, one code plane
// per branch; output channel block bi reads branch bi's codes and
// parameters, and out-of-image taps (global row −1, column −1) carry that
// branch's pad code, as the TPU body quantizes its zeroed halo row and pads
// its shifted column view with the code of 0. Epilogue: float(acc) ·
// yscale, + bias (the zero-point term folded in), as two rounded ops, then
// the activation, one rounding.
//
// bf16 with a_sub ≥ 1 (conv_s2 passes 3 for the consolidated conv, 1 for
// CondNet3.2/4.2 on its output's windows; the HDRTV_INT8_DOWN2=1 programs'
// three calls, C = 256): one quantize pass (conv3x3_s8.cuh quantize_planes)
// reads the window once and writes every branch's plane, then the wgmma s8
// tile of conv3x3_s8_sm90.cuh at stride 2 walks the slot table of
// s2d_slots(2) (18 chunks of each output sub-position's 72), N tiles of 64
// channels, one sub-position of one branch each, stored by TMA. Another
// width with a_sub ≥ 1 is refused (the wrapper raises first). Bound on this
// card: bytes. At 1080p the consolidated conv reads 265 MB of bf16 and
// writes 199 MB (0.139 ms at 3.35 TB/s; 115 GOP of non-zero int8 products,
// 0.058 ms at 1979 TOPS); this two-pass design also writes and reads the
// three code planes, 398 MB each way: 1.26 GB, 0.376 ms, and 0.15 GB for
// each window call. Quantizing on load inside the tile, which saves the
// planes' round trip, is later work. a_sub = 0, and the fp32 instance:
// one quantize_window pass per branch, then the dense mma.sync int8 tile of
// conv3x3_s8.cuh with stride 2, whose out-of-image taps carry the branch's
// pad code. Times: PERF.md §6.
#include "conv3x3_s8.cuh"
#include "conv3x3_s8_sm90.cuh"
#include "conv3x3_tf32x3.cuh"

namespace {

template <typename T>
int down2(const void* x, const void* w, const void* b, const hdrtv::QuantParams* q, int nb, void* y,
          void* codes, int H, int W, int cf, int ch0, int cin, int Co, int act, int a_sub, const int* table,
          int per_list, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table && q) {
    if constexpr (std::is_same<T, hdrtv::bf16>::value) {
      const long long npix = static_cast<long long>(H) * W;
      cudaError_t err = hdrtv::quantize_planes(x, codes, npix, cf, ch0, cin, q, nb, s);
      if (err == cudaSuccess)
        err = hdrtv::conv3x3_s8_sm90_s2(codes, npix * cin, q, nb, y, H, W, cin, Co, a_sub, act, table, per_list, s);
      return static_cast<int>(err);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (table) {
    if constexpr (std::is_same<T, hdrtv::bf16>::value)
      return static_cast<int>(hdrtv::conv3x3_sm90<2>(x, w, static_cast<const float*>(b), nullptr, y, H, W, cf,
                                                     ch0, cin, Co, act, a_sub, table, per_list, s));
    else
      return static_cast<int>(hdrtv::conv3x3_tf32x3<2>(x, w, static_cast<const float*>(b), nullptr, y, H, W, cf,
                                                       ch0, cin, Co, act, a_sub, table, per_list, s));
  }
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
// codes: nb·H·W·cin bytes of scratch, unused without q). table: null, or
// the chunk lists of s2d_slots(2) for a_sub, per_list entries each, which
// send the float form to the Hopper tile (bf16) or its 3×TF32 sibling
// (fp32), and the int8 form (bf16) to the quantize pass and the wgmma s8
// tile.
extern "C" int hdrtv_down2_f32(const void* x, const void* w, const void* b, const void* q, int nb,
                               void* y, void* codes, int H, int W, int cf, int ch0, int cin, int Co,
                               int act, int a_sub, const int* table, int per_list, void* stream) {
  return down2<float>(x, w, b, hdrtv::quant_params(q), nb, y, codes, H, W, cf, ch0, cin, Co, act, a_sub,
                      table, per_list, stream);
}

extern "C" int hdrtv_down2_bf16(const void* x, const void* w, const void* b, const void* q, int nb,
                                void* y, void* codes, int H, int W, int cf, int ch0, int cin, int Co,
                                int act, int a_sub, const int* table, int per_list, void* stream) {
  return down2<hdrtv::bf16>(x, w, b, hdrtv::quant_params(q), nb, y, codes, H, W, cf, ch0, cin, Co, act,
                            a_sub, table, per_list, stream);
}
