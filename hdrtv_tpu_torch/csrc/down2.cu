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
#include "conv3x3.cuh"

namespace {

template <typename T>
int down2(const void* x, const void* w, const void* b, void* y, int H, int W, int cf, int ch0,
          int cin, int Co, int act, void* stream) {
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
  return static_cast<int>(
      hdrtv::launch_conv3x3<T, T, T, 2>(a, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" int hdrtv_down2_f32(const void* x, const void* w, const void* b, void* y, int H,
                               int W, int cf, int ch0, int cin, int Co, int act,
                               void* stream) {
  return down2<float>(x, w, b, y, H, W, cf, ch0, cin, Co, act, stream);
}

extern "C" int hdrtv_down2_bf16(const void* x, const void* w, const void* b, void* y, int H,
                                int W, int cf, int ch0, int cin, int Co, int act,
                                void* stream) {
  return down2<hdrtv::bf16>(x, w, b, y, H, W, cf, ch0, cin, Co, act, stream);
}
