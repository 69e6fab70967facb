// agcm_head's AGCM row tile (csrc/chain_sm90.cuh agcm_sm90) built with its
// phase timers (HDRTV_SM90_PHASES), for tools/sm90_phases.py, which links it
// beside sm90_phases.cu; not part of the kernel library. AgcmSm90Args'
// arguments and the (2·blocks, 8) u64 array the kernel fills. Below, the
// fp32 s2d form's two tiles likewise.
#define HDRTV_SM90_PHASES
#include "../csrc/chain_sm90.cuh"

extern "C" int hdrtv_sm90_agcm_phases(const void* x, int kind, float scale, const void* mods, int mw, const void* w1,
                                      const void* b1, const void* w2, const void* b2, const void* w3, const void* b3,
                                      void* y, int H, int W, void* phases, void* stream) {
  hdrtv::AgcmSm90Args a;
  a.x = x;
  a.kind = kind;
  a.scale = scale;
  a.mods = static_cast<const float*>(mods);
  a.mw = mw;
  const void* w[3] = {w1, w2, w3};
  const void* b[3] = {b1, b2, b3};
  for (int i = 0; i < 3; ++i) {
    a.w[i] = static_cast<const hdrtv::bf16*>(w[i]);
    a.b[i] = static_cast<const float*>(b[i]);
  }
  a.y = static_cast<hdrtv::bf16*>(y);
  a.rows = 4LL * H * W;
  a.W = W;
  a.phases = static_cast<unsigned long long*>(phases);
  return static_cast<int>(hdrtv::agcm_sm90(a, static_cast<cudaStream_t>(stream)));
}

// The fp32 s2d form's two passes on their 3×TF32 tiles, built with their
// timers (csrc/agcm_head.cu, whose exported functions this library then
// also holds): the AGCM pass (AgcmF32Args' arguments as above; phases
// (3·blocks, 8)) and the input conv of agcm (H, W, 12) with the s2d pack's
// w_in, b_in and the head's slot table into fea and c0 (phases (blocks, 8)).
#include "../csrc/agcm_head.cu"

extern "C" int hdrtv_sm90_agcm_f32_phases(const void* x, int kind, float scale, const void* mods, int mw,
                                          const void* w1, const void* b1, const void* w2, const void* b2,
                                          const void* w3, const void* b3, void* y, int H, int W, void* phases,
                                          void* stream) {
  hdrtv::AgcmF32Args g;
  hdrtv::InConvF32Args c;
  const int slots[36] = {};
  hdrtv::agcm_head_s2d_f32_args(g, c, x, kind, scale, mods, mw, w1, b1, w2, b2, w3, b3, nullptr, nullptr, slots,
                                nullptr, nullptr, y, H, W);
  g.phases = static_cast<unsigned long long*>(phases);
  return static_cast<int>(hdrtv::agcm_tf32x3(g, static_cast<cudaStream_t>(stream)));
}

extern "C" int hdrtv_sm90_in_conv_f32_phases(const void* agcm, const void* w_in, const void* b_in, const int* slots,
                                             void* fea, void* c0, int H, int W, void* phases, void* stream) {
  hdrtv::AgcmF32Args g;
  hdrtv::InConvF32Args c;
  hdrtv::agcm_head_s2d_f32_args(g, c, nullptr, 0, 1.f, nullptr, 256, nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr, w_in, b_in, slots, fea, c0, const_cast<void*>(agcm), H, W);
  c.phases = static_cast<unsigned long long*>(phases);
  return static_cast<int>(hdrtv::in_conv_tf32x3(c, static_cast<cudaStream_t>(stream)));
}
