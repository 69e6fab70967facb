// agcm_head's AGCM row tile (csrc/chain_sm90.cuh agcm_sm90) built with its
// phase timers (HDRTV_SM90_PHASES), for tools/sm90_phases.py, which links it
// beside sm90_phases.cu; not part of the kernel library. AgcmSm90Args'
// arguments and the (2·blocks, 8) u64 array the kernel fills.
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
