// The Hopper conv tile (csrc/conv3x3_sm90.cuh) built with its phase timers
// (HDRTV_SM90_PHASES), for tools/sm90_phases.py; not part of the kernel
// library. Same arguments as conv3x3_sm90, plus the (2·blocks, 8) u64 array
// the kernel fills.
#define HDRTV_SM90_PHASES
#include "../csrc/conv3x3_sm90.cuh"

extern "C" int hdrtv_sm90_phases(const void* x, const void* w, const void* b, void* y, int H, int W, int cf,
                                 int ch0, int C, int Co, int S, int a_sub, const int* table, int per_list,
                                 void* phases, void* stream) {
  hdrtv::Sm90Args a;
  a.phases = static_cast<unsigned long long*>(phases);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      S == 1 ? hdrtv::conv3x3_sm90<1>(x, w, static_cast<const float*>(b), nullptr, y, H, W, cf, ch0, C, Co, 0, a_sub,
                                      table, per_list, s, &a)
             : hdrtv::conv3x3_sm90<2>(x, w, static_cast<const float*>(b), nullptr, y, H, W, cf, ch0, C, Co, 0, a_sub,
                                      table, per_list, s, &a);
  return static_cast<int>(err);
}
