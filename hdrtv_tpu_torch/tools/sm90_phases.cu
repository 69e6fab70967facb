// The Hopper conv tiles (csrc/conv3x3_sm90.cuh, bf16, and its 3×TF32 sibling
// csrc/conv3x3_tf32x3.cuh, fp32) built with their phase timers
// (HDRTV_SM90_PHASES), for tools/sm90_phases.py; not part of the kernel
// library (tools/sm90_agcm_phases.cu, linked beside it, has the AGCM row
// tile). Same arguments as conv3x3_sm90, plus f32 (which tile), out_f32
// (the bf16 tile's fp32-output epilogue, y float), pool (block_conv3's
// pool_out instances at stride 1, with the ReLU: y (H/2, W/2, Co)) and the
// (2·blocks, 8) u64 array the kernel fills.
#define HDRTV_SM90_PHASES
#include "../csrc/conv3x3_tf32x3.cuh"

namespace {

template <typename T, int S>
cudaError_t run(const void* x, const void* w, const void* b, void* y, int H, int W, int cf, int ch0, int C, int Co,
                int a_sub, const int* table, int per_list, int out_f32, int pool, void* phases, cudaStream_t s) {
  hdrtv::Sm90Args<T> a;
  a.phases = static_cast<unsigned long long*>(phases);
  const float* bias = static_cast<const float*>(b);
  if (pool) {
    cudaError_t err = S == 1 && H % 2 == 0 && W % 2 == 0 ? cudaSuccess : cudaErrorInvalidValue;
    if (err == cudaSuccess)
      err = hdrtv::sm90_setup(a, w, bias, nullptr, y, H, W, S, cf, ch0, C, Co, hdrtv::ACT_RELU, a_sub, table,
                              per_list);
    if (err != cudaSuccess) return err;
    if constexpr (std::is_same<T, float>::value)
      return hdrtv::launch_tf32x3_fit<S, true>(a, x, H, W, cf, s);
    else
      return hdrtv::launch_sm90_fit<S, hdrtv::kEpiPool>(a, x, H, W, cf, s);
  }
  if constexpr (std::is_same<T, float>::value)
    return hdrtv::conv3x3_tf32x3<S>(x, w, bias, nullptr, y, H, W, cf, ch0, C, Co, 0, a_sub, table, per_list, s, &a);
  else
    return hdrtv::conv3x3_sm90<S>(x, w, bias, nullptr, y, H, W, cf, ch0, C, Co, 0, a_sub, table, per_list, s, &a,
                                  out_f32);
}

}  // namespace

extern "C" int hdrtv_sm90_phases(const void* x, const void* w, const void* b, void* y, int H, int W, int cf,
                                 int ch0, int C, int Co, int S, int a_sub, const int* table, int per_list,
                                 int f32, int out_f32, int pool, void* phases, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int o = out_f32, pl = pool;
  const cudaError_t err =
      f32 ? (S == 1 ? run<float, 1>(x, w, b, y, H, W, cf, ch0, C, Co, a_sub, table, per_list, 0, pl, phases, s)
                    : run<float, 2>(x, w, b, y, H, W, cf, ch0, C, Co, a_sub, table, per_list, 0, pl, phases, s))
          : (S == 1 ? run<hdrtv::bf16, 1>(x, w, b, y, H, W, cf, ch0, C, Co, a_sub, table, per_list, o, pl, phases, s)
                    : run<hdrtv::bf16, 2>(x, w, b, y, H, W, cf, ch0, C, Co, a_sub, table, per_list, o, pl, phases,
                                          s));
  return static_cast<int>(err);
}
