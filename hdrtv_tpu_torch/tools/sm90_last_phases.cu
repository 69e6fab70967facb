// The tail's conv_last built with its phase timers (HDRTV_SM90_PHASES), for
// tools/sm90_phases.py, which links this file beside sm90_phases.cu; not
// part of the kernel library: the dense kernel (csrc/conv_last.cuh
// conv_last_kernel, bf16), the s2d form's Hopper tile
// (conv_last_sm90_kernel) and its fp32 tile (conv_last_tf32x3_kernel). Each
// fills one row of 8 u64 per warp.
#define HDRTV_SM90_PHASES
#include "../csrc/conv_last.cuh"

// conv_last of h (H, W, C) bf16 with w (3, 3, C, Cl) bf16, b (Cl) fp32 and
// skip (H, W, Cl) bf16 into out (packed u16 or bf16): with walk null the
// dense kernel, else the Hopper tile walking it.
extern "C" int hdrtv_conv_last_phases(const void* h, const void* w, const void* b, const void* skip, void* out,
                                      int H, int W, int C, int Cl, int pack, const int* walk, void* phases,
                                      void* stream) {
  if (walk) {
    hdrtv::LastSm90Args a;
    a.phases = static_cast<unsigned long long*>(phases);
    return static_cast<int>(hdrtv::conv_last_sm90(h, w, static_cast<const float*>(b), skip, out, H, W, C, Cl, pack,
                                                  walk, static_cast<cudaStream_t>(stream), &a));
  }
  hdrtv::LastArgs a;
  a.h = h;
  a.w = w;
  a.b = static_cast<const float*>(b);
  a.skip = skip;
  a.out = out;
  a.H = H;
  a.W = W;
  a.C = C;
  a.Cl = Cl;
  a.pack = pack;
  a.phases = static_cast<unsigned long long*>(phases);
  return static_cast<int>(hdrtv::launch_conv_last<hdrtv::bf16>(a, static_cast<cudaStream_t>(stream)));
}

// conv_last's fp32 s2d tile (conv_last_tf32x3_kernel): h (H, W, 128), w (3,
// 3, 128, 12), b, skip fp32 into out (packed u16 or fp32), walking `walk`.
extern "C" int hdrtv_conv_last_f32_phases(const void* h, const void* w, const void* b, const void* skip, void* out,
                                          int H, int W, int pack, const int* walk, void* phases, void* stream) {
  hdrtv::LastF32Args a;
  a.phases = static_cast<unsigned long long*>(phases);
  return static_cast<int>(hdrtv::conv_last_tf32x3(h, w, static_cast<const float*>(b), skip, out, H, W, 128, 12, pack,
                                                  walk, static_cast<cudaStream_t>(stream), &a));
}
