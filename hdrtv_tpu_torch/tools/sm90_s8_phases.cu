// The int8 s2d forms' Hopper tiles built with their phase timers
// (HDRTV_SM90_PHASES), for tools/sm90_phases.py, which links this file
// beside sm90_phases.cu; not part of the kernel library: the wgmma s8 conv
// tile (csrc/conv3x3_s8_sm90.cuh, at stride 1 and, down2_w8a8's form, at
// stride 2 over several branches' code planes) and the SFT row tile (csrc/chain_sm90.cuh
// sft_sm90), the latter in its int8-output mode when q_w is set, else its
// bf16 form; the conv with its bf16 or fp32 output, the SFT pass on bf16 x
// (with the coarse up tensor) or fp32 x (resblock's h1); and cond_chain's
// s2d form on the row tile (csrc/chain_sm90.cuh), its int8 instance when a
// step is int8, in fp32 its 3×TF32 instance (csrc/chain_tf32x3.cuh); and the
// fp32 SFT pass of sft_conv3's and resblock's s2d forms on the row tile's
// 3×TF32 instance (csrc/sft_tf32x3.cuh), and its int8-output mode (the fp32
// s2d forms of tail_w8a8 and sft_conv3_w8a8). Each fills a (2·blocks, 8) u64
// array (the 3×TF32 row tiles: (3·blocks, 8)).
#define HDRTV_SM90_PHASES
#include "../csrc/chain_sm90.cuh"
#include "../csrc/chain_tf32x3.cuh"
#include "../csrc/conv3x3_s8_sm90.cuh"
#include "../csrc/sft_tf32x3.cuh"

namespace {

hdrtv::QuantParams quant(const void* w, const void* yscale, const void* bias, float s, float z, int pad) {
  hdrtv::QuantParams p;
  p.w = static_cast<const int8_t*>(w);
  p.yscale = static_cast<const float*>(yscale);
  p.bias = static_cast<const float*>(bias);
  p.s = s;
  p.z = z;
  p.asym = z != 0.f || pad != 0;
  p.pad = pad;
  return p;
}

}  // namespace

// The int8 'same' conv of codes q (H, W, C) → y (H, W, Co), bf16, or fp32
// with f32_out (resblock_w8a8's conv1, block_conv3_w8a8 in fp32): the layer
// (w, yscale, bias, x_scale s, x_zero z, pad code), the skip (H, W, Co) in
// y's type or null, act, the slot table; pool: block_conv3_w8a8's pool_out
// instance, y (H/2, W/2, Co), without a skip.
extern "C" int hdrtv_sm90_s8_phases(const void* q, const void* w, const void* yscale, const void* bias, float s,
                                    float z, int pad, const void* skip, void* y, int H, int W, int C, int Co, int act,
                                    const int* table, int per_list, int f32_out, int pool, void* phases,
                                    void* stream) {
  hdrtv::S8Sm90Args a;
  a.phases = static_cast<unsigned long long*>(phases);
  const hdrtv::QuantParams p = quant(w, yscale, bias, s, z, pad);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pool) {
    const cudaError_t err =
        hdrtv::s8_sm90_setup<1>(a, q, 0, &p, 1, skip, y, H, W, C, Co, 1, act, table, per_list, f32_out != 0, true);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(f32_out ? hdrtv::launch_s8_sm90<1, false, true, true>(a, st)
                                    : hdrtv::launch_s8_sm90<1, false, false, true>(a, st));
  }
  return static_cast<int>(hdrtv::conv3x3_s8_sm90(q, p, skip, y, H, W, C, Co, act, table, per_list, st, &a,
                                                 f32_out != 0));
}

// down2_w8a8's stride-2 conv of nb code planes (plane bytes apart) → y
// (H/2, W/2, Co) bf16: branch bi's layer (w[bi], yscale[bi], bias[bi], x_scale
// s, x_zero z[bi], pad[bi]), a_sub, act, the stride-2 slot table.
extern "C" int hdrtv_sm90_s8_s2_phases(const void* q, long long plane, const void* const* w,
                                       const void* const* yscale, const void* const* bias, const float* s,
                                       const float* z, const int* pad, int nb, void* y, int H, int W, int C, int Co,
                                       int a_sub, int act, const int* table, int per_list, void* phases,
                                       void* stream) {
  hdrtv::QuantParams p[hdrtv::kMaxBranches];
  for (int bi = 0; bi < nb && bi < hdrtv::kMaxBranches; ++bi) p[bi] = quant(w[bi], yscale[bi], bias[bi], s[bi], z[bi], pad[bi]);
  hdrtv::S8Sm90Args a;
  a.phases = static_cast<unsigned long long*>(phases);
  return static_cast<int>(hdrtv::conv3x3_s8_sm90_s2(q, plane, p, nb, y, H, W, C, Co, a_sub, act, table, per_list,
                                                    static_cast<cudaStream_t>(stream), &a));
}

// The SFT pass over s2d weights (x bf16, add the coarse up tensor or null;
// or with f32x x fp32 and no add; sft the eight pointers), writing bf16 t,
// or with q_w set the codes of the layer (q_w, s, z: only its scale and
// zero point are read).
extern "C" int hdrtv_sm90_sft_phases(const void* x, const void* add, const void* cond, void* t,
                                     const void* const* sft, int H, int W, int C, int CC, const void* q_w, float s,
                                     float z, int asym, int f32x, void* phases, void* stream) {
  hdrtv::QuantParams p = quant(q_w, nullptr, nullptr, s, z, 0);
  p.asym = asym;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* const ph = static_cast<unsigned long long*>(phases);
  if (f32x)
    return static_cast<int>(hdrtv::sft_sm90<float>(x, nullptr, 0, nullptr, cond, t, sft, H, W, C, CC, st,
                                                   q_w ? &p : nullptr, ph));
  return static_cast<int>(hdrtv::sft_sm90<hdrtv::bf16>(x, add, 1, nullptr, cond, t, sft, H, W, C, CC, st,
                                                       q_w ? &p : nullptr, ph));
}

// cond_chain's s2d form (bf16 c0 of npix s2d pixels, natural widths 64 → 64
// ×4 → 16; w, b the five steps' s2d weights and biases, k, n their widths;
// q null or five pointers to QuantParams, null for a float step): the row
// tile's int8 instance with an int8 step, else its float instance.
extern "C" int hdrtv_sm90_cond_chain_phases(const void* c0, void* c, void* cond1, const void* const* w,
                                            const void* const* b, const int* k, const int* n, const void* const* q,
                                            int npix, void* phases, void* stream) {
  hdrtv::ChainSm90Args a;
  bool quant = false;
  const cudaError_t err = hdrtv::cond_chain_sm90_args(a, c0, c, cond1, w, b, k, n, npix,
                                                      reinterpret_cast<const hdrtv::QuantParams* const*>(q), &quant);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.phases = static_cast<unsigned long long*>(phases);
  static hdrtv::DeviceCache cache, qcache;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quant)
    return static_cast<int>(hdrtv::launch_chain_sm90(hdrtv::cond_chain_sm90_kernel<64, 16, true>,
                                                     hdrtv::ChainSm90Cfg<64, 16, 4, true>::SMEM, qcache, a, st));
  return static_cast<int>(hdrtv::launch_chain_sm90(hdrtv::cond_chain_sm90_kernel<64, 16, false>,
                                                   hdrtv::ChainSm90Cfg<64, 16, 4>::SMEM, cache, a, st));
}

// The same in fp32 (c0 fp32): the row tile's 3×TF32 instance, its Q
// instance with an int8 step.
extern "C" int hdrtv_sm90_cond_chain_f32_phases(const void* c0, void* c, void* cond1, const void* const* w,
                                                const void* const* b, const int* k, const int* n, const void* const* q,
                                                int npix, void* phases, void* stream) {
  hdrtv::ChainF32Args a;
  bool quant = false;
  const cudaError_t err = hdrtv::cond_chain_sm90_args(a, c0, c, cond1, w, b, k, n, npix,
                                                      reinterpret_cast<const hdrtv::QuantParams* const*>(q), &quant);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.phases = static_cast<unsigned long long*>(phases);
  static hdrtv::DeviceCache cache, qcache;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quant)
    return static_cast<int>(hdrtv::launch_chain_sm90(hdrtv::cond_chain_sm90_tf32x3_kernel<true>,
                                                     hdrtv::ChainTf32Cfg<true>::SMEM, qcache, a, st,
                                                     hdrtv::ChainTf32Cfg<true>::WGS));
  return static_cast<int>(hdrtv::launch_chain_sm90(hdrtv::cond_chain_sm90_tf32x3_kernel<false>,
                                                   hdrtv::ChainTf32Cfg<false>::SMEM, cache, a, st,
                                                   hdrtv::ChainTf32Cfg<false>::WGS));
}

// The fp32 SFT pass over s2d weights (arguments as sft_tf32x3 takes them:
// fp32 x, add nullptr or fine / coarse, xsum with add, cond, t; H × W s2d
// pixels of C and CC channels).
extern "C" int hdrtv_sm90_sft_f32_phases(const void* x, const void* add, int coarse, void* xsum, const void* cond,
                                         void* t, const void* const* sft, int H, int W, int C, int CC, void* phases,
                                         void* stream) {
  return static_cast<int>(hdrtv::sft_tf32x3(x, add, coarse, xsum, cond, t, sft, H, W, C, CC,
                                            static_cast<cudaStream_t>(stream), nullptr,
                                            static_cast<unsigned long long*>(phases)));
}

// The same pass in its int8-output mode (sft_q8_f32_kernel): t written as the
// codes of the layer (s, z, pad; the codes only matter here).
extern "C" int hdrtv_sm90_sft_q8_f32_phases(const void* x, const void* add, int coarse, const void* cond, void* codes,
                                            const void* const* sft, int H, int W, int C, int CC, float s, float z,
                                            int pad, void* phases, void* stream) {
  const hdrtv::QuantParams q = quant(nullptr, nullptr, nullptr, s, z, pad);
  return static_cast<int>(hdrtv::sft_tf32x3(x, add, coarse, nullptr, cond, codes, sft, H, W, C, CC,
                                            static_cast<cudaStream_t>(stream), &q,
                                            static_cast<unsigned long long*>(phases)));
}
