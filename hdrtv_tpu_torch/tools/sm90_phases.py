"""Where the Hopper conv tiles spend their time: in-kernel phase timers.

    python -m hdrtv_tpu_torch.tools.sm90_phases [--only conv,agcm,s8,s8_s2,last,pool,chain,sft_f32,sft_q8_f32,last_f32,head_f32]

Builds ``tools/sm90_phases.cu`` (the bf16 tile of ``csrc/conv3x3_sm90.cuh``
and the fp32 3×TF32 tile of ``csrc/conv3x3_tf32x3.cuh``, with their
``HDRTV_SM90_PHASES`` clock64() timers) and ``tools/sm90_agcm_phases.cu``
(the AGCM row tile of ``csrc/chain_sm90.cuh``, likewise) with nvcc into ``build/``, runs them
at the 1080p shapes of the frame programs' block_conv3 and down2 calls
(seeded random s2d weights, the ``a_sub`` the program passes; bf16 at the
bf16 programs' shapes, fp32 at the fp32 programs'), and in bf16 at
resblock's L1 shape, its conv2 (bf16 out) and its conv1 (h1 stored by the
fp32-output epilogue), and at trunk3's 32 → 32 conv (135 × 240, natural,
dense: a_sub = 0, one 9-chunk list; in fp32 also its up_conv1, 32 → 128,
on the 3×TF32 tile's 64-wide N tile), and prints, per shape,
the mean cycles a warpgroup spends in each phase of its step loop and their
share of its total. The bf16 tile:

- ``wait B``: the loop's bookkeeping and, where the weights stream, the wait
  for this thread's cp.async copies of B;
- ``wait A``: the wait on the stage's mbarrier (TMA's bytes of A);
- ``meet``: the __syncthreads after it;
- ``products``: thread 0's refill, the wgmma issue and the wait for the
  previous step's products;
- ``epilogue``: a tile's last step: its products, bias, activation,
  rounding and stores;
- ``B stream``: the streamed weights' copies and the ring's counters.

The fp32 tile (its step issues this chunk's products, then loads and
splits the next chunk's A fragments under them): ``split A`` (loading and
splitting the next step's fragments), ``wait A`` (the next stage's
mbarrier), ``meet`` (the __syncthreads and thread 0's refill),
``products`` (issuing the 12 wgmmas and, after the split, waiting for
them), ``epilogue`` (bias, skip, activation, stores) and ``B load``
(reading and splitting the block's resident weights, once).

Then agcm_head's AGCM row tile (``csrc/chain_sm90.cuh agcm_sm90``) at the
1080p frame as u8 pair planes, the mean cycles of a warpgroup's tiles in:
``fetch`` (packing this tile's frame values, issuing the next tile's
loads), ``step 0`` / ``step 1`` / ``step 2`` (issuing and waiting for the
three 1×1s' products), ``hidden 0`` / ``hidden 1`` (bias, modulation, ReLU
and rounding into the next step's fragments) and ``out`` (the last step's
epilogue and the stores).

Then the int8 s2d forms' tiles (``tools/sm90_s8_phases.cu``) at the tail's
1080p shape (540 × 960 s2d pixels, 128 → 128, symmetric and with a zero
point): the wgmma s8 conv tile of ``csrc/conv3x3_s8_sm90.cuh`` (HR_conv2),
its phases named as the bf16 tile's (``meet`` includes filling the pad
rows of edge tiles, ``products`` thread 0's TMA stores and refill,
``epilogue`` the outputs' rescale and staging; a step is one tap's box),
and the SFT row tile (``csrc/chain_sm90.cuh
sft_sm90``, up_coarse un-folded on read) in its int8-output mode and, to
compare, its bf16 form: ``wait`` (for the tile's rows), ``products`` (the
three 1×1 products and the hidden epilogue), ``t`` (x·(scale + 1) + shift;
in bf16 also its rounded store to the stage), ``quantize`` (the IEEE
division and rounding of every value), ``out`` (the codes into the stage,
the meeting and the 16-byte stores). Then resblock_w8a8's s2d forms at its
L1 shape (270 × 480): conv1 on the s8 tile with its fp32-output epilogue
(h1 unrounded, staged in the 128-byte swizzle and stored by TMA) beside
conv2's bf16 output, and SFT2 in the int8-output mode on the fp32 h1
beside the same pass on bf16 x; and block_conv3_w8a8's fp32 calls on the
s8 tile's fp32-output epilogue (L1 trunk conv2 with its fp32 skip, conv1,
up_conv3). Then down2_w8a8's stride-2 form of the s8 tile at the
consolidated CondNet down conv (three branches' code planes) and at
CondNet3.2, symmetric and with zero points (a step is one box of a tap's
64 or 128 bytes a pixel).

Then the tail's conv_last (``tools/sm90_last_phases.cu``) at 1080p, packed
and unpacked: the dense kernel (``csrc/conv_last.cuh conv_last_kernel``)
and the s2d form's Hopper tile (``conv_last_sm90_kernel``), per warp (see
:func:`last_phases`).

Then block_conv3's pool_out form with a_sub = 1 at L1 up_conv3's shape
(270 × 480 × 128 → 512, PS-folded, pooled to 135 × 240; :func:`pool_phases`):
the pooled instances of the bf16 tile (kEpiPool), the 3×TF32 tile and the
wgmma s8 tile (bf16 and fp32 output, its codes given), each beside its
unpooled call, with the phases named as above (``epilogue`` holds the pool:
the shuffle, the rows' exchange or, in the s8 tile, the staged rows' max).

Then cond_chain's s2d form at 1080p (540 × 960 s2d pixels, natural 64 → 64
×4 → 16; :func:`chain_phases`) on the row tile in bf16 and on its fp32
3×TF32 instance (``csrc/chain_tf32x3.cuh``), each with steps 0, 2 and 4
int8 (its int8 instance) and all float: the mean cycles of a warpgroup's
tiles in ``rows`` (the wait for its rows, the next tile's loads), ``float
steps`` (issuing and waiting for the products: bf16, or 3×TF32 with the
chunk sums added), ``int8 steps`` (the meeting over the codes, the s8
products, the rescale), ``hand-off`` (the activation, then the rounding
into the next A fragments, in fp32 the TF32 split, or the quantizing into
the code tile; bf16: the first step's codes or fragments too; fp32: c's
stores), ``out`` (the last step's epilogue and the stores; bf16: the
meeting) and, fp32 only, ``first A`` (the first step's fragments split, or
its codes, from the staged rows).

Then the fp32 SFT pass of sft_conv3's and resblock's s2d forms on the row
tile's 3×TF32 instance (``csrc/sft_tf32x3.cuh``; :func:`sft_f32_phases`) at
their 1080p shapes: sft_conv3's L0 and L2 calls (x alone), resblock's SFT1
at L1 with up_coarse un-folded on read and xsum written, and its SFT2 on
h1: the mean cycles of a warpgroup's tiles in ``rows`` (the wait for its
rows and the refill), ``first A`` (the first product's fragments split
from the staged cond, x and add read, xsum's stores), ``products`` (the
three 16-deep 3×TF32 products and their waits), ``hand-off`` (bias, leaky
ReLU and the split of the hidden into the second products' A) and ``out``
(t and its stores). The convs of those forms are the ``conv`` part's fp32
HR_conv1 (L0), resblock conv (L1) and trunk2/4 conv (L2) shapes.

Then the same pass's int8-output mode (``sft_q8_f32_kernel``, the fp32 s2d
forms of tail_w8a8 and sft_conv3_w8a8; :func:`sft_q8_f32_phases`) at the
tail's 1080p shape with up_coarse and sft_conv3's L0 (symmetric and with a
zero point) and L2 shapes: ``rows`` (the wait for its rows and the
refill), ``reads`` (cond, x and add from the stage), ``hidden`` (the first
product's FMA chains, bias, leaky ReLU, the hidden tile's stores and the
meeting), ``products`` (the second products' FMA chains), ``t + codes`` (t,
its codes by the multiply, the band's groups by the division, the code
tile's stores) and ``out`` (the meeting and the 16-byte stores). The s8 tile's fp32-output
epilogue behind it is the ``s8`` part's.

Then the fp32 s2d tail's conv_last tile (``csrc/conv_last.cuh
conv_last_tf32x3_kernel``; :func:`last_f32_phases`) at 1080p, packed and
unpacked, per warp, its phases named as the bf16 tile's (``products``: a
warp's half of the slots, 32 ldmatrix.x4 with their TF32 split and 144
mma.sync.m16n8k8, and its trade; ``setup`` includes splitting the B
fragments into shared memory). And the fp32 s2d
head's two 3×TF32 tiles (:func:`head_f32_phases`) at the 1080p frame: the
AGCM pass (``csrc/agcm_tf32x3.cuh agcm_tf32x3_kernel``, u8 pair planes)
per warpgroup, in the bf16 tile's phases but ``next A`` (the last step's
issue, and the next tile's A split and the one after it fetched under
those products) and ``step 2`` (their wait), and the input conv
(``csrc/agcm_head.cu in_conv_tf32x3_kernel``, two warpgroups on 48
columns each) per block, in ``halo`` (the wait for a tile's agcm halo and
the meeting), ``gather A`` (so's 16 values a thread from the halo, split),
``products`` (12 wgmmas and their wait), ``wait store`` (thread 0 waiting
for the stage's store two sub-positions back, and the meeting) and
``epilogue`` (bias, activation, the staged output, the meeting and the
three TMA stores' issue), summed over its four sub-positions.

After its build it prints the build's ptxas notes that name a wgmma
serialization or an injected wait (the ``C75`` codes, C7517 among them),
each with the function it names, or says there are none.

The timers cost time themselves; compare shares, not totals, with the
kernel library's times. Needs a CUDA device; the last line is the card's
name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from hdrtv_tpu_torch.models.s2d import w_ps_permute, w_s2d_s1_ps, w_s2d_s2
from hdrtv_tpu_torch.ops import native
from hdrtv_tpu_torch.ops.conv_kernels import sm90_table

SRC = Path(__file__).resolve().parent / "sm90_phases.cu"
SRC_AGCM = Path(__file__).resolve().parent / "sm90_agcm_phases.cu"
SRC_S8 = Path(__file__).resolve().parent / "sm90_s8_phases.cu"
SRC_LAST = Path(__file__).resolve().parent / "sm90_last_phases.cu"
PHASES = {"bf16": ["total", "wait B", "wait A", "meet", "products", "epilogue", "B stream"],
          "f32": ["total", "split A", "wait A", "meet", "products", "epilogue", "B load"]}
# (name, stride, Hb, Wb, C, Co, a_sub): up_conv3/2 (PS-folded, block_conv3), the
# consolidated CondNet down conv, CondNet3.2's window, down_conv1/2 (down2); in fp32
# also the full-resolution HR_conv1/2 (block_conv3, 128 → 128), which only the fp32
# programs run through block_conv3, and trunk3's dense natural convs at /8 (32 → 32,
# and up_conv1 32 → 128)
SHAPES = [
    ("up_conv3", 1, 270, 480, 128, 512, 1), ("up_conv2", 1, 135, 240, 128, 512, 1),
    ("LE.__cond_down", 2, 540, 960, 256, 768, 3), ("CondNet3.2", 2, 270, 480, 256, 256, 1),
    ("down_conv1", 2, 540, 960, 128, 128, 1), ("down_conv2", 2, 270, 480, 128, 128, 1),
]
SHAPES_F32 = SHAPES + [("HR_conv1", 1, 540, 960, 128, 128, 1), ("resblock conv", 1, 270, 480, 128, 128, 1),
                       ("trunk2/4 conv", 1, 135, 240, 128, 128, 1), ("trunk3 conv", 1, 135, 240, 32, 32, 0),
                       ("trunk3 up_conv1", 1, 135, 240, 32, 128, 0)]
# resblock at L1 (bf16 only): conv2, and conv1 with h1 stored in fp32 (the last field); trunk3's
# natural 32 → 32 conv at /8, dense (a_sub 0)
SHAPES_BF16 = [(*shape, False) for shape in SHAPES] + [
    ("resblock conv2", 1, 270, 480, 128, 128, 1, False), ("resblock conv1 h1 fp32", 1, 270, 480, 128, 128, 1, True),
    ("trunk3 conv", 1, 135, 240, 32, 32, 0, False),
]


def build() -> ctypes.CDLL:
    out = native.BUILD_ROOT / "sm90_phases" / native.source_hash()
    so = out / "libsm90_phases.so"
    if not so.exists():
        out.mkdir(parents=True, exist_ok=True)
        srcs = (SRC, SRC_AGCM, SRC_S8, SRC_LAST)
        res = subprocess.run([native._nvcc(), *native.ARCH_FLAGS, *native.NVCC_FLAGS, "-shared", "-o", str(so),
                              *map(str, srcs)], capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed on {', '.join(p.name for p in srcs)}:\n{res.stdout}{res.stderr}")
        (out / "build.log").write_text(res.stdout + res.stderr)
    notes = [ln.strip() for ln in (out / "build.log").read_text().splitlines() if "C75" in ln] \
        if (out / "build.log").exists() else ["(no build log: built by an earlier version of this tool)"]
    print("ptxas C75 notes: " + ("; ".join(notes) if notes else "none"), flush=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hdrtv_sm90_phases.argtypes = [p, p, p, p] + [i] * 8 + [p, i, i, i, i, p, p]
    lib.hdrtv_sm90_phases.restype = i
    lib.hdrtv_sm90_agcm_phases.argtypes = [p, i, ctypes.c_float, p, i] + [p] * 7 + [i, i, p, p]
    lib.hdrtv_sm90_agcm_phases.restype = i
    f = ctypes.c_float
    lib.hdrtv_sm90_s8_phases.argtypes = [p, p, p, p, f, f, i, p, p] + [i] * 5 + [p, i, i, i, p, p]
    lib.hdrtv_sm90_s8_phases.restype = i
    lib.hdrtv_sm90_s8_s2_phases.argtypes = [p, ctypes.c_longlong, p, p, p, p, p, p, i, p] + [i] * 6 + [p, i, p, p]
    lib.hdrtv_sm90_s8_s2_phases.restype = i
    lib.hdrtv_sm90_sft_phases.argtypes = [p, p, p, p, p, i, i, i, i, p, f, f, i, i, p, p]
    lib.hdrtv_sm90_sft_phases.restype = i
    lib.hdrtv_conv_last_phases.argtypes = [p] * 5 + [i] * 5 + [p, p, p]
    lib.hdrtv_conv_last_phases.restype = i
    lib.hdrtv_sm90_cond_chain_phases.argtypes = [p] * 8 + [i, p, p]
    lib.hdrtv_sm90_cond_chain_phases.restype = i
    lib.hdrtv_sm90_cond_chain_f32_phases.argtypes = [p] * 8 + [i, p, p]
    lib.hdrtv_sm90_cond_chain_f32_phases.restype = i
    lib.hdrtv_sm90_sft_f32_phases.argtypes = [p, p, i, p, p, p, p, i, i, i, i, p, p]
    lib.hdrtv_sm90_sft_f32_phases.restype = i
    lib.hdrtv_sm90_sft_q8_f32_phases.argtypes = [p, p, i, p, p, p, i, i, i, i, f, f, i, p, p]
    lib.hdrtv_sm90_sft_q8_f32_phases.restype = i
    lib.hdrtv_conv_last_f32_phases.argtypes = [p] * 5 + [i, i, i, p, p, p]
    lib.hdrtv_conv_last_f32_phases.restype = i
    lib.hdrtv_sm90_agcm_f32_phases.argtypes = lib.hdrtv_sm90_agcm_phases.argtypes
    lib.hdrtv_sm90_agcm_f32_phases.restype = i
    lib.hdrtv_sm90_in_conv_f32_phases.argtypes = [p, p, p, p, p, p, i, i, p, p]
    lib.hdrtv_sm90_in_conv_f32_phases.restype = i
    return lib


def _report(name: str, phases: torch.Tensor, names: list, steps: bool | None = True) -> None:
    """Mean cycles of the warpgroups that ran, per phase, and their shares;
    the last field counts steps (``steps``), tiles (False) or is a phase of
    its own (None: eight names)."""
    torch.cuda.synchronize()
    d = phases.view(-1, 8).cpu().numpy()
    d = d[d[:, 0] > 0]
    mean = d.mean(axis=0)
    shares = {k: f"{mean[i]:.0f} ({mean[i] / mean[0]:.0%})" for i, k in enumerate(names)}
    what = "" if steps is None else f"{mean[7]:.0f} steps each; " if steps else f"{mean[7]:.0f} tiles each; "
    print(f"{name}: {len(d)} warpgroups, {what}cycles {shares}", flush=True)


SFT_PHASES = ["total", "wait", "products", "t", "quantize", "out"]


def s8_phases(lib, dev, rng) -> None:
    """The int8 s2d forms' tiles at the tail's 1080p shape (540 × 960 s2d
    pixels, natural CC 16 and C 32): HR_conv2 on the wgmma s8 tile and the
    SFT pass on the row tile, int8-output and bf16, seeded s2d weights, one
    layer calibrated symmetric and one with a zero point; then
    resblock_w8a8's L1 shape (270 × 480): its convs (fp32 and bf16 output)
    and SFT2 (fp32 x, int8-output) beside the bf16-x pass; then
    block_conv3_w8a8's fp32 calls on the tile's fp32-output epilogue: L1
    trunk conv2 with its fp32 skip beside conv1 without, and L1 up_conv3
    (128 → 512)."""
    from hdrtv_tpu_torch.models.s2d import b_s2d, w_s2d_1x1, w_s2d_s1
    from hdrtv_tpu_torch.ops.w8a8 import pack_qargs
    from hdrtv_tpu_torch.quant.int8 import quantize_weight

    hb, wb, c, cc = 540, 960, 128, 64
    stream = torch.cuda.current_stream().cuda_stream
    table, per_list = sm90_table("tail", 1, 1, c, c, c)
    wq, ws = quantize_weight(rng.randn(3, 3, c // 4, c // 4).astype(np.float32) * 0.05)
    b = (rng.randn(c) * 0.1).astype(np.float32)
    layers = {"sym": pack_qargs(w_s2d_s1(wq), b_s2d(ws), 0.01, None, b, dev),
              "asym": pack_qargs(w_s2d_s1(wq), b_s2d(ws), 0.01, -0.3, b, dev)}

    def conv(name, h, w, out_dt, act, skip=False, layers=layers, co=c):
        codes = torch.as_tensor(rng.randint(-128, 128, size=(h, w, c)).astype(np.int8), device=dev)
        y = torch.empty(h, w, co, device=dev, dtype=out_dt)
        sk = torch.rand(h, w, co, device=dev).to(out_dt) if skip else None
        tab, per = sm90_table(name, 1, 1, c, co, c)
        for cal, qa in layers.items():
            phases = torch.zeros(2 * 132 * 8 * 8, dtype=torch.int64, device=dev)
            for _ in range(3):  # warm: the last run's sums are read
                rc = lib.hdrtv_sm90_s8_phases(codes.data_ptr(), qa.w.data_ptr(), qa.yscale.data_ptr(),
                                              qa.bias.data_ptr(), qa.scale, qa.zero or 0.0, qa.pad,
                                              None if sk is None else sk.data_ptr(), y.data_ptr(), h, w, c, co, act,
                                              tab, per, int(out_dt == torch.float32), 0, phases.data_ptr(),
                                              stream)
                if rc:
                    raise RuntimeError(f"conv3x3_s8_sm90 {name} {cal}: CUDA error {rc}")
            _report(f"{name} int8 s2d ({cal}, pad {qa.pad})", phases, PHASES["bf16"])

    conv("HR_conv2", hb, wb, torch.bfloat16, 1)

    def t(a, dt=torch.bfloat16):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev).to(dt)

    sft = []
    for ci, co in ((16, 16), (16, 32), (16, 16), (16, 32)):
        sft += [t(w_s2d_1x1(rng.randn(1, 1, ci, co).astype(np.float32) * 0.05)[0, 0]),
                t(np.tile(rng.randn(co) * 0.1, 4), torch.float32)]
    ptrs = native.pointer_array(sft)

    def sft_pass(name, h, w, x_dt, forms):
        x = t(rng.rand(h, w, c) - 0.3, x_dt)
        up = t(rng.rand(h // 2, w // 2, 4 * c) - 0.3) if x_dt == torch.bfloat16 else None
        cond = t(rng.rand(h, w, cc) - 0.3)
        out = torch.empty(h, w, c, device=dev, dtype=torch.bfloat16)
        for form, qa in forms:
            phases = torch.zeros(2 * 132 * 8 * 8, dtype=torch.int64, device=dev)
            for _ in range(3):
                rc = lib.hdrtv_sm90_sft_phases(x.data_ptr(), None if up is None else up.data_ptr(), cond.data_ptr(),
                                               out.data_ptr(), ptrs, h, w, c, cc,
                                               None if qa is None else qa.w.data_ptr(),
                                               1.0 if qa is None else qa.scale, (qa.zero or 0.0) if qa else 0.0,
                                               int(qa is not None and qa.zero is not None),
                                               int(x_dt == torch.float32), phases.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"sft_sm90 {name} {form}: CUDA error {rc}")
            _report(f"{name} ({form})", phases, SFT_PHASES, steps=False)

    q8 = [("int8-output, sym", layers["sym"]), ("int8-output, asym", layers["asym"])]
    sft_pass("tail SFT pass s2d", hb, wb, torch.bfloat16, q8 + [("bf16 t", None)])
    conv("resblock L1 conv1 fp32 h1", 270, 480, torch.float32, 1)
    conv("resblock L1 conv2", 270, 480, torch.bfloat16, 0)
    sft_pass("resblock L1 SFT2 s2d, fp32 x", 270, 480, torch.float32, q8)
    sft_pass("resblock L1 SFT1 s2d, bf16 x + up", 270, 480, torch.bfloat16, q8[:1])
    conv("block_conv3_w8a8 fp32 L1 trunk conv1", 270, 480, torch.float32, 1, layers={"sym": layers["sym"]})
    conv("block_conv3_w8a8 fp32 L1 trunk conv2 + fp32 skip", 270, 480, torch.float32, 0, skip=True,
         layers={"sym": layers["sym"]})
    from hdrtv_tpu_torch.models.s2d import w_s2d_s1_ps

    wq4, ws4 = quantize_weight(rng.randn(3, 3, c // 4, c).astype(np.float32) * 0.05)
    up = pack_qargs(w_s2d_s1_ps(wq4), np.tile(ws4, 4), 0.01, None, (rng.randn(4 * c) * 0.1).astype(np.float32), dev)
    conv("block_conv3_w8a8 fp32 L1 up_conv3", 270, 480, torch.float32, 1, layers={"sym": up}, co=4 * c)


def s8_s2_phases(lib, dev, rng) -> None:
    """down2_w8a8's stride-2 s8 tile at its 1080p shapes (the consolidated
    CondNet down conv, 540 × 960 × 256 → 768 over three branches' code
    planes, and CondNet3.2, 270 × 480 × 256 → 256), symmetric and with zero
    points, seeded codes and w_s2d_s2 weights; phases named as the stride-1
    tile's (a step is one box: a tap's 64 or 128 bytes a pixel)."""
    from hdrtv_tpu_torch.models.s2d import b_s2d
    from hdrtv_tpu_torch.ops.conv_kernels import s8_sm90_table
    from hdrtv_tpu_torch.ops.w8a8 import pack_qargs
    from hdrtv_tpu_torch.quant.int8 import quantize_weight

    stream = torch.cuda.current_stream().cuda_stream
    for name, hb, wb, nb in (("LE.__cond_down", 540, 960, 3), ("CondNet3.2", 270, 480, 1)):
        c, co = 256, 256 * nb
        a_sub = 3 if nb > 1 else 1
        table, per_list = s8_sm90_table(name, a_sub, c, co, stride=2)
        codes = torch.as_tensor(rng.randint(-128, 128, size=(nb, hb, wb, c)).astype(np.int8), device=dev)
        y = torch.empty(hb // 2, wb // 2, co, device=dev, dtype=torch.bfloat16)
        for cal in ("sym", "asym"):
            qas = []
            for bi in range(nb):
                wq, ws = quantize_weight(rng.randn(3, 3, c // 4, 64).astype(np.float32) * 0.05)
                qas.append(pack_qargs(w_s2d_s2(wq), b_s2d(ws), 0.01, -0.3 - 0.05 * bi if cal == "asym" else None,
                                      (rng.randn(256) * 0.1).astype(np.float32), dev))
            ws_, ys_, bs_ = (native.pointer_array([getattr(qa, k) for qa in qas]) for k in ("w", "yscale", "bias"))
            scales = (ctypes.c_float * nb)(*[qa.scale for qa in qas])
            zeros = (ctypes.c_float * nb)(*[qa.zero or 0.0 for qa in qas])
            pads = (ctypes.c_int * nb)(*[qa.pad for qa in qas])
            phases = torch.zeros(2 * 132 * 8 * 8, dtype=torch.int64, device=dev)
            for _ in range(3):  # warm: the last run's sums are read
                rc = lib.hdrtv_sm90_s8_s2_phases(codes.data_ptr(), hb * wb * c, ws_, ys_, bs_, scales, zeros, pads, nb,
                                                 y.data_ptr(), hb, wb, c, co, a_sub, 2, table, per_list,
                                                 phases.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"conv3x3_s8_sm90_s2 {name} {cal}: CUDA error {rc}")
            _report(f"{name} int8 stride 2 ({cal}, pads {[qa.pad for qa in qas]})", phases, PHASES["bf16"])


LAST_PHASES = {"dense": ["total", "loads", "products", "epilogue"],
               "sm90": ["total", "setup", "wait", "products", "meet", "epilogue"]}


def last_phases(lib, dev, rng) -> None:
    """The tail's conv_last at the 1080p shape (540 × 960 s2d pixels, h 128
    channels → 12, seeded w_s2d_s1 weight), packed and unpacked, per warp.
    The dense kernel (``csrc/conv_last.cuh conv_last_kernel``): ``loads``
    (staging the block's halo of h and the whole weight, and the meeting
    after it), ``products`` (the nine taps' mma.sync products) and
    ``epilogue`` (bias, skip, pack and the 4-byte stores). The s2d form's
    Hopper tile (``conv_last_sm90_kernel``): ``setup`` (the slots' weights
    into registers, the first loads), then per step ``wait`` (the window's
    three row stages), ``products`` (32 ldmatrix.x4 and 48 mma.sync),
    ``meet`` (the skip row's arrival, the meeting, thread 0's refills and
    the next skip row's copies) and ``epilogue`` (the last row's 16-byte
    stores, bias, skip, pack and staging)."""
    from hdrtv_tpu_torch.models.s2d import w_s2d_s1
    from hdrtv_tpu_torch.ops.megakernel import conv_last_walk

    def t(a, dt=torch.bfloat16):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev).to(dt)

    hb, wb, c, cl = 540, 960, 128, 12
    h = t(np.maximum(rng.rand(hb, wb, c) - 0.3, 0))
    w = t(w_s2d_s1(rng.randn(3, 3, c // 4, cl // 4).astype(np.float32) * 0.03))
    b = t(rng.randn(cl) * 0.02, torch.float32)
    skip = t(rng.rand(hb, wb, cl))
    stream = torch.cuda.current_stream().cuda_stream
    for form, pack in (("dense", 1), ("dense", 0), ("sm90", 1), ("sm90", 0)):
        out = torch.empty((hb, 2, wb, cl // 2), dtype=torch.uint16, device=dev) if pack else \
            torch.empty((hb, wb, cl), dtype=torch.bfloat16, device=dev)
        phases = torch.zeros(((hb + 7) // 8) * ((wb + 15) // 16) * 8 * 8, dtype=torch.int64, device=dev)
        for _ in range(3):  # warm: the last run's sums are read
            rc = lib.hdrtv_conv_last_phases(h.data_ptr(), w.data_ptr(), b.data_ptr(), skip.data_ptr(),
                                            out.data_ptr(), hb, wb, c, cl, pack,
                                            conv_last_walk() if form == "sm90" else None, phases.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"conv_last {form}: CUDA error {rc}")
        _report(f"conv_last {form} (1080p, {'packed' if pack else 'unpacked'}), per warp", phases,
                LAST_PHASES[form], steps=form == "sm90")


AGCM_PHASES = ["total", "fetch", "step 0", "hidden 0", "step 1", "hidden 1", "step 2", "out"]


def agcm_phases(lib, dev, rng) -> None:
    """agcm_head's AGCM row tile at the 1080p frame (540 × 960 s2d pixels as
    u8 pair planes), seeded s2d weights through agcm_head_pack_s2d."""
    from hdrtv_tpu_torch.models.s2d import w_s2d_1x1, w_s2d_s1
    from hdrtv_tpu_torch.ops.megakernel import agcm_head_pack_s2d

    def t(a, dt=torch.bfloat16):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev).to(dt)

    hb, wb = 540, 960
    aw = [t(w_s2d_1x1(rng.randn(1, 1, ci, co).astype(np.float32) * 0.1)[0, 0]) for ci, co in ((3, 64), (64, 64), (64, 3))]
    w_in = t(np.concatenate([w_s2d_s1(rng.randn(3, 3, 3, co).astype(np.float32) * 0.1) for co in (32, 64)], axis=-1))
    w1, w2, w3, _, _ = agcm_head_pack_s2d(*aw, w_in, t(rng.randn(384) * 0.1, torch.float32), n_first=128)
    b = [t(np.tile(rng.randn(n) * 0.1, 4), torch.float32) for n in (64, 64, 3)]
    mods = t(rng.randn(6, 256) * 0.1, torch.float32)
    xs = torch.as_tensor((rng.rand(hb, 2, wb, 6) * 255).astype(np.uint8), device=dev)
    y = torch.empty(hb, wb, 12, device=dev, dtype=torch.bfloat16)
    phases = torch.zeros(8 * 132 * 2 * 8, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(3):  # warm: the last run's sums are read
        rc = lib.hdrtv_sm90_agcm_phases(xs.data_ptr(), 2, 1.0 / 255.0, mods.data_ptr(), 256, w1.data_ptr(),
                                        b[0].data_ptr(), w2.data_ptr(), b[1].data_ptr(), w3.data_ptr(), b[2].data_ptr(),
                                        y.data_ptr(), hb, wb, phases.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"agcm_sm90: CUDA error {rc}")
    torch.cuda.synchronize()
    d = phases.view(-1, 8).cpu().numpy()
    d = d[d[:, 0] > 0]
    mean = d.mean(axis=0)
    shares = {k: f"{mean[i]:.0f} ({mean[i] / mean[0]:.0%})" for i, k in enumerate(AGCM_PHASES)}
    print(f"agcm_sm90 (1080p, u8 pair planes): {len(d)} warpgroups; cycles {shares}", flush=True)


def pool_phases(lib, dev, rng) -> None:
    """block_conv3's pool_out with a_sub = 1 at L1 up_conv3's shape (270 ×
    480 × 128 → 512, PS-folded, ReLU): the bf16 and 3×TF32 tiles pooled and
    unpooled, then the wgmma s8 tile pooled and unpooled, bf16 and fp32 out,
    symmetric."""
    from hdrtv_tpu_torch.ops.conv_kernels import s8_sm90_table
    from hdrtv_tpu_torch.ops.w8a8 import pack_qargs
    from hdrtv_tpu_torch.quant.int8 import quantize_weight

    hb, wb, c, co = 270, 480, 128, 512
    stream = torch.cuda.current_stream().cuda_stream
    w_nat = rng.randn(3, 3, c // 4, co // 4).astype(np.float32) * 0.05
    for dtype, tdt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        w = torch.as_tensor(w_s2d_s1_ps(w_nat), device=dev).to(tdt)
        x = torch.rand(hb, wb, c, device=dev).to(tdt)
        b = torch.zeros(co, device=dev)
        table, per_list = sm90_table("up_conv3", 1, 1, c, co, c, dtype=tdt)
        for pool in (1, 0):
            y = torch.empty(hb // (1 + pool), wb // (1 + pool), co, device=dev, dtype=tdt)
            phases = torch.zeros(2 * 132 * 8 * 8, dtype=torch.int64, device=dev)
            for _ in range(3):  # warm: the last run's sums are read
                rc = lib.hdrtv_sm90_phases(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), hb, wb, c, 0, c,
                                           co, 1, 1, table, per_list, int(dtype == "f32"), 0, pool,
                                           phases.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"up_conv3 pool={pool} {dtype}: CUDA error {rc}")
            _report(f"up_conv3 {'pooled' if pool else 'unpooled'} {dtype}", phases, PHASES[dtype])
    wq, ws = quantize_weight(w_nat)
    qa = pack_qargs(w_s2d_s1_ps(wq), np.tile(w_ps_permute(ws.reshape(1, 1, 1, -1))[0, 0, 0], 4), 0.01, None,
                    (rng.randn(co) * 0.1).astype(np.float32), dev)
    codes = torch.as_tensor(rng.randint(-128, 128, size=(hb, wb, c)).astype(np.int8), device=dev)
    table, per_list = s8_sm90_table("up_conv3", 1, c, co)
    for out_dt in (torch.bfloat16, torch.float32):
        for pool in (1, 0):
            y = torch.empty(hb // (1 + pool), wb // (1 + pool), co, device=dev, dtype=out_dt)
            phases = torch.zeros(2 * 132 * 8 * 8, dtype=torch.int64, device=dev)
            for _ in range(3):
                rc = lib.hdrtv_sm90_s8_phases(codes.data_ptr(), qa.w.data_ptr(), qa.yscale.data_ptr(),
                                              qa.bias.data_ptr(), qa.scale, 0.0, qa.pad, None, y.data_ptr(), hb, wb,
                                              c, co, 1, table, per_list, int(out_dt == torch.float32), pool,
                                              phases.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"up_conv3 int8 pool={pool} {out_dt}: CUDA error {rc}")
            _report(f"up_conv3 {'pooled' if pool else 'unpooled'} int8 s2d, {str(out_dt).split('.')[-1]} out", phases,
                    PHASES["bf16"])


CHAIN_PHASES = ["total", "rows", "float steps", "int8 steps", "hand-off", "out", "first A"]


def chain_phases(lib, dev, rng) -> None:
    """cond_chain's s2d form at 1080p on the row tile, in bf16 and on its fp32
    3×TF32 instance: steps 0, 2 and 4 int8 (2 with a zero point), then every
    step float."""
    from hdrtv_tpu_torch.models.s2d import b_s2d, w_s2d_1x1
    from hdrtv_tpu_torch.ops.w8a8 import pack_qargs
    from hdrtv_tpu_torch.quant.int8 import quantize_weight

    hb, wb = 540, 960
    stream = torch.cuda.current_stream().cuda_stream
    c0_f32 = torch.rand(hb, wb, 256, device=dev) - 0.3
    ws, bs, qargs = [], [], []
    for i, n in enumerate((64, 64, 64, 64, 16)):
        wq, sc = quantize_weight(rng.randn(1, 1, 64, n).astype(np.float32) * 0.15)
        tq, tsc = w_s2d_1x1(wq), b_s2d(sc)
        bnp = b_s2d((rng.randn(n) * 0.1).astype(np.float32))
        ws.append(torch.as_tensor(tq[0, 0].astype(np.float32) * tsc, device=dev))
        bs.append(torch.as_tensor(bnp, device=dev))
        qargs.append(pack_qargs(tq, tsc, 2.0 / 127.0, -0.3 if i == 2 else None, bnp, dev) if i % 2 == 0 else None)
    ints = ctypes.c_int * 5
    k, n = ints(*[w.shape[0] for w in ws]), ints(*[w.shape[1] for w in ws])
    for dtype, fn in ((torch.bfloat16, lib.hdrtv_sm90_cond_chain_phases),
                      (torch.float32, lib.hdrtv_sm90_cond_chain_f32_phases)):
        c0 = c0_f32.to(dtype)
        wt = [w.to(dtype) for w in ws]
        c = torch.empty(hb, wb, 256, device=dev, dtype=dtype)
        cond1 = torch.empty(hb, wb, 64, device=dev, dtype=dtype)
        name = str(dtype).split(".")[-1]
        for form, qs in (("steps 0/2/4 int8", qargs), ("float", None)):
            qptrs, _structs = native.quant_params_pointers(qs) if qs else (None, None)
            phases = torch.zeros(2 * 132 * 8 * 8, dtype=torch.int64, device=dev)
            for _ in range(3):
                rc = fn(c0.data_ptr(), c.data_ptr(), cond1.data_ptr(), native.pointer_array(wt),
                        native.pointer_array(bs), k, n, qptrs, hb * wb, phases.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"cond_chain s2d {name} {form}: CUDA error {rc}")
            _report(f"cond_chain s2d {name} ({form})", phases, CHAIN_PHASES, steps=False)


SFT_F32_PHASES = ["total", "rows", "first A", "products", "hand-off", "out"]


def sft_f32_phases(lib, dev, rng) -> None:
    """The fp32 SFT pass on the 3×TF32 row tile at the 1080p shapes of the
    fp32 s2d forms of sft_conv3 (L0 540 × 960, L2 135 × 240: x alone) and
    resblock (L1 270 × 480: SFT1 with up_coarse and xsum, SFT2 on h1),
    seeded w_s2d_1x1 weights at natural CC 16, C 32."""
    from hdrtv_tpu_torch.models.s2d import w_s2d_1x1

    c, cc = 128, 64
    stream = torch.cuda.current_stream().cuda_stream
    sft = []
    for ci, co in ((16, 16), (16, 32), (16, 16), (16, 32)):
        sft += [torch.as_tensor(w_s2d_1x1(rng.randn(1, 1, ci, co).astype(np.float32) * 0.05)[0, 0], device=dev),
                torch.as_tensor(np.tile(rng.randn(co) * 0.1, 4).astype(np.float32), device=dev)]
    ptrs = native.pointer_array(sft)
    for name, h, w, up in (("sft_conv3 L0", 540, 960, False), ("sft_conv3 L2", 135, 240, False),
                           ("resblock L1 SFT1 + up_coarse, xsum", 270, 480, True),
                           ("resblock L1 SFT2 on h1", 270, 480, False)):
        x = torch.rand(h, w, c, device=dev) - 0.3
        cond = torch.rand(h, w, cc, device=dev) - 0.3
        add = torch.rand(h // 2, w // 2, 4 * c, device=dev) - 0.3 if up else None
        xsum = torch.empty_like(x) if up else None
        t = torch.empty_like(x)
        phases = torch.zeros(2 * 132 * 8 * 8, dtype=torch.int64, device=dev)
        for _ in range(3):  # warm: the last run's sums are read
            rc = lib.hdrtv_sm90_sft_f32_phases(x.data_ptr(), None if add is None else add.data_ptr(), int(up),
                                               None if xsum is None else xsum.data_ptr(), cond.data_ptr(),
                                               t.data_ptr(), ptrs, h, w, c, cc, phases.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"sft_tf32x3 {name}: CUDA error {rc}")
        _report(f"{name} fp32 SFT pass (3×TF32 row tile)", phases, SFT_F32_PHASES, steps=False)


SFT_Q8_F32_PHASES = ["total", "rows", "reads", "hidden", "products", "t + codes", "out"]


def sft_q8_f32_phases(lib, dev, rng) -> None:
    """The fp32 SFT pass's int8-output mode (``csrc/sft_tf32x3.cuh
    sft_q8_f32_kernel``) at the 1080p shapes of the fp32 s2d forms of
    tail_w8a8 (540 × 960, up_coarse un-folded on read) and sft_conv3_w8a8
    (L0 540 × 960 and L2 135 × 240, x alone), the layer calibrated on the
    pass's own t range, symmetric and (L0 sft_conv3) with a zero point;
    seeded w_s2d_1x1 weights at natural CC 16, C 32."""
    from hdrtv_tpu_torch.models.s2d import w_s2d_1x1
    from hdrtv_tpu_torch.ops.megakernel import _sft_t_rows

    c, cc = 128, 64
    stream = torch.cuda.current_stream().cuda_stream
    pairs = []
    for ci, co in ((16, 16), (16, 32), (16, 16), (16, 32)):
        pairs.append((torch.as_tensor(w_s2d_1x1(rng.randn(1, 1, ci, co).astype(np.float32) * 0.05)[0, 0],
                                      device=dev),
                      torch.as_tensor(np.tile(rng.randn(co) * 0.1, 4).astype(np.float32), device=dev)))
    ptrs = native.pointer_array([p for pair in pairs for p in pair])
    for name, h, w, up, asym in (("tail_w8a8 L0 + up_coarse", 540, 960, True, False),
                                 ("sft_conv3_w8a8 L0", 540, 960, False, False),
                                 ("sft_conv3_w8a8 L0, asymmetric", 540, 960, False, True),
                                 ("sft_conv3_w8a8 L2", 135, 240, False, False)):
        x = torch.rand(h, w, c, device=dev) - 0.3
        cond = torch.rand(h, w, cc, device=dev) - 0.3
        add = torch.rand(h // 2, w // 2, 4 * c, device=dev) - 0.3 if up else None
        tt = _sft_t_rows(x, cond, pairs, torch.float32)
        lo, hi = float(tt.min()), float(tt.max())
        del tt
        s, z, pad = ((hi - lo) / 255.0, lo, -128) if asym else (max(abs(lo), abs(hi)) / 127.0, 0.0, 0)
        codes = torch.empty(h, w, c, dtype=torch.int8, device=dev)
        phases = torch.zeros(3 * 132 * 8, dtype=torch.int64, device=dev)
        for _ in range(3):  # warm: the last run's sums are read
            rc = lib.hdrtv_sm90_sft_q8_f32_phases(x.data_ptr(), None if add is None else add.data_ptr(), int(up),
                                                  cond.data_ptr(), codes.data_ptr(), ptrs, h, w, c, cc, s, z, pad,
                                                  phases.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"sft_q8_f32 {name}: CUDA error {rc}")
        _report(f"{name} fp32 SFT pass, int8-output mode", phases, SFT_Q8_F32_PHASES, steps=False)


def last_f32_phases(lib, dev, rng) -> None:
    """The fp32 s2d tail's conv_last tile at the 1080p shape (540 × 960 s2d
    pixels, h 128 fp32 channels → 12, seeded w_s2d_s1 weight), packed and
    unpacked, per warp (eight a block), its phases named as the bf16
    tile's."""
    from hdrtv_tpu_torch.models.s2d import w_s2d_s1
    from hdrtv_tpu_torch.ops.megakernel import conv_last_walk

    hb, wb = 540, 960
    h = torch.clamp_min(torch.rand(hb, wb, 128, device=dev) - 0.3, 0.0)
    w = torch.as_tensor(w_s2d_s1(rng.randn(3, 3, 32, 3).astype(np.float32) * 0.03), device=dev)
    b = torch.as_tensor((rng.randn(12) * 0.02).astype(np.float32), device=dev)
    skip = torch.rand(hb, wb, 12, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for pack in (1, 0):
        out = torch.empty((hb, 2, wb, 6), dtype=torch.uint16, device=dev) if pack else torch.empty(hb, wb, 12,
                                                                                                   device=dev)
        phases = torch.zeros(132 * 8 * 8, dtype=torch.int64, device=dev)
        for _ in range(3):  # warm: the last run's sums are read
            rc = lib.hdrtv_conv_last_f32_phases(h.data_ptr(), w.data_ptr(), b.data_ptr(), skip.data_ptr(),
                                                out.data_ptr(), hb, wb, pack, conv_last_walk(), phases.data_ptr(),
                                                stream)
            if rc:
                raise RuntimeError(f"conv_last fp32: CUDA error {rc}")
        _report(f"conv_last fp32 tile (1080p, {'packed' if pack else 'unpacked'}), per warp", phases,
                LAST_PHASES["sm90"])


AGCM_F32_PHASES = ["total", "next A", "step 0", "hidden 0", "step 1", "hidden 1", "step 2", "out"]
IN_CONV_F32_PHASES = ["total", "halo", "gather A", "products", "wait store", "epilogue"]


def head_f32_phases(lib, dev, rng) -> None:
    """The fp32 s2d head's two 3×TF32 tiles at the 1080p frame (540 × 960
    s2d pixels as u8 pair planes), seeded s2d weights through
    agcm_head_pack_s2d in fp32: the AGCM pass per warpgroup, then the input
    conv over its output per block."""
    from hdrtv_tpu_torch.models.s2d import w_s2d_1x1, w_s2d_s1
    from hdrtv_tpu_torch.ops.megakernel import _head_slots_table, agcm_head_pack_s2d

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    hb, wb = 540, 960
    aw = [t(w_s2d_1x1(rng.randn(1, 1, ci, co).astype(np.float32) * 0.1)[0, 0]) for ci, co in ((3, 64), (64, 64), (64, 3))]
    w_in = t(np.concatenate([w_s2d_s1(rng.randn(3, 3, 3, co).astype(np.float32) * 0.1) for co in (32, 64)], axis=-1))
    w1, w2, w3, win, bin_ = agcm_head_pack_s2d(*aw, w_in, t(rng.randn(384) * 0.1), n_first=128)
    b = [t(np.tile(rng.randn(n) * 0.1, 4)) for n in (64, 64, 3)]
    mods = t(rng.randn(6, 256) * 0.1)
    xs = torch.as_tensor((rng.rand(hb, 2, wb, 6) * 255).astype(np.uint8), device=dev)
    y = torch.empty(hb, wb, 12, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    phases = torch.zeros(132 * 4 * 8, dtype=torch.int64, device=dev)
    for _ in range(3):  # warm: the last run's sums are read
        rc = lib.hdrtv_sm90_agcm_f32_phases(xs.data_ptr(), 2, 1.0 / 255.0, mods.data_ptr(), 256, w1.data_ptr(),
                                            b[0].data_ptr(), w2.data_ptr(), b[1].data_ptr(), w3.data_ptr(),
                                            b[2].data_ptr(), y.data_ptr(), hb, wb, phases.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"agcm_tf32x3: CUDA error {rc}")
    _report("agcm_tf32x3 (1080p, u8 pair planes), per warpgroup", phases, AGCM_F32_PHASES, steps=None)
    fea = torch.empty(hb, wb, 128, device=dev)
    c0 = torch.empty(hb, wb, 256, device=dev)
    phases = torch.zeros(132 * 8, dtype=torch.int64, device=dev)
    for _ in range(3):
        rc = lib.hdrtv_sm90_in_conv_f32_phases(y.data_ptr(), win.data_ptr(), bin_.data_ptr(), _head_slots_table(),
                                               fea.data_ptr(), c0.data_ptr(), hb, wb, phases.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"in_conv_tf32x3: CUDA error {rc}")
    _report("in_conv_tf32x3 (1080p), per block", phases, IN_CONV_F32_PHASES, steps=False)


PARTS = ("conv", "agcm", "s8", "s8_s2", "last", "pool", "chain", "sft_f32", "sft_q8_f32", "last_f32", "head_f32")


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PARTS),
                    help=f"comma-separated parts to time, of {', '.join(PARTS)} (default: all)")
    only = set(ap.parse_args().only.split(","))
    if not only <= set(PARTS):
        raise SystemExit(f"--only takes {', '.join(PARTS)}, got {sorted(only - set(PARTS))}")
    if not torch.cuda.is_available():
        raise SystemExit("sm90_phases needs a CUDA device")
    lib = build()
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)

    conv_shapes = (("bf16", SHAPES_BF16), ("f32", [(*shape, False) for shape in SHAPES_F32]))
    for dtype, shapes in conv_shapes if "conv" in only else ():
        tdt = torch.bfloat16 if dtype == "bf16" else torch.float32

        def t(a, _dt=tdt):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev).to(_dt)

        for name, s, hb, wb, c, co, a_sub, out_f32 in shapes:
            tf = w_s2d_s1_ps if s == 1 else w_s2d_s2
            w = t(np.concatenate([tf(rng.randn(3, 3, c // 4, co // (4 * a_sub)).astype(np.float32) * 0.05)
                                  for _ in range(a_sub)], axis=-1) if a_sub else rng.randn(3, 3, c, co) * 0.05)
            x = t(rng.rand(hb, wb, c))
            b = torch.zeros(co, device=dev)
            y = torch.empty(hb // s, wb // s, co, device=dev, dtype=torch.float32 if out_f32 else tdt)
            phases = torch.zeros(2 * 132 * 8 * 8, dtype=torch.int64, device=dev)
            table, per_list = sm90_table(name, s, a_sub, c, co, c, dtype=tdt, dense_tf32x3=not a_sub)
            stream = torch.cuda.current_stream().cuda_stream
            for _ in range(3):  # warm: the last run's sums are read
                rc = lib.hdrtv_sm90_phases(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), hb, wb, c, 0,
                                           c, co, s, a_sub, table, per_list, int(dtype == "f32"), int(out_f32),
                                           0, phases.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"{name} {dtype}: CUDA error {rc}")
            torch.cuda.synchronize()
            d = phases.view(-1, 8).cpu().numpy()
            d = d[d[:, 0] > 0]
            mean = d.mean(axis=0)
            shares = {k: f"{mean[i]:.0f} ({mean[i] / mean[0]:.0%})" for i, k in enumerate(PHASES[dtype])}
            print(f"{name} {dtype}: {len(d)} warpgroups, {mean[7]:.0f} steps each; cycles {shares}", flush=True)
    for part, fn in (("agcm", agcm_phases), ("s8", s8_phases), ("s8_s2", s8_s2_phases), ("last", last_phases),
                     ("pool", pool_phases), ("chain", chain_phases), ("sft_f32", sft_f32_phases),
                     ("sft_q8_f32", sft_q8_f32_phases), ("last_f32", last_f32_phases), ("head_f32", head_f32_phases)):
        if part in only:
            fn(lib, dev, rng)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
