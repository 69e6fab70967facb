"""Fused 3×3 block convolution (port of ``hdrtv_tpu/ops/conv_kernels.py``
``fused_block_conv3``).

A 3×3 'same' conv over an s2d block tensor (Hb, Wb, C) → (Hb, Wb, Co), HWIO
weights, with bias, optional residual skip and optional ReLU fused:
``relu(conv(x) + b + skip)``. On CUDA tensors it launches
``csrc/block_conv3.cu``; on CPU tensors it runs the plain version.
Activations, weights and skip are float32 or bfloat16 (one type per call),
the bias float32; the sum is fp32 either way and rounds once, on store.
With ``qargs`` (an ``ops/w8a8.py`` ``QArgs``) it is the native-int8 (W8A8)
body: x quantized per tensor, int8 × int8 → int32 tap sums rescaled per
output channel (``csrc/block_conv3.cu`` ``block_conv3_w8a8``). With
``pool_out`` the 2×2 max pool of the result (after the ReLU) is taken in the
kernel's epilogue, in any of the three forms, and the output is
(Hb/2, Wb/2, Co) (``block_conv3_pool``).

``a_sub`` has the JAX kernel's meaning: ≥ 1 declares the weight
s2d-structured (``models/s2d.py w_s2d_s1``, its PS fold, or ``a_sub`` such
blocks side by side along Co), and the float form then multiplies only the 9
non-zero (tap, input sub-position) slots of each output sub-position
(``models/s2d.py s2d_slots``): bf16 on the Hopper tile of
``csrc/conv3x3_sm90.cuh``, fp32 on its 3×TF32 sibling
``csrc/conv3x3_tf32x3.cuh`` (each product split into three TF32 products on
the tensor cores, fp32-accurate). Exact, since the skipped products are
exact zeros. 0 is the dense product, right for any weight: bf16 on the same
Hopper tile, fp32 on the FMA tile of ``csrc/conv3x3.cuh``. The int8 form
with ``a_sub`` = 1 (the bf16 int8 programs' up_conv2.0 and up_conv3.0, C =
128 → Co = 512, and in fp32 all twelve calls of the int8 fp32 program, C =
128 → 128 or 512) quantizes x once and runs the wgmma s8 tile of
``csrc/conv3x3_s8_sm90.cuh`` over the same slot table
(:func:`s8_sm90_table`; other widths raise), in fp32 through its
fp32-output epilogue; ``a_sub`` = 0 stays dense (the same result on such
weights), and so do the plain versions, which hold the skip to account.
``pool_out`` with ``a_sub`` ≥ 1 takes the unpooled call's table and tile,
each with a pooled epilogue (bf16, 3×TF32, and the s8 tile after the
quantize pass in either type); a shape that tile refuses raises on the CPU
as on the card. ``pool_out`` with ``a_sub`` = 0 keeps the older tiles of
``csrc/conv3x3.cuh`` and ``csrc/conv3x3_s8.cuh``. :func:`conv_chunks` is
the K walk the tiles take, shared with ``ops/megakernel.py fused_down2``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hdrtv_tpu_torch.models.layers import conv_nhwc
from hdrtv_tpu_torch.ops import native
from hdrtv_tpu_torch.ops.w8a8 import QArgs, _taps_conv_q, check_qargs


CHUNK = 32  # input channels of one K chunk of csrc/conv3x3_sm90.cuh (kSm90BK)
TABLE_MAX = 288  # chunk entries one launch of it takes (kSm90MaxChunks)
# Chunks of one list whose split fp32 weights stay resident in the 3×TF32
# tile's shared memory (csrc/conv3x3_tf32x3.cuh kTf32MaxList): C ≤ 256 with a_sub.
TF32X3_LIST_MAX = 18


def check_a_sub(name: str, a_sub: int, c: int, co: int) -> None:
    """``a_sub`` shapes that divide, on the CPU as on the card: C into four
    input sub-positions, Co into ``a_sub`` blocks of four output ones."""
    if a_sub < 0 or (a_sub and (c % 4 or co % (4 * a_sub))):
        raise ValueError(f"{name}: a_sub={a_sub} needs C % 4 == 0 and Co % (4·a_sub) == 0, got C={c}, Co={co}")


def conv_chunks(stride: int, a_sub: int, c: int) -> list[list[tuple[int, int]]]:
    """The K walk of the Hopper tile over a window of ``c`` input channels,
    in its order: chunks (tap, c0), each the CHUNK channels [c0, c0 + CHUNK)
    of the window at that tap (tap = 3·dI + dJ). ``a_sub`` = 0: one list,
    every tap and chunk (the dense product). ``a_sub`` ≥ 1: four lists, one
    per output sub-position, over its 9 slots of ``s2d_slots(stride)``."""
    if not a_sub:
        return [[(tap, c0) for tap in range(9) for c0 in range(0, c, CHUNK)]]
    from hdrtv_tpu_torch.models.s2d import s2d_slots  # models/s2d.py imports this module

    ci = c // 4
    return [[(tap, si * ci + c0) for tap, si in slots for c0 in range(0, ci, CHUNK)]
            for slots in s2d_slots(stride)]


@functools.lru_cache(maxsize=64)
def sm90_table(name: str, stride: int, a_sub: int, c: int, co: int, cf: int, ch0: int = 0,
               dtype: torch.dtype = torch.bfloat16, *, dense_tf32x3: bool = False):
    """What a float call in ``dtype`` hands the Hopper tile (bf16) or its
    3×TF32 sibling (fp32): the chunk table (a ctypes int array, entry tap |
    c0 << 4, the lists back to back) and the length of one list. The tiles
    take slots of a multiple of CHUNK channels, N tiles of 32 inside one
    output sub-position (Co, or Co/(4·a_sub), a multiple of 32), 16-byte
    aligned pixels and window (pitch ``cf`` and ``ch0`` whole 16-byte groups:
    multiples of 8 in bf16, 4 in fp32) and at most TABLE_MAX entries
    (9·C/CHUNK); the fp32 tile at most TF32X3_LIST_MAX of them a list. A
    shape a tile refuses raises for ``a_sub`` ≥ 1. The dense product gets
    (None, 0) where the bf16 tile refuses it, which the mma.sync tile of
    csrc/conv3x3.cuh then runs, and in fp32 (the FMA tile there), unless
    the call asks for the 3×TF32 tile's dense table with ``dense_tf32x3``
    (trunk3's convs, C = 32: one list of 9 chunks), which raises where that
    tile refuses the shape. Cached: a frame asks for the same few tables at
    every call."""
    f32 = dtype == torch.float32
    if f32 and not a_sub and not dense_tf32x3:
        return None, 0
    kc, n = (c // 4, co // (4 * a_sub)) if a_sub else (c, co)
    group = 4 if f32 else 8
    per_list = 9 * kc // CHUNK
    if (kc % CHUNK or n % 32 or cf % group or ch0 % group or 9 * c // CHUNK > TABLE_MAX
            or (f32 and per_list > TF32X3_LIST_MAX)):
        if a_sub:
            tile = "3×TF32 Hopper tile" if f32 else "Hopper tile"
            most = TF32X3_LIST_MAX * CHUNK * 4 // 9 if f32 else TABLE_MAX // 9 * CHUNK
            raise ValueError(f"{name}: the {tile} takes a_sub={a_sub} with C/4 a multiple of {CHUNK}, "
                             f"C ≤ {most}, Co/(4·a_sub) a multiple of 32 and the pixel pitch and window "
                             f"start multiples of {group}, got C={c}, Co={co}, pitch {cf}, ch0={ch0}")
        if f32 and dense_tf32x3:
            raise ValueError(f"{name}: the 3×TF32 Hopper tile takes the dense product with C a multiple of "
                             f"{CHUNK}, C ≤ {TF32X3_LIST_MAX * CHUNK // 9}, Co a multiple of 32 and the pixel "
                             f"pitch and window start multiples of {group}, got C={c}, Co={co}, pitch {cf}, "
                             f"ch0={ch0}")
        return None, 0
    chunks = conv_chunks(stride, a_sub, c)
    entries = [tap | c0 << 4 for group_ in chunks for tap, c0 in group_]
    return (ctypes.c_int * len(entries))(*entries), len(chunks[0])


# What the wgmma s8 tile takes (csrc/conv3x3_s8_sm90.cuh), by stride: (C, the a_sub values,
# the output channels of its N tile, of which each sub-position's Co/(4·a_sub) is a multiple):
# natural 32 channels (the trunk, HR and up convs) at stride 1, natural 64 (the CondNet down
# convs, one block or the consolidated conv's three) at stride 2.
S8_SM90 = {1: (128, (1,), CHUNK), 2: (256, (1, 3), 2 * CHUNK)}


def s8_sm90_table(name: str, a_sub: int, c: int, co: int, stride: int = 1):
    """What an int8 call with ``a_sub`` ≥ 1 hands the wgmma s8 tile of
    csrc/conv3x3_s8_sm90.cuh: the slot table of ``stride`` (``sm90_table``,
    a chunk is 32 channels in either type) and its list length. The tile
    takes, at stride 1, ``a_sub`` = 1 with C = 128 and Co a multiple of 128
    (N tiles of 32 inside each output sub-position); at stride 2 (down2's
    int8 body), ``a_sub`` 1 or 3 with C = 256 and Co/(4·a_sub) a multiple of
    64 (N tiles of 64); anything else raises."""
    if stride not in S8_SM90:
        raise ValueError(f"{name}: the wgmma s8 tile has stride 1 or 2, got {stride}")
    want_c, subs, bn = S8_SM90[stride]
    if a_sub not in subs or c != want_c or co % (4 * a_sub * bn):
        raise ValueError(f"{name}: the wgmma s8 tile takes a_sub={' or '.join(map(str, subs))} with C = {want_c} "
                         f"and Co/(4·a_sub) a multiple of {bn} at stride {stride}, got a_sub={a_sub}, C={c}, "
                         f"Co={co}")
    return sm90_table(name, stride, a_sub, c, co, c)


def _epilogue(y, dtype, relu, skip, pool_out):
    """+ skip, relu, the 2×2 max pool, in fp32; one rounding to ``dtype``
    (rounding is monotonic: the max of the rounded values is the rounded
    max, as the Pallas body pools before its cast)."""
    if skip is not None:
        y = y + skip.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    if pool_out:
        h, w, co = y.shape
        y = y.reshape(h // 2, 2, w // 2, 2, co).amax(dim=(1, 3))
    return y.to(dtype)


def fused_block_conv3_ref(x, w, b, *, relu=False, skip=None, pool_out=False):
    """Plain version: conv + b, then + skip, then relu, then the 2×2 max
    pool with ``pool_out``, in fp32; one rounding to ``x.dtype`` at the end."""
    y = conv_nhwc(x[None].float(), w.float(), b.float(), padding=1)[0]
    return _epilogue(y, x.dtype, relu, skip, pool_out)


def fused_block_conv3_q_ref(x, qa: QArgs, *, relu=False, skip=None, pool_out=False):
    """Plain version of the int8 body (conv_kernels.py:180-227): x widened
    to fp32 and quantized (out-of-image taps carry the pad code), the exact
    int32 sum scaled, + the folded bias, + skip, relu, the pool, one
    rounding."""
    return _epilogue(_taps_conv_q(x.float(), qa), x.dtype, relu, skip, pool_out)


def fused_block_conv3(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    relu: bool = False,
    skip: torch.Tensor | None = None,
    qargs: QArgs | None = None,
    pool_out: bool = False,
    a_sub: int = 0,
) -> torch.Tensor:
    """3×3 'same' conv over (Hb, Wb, C) with fused bias/ReLU/skip; ``w`` is
    (3, 3, C, Co). The kernel takes C a multiple of 16 and Co of 4 (the s2d
    callers route C, Co multiples of 128 here). ``qargs``: the layer's int8
    parameters, prepared at load from this ``w`` and ``b``; the int8 body
    reads them in place of ``w`` and ``b`` (C % 64, Co % 8 on the card; with
    ``a_sub`` ≥ 1 the wgmma s8 tile's C = 128, Co % 128).
    ``pool_out``: the 2×2 max pool of the result, (Hb/2, Wb/2, Co); Hb and Wb
    must be even, as in the JAX kernel. ``a_sub``: 0 or the number of
    s2d-structured blocks along Co (1; 2 for the consolidated input conv):
    the float form, and the int8 and pooled forms where their tiles take the
    shape, then skip the weight's structural zeros (see the module
    docstring)."""
    hb, wb, c = x.shape
    co = w.shape[-1]
    dt = native.element_type("block_conv3 x", x)
    native.check_params("block_conv3", dt, [w], [b])
    check_a_sub("block_conv3", a_sub, c, co)
    if pool_out and (hb % 2 or wb % 2):
        raise ValueError(f"pool_out needs even input dims, got {hb}x{wb}")
    table, per_group = None, 0
    if pool_out and a_sub:
        # the unpooled call's table and tile; a shape that tile refuses raises here, on the CPU too
        table, per_group = (sm90_table("block_conv3", 1, a_sub, c, co, c, dtype=dt) if qargs is None
                            else s8_sm90_table("block_conv3", a_sub, c, co))
    tensors = (x, w, b) if skip is None else (x, w, b, skip)
    cpu = native.on_cpu(*tensors)
    if qargs is not None:
        check_qargs("block_conv3", qargs, c, co, not cpu)
    if cpu:
        if qargs is not None:
            return fused_block_conv3_q_ref(x, qargs, relu=relu, skip=skip, pool_out=pool_out)
        return fused_block_conv3_ref(x, w, b, relu=relu, skip=skip, pool_out=pool_out)
    if c % 16 or co % 4 or (qargs is not None and (c % 64 or co % 8)):
        raise ValueError(f"block_conv3 needs C % 16 == 0 and Co % 4 == 0 (int8: C % 64 and Co % 8), "
                         f"got C={c} Co={co}")
    if qargs is None and not pool_out:
        table, per_group = sm90_table("block_conv3", 1, a_sub, c, co, c, dtype=dt)
    elif not pool_out and a_sub:
        table, per_group = s8_sm90_table("block_conv3", a_sub, c, co)
    native.check_cuda("block_conv3 x", x, dt)
    native.check_cuda("block_conv3 w", w, dt, (3, 3, c, co))
    native.check_cuda("block_conv3 b", b, torch.float32, (co,))
    if skip is not None:
        native.check_cuda("block_conv3 skip", skip, dt, (hb, wb, co))
    out = torch.empty((hb // 2, wb // 2, co) if pool_out else (hb, wb, co), dtype=dt, device=x.device)
    # the int8 form's scratch: x's codes
    codes = None if qargs is None else torch.empty((hb, wb, c), dtype=torch.int8, device=x.device)
    counter = "block_conv3" + ("_pool" if pool_out else "") + ("" if qargs is None else "_w8a8")
    native.launch(
        "block_conv3", dt,
        x.data_ptr(), w.data_ptr(), b.data_ptr(), native.quant_params(qargs),
        None if skip is None else skip.data_ptr(), out.data_ptr(),
        None if codes is None else codes.data_ptr(),
        hb, wb, c, co, int(relu), int(pool_out), a_sub, table, per_group, native.stream_of(x),
        counter=counter,
    )
    return out
