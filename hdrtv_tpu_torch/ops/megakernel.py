"""Fused s2d-domain kernels (port of the ``hdrtv_tpu/ops/megakernel.py``
kernels on the frame programs: the L0 megakernels ``fused_agcm_head``,
``fused_cond_chain`` and ``fused_tail``, the HG composite's
``fused_hg_tail``, and ``fused_down2``, ``fused_trunk3``,
``fused_sft_conv3_v2``, ``fused_resblock`` and ``fused_mix_chain``).

Each function takes the JAX kernel's arguments and layouts. On CUDA tensors
it launches the kernel of ``csrc/``; on CPU tensors it runs the plain
version beside it. Activations and weights are float32 or bfloat16 (one
element type per call, that of the activations); biases are float32.

In bfloat16 the rounding points are the contract: each plain version rounds
exactly where the Pallas *kernel body* casts to the compute dtype (which is
not always where the JAX ``*_ref`` beside it does), and the CUDA kernels
round at the same places. Sums are fp32 everywhere.

``fused_sft_conv3_v2``, ``fused_resblock`` and ``fused_tail`` also take the
native-int8 (W8A8) forms of their 3×3 convs (``qargs``, ``ops/w8a8.py``
``QArgs``), as the Pallas kernels' ``quant`` bodies do: the SFT output t is
quantized from fp32, never rounded to the element type first, and the conv
is an exact int32 tap sum rescaled per output channel. ``fused_down2``
takes its int8 body too (``qargs``, one ``QArgs`` per branch of the
consolidated CondNet down conv; the frame programs pass it under
``HDRTV_INT8_DOWN2=1`` only, as the JAX package does), and
``fused_cond_chain`` its int8 steps (``qargs``, a list of five ``QArgs`` or
None in the 1×1 form; no frame program passes them, as in the JAX package;
with ``s2d`` on the row tile of ``csrc/chain_sm90.cuh``, in fp32 its 3×TF32
instance ``csrc/chain_tf32x3.cuh``).

``fused_agcm_head``, ``fused_cond_chain``, ``fused_tail``,
``fused_sft_conv3_v2``, ``fused_resblock`` and ``fused_mix_chain`` take
``s2d``: the caller's declaration that the weights are the s2d transforms
the frame programs hand them, whose zeros the bf16 float forms then skip on
the Hopper tiles (``csrc/chain_sm90.cuh``, ``csrc/conv3x3_sm90.cuh``, and
the head's input conv in ``csrc/agcm_head.cu``). The plain versions honour
it, so a weight without that structure gives another result than the JAX
kernel's. The int8 bodies of ``fused_tail``, ``fused_sft_conv3_v2`` and
``fused_resblock`` take it too: in bf16 their SFT passes run the row tile's
int8-output mode and their convs the wgmma s8 tile of
``csrc/conv3x3_s8_sm90.cuh``, which also runs ``fused_down2``'s int8 body in
bf16 at stride 2 (its ``a_sub`` ≥ 1 being the same declaration). In fp32
the float bodies of ``fused_sft_conv3_v2`` and ``fused_resblock`` run their
SFT passes on the row tile's 3×TF32 instance (``csrc/sft_tf32x3.cuh``) and
their convs on the 3×TF32 conv tile (``csrc/conv3x3_tf32x3.cuh``), and so
does the fp32 float tail, whose conv_last runs its fp32 tile
(``csrc/conv_last.cuh``, 3×TF32 on mma.sync); ``fused_agcm_head`` in fp32
runs its AGCM pass and input conv on 3×TF32 tiles (``csrc/agcm_tf32x3.cuh``,
``csrc/agcm_head.cu``). The fp32 int8 bodies of ``fused_tail`` and
``fused_sft_conv3_v2`` run their SFT passes in the int8-output mode of
``csrc/sft_tf32x3.cuh`` (fp32 FMA chains in the plain version's order, the
codes written from registers) and their convs on the wgmma s8 tile's
fp32-output epilogue, the tail's conv_last on its fp32 tile;
``fused_resblock``'s fp32 int8 body keeps the dense kernels.
``fused_trunk3`` runs natural tensors; both its instances run the Hopper
tiles on any weights (fp32 the 3×TF32 tile, dense).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hdrtv_tpu_torch.models.layers import conv_nhwc, leaky_relu
from hdrtv_tpu_torch.ops import native
from hdrtv_tpu_torch.ops.conv_kernels import check_a_sub, s8_sm90_table, sm90_table
from hdrtv_tpu_torch.ops.w8a8 import QArgs, _dense_q, _quantize_act, _taps_conv_q, check_qargs

_ACTS = {None: 0, "relu": 1, "lrelu": 2}


def _apply_act(v: torch.Tensor, act: str | None) -> torch.Tensor:
    if act == "relu":
        return torch.clamp_min(v, 0.0)
    if act == "lrelu":
        return leaky_relu(v, 0.1)
    return v


def _rounded(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 ``v`` as a store in ``dtype`` and a load back would leave it."""
    return v if dtype == torch.float32 else v.to(dtype).float()


def _conv_same(t: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3×3 'same' conv of fp32 ``t`` (H, W, C), fp32 sum, then + fp32 bias."""
    return conv_nhwc(t[None], w.float(), None, padding=1)[0] + b


def pick_rows(hb: int, limit: int = 12, minimum: int = 3) -> int:
    """Largest divisor of ``hb`` in [minimum, limit], else ``hb``: the JAX
    package's rows-per-grid-step picker. Kept, like :func:`pick_rows_even`,
    only so that ``models/s2d.py`` routes a frame size as the TPU program
    does."""
    for cand in range(min(limit, hb), minimum - 1, -1):
        if hb % cand == 0:
            return cand
    return hb


def pick_rows_even(hb: int, limit: int = 12) -> int:
    """Largest even divisor of ``hb`` ≤ limit (0 if none): the JAX package's
    tile-row picker for its two-row-halo kernels. The CUDA kernels take any
    height; ``models/s2d.py`` keeps this rule only to route as the TPU
    program does."""
    for cand in range(min(limit, hb) // 2 * 2, 1, -2):
        if hb % cand == 0:
            return cand
    return 0


def _window(name: str, cf: int, cin: int | None, ch0: int) -> int:
    c = cin if cin is not None else cf
    if ch0 % c or ch0 + c > cf:
        raise ValueError(f"{name}: channel window [{ch0}, {ch0 + c}) must be window-aligned inside {cf}")
    return c


# ---------------------------------------------------------------------------
# AGCM + LE input conv
# ---------------------------------------------------------------------------

_CIN = 12  # s2d channels of an RGB frame: what the head kernel is built for


def _s2d_of_pairs(xs: torch.Tensor) -> torch.Tensor:
    """(Hb, 2, Wb, 6) row-pair planes → (Hb, Wb, 12): the s2d channels are
    the two row parities side by side, channel 6a + m = xs[i, a, j, m]."""
    return torch.cat([xs[:, 0], xs[:, 1]], dim=-1) if xs.ndim == 4 else xs


def fused_agcm_head_ref(xs, mods, aw1, ab1, aw2, ab2, aw3, ab3, w_in, b_in, *, n_first, scale=1.0, s2d=False):
    """Plain version, the body of the Pallas ``_agcm_head_kernel``: the frame
    is widened to fp32, scaled, then rounded to the element type (that of the
    weights) before the first product; each modulation ``v·(s+1)+sh`` is fp32
    with the fp32 ``mods``; a, b and the AGCM result are each rounded to the
    element type; the AGCM result is zero outside the image (the 'same'
    padding of the input conv, applied after the modulation); the conv sums in
    fp32, adds the fp32 bias, and the ReLU / leaky ReLU (slope 0.1 in fp32)
    halves are rounded once on store. ``s2d``: the 1×1s multiply their
    weights' first diagonal blocks only (:func:`_rows_1x1`; ``mods`` are taken
    per sub-position as given) and the conv only the populated s2d slots of
    each of ``w_in``'s two parts, split at ``n_first`` (:func:`_s2d_slots_only`),
    as the kernel's s2d form does."""
    dt = aw1.dtype
    x = _s2d_of_pairs(xs)
    hb, wb, cin = x.shape
    v = x.reshape(-1, cin).float() * scale

    def mod(v, row, width):
        return v * (mods[row, :width] + 1.0) + mods[row + 1, :width]

    def lin(v, w, b):
        if s2d:
            return _rows_1x1(_rounded(v, dt), w, b)
        return torch.matmul(_rounded(v, dt), w.float()) + b

    a = torch.clamp_min(mod(lin(v, aw1, ab1), 0, aw1.shape[1]), 0.0)
    b = torch.clamp_min(mod(lin(a, aw2, ab2), 2, aw2.shape[1]), 0.0)
    agcm = mod(lin(b, aw3, ab3), 4, cin).to(dt).reshape(hb, wb, cin)
    if s2d:
        w_in = torch.cat([_s2d_slots_only(w_in[..., :n_first]), _s2d_slots_only(w_in[..., n_first:])], dim=-1)
    acc = _conv_same(agcm.float(), w_in, b_in)
    fea = torch.clamp_min(acc[..., :n_first], 0.0).to(dt)
    c0 = _apply_act(acc[..., n_first:], "lrelu").to(dt)
    return fea, c0, agcm


def agcm_head_pack(aw1: torch.Tensor, aw3: torch.Tensor, w_in: torch.Tensor) -> tuple:
    """What csrc/agcm_head.cu reads in place of ``aw1``, ``aw3`` and ``w_in``:
    ``aw1`` with its 12 rows padded to 16, ``aw3`` with its 12 columns padded
    to 16, and ``w_in`` as one (9·12 → 112, Co) matrix, taps in (dI, dJ)
    row-major order then channel; the padding is zero. It depends on the
    parameters only: build it once at load and pass it as ``packed``."""
    cin, co = w_in.shape[2], w_in.shape[3]
    aw1p = aw1.new_zeros((16, aw1.shape[1]))
    aw1p[:cin] = aw1
    aw3p = aw3.new_zeros((aw3.shape[0], 16))
    aw3p[:, :cin] = aw3
    wcat = w_in.new_zeros((112, co))
    wcat[: 9 * cin] = w_in.reshape(9 * cin, co)
    return aw1p, aw3p, wcat


# The natural widths the s2d head of csrc/agcm_head.cu is built for: AGCM
# 3 → 64 → 64 → 3 and the input conv 3 → 32 ‖ 64 (fea ‖ c0).
AGCM_S2D_WIDTHS = (3, 64, 64, 32, 64)


def _head_slots():
    """The 36 slot entries the s2d head's input conv reads: output
    sub-position so's 9 (tap, si) of ``models/s2d.py s2d_slots(1)`` at
    [9·so, 9·so + 9), each tap | si << 4."""
    from hdrtv_tpu_torch.models.s2d import s2d_slots  # models/s2d.py imports this module

    return [tap | si << 4 for slots in s2d_slots(1) for tap, si in slots]


@functools.lru_cache(maxsize=1)
def _head_slots_table() -> ctypes.Array:
    """:func:`_head_slots` as the kernel takes it (a ctypes int array)."""
    slots = _head_slots()
    return (ctypes.c_int * len(slots))(*slots)


def agcm_head_pack_s2d(aw1, aw2, aw3, w_in, b_in, *, n_first: int) -> tuple:
    """What the s2d form of csrc/agcm_head.cu reads in place of the weights
    (``s2d=True`` in bf16): the three AGCM 1×1s' first diagonal blocks,
    ``aw1``'s (C/4, C1/4) padded with zero rows to 16, ``aw2``'s, and
    ``aw3``'s (C2/4, 3) padded with zero columns to 16; then the input conv
    gathered per output sub-position so, (4, 32, Cf/4 + Cc/4): row 3·k + c is
    channel c of so's k-th slot (tap, si) of ``s2d_slots(1)`` (rows 27 .. 31
    zero), columns so's fea block then its c0 block, and its bias likewise
    (4, Cf/4 + Cc/4), fp32. The weights keep the element type: the bf16
    pack for the bf16 tiles, the fp32 pack for their 3×TF32 instances. Pass
    the BGR-permuted ``aw1`` for a BGR frame. It depends on the parameters
    only: build it once at load and pass it as ``packed_s2d``."""
    cin, co = w_in.shape[2] // 4, w_in.shape[3]
    c1, c2 = aw1.shape[1] // 4, aw2.shape[1] // 4
    w1 = aw1.new_zeros((16, c1))
    w1[:cin] = aw1[:cin, :c1]
    w3 = aw3.new_zeros((c2, 16))
    w3[:, :cin] = aw3[:c2, :cin]
    nf, nc = n_first // 4, (co - n_first) // 4
    slots = _head_slots()
    win = w_in.new_zeros((4, 32, nf + nc))
    bin_ = b_in.new_zeros((4, nf + nc))
    for so in range(4):
        for k, e in enumerate(slots[9 * so: 9 * so + 9]):
            tap, si = e & 15, e >> 4
            rows = w_in[tap // 3, tap % 3, si * cin:(si + 1) * cin]
            win[so, 3 * k: 3 * k + cin, :nf] = rows[:, so * nf:(so + 1) * nf]
            win[so, 3 * k: 3 * k + cin, nf:] = rows[:, n_first + so * nc: n_first + (so + 1) * nc]
        bin_[so, :nf] = b_in[so * nf:(so + 1) * nf]
        bin_[so, nf:] = b_in[n_first + so * nc: n_first + (so + 1) * nc]
    return w1.contiguous(), aw2[:c1, :c2].contiguous(), w3.contiguous(), win.contiguous(), bin_.contiguous()


def fused_agcm_head(
    xs: torch.Tensor, mods: torch.Tensor,
    aw1, ab1, aw2, ab2, aw3, ab3, w_in, b_in,
    *, n_first: int, scale: float = 1.0, packed: tuple | None = None, packed_s2d: tuple | None = None,
    s2d: bool = False,
):
    """s2d frame → (fea0, c0, agcm_out): AGCM (three modulated 1×1 convs) and
    the fused LE input conv (conv_first‖cond_first.0, 3×3 'same') with its
    relu / lrelu halves split at ``n_first``.

    ``xs``: (Hb, 2, Wb, 6) row-pair planes or (Hb, Wb, 12), uint8 (pass
    ``scale=1/255``) or the element type. ``mods``: (6, ≥ 4·nf) fp32, the
    AGCM scale/shift vectors (first, HR, last) tiled over the 4 s2d
    sub-positions; the conv_last rows use the first 12 lanes. ``aw1`` (12, C1),
    ``aw2`` (C1, C2), ``aw3`` (C2, 12), ``w_in`` (3, 3, 12, Cf + Cc) in the
    element type (which is also the outputs'); biases fp32. ``packed``:
    :func:`agcm_head_pack` of the same parameters, ``packed_s2d``
    :func:`agcm_head_pack_s2d`, when the caller keeps them (only the CUDA
    kernels read them, each its own form).

    ``s2d`` declares the three 1×1 weights ``w_s2d_1x1(w)``, their biases
    ``b_s2d(b)`` and ``w_in`` ``w_s2d_s1(conv_first) ‖
    w_s2d_s1(cond_first.0)``, split at ``n_first`` (``models/s2d.py``; the
    frame programs pass True): the 1×1s then multiply the (4·Hb·Wb, 3) rows
    of natural pixels by each weight's first diagonal block, modulated at
    each row's own sub-position, and the conv only the populated s2d slots
    of each part. bf16 on the card: the AGCM pass on the Hopper row tile of
    ``csrc/chain_sm90.cuh`` and the input conv on a wgmma tile over the
    slots (``csrc/agcm_head.cu``); fp32 on the card: their 3×TF32 instances
    (the AGCM pass ``csrc/agcm_tf32x3.cuh agcm_tf32x3_kernel``, the input
    conv ``csrc/agcm_head.cu in_conv_tf32x3_kernel``), reading
    ``packed_s2d`` in fp32. Either type: natural widths ``AGCM_S2D_WIDTHS``
    only (others raise). The plain version honours it too, so a weight
    without that structure gives another result than the JAX kernel's.
    False: dense, right for any weight."""
    if xs.ndim == 4:
        hb, two, wb, half = xs.shape
        if (two, 2 * half) != (2, _CIN):
            raise ValueError(f"agcm_head: pair planes are (Hb, 2, Wb, 6), got {tuple(xs.shape)}")
    else:
        hb, wb, cin = xs.shape
        if cin != _CIN:
            raise ValueError(f"agcm_head takes {_CIN} s2d channels, got {cin}")
    c1, c2, co = aw1.shape[1], aw2.shape[1], w_in.shape[-1]
    dt = native.element_type("agcm_head aw1", aw1)
    if xs.dtype not in (torch.uint8, dt):
        raise ValueError(f"agcm_head: the frame must be uint8 or {dt} like the weights, got {xs.dtype}")
    native.check_params("agcm_head", dt, [aw1, aw2, aw3, w_in], [mods, ab1, ab2, ab3, b_in])
    shapes = {"aw1": (aw1, (_CIN, c1)), "ab1": (ab1, (c1,)), "aw2": (aw2, (c1, c2)), "ab2": (ab2, (c2,)),
              "aw3": (aw3, (c2, _CIN)), "ab3": (ab3, (_CIN,)), "w_in": (w_in, (3, 3, _CIN, co)),
              "b_in": (b_in, (co,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"agcm_head {name} must have shape {shape}, got {tuple(t.shape)}")
    if mods.ndim != 2 or mods.shape[0] != 6 or mods.shape[1] < max(c1, c2, _CIN):
        raise ValueError(f"agcm_head mods must be (6, >= {max(c1, c2, _CIN)}), got {tuple(mods.shape)}")
    if not 0 < n_first < co:
        raise ValueError(f"agcm_head: n_first {n_first} must split the {co} conv outputs")
    if s2d:
        _check_s2d_1x1("agcm_head", [(aw1, ab1), (aw2, ab2), (aw3, ab3)])
        check_a_sub("agcm_head conv_first", 1, _CIN, n_first)
        check_a_sub("agcm_head cond_first.0", 1, _CIN, co - n_first)
    if native.on_cpu(xs, mods, aw1, ab1, aw2, ab2, aw3, ab3, w_in, b_in):
        return fused_agcm_head_ref(xs, mods, aw1, ab1, aw2, ab2, aw3, ab3, w_in, b_in,
                                   n_first=n_first, scale=scale, s2d=s2d)
    native.check_cuda("agcm_head xs", xs, xs.dtype)
    native.check_cuda("agcm_head mods", mods, torch.float32)
    kind = 0 if xs.dtype == dt else (2 if xs.ndim == 4 else 1)
    fea = torch.empty((hb, wb, n_first), dtype=dt, device=xs.device)
    c0 = torch.empty((hb, wb, co - n_first), dtype=dt, device=xs.device)
    agcm = torch.empty((hb, wb, _CIN), dtype=dt, device=xs.device)
    if s2d:
        widths = (_CIN // 4, c1 // 4, c2 // 4, n_first // 4, (co - n_first) // 4)
        if widths != AGCM_S2D_WIDTHS:
            raise ValueError(f"agcm_head: the s2d head takes natural widths (C, C1, C2, Cf, Cc) = "
                             f"{AGCM_S2D_WIDTHS}, got {widths}")
        if 12 * hb * wb >= 2 ** 31:
            raise ValueError(f"agcm_head: the s2d head indexes the frame in 32 bits, got {hb} × {wb} pixels")
        pk = packed_s2d if packed_s2d is not None else agcm_head_pack_s2d(aw1, aw2, aw3, w_in, b_in,
                                                                          n_first=n_first)
        nat = AGCM_S2D_WIDTHS
        for name, t, shape, tdt in (("aw1 (s2d pack)", pk[0], (16, nat[1]), dt), ("aw2 (s2d pack)", pk[1], nat[1:3], dt),
                                    ("aw3 (s2d pack)", pk[2], (nat[2], 16), dt),
                                    ("w_in (s2d pack)", pk[3], (4, 32, nat[3] + nat[4]), dt),
                                    ("b_in (s2d pack)", pk[4], (4, nat[3] + nat[4]), torch.float32),
                                    ("ab1", ab1, (c1,), torch.float32), ("ab2", ab2, (c2,), torch.float32),
                                    ("ab3", ab3, (_CIN,), torch.float32)):
            native.check_cuda(f"agcm_head {name}", t, tdt, shape)
        native.launch(
            "agcm_head_s2d", dt,
            xs.data_ptr(), kind, float(scale), mods.data_ptr(), mods.shape[1],
            pk[0].data_ptr(), ab1.data_ptr(), pk[1].data_ptr(), ab2.data_ptr(), pk[2].data_ptr(), ab3.data_ptr(),
            pk[3].data_ptr(), pk[4].data_ptr(), _head_slots_table(), fea.data_ptr(), c0.data_ptr(), agcm.data_ptr(),
            hb, wb, native.stream_of(xs), counter="agcm_head",
        )
        return fea, c0, agcm
    if c1 % 16 or c2 % 16 or co % 8 or n_first % 8:
        raise ValueError(f"agcm_head needs C1 % 16, C2 % 16, Co % 8 and n_first % 8 == 0, got {c1}, {c2}, {co}, {n_first}")
    aw1p, aw3p, wcat = packed if packed is not None else agcm_head_pack(aw1, aw3, w_in)
    for name, t, shape in (("aw1 (packed)", aw1p, (16, c1)), ("aw2", aw2, (c1, c2)),
                           ("aw3 (packed)", aw3p, (c2, 16)), ("w_in (packed)", wcat, (112, co))):
        native.check_cuda(f"agcm_head {name}", t, dt, shape)
    for name, t in (("ab1", ab1), ("ab2", ab2), ("ab3", ab3), ("b_in", b_in)):
        native.check_cuda(f"agcm_head {name}", t, torch.float32)
    native.launch(
        "agcm_head", dt,
        xs.data_ptr(), kind, float(scale), mods.data_ptr(), mods.shape[1],
        aw1p.data_ptr(), ab1.data_ptr(), aw2.data_ptr(), ab2.data_ptr(), aw3p.data_ptr(), ab3.data_ptr(),
        wcat.data_ptr(), b_in.data_ptr(), fea.data_ptr(), c0.data_ptr(), agcm.data_ptr(),
        hb, wb, c1, c2, co, n_first, native.stream_of(xs),
    )
    return fea, c0, agcm


# ---------------------------------------------------------------------------
# Condition 1×1 chain
# ---------------------------------------------------------------------------


def _rows_1x1(v: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 ``v`` (..., 4K) times a ``w_s2d_1x1`` weight (4K, 4N) plus a
    ``b_s2d`` bias, as the s2d forms take it: the (·, K) rows of natural
    pixels (the sub-position-major channels of an s2d pixel are four such
    rows) times the weight's first diagonal block, + the bias's first
    quarter. Equal to the dense product on weights of that structure, another
    result on any other."""
    k, n = w.shape[0] // 4, w.shape[1] // 4
    rows = torch.matmul(v.reshape(-1, k), w[:k, :n].float()) + b[:n]
    return rows.reshape(*v.shape[:-1], 4 * n)


def _rows_q(v: torch.Tensor, qa: QArgs) -> torch.Tensor:
    """An int8 1×1 step over ``w_s2d_1x1`` codes as the s2d forms take it:
    fp32 ``v`` (..., 4K) quantized, the codes' (·, K) rows of natural pixels
    times the weight's first diagonal block (``qa.w[:N, :K]``) as exact
    int32 sums, times the first N of yscale, + the first N of the folded
    bias. Equal to the dense step (``ops/w8a8.py _dense_q``) on such codes,
    whose other blocks are zero and whose yscale and bias repeat per
    sub-position; another result on any other."""
    k, n = qa.c // 4, qa.co // 4
    acc = _quantize_act(v, qa).reshape(-1, k).double() @ qa.w[:n, :k].double().T
    rows = acc.float() * qa.yscale[:n] + qa.bias[:n]
    return rows.reshape(*v.shape[:-1], 4 * n)


def _check_s2d_1x1(name: str, weights) -> None:
    """What ``s2d=True`` takes, on the CPU as on the card: 1×1 weights and
    biases whose widths are four sub-position blocks."""
    for w, b in weights:
        if w.shape[0] % 4 or w.shape[1] % 4 or b.shape[0] % 4:
            raise ValueError(f"{name}: s2d=True needs 1×1 widths divisible by 4, got {tuple(w.shape)} / "
                             f"{tuple(b.shape)}")


def fused_cond_chain_ref(c0, weights, qargs=None, *, s2d=False):
    """Plain version, the body of the Pallas ``_cond_chain_kernel``: the
    running value stays fp32 from step to step and is rounded to the weight's
    type at each product; sums, the fp32 bias and the leaky ReLU (all steps
    but the last) are fp32; ``c`` is the value after the second step and
    ``cond1`` the last, each rounded once on store. An int8 step (``qargs``
    entry not None) quantizes the fp32 running value itself, sums the codes'
    products exactly and rescales: yscale, then the folded bias. ``s2d``:
    each step multiplies the weight's first diagonal block only (float
    :func:`_rows_1x1`, int8 :func:`_rows_q`), as the kernel's s2d form does."""
    v = c0.float()
    c = None
    for idx, ((w, b), qa) in enumerate(zip(weights, qargs or [None] * len(weights))):
        if qa is not None:
            v = _rows_q(v, qa) if s2d else _dense_q(v, qa)
        elif s2d:
            v = _rows_1x1(_rounded(v, w.dtype), w, b)
        else:
            v = torch.matmul(_rounded(v, w.dtype), w.float()) + b
        if idx != 4:
            v = _apply_act(v, "lrelu")
        if idx == 1:
            c = v.to(c0.dtype)
    return c, v.to(c0.dtype)


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """fp32 ``v`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest on
    the low 13 bits, ties away from zero."""
    return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32x3(rows: torch.Tensor, blk: torch.Tensor, products: int = 3) -> torch.Tensor:
    """fp32 ``rows`` (M, K) times fp32 ``blk`` (K, N) as the 3×TF32 tiles sum
    it: both split into TF32 big and small halves, small·big + big·small +
    big·big summed over each 32-deep chunk of K (exact products, the chunk's
    sum rounded once to fp32: the tensor cores' order within it is not
    modelled), the chunk sums added in fp32. ``products`` = 1 keeps big·big
    alone, one TF32 product: a fault the checks must see."""
    rb, wb = _tf32(rows), _tf32(blk)
    rs, ws = _tf32(rows - rb), _tf32(blk - wb)
    acc = None
    for c32 in range(0, rows.shape[1], 32):
        sl = slice(c32, c32 + 32)
        part = rb[:, sl].double() @ wb[sl].double()
        if products == 3:
            part = part + rs[:, sl].double() @ wb[sl].double() + rb[:, sl].double() @ ws[sl].double()
        acc = part.float() if acc is None else acc + part.float()
    return acc


def _rows_tf32x3(v: torch.Tensor, w: torch.Tensor, b: torch.Tensor, products: int = 3) -> torch.Tensor:
    """:func:`_rows_1x1` as the row tile's fp32 instance (``csrc/chain_tf32x3.cuh``)
    computes it: the rows times the weight's first diagonal block by
    :func:`_mm_tf32x3`, then the bias, in fp32."""
    k, n = w.shape[0] // 4, w.shape[1] // 4
    acc = _mm_tf32x3(v.reshape(-1, k), w[:k, :n].float(), products)
    return (acc + b[:n]).reshape(*v.shape[:-1], 4 * n)


def cond_chain_tf32x3_emulation(c0, weights, qargs=None, *, products: int = 3):
    """The fp32 row tile's chain in torch ops, on s2d weights as
    ``fused_cond_chain(..., s2d=True)`` takes them: float steps
    :func:`_rows_tf32x3`, int8 steps the plain version's :func:`_rows_q`;
    returns (c, cond1) in fp32."""
    v = c0.float()
    c = None
    for idx, ((w, b), qa) in enumerate(zip(weights, qargs or [None] * len(weights))):
        v = _rows_q(v, qa) if qa is not None else _rows_tf32x3(v, w, b, products)
        if idx != 4:
            v = _apply_act(v, "lrelu")
        if idx == 1:
            c = v
    return c, v


def sft_tf32x3_emulation(x, cond, sft4, *, products: int = 3):
    """The fp32 SFT pass of ``csrc/sft_tf32x3.cuh`` in torch ops, on the
    ``w_s2d_1x1`` weights and ``b_s2d`` biases the s2d forms take: each of
    its four 16-deep products :func:`_rows_tf32x3` (one chunk from zero),
    the leaky ReLU between, then t = x·(scale + 1) + shift with the multiply
    and the add rounded apart, all fp32. ``x`` (…, 4C) is the pass's input
    (x + add already summed, or h1), ``cond`` (…, 4CC); returns t (…, 4C).
    ``products`` = 1: one TF32 product each, a fault the checks must see."""
    cond = cond.float()
    hid_s = _apply_act(_rows_tf32x3(cond, *sft4[0], products), "lrelu")
    hid_h = _apply_act(_rows_tf32x3(cond, *sft4[2], products), "lrelu")
    scale = _rows_tf32x3(hid_s, *sft4[1], products)
    shift = _rows_tf32x3(hid_h, *sft4[3], products)
    return x.float() * (scale + 1.0) + shift


def _fma_rows(v: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The rows ``v`` (M, K) times the weight's first diagonal block (K, N)
    as fp32 FMA chains, each output's products summed from zero in the order
    of K (each step ``fma(v_k, w_k, acc)``: the product exact in float64, the
    sum rounded to fp32 through float64, which a double rounding moves in
    about one step of 2^28), then + the bias's first quarter in fp32."""
    k, n = w.shape[0] // 4, w.shape[1] // 4
    blk = w[:k, :n].double()
    acc = torch.zeros(v.shape[0], n, dtype=torch.float32, device=v.device)
    for kk in range(k):
        acc = (v[:, kk:kk + 1].double() * blk[kk] + acc.double()).float()
    return acc + b[:n]


def quantize_codes_fast(t: torch.Tensor, scale: float, zero: float | None, *, fixup: bool = True) -> torch.Tensor:
    """The codes ``csrc/common.cuh quantize_code_fast`` gives fp32 ``t`` in
    float32 torch ops: a = t − z, c = a·inv clamped to the code range (inv =
    1/s rounded to fp32, the host's division), the code rint(c) (− 128 with a
    zero point); ``fixup``: where c lies in the band 0.5 − |c − rint(c)| ≤
    2^-13 around a half-integer, the IEEE division's code (``_quantize_act``),
    as the int8-output passes write those values again. Returns int8 codes.
    Without ``fixup`` (a fault) the band keeps the multiply's code."""
    lo, hi = (-128.0, 127.0) if zero is None else (0.0, 255.0)
    inv = float(torch.tensor(1.0 / scale, dtype=torch.float64).float())
    a = t.float() if zero is None else t.float() - torch.tensor(zero, dtype=torch.float32)
    c = (a * torch.tensor(inv, dtype=torch.float32)).clamp(lo, hi)
    r = torch.round(c)
    codes = r if zero is None else r - 128.0
    if fixup:
        near = ~((0.5 - (c - r).abs()) > 2.0 ** -13)
        exact = torch.round(((a.double() / scale).float())).clamp(lo, hi)
        codes = torch.where(near, exact if zero is None else exact - 128.0, codes)
    return codes.to(torch.int8)


def sft_q8_tf32x3_emulation(x, cond, sft4, qa: QArgs, *, products: int | None = None):
    """The codes the int8-output mode of ``csrc/sft_tf32x3.cuh``
    (``sft_q8_f32_kernel``) writes, in torch ops, on the ``w_s2d_1x1``
    weights and ``b_s2d`` biases the fp32 s2d tail_w8a8 and sft_conv3_w8a8
    take: the four products as fp32 FMA chains (:func:`_fma_rows`), the leaky
    ReLU between, t = x·(scale + 1) + shift with the multiply and the add
    rounded apart, then :func:`quantize_codes_fast` for the layer ``qa``.
    ``x`` (…, 4C) is the pass's input (the tail's s + d2s(up) summed in
    fp32), ``cond`` (…, 4CC); returns int8 codes (…, 4C). ``products`` 3:
    t from the float mode's 3×TF32 products (:func:`sft_tf32x3_emulation`)
    instead, what the pass would give on them; 1: one TF32 product each, a
    fault the checks must see."""
    if products is not None:
        t = sft_tf32x3_emulation(x, cond, sft4, products=products)
    else:
        c, cc = x.shape[-1] // 4, cond.shape[-1] // 4
        cd = cond.float().reshape(-1, cc)
        hid_s = _apply_act(_fma_rows(cd, *sft4[0]), "lrelu")
        hid_h = _apply_act(_fma_rows(cd, *sft4[2]), "lrelu")
        scale, shift = _fma_rows(hid_s, *sft4[1]), _fma_rows(hid_h, *sft4[3])
        t = (x.float().reshape(-1, c) * (scale + 1.0) + shift).reshape(x.shape)
    return quantize_codes_fast(t, qa.scale, qa.zero)


def agcm_tf32x3_emulation(xs, mods, aw1, ab1, aw2, ab2, aw3, ab3, *, scale=1.0, products: int = 3):
    """The fp32 AGCM pass of ``csrc/agcm_tf32x3.cuh agcm_tf32x3_kernel`` in
    torch ops, on the s2d weights ``fused_agcm_head(..., s2d=True)`` takes:
    the frame's natural rows (× ``scale``, fp32) through the three 1×1s'
    first diagonal blocks by :func:`_rows_tf32x3` (K = 3 one chunk, K = 64
    two), each + bias and modulated at its row's own sub-position (multiply
    and add rounded apart), ReLU after the first two; returns agcm (Hb, Wb,
    12) fp32. ``products`` = 1: one TF32 product each, a fault."""
    x = _s2d_of_pairs(xs)
    hb, wb, cin = x.shape
    v = x.reshape(-1, cin).float() * scale

    def mod(v, row, width):
        return v * (mods[row, :width] + 1.0) + mods[row + 1, :width]

    a = torch.clamp_min(mod(_rows_tf32x3(v, aw1, ab1, products), 0, aw1.shape[1]), 0.0)
    b = torch.clamp_min(mod(_rows_tf32x3(a, aw2, ab2, products), 2, aw2.shape[1]), 0.0)
    return mod(_rows_tf32x3(b, aw3, ab3, products), 4, cin).reshape(hb, wb, cin)


def in_conv_tf32x3_emulation(agcm, *, n_first: int, packed_s2d: tuple, products: int = 3):
    """The fp32 input conv of ``csrc/agcm_head.cu in_conv_tf32x3_kernel`` in
    torch ops: per output sub-position so, the 9 slots' 3 channels of each
    pixel's zero-padded agcm neighbourhood (27 columns, rows 3·k + c of so's
    gathered weight in ``packed_s2d``, :func:`agcm_head_pack_s2d`) times that
    weight by :func:`_mm_tf32x3` (one chunk), + so's bias, ReLU (fea) or
    leaky ReLU 0.1 (c0); returns (fea, c0) fp32."""
    hb, wb, _ = agcm.shape
    win, bin_ = packed_s2d[3], packed_s2d[4]
    nf = n_first // 4
    pad = torch.nn.functional.pad(agcm.float(), (0, 0, 1, 1, 1, 1))  # zero outside the image
    slots = _head_slots()
    outs = []
    for so in range(4):
        cols = []
        for e in slots[9 * so: 9 * so + 9]:
            tap, si = e & 15, e >> 4
            cols.append(pad[tap // 3: tap // 3 + hb, tap % 3: tap % 3 + wb, 3 * si: 3 * si + 3])
        acc = _mm_tf32x3(torch.cat(cols, dim=-1).reshape(-1, 27), win[so, :27].float(), products) + bin_[so]
        outs.append(acc.reshape(hb, wb, -1))
    acc = torch.stack(outs, dim=2)
    fea = torch.clamp_min(acc[..., :nf], 0.0).reshape(hb, wb, -1)
    c0 = _apply_act(acc[..., nf:], "lrelu").reshape(hb, wb, -1)
    return fea, c0


def agcm_head_tf32x3_emulation(xs, mods, aw1, ab1, aw2, ab2, aw3, ab3, w_in, b_in, *, n_first, scale=1.0,
                               products: int = 3):
    """``fused_agcm_head(..., s2d=True)`` in fp32 as the card runs it:
    :func:`agcm_tf32x3_emulation`, then :func:`in_conv_tf32x3_emulation` on
    its result; returns (fea, c0, agcm) fp32."""
    agcm = agcm_tf32x3_emulation(xs, mods, aw1, ab1, aw2, ab2, aw3, ab3, scale=scale, products=products)
    pk = agcm_head_pack_s2d(aw1, aw2, aw3, w_in, b_in, n_first=n_first)
    fea, c0 = in_conv_tf32x3_emulation(agcm, n_first=n_first, packed_s2d=pk, products=products)
    return fea, c0, agcm


# The natural widths the Hopper row tile of csrc/chain_sm90.cuh is built for:
# cond_chain 64 → 64 ×4 → 16; the SFT passes of the tail, sft_conv3 and
# resblock cond 16 and features 32.
COND_CHAIN_S2D_WIDTHS = (64, 64, 64, 64, 64, 16)
SFT_S2D_WIDTHS = (16, 32)
# The kernels whose fp32 float s2d form runs the 3×TF32 tiles: the SFT pass on
# csrc/sft_tf32x3.cuh, the 3×3 convs on csrc/conv3x3_tf32x3.cuh, and the
# tail's conv_last on its fp32 tile (csrc/conv_last.cuh conv_last_tf32x3_kernel).
SFT_TF32X3 = ("sft_conv3", "resblock", "tail")
# The kernels whose fp32 int8 s2d body runs the row tile's int8-output mode
# (csrc/sft_tf32x3.cuh sft_q8_f32_kernel) and the wgmma s8 tile's fp32-output
# epilogue (csrc/conv3x3_s8_sm90.cuh), the tail's conv_last its fp32 tile.
SFT_Q8_F32 = ("sft_conv3", "tail")


def _sft_hopper(name: str, s2d: bool, dt: torch.dtype, cc: int, c: int, co: int, *, quant: bool = False) -> tuple:
    """What a card call of the tail, sft_conv3 or resblock hands its kernel
    for the Hopper tiles: (1, the stride-1 slot table of its 3×3 conv
    (``sm90_table``), its list length) for the s2d form in bf16, float or
    int8 (the int8 conv on the wgmma s8 tile of csrc/conv3x3_s8_sm90.cuh,
    which walks the same table: a chunk is 32 channels in either type), in
    fp32 for the float body (no ``quant``) of the kernels SFT_TF32X3 (the
    SFT pass on csrc/sft_tf32x3.cuh, the convs on the 3×TF32 tile of
    csrc/conv3x3_tf32x3.cuh, the tail's conv_last on its fp32 tile), and in
    fp32 for the int8 body of the kernels SFT_Q8_F32 (the SFT pass in
    sft_tf32x3.cuh's int8-output mode, the conv on the s8 tile's fp32-output
    epilogue); else (0, None, 0), the dense kernels: fp32 resblock_w8a8. The
    row tiles take the natural widths SFT_S2D_WIDTHS (CC, C) only; others
    raise."""
    if not s2d or (dt != torch.bfloat16 and (name not in (SFT_Q8_F32 if quant else SFT_TF32X3))):
        return 0, None, 0
    if (cc // 4, c // 4) != SFT_S2D_WIDTHS:
        raise ValueError(f"{name}: the s2d row tile takes natural widths (CC, C) = {SFT_S2D_WIDTHS}, "
                         f"got {(cc // 4, c // 4)}")
    return (1, *sm90_table(name, 1, 1, c, co, c, dtype=dt))


def fused_cond_chain(
    c0: torch.Tensor, weights, *, qargs=None, s2d: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """c0 (Hb, Wb, C) → (c, cond1): lrelu(cond_first.2), lrelu(cond_first.4)
    → ``c``, then lrelu(CondNet1.0), lrelu(CondNet1.2), CondNet1.4 →
    ``cond1``, in one pass. ``weights``: five (w (C, C'), b (C',)) pairs.
    ``qargs``: None, or five entries, each None (a float step) or the step's
    1×1 int8 parameters (``ops/w8a8.py`` ``QArgs`` with ``taps`` 1, prepared
    from that step's w and b; on the card its input width % 32 and output
    width % 8): the JAX kernel's ``qflags`` steps. A launch with any int8 step
    counts as ``cond_chain_w8a8``.

    ``s2d`` declares every weight ``w_s2d_1x1(w)`` and every bias
    ``b_s2d(b)`` (``models/s2d.py``; the frame programs pass True, their
    weights come from those transforms): a float step then multiplies the
    (4·Hb·Wb, K) rows of natural pixels by the weight's first diagonal block
    only, a quarter of the dense product, and an int8 step the first
    diagonal block of its codes (its other blocks are zero codes: the same
    int32 sums). On the card: the Hopper row tile of ``csrc/chain_sm90.cuh``
    (natural widths 64 → 64 ×4 → 16; others raise), with int8 steps its
    int8 instance (codes made in registers, s8 wgmma); in fp32 its 3×TF32
    instance (``csrc/chain_tf32x3.cuh``), float and int8 steps. The plain
    version honours it too, so a weight without that structure gives
    another result than the JAX kernel's. False: the dense product, right
    for any weight."""
    hb, wb, k = c0.shape
    dt = native.element_type("cond_chain c0", c0)
    if len(weights) != 5:
        raise ValueError(f"cond_chain takes five (w, b) pairs, got {len(weights)}")
    qargs = list(qargs) if qargs is not None else [None] * 5
    if len(qargs) != 5:
        raise ValueError(f"cond_chain takes five qargs entries, got {len(qargs)}")
    ws, bs = [w for w, _ in weights], [b for _, b in weights]
    native.check_params("cond_chain", dt, ws, bs)
    cpu = native.on_cpu(c0, *ws, *bs)
    for (w, b), qa in zip(weights, qargs):
        if w.ndim != 2 or w.shape[0] != k or tuple(b.shape) != (w.shape[1],):
            raise ValueError(f"cond_chain: step weight {tuple(w.shape)} / bias {tuple(b.shape)} after width {k}")
        if qa is not None:
            if qa.taps != 1:
                raise ValueError(f"cond_chain: int8 steps take 1×1 qargs, got {qa.taps} taps")
            check_qargs("cond_chain", qa, k, w.shape[1], not cpu)
        k = w.shape[1]
    if s2d:
        _check_s2d_1x1("cond_chain", weights)
    if cpu:
        return fused_cond_chain_ref(c0, weights, qargs, s2d=s2d)
    if any(w.shape[0] % 16 or w.shape[1] % 8 for w in ws):
        raise ValueError("cond_chain needs every step's input % 16 and output % 8 == 0")
    if any(qa is not None and w.shape[0] % 32 for w, qa in zip(ws, qargs)):
        raise ValueError("cond_chain needs an int8 step's input % 32 == 0")
    native.check_cuda("cond_chain c0", c0, dt)
    for w, b in weights:
        native.check_cuda("cond_chain w", w, dt)
        native.check_cuda("cond_chain b", b, torch.float32)
    quant = any(qa is not None for qa in qargs)
    row_tile = s2d  # the Hopper row tile (fp32: its 3×TF32 instance)
    if row_tile and tuple([ws[0].shape[0] // 4] + [w.shape[1] // 4 for w in ws]) != COND_CHAIN_S2D_WIDTHS:
        raise ValueError(f"cond_chain: the s2d row tile takes natural widths {COND_CHAIN_S2D_WIDTHS}, got "
                         f"{[ws[0].shape[0] // 4] + [w.shape[1] // 4 for w in ws]}")
    ints = ctypes.c_int * 5
    c = torch.empty((hb, wb, ws[1].shape[1]), dtype=dt, device=c0.device)
    cond1 = torch.empty((hb, wb, k), dtype=dt, device=c0.device)
    qptrs, _structs = native.quant_params_pointers(qargs) if quant else (None, None)
    native.launch(
        "cond_chain", dt,
        c0.data_ptr(), c.data_ptr(), cond1.data_ptr(), native.pointer_array(ws), native.pointer_array(bs),
        ints(*[w.shape[0] for w in ws]), ints(*[w.shape[1] for w in ws]), qptrs, hb * wb, int(row_tile),
        native.stream_of(c0), counter="cond_chain_w8a8" if quant else None,
    )
    return c, cond1


# ---------------------------------------------------------------------------
# Output slice: SFT2 + HR_conv2 + conv_last + skip (+ RGB48 pack)
# ---------------------------------------------------------------------------


def _sft_t_rows(x: torch.Tensor, cond: torch.Tensor, sft4, dtype: torch.dtype) -> torch.Tensor:
    """:func:`_sft_t` over ``w_s2d_1x1`` SFT weights and ``b_s2d`` biases as
    the s2d forms take them: the rows of natural pixels of ``x`` and ``cond``
    (fp32, (..., 4C) and (..., 4CC)) against each weight's first diagonal
    block and each bias's first quarter."""
    c, cc = x.shape[-1] // 4, cond.shape[-1] // 4
    blocks = [(w[: w.shape[0] // 4, : w.shape[1] // 4], b[: b.shape[0] // 4]) for w, b in sft4]
    return _sft_t(x.reshape(-1, c), cond.reshape(-1, cc), blocks, dtype).reshape(x.shape)


def _s2d_slots_only(w: torch.Tensor) -> torch.Tensor:
    """A ``w_s2d_s1`` weight (3, 3, 4C, 4Co) with every (tap, input
    sub-position) slot that ``models/s2d.py s2d_slots(1)`` leaves out of an
    output sub-position set to zero: what the Hopper conv tile multiplies
    when it walks the slot table."""
    from hdrtv_tpu_torch.models.s2d import s2d_slots  # models/s2d.py imports this module

    ci, co = w.shape[2] // 4, w.shape[3] // 4
    mask = torch.zeros(9, 4, 4, dtype=torch.bool)
    for so, slots in enumerate(s2d_slots(1)):
        for tap, si in slots:
            mask[tap, si, so] = True
    full = mask.repeat_interleave(ci, dim=1).repeat_interleave(co, dim=2).reshape(3, 3, 4 * ci, 4 * co)
    return torch.where(full.to(w.device), w, torch.zeros((), dtype=w.dtype, device=w.device))


@functools.lru_cache(maxsize=1)
def conv_last_walk() -> ctypes.Array:
    """What conv_last's Hopper tile (csrc/conv_last.cuh conv_last_sm90_kernel)
    multiplies: the 16 (tap, input sub-position) slots that some output
    sub-position of a ``w_s2d_s1`` weight reads (``models/s2d.py
    s2d_slots(1)``), in (tap, si) order, each with the output sub-positions
    it feeds, as a ctypes int array of entries tap | si << 4 | so mask << 8
    (36 (slot, so) pairs; the launcher refuses any other list)."""
    from hdrtv_tpu_torch.models.s2d import s2d_slots  # models/s2d.py imports this module

    masks: dict[tuple[int, int], int] = {}
    for so, slots in enumerate(s2d_slots(1)):
        for slot in slots:
            masks[slot] = masks.get(slot, 0) | 1 << so
    entries = [tap | si << 4 | masks[tap, si] << 8 for tap, si in sorted(masks)]
    return (ctypes.c_int * len(entries))(*entries)


# The widths conv_last's Hopper tile is built for: h 128 channels (natural 32), 12 outputs (natural 3).
CONV_LAST_S2D_WIDTHS = (128, 12)


def _pack_u16(y: torch.Tensor) -> torch.Tensor:
    """fp32 y (Hb, Wb, 12) packed as the tail packs it: u16(int(clip(y, 0,
    1)·65535 + 0.5)), multiply and add rounded apart, as (Hb, 2, Wb, 6)."""
    u = (y.clamp(0.0, 1.0) * 65535.0 + 0.5).to(torch.int32).to(torch.uint16)
    half = u.shape[-1] // 2
    return torch.stack([u[..., :half], u[..., half:]], dim=1)


def conv_last_tf32x3_emulation(h, w_last, b_last, skip, *, pack=True, products: int = 3):
    """conv_last of the fp32 s2d tail as ``csrc/conv_last.cuh
    conv_last_tf32x3_kernel`` sums it, in torch ops: for each slot of
    :func:`conv_last_walk`, the 32 channels of input sub-position si at the
    slot's tap of the zero-padded h times the slot's weight rows (the
    columns of output sub-positions it does not feed zero) by
    :func:`_mm_tf32x3` (one chunk), the slot sums of each half of the walk
    (slots 0-7 and 8-15, the kernel's two halves of its warps) added in
    fp32 in its order, then the halves; then (acc + b) + skip, packed
    (:func:`_pack_u16`) or fp32. ``products`` = 1: one TF32 product, a
    fault."""
    hb, wb, c = h.shape
    ci, cl = c // 4, w_last.shape[-1]
    pad = torch.nn.functional.pad(h.float(), (0, 0, 1, 1, 1, 1))
    halves = [torch.zeros(hb * wb, cl, device=h.device) for _ in range(2)]
    for s, e in enumerate(conv_last_walk()):
        tap, si, mask = e & 15, (e >> 4) & 15, e >> 8
        a = pad[tap // 3: tap // 3 + hb, tap % 3: tap % 3 + wb, si * ci:(si + 1) * ci].reshape(-1, ci)
        w = w_last[tap // 3, tap % 3, si * ci:(si + 1) * ci].float().clone()
        for so in range(4):
            if not (mask >> so) & 1:
                w[:, so * cl // 4:(so + 1) * cl // 4] = 0.0
        halves[s // 8] = halves[s // 8] + _mm_tf32x3(a, w, products)
    y = ((halves[0] + halves[1]).reshape(hb, wb, cl) + b_last) + skip.float()
    return _pack_u16(y) if pack else y


def fused_tail_ref(s, cond1, skip, sft_small, w_hr, b_hr, w_last, b_last, *, pack=True, up_coarse=None,
                   qargs_hr=None, s2d=False):
    """Plain version, the body of the Pallas ``_tail_kernel``: with
    ``up_coarse`` the SFT input is s + d2s(up_coarse) summed in fp32 and
    stored in the element type; the SFT's hidden activations are stored in
    it, scale, shift and t are fp32; t and h = relu(HR_conv2(t)) are each
    stored in the element type and are zero outside the image (both convs
    pad with zeros); conv_last sums in fp32, adds the fp32 bias and the skip;
    the pack rounds its multiply and its add separately and truncates. With
    ``qargs_hr`` (the int8 body) t stays fp32 and is quantized for HR_conv2;
    h is rounded to the element type as in the float body. ``s2d``: the SFT
    multiplies its weights' first diagonal blocks only
    (:func:`_sft_t_rows`), the float HR_conv2 only the populated s2d slots
    of ``w_hr`` and conv_last those of ``w_last`` (:func:`_s2d_slots_only`),
    as the kernel's s2d form does."""
    dt = s.dtype
    sf = s.float()
    if up_coarse is not None:
        sf = _rounded(sf + _d2s_fine(up_coarse).float(), dt)
    hacc = _sft_conv_t(sf, cond1.to(dt).float(), sft_small, w_hr, b_hr, qargs_hr, dt, s2d)
    h = _rounded(torch.clamp_min(hacc, 0.0), dt)
    y = _conv_same(h, _s2d_slots_only(w_last) if s2d else w_last, b_last) + skip.float()
    return _pack_u16(y) if pack else y.to(dt)


def fused_tail(
    s: torch.Tensor, cond1: torch.Tensor, skip: torch.Tensor,
    sft_small, w_hr, b_hr, w_last, b_last,
    *, pack: bool = True, up_coarse: torch.Tensor | None = None, qargs_hr: QArgs | None = None,
    s2d: bool = False,
) -> torch.Tensor:
    """The LE output slice over s2d tensors:

        t   = SFT_layer2(s, cond1)          x·(scale+1)+shift
        h   = relu(HR_conv2(t))             3×3 'same'
        y   = conv_last(h) + skip           3×3 'same' + long skip
        out = pack ? u16(clip(y)·65535+.5) : y

    ``s`` (Hb, Wb, C), ``cond1`` (Hb, Wb, CC), ``skip`` (Hb, Wb, 12). With
    ``pack`` the result is (Hb, 2, Wb, 6) uint16, whose flat layout is the
    natural (2Hb, 2Wb, 3) RGB48 frame; otherwise (Hb, Wb, 12) in the element
    type. With ``up_coarse`` (Hb/2, Wb/2, 4C), the un-folded up_conv3 output,
    ``s`` is the fine skip alone and the SFT input is s + d2s(up_coarse),
    un-folded on read. ``sft_small``: four (w (in, out), b) pairs as for
    :func:`fused_sft_conv3_v2`. ``qargs_hr``: HR_conv2's int8 parameters (the
    int8 body, ``tail_w8a8``; they stand in for ``w_hr`` and ``b_hr``).

    ``s2d`` declares the SFT weights ``w_s2d_1x1(w)``, their biases
    ``b_s2d(b)``, and ``w_hr`` and ``w_last`` ``w_s2d_s1(w)``
    (``models/s2d.py``; the frame programs pass True): the SFT then
    multiplies the rows of natural pixels by each weight's first diagonal
    block, and HR_conv2 and conv_last only the populated s2d slots. bf16 on
    the card: the SFT on the Hopper row tile of ``csrc/chain_sm90.cuh``
    (natural widths CC 16, C 32; others raise), HR_conv2 over the slot table
    (``ops/conv_kernels.py sm90_table``) on ``csrc/conv3x3_sm90.cuh``'s
    tile, or with ``qargs_hr`` the SFT in its int8-output mode and HR_conv2
    on the wgmma s8 tile of ``csrc/conv3x3_s8_sm90.cuh``, and in either body
    conv_last on its Hopper tile (``csrc/conv_last.cuh``, the 16 slots of
    :func:`conv_last_walk`; widths other than CONV_LAST_S2D_WIDTHS raise).
    fp32 on the card, the float body: the SFT on the row tile's 3×TF32
    instance (``csrc/sft_tf32x3.cuh``), HR_conv2 over the slot table on the
    3×TF32 tile of ``csrc/conv3x3_tf32x3.cuh`` and conv_last on its fp32 tile
    (``csrc/conv_last.cuh conv_last_tf32x3_kernel``, the same slots and
    widths); fp32 with ``qargs_hr``: the SFT in that file's int8-output mode
    (``sft_q8_f32_kernel``), HR_conv2 on the wgmma s8 tile's fp32-output
    epilogue and conv_last on its fp32 tile. The plain version honours it
    too (the int8 conv's sum over the populated slots alone equals its dense
    sum on such weights). False: dense, right for any weight."""
    hb, wb, c = s.shape
    cc = cond1.shape[-1]
    cl = w_last.shape[-1]
    if up_coarse is not None and (hb % 2 or wb % 2 or tuple(up_coarse.shape) != (hb // 2, wb // 2, 4 * c)):
        raise ValueError(f"up_coarse {tuple(up_coarse.shape)} != {(hb // 2, wb // 2, 4 * c)}")
    if tuple(skip.shape) != (hb, wb, cl) or tuple(cond1.shape) != (hb, wb, cc):
        raise ValueError(f"tail: skip {tuple(skip.shape)} / cond1 {tuple(cond1.shape)} for s {tuple(s.shape)}, {cl} outputs")
    dt = native.element_type("tail s", s)
    native.check_params("tail", dt, [w_hr, w_last], [b_hr, b_last])
    tensors = [s, cond1, skip, w_hr, b_hr, w_last, b_last] + ([] if up_coarse is None else [up_coarse])
    cpu = native.on_cpu(*tensors, *[t for pair in sft_small for t in pair])
    flat = _check_sft("tail", sft_small, dt, c, cc, not cpu)
    if qargs_hr is not None:
        check_qargs("tail", qargs_hr, c, c, not cpu)
    if s2d:
        _check_s2d_1x1("tail", sft_small)
        check_a_sub("tail", 1, c, c)
        check_a_sub("tail conv_last", 1, c, cl)
    if cpu:
        return fused_tail_ref(s, cond1, skip, sft_small, w_hr, b_hr, w_last, b_last,
                              pack=pack, up_coarse=up_coarse, qargs_hr=qargs_hr, s2d=s2d)
    if c % 32 or cc % 16 or cl % 4 or cl > 16 or (qargs_hr is not None and c % 64):
        raise ValueError(f"tail needs C % 32, CC % 16, and 4 | Cl <= 16 (int8: C % 64), got {c}, {cc}, {cl}")
    native.check_cuda("tail s", s, dt)
    native.check_cuda("tail cond1", cond1, dt)
    native.check_cuda("tail skip", skip, dt)
    native.check_cuda("tail w_hr", w_hr, dt, (3, 3, c, c))
    native.check_cuda("tail b_hr", b_hr, torch.float32, (c,))
    native.check_cuda("tail w_last", w_last, dt, (3, 3, c, cl))
    native.check_cuda("tail b_last", b_last, torch.float32, (cl,))
    if up_coarse is not None:
        native.check_cuda("tail up_coarse", up_coarse, dt)
    hopper, table, per_list = _sft_hopper("tail", s2d, dt, cc, c, c, quant=qargs_hr is not None)
    if hopper and (c, cl) != CONV_LAST_S2D_WIDTHS:
        raise ValueError(f"tail: conv_last's s2d tile takes (C, Cl) = {CONV_LAST_S2D_WIDTHS}, got {(c, cl)}")
    t = torch.empty((hb, wb, c), dtype=dt if qargs_hr is None else torch.int8, device=s.device)  # t or its codes
    h = torch.empty((hb, wb, c), dtype=dt, device=s.device)
    if pack:
        out = torch.empty((hb, 2, wb, cl // 2), dtype=torch.uint16, device=s.device)
    else:
        out = torch.empty((hb, wb, cl), dtype=dt, device=s.device)
    native.launch(
        "tail", dt,
        s.data_ptr(), None if up_coarse is None else up_coarse.data_ptr(), cond1.data_ptr(),
        skip.data_ptr(), native.pointer_array(flat), w_hr.data_ptr(), b_hr.data_ptr(),
        native.quant_params(qargs_hr), w_last.data_ptr(), b_last.data_ptr(), conv_last_walk() if hopper else None,
        out.data_ptr(), t.data_ptr(), h.data_ptr(), hb, wb, c, cc, cl, int(pack), hopper, table, per_list,
        native.stream_of(s),
        counter=None if qargs_hr is None else "tail_w8a8",
    )
    return out


# ---------------------------------------------------------------------------
# HG composite tail: concat-free 1×1 mixes + mask composite + RGB48 pack
# ---------------------------------------------------------------------------


def fused_hg_tail_ref(up5, c1, img_s2d, mask4, w10, b10, wlast, blast):
    """Plain version, the body of the Pallas ``_hg_tail_kernel`` (which, unlike
    the JAX ``fused_hg_tail_ref``, rounds ``u10``): both products of conv10
    sum in fp32 from operands in the element type and the fp32 bias is added;
    ``u10`` is rounded to the element type (``img`` already has it) before
    the two products of conv_last, which sum in fp32 again; the bias, the
    composite ``mask·out + img`` with the mask of a sub-position on its RGB
    triplet, the clip and the pack are fp32; the pack rounds its multiply and
    its add separately and truncates."""
    dt = up5.dtype
    cu = up5.shape[-1]
    u10 = torch.matmul(up5.float(), w10[:cu].float()) + torch.matmul(c1.float(), w10[cu:].float()) + b10
    img = img_s2d.float()
    out = torch.matmul(_rounded(u10, dt), wlast[:12].float()) + torch.matmul(img, wlast[12:].float()) + blast
    comp = mask4.float().repeat_interleave(3, dim=-1) * out + img
    u = (comp.clamp(0.0, 1.0) * 65535.0 + 0.5).to(torch.int32).to(torch.uint16)
    return torch.stack([u[..., :6], u[..., 6:]], dim=1)


def fused_hg_tail(
    up5: torch.Tensor, c1: torch.Tensor, img_s2d: torch.Tensor, mask4: torch.Tensor,
    w10: torch.Tensor, b10: torch.Tensor, wlast: torch.Tensor, blast: torch.Tensor,
) -> torch.Tensor:
    """The HG composite's output slice over s2d tensors, in one pass:

        u10  = conv10([up5 ‖ c1])            1×1, concat-permuted weights
        out  = conv_last([u10 ‖ img])        1×1
        comp = mask·out + img
        pack = u16(clip(comp, 0, 1)·65535 + 0.5)

    ``up5`` (Hb, Wb, Cu) and ``c1`` (Hb, Wb, Cc): the s2d outputs of Up_conv5
    and conv1; ``img_s2d`` (Hb, Wb, 12): the padded base output; ``mask4``
    (Hb, Wb, 4): one mask value per sub-position, all in the element type.
    ``w10`` (Cu + Cc, 12) and ``wlast`` (24, 12): the concat-permuted
    block-diagonal 1×1 weights of ``hg_s2d_transform`` in the element type
    (the kernel reads the row blocks of ``up5`` and ``c1``, of ``u10`` and
    ``img``, in place); biases fp32. Returns (Hb, 2, Wb, 6) uint16, whose flat
    layout is the natural (2Hb, 2Wb, 3) RGB48 frame."""
    hb, wb, cu = up5.shape
    cc = c1.shape[-1]
    dt = native.element_type("hg_tail up5", up5)
    shapes = {"c1": (c1, (hb, wb, cc)), "img_s2d": (img_s2d, (hb, wb, _CIN)), "mask4": (mask4, (hb, wb, 4)),
              "w10": (w10, (cu + cc, _CIN)), "b10": (b10, (_CIN,)), "wlast": (wlast, (2 * _CIN, _CIN)),
              "blast": (blast, (_CIN,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"hg_tail {name} must have shape {shape}, got {tuple(t.shape)}")
    for name in ("c1", "img_s2d", "mask4"):
        if shapes[name][0].dtype != dt:
            raise ValueError(f"hg_tail {name} must be {dt} like up5, got {shapes[name][0].dtype}")
    native.check_params("hg_tail", dt, [w10, wlast], [b10, blast])
    if native.on_cpu(up5, c1, img_s2d, mask4, w10, b10, wlast, blast):
        return fused_hg_tail_ref(up5, c1, img_s2d, mask4, w10, b10, wlast, blast)
    if cu % 4 or cc % 4:
        raise ValueError(f"hg_tail needs Cu % 4 and Cc % 4 == 0, got {cu}, {cc}")
    for name, (t, _) in shapes.items():
        native.check_cuda(f"hg_tail {name}", t, torch.float32 if name in ("b10", "blast") else dt)
    native.check_cuda("hg_tail up5", up5, dt)
    out = torch.empty((hb, 2, wb, _CIN // 2), dtype=torch.uint16, device=up5.device)
    native.launch(
        "hg_tail", dt,
        up5.data_ptr(), c1.data_ptr(), img_s2d.data_ptr(), mask4.data_ptr(),
        w10.data_ptr(), b10.data_ptr(), wlast.data_ptr(), blast.data_ptr(), out.data_ptr(),
        hb, wb, cu, cc, native.stream_of(up5),
    )
    return out


# ---------------------------------------------------------------------------
# Stride-2 dense-s2d block conv (the weight-transformed down convs)
# ---------------------------------------------------------------------------


def fused_down2_ref(x, w, b, *, act=None):
    """Plain version: 3×3 stride-2 conv with (1,0) padding, + b, act, in
    fp32; one rounding to ``x.dtype`` at the end."""
    y = conv_nhwc(x[None].float(), w.float(), b.float(), stride=2, padding=((1, 0), (1, 0)))[0]
    return _apply_act(y, act).to(x.dtype)


def fused_down2_q_ref(x, qargs, *, act=None):
    """Plain version of the int8 body (megakernel.py:608-705): for each
    branch (``qargs``: one ``QArgs`` or a sequence, one per branch, in output
    channel order) x widened to fp32 and quantized with the branch's scale
    and zero (global row −1 and column −1 carry its pad code), the exact
    int32 stride-2 tap sum, · yscale, + the folded bias; the branches side by
    side, the activation, one rounding to ``x.dtype``."""
    branches = [qargs] if isinstance(qargs, QArgs) else list(qargs)
    xf = x.float()
    y = torch.cat([_taps_conv_q(xf, qa, stride=2) for qa in branches], dim=-1)
    return _apply_act(y, act).to(x.dtype)


def fused_down2(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, act: str | None = None,
    cin: int | None = None, ch0: int = 0, qargs=None, a_sub: int = 1,
) -> torch.Tensor:
    """Stride-2 3×3 block conv, (1,0) pad: (Hb,Wb,C) → (Hb/2,Wb/2,Co).

    ``w``: (3,3,C,Co), the s2d-transformed stride-2 weight: ``a_sub``
    (≥ 1) blocks of ``w_s2d_s2`` side by side along Co, whose structural
    zeros the float form skips (``ops/conv_kernels.py``); ``a_sub`` = 0
    runs the dense product, right for any weight. ``act``: None | 'relu' |
    'lrelu'. ``cin``/``ch0``: read the ``[ch0:ch0+cin]`` channel window of a
    wider ``x`` in place (``ch0`` a multiple of ``cin``, as in the JAX
    contract); the plain version slices. ``qargs``: the int8 body, one
    ``QArgs`` (per-tensor calibration) or one per branch of a consolidated
    conv (``a_sub`` of them, each for its Co/a_sub output channels, a
    multiple of 128 on the card), prepared at load from this ``w`` and
    ``b``; on the card the window takes C % 64. ``a_sub``: the consolidated
    sub-blocks (3 for the CondNet down convs), also the int8 branches' count.
    The int8 body in bf16 with ``a_sub`` ≥ 1 quantizes the window once into
    one code plane per branch and runs the wgmma s8 tile of
    ``csrc/conv3x3_s8_sm90.cuh`` at stride 2 over the slot table
    (``s8_sm90_table``: C = 256, ``a_sub`` 1 or 3; another width raises);
    fp32 and ``a_sub`` = 0 run the dense int8 tile, the same result on
    ``w_s2d_s2`` weights.
    """
    hb, wb, cf = x.shape
    c = _window("down2", cf, cin, ch0)
    if act not in _ACTS:
        raise ValueError(f"unknown act {act!r}")
    co = w.shape[-1]
    dt = native.element_type("down2 x", x)
    native.check_params("down2", dt, [w], [b])
    check_a_sub("down2", a_sub, c, co)
    cpu = native.on_cpu(x, w, b)
    branches = None if qargs is None else ([qargs] if isinstance(qargs, QArgs) else list(qargs))
    if branches is not None:
        nb = len(branches)
        if (nb != 1 and nb != a_sub) or co % nb:
            raise ValueError(f"down2: {nb} qargs branches for a_sub={a_sub}, Co={co}")
        for qa in branches:
            check_qargs("down2", qa, c, co // nb, not cpu)
    if cpu:
        if branches is not None:
            return fused_down2_q_ref(x[..., ch0 : ch0 + c], branches, act=act)
        return fused_down2_ref(x[..., ch0 : ch0 + c], w, b, act=act)
    if hb % 2 or wb % 2:
        raise ValueError(f"down2 needs even block dims, got {hb}x{wb}")
    if c % 16 or co % 4 or cf % 4:
        raise ValueError(f"down2 needs cin % 16, Co % 4 and C % 4 == 0, got {c}, {co}, {cf}")
    if branches is not None and (c % 64 or co % 8 or len(branches) > 4 or
                                 (len(branches) > 1 and (co // len(branches)) % 128)):
        raise ValueError(f"down2 int8 needs cin % 64, Co % 8 and branches of 128-multiples (at most 4), "
                         f"got {c}, {co}, {len(branches)} branches")
    table, per_group = None, 0
    if branches is None:
        table, per_group = sm90_table("down2", 2, a_sub, c, co, cf, ch0, dtype=dt)
    elif a_sub and dt == torch.bfloat16:
        # one quantize pass into every branch's plane (16-byte reads), then the s8 tile at stride 2
        table, per_group = s8_sm90_table("down2", a_sub, c, co, stride=2)
        if cf % 8:
            raise ValueError(f"down2: the int8 s8 tile's quantize pass needs a pixel pitch % 8 == 0, got {cf}")
    native.check_cuda("down2 x", x, dt)
    native.check_cuda("down2 w", w, dt, (3, 3, c, co))
    native.check_cuda("down2 b", b, torch.float32, (co,))
    out = torch.empty((hb // 2, wb // 2, co), dtype=dt, device=x.device)
    qp, codes = None, None
    if branches is not None:
        qp = native.quant_params_array(branches)
        # the int8 form's scratch: the window's codes, one plane per branch
        codes = torch.empty((len(branches), hb, wb, c), dtype=torch.int8, device=x.device)
    native.launch(
        "down2", dt,
        x.data_ptr(), w.data_ptr(), b.data_ptr(), qp, 0 if branches is None else len(branches),
        out.data_ptr(), None if codes is None else codes.data_ptr(),
        hb, wb, cf, ch0, c, co, _ACTS[act], a_sub, table, per_group, native.stream_of(x),
        counter=None if branches is None else "down2_w8a8",
    )
    return out


# ---------------------------------------------------------------------------
# SFT + 3×3 conv, and the full SFT resblock
# ---------------------------------------------------------------------------


def _sft_mix(cond: torch.Tensor, p0, p1, dtype: torch.dtype) -> torch.Tensor:
    """One SFT branch, conv1(lrelu(conv0(cond))) with 1×1 weights (in, out),
    as the Pallas ``_sft_mix``: fp32 sums and biases, the hidden activation
    stored in ``dtype``. ``cond``: fp32 values already on the ``dtype`` grid."""
    h = leaky_relu(torch.matmul(cond, p0[0].float()) + p0[1], 0.1)
    return torch.matmul(_rounded(h, dtype), p1[0].float()) + p1[1]


def _sft_t(x: torch.Tensor, cond: torch.Tensor, sft4, dtype: torch.dtype) -> torch.Tensor:
    """t = x·(scale+1)+shift in fp32 (``x``, ``cond`` fp32), not rounded:
    what an int8 body quantizes."""
    scale = _sft_mix(cond, sft4[0], sft4[1], dtype)
    shift = _sft_mix(cond, sft4[2], sft4[3], dtype)
    return x * (scale + 1.0) + shift


def _sft(x: torch.Tensor, cond: torch.Tensor, sft4, dtype: torch.dtype) -> torch.Tensor:
    """t = x·(scale+1)+shift in fp32 (``x``, ``cond`` fp32), stored in ``dtype``."""
    return _rounded(_sft_t(x, cond, sft4, dtype), dtype)


def _sft_conv_t(x: torch.Tensor, cond: torch.Tensor, sft4, w, b, qa: QArgs | None,
                dtype: torch.dtype, s2d: bool = False) -> torch.Tensor:
    """An SFT and the 3×3 conv after it, fp32 with the bias: the float
    body's conv of t stored in ``dtype``, or the int8 body's of t quantized
    from fp32. ``s2d``: the SFT over its weights' first diagonal blocks
    (:func:`_sft_t_rows`) and the float conv over ``w``'s populated slots
    (:func:`_s2d_slots_only`), as the kernels' s2d forms compute; the int8
    conv stays dense: its exact int32 sum over the populated slots alone,
    the s2d int8 tile's, is the dense sum wherever the int8 weight is zero
    outside them (``w_s2d_s1`` of a quantized weight)."""
    t = (_sft_t_rows if s2d else _sft_t)(x, cond, sft4, dtype)
    if qa is None:
        return _conv_same(_rounded(t, dtype), _s2d_slots_only(w) if s2d else w, b)
    return _taps_conv_q(t, qa)


def _d2s_fine(cu: torch.Tensor) -> torch.Tensor:
    """Block d2s of an unbatched coarse tensor, (Hc, Wc, 4C) → (2Hc, 2Wc, C):
    fine[2i+a, 2j+b, k] = coarse[i, j, (2a+b)·C + k]."""
    hc, wc, c4 = cu.shape
    c = c4 // 4
    return cu.reshape(hc, wc, 2, 2, c).permute(0, 2, 1, 3, 4).reshape(2 * hc, 2 * wc, c)


def fused_sft_conv3_v2_ref(x, cond, sft4, w, b, *, relu=False, skip=None, qargs=None, s2d=False):
    """Plain version, the body of the Pallas ``_sft_conv_kernel``: cond in the
    element type; hidden activations stored in it; scale, shift and t in
    fp32; t stored in the element type, zero outside the image (the conv's
    'same' padding); fp32 conv sum + fp32 bias + skip, ReLU, one rounding.
    With ``qargs`` (the int8 body) t stays fp32 and is quantized instead.
    ``s2d``: the SFT multiplies its weights' first diagonal blocks only and
    the float conv only the populated s2d slots of ``w`` (:func:`_sft_conv_t`),
    as the kernel's s2d form does."""
    dt = x.dtype
    y = _sft_conv_t(x.float(), cond.to(dt).float(), sft4, w, b, qargs, dt, s2d)
    if skip is not None:
        y = y + skip.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(dt)


def _check_sft(name: str, sft4, dt: torch.dtype, c: int, cc: int, cuda: bool) -> list:
    """The four (w, b) pairs scale0, scale1, shift0, shift1 of an SFT; returns
    them flat, w then b, as the kernels take them."""
    shapes = [(cc, cc), (cc, c), (cc, cc), (cc, c)]
    native.check_params(name, dt, [w for w, _ in sft4], [b for _, b in sft4])
    flat = []
    for (w, b), shape in zip(sft4, shapes, strict=True):
        if tuple(w.shape) != shape or tuple(b.shape) != shape[1:]:
            raise ValueError(f"{name}: SFT weight {tuple(w.shape)} / bias {tuple(b.shape)}, expected {shape}")
        if cuda:
            native.check_cuda(f"{name} sft w", w, dt)
            native.check_cuda(f"{name} sft b", b, torch.float32)
        flat += [w, b]
    return flat


def fused_sft_conv3_v2(
    x: torch.Tensor, cond: torch.Tensor, sft4, w: torch.Tensor, b: torch.Tensor,
    *, relu: bool = False, skip: torch.Tensor | None = None, qargs: QArgs | None = None,
    s2d: bool = False,
) -> torch.Tensor:
    """y = conv3x3(sft(x, cond)) (+skip)(relu) over s2d tensors: x (Hb,Wb,C),
    cond (Hb,Wb,CC) → (Hb,Wb,Co).

    ``sft4``: four (w (in, out), b) pairs, scale0, scale1, shift0, shift1 (the
    s2d block-diagonal dense 1×1s). ``qargs``: the conv's int8 parameters
    (the int8 body, ``sft_conv3_w8a8``; they stand in for ``w`` and ``b``).

    ``s2d`` declares the SFT weights ``w_s2d_1x1(w)``, their biases
    ``b_s2d(b)`` and ``w`` ``w_s2d_s1(w)`` (``models/s2d.py``; the frame
    programs pass True): the SFT then multiplies the rows of natural pixels
    by each weight's first diagonal block and the float conv only the
    populated s2d slots. bf16 on the card: the SFT on the Hopper row tile of
    ``csrc/chain_sm90.cuh`` (natural widths CC 16, C 32; others raise) and
    the conv over the slot table on ``csrc/conv3x3_sm90.cuh``'s tile, or
    with ``qargs`` the SFT in its int8-output mode and the conv on the wgmma
    s8 tile of ``csrc/conv3x3_s8_sm90.cuh``. fp32 on the card, the float
    body: the SFT on the row tile's 3×TF32 instance (``csrc/sft_tf32x3.cuh``,
    the same widths) and the conv over the slot table on the 3×TF32 tile of
    ``csrc/conv3x3_tf32x3.cuh``; fp32 with ``qargs``: the SFT in that file's
    int8-output mode (``sft_q8_f32_kernel``) and the conv on the wgmma s8
    tile's fp32-output epilogue. The plain version honours it too. False:
    dense, right for any weight.
    """
    hb, wb, c = x.shape
    cc = cond.shape[-1]
    co = w.shape[-1]
    dt = native.element_type("sft_conv3 x", x)
    native.check_params("sft_conv3", dt, [w], [b])
    tensors = [x, cond, w, b] + ([] if skip is None else [skip])
    cpu = native.on_cpu(*tensors, *[t for pair in sft4 for t in pair])
    flat = _check_sft("sft_conv3", sft4, dt, c, cc, not cpu)
    if qargs is not None:
        check_qargs("sft_conv3", qargs, c, co, not cpu)
    if s2d:
        _check_s2d_1x1("sft_conv3", sft4)
        check_a_sub("sft_conv3", 1, c, co)
    if cpu:
        return fused_sft_conv3_v2_ref(x, cond, sft4, w, b, relu=relu, skip=skip, qargs=qargs, s2d=s2d)
    if c % 16 or cc % 16 or co % 4 or (qargs is not None and (c % 64 or co % 8)):
        raise ValueError(f"sft_conv3 needs C % 16, CC % 16 and Co % 4 == 0 (int8: C % 64 and Co % 8), "
                         f"got {c}, {cc}, {co}")
    native.check_cuda("sft_conv3 x", x, dt)
    native.check_cuda("sft_conv3 cond", cond, dt, (hb, wb, cc))
    native.check_cuda("sft_conv3 w", w, dt, (3, 3, c, co))
    native.check_cuda("sft_conv3 b", b, torch.float32, (co,))
    if skip is not None:
        native.check_cuda("sft_conv3 skip", skip, dt, (hb, wb, co))
    hopper, table, per_list = _sft_hopper("sft_conv3", s2d, dt, cc, c, co, quant=qargs is not None)
    out = torch.empty((hb, wb, co), dtype=dt, device=x.device)
    t = torch.empty((hb, wb, c), dtype=dt if qargs is None else torch.int8, device=x.device)  # t or its codes
    native.launch(
        "sft_conv3", dt,
        x.data_ptr(), cond.data_ptr(), native.pointer_array(flat), w.data_ptr(), b.data_ptr(),
        native.quant_params(qargs), None if skip is None else skip.data_ptr(), out.data_ptr(), t.data_ptr(),
        hb, wb, c, cc, co, int(relu), hopper, table, per_list, native.stream_of(x),
        counter=None if qargs is None else "sft_conv3_w8a8",
    )
    return out


def fused_resblock_ref(x, cond, sft1, w1, b1, sft2, w2, b2, *, up_coarse=None, x_add=None,
                       qargs1=None, qargs2=None, s2d=False):
    """Plain version, the body of the Pallas ``_resblock_kernel``: with a
    second input the block input is x + d2s(up_coarse) (or x + x_add) summed
    in fp32 and stored in the element type, and that stored sum is the
    residual; h1 = relu(conv1 + b1) stays fp32 into SFT2; t1 and t2 are
    stored in the element type (quantized from fp32 in the int8 body, with
    ``qargs1`` and ``qargs2``); out = conv2 + b2 + input in fp32, one
    rounding. ``s2d``: both SFTs over their weights' first diagonal blocks,
    the float convs over the populated s2d slots (:func:`_sft_conv_t`)."""
    dt = x.dtype
    xin = x.float()
    if up_coarse is not None:
        xin = _rounded(xin + _d2s_fine(up_coarse).float(), dt)
    elif x_add is not None:
        xin = _rounded(xin + x_add.float(), dt)
    cf = cond.to(dt).float()
    h1 = torch.clamp_min(_sft_conv_t(xin, cf, sft1, w1, b1, qargs1, dt, s2d), 0.0)
    return (_sft_conv_t(h1, cf, sft2, w2, b2, qargs2, dt, s2d) + xin).to(dt)


def fused_resblock(
    x: torch.Tensor, cond: torch.Tensor, sft1, w1, b1, sft2, w2, b2,
    *, up_coarse: torch.Tensor | None = None, x_add: torch.Tensor | None = None,
    qargs1: QArgs | None = None, qargs2: QArgs | None = None, s2d: bool = False,
) -> torch.Tensor:
    """ResBlock_with_SFT in one call:

        out = xin + conv2( sft2( relu(conv1( sft1(xin, cond) )), cond ) )

    over x (Hb,Wb,C), cond (Hb,Wb,CC). ``up_coarse`` (Hb/2, Wb/2, 4C): xin =
    x + d2s(up_coarse), un-folded on read (trunk5's up path); ``x_add``
    (Hb,Wb,C): xin = x + x_add (trunk4's). Otherwise xin = x. ``qargs1`` and
    ``qargs2``: the two convs' int8 parameters, both or neither (the int8
    body, ``resblock_w8a8``).

    ``s2d`` declares every SFT weight ``w_s2d_1x1(w)``, its bias
    ``b_s2d(b)`` and ``w1``, ``w2`` ``w_s2d_s1(w)`` (the frame programs pass
    True), as for :func:`fused_sft_conv3_v2`. bf16 on the card: both SFT
    passes on the Hopper row tile (SFT2 reading the fp32 h1; natural widths
    CC 16, C 32, others raise), both convs over the slot table, conv1
    storing h1 in fp32; with float convs on the Hopper conv tile, with
    ``qargs1``/``qargs2`` both SFT passes in the row tile's int8-output mode
    (SFT1 also writing the rounded sum with a second input) and both convs
    on the wgmma s8 tile of ``csrc/conv3x3_s8_sm90.cuh``. fp32 on the card,
    the float body: both SFT passes on the row tile's 3×TF32 instance
    (``csrc/sft_tf32x3.cuh``; SFT1 writing the fp32 sum with a second
    input, SFT2 reading h1), both convs over the slot table on the 3×TF32
    tile of ``csrc/conv3x3_tf32x3.cuh``, conv2 adding the residual; fp32
    with ``qargs1``/``qargs2`` keeps the dense kernels, the same function on
    such weights. The plain version honours it too.
    """
    hb, wb, c = x.shape
    cc = cond.shape[-1]
    if up_coarse is not None and x_add is not None:
        raise ValueError("up_coarse and x_add are mutually exclusive")
    if up_coarse is not None and (hb % 2 or wb % 2 or tuple(up_coarse.shape) != (hb // 2, wb // 2, 4 * c)):
        raise ValueError(f"up_coarse {tuple(up_coarse.shape)} != {(hb // 2, wb // 2, 4 * c)}")
    second = up_coarse if up_coarse is not None else x_add
    dt = native.element_type("resblock x", x)
    native.check_params("resblock", dt, [w1, w2], [b1, b2])
    tensors = [x, cond, w1, b1, w2, b2] + ([] if second is None else [second])
    cpu = native.on_cpu(*tensors, *[t for pair in (*sft1, *sft2) for t in pair])
    flat1 = _check_sft("resblock sft1", sft1, dt, c, cc, not cpu)
    flat2 = _check_sft("resblock sft2", sft2, dt, c, cc, not cpu)
    if (qargs1 is None) != (qargs2 is None):
        raise ValueError("resblock: qargs1 and qargs2 come both or neither")
    quant = qargs1 is not None
    if quant:
        check_qargs("resblock conv1", qargs1, c, c, not cpu)
        check_qargs("resblock conv2", qargs2, c, c, not cpu)
    if s2d:
        _check_s2d_1x1("resblock", [*sft1, *sft2])
        check_a_sub("resblock", 1, c, c)
    if cpu:
        return fused_resblock_ref(x, cond, sft1, w1, b1, sft2, w2, b2, up_coarse=up_coarse, x_add=x_add,
                                  qargs1=qargs1, qargs2=qargs2, s2d=s2d)
    if c % 16 or cc % 16 or (quant and c % 64):
        raise ValueError(f"resblock needs C % 16 and CC % 16 == 0 (int8: C % 64), got {c}, {cc}")
    native.check_cuda("resblock x", x, dt)
    native.check_cuda("resblock cond", cond, dt, (hb, wb, cc))
    for name, w, b in (("1", w1, b1), ("2", w2, b2)):
        native.check_cuda(f"resblock w{name}", w, dt, (3, 3, c, c))
        native.check_cuda(f"resblock b{name}", b, torch.float32, (c,))
    if x_add is not None:
        native.check_cuda("resblock x_add", x_add, dt, (hb, wb, c))
    if up_coarse is not None:
        native.check_cuda("resblock up_coarse", up_coarse, dt)
    hopper, table, per_list = _sft_hopper("resblock", s2d, dt, cc, c, c, quant=quant)
    t = torch.empty((hb, wb, c), dtype=torch.int8 if quant else dt, device=x.device)  # t or its codes
    h1 = torch.empty((hb, wb, c), dtype=torch.float32, device=x.device)
    xsum = None if second is None else torch.empty((hb, wb, c), dtype=dt, device=x.device)
    out = torch.empty((hb, wb, c), dtype=dt, device=x.device)
    native.launch(
        "resblock", dt,
        x.data_ptr(), cond.data_ptr(), native.pointer_array(flat1), w1.data_ptr(), b1.data_ptr(),
        native.quant_params(qargs1), native.pointer_array(flat2), w2.data_ptr(), b2.data_ptr(),
        native.quant_params(qargs2), None if second is None else second.data_ptr(), int(up_coarse is not None),
        out.data_ptr(), t.data_ptr(), h1.data_ptr(), None if xsum is None else xsum.data_ptr(),
        hb, wb, c, cc, hopper, table, per_list, native.stream_of(x),
        counter="resblock_w8a8" if quant else None,
    )
    return out


# ---------------------------------------------------------------------------
# The whole natural trunk3 stage (4 SFT resblocks + skip + up_conv1)
# ---------------------------------------------------------------------------


def fused_trunk3_ref(fea3, cond4, blocks, w_up, b_up):
    """Plain version, the body of the Pallas ``_trunk3_kernel``: 'same' convs
    over the SFT outputs, the stage skip, relu(up_conv1). Sums are fp32; the
    SFT's hidden activations, t, h1, t2, the running x after each resblock
    and the stage-skip sum are each stored in the element type."""
    dt = fea3.dtype
    x0 = fea3.float()
    cond = cond4.to(dt).float()
    x = x0
    for sft1, w1, b1, sft2, w2, b2 in blocks:
        h1 = _rounded(torch.clamp_min(_conv_same(_sft(x, cond, sft1, dt), w1, b1), 0.0), dt)
        x = _rounded(x + _conv_same(_sft(h1, cond, sft2, dt), w2, b2), dt)
    out = _rounded(x + x0, dt)
    return torch.clamp_min(_conv_same(out, w_up, b_up), 0.0).to(dt)


def trunk3_pack(blocks, w_up, b_up) -> torch.Tensor:
    """The fp32 parameter block csrc/trunk3.cu reads: per resblock sft1 (its
    four (w, b) pairs in order), conv1 w, b, sft2, conv2 w, b; then up_conv1
    w, b. bf16 weights are widened (the block then holds bf16-rounded values,
    so the kernel's products are those of the bf16 weights). It depends on the
    parameters only: build it once at load and pass it as ``packed``."""
    parts = []
    for sft1, w1, b1, sft2, w2, b2 in blocks:
        for group in (sft1, [(w1, b1)], sft2, [(w2, b2)]):
            for w, b in group:
                parts += [w.reshape(-1), b.reshape(-1)]
    parts += [w_up.reshape(-1), b_up.reshape(-1)]
    return torch.cat([p.float() for p in parts])


def trunk3_pack_bf16(blocks, w_up, b_up) -> tuple[torch.Tensor, torch.Tensor]:
    """What the bf16 instance of csrc/trunk3.cu reads (the Hopper tiles):
    :func:`trunk3_pack`'s order split in two, the weights in bf16 (1×1s as
    (in, out), 3×3s HWIO as the conv tile reads them) and the biases in fp32.
    It depends on the parameters only: build it once at load and pass it as
    ``packed``."""
    ws, bs = [], []
    for sft1, w1, b1, sft2, w2, b2 in blocks:
        for group in (sft1, [(w1, b1)], sft2, [(w2, b2)]):
            for w, b in group:
                ws.append(w.reshape(-1))
                bs.append(b.reshape(-1))
    ws.append(w_up.reshape(-1))
    bs.append(b_up.reshape(-1))
    return torch.cat([w.to(torch.bfloat16) for w in ws]), torch.cat([b.float() for b in bs])


def fused_trunk3(
    fea3: torch.Tensor, cond4: torch.Tensor, blocks, w_up: torch.Tensor, b_up: torch.Tensor,
    *, packed=None,
) -> torch.Tensor:
    """The L3 natural stage in one call: 4 ResBlock_with_SFT, the trailing
    ``out + fea3`` skip and relu(up_conv1(out)), (H, W, 32) + cond (H, W, 16)
    → (H, W, Co).

    ``blocks``: 4 tuples (sft1, w1, b1, sft2, w2, b2), each sft a list of 4
    (w (in, out), b) pairs: scale_conv0, scale_conv1, shift_conv0,
    shift_conv1. ``w1``/``w2`` (3,3,C,C), ``w_up`` (3,3,C,Co) HWIO.
    ``packed``: the pack of the same parameters for the call's element type,
    :func:`trunk3_pack` (fp32) or :func:`trunk3_pack_bf16`, when the caller
    keeps one (only the CUDA kernel reads it). On the card, C = 32, CC = 16
    and Co % 32 == 0 only, the convs run the Hopper tiles with the dense
    9-chunk table: fp32 the 3×TF32 tile of ``csrc/conv3x3_tf32x3.cuh`` (the
    table asked for by ``dense_tf32x3``), its SFT passes the coalesced fp32
    pass of ``csrc/trunk3.cu``; bf16 the tile of ``csrc/conv3x3_sm90.cuh``,
    its SFT passes ``csrc/chain_sm90.cuh``'s row tile over natural rows.
    """
    hb, wb, c = fea3.shape
    cc = cond4.shape[-1]
    co = w_up.shape[-1]
    dt = native.element_type("trunk3 fea3", fea3)
    weights = [w_up] + [w for blk in blocks for w in (blk[1], blk[4])]
    biases = [b_up] + [b for blk in blocks for b in (blk[2], blk[5])]
    for blk in blocks:
        for sft in (blk[0], blk[3]):
            weights += [w for w, _ in sft]
            biases += [b for _, b in sft]
    native.check_params("trunk3", dt, weights, biases)
    if native.on_cpu(fea3, cond4, w_up, b_up):
        return fused_trunk3_ref(fea3, cond4, blocks, w_up, b_up)
    native.check_cuda("trunk3 fea3", fea3, dt)
    native.check_cuda("trunk3 cond4", cond4, dt, (hb, wb, cc))
    want = native.lib().hdrtv_trunk3_param_floats(c, cc, co)
    if want == 0 or co % 32:
        raise ValueError(f"trunk3 is built for C=32, CC=16 and its Hopper conv tiles need Co % 32 == 0; "
                         f"got C={c} CC={cc} Co={co}")
    biases = None
    if dt == torch.float32:
        params = packed if packed is not None else trunk3_pack(blocks, w_up, b_up)
        if params.numel() != want:
            raise ValueError(f"trunk3 parameter block has {params.numel()} floats, expected {want}")
        native.check_cuda("trunk3 params", params, torch.float32)
    else:
        params, biases = packed if packed is not None else trunk3_pack_bf16(blocks, w_up, b_up)
        n_w = 4 * (2 * 2 * (cc * cc + cc * c) + 2 * 9 * c * c) + 9 * c * co
        native.check_cuda("trunk3 weights (bf16 pack)", params, dt, (n_w,))
        native.check_cuda("trunk3 biases (bf16 pack)", biases, torch.float32, (want - n_w,))
    table, per_list = sm90_table("trunk3", 1, 0, c, c, c, dtype=dt, dense_tf32x3=True)
    scratch = torch.empty(3 * hb * wb * c, dtype=dt, device=fea3.device)
    out = torch.empty((hb, wb, co), dtype=dt, device=fea3.device)
    native.launch(
        "trunk3", dt,
        fea3.data_ptr(), cond4.data_ptr(), params.data_ptr(), None if biases is None else biases.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), hb, wb, c, cc, co, table, per_list, native.stream_of(fea3),
    )
    return out


# ---------------------------------------------------------------------------
# Generic pointwise 1×1 chain (the small CondNet tails)
# ---------------------------------------------------------------------------


def fused_mix_chain_ref(x, steps, *, s2d=False):
    """Plain version, the body of the Pallas ``_mix_chain_kernel``: each step
    casts its input to the weight's type, sums in fp32, adds the fp32 bias
    and applies the activation in fp32; only the last result is rounded.
    ``s2d``: each step multiplies the weight's first diagonal block only
    (:func:`_rows_1x1`), as the kernel's s2d form does."""
    v = x
    for w, b, act in steps:
        v = v.to(w.dtype).float()
        v = _apply_act(_rows_1x1(v, w, b) if s2d else torch.matmul(v, w.float()) + b, act)
    return v.to(x.dtype)


# The chain the Hopper row tile of csrc/chain_sm90.cuh takes for mix_chain: the CondNet2
# tail, natural widths 64 → 64 (lrelu) → 16.
MIX_CHAIN_S2D_WIDTHS = (64, 64, 16)
MIX_CHAIN_S2D_ACTS = ("lrelu", None)


def fused_mix_chain(x: torch.Tensor, steps, *, cin: int | None = None, ch0: int = 0,
                    s2d: bool = False) -> torch.Tensor:
    """Chain of 1×1 convs (+activations) in one pass: (Hb,Wb,C) → (Hb,Wb,C').

    ``steps``: list of (w (C, C'), b (C',), act ∈ {None, 'relu', 'lrelu'}).
    ``cin``/``ch0``: read the ``[ch0:ch0+cin]`` channel window of a wider
    ``x`` in place (``ch0`` a multiple of ``cin``); the plain version slices.

    ``s2d`` declares every weight ``w_s2d_1x1(w)`` and every bias
    ``b_s2d(b)`` (``models/s2d.py``; the frame programs' CondNet tails pass
    True): a step then multiplies the (4·Hb·Wb, K) rows of natural pixels by
    the weight's first diagonal block only. bf16 on the card: the Hopper row
    tile of ``csrc/chain_sm90.cuh`` (the chain MIX_CHAIN_S2D_WIDTHS with
    MIX_CHAIN_S2D_ACTS; another raises); fp32 keeps the dense kernel, the
    same function on such weights. The plain version honours it too, so a
    weight without that structure gives another result than the JAX
    kernel's. False: the dense product, right for any weight.
    """
    hb, wb, cf = x.shape
    c = _window("mix_chain", cf, cin, ch0)
    dt = native.element_type("mix_chain x", x)
    ws, bs, acts = [w for w, _, _ in steps], [b for _, b, _ in steps], [a for _, _, a in steps]
    if any(a not in _ACTS for a in acts):
        raise ValueError(f"unknown act in {acts!r}")
    native.check_params("mix_chain", dt, ws, bs)
    k = c
    for w, b in zip(ws, bs, strict=True):
        if w.ndim != 2 or w.shape[0] != k or tuple(b.shape) != (w.shape[1],):
            raise ValueError(f"mix_chain: step weight {tuple(w.shape)} / bias {tuple(b.shape)} after width {k}")
        k = w.shape[1]
    if s2d:
        _check_s2d_1x1("mix_chain", zip(ws, bs))
    if native.on_cpu(x, *ws, *bs):
        return fused_mix_chain_ref(x[..., ch0 : ch0 + c], steps, s2d=s2d)
    n_steps = len(steps)
    if not 1 <= n_steps <= native.lib().hdrtv_mix_chain_max_steps():
        raise ValueError(f"mix_chain takes 1 to {native.lib().hdrtv_mix_chain_max_steps()} steps, got {n_steps}")
    if cf % 4 or any(w.shape[0] % 16 or w.shape[1] % 4 for w in ws):
        raise ValueError("mix_chain needs C % 4 == 0 and every step's input % 16, output % 4 == 0")
    row_tile = s2d and dt == torch.bfloat16  # the Hopper row tile
    widths = tuple([c // 4] + [w.shape[1] // 4 for w in ws])
    if row_tile and (widths != MIX_CHAIN_S2D_WIDTHS or tuple(acts) != MIX_CHAIN_S2D_ACTS or cf % 8 or ch0 % 8):
        raise ValueError(f"mix_chain: the s2d row tile takes natural widths {MIX_CHAIN_S2D_WIDTHS} with acts "
                         f"{MIX_CHAIN_S2D_ACTS} and a pixel pitch and window start % 8 == 0, got {widths}, "
                         f"{tuple(acts)}, pitch {cf}, ch0={ch0}")
    native.check_cuda("mix_chain x", x, dt)
    for w, b in zip(ws, bs, strict=True):
        native.check_cuda("mix_chain w", w, dt)
        native.check_cuda("mix_chain b", b, torch.float32)
    ints = ctypes.c_int * n_steps
    out = torch.empty((hb, wb, k), dtype=dt, device=x.device)
    native.launch(
        "mix_chain", dt,
        x.data_ptr(), out.data_ptr(), native.pointer_array(ws), native.pointer_array(bs),
        ints(*[w.shape[0] for w in ws]), ints(*[w.shape[1] for w in ws]),
        ints(*[_ACTS[a] for a in acts]), n_steps, hb * wb, cf, ch0, int(row_tile), native.stream_of(x),
    )
    return out
