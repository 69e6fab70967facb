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
is an exact int32 tap sum rescaled per output channel. The int8 bodies of
``fused_cond_chain`` and ``fused_down2`` are not ported (ROADMAP.md slice 6:
no frame program runs them by default).
"""

from __future__ import annotations

import ctypes

import torch

from hdrtv_tpu_torch.models.layers import conv_nhwc, leaky_relu
from hdrtv_tpu_torch.ops import native
from hdrtv_tpu_torch.ops.w8a8 import QArgs, _taps_conv_q, check_qargs

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


def fused_agcm_head_ref(xs, mods, aw1, ab1, aw2, ab2, aw3, ab3, w_in, b_in, *, n_first, scale=1.0):
    """Plain version, the body of the Pallas ``_agcm_head_kernel``: the frame
    is widened to fp32, scaled, then rounded to the element type (that of the
    weights) before the first product; each modulation ``v·(s+1)+sh`` is fp32
    with the fp32 ``mods``; a, b and the AGCM result are each rounded to the
    element type; the AGCM result is zero outside the image (the 'same'
    padding of the input conv, applied after the modulation); the conv sums in
    fp32, adds the fp32 bias, and the ReLU / leaky ReLU (slope 0.1 in fp32)
    halves are rounded once on store."""
    dt = aw1.dtype
    x = _s2d_of_pairs(xs)
    hb, wb, cin = x.shape
    v = x.reshape(-1, cin).float() * scale

    def mod(v, row, width):
        return v * (mods[row, :width] + 1.0) + mods[row + 1, :width]

    def dot(v, w):
        return torch.matmul(_rounded(v, dt), w.float())

    a = torch.clamp_min(mod(dot(v, aw1) + ab1, 0, aw1.shape[1]), 0.0)
    b = torch.clamp_min(mod(dot(a, aw2) + ab2, 2, aw2.shape[1]), 0.0)
    agcm = mod(dot(b, aw3) + ab3, 4, cin).to(dt).reshape(hb, wb, cin)
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


def fused_agcm_head(
    xs: torch.Tensor, mods: torch.Tensor,
    aw1, ab1, aw2, ab2, aw3, ab3, w_in, b_in,
    *, n_first: int, scale: float = 1.0, packed: tuple | None = None,
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
    :func:`agcm_head_pack` of the same parameters, when the caller keeps one
    (only the CUDA kernel reads it)."""
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
    if native.on_cpu(xs, mods, aw1, ab1, aw2, ab2, aw3, ab3, w_in, b_in):
        return fused_agcm_head_ref(xs, mods, aw1, ab1, aw2, ab2, aw3, ab3, w_in, b_in,
                                   n_first=n_first, scale=scale)
    if c1 % 16 or c2 % 16 or co % 8 or n_first % 8:
        raise ValueError(f"agcm_head needs C1 % 16, C2 % 16, Co % 8 and n_first % 8 == 0, got {c1}, {c2}, {co}, {n_first}")
    aw1p, aw3p, wcat = packed if packed is not None else agcm_head_pack(aw1, aw3, w_in)
    native.check_cuda("agcm_head xs", xs, xs.dtype)
    native.check_cuda("agcm_head mods", mods, torch.float32)
    for name, t, shape in (("aw1 (packed)", aw1p, (16, c1)), ("aw2", aw2, (c1, c2)),
                           ("aw3 (packed)", aw3p, (c2, 16)), ("w_in (packed)", wcat, (112, co))):
        native.check_cuda(f"agcm_head {name}", t, dt, shape)
    for name, t in (("ab1", ab1), ("ab2", ab2), ("ab3", ab3), ("b_in", b_in)):
        native.check_cuda(f"agcm_head {name}", t, torch.float32)
    kind = 0 if xs.dtype == dt else (2 if xs.ndim == 4 else 1)
    fea = torch.empty((hb, wb, n_first), dtype=dt, device=xs.device)
    c0 = torch.empty((hb, wb, co - n_first), dtype=dt, device=xs.device)
    agcm = torch.empty((hb, wb, _CIN), dtype=dt, device=xs.device)
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


def fused_cond_chain_ref(c0, weights):
    """Plain version, the body of the Pallas ``_cond_chain_kernel``: the
    running value stays fp32 from step to step and is rounded to the weight's
    type at each product; sums, the fp32 bias and the leaky ReLU (all steps
    but the last) are fp32; ``c`` is the value after the second step and
    ``cond1`` the last, each rounded once on store."""
    v = c0.float()
    c = None
    for idx, (w, b) in enumerate(weights):
        v = torch.matmul(_rounded(v, w.dtype), w.float()) + b
        if idx != 4:
            v = _apply_act(v, "lrelu")
        if idx == 1:
            c = v.to(c0.dtype)
    return c, v.to(c0.dtype)


def fused_cond_chain(c0: torch.Tensor, weights) -> tuple[torch.Tensor, torch.Tensor]:
    """c0 (Hb, Wb, C) → (c, cond1): lrelu(cond_first.2), lrelu(cond_first.4)
    → ``c``, then lrelu(CondNet1.0), lrelu(CondNet1.2), CondNet1.4 →
    ``cond1``, in one pass. ``weights``: five (w (C, C'), b (C',)) pairs. The
    JAX kernel's int8 ``qargs`` form is not ported."""
    hb, wb, k = c0.shape
    dt = native.element_type("cond_chain c0", c0)
    if len(weights) != 5:
        raise ValueError(f"cond_chain takes five (w, b) pairs, got {len(weights)}")
    ws, bs = [w for w, _ in weights], [b for _, b in weights]
    native.check_params("cond_chain", dt, ws, bs)
    for w, b in weights:
        if w.ndim != 2 or w.shape[0] != k or tuple(b.shape) != (w.shape[1],):
            raise ValueError(f"cond_chain: step weight {tuple(w.shape)} / bias {tuple(b.shape)} after width {k}")
        k = w.shape[1]
    if native.on_cpu(c0, *ws, *bs):
        return fused_cond_chain_ref(c0, weights)
    if any(w.shape[0] % 16 or w.shape[1] % 8 for w in ws):
        raise ValueError("cond_chain needs every step's input % 16 and output % 8 == 0")
    native.check_cuda("cond_chain c0", c0, dt)
    for w, b in weights:
        native.check_cuda("cond_chain w", w, dt)
        native.check_cuda("cond_chain b", b, torch.float32)
    ints = ctypes.c_int * 5
    c = torch.empty((hb, wb, ws[1].shape[1]), dtype=dt, device=c0.device)
    cond1 = torch.empty((hb, wb, k), dtype=dt, device=c0.device)
    native.launch(
        "cond_chain", dt,
        c0.data_ptr(), c.data_ptr(), cond1.data_ptr(), native.pointer_array(ws), native.pointer_array(bs),
        ints(*[w.shape[0] for w in ws]), ints(*[w.shape[1] for w in ws]), hb * wb, native.stream_of(c0),
    )
    return c, cond1


# ---------------------------------------------------------------------------
# Output slice: SFT2 + HR_conv2 + conv_last + skip (+ RGB48 pack)
# ---------------------------------------------------------------------------


def fused_tail_ref(s, cond1, skip, sft_small, w_hr, b_hr, w_last, b_last, *, pack=True, up_coarse=None,
                   qargs_hr=None):
    """Plain version, the body of the Pallas ``_tail_kernel``: with
    ``up_coarse`` the SFT input is s + d2s(up_coarse) summed in fp32 and
    stored in the element type; the SFT's hidden activations are stored in
    it, scale, shift and t are fp32; t and h = relu(HR_conv2(t)) are each
    stored in the element type and are zero outside the image (both convs
    pad with zeros); conv_last sums in fp32, adds the fp32 bias and the skip;
    the pack rounds its multiply and its add separately and truncates. With
    ``qargs_hr`` (the int8 body) t stays fp32 and is quantized for HR_conv2;
    h is rounded to the element type as in the float body."""
    dt = s.dtype
    sf = s.float()
    if up_coarse is not None:
        sf = _rounded(sf + _d2s_fine(up_coarse).float(), dt)
    hacc = _sft_conv_t(sf, cond1.to(dt).float(), sft_small, w_hr, b_hr, qargs_hr, dt)
    h = _rounded(torch.clamp_min(hacc, 0.0), dt)
    y = _conv_same(h, w_last, b_last) + skip.float()
    if not pack:
        return y.to(dt)
    u = (y.clamp(0.0, 1.0) * 65535.0 + 0.5).to(torch.int32).to(torch.uint16)
    half = u.shape[-1] // 2
    return torch.stack([u[..., :half], u[..., half:]], dim=1)


def fused_tail(
    s: torch.Tensor, cond1: torch.Tensor, skip: torch.Tensor,
    sft_small, w_hr, b_hr, w_last, b_last,
    *, pack: bool = True, up_coarse: torch.Tensor | None = None, qargs_hr: QArgs | None = None,
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
    int8 body, ``tail_w8a8``; they stand in for ``w_hr`` and ``b_hr``)."""
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
    if cpu:
        return fused_tail_ref(s, cond1, skip, sft_small, w_hr, b_hr, w_last, b_last,
                              pack=pack, up_coarse=up_coarse, qargs_hr=qargs_hr)
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
        native.quant_params(qargs_hr), w_last.data_ptr(), b_last.data_ptr(), out.data_ptr(), t.data_ptr(),
        h.data_ptr(), hb, wb, c, cc, cl, int(pack), native.stream_of(s),
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


def fused_down2(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, act: str | None = None,
    cin: int | None = None, ch0: int = 0,
) -> torch.Tensor:
    """Stride-2 3×3 block conv, (1,0) pad: (Hb,Wb,C) → (Hb/2,Wb/2,Co).

    ``w``: (3,3,C,Co), the s2d-transformed stride-2 weight (the kernel is
    dense, so any weight gives the conv's result). ``act``: None | 'relu' |
    'lrelu'. ``cin``/``ch0``: read the ``[ch0:ch0+cin]`` channel window of a
    wider ``x`` in place (``ch0`` a multiple of ``cin``, as in the JAX
    contract); the plain version slices.
    """
    hb, wb, cf = x.shape
    c = _window("down2", cf, cin, ch0)
    if act not in _ACTS:
        raise ValueError(f"unknown act {act!r}")
    co = w.shape[-1]
    dt = native.element_type("down2 x", x)
    native.check_params("down2", dt, [w], [b])
    if native.on_cpu(x, w, b):
        return fused_down2_ref(x[..., ch0 : ch0 + c], w, b, act=act)
    if hb % 2 or wb % 2:
        raise ValueError(f"down2 needs even block dims, got {hb}x{wb}")
    if c % 16 or co % 4 or cf % 4:
        raise ValueError(f"down2 needs cin % 16, Co % 4 and C % 4 == 0, got {c}, {co}, {cf}")
    native.check_cuda("down2 x", x, dt)
    native.check_cuda("down2 w", w, dt, (3, 3, c, co))
    native.check_cuda("down2 b", b, torch.float32, (co,))
    out = torch.empty((hb // 2, wb // 2, co), dtype=dt, device=x.device)
    native.launch(
        "down2", dt,
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        hb, wb, cf, ch0, c, co, _ACTS[act], native.stream_of(x),
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
                dtype: torch.dtype) -> torch.Tensor:
    """An SFT and the 3×3 conv after it, fp32 with the bias: the float
    body's conv of t stored in ``dtype``, or the int8 body's of t quantized
    from fp32."""
    if qa is None:
        return _conv_same(_sft(x, cond, sft4, dtype), w, b)
    return _taps_conv_q(_sft_t(x, cond, sft4, dtype), qa)


def _d2s_fine(cu: torch.Tensor) -> torch.Tensor:
    """Block d2s of an unbatched coarse tensor, (Hc, Wc, 4C) → (2Hc, 2Wc, C):
    fine[2i+a, 2j+b, k] = coarse[i, j, (2a+b)·C + k]."""
    hc, wc, c4 = cu.shape
    c = c4 // 4
    return cu.reshape(hc, wc, 2, 2, c).permute(0, 2, 1, 3, 4).reshape(2 * hc, 2 * wc, c)


def fused_sft_conv3_v2_ref(x, cond, sft4, w, b, *, relu=False, skip=None, qargs=None):
    """Plain version, the body of the Pallas ``_sft_conv_kernel``: cond in the
    element type; hidden activations stored in it; scale, shift and t in
    fp32; t stored in the element type, zero outside the image (the conv's
    'same' padding); fp32 conv sum + fp32 bias + skip, ReLU, one rounding.
    With ``qargs`` (the int8 body) t stays fp32 and is quantized instead."""
    dt = x.dtype
    y = _sft_conv_t(x.float(), cond.to(dt).float(), sft4, w, b, qargs, dt)
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
) -> torch.Tensor:
    """y = conv3x3(sft(x, cond)) (+skip)(relu) over s2d tensors: x (Hb,Wb,C),
    cond (Hb,Wb,CC) → (Hb,Wb,Co).

    ``sft4``: four (w (in, out), b) pairs, scale0, scale1, shift0, shift1 (the
    s2d block-diagonal dense 1×1s). ``qargs``: the conv's int8 parameters
    (the int8 body, ``sft_conv3_w8a8``; they stand in for ``w`` and ``b``).
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
    if cpu:
        return fused_sft_conv3_v2_ref(x, cond, sft4, w, b, relu=relu, skip=skip, qargs=qargs)
    if c % 16 or cc % 16 or co % 4 or (qargs is not None and (c % 64 or co % 8)):
        raise ValueError(f"sft_conv3 needs C % 16, CC % 16 and Co % 4 == 0 (int8: C % 64 and Co % 8), "
                         f"got {c}, {cc}, {co}")
    native.check_cuda("sft_conv3 x", x, dt)
    native.check_cuda("sft_conv3 cond", cond, dt, (hb, wb, cc))
    native.check_cuda("sft_conv3 w", w, dt, (3, 3, c, co))
    native.check_cuda("sft_conv3 b", b, torch.float32, (co,))
    if skip is not None:
        native.check_cuda("sft_conv3 skip", skip, dt, (hb, wb, co))
    out = torch.empty((hb, wb, co), dtype=dt, device=x.device)
    t = torch.empty((hb, wb, c), dtype=dt if qargs is None else torch.int8, device=x.device)  # t or its codes
    native.launch(
        "sft_conv3", dt,
        x.data_ptr(), cond.data_ptr(), native.pointer_array(flat), w.data_ptr(), b.data_ptr(),
        native.quant_params(qargs), None if skip is None else skip.data_ptr(), out.data_ptr(), t.data_ptr(),
        hb, wb, c, cc, co, int(relu), native.stream_of(x),
        counter=None if qargs is None else "sft_conv3_w8a8",
    )
    return out


def fused_resblock_ref(x, cond, sft1, w1, b1, sft2, w2, b2, *, up_coarse=None, x_add=None,
                       qargs1=None, qargs2=None):
    """Plain version, the body of the Pallas ``_resblock_kernel``: with a
    second input the block input is x + d2s(up_coarse) (or x + x_add) summed
    in fp32 and stored in the element type, and that stored sum is the
    residual; h1 = relu(conv1 + b1) stays fp32 into SFT2; t1 and t2 are
    stored in the element type (quantized from fp32 in the int8 body, with
    ``qargs1`` and ``qargs2``); out = conv2 + b2 + input in fp32, one
    rounding."""
    dt = x.dtype
    xin = x.float()
    if up_coarse is not None:
        xin = _rounded(xin + _d2s_fine(up_coarse).float(), dt)
    elif x_add is not None:
        xin = _rounded(xin + x_add.float(), dt)
    cf = cond.to(dt).float()
    h1 = torch.clamp_min(_sft_conv_t(xin, cf, sft1, w1, b1, qargs1, dt), 0.0)
    return (_sft_conv_t(h1, cf, sft2, w2, b2, qargs2, dt) + xin).to(dt)


def fused_resblock(
    x: torch.Tensor, cond: torch.Tensor, sft1, w1, b1, sft2, w2, b2,
    *, up_coarse: torch.Tensor | None = None, x_add: torch.Tensor | None = None,
    qargs1: QArgs | None = None, qargs2: QArgs | None = None,
) -> torch.Tensor:
    """ResBlock_with_SFT in one call:

        out = xin + conv2( sft2( relu(conv1( sft1(xin, cond) )), cond ) )

    over x (Hb,Wb,C), cond (Hb,Wb,CC). ``up_coarse`` (Hb/2, Wb/2, 4C): xin =
    x + d2s(up_coarse), un-folded on read (trunk5's up path); ``x_add``
    (Hb,Wb,C): xin = x + x_add (trunk4's). Otherwise xin = x. ``qargs1`` and
    ``qargs2``: the two convs' int8 parameters, both or neither (the int8
    body, ``resblock_w8a8``).
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
    if cpu:
        return fused_resblock_ref(x, cond, sft1, w1, b1, sft2, w2, b2, up_coarse=up_coarse, x_add=x_add,
                                  qargs1=qargs1, qargs2=qargs2)
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
        hb, wb, c, cc, native.stream_of(x),
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


def fused_trunk3(
    fea3: torch.Tensor, cond4: torch.Tensor, blocks, w_up: torch.Tensor, b_up: torch.Tensor,
    *, packed: torch.Tensor | None = None,
) -> torch.Tensor:
    """The L3 natural stage in one call: 4 ResBlock_with_SFT, the trailing
    ``out + fea3`` skip and relu(up_conv1(out)), (H, W, 32) + cond (H, W, 16)
    → (H, W, Co).

    ``blocks``: 4 tuples (sft1, w1, b1, sft2, w2, b2), each sft a list of 4
    (w (in, out), b) pairs: scale_conv0, scale_conv1, shift_conv0,
    shift_conv1. ``w1``/``w2`` (3,3,C,C), ``w_up`` (3,3,C,Co) HWIO.
    ``packed``: :func:`trunk3_pack` of the same parameters, when the caller
    keeps one (only the CUDA kernel reads it).
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
    params = packed if packed is not None else trunk3_pack(blocks, w_up, b_up)
    want = native.lib().hdrtv_trunk3_param_floats(c, cc, co)
    if want == 0 or co % 4:
        raise ValueError(f"trunk3 is built for C=32, CC=16, Co % 4 == 0; got C={c} CC={cc} Co={co}")
    if params.numel() != want:
        raise ValueError(f"trunk3 parameter block has {params.numel()} floats, expected {want}")
    native.check_cuda("trunk3 params", params, torch.float32)
    scratch = torch.empty(3 * hb * wb * c, dtype=dt, device=fea3.device)
    out = torch.empty((hb, wb, co), dtype=dt, device=fea3.device)
    native.launch(
        "trunk3", dt,
        fea3.data_ptr(), cond4.data_ptr(), params.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), hb, wb, c, cc, co, native.stream_of(fea3),
    )
    return out


# ---------------------------------------------------------------------------
# Generic pointwise 1×1 chain (the small CondNet tails)
# ---------------------------------------------------------------------------


def fused_mix_chain_ref(x, steps):
    """Plain version, the body of the Pallas ``_mix_chain_kernel``: each step
    casts its input to the weight's type, sums in fp32, adds the fp32 bias
    and applies the activation in fp32; only the last result is rounded."""
    v = x
    for w, b, act in steps:
        v = _apply_act(torch.matmul(v.to(w.dtype).float(), w.float()) + b, act)
    return v.to(x.dtype)


def fused_mix_chain(x: torch.Tensor, steps, *, cin: int | None = None, ch0: int = 0) -> torch.Tensor:
    """Chain of 1×1 convs (+activations) in one pass: (Hb,Wb,C) → (Hb,Wb,C').

    ``steps``: list of (w (C, C'), b (C',), act ∈ {None, 'relu', 'lrelu'}).
    ``cin``/``ch0``: read the ``[ch0:ch0+cin]`` channel window of a wider
    ``x`` in place (``ch0`` a multiple of ``cin``); the plain version slices.
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
    if native.on_cpu(x, *ws, *bs):
        return fused_mix_chain_ref(x[..., ch0 : ch0 + c], steps)
    n_steps = len(steps)
    if not 1 <= n_steps <= native.lib().hdrtv_mix_chain_max_steps():
        raise ValueError(f"mix_chain takes 1 to {native.lib().hdrtv_mix_chain_max_steps()} steps, got {n_steps}")
    if cf % 4 or any(w.shape[0] % 16 or w.shape[1] % 4 for w in ws):
        raise ValueError("mix_chain needs C % 4 == 0 and every step's input % 16, output % 4 == 0")
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
        ints(*[_ACTS[a] for a in acts]), n_steps, hb * wb, cf, ch0, native.stream_of(x),
    )
    return out
