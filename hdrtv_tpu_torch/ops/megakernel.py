"""Fused s2d-domain kernels (port of the ``hdrtv_tpu/ops/megakernel.py``
kernels on the non-mega frame programs: ``fused_down2``, ``fused_trunk3``,
``fused_sft_conv3_v2``, ``fused_resblock`` and ``fused_mix_chain``).

Each function takes the JAX kernel's arguments and layouts. On CUDA tensors
it launches the kernel of ``csrc/``; on CPU tensors it runs the plain
version beside it. Activations and weights are float32 or bfloat16 (one
element type per call, that of the activations); biases are float32.

In bfloat16 the rounding points are the contract: each plain version rounds
exactly where the Pallas *kernel body* casts to the compute dtype (which is
not always where the JAX ``*_ref`` beside it does), and the CUDA kernels
round at the same places. Sums are fp32 everywhere.
"""

from __future__ import annotations

import ctypes

import torch

from hdrtv_tpu_torch.models.layers import conv_nhwc, leaky_relu
from hdrtv_tpu_torch.ops import native

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


def _sft(x: torch.Tensor, cond: torch.Tensor, sft4, dtype: torch.dtype) -> torch.Tensor:
    """t = x·(scale+1)+shift in fp32 (``x``, ``cond`` fp32), stored in ``dtype``."""
    scale = _sft_mix(cond, sft4[0], sft4[1], dtype)
    shift = _sft_mix(cond, sft4[2], sft4[3], dtype)
    return _rounded(x * (scale + 1.0) + shift, dtype)


def _d2s_fine(cu: torch.Tensor) -> torch.Tensor:
    """Block d2s of an unbatched coarse tensor, (Hc, Wc, 4C) → (2Hc, 2Wc, C):
    fine[2i+a, 2j+b, k] = coarse[i, j, (2a+b)·C + k]."""
    hc, wc, c4 = cu.shape
    c = c4 // 4
    return cu.reshape(hc, wc, 2, 2, c).permute(0, 2, 1, 3, 4).reshape(2 * hc, 2 * wc, c)


def fused_sft_conv3_v2_ref(x, cond, sft4, w, b, *, relu=False, skip=None):
    """Plain version, the body of the Pallas ``_sft_conv_kernel``: cond in the
    element type; hidden activations stored in it; scale, shift and t in
    fp32; t stored in the element type, zero outside the image (the conv's
    'same' padding); fp32 conv sum + fp32 bias + skip, ReLU, one rounding."""
    dt = x.dtype
    t = _sft(x.float(), cond.to(dt).float(), sft4, dt)
    y = _conv_same(t, w, b)
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
    *, relu: bool = False, skip: torch.Tensor | None = None,
) -> torch.Tensor:
    """y = conv3x3(sft(x, cond)) (+skip)(relu) over s2d tensors: x (Hb,Wb,C),
    cond (Hb,Wb,CC) → (Hb,Wb,Co).

    ``sft4``: four (w (in, out), b) pairs, scale0, scale1, shift0, shift1 (the
    s2d block-diagonal dense 1×1s). The JAX kernel's int8 ``qargs`` form is
    not ported.
    """
    hb, wb, c = x.shape
    cc = cond.shape[-1]
    co = w.shape[-1]
    dt = native.element_type("sft_conv3 x", x)
    native.check_params("sft_conv3", dt, [w], [b])
    tensors = [x, cond, w, b] + ([] if skip is None else [skip])
    cpu = native.on_cpu(*tensors, *[t for pair in sft4 for t in pair])
    flat = _check_sft("sft_conv3", sft4, dt, c, cc, not cpu)
    if cpu:
        return fused_sft_conv3_v2_ref(x, cond, sft4, w, b, relu=relu, skip=skip)
    if c % 16 or cc % 16 or co % 4:
        raise ValueError(f"sft_conv3 needs C % 16, CC % 16 and Co % 4 == 0, got {c}, {cc}, {co}")
    native.check_cuda("sft_conv3 x", x, dt)
    native.check_cuda("sft_conv3 cond", cond, dt, (hb, wb, cc))
    native.check_cuda("sft_conv3 w", w, dt, (3, 3, c, co))
    native.check_cuda("sft_conv3 b", b, torch.float32, (co,))
    if skip is not None:
        native.check_cuda("sft_conv3 skip", skip, dt, (hb, wb, co))
    sft_ptrs = native.pointer_array(flat)
    t = torch.empty((hb, wb, c), dtype=dt, device=x.device)
    out = torch.empty((hb, wb, co), dtype=dt, device=x.device)
    native.launch(
        "sft_conv3", dt,
        x.data_ptr(), cond.data_ptr(), sft_ptrs, w.data_ptr(), b.data_ptr(),
        None if skip is None else skip.data_ptr(), out.data_ptr(), t.data_ptr(),
        hb, wb, c, cc, co, int(relu), native.stream_of(x),
    )
    return out


def fused_resblock_ref(x, cond, sft1, w1, b1, sft2, w2, b2, *, up_coarse=None, x_add=None):
    """Plain version, the body of the Pallas ``_resblock_kernel``: with a
    second input the block input is x + d2s(up_coarse) (or x + x_add) summed
    in fp32 and stored in the element type, and that stored sum is the
    residual; h1 = relu(conv1 + b1) stays fp32 into SFT2; t1 and t2 are
    stored in the element type; out = conv2 + b2 + input in fp32, one
    rounding."""
    dt = x.dtype
    xin = x.float()
    if up_coarse is not None:
        xin = _rounded(xin + _d2s_fine(up_coarse).float(), dt)
    elif x_add is not None:
        xin = _rounded(xin + x_add.float(), dt)
    cf = cond.to(dt).float()
    h1 = torch.clamp_min(_conv_same(_sft(xin, cf, sft1, dt), w1, b1), 0.0)
    return (_conv_same(_sft(h1, cf, sft2, dt), w2, b2) + xin).to(dt)


def fused_resblock(
    x: torch.Tensor, cond: torch.Tensor, sft1, w1, b1, sft2, w2, b2,
    *, up_coarse: torch.Tensor | None = None, x_add: torch.Tensor | None = None,
) -> torch.Tensor:
    """ResBlock_with_SFT in one call:

        out = xin + conv2( sft2( relu(conv1( sft1(xin, cond) )), cond ) )

    over x (Hb,Wb,C), cond (Hb,Wb,CC). ``up_coarse`` (Hb/2, Wb/2, 4C): xin =
    x + d2s(up_coarse), un-folded on read (trunk5's up path); ``x_add``
    (Hb,Wb,C): xin = x + x_add (trunk4's). Otherwise xin = x. The JAX
    kernel's int8 ``qargs`` forms are not ported.
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
    if cpu:
        return fused_resblock_ref(x, cond, sft1, w1, b1, sft2, w2, b2, up_coarse=up_coarse, x_add=x_add)
    if c % 16 or cc % 16:
        raise ValueError(f"resblock needs C % 16 and CC % 16 == 0, got {c}, {cc}")
    native.check_cuda("resblock x", x, dt)
    native.check_cuda("resblock cond", cond, dt, (hb, wb, cc))
    for name, w, b in (("1", w1, b1), ("2", w2, b2)):
        native.check_cuda(f"resblock w{name}", w, dt, (3, 3, c, c))
        native.check_cuda(f"resblock b{name}", b, torch.float32, (c,))
    if x_add is not None:
        native.check_cuda("resblock x_add", x_add, dt, (hb, wb, c))
    if up_coarse is not None:
        native.check_cuda("resblock up_coarse", up_coarse, dt)
    p1, p2 = native.pointer_array(flat1), native.pointer_array(flat2)
    t = torch.empty((hb, wb, c), dtype=dt, device=x.device)
    h1 = torch.empty((hb, wb, c), dtype=torch.float32, device=x.device)
    xsum = None if second is None else torch.empty((hb, wb, c), dtype=dt, device=x.device)
    out = torch.empty((hb, wb, c), dtype=dt, device=x.device)
    native.launch(
        "resblock", dt,
        x.data_ptr(), cond.data_ptr(), p1, w1.data_ptr(), b1.data_ptr(),
        p2, w2.data_ptr(), b2.data_ptr(),
        None if second is None else second.data_ptr(), int(up_coarse is not None),
        out.data_ptr(), t.data_ptr(), h1.data_ptr(),
        None if xsum is None else xsum.data_ptr(),
        hb, wb, c, cc, native.stream_of(x),
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
