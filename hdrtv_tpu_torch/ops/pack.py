"""The per-pixel output slices (port of ``hdrtv_tpu/ops/pack.py``).

``pack_rgb48``: the network output [0,1] RGB is the BT.2020/PQ signal;
delivery is ``clamp(0,1)·65535 + 0.5 → uint16``, truncating.

``colorimetric_pq_pack``: the explicit colour-managed slice, SDR
linearisation (gamma 2.4), BT.709 → BT.2020 gamut map, scale to display
nits, ST 2084 PQ encode, u16 pack, in one pass. No frame program reaches it
(nor in the JAX package): it serves the metric path and as an output option.

On a CUDA tensor each launches its kernel (``csrc/pack.cu``,
``csrc/colorimetric.cu``, which reads tables built once per device and
parameters); on a CPU tensor it runs the plain version. A bf16 input is
widened to fp32 first.
"""

from __future__ import annotations

import torch

from hdrtv_tpu_torch.ops import native
from hdrtv_tpu_torch.ops.color import BT709_TO_BT2020, PQ_C1, PQ_C2, PQ_C3, PQ_M1, PQ_M2


def pack_rgb48_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: the multiply and the add round separately, as in the
    JAX ``pack_rgb48_ref``."""
    v = x.float().clamp(0.0, 1.0) * 65535.0 + 0.5
    return v.to(torch.int32).to(torch.uint16)


def pack_rgb48(x: torch.Tensor) -> torch.Tensor:
    """[0,1] RGB (…, W, 3) float32 or bfloat16 → uint16 RGB48 code values,
    same shape. The kernel takes any contiguous input, a view at an offset
    that is not 16-byte aligned included: the output then lies as many
    elements past a 16-byte boundary (a view into a slightly longer
    buffer), so that the kernel's groups of 8 start at the same element of
    both after a scalar head."""
    dt = native.element_type("pack_rgb48 input", x)
    if native.on_cpu(x):
        return pack_rgb48_ref(x)
    native.check_cuda("pack_rgb48 input", x, dt, align=x.element_size())
    off = (x.data_ptr() % 16) // x.element_size()
    if off:
        out = torch.empty(x.numel() + off, dtype=torch.uint16, device=x.device)[off:].view(x.shape)
    else:
        out = torch.empty(x.shape, dtype=torch.uint16, device=x.device)
    native.launch("pack_rgb48", dt, x.data_ptr(), out.data_ptr(), x.numel(), native.stream_of(x))
    return out


def _pq_oetf_f32(y: torch.Tensor) -> torch.Tensor:
    y = y.clamp(0.0, 1.0)
    y_m1 = torch.pow(y, PQ_M1)
    return torch.pow((PQ_C1 + PQ_C2 * y_m1) / torch.clamp_min(1.0 + PQ_C3 * y_m1, 1e-12), PQ_M2)


def colorimetric_pq_pack_ref(x: torch.Tensor, *, peak_nits: float = 1000.0, gamma: float = 2.4) -> torch.Tensor:
    """Plain version, the JAX ``colorimetric_pq_pack_ref`` in torch ops, fp32."""
    lin = torch.pow(x.float().clamp(0.0, 1.0), gamma)
    m = torch.from_numpy(BT709_TO_BT2020).to(lin.device)
    lin2020 = torch.einsum("...c,rc->...r", lin, m)
    pq = _pq_oetf_f32(lin2020 * (peak_nits / 10000.0))
    return (pq * 65535.0 + 0.5).to(torch.int32).to(torch.uint16)


# The colorimetric kernel's tables on each device, for one (peak_nits, gamma):
# device index -> ((peak_nits, gamma), PQ code thresholds (65537,) fp32, gamma
# table (0x3F81,) fp32, the kernel's float arguments).
_COLOR_TABLES: dict = {}
COLOR_CODES = 65536
COLOR_GAMMA_ENTRIES = 0x3F81  # the bf16 bit patterns of [0, 1]


def _color_params(peak_nits: float, gamma: float) -> tuple:
    return (*[float(v) for v in BT709_TO_BT2020.reshape(-1)], PQ_M1, PQ_M2, PQ_C1, PQ_C2, PQ_C3,
            float(peak_nits) / 10000.0, float(gamma))


def colorimetric_tables(device: torch.device, peak_nits: float, gamma: float) -> tuple:
    """The tables the colorimetric kernel reads (``csrc/colorimetric.cu``)
    and its float arguments: the 65,536 thresholds of the exact PQ curve's
    codes in BT.2020 linear light for ``peak_nits`` (and +inf after them)
    and the powers ``x ** gamma`` of the bf16 values in [0, 1], built on the
    device by the file's own kernel (counted as ``colorimetric_tables``), one
    set per device, built again when ``peak_nits`` or ``gamma`` changes. The
    build waits for its stream once, so that a call on another stream finds
    the tables whole; a CUDA graph that captured a call reads the tables of
    that call's parameters and must not outlive a rebuild."""
    key = (float(peak_nits), float(gamma))
    held = _COLOR_TABLES.get(device.index)
    if held is not None and held[0] == key:
        return held[1:]
    thr = torch.empty(COLOR_CODES + 1, dtype=torch.float32, device=device)
    gam = torch.empty(COLOR_GAMMA_ENTRIES, dtype=torch.float32, device=device)
    params = _color_params(peak_nits, gamma)
    native.launch("colorimetric_tables", torch.float32, thr.data_ptr(), gam.data_ptr(), *params,
                  native.stream_of(thr))
    torch.cuda.current_stream(device).synchronize()
    _COLOR_TABLES[device.index] = (key, thr, gam, params)
    return thr, gam, params


def colorimetric_pq_pack(x: torch.Tensor, *, peak_nits: float = 1000.0, gamma: float = 2.4) -> torch.Tensor:
    """SDR [0,1] RGB (…, W, 3) float32 or bfloat16 → BT.2020/PQ uint16 code
    values, same shape. The kernel gives the codes of the exact PQ curve
    (evaluated to a few hundredths of a code, the thresholds of
    :func:`colorimetric_tables` deciding near a boundary), the plain version
    ``torch.pow``'s in fp32: the two agree within a code or two (exactly at
    0 and 1)."""
    dt = native.element_type("colorimetric_pq_pack input", x)
    if x.shape[-1] != 3:
        raise ValueError(f"colorimetric_pq_pack takes RGB triplets (…, 3), got {tuple(x.shape)}")
    if native.on_cpu(x):
        return colorimetric_pq_pack_ref(x, peak_nits=peak_nits, gamma=gamma)
    native.check_cuda("colorimetric_pq_pack input", x, dt)
    thr, gam, params = colorimetric_tables(x.device, peak_nits, gamma)
    out = torch.empty(x.shape, dtype=torch.uint16, device=x.device)
    native.launch("colorimetric", dt, x.data_ptr(), out.data_ptr(), x.numel() // 3, *params, thr.data_ptr(),
                  gam.data_ptr(), native.stream_of(x))
    return out
