"""RGB48 delivery pack (port of ``hdrtv_tpu/ops/pack.py`` ``pack_rgb48``).

The network output [0,1] RGB is the BT.2020/PQ signal; delivery is
``clamp(0,1)·65535 + 0.5 → uint16``, truncating. On a CUDA tensor this
launches the kernel of ``csrc/pack.cu``; on a CPU tensor it runs the plain
version. A bf16 input is widened to fp32 first, so both element types pack
exactly.
"""

from __future__ import annotations

import torch

from hdrtv_tpu_torch.ops import native


def pack_rgb48_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: the multiply and the add round separately, as in the
    JAX ``pack_rgb48_ref``."""
    v = x.float().clamp(0.0, 1.0) * 65535.0 + 0.5
    return v.to(torch.int32).to(torch.uint16)


def pack_rgb48(x: torch.Tensor) -> torch.Tensor:
    """[0,1] RGB (…, W, 3) float32 or bfloat16 → uint16 RGB48 code values,
    same shape."""
    dt = native.element_type("pack_rgb48 input", x)
    if native.on_cpu(x):
        return pack_rgb48_ref(x)
    native.check_cuda("pack_rgb48 input", x, dt)
    out = torch.empty(x.shape, dtype=torch.uint16, device=x.device)
    native.launch("pack_rgb48", dt, x.data_ptr(), out.data_ptr(), x.numel(), native.stream_of(x))
    return out
