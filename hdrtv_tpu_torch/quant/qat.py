"""QAT: straight-through-estimator fake quantization for fine-tuning (port
of ``hdrtv_tpu/quant/qat.py``).

The reference QAT scripts train with ``_FakeQuantizeSTE`` on Conv/Linear
weights plus the teacher-distillation loss recipe
(scripts/quantize/quantize_int8_mixed_qat.py:188; README.md:1174-1187).
Here fake-quant is a dict transform applied inside the loss function
(hooked via ``train.make_train_step(fake_quant=...)``): latent weights stay
fp32, the forward sees round(w/s)·s, and the ``torch.autograd.Function``'s
backward passes gradients straight through the rounding.
"""

from __future__ import annotations

import numpy as np
import torch


class _FakeQuantSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w):
        dims = tuple(range(w.ndim - 1))
        a = w.abs() if not dims else w.abs().amax(dim=dims, keepdim=True)  # amax over () would reduce every axis
        scale = torch.clamp_min(a, 1e-8) / 127.0
        q = torch.clamp(torch.round(w / scale), -128.0, 127.0)
        return q * scale

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quant_ste(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric int8 fake-quant (round/clamp like
    W8Conv2d; the output channel is the last axis of HWIO and (in, out)
    weights) with identity gradient."""
    return _FakeQuantSTE.apply(w)


def make_weight_fake_quant(layers: list[str]):
    """Dict transform fake-quantizing ``{layer}.weight`` for the given
    layers — plug into train.make_train_step(fake_quant=...)."""
    targets = {f"{l}.weight" for l in layers}

    def transform(params: dict) -> dict:
        return {k: fake_quant_ste(v) if k in targets else v for k, v in params.items()}

    return transform


def run_qat(
    params: dict,
    cfg,
    layers: list[str],
    frames,
    *,
    steps: int = 50,
    lr: float = 2e-6,
    mode: str = "w8a8",
    asymmetric: bool = True,
    distill: bool = True,
    calibrate_after: bool = True,
    policy=None,
    log=print,
    device=None,
) -> tuple[dict, list[float]]:
    """Teacher-distilled QAT fine-tune → calibrated portable int8 params.

    The reference recipe (scripts/quantize/quantize_int8_mixed_qat.py;
    README.md:1174-1187): STE fake-quant on the selected layers, FP32-teacher
    distillation with highlight/dark tone-protection losses, then freeze into
    a portable checkpoint. ``frames``: [0,1] RGB HWC arrays (paired GT would
    replace the teacher where available). The steps run on ``device``: the
    CUDA card unless the caller names another.
    """
    from hdrtv_tpu_torch.utils.device import compute_device
    from hdrtv_tpu_torch.models.hdrtvnet import model_apply, natural_params_to_torch
    from hdrtv_tpu_torch.models.layers import F32
    from hdrtv_tpu_torch.quant.calibrate import frame_inputs
    from hdrtv_tpu_torch.train import init_state, make_train_step, params_to_numpy

    dev = compute_device(device)
    policy = policy or F32
    teacher = natural_params_to_torch(params, dev, policy)
    fq = make_weight_fake_quant(layers)
    train = make_train_step(cfg, policy=policy, fake_quant=fq)
    state = init_state(params, lr=lr, device=dev, policy=policy)

    losses: list[float] = []
    n = max(1, len(frames))
    for i in range(steps):
        with torch.no_grad(), policy.math():
            img, cond = frame_inputs(frames[i % n], dev)
            t_out = model_apply(teacher, img, cond, cfg, policy=policy) if distill else None
        gt = t_out if distill else img
        state, loss = train(state, img, cond, gt, t_out)
        losses.append(float(loss))
        if log and (i % 10 == 0 or i == steps - 1):
            log(f"qat step {i}: loss {losses[-1]:.5f}")

    q = finalize_qat(params_to_numpy(state.params), layers, mode=mode, asymmetric=asymmetric)
    if calibrate_after and mode == "w8a8":
        from hdrtv_tpu_torch.quant.calibrate import calibrate

        q = calibrate(q, frames, cfg, policy=policy, device=dev)
    return q, losses


def finalize_qat(params: dict, layers: list[str], *, mode: str = "w8a8", asymmetric: bool = False) -> dict:
    """Freeze trained latent weights into a real int8 checkpoint
    (the QAT → portable-checkpoint step, make_portable_int8_checkpoint.py)."""
    from hdrtv_tpu_torch.quant.int8 import quantize_params

    host = {k: np.asarray(v) for k, v in params.items()}
    return quantize_params(host, layers, mode=mode, asymmetric=asymmetric)
