"""Training / fine-tuning step (QAT recipe losses) over the natural-layout
model (port of ``hdrtv_tpu/train.py``).

The reference trains offline via QAT scripts with FP32-teacher distillation:
weighted combination of teacher L1, highlight-region L1 and dark-region L1
(scripts/quantize/quantize_int8_mixed_qat.py — teacher 0.68/0.65, highlight
0.38/0.35, dark 0.36/0.34; README.md:1174-1187). This module gives the
same loss and step with ``torch.autograd`` in place of
``jax.value_and_grad`` and ``torch.optim.Adam`` in place of ``optax.adam``.
The parameters live on one device (the CUDA card unless the caller names
another); the step runs under the policy's math (fp32: TF32 off, forward
and backward).

Every float leaf of the parameter dict is trained, as in the JAX step. A
leaf the loss does not reach gets no gradient here (zero there); Adam leaves
it unchanged in both.

The train state is written in the port's own format, one ``torch.save``
file: the flat parameter dict, the names of the trained leaves, the step
and the optimizer's ``state_dict``. (The JAX package pickles a JAX pytree
definition into an npz, which cannot be read without JAX.)
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig, model_apply, natural_params_to_torch
from hdrtv_tpu_torch.models.layers import F32, Policy

ADAM_BETAS = (0.9, 0.999)  # optax.adam's defaults
ADAM_EPS = 1e-8
STATE_FORMAT = "hdrtv_tpu_torch.train_state/1"


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Mixed-QAT recipe defaults (quantize_int8_mixed_qat.py)."""

    gt: float = 1.0
    teacher: float = 0.68
    highlight: float = 0.38
    dark: float = 0.36
    highlight_thresh: float = 0.75
    dark_thresh: float = 0.15


def qat_loss(
    out: torch.Tensor,
    gt: torch.Tensor,
    teacher_out: torch.Tensor | None,
    w: LossWeights = LossWeights(),
) -> torch.Tensor:
    """L1 to GT + teacher distillation + tone-protected highlight/dark terms."""
    out = out.float()
    gt = gt.float()
    loss = w.gt * (out - gt).abs().mean()
    ref = gt if teacher_out is None else teacher_out.float()
    if teacher_out is not None:
        loss = loss + w.teacher * (out - ref).abs().mean()
    # Tone-protection masks: luminance regions where quantization artifacts
    # (highlight rolloff / dark banding) are most visible.
    lum = ref.amax(dim=-1, keepdim=True)
    hl = (lum > w.highlight_thresh).float()
    dk = (lum < w.dark_thresh).float()
    loss = loss + w.highlight * (hl * (out - ref).abs()).sum() / torch.clamp_min(hl.sum() * 3, 1.0)
    loss = loss + w.dark * (dk * (out - ref).abs()).sum() / torch.clamp_min(dk.sum() * 3, 1.0)
    return loss


@dataclasses.dataclass
class TrainState:
    """The parameters (name → tensor on the device; the float leaves
    require grad), the Adam optimizer over the float leaves, the step."""

    params: dict
    optimizer: torch.optim.Optimizer
    step: int = 0


def _trainable(params: dict) -> list[str]:
    return [k for k, v in params.items() if v.is_floating_point()]


def _adam(tensors: list[torch.Tensor], lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(tensors, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)


def make_train_step(
    cfg: ModelConfig,
    *,
    policy: Policy = F32,
    weights: LossWeights = LossWeights(),
    fake_quant: Callable[[dict], dict] | None = None,
) -> Callable:
    """Build ``train_step(state, img, cond, gt[, teacher_out]) -> (state, loss)``.

    ``fake_quant`` hooks the QAT straight-through-estimator weight transform
    (quant/qat.py) into the forward pass; gradients flow to the latent fp32
    params through the STE's identity backward. The state is updated in
    place and returned; ``loss`` is the step's loss, detached (before the
    update). After the step each trained leaf's ``.grad`` holds its
    gradient (None where the loss did not reach it).
    """

    def loss_fn(params, img, cond, gt, teacher_out):
        p = fake_quant(params) if fake_quant is not None else params
        out = model_apply(p, img, cond, cfg, policy=policy)
        return qat_loss(out, gt, teacher_out, weights)

    def train_step(state: TrainState, img, cond, gt, teacher_out=None):
        with torch.enable_grad(), policy.math():
            state.optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(state.params, img, cond, gt, teacher_out)
            loss.backward()
            state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return train_step


def init_state(params: dict, *, lr: float, device=None, policy: Policy = F32) -> TrainState:
    """Numpy ``params`` on ``device`` (the CUDA card unless the caller names
    another) as the natural program reads them, every float leaf trainable
    under Adam(lr, betas=(0.9, 0.999), eps=1e-8); int8 payloads stay
    frozen buffers."""
    from hdrtv_tpu_torch.utils.device import compute_device

    dev = compute_device(device)
    p = natural_params_to_torch(params, dev, policy)
    names = _trainable(p)
    for k in names:
        p[k].requires_grad_(True)
    return TrainState(params=p, optimizer=_adam([p[k] for k in names], lr))


# ---------------------------------------------------------------------------
# Checkpoint / resume (QAT early-stop + best-by-monitor pattern, SURVEY.md §5)
# ---------------------------------------------------------------------------


def _state_path(path: str) -> str:
    return path if os.path.splitext(path)[1] else path + ".pt"


def save_train_state(path: str, state: TrainState) -> str:
    """Persist params + optimizer state to one ``torch.save`` file (``.pt``
    added where ``path`` has no suffix); returns the path written."""
    out = _state_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save({
        "format": STATE_FORMAT,
        "step": int(state.step),
        "params": {k: v.detach().cpu() for k, v in state.params.items()},
        "trainable": _trainable(state.params),
        "optimizer": state.optimizer.state_dict(),
    }, out)
    return out


def load_train_state(path: str, *, device=None) -> TrainState:
    """The state :func:`save_train_state` wrote, on ``device`` (the CUDA
    card unless the caller names another), its optimizer resumed."""
    from hdrtv_tpu_torch.utils.device import compute_device

    dev = compute_device(device)
    blob = torch.load(_state_path(path), map_location="cpu", weights_only=True)
    if blob.get("format") != STATE_FORMAT:
        raise ValueError(f"{path}: not a train state of the port ({blob.get('format')!r})")
    params = {k: v.to(dev) for k, v in blob["params"].items()}
    names = blob["trainable"]
    for k in names:
        params[k].requires_grad_(True)
    lr = blob["optimizer"]["param_groups"][0]["lr"]
    opt = _adam([params[k] for k in names], lr)
    opt.load_state_dict(blob["optimizer"])
    return TrainState(params=params, optimizer=opt, step=int(blob["step"]))


def params_to_numpy(params: dict) -> dict:
    """A state's parameters as a numpy dict (a checkpoint's contents)."""
    return {k: np.asarray(v.detach().cpu().numpy()) for k, v in params.items()}
