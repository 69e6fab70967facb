"""HDRTVNetTorch — the inference runtime of the port (counterpart of
``hdrtv_tpu/runtime/processor.py`` ``HDRTVNetTPU``).

    uint8 BGR frame as (Hb, 2, Wb, 6) row-pair planes
        ──► ¼-res AA-bicubic cond (two matmuls) → classifier → modulation vectors
        ──► agcm_head (AGCM + LE input conv; /255 and BGR→RGB folded in)
        ──► cond_chain → sft_conv3, down2, mix_chain, resblock, trunk3, block_conv3
        ──► tail (SFT + HR_conv2 + conv_last + long skip + u16 RGB48 pack)

Three frame programs of the base model are ported (ROADMAP.md, slices 1 to
3). bf16, the product's default precision, runs the megakernel program above,
as ``HDRTVNetTPU`` does, wherever ``models/s2d.py _mega_ok`` holds (1080p, and
any frame whose half height has an even divisor up to 12). With
``HDRTV_MEGAKERNEL=0`` in the environment, read at each call, bf16 runs the
program without the three L0 megakernels (torch glue at L0, pack_rgb48 at
the end), as the JAX package does with the same setting. fp32 is the accuracy
reference: the same program without the SFT kernels.

With a composite checkpoint (``base.*`` + ``hg.*`` keys, ``use_hg`` in its
sidecar or as an argument) each of them becomes the HG composite program
(slice 4), in the two stages the JAX runtime splits it into:

    uint8 BGR frame as (H, 3W) byte rows
        ──► the base program above to its s2d output (1, Hb, Wb, 12), unpacked
            (models/s2d.py ensemble_s2d_base_flat)
        ──► highlight mask → /16-grid reflect pad → the HG generator
            (conv1 in s2d, a torch-conv UNet below, Up_conv5 back in s2d)
        ──► hg_tail (conv10 + conv_last + mask composite + u16 RGB48 pack), crop
            (models/hg_s2d.py hg_composite_s2d, pack=True, tail_on=True)

``HDRTV_HG_TAIL=0`` in the environment, read at each call, replaces the
hg_tail kernel by the torch-op tail, as in the JAX package.

An int8 checkpoint (``.weight_int8`` keys; slice 6) takes the JAX runtime's
route: its weights are pre-dequantized to float at load
(``HDRTVNET_PREDEQUANTIZE``, on by default), s2d-transformed, and, for a
W8A8 checkpoint, the int8 codes and scales of the layers the kernels
quantize are attached (``models/s2d.py attach_native_int8``;
``HDRTVNET_NATIVE_INT8``, on by default, read at load). Each of the three
base programs above then runs those layers' convs in the kernels' int8 forms
(block_conv3, sft_conv3, resblock and tail): activations quantized per
tensor, int8 × int8 → int32 products. ``HDRTV_INT8_DOWN2=1``, read at each
call, also runs the stride-2 convs the JAX package quantizes then (the
consolidated CondNet down conv and CondNet3.2/4.2 at nf = 32) in down2's int8
form. A composite (HG) int8 checkpoint runs the HG composite after the int8
base program, its HG in float on the pre-dequantized weights, as in the JAX
package. A weight-only (W8) checkpoint, or ``HDRTVNET_NATIVE_INT8=0``, runs
the float program on the pre-dequantized weights.

The natural-layout program (slice 5) takes every frame the s2d programs do
not, by the JAX runtime's rule: frames whose sides are not both multiples of
8 (the 540p preset, 960 × 540, among them), and every frame when ``turbo``
is off (``turbo=False`` or ``HDRTVNET_TPU_TURBO=0``, and always for an int8
checkpoint kept int8 by ``predequantize=False``):

    uint8 BGR frame as (H, 3W) byte rows
        ──► BGR→RGB · f32(1/255) → ¼-res AA-bicubic cond
        ──► models/hdrtvnet.py model_apply on the untransformed parameters
            (AGCM → LE SFT-UNet, and with HG the /32-padded generator), torch ops
        ──► pack_rgb48 (the kernel)

With ``predequantize=False`` the int8 layers stay int8 and run eagerly:
weights dequantized at each use, activations fake-quantized (W8A8).

Everything else raises with the ROADMAP item that will port it; nothing falls
back to a different computation, and nothing runs on the CPU unless the
caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig, model_apply, natural_params_to_torch
from hdrtv_tpu_torch.models.hg_s2d import hg_composite_s2d
from hdrtv_tpu_torch.models.import_npz import load_npz, load_npz_meta, npz_arch_dict
from hdrtv_tpu_torch.models.layers import Policy, policy_for
from hdrtv_tpu_torch.models.s2d import (
    attach_native_int8,
    ensemble_s2d_base_flat,
    ensemble_s2d_rgb48_flat,
    ensemble_s2d_rgb48_pairs,
    params_to_torch,
    s2d_transform_params,
)
from hdrtv_tpu_torch.ops.pack import pack_rgb48
from hdrtv_tpu_torch.ops.resize import downsample_quarter_aa
from hdrtv_tpu_torch.quant.int8 import predequantize_params
from hdrtv_tpu_torch.utils.env import env_bool


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to hdrtv_tpu_torch yet: ROADMAP.md {item}")


def _env_on(*names: str) -> bool:
    """Any of the variables set truthy."""
    return any(env_bool(n) for n in names)


# The base model's width the card's routes are built for: the s2d programs'
# Hopper tiles and trunk3 take the nf = 32 checkpoint's natural widths alone.
CARD_NF = 32


def check_card_widths(cfg: ModelConfig, device: str | torch.device, *, turbo: bool = True) -> None:
    """Refuse at load what would fail at the first frame: on a CUDA device,
    the space-to-depth programs (``turbo``) of a checkpoint whose ``nf`` is
    not CARD_NF. Their kernels are built for its natural widths (trunk 32
    channels, SFT condition 16, CondNet 64; s2d blocks of 128) and raise on
    others, with no dense fallback. The CPU, whose plain versions take any
    width, and the natural-layout program (``turbo`` off: torch ops and the
    pack) take every nf."""
    if torch.device(device).type == "cuda" and turbo and cfg.nf != CARD_NF:
        raise ValueError(
            f"the card's space-to-depth programs take the nf = {CARD_NF} base model's widths (trunk 32 "
            f"channels, SFT condition 16, CondNet 64, s2d blocks of 128); this checkpoint has nf = {cfg.nf}. "
            "Run it with turbo=False (the natural-layout program) or on device='cpu'"
        )


class HDRTVNetTorch:
    """Real-time SDR→HDR10 converter on one CUDA device.

    ``model_path``: a converted ``.npz`` checkpoint (with its ``.json``
    sidecar). ``precision``: the reference token: ``fp32``/``float32`` is
    true fp32 (TF32 off for the torch ops), every other token (the default
    ``fp16``, the int8 presets) computes in bf16. The parameters are cast to
    what the policy computes with once, here.
    ``device``: ``None`` means ``"cuda"`` and raises without a CUDA device;
    ``"cpu"`` runs the kernels' plain versions (the tests' mode).
    ``predequantize``: for an int8 checkpoint, expand the int8 weights to
    float at load (``None`` reads ``HDRTVNET_PREDEQUANTIZE``, default on;
    off keeps them int8 and runs the eager W8A8 natural program on every
    frame). ``predequantized`` and ``native_int8`` say what the load did.
    ``turbo``: the space-to-depth programs (``None`` reads
    ``HDRTVNET_TPU_TURBO``, default on); off, the natural-layout program
    runs every frame. ``turbo`` after the load says which holds, by the JAX
    runtime's rule.
    """

    def __init__(
        self,
        model_path: str,
        *,
        precision: str = "fp16",
        device: str | torch.device | None = None,
        use_hg: bool | None = None,
        fast_condition_resize: bool | None = None,
        fast_zero_condition: bool | None = None,
        proc_resolution: tuple[int, int] | None = None,
        predequantize: bool | None = None,
        turbo: bool | None = None,
        mesh=None,
    ):
        self.model_path = model_path
        self.precision = precision
        self.policy: Policy = policy_for(precision)
        if fast_condition_resize is None:
            fast_condition_resize = _env_on("HDRTVNET_FAST_COND_RESIZE", "HDRTVNET_FAST_CONDITION_RESIZE")
        if fast_zero_condition is None:
            fast_zero_condition = _env_on("HDRTVNET_ZERO_COND", "HDRTVNET_FAST_ZERO_CONDITION")
        if fast_condition_resize or fast_zero_condition:
            raise _not_ported("the fast-condition shortcuts", "Slice 8 (host, runtime and tooling modules)")
        if proc_resolution is not None:
            raise _not_ported("proc_resolution (device letterbox)", "Slice 8 (host, runtime and tooling modules)")
        if mesh is not None:
            raise _not_ported("mesh inference", "Slice 8 (parallel: Queue 1 item 13)")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "HDRTVNetTorch runs on CUDA and no CUDA device is available; "
                    "pass device='cpu' to run the plain reference versions on the CPU"
                )
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {self.device}")

        if not model_path.endswith(".npz"):
            raise _not_ported("loading .pt checkpoints", "Slice 8 (host, runtime and tooling modules)")
        params = load_npz(model_path)
        arch = npz_arch_dict(load_npz_meta(model_path))
        if use_hg is None:
            use_hg = bool(arch.get("use_hg", False))
        cfg = ModelConfig.from_arch_dict(arch, use_hg=bool(use_hg))
        if cfg.use_hg and cfg.hg_arch != "pixelshuffle":
            raise _not_ported(f"the {cfg.hg_arch} HG generator", "Slice 8 (model variants: Queue 1 item 9)")
        if cfg.classifier != "color_condition" or cfg.le_arch != "sft" or cfg.post_correction:
            raise _not_ported(
                f"architecture {cfg.classifier}/{cfg.le_arch}/{cfg.post_correction or '-'}",
                "Slice 8 (model variants: Queue 1 item 9)",
            )
        if cfg.use_hg:
            missing = [f"{pre}*" for pre in ("base.", "hg.") if not any(k.startswith(pre) for k in params)]
            if missing:
                raise ValueError(f"use_hg needs a composite checkpoint (base.* and hg.* keys); {model_path} "
                                 f"has no {' and no '.join(missing)} keys")
        # An int8 checkpoint: float weights once at load (the JAX runtime's
        # pre-dequantize mode), the hg.* layers of a composite among them,
        # before hg_s2d_transform folds their BatchNorms; or, with
        # predequantize off, int8 kept for the eager W8A8 natural program.
        has_int8 = any(k.endswith(".weight_int8") for k in params)
        if predequantize is None:
            predequantize = env_bool("HDRTVNET_PREDEQUANTIZE", True)
        self.predequantized = bool(predequantize and has_int8)
        raw_int8 = params if has_int8 else None
        if self.predequantized:
            params = predequantize_params(params)
            has_int8 = False
        if turbo is None:
            turbo = env_bool("HDRTVNET_TPU_TURBO", True)
        # The JAX runtime's rule (its turbo): the s2d programs need the
        # s2d-able pixel-shuffle HG and float (or pre-dequantized) weights;
        # the architecture checks above already hold.
        self.turbo = bool(turbo and (not cfg.use_hg or "hg.conv1.0.weight" in params) and not has_int8)
        check_card_widths(cfg, self.device, turbo=self.turbo)
        self.cfg = cfg
        # The natural-layout parameters, untransformed: the program of every
        # frame without turbo, and of the frames whose sides are not
        # multiples of 8 with it.
        self._nat_params = natural_params_to_torch(params, self.device, self.policy)
        self.native_int8 = False
        self.params = self._nat_params
        if self.turbo:
            # s2d weight transform once on the host, then, for W8A8 layers,
            # the s2d-transformed int8 codes beside the float weights for the
            # kernels' int8 forms, then one cast and one copy to the device.
            sp = s2d_transform_params(params, cfg)
            if self.predequantized and env_bool("HDRTVNET_NATIVE_INT8", True):
                sp = attach_native_int8(sp, raw_int8)
                self.native_int8 = any(k.endswith(".qweight") for k in sp)
            self.params = params_to_torch(sp, self.device, self.policy)

    # ------------------------------------------------------------------
    # Frame programs
    # ------------------------------------------------------------------

    def natural(self, h: int, w: int) -> bool:
        """True when frames at (h, w) run the natural-layout program: every
        frame without turbo, else those whose sides are not both multiples
        of 8 (each UNet level must keep a whole s2d block grid: 540p's /4
        level is 135 rows)."""
        return not self.turbo or h % 8 != 0 or w % 8 != 0

    def _run_natural(self, flat: torch.Tensor) -> torch.Tensor:
        """The natural-layout program on (H, 3W) BGR byte rows → (H, 3W) u16:
        [0, 1] RGB, its ¼-res condition image, ``model_apply``, the pack."""
        h, w3 = flat.shape
        with torch.inference_mode(), self.policy.math():
            x = flat.reshape(h, w3 // 3, 3).flip(-1)[None].float() * (1.0 / 255.0)
            out = model_apply(self._nat_params, x, downsample_quarter_aa(x), self.cfg, policy=self.policy)
            return pack_rgb48(out[0].contiguous()).reshape(h, w3)

    def _run(self, fn, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), self.policy.math():
            return fn(self.params, x, None, self.cfg, policy=self.policy, bgr=True)

    def _run_hg_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """The two-stage HG program on (H, 3W) byte rows: the base model to
        its s2d output, then the HG composite, which packs (its tail kernel
        chosen by default)."""
        with torch.inference_mode(), self.policy.math():
            base = ensemble_s2d_base_flat(self.params, flat, policy=self.policy, bgr=True)
            return hg_composite_s2d(self.params, base, self.cfg, policy=self.policy, pack=True, tail_on=True)

    def wants_pairs(self, h: int, w: int) -> bool:
        """True when frames at (h, w) ship as (Hb, 2, Wb, 6) u8 pair planes
        (the same bytes as (H, 3W) rows; a free host view). Not with HG: its
        program takes flat rows; nor with ``HDRTV_PAIRS_BOUNDARY=0`` (read at
        each call), as in the JAX runtime: flat rows then, and the flat
        program; nor for the natural-layout program."""
        if not env_bool("HDRTV_PAIRS_BOUNDARY", True):
            return False
        return not self.cfg.use_hg and not self.natural(h, w)

    def put_frame(self, flat_np: np.ndarray) -> torch.Tensor:
        """Host (H, 3W) u8 byte rows → the device tensor the dispatcher
        wants: (Hb, 2, Wb, 6) pair planes when eligible, flat rows otherwise."""
        h, w = flat_np.shape[0], flat_np.shape[1] // 3
        arr = np.ascontiguousarray(flat_np)
        if self.wants_pairs(h, w):
            arr = arr.reshape(h // 2, 2, w // 2, 6)
        return torch.from_numpy(arr).to(self.device)

    def process_rgb48_device(self, frame_u8_dev: torch.Tensor) -> torch.Tensor:
        """Device-resident variant (no host sync). Accepts (Hb, 2, Wb, 6)
        pair planes, (H, 3W) flat byte rows or (H, W, 3), BGR u8; returns the
        matching shape in uint16 RGB48."""
        x = frame_u8_dev
        if x.dtype != torch.uint8:
            raise ValueError(f"frames are uint8, got {x.dtype}")
        if x.ndim == 4:
            hb, two, wb, six = x.shape
            if (two, six) != (2, 6):
                raise ValueError(f"pair planes are (Hb, 2, Wb, 6), got {tuple(x.shape)}")
            if hb % 4 or wb % 4:
                raise ValueError(f"pair planes need sides that are multiples of 8, got {2 * hb}x{2 * wb}: "
                                 "send (H, 3W) rows (wants_pairs is False at this size)")
            if self.cfg.use_hg or self.natural(2 * hb, 2 * wb):
                return self._run_flat(x.contiguous().reshape(2 * hb, 6 * wb)).reshape(hb, 2, wb, 6)
            return self._run(ensemble_s2d_rgb48_pairs, x.contiguous())
        if x.ndim == 2:
            return self._run_flat(x.contiguous())
        h, w, _ = x.shape
        return self._run_flat(x.reshape(h, w * 3).contiguous()).reshape(h, w, 3)

    def _run_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """(H, 3W) rows to the program that takes them: the natural-layout
        one, the two-stage HG one, or the flat s2d one."""
        h, w3 = flat.shape
        if self.natural(h, w3 // 3):
            return self._run_natural(flat)
        if self.cfg.use_hg:
            return self._run_hg_flat(flat)
        return self._run(ensemble_s2d_rgb48_flat, flat)

    def process_rgb48(self, frame_bgr: np.ndarray) -> np.ndarray:
        """Full BGR u8 frame (H, W, 3) → uint16 RGB48 PQ code values (H, W, 3)."""
        h, w, _ = frame_bgr.shape
        flat = np.ascontiguousarray(frame_bgr).reshape(h, w * 3)
        out = self.process_rgb48_device(self.put_frame(flat))
        return out.cpu().numpy().reshape(h, w, 3)
