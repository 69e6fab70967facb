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

The runtime around the programs follows ``HDRTVNetTPU``: ``proc_resolution``
(W, H) letterboxes every frame on the device to the processing resolution
first (``ops/resize.py letterbox_u8``: INTER_AREA down, bicubic up, black
bars), and the output is at that resolution; ``fast_condition_resize`` and
``fast_zero_condition`` replace the condition image by the bilinear ¼-res
one or by zeros (the flat s2d and natural programs; the HG split's base
stage keeps the default one, as in the JAX runtime), and frames under
either ship as flat rows, as they do under a ``proc_resolution`` other than
the frame's. The stage API (``preprocess`` → ``infer`` → ``postprocess``,
``process`` with BGR u8 out, ``process_timed``), ``process_rgb48_batch``,
``passthrough_rgb48[_device]``, ``warmup_compile``, ``with_proc_resolution``
and ``end_profiling`` are those of ``HDRTVNetTPU``.

Where the JAX runtime runs one compiled XLA executable per (resolution,
precision, output) signature, ``process_rgb48_device`` on a CUDA device runs
one CUDA graph per frame signature (``runtime/engine.py GraphCache``): the
first frame of a signature runs the program eagerly, then captures it; every
frame replays it and returns its own copy of the output. The stage API stays
eager, and ``_rgb48_eager`` is the same program without the graph. On the
CPU everything runs eagerly.

Frames cross the host boundary through pinned host buffers on a CUDA device
(``runtime/transfer.py``): ``put_frame`` (and every method that takes a host
frame) stages the bytes in a pinned buffer and copies them with
``non_blocking=True`` on the processor's H2D stream, and the caller's current
stream waits for that copy; ``process_rgb48`` and the other methods that
return host arrays copy back on the processor's D2H stream into a pinned
buffer and return a copy of it, the caller's own. The pinned buffers are
allocated once per frame shape and reused. A processor's copies are made from
one thread at a time. On the CPU nothing is pinned.

A reference ``.pt`` checkpoint loads through ``models/import_torch.py
load_checkpoint`` (an HR file, a composite, or an HR file with the HG
generator's own file as ``hg_path``; its HG BatchNorms folded, an FP8
source's quantized layers rounded through e4m3) to the same numpy
parameters a converted ``.npz`` holds, and from there runs as one.
Every architecture variant the checkpoint's ``architecture`` dict names
runs: the AGCM classifier variants, the LE archs, the post-correction heads
and the ``direct`` HG generator. The s2d programs are the release
architecture's (``color_condition`` / ``sft`` / ``pixelshuffle``, no
post-correction), so by the JAX runtime's rule every other architecture
turns turbo off and runs the natural-layout program on every frame.

A ``mesh`` (``parallel/mesh.py``) with a spatial axis of n > 1 runs every
frame of ``process_rgb48_device`` (and so of ``process_rgb48``) W-sharded,
as ``HDRTVNetTPU`` does with its ``shard_map`` programs: the frame's columns
split into n shards, each shard a thread on its own stream of its device,
running the single-device s2d program (every kernel on its shard's shifted
windows, the halo exchanges of ``parallel/halo.py``; with HG the base
program then the HG composite), the columns joined after. It takes the
release architecture with ``H % 8 == 0`` and ``W % (16·n) == 0``
(``W % (32·n)`` with HG or native int8 layers), at the processing size, always with the default
condition image (the JAX program's). Where the JAX runtime falls back to its
GSPMD-partitioned lax program (another size, ``HDRTV_MESH_SHARD_MAP=0``),
the port has no partitioner and raises ``ValueError`` naming the condition.
The sharded frame runs eagerly (no CUDA graph). ``process_rgb48_batch(...,
mesh=)`` splits a batch over the mesh's data axis (padded with repeats of
the last frame, trimmed after), each data row's first device running the
single-device program on its frames. Nothing falls back to a different
computation, and nothing runs on the CPU unless the caller asks for
``device="cpu"`` (or a mesh of CPU devices).
"""

from __future__ import annotations

import copy
import time
import warnings

import numpy as np
import torch

from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig, model_apply, natural_params_to_torch
from hdrtv_tpu_torch.models.hg_s2d import hg_composite_s2d
from hdrtv_tpu_torch.models.import_npz import load_npz, load_npz_meta, npz_arch_dict
from hdrtv_tpu_torch.models.import_torch import load_checkpoint
from hdrtv_tpu_torch.models.layers import Policy, policy_for
from hdrtv_tpu_torch.models.s2d import (
    attach_native_int8,
    ensemble_s2d,
    ensemble_s2d_base_flat,
    ensemble_s2d_rgb48_flat,
    ensemble_s2d_rgb48_pairs,
    params_to_torch,
    s2d_transform_params,
)
from hdrtv_tpu_torch.ops.pack import pack_rgb48
from hdrtv_tpu_torch.ops.resize import (
    downsample_quarter_aa,
    downsample_quarter_aa_flat,
    downsample_quarter_bilinear,
    letterbox_u8,
)
from hdrtv_tpu_torch.parallel import halo
from hdrtv_tpu_torch.parallel.mesh import Mesh, params_on
from hdrtv_tpu_torch.quant.int8 import predequantize_params
from hdrtv_tpu_torch.runtime import engine, transfer
from hdrtv_tpu_torch.utils.env import env_bool


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
    sidecar) or a reference ``.pt`` (``hg_path``: the HG generator's own
    ``.pt`` beside an HR one; a ``.npz`` composite carries its ``hg.*``
    keys itself, and an ``hg_path`` beside a ``.npz`` is ignored with a
    warning, as ``HDRTVNetTPU`` ignores it). ``use_hg``: ``None`` takes the checkpoint's word (for a
    ``.pt`` without one, whether ``hg_path`` is given). ``precision``: the reference token: ``fp32``/``float32`` is
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
    ``proc_resolution``: (W, H) to letterbox every frame to on the device.
    ``fast_condition_resize`` / ``fast_zero_condition``: the condition-path
    shortcuts (``None`` reads ``HDRTVNET_FAST_COND_RESIZE`` or
    ``HDRTVNET_FAST_CONDITION_RESIZE``, and ``HDRTVNET_ZERO_COND`` or
    ``HDRTVNET_FAST_ZERO_CONDITION``). ``cfg_overrides``: fields of the
    sidecar's architecture to replace. ``persistent_cache``: record each
    ``warmup_compile`` in the engine registry (``runtime/engine.py``).
    ``mesh``: a ``parallel/mesh.py`` ``Mesh`` whose spatial axis shards every
    frame's W (its devices of ``device``'s type; the parameters copied once
    to each other device).
    """

    def __init__(
        self,
        model_path: str,
        *,
        precision: str = "fp16",
        device: str | torch.device | None = None,
        use_hg: bool | None = None,
        hg_path: str | None = None,
        fast_condition_resize: bool | None = None,
        fast_zero_condition: bool | None = None,
        persistent_cache: bool = True,
        turbo: bool | None = None,
        predequantize: bool | None = None,
        proc_resolution: tuple[int, int] | None = None,
        cfg_overrides: dict | None = None,
        mesh=None,
    ):
        self.model_path = model_path
        self.precision = precision
        self.policy: Policy = policy_for(precision)
        # (W, H) the frames are letterboxed to on the device before inference
        self.proc_resolution = tuple(proc_resolution) if proc_resolution else None
        if fast_condition_resize is None:
            fast_condition_resize = _env_on("HDRTVNET_FAST_COND_RESIZE", "HDRTVNET_FAST_CONDITION_RESIZE")
        if fast_zero_condition is None:
            fast_zero_condition = _env_on("HDRTVNET_ZERO_COND", "HDRTVNET_FAST_ZERO_CONDITION")
        self.fast_condition_resize = bool(fast_condition_resize)
        self.fast_zero_condition = bool(fast_zero_condition)
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

        if model_path.endswith(".npz"):
            if hg_path is not None:
                # HDRTVNetTPU ignores it here too: a composite .npz carries its own hg.*
                warnings.warn(f"hg_path {hg_path} ignored: hg_path goes with a .pt model; the .npz {model_path} "
                              "carries its own hg.* keys when it is a composite", stacklevel=2)
            params = load_npz(model_path)
            arch = npz_arch_dict(load_npz_meta(model_path))
            if use_hg is None:
                use_hg = bool(arch.get("use_hg", False))
            cfg = ModelConfig.from_arch_dict(arch, use_hg=bool(use_hg), **(cfg_overrides or {}))
        else:
            params, cfg = load_checkpoint(model_path, hg_path=hg_path, use_hg=use_hg, **(cfg_overrides or {}))
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
        # The JAX runtime's rule (its turbo): the s2d programs are the
        # release architecture's (the pixel-shuffle HG with its s2d-able
        # conv1, the color_condition classifier, the sft LE, no
        # post-correction) on float (or pre-dequantized) weights.
        self.turbo = bool(
            turbo
            and (not cfg.use_hg or (cfg.hg_arch == "pixelshuffle" and "hg.conv1.0.weight" in params))
            and cfg.classifier == "color_condition"
            and cfg.le_arch == "sft"
            and not cfg.post_correction
            and not has_int8
        )
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
            params = s2d_transform_params(params, cfg)
            if self.predequantized and env_bool("HDRTVNET_NATIVE_INT8", True):
                params = attach_native_int8(params, raw_int8)
                self.native_int8 = any(k.endswith(".qweight") for k in params)
            self.params = params_to_torch(params, self.device, self.policy)
        # the JAX runtime's fingerprint, of the same numpy parameters
        self.model_hash = engine.model_fingerprint(params)
        self.mesh: Mesh | None = mesh
        self._replicas: dict[torch.device, tuple[dict, dict]] = {}
        if mesh is not None:
            kinds = {d.type for d in mesh.distinct_devices()}
            if kinds != {self.device.type}:
                raise ValueError(f"the mesh's devices ({sorted(kinds)}) must be of the processor's type "
                                 f"({self.device.type})")
            for dev in mesh.distinct_devices():
                self._params_on(dev)
        self.registry = engine.EngineRegistry() if persistent_cache else None
        self.graphs = engine.GraphCache()
        self._timings: dict[str, float] = {}
        self._h2d = self._d2h = None
        if self.device.type == "cuda":
            self._h2d = torch.cuda.Stream(self.device)
            self._d2h = torch.cuda.Stream(self.device)
        self._new_host_buffers()

    def _params_on(self, dev: torch.device) -> tuple[dict, dict]:
        """(s2d parameters, natural parameters) on ``dev``: the processor's
        own on its device, a copy made once on any other."""
        dev = torch.device(dev)
        if dev == self.device or (dev.type == self.device.type == "cuda"
                                  and (dev.index or 0) == (self.device.index or 0)):
            return self.params, self._nat_params
        if dev not in self._replicas:
            self._replicas[dev] = (params_on(self.params, dev), params_on(self._nat_params, dev))
        return self._replicas[dev]

    def _new_host_buffers(self) -> None:
        """The pinned buffers of the host copies, by frame shape: a few
        staging slots a shape for the copies in (each refilled only after
        its last copy is done), one slot a shape for the copies back."""
        self._staging: dict[tuple, list[transfer.HostSlot]] = {}
        self._readback: dict[tuple, transfer.HostSlot] = {}

    # ------------------------------------------------------------------
    # Host ↔ device copies
    # ------------------------------------------------------------------

    # Staging slots a frame shape: frame n + 2 is staged while frame n + 1's
    # copy may still run; frame n's was done long before.
    STAGING_SLOTS = 2

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Host array → a tensor on the processor's device: on a CUDA device
        through a pinned staging slot on the H2D stream (the current stream
        waits for the copy; a failed pin or copy raises); on the CPU the
        array itself, as a tensor."""
        arr = np.ascontiguousarray(arr)
        if self.device.type != "cuda":
            return torch.from_numpy(arr)
        slots = self._staging.setdefault((arr.shape, arr.dtype.str),
                                         [transfer.HostSlot(pinned=True) for _ in range(self.STAGING_SLOTS)])
        slots.append(slots.pop(0))
        return transfer.copy_in(arr, slots[-1], self.device, self._h2d)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        """Device tensor → a host array of the caller's own: on a CUDA
        device through the shape's pinned readback slot on the D2H stream,
        after the current stream's work so far, then copied out of the slot
        (the next call of that shape reuses the slot)."""
        if t.device.type != "cuda":
            return t.cpu().numpy()
        slot = self._readback.setdefault((tuple(t.shape), t.dtype), transfer.HostSlot(pinned=True))
        return transfer.copy_out(t, slot, self._d2h).array().copy()

    # ------------------------------------------------------------------
    # Dispatch rules (HDRTVNetTPU's, method by method)
    # ------------------------------------------------------------------

    def natural(self, h: int, w: int) -> bool:
        """True when frames at (h, w) run the natural-layout program: every
        frame without turbo, else those whose sides are not both multiples
        of 8 (each UNet level must keep a whole s2d block grid: 540p's /4
        level is 135 rows)."""
        return not self.turbo or h % 8 != 0 or w % 8 != 0

    def _proc_hw(self, h: int, w: int) -> tuple[int, int]:
        """The size a frame of (h, w) is processed at."""
        if self.proc_resolution is None:
            return h, w
        return self.proc_resolution[1], self.proc_resolution[0]

    def _pairs_ok(self, h: int, w: int) -> bool:
        """Whether frames at (h, w) can run the pair-plane program: no HG, an
        s2d size, no fast-condition shortcut, and no letterbox (it runs on
        the flat layout)."""
        return (not self.cfg.use_hg and not self.natural(h, w) and self._spatial_n() == 1
                and not (self.fast_zero_condition or self.fast_condition_resize)
                and self._proc_hw(h, w) == (h, w))

    def _spatial_n(self) -> int:
        """The shards of a frame: the mesh's spatial axis, 1 without a mesh."""
        return 1 if self.mesh is None else self.mesh.shape["spatial"]

    def wants_pairs(self, h: int, w: int) -> bool:
        """True when frames at (h, w) ship as (Hb, 2, Wb, 6) u8 pair planes
        (the same bytes as (H, 3W) rows; a free host view). Not with HG: its
        program takes flat rows; nor with ``HDRTV_PAIRS_BOUNDARY=0`` (read at
        each call), as in the JAX runtime: flat rows then, and the flat
        program; nor for the natural-layout program, under a fast-condition
        shortcut, or where ``proc_resolution`` letterboxes the frame, nor
        under a spatial mesh (its program shards flat rows)."""
        return env_bool("HDRTV_PAIRS_BOUNDARY", True) and self._pairs_ok(h, w)

    def _cond_of(self, x: torch.Tensor) -> torch.Tensor:
        """The ¼-res condition image of an NHWC [0, 1] RGB frame: zeros or
        the bilinear one under the fast-condition shortcuts, else the
        antialiased bicubic one."""
        if self.fast_zero_condition:
            n, h, w, c = x.shape
            return torch.zeros((n, h // 4, w // 4, c), dtype=x.dtype, device=x.device)
        if self.fast_condition_resize:
            return downsample_quarter_bilinear(x)
        return downsample_quarter_aa(x)

    def _letterbox(self, frame_u8: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) u8 → the frame at ``proc_resolution`` (as it is without one)."""
        if self.proc_resolution is None:
            return frame_u8
        pw, ph = self.proc_resolution
        return letterbox_u8(frame_u8, ph, pw)

    def _pre(self, frame_u8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(H, W, 3) BGR u8 → ([0, 1] RGB NHWC, ¼-res condition)."""
        frame_u8 = self._letterbox(frame_u8)
        x = frame_u8[None].flip(-1).float() * (1.0 / 255.0)
        return x, self._cond_of(x)

    def _net(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """The model on an NHWC [0, 1] frame: the s2d ensemble where its
        sides allow, the natural-layout model otherwise."""
        if self.turbo and x.shape[1] % 8 == 0 and x.shape[2] % 8 == 0:
            return ensemble_s2d(self.params, x, cond, self.cfg, policy=self.policy)
        return model_apply(self._nat_params, x, cond, self.cfg, policy=self.policy)

    @staticmethod
    def _post(out: torch.Tensor) -> torch.Tensor:
        """Model output (1, H, W, 3) RGB → (H, W, 3) BGR u8."""
        v = out[0].float().clamp(0.0, 1.0) * 255.0 + 0.5
        return v.to(torch.uint8).flip(-1)

    # ------------------------------------------------------------------
    # The RGB48 frame programs
    # ------------------------------------------------------------------

    @staticmethod
    def _frame_hw(x: torch.Tensor) -> tuple[int, int]:
        """The (H, W) of a u8 BGR frame given as (Hb, 2, Wb, 6) pair planes,
        (H, 3W) flat rows or (H, W, 3), with its layout checked."""
        if x.dtype != torch.uint8:
            raise ValueError(f"frames are uint8, got {x.dtype}")
        if x.ndim == 4:
            hb, two, wb, six = x.shape
            if (two, six) != (2, 6):
                raise ValueError(f"pair planes are (Hb, 2, Wb, 6), got {tuple(x.shape)}")
            if hb % 4 or wb % 4:
                raise ValueError(f"pair planes need sides that are multiples of 8, got {2 * hb}x{2 * wb}: "
                                 "send (H, 3W) rows (wants_pairs is False at this size)")
            return 2 * hb, 2 * wb
        if x.ndim == 2:
            return x.shape[0], x.shape[1] // 3
        if x.ndim == 3 and x.shape[2] == 3:
            return x.shape[0], x.shape[1]
        raise ValueError(f"frames are (Hb, 2, Wb, 6), (H, 3W) or (H, W, 3), got {tuple(x.shape)}")

    def _program(self, x: torch.Tensor) -> str:
        """Which program ``process_rgb48_device`` runs ``x`` with: ``pairs``
        (pair planes in and out), ``mesh`` (the W-sharded frame, under a
        spatial mesh), or on flat rows at the processing size ``natural``,
        ``hg`` (the two-stage HG composite) or ``flat``."""
        h, w = self._frame_hw(x)
        if x.ndim == 4 and self._pairs_ok(h, w):
            return "pairs"
        if self._spatial_n() > 1:
            return "mesh"
        return self._flat_program(h, w)

    def _flat_program(self, h: int, w: int) -> str:
        """The single-device program of flat rows of (h, w)."""
        ph, pw = self._proc_hw(h, w)
        if self.natural(ph, pw):
            return "natural"
        return "hg" if self.cfg.use_hg else "flat"

    def _run_flat(self, flat: torch.Tensor, program: str, params: tuple[dict, dict] | None = None) -> torch.Tensor:
        """(H, 3W) rows → (H', 3W') u16 rows at the processing size: the
        letterbox, then the natural-layout program, the two-stage HG one
        (its base stage computes the default condition, as the JAX
        runtime's does), or the flat s2d one (with the shortcuts' condition
        image when one is on). ``params``: (s2d, natural) parameters on the
        frame's device (default: the processor's)."""
        sp, nat = params or (self.params, self._nat_params)
        h, w3 = flat.shape
        flat = self._letterbox(flat.reshape(h, w3 // 3, 3))
        h, w = flat.shape[:2]
        if program == "natural":
            x = flat.flip(-1)[None].float() * (1.0 / 255.0)
            out = model_apply(nat, x, self._cond_of(x), self.cfg, policy=self.policy)
            return pack_rgb48(out[0].contiguous()).reshape(h, 3 * w)
        flat = flat.reshape(h, 3 * w)
        if program == "hg":
            base = ensemble_s2d_base_flat(sp, flat, policy=self.policy, bgr=True)
            return hg_composite_s2d(sp, base, self.cfg, policy=self.policy, pack=True, tail_on=True)
        cond = None
        if self.fast_zero_condition or self.fast_condition_resize:
            cond = self._cond_of(flat.reshape(h, w, 3)[None].flip(-1).float() * (1.0 / 255.0))
        return ensemble_s2d_rgb48_flat(sp, flat, cond, self.cfg, policy=self.policy, bgr=True)

    # ------------------------------------------------------------------
    # The W-sharded frame (a spatial mesh)
    # ------------------------------------------------------------------

    def _mesh_refusal(self, h: int, w3: int) -> str | None:
        """Why a frame of (h, w3 // 3) at the processing size cannot take the
        sharded program, or None when it can: the JAX runtime's
        ``_mesh_manual_ok``, whose failure sends it to a GSPMD-partitioned
        program the port does not have."""
        n = self._spatial_n()
        w = w3 // 3
        if not self.turbo:
            return "the space-to-depth programs are off (turbo) for this checkpoint or setting"
        if not env_bool("HDRTV_MESH_SHARD_MAP", True):
            return "HDRTV_MESH_SHARD_MAP=0 asks for the GSPMD-partitioned program, which the port does not have"
        if h % 8:
            return f"the frame's height {h} is not a multiple of 8"
        if self.cfg.use_hg:
            if "hg.conv1.0.weight" not in self.params:
                return "the HG generator has no space-to-depth conv1"
            if w % (32 * n):
                return f"with HG the width {w} must be a multiple of 32 × {n} shards"
        elif w % (16 * n):
            return f"the width {w} must be a multiple of 16 × {n} shards"
        elif self.native_int8 and w % (32 * n):
            # A W8A8 layer runs int8 only where its input's width is a
            # multiple of 8 (models/s2d.py _qargs_for, the JAX routing rule):
            # a shard of W/(8n) columns at /8 that is not a multiple of 4
            # has no even radius keeping its windows so, and those layers
            # would run in float (JAX's sharded program does; the
            # single-device one does not).
            return f"with native int8 layers the width {w} must be a multiple of 32 × {n} shards"
        return None

    def _mesh_manual_ok(self, h: int, w3: int) -> bool:
        """Whether a frame of (h, w3 // 3) takes the sharded program."""
        return self._mesh_refusal(h, w3) is None

    def _mesh_rgb48_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """(H, 3W) rows → the sharded frame program's (H', 3W') u16 rows: the
        letterbox first (on the processor's device, so the sharded program
        has one shape), then the W-divisibility checks (``ValueError``),
        then each shard's columns through the program on its device and
        stream, joined back on the processor's device.

        The ¼-res condition image is computed once, on the whole frame,
        before the frame is split, and each shard takes its columns of it
        (the classifier gathers them back): its W contraction is a GEMM over
        the frame's width, whose sums change with that width, so a shard's
        halo window (``ops/resize.py``, what a sharded body computes without
        a condition image, as the JAX program does) would move the
        classifier's input by an ulp and the modulation with it."""
        h, w3 = flat.shape
        if self.proc_resolution is not None and (h, w3 // 3) != self._proc_hw(h, w3 // 3):
            flat = self._letterbox(flat.reshape(h, w3 // 3, 3))
            h, w3 = flat.shape[0], flat.shape[1] * 3
            flat = flat.reshape(h, w3)
        n = self._spatial_n()
        if not (self.turbo and (w3 // 3) % (8 * n) == 0 and h % 8 == 0):
            raise ValueError(f"mesh spatial inference needs the turbo arch and W divisible by 8 × the spatial "
                             f"axis (got {w3 // 3}px over {n} devices, H {h})")
        why = self._mesh_refusal(h, w3)
        if why is not None:
            raise ValueError(f"the sharded frame program does not take {h}x{w3 // 3} over {n} shards: {why}")
        devices = self.mesh.row(0)
        cols = w3 // n
        cfg, policy = self.cfg, self.policy
        cond = downsample_quarter_aa_flat(flat, bgr=True)
        ccols = cond.shape[2] // n

        def shard(k: int, local: torch.Tensor, cond_local: torch.Tensor) -> torch.Tensor:
            sp = self._params_on(devices[k])[0]
            local = local.to(devices[k]).contiguous()
            cond_local = cond_local.to(devices[k]).contiguous()
            with halo.manual_axis("spatial"):
                if cfg.use_hg:
                    base = ensemble_s2d_base_flat(sp, local, cond_local, policy=policy, bgr=True)
                    return hg_composite_s2d(sp, base, cfg, policy=policy, pack=True, tail_on=True)
                return ensemble_s2d_rgb48_flat(sp, local, cond_local, cfg, policy=policy, bgr=True)

        outs = halo.run_sharded(
            shard, [(flat.narrow(1, k * cols, cols), cond.narrow(2, k * ccols, ccols)) for k in range(n)], devices,
        )
        return torch.cat([o.to(self.device) for o in outs], dim=1)

    def _rgb48_eager(self, frame_u8_dev: torch.Tensor) -> torch.Tensor:
        """The frame program of ``process_rgb48_device`` run eagerly, launch
        by launch, without the CUDA graph."""
        x = frame_u8_dev
        h, w = self._frame_hw(x)
        program = self._program(x)
        with torch.inference_mode(), self.policy.math():
            if program == "pairs":
                return ensemble_s2d_rgb48_pairs(self.params, x.contiguous(), None, self.cfg,
                                                policy=self.policy, bgr=True)
            if program == "mesh":
                out = self._mesh_rgb48_flat(x.contiguous().reshape(h, 3 * w))
            else:
                out = self._run_flat(x.contiguous().reshape(h, 3 * w), program)
        oh, ow = out.shape[0], out.shape[1] // 3
        if x.ndim == 3:
            return out.reshape(oh, ow, 3)
        if x.ndim == 4 and oh % 2 == 0 and ow % 2 == 0:
            return out.reshape(oh // 2, 2, ow // 2, 6)
        return out

    def put_frame(self, flat_np: np.ndarray) -> torch.Tensor:
        """Host (H, 3W) u8 byte rows → the device tensor the dispatcher
        wants: (Hb, 2, Wb, 6) pair planes when eligible, flat rows otherwise.
        On a CUDA device the bytes go through a pinned staging slot and a
        non-blocking copy on the H2D stream, which the current stream waits
        for (``_to_device``)."""
        h, w = flat_np.shape[0], flat_np.shape[1] // 3
        arr = np.ascontiguousarray(flat_np)
        if self.wants_pairs(h, w):
            arr = arr.reshape(h // 2, 2, w // 2, 6)
        return self._to_device(arr)

    def process_rgb48_device(self, frame_u8_dev: torch.Tensor) -> torch.Tensor:
        """Device-resident frame → device-resident uint16 RGB48 (no host
        sync). Accepts (Hb, 2, Wb, 6) pair planes, (H, 3W) flat byte rows or
        (H, W, 3), BGR u8; returns the same layout at the processing size
        (pair planes as flat rows where a letterbox leaves an odd side). On a
        CUDA device each signature's program is captured once as a CUDA
        graph and replayed (``runtime/engine.py``); the tensor returned is
        the caller's own. A sharded frame (a spatial mesh) runs eagerly."""
        x = frame_u8_dev
        if self.device.type != "cuda" or self._spatial_n() > 1:
            return self._rgb48_eager(x)
        key = engine.graph_signature(x.shape, x.dtype, self._program(x), self.precision, self.proc_resolution,
                                     self.fast_condition_resize, self.fast_zero_condition)
        return self.graphs.run(key, self._rgb48_eager, x)

    @staticmethod
    def _hw3(out: np.ndarray) -> np.ndarray:
        """A u16 output in any of the three layouts as (H, W, 3), a view."""
        if out.ndim == 4:
            hb, _, wb, _ = out.shape
            return out.reshape(2 * hb, 2 * wb, 3)
        if out.ndim == 2:
            return out.reshape(out.shape[0], out.shape[1] // 3, 3)
        return out

    def process_rgb48(self, frame_bgr: np.ndarray) -> np.ndarray:
        """Full BGR u8 frame (H, W, 3) → uint16 RGB48 PQ code values, (H, W,
        3) or at ``proc_resolution`` when set."""
        h, w, _ = frame_bgr.shape
        flat = np.ascontiguousarray(frame_bgr).reshape(h, w * 3)
        out = self.process_rgb48_device(self.put_frame(flat))
        return self._hw3(self._to_host(out))

    def process_rgb48_batch(self, frames_bgr: np.ndarray, *, mesh: Mesh | None = None) -> np.ndarray:
        """(N, H, W, 3) BGR u8 → (N, H', W', 3) u16 RGB48, at the processing
        size: each frame as flat rows through ``process_rgb48_device``, one
        copy back at the end (pinned on a CUDA device, as every copy). With
        ``mesh``, the frames split over its data axis (frame-batch data
        parallelism): a batch that the axis does not divide is padded with
        repeats of the last frame and trimmed after, never run unsplit."""
        if mesh is not None:
            return self._batch_on_mesh(np.ascontiguousarray(frames_bgr), mesh)
        frames = np.ascontiguousarray(frames_bgr)
        n, h, w, _ = frames.shape
        outs = [self.process_rgb48_device(self._to_device(frames[i].reshape(h, w * 3))) for i in range(n)]
        stacked = self._to_host(torch.stack(outs))
        return stacked.reshape(n, stacked.shape[1], stacked.shape[2] // 3, 3)

    def _batch_on_mesh(self, frames: np.ndarray, mesh: Mesh) -> np.ndarray:
        """The data-parallel batch: data row d's first device runs frames
        [d·m, (d+1)·m) of the padded batch through the single-device flat
        program (eagerly, on its own stream), one frame after another; the
        outputs are joined on the processor's device and copied back once."""
        n, h, w, _ = frames.shape
        nd = mesh.shape["data"]
        pad = (-n) % nd
        if pad:
            frames = np.concatenate([frames, np.repeat(frames[-1:], pad, axis=0)], axis=0)
        per = frames.shape[0] // nd
        devices = [mesh.devices[d, 0] for d in range(nd)]
        program = self._flat_program(h, w)
        x = self._to_device(frames.reshape(frames.shape[0], h, w * 3))

        def shard(k: int, chunk: torch.Tensor) -> torch.Tensor:
            params = self._params_on(devices[k])
            chunk = chunk.to(devices[k])
            return torch.stack([self._run_flat(chunk[i].contiguous(), program, params) for i in range(per)])

        with self.policy.math():
            outs = halo.run_sharded(shard, [(x[d * per:(d + 1) * per],) for d in range(nd)], devices)
            stacked = self._to_host(torch.cat([o.to(self.device) for o in outs]))[:n]
        return stacked.reshape(n, stacked.shape[1], stacked.shape[2] // 3, 3)

    @staticmethod
    def _passthrough(frame_u8: torch.Tensor) -> torch.Tensor:
        """HDR-input bypass: the source is already the PQ signal, so its u8
        code values scale to u16 (× 257), the last axis flipped (BGR → RGB),
        without the model."""
        return (frame_u8.flip(-1).to(torch.int32) * 257).to(torch.uint16)

    def passthrough_rgb48(self, frame_bgr: np.ndarray) -> np.ndarray:
        return self._to_host(self._passthrough(self._to_device(frame_bgr)))

    def passthrough_rgb48_device(self, frame_u8_dev: torch.Tensor) -> torch.Tensor:
        return self._passthrough(frame_u8_dev)

    # ------------------------------------------------------------------
    # The stage API (eager)
    # ------------------------------------------------------------------

    def preprocess(self, frame_bgr: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """BGR u8 (H, W, 3) → ([0, 1] RGB (1, H, W, 3), its ¼-res condition),
        on the device, letterboxed to ``proc_resolution`` when set."""
        with torch.inference_mode(), self.policy.math():
            return self._pre(self._to_device(frame_bgr))

    def infer(self, input_cond) -> torch.Tensor:
        x, cond = input_cond
        with torch.inference_mode(), self.policy.math():
            return self._net(x, cond)

    def postprocess(self, output: torch.Tensor) -> np.ndarray:
        with torch.inference_mode():
            return self._to_host(self._post(output))

    def process(self, frame_bgr: np.ndarray) -> np.ndarray:
        """Full frame → BGR uint8 (the SDR-range preview path)."""
        with torch.inference_mode(), self.policy.math():
            return self._to_host(self._post(self._net(*self._pre(self._to_device(frame_bgr)))))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def process_timed(self, frame_bgr: np.ndarray):
        """(output, pre_ms, infer_ms, post_ms), the device synchronized
        between the stages."""
        t0 = time.perf_counter()
        x, cond = self.preprocess(frame_bgr)
        self._sync()
        t1 = time.perf_counter()
        out = self.infer((x, cond))
        self._sync()
        t2 = time.perf_counter()
        res = self.postprocess(out)
        t3 = time.perf_counter()
        return res, (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3

    # ------------------------------------------------------------------
    # Warmup / engine management
    # ------------------------------------------------------------------

    def warmup_compile(self, width: int = 1920, height: int = 1080, *, rgb48: bool = True) -> float:
        """Make ready the program of one resolution: with ``rgb48`` the one
        ``process_rgb48_device`` takes for frames from ``put_frame`` at that
        size, its CUDA graph captured on a CUDA device (the kernels built on
        the first call of the process); else ``process``, eagerly. Records
        the signature in the engine registry when ``persistent_cache`` is on;
        returns the seconds it took."""
        key = engine.EngineRecord.make_key(
            self.model_hash, width, height, f"{self.precision}{'-hg' if self.cfg.use_hg else ''}"
        )
        t0 = time.perf_counter()
        if rgb48:
            self.process_rgb48_device(self.put_frame(np.zeros((height, width * 3), np.uint8)))
        else:
            self.process(np.zeros((height, width, 3), np.uint8))
        self._sync()
        dt = time.perf_counter() - t0
        if self.registry is not None:
            self.registry.record(engine.EngineRecord(
                key=key, model_hash=self.model_hash, width=width, height=height, precision=self.precision,
                use_hg=self.cfg.use_hg, torch_version=torch.__version__,
                device_name=torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu",
                compile_seconds=dt, created=time.time(),
            ))
        self._timings[key] = dt
        return dt

    def with_proc_resolution(self, proc_resolution: tuple[int, int] | None) -> "HDRTVNetTorch":
        """Shallow clone with another processing resolution: the parameters
        and the copy streams are shared, the graph cache and the pinned host
        buffers are its own."""
        clone = copy.copy(self)
        clone.proc_resolution = tuple(proc_resolution) if proc_resolution else None
        clone.graphs = engine.GraphCache()
        clone._timings = {}
        clone._new_host_buffers()
        return clone

    def end_profiling(self):  # the reference API's
        return None
