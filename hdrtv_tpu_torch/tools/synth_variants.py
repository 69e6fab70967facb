"""Checkpoints of the model variants, and reference ``.pt`` files written
from converted parameters.

    python -m hdrtv_tpu_torch.tools.synth_variants OUT_DIR [--names NAME ...]

The repository holds the variants' weights only as the golden fixtures
``tests/fixtures/agcm_variants.npz`` (five AGCM classifier modes) and
``ensemble_variants.npz`` (ten LE archs and a lowrank AGCM), at nf = 16 and
in the torch layout, and ``hg_direct.npz`` (a direct HG generator at scale 4,
depth 2). No weights exist for the post-correction heads, nor for a direct
HG at the runtime's defaults (scale 8, depth 8). This module builds one full
checkpoint per variant from them (:func:`variant_checkpoints`):

- ``agcm_<tag>``: the AGCM of ``agcm_variants.npz`` over the ``cleantrunk``
  ensemble's LE;
- ``le_<tag>`` and ``lowrank4``: the ensembles of ``ensemble_variants.npz``
  as they are (lowrank4 keeps its full-rank HRconv, which the loader factors);
- ``hg_direct``: the release model (``weights/hr_fp32.npz``) as the base of
  a composite whose generator is a seeded direct one (width 16) at scale 8,
  depth 8 (the fixtures' random ensembles hardly reach the highlight mask's
  threshold, so over them the generator would change nothing);
- ``pc_<mode>``: the ``cleantrunk`` ensemble with a seeded post-correction
  head of each of the six modes.

The seeded layers are drawn at ``gain / √fan_in`` with small biases, so the
heads' tanh stays off its rails and every correction moves the output. Each
checkpoint is written as a reference ``.pt`` container (``state_dict`` in
the torch layout, ``architecture``) by :func:`write_pt`, the inverse of the
loader's layout conversion.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")

AGCM_VARIANTS = {"plain": "agcm_plain", "affine": "agcm_affine", "lite8": "agcm_lite_8",
                 "spatial": "spatial_h4_wide8_x2", "spatialmix": "spatial_mix_h4_wide8_x2"}
LE_VARIANTS = {"cleantrunk": "cleantrunk", "cleantrunk_deep8": "cleantrunk_deep8", "wide64x4": "cleantrunk_wide64x4",
               "selectsft23": "selectsft23", "bottleneck_heavy": "bottleneck_heavy", "flatall8": "cleantrunk_flatall8",
               "plainflatlinear8": "plainflatlinear8", "plainbottleneck": "plainbottleneckh8wide24x2",
               "conddirect": "conddirecth4wide24x2", "condgatedirect": "condgatedirecth4wide24x2"}
# One name per post-correction mode (models/hdrtvnet.py parse_post_correction).
POST_CORRECTIONS = {"global": "globalwide16x2", "global_spatial": "globalwide16x2correcth4wide16x2",
                    "global_residual": "globalwide16x2residualh4wide16x2", "residual": "residualh4wide16x2",
                    "affine": "affineh4wide16x2", "spatial": "correcth4wide16x2"}
VARIANT_NF = 16  # the fixtures' width
BASE_LE = "cleantrunk"  # the ensemble under the AGCM variants and the heads
RELEASE_WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")


def _fixture(name: str) -> dict[str, np.ndarray]:
    with np.load(os.path.join(FIXTURES, name)) as z:
        return {k: z[k] for k in z.files}


def _strip(fx: dict, prefix: str) -> dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in fx.items() if k.startswith(prefix)}


def to_torch_layout(params: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Converted parameters back to the torch layout: HWIO conv weights to
    OIHW, (in, out) linear weights to (out, in); the inverse of
    ``models/import_npz.py convert_state`` on its own output."""
    out = {}
    for key, arr in params.items():
        arr = np.asarray(arr)
        if key.endswith(("weight", "weight_int8")):
            if arr.ndim == 4:
                arr = np.transpose(arr, (3, 2, 0, 1))
            elif arr.ndim == 2:
                arr = np.transpose(arr, (1, 0))
        out[key] = np.ascontiguousarray(arr)
    return out


def write_pt(path: str, state: dict[str, np.ndarray], arch: dict | None = None, **container) -> str:
    """Write a reference ``.pt`` container: ``state_dict`` (torch-layout
    arrays as tensors), ``architecture`` when given, and any other container
    keys (e.g. ``fp8_source_schema``, ``weight_qparams``). Returns ``path``."""
    import torch

    obj = {"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}, **container}
    if arch is not None:
        obj["architecture"] = dict(arch)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(obj, path)
    return path


def _seeded_conv(rng, p: dict, name: str, k: int, ci: int, co: int, *, gain: float = 1.0,
                 bias_std: float = 0.02) -> None:
    """A torch-layout (OIHW) conv drawn at gain / √(k² · ci)."""
    p[f"{name}.weight"] = (rng.randn(co, ci, k, k) * (gain / np.sqrt(k * k * ci))).astype(np.float32)
    p[f"{name}.bias"] = (rng.randn(co) * bias_std).astype(np.float32)


def post_correction_state(spec: str, seed: int = 0, prefix: str = "post_correction.") -> dict[str, np.ndarray]:
    """Seeded torch-layout weights of a post-correction head at the shapes
    the forward reads: the global head ``net.1`` (6 → width), hidden
    ``net.3 … net.(1 + 2·depth)``, ``net.(3 + 2·depth)`` (→ 12); the spatial,
    affine and residual heads ``trunk.0`` (6 → width, 1×1), ``trunk.2 …
    trunk.(2·depth)`` (3×3), ``out`` (→ 12, 6, or 3·scale² for the
    residual). The combined modes put the second head under ``spatial.`` or
    ``residual.``."""
    from hdrtv_tpu_torch.models.hdrtvnet import parse_post_correction

    cfg = parse_post_correction(spec)
    rng = np.random.RandomState(seed)
    p: dict[str, np.ndarray] = {}

    def global_head(pre, width, depth):
        _seeded_conv(rng, p, f"{pre}net.1", 1, 6, width)
        for i in range(depth):
            _seeded_conv(rng, p, f"{pre}net.{3 + 2 * i}", 1, width, width)
        _seeded_conv(rng, p, f"{pre}net.{3 + 2 * depth}", 1, width, 12, gain=0.5)

    def spatial_head(pre, mode, scale, width, depth):
        _seeded_conv(rng, p, f"{pre}trunk.0", 1, 6, width)
        for i in range(depth):
            _seeded_conv(rng, p, f"{pre}trunk.{2 * (i + 1)}", 3, width, width)
        out_c = {"residual": 3 * scale * scale, "affine": 6}.get(mode, 12)
        _seeded_conv(rng, p, f"{pre}out", 1, width, out_c, gain=0.5)

    mode = cfg[0]
    if mode == "global":
        global_head(prefix, cfg[2], cfg[3])
    elif mode in ("global_spatial", "global_residual"):
        inner = mode.split("_")[1]
        global_head(prefix, cfg[1], cfg[2])
        spatial_head(f"{prefix}{inner}.", inner, *cfg[3:])
    else:
        spatial_head(prefix, *cfg)
    return p


def hg_direct_state(nf: int = VARIANT_NF, seed: int = 0, scale: int = 8, depth: int = 8,
                    prefix: str = "hg.") -> dict[str, np.ndarray]:
    """Seeded torch-layout weights of a direct HG generator: ``low_in``
    (4 → nf), ``trunk.0 … trunk.(2·depth − 2)`` (3×3), ``low_out``
    (→ 3·scale²)."""
    rng = np.random.RandomState(seed)
    p: dict[str, np.ndarray] = {}
    _seeded_conv(rng, p, f"{prefix}low_in", 1, 4, nf)
    for i in range(depth):
        _seeded_conv(rng, p, f"{prefix}trunk.{2 * i}", 3, nf, nf)
    _seeded_conv(rng, p, f"{prefix}low_out", 1, nf, 3 * scale * scale, gain=0.25)
    return p


def variant_checkpoints() -> dict[str, tuple[dict[str, np.ndarray], dict]]:
    """Every variant as (torch-layout state, architecture dict), by name."""
    agcm = _fixture("agcm_variants.npz")
    ens = _fixture("ensemble_variants.npz")
    base = _strip(ens, f"{BASE_LE}__sd__")
    base_le = {k: v for k, v in base.items() if k.startswith("LE.")}
    out: dict[str, tuple[dict, dict]] = {}
    for tag, classifier in AGCM_VARIANTS.items():
        state = {**{f"AGCM.{k}": v for k, v in _strip(agcm, f"{tag}__sd__").items()}, **base_le}
        out[f"agcm_{tag}"] = (state, {"classifier": classifier, "le_arch": BASE_LE, "nf": VARIANT_NF})
    for tag, le_arch in LE_VARIANTS.items():
        out[f"le_{tag}"] = (_strip(ens, f"{tag}__sd__"), {"le_arch": le_arch, "nf": VARIANT_NF})
    out["lowrank4"] = (_strip(ens, "lowrank4__sd__"), {"classifier": "lowrank_4", "nf": VARIANT_NF})
    from hdrtv_tpu_torch.models.import_npz import load_npz, load_npz_meta, npz_arch_dict

    release = to_torch_layout(load_npz(RELEASE_WEIGHTS))
    arch = {**npz_arch_dict(load_npz_meta(RELEASE_WEIGHTS)), "use_hg": True, "hg_arch": "direct"}
    out["hg_direct"] = ({**{f"base.{k}": v for k, v in release.items()}, **hg_direct_state(seed=7)}, arch)
    for i, (mode, spec) in enumerate(POST_CORRECTIONS.items()):
        out[f"pc_{mode}"] = ({**base, **post_correction_state(spec, seed=11 + i)},
                             {"le_arch": BASE_LE, "nf": VARIANT_NF, "post_correction": spec})
    return out


def write_variants(out_dir: str, names=None) -> dict[str, str]:
    """Write the named variants (all by default) as ``<name>.pt``; returns
    their paths by name."""
    ckpts = variant_checkpoints()
    return {name: write_pt(os.path.join(out_dir, f"{name}.pt"), *ckpts[name]) for name in (names or ckpts)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--names", nargs="*", default=None, help="variants to write (default: all)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    for name, path in write_variants(args.out_dir, args.names).items():
        print(f"{name}: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
