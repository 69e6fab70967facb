"""Reference ``.pt`` checkpoints in hdrtv_tpu_torch on the CPU, against
hdrtv_tpu: ``models/import_torch.py`` (``load_checkpoint`` with the
classifier remaps, the HG BatchNorm fold and the FP8 emulation;
``split_source_checkpoint``) and ``HDRTVNetTorch`` on a ``.pt``.

Every container here is written by the test itself with ``torch.save``
(``tools/synth_variants.py write_pt``) from the shipped weights: the
reference's own ``.pt`` files are not in the repository. The parameters the
port loads must equal JAX ``load_checkpoint``'s bit for bit, key for key.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
f32 = np.float32


def _release():
    """(torch-layout state, architecture dict) of the shipped weights."""
    from hdrtv_tpu_torch.models.import_npz import load_npz, load_npz_meta, npz_arch_dict
    from hdrtv_tpu_torch.tools.synth_variants import to_torch_layout

    return to_torch_layout(load_npz(WEIGHTS)), dict(npz_arch_dict(load_npz_meta(WEIGHTS)))


def _hg_sources(nf: int = 8):
    """A synthetic generator's state in the torch layout, its BatchNorm
    statistics unfolded (and the counters a trained module carries), keys
    without the ``hg.`` prefix, as an HG generator's own file holds them."""
    from hdrtv_tpu_torch.tools.synth_hg import synth_hg_params
    from hdrtv_tpu_torch.tools.synth_variants import to_torch_layout

    hg = {k[3:]: v for k, v in synth_hg_params(nf=nf, seed=3).items() if k.startswith("hg.")}
    hg = to_torch_layout(hg)
    for k in [k for k in hg if k.endswith(".1.running_mean")]:
        hg[k.replace("running_mean", "num_batches_tracked")] = np.array(7, np.int64)
    return hg


CASES = ["plain", "composite_hg_path", "woin", "lite", "lowrank", "fp8"]


def _write_case(case: str, tmp) -> tuple[str, dict]:
    """Write one container; returns (path, load_checkpoint keywords)."""
    from hdrtv_tpu_torch.tools.synth_variants import write_pt

    state, arch = _release()
    path = str(tmp / f"{case}.pt")
    if case == "plain":
        return write_pt(path, state, arch), {}
    if case == "composite_hg_path":
        hg = write_pt(str(tmp / "hg_only.pt"), _hg_sources())
        return write_pt(path, state, {**arch, "use_hg": True}), {"hg_path": hg}
    if case in ("woin", "lite", "lowrank"):
        classifier = {"woin": "color_condition_woin", "lite": "lite_16", "lowrank": "lowrank_8"}[case]
        return write_pt(path, state, {**arch, "classifier": classifier}), {}
    layers = [k[: -len(".weight")] for k, v in state.items() if k.endswith(".weight") and v.ndim == 4]
    layers = layers[::2] + ["LE.no_such_layer"]  # and a name the state does not hold
    qparams = {name: {"amax": torch.tensor(1.0)} for name in layers}
    return write_pt(path, state, arch, fp8_source_schema="hdrtv-fp8-source", weight_qparams=qparams,
                    fp8_source_note="weights stored fp32; FP8 Q/DQ at build"), {}


def _assert_same_params(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("case", CASES)
def test_load_checkpoint_matches_jax(case, tmp_path):
    """The port's parameters and configuration equal JAX ``load_checkpoint``'s
    for the plain container, the composite with its generator as
    ``hg_path`` (BatchNorms folded, counters dropped), the woIN, lite and
    lowrank (SVD) classifier remaps, and an FP8 source container."""
    from hdrtv_tpu.models.import_torch import load_checkpoint as jax_load
    from hdrtv_tpu_torch.models.import_torch import load_checkpoint

    path, kw = _write_case(case, tmp_path)
    got, cfg = load_checkpoint(path, **kw)
    want, jcfg = jax_load(path, **kw)
    assert repr(cfg) == repr(jcfg)
    _assert_same_params(got, want)
    if case == "composite_hg_path":
        assert cfg.use_hg and "hg.conv1.0.weight" in got and "base.LE.conv_first.weight" in got
        assert not any(".1.running_" in k or "num_batches" in k for k in got)
    if case == "lowrank":
        assert got["AGCM.HRconv_reduce.weight"].shape[-1] == 8 and "AGCM.HRconv.weight" not in got
    if case == "lite":
        assert got["AGCM.conv_first.weight"].shape[-1] == 16


def test_woin_remap_matches_jax():
    """The woIN renumbering on a state that has the 20-layer classifier:
    InstanceNorm entries dropped, 4 → 3 … 20 → 16, as the JAX remap does."""
    from hdrtv_tpu.models.import_torch import remap_condition_state as jax_remap
    from hdrtv_tpu_torch.models.import_torch import remap_condition_state

    state, _ = _release()
    got = remap_condition_state(state, prefix="AGCM.", classifier="color_condition_woin")
    want = jax_remap(state, prefix="AGCM.", classifier="color_condition_woin")
    _assert_same_params(got, want)
    assert "AGCM.classifier.model.16.weight" in got and "AGCM.classifier.model.20.weight" not in got
    assert not any(k.startswith("AGCM.classifier.model.15.") for k in got)


def test_fold_hg_batchnorm_matches_jax():
    from hdrtv_tpu.models.import_torch import fold_hg_batchnorm as jax_fold
    from hdrtv_tpu_torch.models.import_torch import fold_hg_batchnorm

    hg = {f"hg.{k}": v for k, v in _hg_sources().items()}
    got, want = fold_hg_batchnorm(hg), jax_fold(hg)
    _assert_same_params(got, want)
    assert len(got) < len(hg)


def _e4m3_edges() -> np.ndarray:
    """Values for a tensor whose amax is 448 (scale 1, so they reach the
    cast as they are): ±448, every e4m3 value, every midpoint between two
    neighbours (exact ties, which round to even) and the floats just either
    side of it, the subnormal range (below 2⁻⁶) down to half the smallest
    subnormal 2⁻⁹, and zeros."""
    import ml_dtypes

    vals = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn).astype(f32)
    vals = np.unique(vals[np.isfinite(vals)])
    mids = ((vals[1:].astype(np.float64) + vals[:-1]) / 2).astype(f32)
    sub = np.array([2.0**-6, 2.0**-7, 3 * 2.0**-9, 2.0**-9, 2.0**-10, 3 * 2.0**-10, 2.0**-11], f32)
    return np.concatenate([[448.0, -448.0, 0.0, -0.0], vals, mids, np.nextafter(mids, np.inf),
                           np.nextafter(mids, -np.inf), sub, -sub]).astype(f32)


def test_fp8_e4m3_roundtrip_matches_jax_on_edge_values():
    """``torch.float8_e4m3fn`` against ``ml_dtypes.float8_e4m3fn``, bit for
    bit, on the edges at scale 1, on random tensors at other scales, and on
    an all-zero tensor."""
    from hdrtv_tpu.models.import_torch import fp8_e4m3_roundtrip as jax_rt
    from hdrtv_tpu_torch.models.import_torch import fp8_e4m3_roundtrip

    rng = np.random.RandomState(8)
    cases = [_e4m3_edges(), rng.randn(64, 32, 3, 3).astype(f32) * 0.05, rng.randn(17, 9).astype(f32) * 3e3,
             np.zeros((4, 4), f32), (rng.rand(1000).astype(f32) - 0.5) * 2.0**-20]
    for w in cases:
        got, want = fp8_e4m3_roundtrip(w), jax_rt(w)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()
    edges = _e4m3_edges()
    assert np.array_equal(fp8_e4m3_roundtrip(edges)[:2], [448.0, -448.0])


def test_fp8_container_emulates_its_layers(tmp_path):
    """An FP8 source container rounds the named layers (a missing one is
    skipped) onto the e4m3 grid and no other layer; ``fp8_emulate=False``
    keeps the fp32 tensors."""
    from hdrtv_tpu_torch.models.import_torch import fp8_e4m3_roundtrip, load_checkpoint, load_torch_file

    path, _ = _write_case("fp8", tmp_path)
    _, meta = load_torch_file(path)
    layers = meta["quantized_layers"]
    p8, _ = load_checkpoint(path)
    p32, _ = load_checkpoint(path, fp8_emulate=False)
    moved = sorted(k[: -len(".weight")] for k in p8 if not np.array_equal(p8[k], p32[k]))
    assert set(moved) == set(layers) - {"LE.no_such_layer"} and len(moved) > 10
    for layer in moved:
        w = p8[f"{layer}.weight"]
        assert np.array_equal(fp8_e4m3_roundtrip(w), w)


@pytest.mark.parametrize("kind", ["pt", "npz"])
def test_split_source_checkpoint_matches_jax(kind, tmp_path):
    """A composite split by both packages: the same key lists, the same
    arrays in the written files and the same sidecars (layer lists filtered
    by prefix)."""
    from hdrtv_tpu.models.import_torch import split_source_checkpoint as jax_split
    from hdrtv_tpu_torch.models.import_npz import load_npz, save_npz
    from hdrtv_tpu_torch.tools.synth_variants import write_pt

    state, arch = _release()
    comp = {**{f"base.{k}": v for k, v in state.items()}, **{f"hg.{k}": v for k, v in _hg_sources().items()}}
    meta = {"w8a8_layers": ["base.LE.conv_first", "hg.conv1.0", "AGCM.HRconv"], "fp16_layers": ["hg.conv10"],
            "quantization": "w8a8"}
    if kind == "pt":
        src = write_pt(str(tmp_path / "comp.pt"), comp, {**arch, "use_hg": True}, **meta)
    else:
        src = str(tmp_path / "comp.npz")
        save_npz(src, comp, {"architecture": {**arch, "use_hg": True}, **meta})
    from hdrtv_tpu_torch.models.import_torch import split_source_checkpoint

    outs = {}
    for who, fn in (("port", split_source_checkpoint), ("jax", jax_split)):
        d = tmp_path / who
        keys = fn(src, str(d / "hr.npz"), str(d / "hg.npz"))
        outs[who] = (keys, {n: load_npz(str(d / f"{n}.npz")) for n in ("hr", "hg")},
                     {n: json.loads((d / f"{n}.json").read_text()) for n in ("hr", "hg")})
    (pk, pf, pm), (jk, jf, jm) = outs["port"], outs["jax"]
    assert pk == jk and pm == jm
    assert pm["hr"]["w8a8_layers"] == ["LE.conv_first", "AGCM.HRconv"] and pm["hg"]["fp16_layers"] == ["conv10"]
    for n in ("hr", "hg"):
        _assert_same_params(pf[n], jf[n])
    with pytest.raises(ValueError, match="not a composite"):
        split_source_checkpoint(WEIGHTS, str(tmp_path / "a.npz"), str(tmp_path / "b.npz"))


@pytest.fixture(scope="module")
def release_pt(tmp_path_factory):
    from hdrtv_tpu_torch.tools.synth_variants import write_pt

    state, arch = _release()
    return write_pt(str(tmp_path_factory.mktemp("pt") / "hr_fp32.pt"), state, arch)


@pytest.mark.parametrize("precision", ["fp16", "fp32"])
def test_model_hash_of_pt_equals_npz(precision, release_pt):
    """A ``.pt`` and the ``.npz`` holding the same weights load to the same
    parameters and fingerprint, in the port and in the JAX runtime."""
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    pt = HDRTVNetTorch(release_pt, precision=precision, device="cpu")
    nz = HDRTVNetTorch(WEIGHTS, precision=precision, device="cpu")
    assert pt.turbo and repr(pt.cfg) == repr(nz.cfg)
    assert pt.model_hash == nz.model_hash == HDRTVNetTPU(release_pt, precision=precision,
                                                        persistent_cache=False).model_hash
    assert sorted(pt.params) == sorted(nz.params)
    assert all(torch.equal(pt.params[k], nz.params[k]) for k in nz.params if isinstance(nz.params[k], torch.Tensor))


def test_pt_frame_matches_jax(release_pt):
    """One small frame through both runtimes from the same ``.pt`` (fp32,
    the s2d program) within 4 u16 codes, and bit-equal to the port's
    ``.npz`` processor."""
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    frame = (np.random.RandomState(20).rand(32, 48, 3) * 255).astype(np.uint8)
    got = HDRTVNetTorch(release_pt, precision="fp32", device="cpu").process_rgb48(frame)
    assert np.array_equal(got, HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu").process_rgb48(frame))
    want = HDRTVNetTPU(release_pt, precision="fp32", persistent_cache=False).process_rgb48(frame)
    assert got.shape == (32, 48, 3) and np.abs(got.astype(np.int64) - want).max() <= 4


def test_composite_hg_path_processor_matches_jax(tmp_path):
    """``HDRTVNetTorch(hr.pt, hg_path=hg.pt)`` (the generator's BatchNorms
    folded at load) against ``HDRTVNetTPU`` on the same files: the same
    configuration and fingerprint, frames within 4 codes off the mask's
    threshold (fp32, turbo off: the natural composite)."""
    from hdrtv_tpu.runtime.processor import HDRTVNetTPU
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    path, kw = _write_case("composite_hg_path", tmp_path)
    frame = np.clip(np.kron(np.random.RandomState(5).rand(4, 6, 1), np.ones((8, 8, 3))) * 420, 0, 255).astype(np.uint8)
    tp = HDRTVNetTorch(path, precision="fp32", device="cpu", turbo=False, **kw)
    jp = HDRTVNetTPU(path, precision="fp32", persistent_cache=False, turbo=False, **kw)
    assert tp.cfg.use_hg and repr(tp.cfg) == repr(jp.cfg) and tp.model_hash == jp.model_hash
    got, want = tp.process_rgb48(frame).astype(np.int64), jp.process_rgb48(frame).astype(np.int64)
    base = HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu", turbo=False).process_rgb48(frame)
    near = np.abs(base.astype(np.float32).max(axis=-1) / 65535.0 - 0.775) <= 2e-4
    assert np.abs(got - want).max(axis=-1)[~near].max() <= 4
    assert (np.abs(got - base) > 0).any()


def test_hg_path_with_npz_raises():
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    with pytest.raises(ValueError, match="hg_path goes with a .pt model"):
        HDRTVNetTorch(WEIGHTS, device="cpu", hg_path="hg.pt")


def test_new_modules_leave_jax_and_ml_dtypes_out():
    """The checkpoint, variant and metric modules import neither JAX, nor the
    JAX package, nor ``ml_dtypes`` (the card's machine has none); the FP8
    rounding runs there."""
    code = (
        "import sys\n"
        "import hdrtv_tpu_torch.models.import_torch as it, hdrtv_tpu_torch.ops.metrics, "
        "hdrtv_tpu_torch.tools.synth_variants, hdrtv_tpu_torch.runtime.processor, hdrtv_tpu_torch.cli\n"
        "import numpy as np\n"
        "assert it.fp8_e4m3_roundtrip(np.array([448.0, 1.0625, 3 * 2.0**-10], np.float32)).tolist() == "
        "[448.0, 1.0, 2.0**-8]\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'hdrtv_tpu', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
