"""The port's CLI on the CPU (``HDRTV_CLI_PLATFORM=cpu``): the parser takes
the JAX CLI's command lines (``tests/test_cli.py``), ``convert`` runs a
synthetic source to the null and file sinks and ``export`` a clip written
with cv2, against the port's own per-frame program (bit for bit) and the
JAX package's (CODES u16 codes in fp32: the 5e-5 golden tolerance × 65535,
rounded up, as ``tests/test_torch_slice.py``); ``convert`` and ``export``
take a reference ``.pt`` ``--model`` (and ``--hg-weights``); ``presets``,
``assets`` and ``engines`` run; ``info`` and ``split-sources`` print and
write what the JAX CLI does; ``quantize`` and ``mine-hard-frames`` write
what the JAX CLI writes on the same inputs, ``layout``, ``qat``, ``sweep``
and ``teacher-pairs`` run on the port at small sizes (their modules are held
to JAX in tests/test_torch_quant.py, test_torch_train.py and
test_torch_curate_sweep.py); ``live`` runs the synthetic capture and refuses
a capture device that does not exist (its modules are held to JAX in
tests/test_torch_live.py, ``convert --audio`` and ``--interactive`` in
tests/test_torch_audio_shell.py); every option that is not ported raises
``NotImplementedError`` naming its ROADMAP.md item; without a card and
without the CPU switch nothing runs. The config, prefs and assets copies
agree with the JAX package's.

The presets' resolutions are cut to 64 × 96 for the runs (``RESOLUTION_SCALES``
patched): the CLI processes at the preset's size.
"""

import csv
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from hdrtv_tpu import config as jax_config
from hdrtv_tpu.cli import build_parser as jax_build_parser
from hdrtv_tpu_torch import cli, config

ROOT = os.path.join(os.path.dirname(__file__), "..")
WEIGHTS = os.path.join(ROOT, "weights", "hr_fp32.npz")
CODES = 4
H, W = 64, 96

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU programs on one intra-op thread: the suite runs in several
    worker processes at once, and torch's thread pools, one a core in each,
    slow every one of them down many times over when they share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_cli.py TestParser.test_all_subcommands_parse
ARGVS = [
    ["convert", "--display", "null", "--frames", "3"],
    ["bench", "--duration", "1"],
    ["engines", "list"],
    ["build-engines", "--resolutions", "540p"],
    ["quantize", "--model", "m.npz", "--out", "o.npz"],
    ["info", "--model", "m.npz"],
    ["export", "--video", "v.mp4"],
    ["export", "--video", "v.mp4", "--hosts", "4", "--host-id", "2"],
    ["convert", "--mesh", "spatial", "--display", "null"],
    ["live", "--capture", "synthetic", "--display", "null"],
]


@pytest.fixture
def cpu_cli(monkeypatch, tmp_path):
    """The CLI on the CPU at 64 × 96, prefs and the engine registry in
    tmp_path, and no playback lock."""
    monkeypatch.setenv("HDRTV_CLI_PLATFORM", "cpu")
    monkeypatch.setenv("HDRTVNET_PREFS_PATH", str(tmp_path / "prefs.json"))
    monkeypatch.setenv("HDRTVNET_ENGINE_CACHE_DIR", str(tmp_path / "engines"))
    monkeypatch.setenv("HDRTVNET_CACHE_DIR", str(tmp_path / "cache"))
    for key in ("540p", "1080p"):
        monkeypatch.setitem(config.RESOLUTION_SCALES, key, (W, H))
    return tmp_path


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a[:2]) + f"-{i}" for i, a in enumerate(ARGVS)])
def test_parser_takes_the_jax_command_lines(argv):
    ours, theirs = cli.build_parser().parse_args(argv), jax_build_parser().parse_args(argv)
    assert callable(ours.fn)
    assert {k: v for k, v in vars(ours).items() if k != "fn"} == {k: v for k, v in vars(theirs).items() if k != "fn"}


def test_parser_has_the_jax_subcommands():
    def subs(p):
        return set(next(a for a in p._actions if a.dest == "cmd").choices)

    assert subs(cli.build_parser()) == subs(jax_build_parser())
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["convert", "--resolution", "8K"])


def _synthetic(n):
    from hdrtv_tpu_torch.pipeline.source import SyntheticSource

    src = SyntheticSource(W, H, fps=30, frames=n)
    return [src.read_with_meta()[0] for _ in range(n)]


def test_convert_null_and_file(cpu_cli, capsys):
    """convert --display null --frames 3, then --display file: the file
    holds the frames the port's processor gives the synthetic source's
    frames, bit for bit, and the prefs keep the last run's settings."""
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch
    from hdrtv_tpu_torch.utils.prefs import load_prefs

    assert cli.main(["convert", "--display", "null", "--frames", "3", "--no-realtime", "--resolution", "540p"]) == 0
    assert "frames=3 " in capsys.readouterr().out
    out = str(cpu_cli / "o.rgb48")
    assert cli.main(["convert", "--display", "file", "--output", out, "--frames", "4", "--no-realtime",
                     "--precision", "FP32", "--stages"]) == 0
    text = capsys.readouterr().out
    assert "frames=4 " in text and "render" in text
    got = np.fromfile(out, np.uint16)
    assert got.size == 4 * H * W * 3
    proc = HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu", persistent_cache=False, proc_resolution=(W, H))
    want = np.stack([proc.process_rgb48(f) for f in _synthetic(4)])
    assert np.array_equal(got.reshape(4, H, W, 3), want)
    assert load_prefs()["display"] == "file" and load_prefs()["precision"] == "FP32"


def _clip(path, n=4):
    import cv2

    rng = np.random.RandomState(5)
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 24, (W, H))
    for _ in range(n):
        wr.write((rng.rand(H, W, 3) * 255).astype(np.uint8))
    wr.release()


def test_export_clip_matches_jax(cpu_cli, capsys, monkeypatch):
    """export --codec raw of a four-frame MJPG clip: the port's file holds
    its own processor's frames of the decoded clip bit for bit, and is
    within CODES of the JAX CLI's export of the same clip."""
    import json

    import cv2

    from hdrtv_tpu import cli as jax_cli
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    clip = str(cpu_cli / "clip.avi")
    _clip(clip)
    outs = {}
    monkeypatch.setitem(jax_config.RESOLUTION_SCALES, "540p", (W, H))
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        rc = main(["export", "--video", clip, "--codec", "raw", "--precision", "FP32", "--resolution", "540p",
                   "--output", str(cpu_cli / f"{name}.rgb48")])
        assert rc == 0
        text = capsys.readouterr().out
        stats = json.loads(text[text.index("{"):])
        assert stats["frames"] == 4 and stats["codec"] == "raw"
        outs[name] = np.fromfile(stats["output"], np.uint16).reshape(4, H, W, 3)
    cap = cv2.VideoCapture(clip)
    frames = [cap.read()[1] for _ in range(4)]
    cap.release()
    proc = HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu", persistent_cache=False, proc_resolution=(W, H))
    assert np.array_equal(outs["port"], np.stack([proc.process_rgb48(f) for f in frames]))
    assert np.abs(outs["port"].astype(np.int64) - outs["jax"].astype(np.int64)).max() <= CODES


def test_presets_assets_engines_run(cpu_cli, capsys):
    assert cli.main(["presets"]) == 0
    text = capsys.readouterr().out
    assert "INT8 Mixed (QAT)" in text and "resolutions:" in text
    assert cli.main(["assets"]) == 0 and "present" in capsys.readouterr().out
    assert cli.main(["engines", "list"]) == 0 and "(no engines recorded)" in capsys.readouterr().out
    assert cli.main(["engines", "warm", "--resolution", "540p"]) == 0
    assert f"warmed {W}x{H}" in capsys.readouterr().out
    assert cli.main(["engines", "list"]) == 0 and f"_{W}x{H}_fp16" in capsys.readouterr().out
    assert cli.main(["engines", "clear"]) == 0 and "cleared 1" in capsys.readouterr().out
    assert cli.main(["build-engines", "--resolutions", "540p", "--precisions", "FP32,fp16",
                     "--benchmark-runs", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and all("engine ready" in ln and "ms/frame over 1 runs" in ln for ln in lines)


@pytest.mark.parametrize("argv,item", [
    (["convert", "--mesh", "spatial", "--display", "null", "--frames", "1", "--no-realtime", "--resolution",
      "540p"], "running single-chip"),
    (["export", "--video", "v.mp4", "--hosts", "4", "--host-id", "2", "--codec", "raw", "--precision", "FP32",
      "--resolution", "540p"], '"host_id": 2'),
    (["export", "--video", "v.mp4", "--mesh", "--batch", "2", "--codec", "raw", "--precision", "FP32",
      "--resolution", "540p"], '"frames": 5'),
], ids=["mesh-spatial", "hosts", "export-mesh"])
def test_unported_options_raise(argv, item, cpu_cli, capsys):
    """The multi-device options, once refused, run (the JAX CLI's lines):
    ``convert --mesh spatial`` with one visible device says so and runs
    single-chip; ``export --hosts 4 --host-id 2`` renders host 2's frame
    range of a five-frame clip ([3, 4), by ``plan_frame_ranges``) into its
    segment with a ``.done`` marker; ``export --mesh --batch 2`` splits its
    full batches over the (one-device) mesh's data axis. Each exported
    frame is the port's processor's frame of the decoded clip, bit for bit."""
    import json

    import cv2

    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    clip = str(cpu_cli / "clip.avi")
    _clip(clip, n=5)
    out = str(cpu_cli / "x.mov")
    if argv[0] == "export":
        argv = [clip if a == "v.mp4" else a for a in argv] + ["--output", out]
    assert cli.main(argv) == 0
    text = capsys.readouterr().out
    assert item in text
    if argv[0] == "convert":
        assert "frames=1 " in text
        return
    stats = json.loads(text[text.index("{"):])
    cap = cv2.VideoCapture(clip)
    frames = [cap.read()[1] for _ in range(5)]
    cap.release()
    start, end = stats.get("frame_range", (0, 5))
    assert (start, end) == ((3, 4) if "--hosts" in argv else (0, 5)) and stats["frames"] == end - start
    if "--hosts" in argv:
        assert os.path.isfile(str(cpu_cli / "x.seg002.mov.rgb48.done"))
    proc = HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu", persistent_cache=False, proc_resolution=(W, H))
    got = np.fromfile(stats["output"], np.uint16).reshape(end - start, H, W, 3)
    assert np.array_equal(got, np.stack([proc.process_rgb48(f) for f in frames[start:end]]))


def test_live_synthetic_null_sink(cpu_cli, capsys):
    """tests/test_cli.py test_live_synthetic_null_sink on the port: the
    synthetic capture to the null sink, the JAX summary line."""
    assert cli.main(["live", "--model", WEIGHTS, "--capture", "synthetic", "--display", "null",
                     "--resolution", "540p", "--fps", "60", "--frames", "2"]) == 0
    out = capsys.readouterr().out
    assert "frames=2" in out and "observed=" in out and "audio_delay_target=" in out


def test_live_bad_capture_spec(cpu_cli, capsys):
    """tests/test_cli.py test_live_bad_capture_spec on the port: a v4l2
    device that does not exist returns 2, saying the capture is unavailable."""
    assert cli.main(["live", "--model", WEIGHTS, "--capture", "v4l2:/dev/video99", "--display", "null",
                     "--resolution", "540p", "--frames", "1"]) == 2
    assert "unavailable" in capsys.readouterr().out


def test_live_needs_a_card_without_the_switch(monkeypatch, tmp_path):
    """live, like every command, refuses without a card and without
    HDRTV_CLI_PLATFORM=cpu, and starts no capture thread."""
    import threading

    monkeypatch.delenv("HDRTV_CLI_PLATFORM", raising=False)
    monkeypatch.setenv("HDRTVNET_PREFS_PATH", str(tmp_path / "prefs.json"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["live", "--capture", "synthetic", "--display", "null", "--frames", "1"])
    assert not any(t.name == "live-observe" for t in threading.enumerate())


def test_no_card_no_switch_raises(monkeypatch, tmp_path):
    """Without a CUDA device and without HDRTV_CLI_PLATFORM=cpu the CLI
    refuses; it never runs the CPU in the card's place."""
    monkeypatch.delenv("HDRTV_CLI_PLATFORM", raising=False)
    monkeypatch.setenv("HDRTVNET_PREFS_PATH", str(tmp_path / "prefs.json"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["convert", "--display", "null", "--frames", "1"])
    monkeypatch.setenv("HDRTV_CLI_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="HDRTV_CLI_PLATFORM"):
        cli.main(["convert", "--display", "null", "--frames", "1"])


def test_config_matches_jax(monkeypatch, tmp_path):
    """The same presets, tokens and checkpoints, each below its package's
    weights root (the port's reloaded under tmp_path); the same name
    resolution, processing sizes and availability rule."""
    import importlib

    jax_root = jax_config.weights_root()
    monkeypatch.setenv("HDRTVNET_WEIGHTS_ROOT", str(tmp_path))
    ours = importlib.reload(config)
    try:
        def rel(p, root):
            return None if p is None else os.path.relpath(p, root)

        assert list(ours.PRECISIONS) == list(jax_config.PRECISIONS)
        for key in ours.PRECISIONS:
            a, b = ours.PRECISIONS[key], jax_config.PRECISIONS[key]
            assert (a.precision, a.requires_fp8) == (b.precision, b.requires_fp8)
            for f in ("model", "model_nohg", "hg_weights"):
                assert rel(getattr(a, f), str(tmp_path)) == rel(getattr(b, f), jax_root), (key, f)
        for name in ("fp16", "FP32", "int8-mixed-qat", "int8-full-qat-film", "fp8-full-ptq", "nope", None):
            assert ours.resolve_precision_key(name) == jax_config.resolve_precision_key(name)
        for key in ("540p", "720p", "1080p", "4K", "8K", None):
            assert ours.processing_dims(key) == jax_config.processing_dims(key)
        for wh in ((640, 360), (960, 540), (1280, 720), (1921, 1080), (4000, 3000)):
            assert ours.max_processing_preset_for_source(*wh) == jax_config.max_processing_preset_for_source(*wh)
        assert ours.available_precisions() == []
        (tmp_path / "original").mkdir()
        (tmp_path / "original" / "HR.pt").write_bytes(b"\0" * 70000)
        assert ours.available_precisions() == ["FP16", "FP32"]
    finally:
        monkeypatch.delenv("HDRTVNET_WEIGHTS_ROOT")
        importlib.reload(config)


def test_prefs_and_assets_match_jax(monkeypatch, tmp_path):
    from hdrtv_tpu.utils import assets as jax_assets
    from hdrtv_tpu.utils import prefs as jax_prefs
    from hdrtv_tpu_torch.utils import assets, prefs

    monkeypatch.setenv("HDRTVNET_PREFS_PATH", str(tmp_path / "p.json"))
    prefs.save_prefs(precision="INT8 Full (QAT)", resolution="720p")
    assert jax_prefs.load_prefs() == prefs.load_prefs() == {"precision": "INT8 Full (QAT)", "resolution": "720p"}
    with pytest.raises(ValueError):
        prefs.save_prefs(nonsense=1)
    page = tmp_path / "page.pt"
    page.write_bytes(b"<html>" + b"x" * 4096)
    for p in (str(page), str(tmp_path / "missing.pt"), WEIGHTS):
        assert assets.validate_file(p) == jax_assets.validate_file(p)
    assert [(a.path, a.status) for a in assets.required_assets()] == \
        [(a.path, a.status) for a in jax_assets.required_assets()]
    monkeypatch.setenv("HDRTVNET_REQUIRE_CLONE_ASSETS", "1")
    with pytest.raises(RuntimeError, match="required weight file"):
        assets.require_assets_or_raise()


def test_hdr_bypass_flips_channels_only():
    """--hdr-input bypass: each pixel's u8 PQ codes × 257 with BGR turned
    into RGB, the frame's columns in place (frames ship as (H, W, 3))."""
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    frame = np.random.RandomState(7).randint(0, 256, (H, W, 3)).astype(np.uint8)
    bp = cli._Bypass(HDRTVNetTorch(WEIGHTS, device="cpu", persistent_cache=False))
    out = bp.process_rgb48_device(bp.put_frame(frame.reshape(H, -1))).numpy()
    assert out.dtype == np.uint16 and np.array_equal(out, frame[..., ::-1].astype(np.uint16) * 257)


def _pt_pair(tmp_path):
    """The shipped weights as a reference ``.pt`` (HR), and a synthetic
    HG generator's own ``.pt`` (nf = 8, BatchNorms unfolded)."""
    from hdrtv_tpu_torch.models.import_npz import load_npz, load_npz_meta, npz_arch_dict
    from hdrtv_tpu_torch.tools.synth_hg import synth_hg_params
    from hdrtv_tpu_torch.tools.synth_variants import to_torch_layout, write_pt

    arch = npz_arch_dict(load_npz_meta(WEIGHTS))
    hr = write_pt(str(tmp_path / "HR.pt"), to_torch_layout(load_npz(WEIGHTS)), arch)
    hg = {k[3:]: v for k, v in synth_hg_params(nf=8, seed=2).items() if k.startswith("hg.")}
    return hr, write_pt(str(tmp_path / "HG.pt"), to_torch_layout(hg))


@pytest.mark.parametrize("which", ["npz", "pt", "pt_use_hg"])
def test_info_matches_jax(which, tmp_path, capsys):
    """info prints the JAX CLI's JSON: tensors, parameters, the layer mix
    (of the int8 fixture too) and, for a ``.pt``, the configuration."""
    from hdrtv_tpu import cli as jax_cli

    hr, _ = _pt_pair(tmp_path)
    argvs = {"npz": [["info", "--model", WEIGHTS], ["info", "--model", os.path.join(ROOT, "tests", "fixtures",
                                                                                       "hr_w8a8.npz")]],
             "pt": [["info", "--model", hr]], "pt_use_hg": [["info", "--model", hr, "--use-hg"]]}[which]
    for argv in argvs:
        texts = []
        for main in (cli.main, jax_cli.main):
            assert main(argv) == 0
            texts.append(capsys.readouterr().out)
        assert texts[0] == texts[1] and '"tensors"' in texts[0]


def test_split_sources_matches_jax(tmp_path, capsys):
    """split-sources of a composite ``.pt``: the same printed lines and the
    same two files (arrays and sidecars) as the JAX CLI's."""
    import json

    from hdrtv_tpu import cli as jax_cli
    from hdrtv_tpu_torch.models.import_npz import load_npz, load_npz_meta, npz_arch_dict
    from hdrtv_tpu_torch.tools.synth_hg import synth_hg_params
    from hdrtv_tpu_torch.tools.synth_variants import to_torch_layout, write_pt

    comp = write_pt(str(tmp_path / "comp.pt"), to_torch_layout(synth_hg_params(nf=8, seed=4)),
                    {**npz_arch_dict(load_npz_meta(WEIGHTS)), "use_hg": True, "hg_nf": 8},
                    w8a8_layers=["base.LE.conv_first", "hg.conv2.0"])
    outs = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        d = tmp_path / name
        assert main(["split-sources", "--model", comp, "--out-hr", str(d / "hr.npz"), "--out-hg", str(d / "hg.npz")]) == 0
        outs[name] = (capsys.readouterr().out.replace(str(d), "D"),
                      {n: load_npz(str(d / f"{n}.npz")) for n in ("hr", "hg")},
                      {n: json.loads((d / f"{n}.json").read_text()) for n in ("hr", "hg")})
    (pt, pf, pm), (jt, jf, jm) = outs["port"], outs["jax"]
    assert pt == jt and "HG: " in pt and pm == jm and pm["hg"]["w8a8_layers"] == ["conv2.0"]
    for n in ("hr", "hg"):
        assert sorted(pf[n]) == sorted(jf[n]) and all(np.array_equal(pf[n][k], jf[n][k]) for k in jf[n])


def test_convert_and_export_take_a_pt(cpu_cli, capsys, tmp_path):
    """convert --model HR.pt --hg-weights HG.pt --use-hg writes the frames of
    the composite the processor loads from the same two files; export
    --model HR.pt writes those of the ``.npz`` processor (the same weights)."""
    import json

    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    hr, hg = _pt_pair(tmp_path)
    out = str(cpu_cli / "o.rgb48")
    assert cli.main(["convert", "--model", hr, "--hg-weights", hg, "--use-hg", "--display", "file", "--output", out,
                     "--frames", "2", "--no-realtime", "--precision", "FP32"]) == 0
    assert "frames=2 " in capsys.readouterr().out
    proc = HDRTVNetTorch(hr, hg_path=hg, use_hg=True, precision="fp32", device="cpu", proc_resolution=(W, H))
    assert proc.cfg.use_hg and proc.turbo
    want = np.stack([proc.process_rgb48(f) for f in _synthetic(2)])
    assert np.array_equal(np.fromfile(out, np.uint16).reshape(2, H, W, 3), want)
    clip = str(cpu_cli / "clip.avi")
    _clip(clip, n=2)
    assert cli.main(["export", "--video", clip, "--model", hr, "--codec", "raw", "--precision", "FP32",
                     "--resolution", "540p", "--output", str(cpu_cli / "x.rgb48")]) == 0
    text = capsys.readouterr().out
    stats = json.loads(text[text.index("{"):])
    got = np.fromfile(stats["output"], np.uint16).reshape(2, H, W, 3)
    assert cli.main(["export", "--video", clip, "--model", WEIGHTS, "--codec", "raw", "--precision", "FP32",
                     "--resolution", "540p", "--output", str(cpu_cli / "y.rgb48")]) == 0
    capsys.readouterr()
    assert np.array_equal(got, np.fromfile(str(cpu_cli / "y.rgb48"), np.uint16).reshape(2, H, W, 3))


# ---------------------------------------------------------------------------
# The bench commands: bench, quality, compare, sessions, validate, preview,
# figures, doctor, and convert --log-session
# ---------------------------------------------------------------------------


class _JaxFake:
    """A processor for the JAX CLI's runs: the SDR frame as RGB48."""

    model_path = ""

    def warmup_compile(self, w, h, **kw):
        return 0.0

    def process_rgb48_device(self, frame):
        import jax.numpy as jnp

        return frame.astype(jnp.uint16) * 257

    def process_rgb48(self, frame_bgr):
        return frame_bgr[..., ::-1].astype(np.uint16) * 257


class _TorchFake(_JaxFake):
    """The same for the port's CLI, on torch tensors (HDRTVNetTorch's frame
    contract: (H, 3W) u8 rows in, u16 out)."""

    device = torch.device("cpu")

    def put_frame(self, flat):
        return torch.from_numpy(np.ascontiguousarray(flat))

    def process_rgb48_device(self, x):
        return x.to(torch.int32).mul(257).to(torch.uint16)


@pytest.fixture
def both_clis(cpu_cli, monkeypatch):
    """The port's and the JAX CLI on fake processors at 64 × 96 (both
    packages' presets cut), the sessions under tmp_path."""
    from hdrtv_tpu import cli as jax_cli

    for key in ("540p", "1080p"):
        monkeypatch.setitem(jax_config.RESOLUTION_SCALES, key, (W, H))
    monkeypatch.setattr(cli, "_make_processor", lambda args: _TorchFake())
    monkeypatch.setattr(jax_cli, "_make_processor", lambda args: _JaxFake())
    return {"port": cli.main, "jax": jax_cli.main}


def _json_out(text):
    return json.loads(text[text.index("{"):text.rindex("}") + 1])


def test_bench_matches_jax(both_clis, cpu_cli, capsys):
    """bench (the session's JSON and files), --device-resident-only and the
    --resolutions / --runs matrix through both CLIs on the same fake."""
    got = {}
    for name, main in both_clis.items():
        out = cpu_cli / name
        assert main(["bench", "--duration", "0.3", "--no-realtime", "--out", str(out / "s")]) == 0
        res = _json_out(capsys.readouterr().out)
        assert main(["bench", "--duration", "0.1", "--device-resident-only"]) == 0
        dr = _json_out(capsys.readouterr().out)
        assert main(["bench", "--duration", "0.2", "--no-realtime", "--resolutions", "540p", "--runs", "FP16",
                     "FP32", "--out", str(out / "b")]) == 0
        text = capsys.readouterr().out
        with open(out / "b" / "batch.csv") as f:
            rows = list(csv.reader(f))
        got[name] = (res, dr, sorted(os.listdir(out / "s")), text.splitlines()[-1].split(":")[0], rows)
    (res, dr, files, last, rows), (jres, jdr, jfiles, jlast, jrows) = got["port"], got["jax"]
    assert set(res) == set(jres) and res["config"] == jres["config"] and res["frames"] == jres["frames"] == 9
    assert set(dr) == set(jdr) | {"device"} and dr["frames"] == jdr["frames"] == 3 and dr["resolution"] == "96x64"
    assert files == jfiles == ["runtime_metrics.csv", "session.json", "summary.txt"]
    assert last == jlast == "batch CSV" and rows[0] == jrows[0] and [r[:3] for r in rows] == [r[:3] for r in jrows]


def test_bench_runs_the_port_processor(cpu_cli, capsys):
    """bench on HDRTVNetTorch (CPU, 64 × 96): the device-resident chain and
    the pipelined run, under the torch.profiler trace."""
    trace = cpu_cli / "trace"
    assert cli.main(["bench", "--duration", "0.2", "--no-realtime", "--resolution", "540p", "--device-resident",
                     "--out", str(cpu_cli / "s"), "--trace", str(trace)]) == 0
    text = capsys.readouterr().out
    dr = json.loads(text[text.index("{"):text.index("}") + 1])
    assert dr["frames"] == 6 and dr["device"] == "cpu" and dr["resolution"] == f"{W}x{H}"
    assert "device trace written" in text and os.path.isfile(trace / "trace.json")
    assert _json_out(text[text.index("}") + 1:])["frames"] == 6


def test_bench_supervised_runs_the_jax_child(both_clis, monkeypatch, capsys):
    """bench --supervised: the child's argv is the JAX CLI's with the port's
    module, the child's rc is the command's, the batch table printed."""
    from hdrtv_tpu.bench import wrapper as jw
    from hdrtv_tpu_torch.bench import wrapper as tw

    seen = {}
    for name, mod in (("port", tw), ("jax", jw)):
        class Recorder(mod.PlaybackBenchmarkWrapper):
            def run(self, _name=name):
                seen[_name] = self.argv
                self.on_line("child line")
                return 7

        monkeypatch.setattr(mod, "PlaybackBenchmarkWrapper", Recorder)
    argv = ["bench", "--supervised", "--resolution", "1080p", "--duration", "3", "--no-realtime"]
    for name, main in both_clis.items():
        assert main(argv) == 7
        text = capsys.readouterr().out
        assert "  | child line" in text and "[wrapper] child rc=7" in text
    assert seen["port"][1:3] == ["-m", "hdrtv_tpu_torch.cli"] and seen["jax"][1:3] == ["-m", "hdrtv_tpu.cli"]
    assert seen["port"][3:] == seen["jax"][3:] == [a for a in argv if a != "--supervised"]


def _gt_pair(tmp, lead=2, n=30):
    """An MJPG SDR clip of seeded noise frames and a 10-bit y4m ground truth
    of the same frames ``lead`` frames late, with its PQ sidecar."""
    import cv2

    from hdrtv_tpu.pipeline.export import _y4m_sidecar
    from hdrtv_tpu_torch.bench.y4m import Y4MWriter

    frames = np.random.RandomState(7).randint(0, 255, (n, H, W, 3), np.uint8)
    sdr = str(tmp / "clip.avi")
    wr = cv2.VideoWriter(sdr, cv2.VideoWriter_fourcc(*"MJPG"), 25.0, (W, H))
    for f in frames:
        wr.write(f)
    wr.release()
    gt = str(tmp / "gt.y4m")
    with Y4MWriter(gt, W, H, fps=25.0, ctag="422p10") as gw:
        for _ in range(lead):
            gw.write_rgb_unit(np.zeros((H, W, 3), np.float32), matrix="bt2020nc")
        for f in frames:
            gw.write_rgb_unit(f[..., ::-1].astype(np.float32) / 255.0, matrix="bt2020nc")
    with open(gt + ".json", "w") as f:
        json.dump(_y4m_sidecar(gt), f)
    return sdr, gt


def test_quality_matches_jax(both_clis, cpu_cli, capsys, monkeypatch):
    """quality with the GT validation gate (the +2 sync offset found and fed
    into the frame map) and quality --queue FP16,FP32, both CLIs on the same
    fake: the same JSON (metrics at tests/test_torch_metrics.py's tolerances
    plus the summary's rounding) and session folders."""
    sdr, gt = _gt_pair(cpu_cli)
    monkeypatch.chdir(cpu_cli)  # the GT sync cache goes to logs/ under the working directory
    got = {}
    for name, main in both_clis.items():
        out = str(cpu_cli / name)
        assert main(["quality", "--video", sdr, "--gt", gt, "--frames", "2", "--out", out]) == 0
        text = capsys.readouterr().out
        assert "GT validated" in text and "+2 frames" in text
        single = _json_out(text)
        assert main(["quality", "--video", sdr, "--gt", gt, "--frames", "2", "--no-validate-gt", "--out", out,
                     "--queue", "FP16,FP32"]) == 0
        queue = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
        got[name] = (single, queue)
    (single, queue), (jsingle, jqueue) = got["port"], got["jax"]
    assert set(single) == set(jsingle) and single["gt_decode"] == jsingle["gt_decode"] == "y4m-native-exact-10bit"
    assert single["post_verify"] == jsingle["post_verify"]
    tol = {"mean_psnr": 2e-4, "mean_ssim": 1.1e-5, "mean_delta_e_itp": 2e-4}
    for a, b in [(single, jsingle)] + list(zip(queue, jqueue)):
        assert all(abs(a[k] - b[k]) <= t * (max(1.0, abs(b[k])) if "delta" in k else 1.0) for k, t in tol.items())
        assert os.path.basename(a["session_dir"]).split("__", 1)[1] == \
            os.path.basename(b["session_dir"]).split("__", 1)[1]
    assert [q["precision"] for q in queue] == [q["precision"] for q in jqueue] == ["FP16", "FP32"]


def test_compare_matches_jax(both_clis, cpu_cli, capsys):
    """compare --frame 3 against the y4m ground truth: the same metrics and
    the same sheet files."""
    sdr, gt = _gt_pair(cpu_cli, lead=0, n=6)
    got = {}
    for name, main in both_clis.items():
        out = cpu_cli / name
        assert main(["compare", "--video", sdr, "--gt", gt, "--frame", "3", "--out", str(out)]) == 0
        got[name] = (_json_out(capsys.readouterr().out), sorted(os.listdir(out)))
    (body, files), (jbody, jfiles) = got["port"], got["jax"]
    assert files == jfiles and os.path.basename(body["sheet"]) == "compare_000003.png"
    for k, v in jbody["metrics"].items():
        tol = max(1e-4 * abs(v), 1e-3) if k.startswith("delta") else (1e-6 if k == "ssim" else 1e-4)
        assert abs(body["metrics"][k] - v) <= tol, k


def test_sessions_and_preview_match_jax(cpu_cli, capsys):
    """sessions (JSON and text) over a quality and a playback session, and
    preview's contact sheet: the JAX CLI's output, byte for byte."""
    from hdrtv_tpu import cli as jax_cli

    q = cpu_cli / "logs" / "benchmark_sessions" / "clip" / "x__FP16__540p__n2"
    q.mkdir(parents=True)
    (q / "summary.json").write_text(json.dumps({"source": "clip", "precision": "FP16", "resolution": "540p",
                                                "frames": [1, 2], "mean_psnr": 41.2, "mean_ssim": 0.99,
                                                "mean_delta_e_itp": 1.5, "gt_decode": "cv2-8bit"}))
    p = cpu_cli / "logs" / "playback_sessions" / "cli"
    p.mkdir(parents=True)
    (p / "session.json").write_text(json.dumps({"config": {"precision_key": "FP16", "resolution_key": "1080p"},
                                                "fps": 234.0, "fps_1pct_low": 79.4, "model_ms": 4.39,
                                                "frames": 1136, "dropped": 0}))
    clip = str(cpu_cli / "clip.avi")
    _clip(clip, n=10)
    for argv in (["sessions", "--roots", str(cpu_cli / "logs"), "--json"], ["sessions", "--roots",
                                                                           str(cpu_cli / "logs")],
                 ["sessions", "--roots", str(cpu_cli / "none")]):
        rc = cli.main(argv)
        text = capsys.readouterr().out
        assert rc == jax_cli.main(argv) and text == capsys.readouterr().out
    outs = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        out = str(cpu_cli / f"{name}.png")
        assert main(["preview", "--video", clip, "--frames", "6", "--columns", "3", "--thumb-width", "64",
                     "--out", out]) == 0
        outs[name] = (json.loads(capsys.readouterr().out)["grid"], open(out, "rb").read())
    assert outs["port"] == outs["jax"] and outs["port"][0] == [2, 3]


def test_figures_matches_jax(cpu_cli, capsys):
    """figures over a session's frame folder: the same manifest and files,
    the PNGs within one 8-bit code (the tone map's fp32 pow within 1e-3)."""
    import cv2

    from hdrtv_tpu import cli as jax_cli
    from hdrtv_tpu.bench import hdr_io

    d = cpu_cli / "sess" / "frames" / "000003"
    d.mkdir(parents=True)
    rng = np.random.RandomState(5)
    cv2.imwrite(str(d / "sdr.png"), rng.randint(0, 255, (36, 64, 3), np.uint8))
    for k in ("hdr_gt.tiff", "hdr_convert.tiff"):
        hdr_io.write_tiff16(str(d / k), rng.randint(0, 65535, (36, 64, 3)).astype(np.uint16))
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        assert main(["figures", "--input", str(cpu_cli / "sess"), "--out", str(cpu_cli / name),
                     "--render-size", "128x72"]) == 0
        assert json.loads(capsys.readouterr().out.splitlines()[-1])["frames"] == 1
    assert cli.main(["figures", "--input", str(cpu_cli / "sess"), "--out", str(cpu_cli / "x"),
                     "--render-size", "x"]) == 2
    for f in ("sdr.png", "hdr_convert.png", "hdr_gt.png", "contact_sheet.png"):
        a = cv2.imread(str(cpu_cli / "port" / "frames__000003" / f), cv2.IMREAD_UNCHANGED).astype(np.int64)
        b = cv2.imread(str(cpu_cli / "jax" / "frames__000003" / f), cv2.IMREAD_UNCHANGED).astype(np.int64)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, f
    with open(cpu_cli / "port" / "manifest.json") as f1, open(cpu_cli / "jax" / "manifest.json") as f2:
        m1, m2 = json.load(f1), json.load(f2)
    assert {k: v for k, v in m1.items() if k != "frames"} == {k: v for k, v in m2.items() if k != "frames"}


def test_validate_matches_jax(cpu_cli, capsys, monkeypatch):
    """validate --model (the W8A8 fixture) --teacher (the shipped fp32
    weights) --expect-w8a8 127 --temporal, the validation frames cut to
    24 × 32 in both packages: the same report within a flipped code's worth
    (eager W8A8 in two implementations); a broken contract raises."""
    from hdrtv_tpu import cli as jax_cli
    from hdrtv_tpu.bench import validate as jv
    from hdrtv_tpu_torch.bench import validate as tv

    for mod in (jv, tv):
        cut = mod._frames_for_validation
        monkeypatch.setattr(mod, "_frames_for_validation", lambda f, n, size, _c=cut: _c(f, n, (24, 32)))
    w8a8 = os.path.join(ROOT, "tests", "fixtures", "hr_w8a8.npz")
    argv = ["validate", "--model", w8a8, "--teacher", WEIGHTS, "--frames", "1", "--expect-w8a8", "127"]
    got = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        assert main(argv) == 0
        got[name] = _json_out(capsys.readouterr().out)
    a, b = got["port"], got["jax"]
    assert set(a) == set(b) and a["layer_mix"] == b["layer_mix"] == {"w8a8": 127, "fp": 1}
    assert abs(a["psnr"] - b["psnr"]) <= 0.05 and abs(a["mae"] - b["mae"]) <= 2e-4
    with pytest.raises(AssertionError, match="layer contract violated"):
        cli.main(argv[:-1] + ["29"])


def test_doctor_without_a_card(cpu_cli, capsys):
    """doctor: no card, so exit 3 with the issue named; --no-device gives
    the JAX check's keys of the tool belt and the weights."""
    from hdrtv_tpu import cli as jax_cli

    assert cli.main(["doctor"]) == 3
    rep = json.loads(capsys.readouterr().out)
    assert not rep["ok"] and any("no CUDA device" in i for i in rep["issues"])
    assert cli.main(["doctor", "--no-device"]) == 3
    rep = json.loads(capsys.readouterr().out)
    jax_cli.main(["doctor", "--no-device"])
    jrep = json.loads(capsys.readouterr().out)
    assert rep["details"]["device_probe"] == "skipped" and "platform" not in rep["details"]
    assert {k: rep["details"][k] for k in ("ffmpeg", "ffprobe", "mpv", "octave", "weights")} == \
        {k: jrep["details"][k] for k in ("ffmpeg", "ffprobe", "mpv", "octave", "weights")}


@pytest.mark.parametrize("cmd", ["bench", "quality", "compare", "validate", "figures"])
def test_bench_commands_need_a_card_without_the_switch(cmd, monkeypatch, tmp_path):
    """Without a CUDA device and without HDRTV_CLI_PLATFORM=cpu the bench
    commands raise: the processor, the metrics, the validation models and
    the figures' tone map do not fall back to the CPU."""
    import cv2

    from hdrtv_tpu_torch.bench import hdr_io

    monkeypatch.delenv("HDRTV_CLI_PLATFORM", raising=False)
    monkeypatch.setenv("HDRTVNET_PREFS_PATH", str(tmp_path / "prefs.json"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clip = str(tmp_path / "clip.avi")
    _clip(clip)
    d = tmp_path / "sess" / "f"
    d.mkdir(parents=True)
    cv2.imwrite(str(d / "sdr.png"), np.zeros((8, 8, 3), np.uint8))
    for k in ("hdr_gt.tiff", "hdr_convert.tiff"):
        hdr_io.write_tiff16(str(d / k), np.zeros((8, 8, 3), np.uint16))
    argv = {
        "bench": ["bench", "--duration", "0.1"],
        "quality": ["quality", "--video", clip, "--gt", clip, "--no-validate-gt"],
        "compare": ["compare", "--video", clip],
        "validate": ["validate", "--model", WEIGHTS, "--teacher", WEIGHTS],
        "figures": ["figures", "--input", str(tmp_path / "sess"), "--out", str(tmp_path / "o")],
    }[cmd]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_convert_log_session_writes_the_jax_layout(cpu_cli, capsys):
    """convert --log-session: the playback session files of
    bench/playback.py write_session, with the JAX CLI's config keys."""
    from hdrtv_tpu.bench.playback import PlaybackResult

    logs = cpu_cli / "logs"
    assert cli.main(["convert", "--display", "null", "--frames", "2", "--no-realtime", "--log-session",
                     str(logs)]) == 0
    assert "session logged to" in capsys.readouterr().out
    (sess,) = os.listdir(logs)
    assert sess.endswith("_synthetic") and sorted(os.listdir(logs / sess)) == [
        "runtime_metrics.csv", "session.json", "summary.txt"]
    with open(logs / sess / "session.json") as f:
        body = json.load(f)
    assert set(body) == {f.name for f in dataclasses.fields(PlaybackResult)}
    assert body["frames"] == 2 and set(body["config"]) == {"video", "precision", "resolution"}


QUANT_LAYERS = ["LE.conv_first", "LE.HR_conv1", "LE.recon_trunk3.0.conv1", "AGCM.cond_scale_first"]


def _layout_file(path):
    path.write_text("# four layers\n" + "\n".join(QUANT_LAYERS) + "\n")
    return str(path)


@pytest.mark.parametrize("method,layout", [("max", False), ("percentile", True), ("kl", True)])
def test_quantize_matches_jax(cpu_cli, capsys, method, layout):
    """quantize on the same clip's frames through both CLIs: the same keys,
    int8 codes and weight scales equal, activation scales and zero points
    within a relative 1e-4 (tests/test_torch_quant.py's percentile bound;
    kl: within one histogram bin, 1/2048 of the range)."""
    from hdrtv_tpu import cli as jax_cli
    from hdrtv_tpu_torch.models.import_npz import load_npz

    clip = str(cpu_cli / "clip.avi")
    _clip(clip)
    extra = ["--layout", _layout_file(cpu_cli / "layout.txt"), "--asymmetric"] if layout else []
    if method == "kl":
        extra = extra[:2]  # kl calibrates symmetric layers
    outs = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        out = str(cpu_cli / f"{name}.npz")
        assert main(["quantize", "--model", WEIGHTS, "--out", out, "--calib-video", clip, "--calib-frames", "2",
                     "--calib-method", method, *extra]) == 0
        assert f"wrote {out}; layer mix:" in capsys.readouterr().out
        outs[name] = load_npz(out)
    got, want = outs["port"], outs["jax"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k.endswith((".x_scale", ".x_zero")):
            rtol = 1.0 / 2048 if method == "kl" else 1e-4
            assert abs(float(got[k]) - float(v)) <= rtol * max(abs(float(v)), 1e-6), k
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    n_int8 = sum(k.endswith(".weight_int8") for k in got)
    assert n_int8 == (len(QUANT_LAYERS) if layout else 127)
    assert sum(k.endswith(".x_zero") for k in got) == (n_int8 if "--asymmetric" in extra else 0)


def test_layout_writes_the_probe_ranking(cpu_cli, capsys):
    """layout on one frame of a clip: the file lists --count layers, all
    quantizable, as generate_mixed_layout ranks them on the same frame."""
    from hdrtv_tpu_torch.models.hdrtvnet import ModelConfig
    from hdrtv_tpu_torch.models.import_npz import load_npz
    from hdrtv_tpu_torch.quant.int8 import load_mixed_layout, quantizable_layers
    from hdrtv_tpu_torch.quant.mixed import generate_mixed_layout

    clip = str(cpu_cli / "clip.avi")
    _clip(clip)
    out = cpu_cli / "layout.txt"
    assert cli.main(["layout", "--model", WEIGHTS, "--out", str(out), "--count", "6", "--probe-video", clip,
                     "--probe-frames", "1"]) == 0
    assert capsys.readouterr().out.strip() == f"wrote {out}: 6 W8A8 layers"
    layers = load_mixed_layout(str(out))
    assert len(layers) == 6 and set(layers) <= set(quantizable_layers(load_npz(WEIGHTS)))
    frames = cli._video_frames(clip, 1)
    assert generate_mixed_layout(load_npz(WEIGHTS), frames, ModelConfig(), count=6, device="cpu") == layers
    assert out.read_text().startswith("# Mixed W8A8 layout generated by per-layer sensitivity probe")


@pytest.mark.parametrize("symmetric", [False, True], ids=["asymmetric", "symmetric"])
def test_qat_writes_a_checkpoint_the_processor_runs(cpu_cli, capsys, symmetric):
    """qat, two steps on 32 × 64 crops: the JSON the JAX CLI prints, every
    default layer in W8A8 (asymmetric unless --symmetric), finite losses;
    the checkpoint runs on the port's processor."""
    from hdrtv_tpu_torch.models.import_npz import load_npz
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    out = str(cpu_cli / "qat.npz")
    assert cli.main(["qat", "--model", WEIGHTS, "--out", out, "--steps", "2", "--num-frames", "1", "--crop", "32",
                     *(["--symmetric"] if symmetric else [])]) == 0
    text = capsys.readouterr().out
    rep = json.loads(text[text.index("{"):])
    kind = "w8a8" if symmetric else "w8a8-asym"
    assert rep["out"] == out and rep["layers_quantized"] == 127 and rep["layer_mix"] == {kind: 127, "fp": 1}
    assert np.isfinite(rep["loss_first"]) and np.isfinite(rep["loss_last"]) and rep["loss_first"] > 0
    assert ("qat step 0: loss" in text) and ("qat step 1: loss" in text)
    assert sum(k.endswith(".x_zero") for k in load_npz(out)) == (0 if symmetric else 127)
    proc = HDRTVNetTorch(out, precision="fp16", device="cpu", persistent_cache=False)
    frame = (np.random.RandomState(0).rand(H, W, 3) * 255).astype(np.uint8)
    y = proc.process_rgb48(frame)
    assert proc.native_int8 and y.shape == (H, W, 3) and y.dtype == np.uint16 and y.max() > y.min()


def test_sweep_rows(cpu_cli, capsys):
    """sweep --frames 1 with a preset checkpoint, then the default ladder:
    the rows the JAX CLI prints, at the sweep's own 192 × 256."""
    fixture = os.path.join(ROOT, "tests", "fixtures", "hr_w8a8.npz")
    assert cli.main(["sweep", "--model", WEIGHTS, "--frames", "1", "--preset-checkpoints",
                     f"int8-ptq={fixture}"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [r["preset"] for r in rows] == ["int8-ptq"] and rows[0]["layer_mix"] == {"w8a8": 127, "fp": 1}
    assert 20 < rows[0]["psnr"] < 60 and 0 < rows[0]["ssim"] < 1 and rows[0]["delta_e_itp"] > 0
    assert cli.main(["sweep", "--model", WEIGHTS, "--frames", "1"]) == 0
    ladder = json.loads(capsys.readouterr().out)
    assert [r["preset"] for r in ladder] == ["bf16", "int8-full (PTQ)"]
    assert ladder[1]["layer_mix"] == {"w8a8-asym": 127, "fp": 1} and ladder[0]["psnr"] > ladder[1]["psnr"]


def test_mine_hard_frames_matches_jax(cpu_cli, capsys):
    import cv2

    from hdrtv_tpu import cli as jax_cli

    sdr, hdr = cpu_cli / "sdr", cpu_cli / "hdr"
    sdr.mkdir()
    hdr.mkdir()
    rng = np.random.RandomState(2)
    for i in range(4):
        cv2.imwrite(str(sdr / f"{i}.png"), (rng.rand(40, 60, 3) * 200 + 20 * i).astype(np.uint8))
        cv2.imwrite(str(hdr / f"{i}.png"), (rng.rand(40, 60, 3) * 40000 + 6000 * i).astype(np.uint16))
    got = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        assert main(["mine-hard-frames", "--sdr-dir", str(sdr), "--hdr-dir", str(hdr), "--out",
                     str(cpu_cli / name), "--top", "2"]) == 0
        got[name] = json.loads(capsys.readouterr().out)
        with open(cpu_cli / name / "manifest.json") as f:
            got[name]["replay"] = json.load(f)["replay"]
    assert got["port"].pop("csv") != got["jax"].pop("csv")
    assert got["port"] == got["jax"] and got["port"]["hard_count"] == 2 and got["port"]["total_pairs"] == 4


def test_teacher_pairs_are_the_processors_frames(cpu_cli, capsys):
    """teacher-pairs --precision FP32 on a clip: each teacher PNG is the
    port's process_rgb48 of its SDR frame, bit for bit."""
    import cv2

    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    clip = str(cpu_cli / "clip.avi")
    _clip(clip)
    out = cpu_cli / "pairs"
    assert cli.main(["teacher-pairs", "--video", clip, "--out", str(out), "--frames", "0,2", "--precision",
                     "FP32", "--resolution", "540p"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep == {"video": clip, "count": 2}
    proc = HDRTVNetTorch(WEIGHTS, precision="fp32", device="cpu", persistent_cache=False, proc_resolution=(W, H))
    for idx in (0, 2):
        sdr = cv2.imread(str(out / f"clip_{idx:06d}_sdr.png"), cv2.IMREAD_UNCHANGED)
        teacher = cv2.imread(str(out / f"clip_{idx:06d}_teacher.png"), cv2.IMREAD_UNCHANGED)
        assert sdr.shape == (H, W, 3) and teacher.dtype == np.uint16
        assert np.array_equal(teacher[..., ::-1], proc.process_rgb48(sdr))


@pytest.mark.parametrize("cmd", ["quantize", "layout", "qat", "sweep", "teacher-pairs"])
def test_quant_commands_need_a_card_without_the_switch(cmd, monkeypatch, tmp_path):
    """Without a CUDA device and without HDRTV_CLI_PLATFORM=cpu the
    quantization, training, probe, sweep and teacher commands raise: none
    of them falls back to the CPU."""
    monkeypatch.delenv("HDRTV_CLI_PLATFORM", raising=False)
    monkeypatch.setenv("HDRTVNET_PREFS_PATH", str(tmp_path / "prefs.json"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clip = str(tmp_path / "clip.avi")
    _clip(clip)
    out = str(tmp_path / "o")
    argv = {
        "quantize": ["quantize", "--model", WEIGHTS, "--out", out, "--calib-frames", "1"],
        "layout": ["layout", "--model", WEIGHTS, "--out", out, "--probe-frames", "1"],
        "qat": ["qat", "--model", WEIGHTS, "--out", out, "--num-frames", "1", "--crop", "16"],
        "sweep": ["sweep", "--model", WEIGHTS, "--frames", "1"],
        "teacher-pairs": ["teacher-pairs", "--video", clip, "--out", out],
    }[cmd]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    assert not os.path.exists(out)
