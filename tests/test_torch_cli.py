"""The port's CLI on the CPU (``HDRTV_CLI_PLATFORM=cpu``): the parser takes
the JAX CLI's command lines (``tests/test_cli.py``), ``convert`` runs a
synthetic source to the null and file sinks and ``export`` a clip written
with cv2, against the port's own per-frame program (bit for bit) and the
JAX package's (CODES u16 codes in fp32: the 5e-5 golden tolerance × 65535,
rounded up, as ``tests/test_torch_slice.py``); ``presets``, ``assets`` and
``engines`` run; every subcommand and option that is not ported raises
``NotImplementedError`` naming its ROADMAP.md item; without a card and
without the CPU switch nothing runs. The config, prefs and assets copies
agree with the JAX package's.

The presets' resolutions are cut to 64 × 96 for the runs (``RESOLUTION_SCALES``
patched): the CLI processes at the preset's size.
"""

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


@pytest.mark.parametrize("name", sorted(cli.NOT_PORTED))
def test_unported_subcommands_raise(name, cpu_cli):
    argv = next((a for a in ARGVS if a[0] == name), None) or {
        "quality": ["quality", "--video", "v", "--gt", "g"], "sweep": ["sweep", "--model", "m"],
        "layout": ["layout", "--model", "m", "--out", "o"], "qat": ["qat", "--model", "m", "--out", "o"],
        "validate": ["validate", "--model", "m", "--teacher", "t"], "compare": ["compare", "--video", "v"],
        "preview": ["preview", "--video", "v"], "figures": ["figures", "--input", "i"],
        "mine-hard-frames": ["mine-hard-frames", "--sdr-dir", "a", "--hdr-dir", "b", "--out", "o"],
        "teacher-pairs": ["teacher-pairs", "--video", "v", "--out", "o"],
        "split-sources": ["split-sources", "--model", "m", "--out-hr", "a", "--out-hg", "b"],
    }.get(name, [name])
    item = cli.NOT_PORTED[name][1]
    with pytest.raises(NotImplementedError, match=item.replace("(", r"\(").replace(")", r"\)")):
        cli.main(argv)


@pytest.mark.parametrize("argv,item", [
    (["convert", "--audio", "--frames", "1"], "Queue 1 item 11"),
    (["convert", "--interactive", "--frames", "1"], "Queue 1 item 11"),
    (["convert", "--log-session", "logs", "--frames", "1"], "Queue 1 item 11"),
    (["convert", "--mesh", "spatial", "--display", "null", "--frames", "1"], "Queue 1 item 13"),
    (["export", "--video", "v.mp4", "--hosts", "4", "--host-id", "2"], "Queue 1 item 13"),
    (["export", "--video", "v.mp4", "--mesh", "--batch", "2", "--resolution", "540p"], "Queue 1 item 13"),
], ids=["audio", "interactive", "log-session", "mesh-spatial", "hosts", "export-mesh"])
def test_unported_options_raise(argv, item, cpu_cli):
    with pytest.raises(NotImplementedError, match=item):
        cli.main(argv)


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
