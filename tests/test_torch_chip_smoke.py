"""chip_smoke.py's refusals, on the CPU: without a CUDA device, and copied
alone into a directory that holds nothing else of the repository, it exits
non-zero and prints no result line."""

import os
import shutil
import subprocess
import sys

import pytest

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")

# Runs the script as __main__ with torch.cuda.is_available() forced true: the
# card check passes and the script goes on to look for the port beside it.
_AS_IF_CUDA = (
    "import runpy, sys, torch; torch.cuda.is_available = lambda: True; "
    "sys.argv = ['chip_smoke.py']; runpy.run_path('chip_smoke.py', run_name='__main__')"
)


@pytest.mark.parametrize("case,rc,says", [("no_cuda", 2, "no CUDA device"),
                                          ("alone", 3, "not next to this script")])
def test_chip_smoke_refuses(tmp_path, case, rc, says):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if case == "no_cuda":
        cmd, cwd = [sys.executable, os.path.abspath(SCRIPT)], os.path.dirname(os.path.abspath(SCRIPT))
        env["CUDA_VISIBLE_DEVICES"] = ""
    else:
        shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
        cmd, cwd = [sys.executable, "-c", _AS_IF_CUDA], str(tmp_path)
    res = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == rc, (res.returncode, res.stderr[-2000:])
    assert says in res.stderr
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout


def test_stream_overlap_reads_a_trace(tmp_path):
    """Phase 9's reading of a torch.profiler Chrome trace: the busy share is
    the union of the card's intervals over their span; the replays' stream
    is the one with the most kernel time; a copy's overlap is the share of
    its time under a kernel of another stream."""
    import importlib.util
    import json

    spec = importlib.util.spec_from_file_location("chip_smoke_tables", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def ev(cat, name, ts, dur, stream):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {"stream": stream}}

    trace = {"traceEvents": [
        ev("kernel", "k0", 0, 40, 7), ev("kernel", "k1", 50, 40, 7), ev("kernel", "side", 95, 1, 20),
        ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 30, 20, 13),   # 10 of 20 under k0
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 85, 10, 14),   # 5 of 10 under k1
        ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 100, 10, 7),
        ev("cpu_op", "aten::copy_", 0, 500, 1),
    ]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    got = mod.stream_overlap(str(path))
    assert got["replay_stream"] == 7 and got["busy"] == round(106 / 110, 4) and got["kernel_ms"] == 0.081
    assert got["HtoD"] == {"n": 1, "ms": 0.02, "streams": ["13"], "overlapped": 0.5, "off_replay_stream": True}
    assert got["DtoH"]["overlapped"] == 0.5 and got["DtoH"]["off_replay_stream"]


def test_bench_line_shape():
    """Phase 11's {"bench": ...} line: one JSON object under "bench" with
    every key of BENCH_KEYS in order (the figures of a card run, in the
    shape phase_bench builds them); a missing or an extra key fails."""
    import importlib.util
    import json

    spec = importlib.util.spec_from_file_location("chip_smoke_bench", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    row = {"psnr": 1e-5, "psnr_gn": 1e-5, "ssim": 1e-7, "delta_e_itp": 1e-4, "delta_e_itp_gn": 1e-4}
    quality = {name: {"preset": spec[0], "mean_psnr": 76.8, "mean_ssim": 0.99998, "mean_delta_e_itp": 0.04,
                      "psnr": [76.7] * mod.BENCH_FRAMES, "ms_per_frame": 2147.5, "card_vs_cpu_max": row,
                      "artifacts_equal": True} for name, spec in mod.QUALITY_PRESETS.items()}
    figures = {
        "card": "NVIDIA H100 80GB HBM3, 700.00 W", "cv2": True, "ffmpeg": False, "quality": quality,
        "planted": {"bound": mod.QUALITY_FP32_PSNR, "psnr": [22.0] * mod.BENCH_FRAMES,
                    "gt_frame": list(range(mod.BENCH_FRAMES))},
        "compare": {"frame": 4, "metrics": row, "row_apart": row},
        "playback": {"frames": 1136, "dropped": 0, "fps": 234.04, "fps_1pct_low": 79.37, "model_ms": 4.39,
                     "ring_ms": 14.22, "wall_s": 5.01, "files": ["runtime_metrics.csv", "session.json",
                                                                 "summary.txt"]},
        "device_resident": {"device_fps": 238.86, "device_model_ms": 4.187, "frames": mod.RESIDENT_FRAMES},
        "cli": {"doctor_rc": 0, "bench_supervised_rc": 0, "quality": "ran"},
        "wrapper": {"budget_s": 2.0, "killed_after_s": 2.01, "rc": -9, "canceled": True},
        "phase_s": 148.3,
    }
    line = mod.bench_line(dict(reversed(list(figures.items()))))
    body = json.loads(line)
    assert list(body) == ["bench"] and tuple(body["bench"]) == mod.BENCH_KEYS
    assert set(body["bench"]["quality"]) == {"quality_fp32", "quality_bf16", "quality_int8"}
    assert mod.QUALITY_FP32_PSNR == round(20 * __import__("math").log10(1 / (0.5 / 876 + 1.8814 * 0.5 / 896)), 1)
    for broken in ({k: v for k, v in figures.items() if k != "planted"}, {**figures, "extra": 1}):
        with pytest.raises(AssertionError, match="bench line"):
            mod.bench_line(broken)


def _load():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_quant", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase_quant_is_wired_into_main():
    """Phase 12 runs after phase 11 inside main's fp32_math block, its
    launch counts join the kernels line's, and its line comes before the
    card's line."""
    import inspect

    mod = _load()
    src = inspect.getsource(mod.main)
    assert callable(mod.phase_quant) and callable(mod.quant_int8_frame)
    bench, quant = src.index("phase_bench(torch, np, native, smi, tmp)"), src.index("phase_quant(torch, np,")
    assert src.index("with fp32_math():") < bench < quant < src.index("finally:")
    assert "counts.update(quant_counts)" in src
    assert src.index("log(quant_line(quant))") < src.index("log(smi)") < src.index('print(json.dumps({"ok": True')
    assert "12. quantization" in mod.__doc__


def test_quant_line_shape():
    """Phase 12's {"quant": ...} line: every key of QUANT_KEYS in order; a
    missing or an extra key fails."""
    import json

    mod = _load()
    figures = {k: {"x": 1} for k in mod.QUANT_KEYS}
    figures["phase_s"] = 99.5
    body = json.loads(mod.quant_line(dict(reversed(list(figures.items())))))
    assert list(body) == ["quant"] and tuple(body["quant"]) == mod.QUANT_KEYS
    for broken in ({k: v for k, v in figures.items() if k != "qat"}, {**figures, "extra": 1}):
        with pytest.raises(AssertionError, match="quant line"):
            mod.quant_line(broken)


def test_unit_u8_round_trip():
    """The frames phase 12 writes as PNGs and reads back through the CLI's
    video source: u8 BGR, and the [0, 1] RGB a source gives."""
    import numpy as np

    mod = _load()
    f = np.random.RandomState(0).rand(6, 8, 3).astype(np.float32)
    u8, back = mod.unit_u8(np, f)
    assert u8.dtype == np.uint8 and np.array_equal(u8[..., ::-1], np.round(f * 255).astype(np.uint8))
    assert np.abs(back - f).max() <= 0.5 / 255 + 1e-7


def test_kl_bin_reads_calibrate_kl_scale():
    """Phase 12 (b) reads each symmetric layer's KL threshold bin back from
    calibrate's kl scale and the max method's scale on the same frames: the
    bin calibrate chose, for bins across the range; a scale off the bins'
    grid raises."""
    import numpy as np

    from hdrtv_tpu_torch.quant.calibrate import KL_BINS

    mod = _load()
    for abs_max in (3.7e-4, 0.61, 17.3, 240.0):
        max_scale = np.float32(max(abs_max, 1e-8) / 127.0)
        for i in (0, 1, 127, 1000, KL_BINS - 1):
            kl_scale = np.float32(max((i + 0.5) * (max(abs_max, 1e-8) / KL_BINS), 1e-8) / 127.0)
            assert mod.kl_bin(kl_scale, max_scale) == i
    with pytest.raises(AssertionError, match="no bin"):
        mod.kl_bin(np.float32(0.25 * 0.61 / KL_BINS / 127.0), np.float32(0.61 / 127.0))


def test_phase_live_is_wired_into_main():
    """Phase 13 runs after phase 12 inside main's fp32_math block, its
    launch counts join the kernels line's, and its line comes before the
    card's line."""
    import inspect

    mod = _load()
    src = inspect.getsource(mod.main)
    quant, live = src.index("phase_quant(torch, np,"), src.index("phase_live(torch, np, native, smi, tmp)")
    assert src.index("with fp32_math():") < quant < live < src.index("finally:")
    assert "counts.update(live_counts)" in src
    assert src.index("log(quant_line(quant))") < src.index("log(live_line(live))") < src.index("log(smi)")
    assert "13. live capture" in mod.__doc__
    assert set(mod.LIVE_CAPTURES) == {"live_bf16", "live_letterbox"} and mod.LIVE_PHASE_S <= 60


def test_live_line_shape():
    """Phase 13's {"live": ...} line: every key of LIVE_KEYS in order; a
    missing or an extra key fails."""
    import json

    mod = _load()
    figures = {k: {"x": 1} for k in mod.LIVE_KEYS}
    figures["phase_s"] = 41.5
    body = json.loads(mod.live_line(dict(reversed(list(figures.items())))))
    assert list(body) == ["live"] and tuple(body["live"]) == mod.LIVE_KEYS
    for broken in ({k: v for k, v in figures.items() if k != "shell"}, {**figures, "extra": 1}):
        with pytest.raises(AssertionError, match="live line"):
            mod.live_line(broken)


def test_served_frames_map_to_their_observations():
    """Phase 13's mapping: the port's LiveSource over the synthetic grabber,
    each frame it serves traced to the observation it was (its bar's place
    tells the grab apart), the observations never going back; a kept frame
    is looked up by its pts; an unknown observation or one going back fails."""
    import time

    import numpy as np

    from hdrtv_tpu_torch.pipeline.live import LiveSource, synthetic_grabber

    mod = _load()
    grab = mod.ObservedGrabber(synthetic_grabber(96, 64), keep=16)
    src = mod.served_observations(LiveSource)(grab, process_fps=100.0, observe_fps=200.0)
    kept = []
    try:
        for i in range(40):
            frame, idx, pts = src.read_with_meta()
            assert idx == i and pts == i / 100.0
            if i % 10 == 0:
                kept.append((pts, frame))
            time.sleep(0.003)
    finally:
        src.close()
    obs = mod.check_served(src.served_obs, kept, 100.0)
    assert len(src.served_obs) == 40 and grab.n >= max(src.served_obs) and len(grab.ms) >= grab.n
    ref = synthetic_grabber(96, 64)
    frames = [ref() for _ in range(max(obs))]
    for o, (_, frame) in zip(obs, kept):
        assert np.array_equal(frame, frames[o - 1])
    assert grab.observation(np.zeros(1)) is None
    with pytest.raises(AssertionError, match="unknown observation"):
        mod.check_served([1, None, 3], [], 100.0)
    with pytest.raises(AssertionError, match="went back"):
        mod.check_served([1, 3, 2], [], 100.0)


def test_main_refuses_without_a_card(monkeypatch, capsys):
    """main() in process, torch.cuda.is_available() false: exit 2, nothing
    on stdout, phase 13 never reached."""
    import torch

    mod = _load()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mod, "phase_live", lambda *a: pytest.fail("phase 13 ran without a card"))
    assert mod.main() == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_phase_mesh_is_wired_into_main():
    """Phase 14 runs after phase 13 inside main's fp32_math block, its
    launch counts join the kernels line's (paths mesh_*), and its line comes
    before the card's line."""
    import inspect

    mod = _load()
    src = inspect.getsource(mod.main)
    live, mesh = src.index("phase_live(torch, np, native, smi, tmp)"), src.index("phase_mesh(torch, np, native,")
    assert src.index("with fp32_math():") < live < mesh < src.index("finally:")
    assert "counts.update(mesh_counts)" in src
    assert src.index("log(live_line(live))") < src.index("log(mesh_line(mesh))") < src.index("log(smi)")
    assert "14. the mesh" in mod.__doc__
    assert set(mod.MESH_PROGRAMS) | {"mesh_bf16_4k"} == set(mod.MESH_LSB) and mod.MESH_NS == (2, 4)
    assert set(mod.MESH_PROGRAMS.values()) <= set(mod.PATHS) and mod.MESH_4K == (2160, 3840)


def test_mesh_line_shape():
    """Phase 14's {"mesh": ...} line: every key of MESH_KEYS in order; a
    missing or an extra key fails."""
    import json

    mod = _load()
    figures = {k: {"x": 1} for k in mod.MESH_KEYS}
    body = json.loads(mod.mesh_line(dict(reversed(list(figures.items())))))
    assert list(body) == ["mesh"] and tuple(body["mesh"]) == mod.MESH_KEYS
    for broken in ({k: v for k, v in figures.items() if k != "farm"}, {**figures, "extra": 1}):
        with pytest.raises(AssertionError, match="mesh line"):
            mod.mesh_line(broken)


def test_mesh_call_checks_record_and_restore():
    """MeshCallChecks on a CPU frame of the int8 checkpoint over 2 shards:
    each kernel call of each shard is recorded with its window's shape (an
    int8 form apart from the float one) and an error of 0 (on the CPU the
    kernel is its plain version), and every patched name is restored."""
    import numpy as np
    import torch

    from hdrtv_tpu_torch.models import s2d
    from hdrtv_tpu_torch.ops import megakernel, native
    from hdrtv_tpu_torch.parallel.mesh import spatial_mesh
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch

    mod = _load()
    before = (native.on_cpu, s2d.fused_tail, megakernel.check_qargs)
    weights = os.path.join(os.path.dirname(SCRIPT), "tests", "fixtures", "hr_w8a8.npz")
    proc = HDRTVNetTorch(weights, device="cpu", persistent_cache=False,
                         mesh=spatial_mesh(2, devices=[torch.device("cpu")] * 2))
    frame = (np.random.RandomState(0).rand(32, 128, 3) * 255).astype(np.uint8)
    with mod.MeshCallChecks(torch, native) as checks:
        proc._rgb48_eager(proc.put_frame(frame.reshape(32, 384)))
    summary = checks.summary()
    assert (native.on_cpu, s2d.fused_tail, megakernel.check_qargs) == before
    tail = summary["fused_tail_w8a8"]  # the int8 body, apart from the float form
    assert tail["calls"] == 2 and tail["unit"] == "u16_bf16" and tail["bound"] == mod.MESH_CALL_BOUND["u16_bf16"][
        "fused_tail_w8a8"]
    assert summary["fused_agcm_head"]["shapes"] == [[16, 2, 40, 6]]  # 32 s2d columns + a radius of 4 each side
    assert all(s["err"] == 0.0 and s["err"] <= s["bound"] for s in summary.values())
