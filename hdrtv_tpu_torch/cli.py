"""Command-line interface of the port (counterpart of ``hdrtv_tpu/cli.py``).

    python -m hdrtv_tpu_torch.cli convert --display null --frames 3
    python -m hdrtv_tpu_torch.cli export --video clip.mp4 --codec raw

The parser accepts every command line the JAX package's does. These
subcommands run: ``convert`` (play/convert a video or a synthetic source to
a sink, ``pipeline/runner.py``), ``export`` (HDR10 export,
``pipeline/export.py``), ``presets``, ``assets``, ``engines`` and
``build-engines``. The others, and the options of ``convert`` whose modules
are not ported yet, raise ``NotImplementedError`` naming the ROADMAP.md Queue
1 item that owns those modules.

The processor runs on the CUDA card; ``HDRTV_CLI_PLATFORM=cpu`` (the JAX
CLI's switch) runs it on the CPU, the kernels' plain versions. Without a card
and without that switch the commands raise: nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# What the subcommands and options that do not run yet wait for: the
# ROADMAP.md Queue 1 item that owns their modules.
ITEM_1 = "Slice 8 (host, runtime and tooling modules: Queue 1 item 1)"
ITEM_11 = "Queue 1 item 11"
ITEM_12 = "Queue 1 item 12"
ITEM_13 = "Slice 8 (parallel: Queue 1 item 13)"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to hdrtv_tpu_torch yet: ROADMAP.md {item}")


def _cli_device() -> str | None:
    """The processor's device: ``HDRTV_CLI_PLATFORM=cpu`` asks for the CPU,
    unset (or ``cuda`` / ``gpu``) for the card, which then must exist."""
    plat = os.environ.get("HDRTV_CLI_PLATFORM", "").strip().lower()
    if plat == "cpu":
        return "cpu"
    if plat in ("", "cuda", "gpu"):
        return None
    raise ValueError(f"HDRTV_CLI_PLATFORM={plat!r}: the port runs on cuda (the default) or cpu")


def _add_model_args(p: argparse.ArgumentParser, *, prefs_defaults: bool = False) -> None:
    # prefs_defaults=True (convert): unset flags restore the last-used
    # settings from prefs.json — the reference's .gui_prefs.json startup
    # restore (gui_settings_preview.py); explicit flags always win.
    p.add_argument("--model", default=None, help="checkpoint path (.pt or .npz); default: preset table")
    p.add_argument("--precision", default=None if prefs_defaults else "FP16",
                   help="precision preset key (config.PRECISIONS)")
    p.add_argument("--resolution", default=None if prefs_defaults else "1080p",
                   choices=["540p", "720p", "1080p", "4K"])
    p.add_argument("--use-hg", action="store_true", default=None if prefs_defaults else False,
                   help="enable highlight generation composite")
    p.add_argument("--hg-weights", default=None)


def _apply_prefs(args) -> None:
    """Fill convert's unset model/display flags from prefs.json."""
    from hdrtv_tpu_torch.utils.prefs import load_prefs

    prefs = load_prefs()
    if args.precision is None:
        args.precision = prefs.get("precision") or "FP16"
    if args.resolution is None:
        args.resolution = prefs.get("resolution") or "1080p"
    if args.use_hg is None:
        args.use_hg = bool(prefs.get("use_hg", False))
    if getattr(args, "display", None) is None:
        args.display = prefs.get("display") or "null"
    if getattr(args, "upscale", None) is None:
        args.upscale = prefs.get("upscale") or None
    if getattr(args, "film_grain", None) is None:
        args.film_grain = bool(prefs.get("film_grain", False))


def _make_processor(args):
    from hdrtv_tpu_torch.config import PRECISIONS, processing_dims, resolve_precision_key, select_model_path
    from hdrtv_tpu_torch.runtime.processor import HDRTVNetTorch
    from hdrtv_tpu_torch.utils.assets import require_assets_or_raise

    require_assets_or_raise()  # HDRTVNET_REQUIRE_CLONE_ASSETS fail-fast gate
    # accept the reference CLI's short run names (fp16, int8-mixed-qat, …)
    args.precision = resolve_precision_key(args.precision)

    model_path = args.model
    if model_path is None:
        if args.precision in PRECISIONS and os.path.isfile(select_model_path(args.precision, args.use_hg)):
            model_path = select_model_path(args.precision, args.use_hg)
        else:
            model_path = os.path.join(ROOT, "weights", "hr_fp32.npz")
    precision_token = PRECISIONS[args.precision].precision if args.precision in PRECISIONS else args.precision
    # The resolution preset governs *processing*: frames letterbox on device
    # to these dims (gui_scaling.py:228 applied per frame in the reference
    # worker, gui_pipeline_worker_frame_processing.py:168-331).
    proc_res = processing_dims(args.resolution) if getattr(args, "resolution", None) else None
    if getattr(args, "mesh", None) == "spatial":
        raise _not_ported("--mesh spatial (W-sharding a frame over devices)", ITEM_13)
    return HDRTVNetTorch(
        model_path,
        precision=precision_token,
        device=_cli_device(),
        use_hg=args.use_hg or None,
        hg_path=args.hg_weights,
        proc_resolution=proc_res,
    )


def _playback_lock_path() -> str:
    """The machine-wide lock a supervised benchmark holds (the JAX package's
    ``bench/wrapper.py playback_lock_path``, the same file)."""
    from hdrtv_tpu_torch.utils.env import env_str

    root = env_str("HDRTVNET_CACHE_DIR") or os.path.join(os.path.expanduser("~"), ".cache", "hdrtv_tpu")
    return os.path.join(root, "playback.lock")


def _playback_locked() -> bool:
    """True when a live process holds the playback lock (a stale lock, whose
    pid is gone, does not count)."""
    try:
        with open(_playback_lock_path()) as f:
            pid = int(f.read().strip() or 0)
    except (OSError, ValueError):
        return False
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


class _Bypass:
    """HDR input passed through: u8 PQ codes scaled to u16 on the device,
    without the model (``passthrough_rgb48_device``). Frames ship as (H, W,
    3) through the processor's pinned copy, so the flip is BGR → RGB."""

    def __init__(self, p):
        self._p = p
        self.model_path = getattr(p, "model_path", "")
        self.device = p.device

    def warmup_compile(self, *a, **k):
        return 0.0

    def put_frame(self, flat):
        return self._p._to_device(flat.reshape(flat.shape[0], -1, 3))

    def process_rgb48_device(self, frame):
        return self._p.passthrough_rgb48_device(frame)


def cmd_convert(args) -> int:
    from hdrtv_tpu_torch.config import processing_dims
    from hdrtv_tpu_torch.pipeline.runner import PipelineRunner
    from hdrtv_tpu_torch.pipeline.sinks import make_sink
    from hdrtv_tpu_torch.pipeline.source import SyntheticSource, VideoSource
    from hdrtv_tpu_torch.utils.env import env_bool

    for flag, what in (("audio", "--audio (pipeline/audio.py)"), ("interactive", "--interactive (pipeline/shell.py)"),
                       ("log_session", "--log-session (bench/playback.py)")):
        if getattr(args, flag, None):
            raise _not_ported(what, ITEM_11)
    if not env_bool("HDRTVNET_IGNORE_PLAYBACK_LOCK", False) and _playback_locked():
        # The reference locks playback interactions while a benchmark runs
        # (gui_playback_runtime.py:274-411).
        print("a supervised benchmark holds the playback lock; "
              "HDRTVNET_IGNORE_PLAYBACK_LOCK=1 overrides", file=sys.stderr)
        return 2

    _apply_prefs(args)
    proc = _make_processor(args)
    w, h = processing_dims(args.resolution)
    bypass = False
    if args.video:
        from hdrtv_tpu_torch.runtime.probe import probe_media, should_bypass_processing

        info = probe_media(args.video)
        if should_bypass_processing(info):
            # Reference GUI rejects HDR input for playback (gui_media_probe.py:178);
            # --hdr-input bypass feeds it through untouched instead.
            if args.hdr_input == "reject":
                print("input is already HDR (PQ/BT.2020); refusing to convert "
                      "(use --hdr-input bypass to pass it through)")
                return 2
            bypass = True
        src = VideoSource(args.video, prefetch=max(0, args.prefetch))
    else:
        src = SyntheticSource(w, h, fps=30, frames=args.frames or 300)
    if getattr(args, "start_frame", None):
        src.seek(max(0, int(args.start_frame)))  # gui_app_entry.py --start-frame
    if bypass:
        proc = _Bypass(proc)
    out_size = None
    if getattr(args, "display_size", None):
        try:
            ow, oh = (int(v) for v in str(args.display_size).lower().split("x"))
            out_size = (ow, oh)
        except ValueError:
            print(f"ignoring malformed --display-size {args.display_size!r} (want WxH)")
    sink = make_sink(
        args.display, w, h, getattr(src, "fps", 30.0), path=args.output,
        out_size=out_size, upscaler=getattr(args, "upscale", None),
        film_grain=bool(getattr(args, "film_grain", False)),
    )
    print(f"capturing {w}x{h} ({args.precision})...", flush=True)
    dt = proc.warmup_compile(w, h)
    print(f"engine ready in {dt:.1f}s", flush=True)

    def _factory(precision=None, proc_resolution=None):
        import copy

        a = copy.copy(args)
        if precision is not None:
            a.precision = precision
        p2 = _make_processor(a)
        if proc_resolution is not None:
            p2 = p2.with_proc_resolution(proc_resolution)
        return p2

    runner = PipelineRunner(
        src, proc, sink, realtime=not args.no_realtime, max_frames=args.frames,
        processor_factory=_factory,
        target_fps=(args.target_fps or None),
        warmup_frames=max(0, getattr(args, "warmup", 0) or 0),
    )
    interval = max(0, getattr(args, "timing_interval", 0) or 0)
    if interval:
        # periodic `[timing]` reports every N frames (main.py --timing-interval)
        state = {"next": interval}

        def _timing_cb(snap, _r=runner, _s=state):
            if snap.frames >= _s["next"]:
                _s["next"] = snap.frames + interval
                print(_r.timers.timing_line(
                    snap.frames, snap.fps, snap.fps_1pct_low,
                    target_fps=args.target_fps or 0.0, late_frames=snap.dropped,
                ), flush=True)

        runner.on_metrics = _timing_cb
    try:
        m = runner.run()
    finally:
        src.close()
        sink.close()
    # persist last-used settings (.gui_prefs.json role)
    from hdrtv_tpu_torch.utils.prefs import save_prefs

    save_prefs(
        precision=args.precision,
        resolution=args.resolution,
        use_hg=bool(args.use_hg),
        display=args.display,
        upscale=getattr(args, "upscale", None),
        film_grain=bool(getattr(args, "film_grain", False)),
    )
    print(
        f"frames={m.frames} dropped={m.dropped} fps={m.fps:.2f} "
        f"1%low={m.fps_1pct_low:.2f} model={m.model_ms:.2f}ms ring={m.ring_ms:.2f}ms "
        f"rt×={m.realtime_factor:.2f} dev_mem={m.device_mem_mb}MB rss={m.host_rss_mb}MB"
    )
    if args.stages:
        # per-stage host timing table (reference CLI stage report,
        # main.py:282-331)
        print(runner.timers.report())
    return 0


def cmd_build_engines(args) -> int:
    """Batch warm-up over resolutions × precisions — the
    build_tensorrt_engines.py role: each signature's CUDA graph captured
    and recorded in the engine registry."""
    import time as _time

    from hdrtv_tpu_torch.config import processing_dims

    resolutions = args.resolutions.split(",")
    precisions = args.precisions.split(",")
    for precision in precisions:
        a = argparse.Namespace(**{**vars(args), "precision": precision})
        proc = _make_processor(a)
        for res in resolutions:
            w, h = processing_dims(res.strip())
            dt = proc.warmup_compile(w, h)
            line = f"{precision} {res}: engine ready in {dt:.1f}s"
            if args.benchmark_runs:
                frame = (np.random.RandomState(0).rand(h, w, 3) * 255).astype(np.uint8)
                t0 = _time.perf_counter()
                for _ in range(args.benchmark_runs):
                    proc.process_rgb48(frame)
                ms = (_time.perf_counter() - t0) / args.benchmark_runs * 1e3
                line += f"; {ms:.1f} ms/frame over {args.benchmark_runs} runs"
            print(line, flush=True)
    return 0


def cmd_engines(args) -> int:
    from hdrtv_tpu_torch.runtime.engine import EngineRegistry

    reg = EngineRegistry()
    if args.action == "list":
        for rec in reg.list():
            print(
                f"{rec.key}  {rec.precision}{' hg' if rec.use_hg else ''}  "
                f"capture={rec.compile_seconds:.1f}s  torch={rec.torch_version}  {rec.device_name}"
            )
        if not reg.list():
            print("(no engines recorded)")
    elif args.action == "clear":
        n = reg.clear()
        print(f"cleared {n} cache files")
    elif args.action == "warm":
        from hdrtv_tpu_torch.config import processing_dims

        proc = _make_processor(args)
        w, h = processing_dims(args.resolution)
        dt = proc.warmup_compile(w, h)
        print(f"warmed {w}x{h} in {dt:.1f}s")
    return 0


def cmd_assets(args) -> int:
    """Required-asset inventory: every preset weight file, its validation
    status, and the presets that need it (required_clone_assets.py role —
    no downloads; the report tells the user what to populate)."""
    from hdrtv_tpu_torch.utils.assets import required_assets

    assets = required_assets()
    for a in assets:
        mb = a.size_bytes / (1 << 20)
        size = f"{mb:8.1f} MB" if a.size_bytes else "      —   "
        used = ", ".join(a.used_by[:3]) + ("…" if len(a.used_by) > 3 else "")
        print(f"{a.status:9s} {size}  {a.path}  [{used}]")
    missing = [a for a in assets if a.status != "ok"]
    print(f"{len(assets) - len(missing)}/{len(assets)} present")
    if missing and args.require:
        return 3
    return 0


def cmd_presets(args) -> int:
    """Precision-preset table with availability — the GUI precision
    dropdown's data (gui_config.py:19-160 + :260-278 availability)."""
    from hdrtv_tpu_torch.config import (
        DEFAULT_PRECISION_KEY, PRECISIONS, RESOLUTION_SCALES, precision_is_available, show_fp8,
    )

    for key, p in PRECISIONS.items():
        mark = "*" if key == DEFAULT_PRECISION_KEY else " "
        if p.requires_fp8 and not show_fp8():
            state = "hidden (HDRTVNET_SHOW_FP8=0)"
        elif precision_is_available(key):
            state = "available"
        else:
            state = "weights missing"
        print(f"{mark} {key:28s} {p.precision:12s} {state}")
    print(f"resolutions: {', '.join(RESOLUTION_SCALES)}   (* = default preset)")
    return 0


def cmd_export(args) -> int:
    from hdrtv_tpu_torch.pipeline.export import ExportConfig, export_video, export_video_multihost
    from hdrtv_tpu_torch.utils.env import env_int

    cfg = ExportConfig(
        output=args.output or "export.mov",
        resolution_key=args.resolution,
        codec=args.codec,
        batch=args.batch,
        use_mesh=args.mesh,
    )
    hosts = args.hosts or env_int("HDRTV_EXPORT_HOSTS", 1)
    if hosts > 1:
        host_id = args.host_id if args.host_id is not None else env_int("HDRTV_EXPORT_HOST_ID", 0)
        return export_video_multihost(args.video, None, cfg, hosts=hosts, host_id=host_id)  # raises: not ported
    proc = _make_processor(args)
    stats = export_video(args.video, proc, cfg)
    print(json.dumps(stats, indent=2))
    return 0


# Subcommands whose modules are not ported yet, with what they need.
NOT_PORTED = {
    "live": ("live capture (pipeline/live.py, capture.py)", ITEM_11),
    "bench": ("the playback benchmark (bench/playback.py)", ITEM_11),
    "quality": ("the quality benchmark (bench/quality.py)", ITEM_11),
    "doctor": ("the runtime check (runtime/doctor.py)", ITEM_11),
    "sweep": ("the precision sweep (bench/sweep.py)", ITEM_11),
    "validate": ("checkpoint validation (bench/validate.py)", ITEM_11),
    "compare": ("the compare snapshot (pipeline/compare.py)", ITEM_11),
    "preview": ("scrub previews (the preview command)", ITEM_11),
    "sessions": ("the session viewer (bench/playback.py sessions)", ITEM_11),
    "figures": ("figure rendering (bench/figures.py)", ITEM_11),
    "quantize": ("PTQ quantization (quant/calibrate.py)", ITEM_12),
    "layout": ("mixed-layout generation (quant/mixed.py)", ITEM_12),
    "qat": ("QAT fine-tuning (quant/qat.py, train.py)", ITEM_12),
    "mine-hard-frames": ("QAT frame mining (data/curate.py)", ITEM_12),
    "teacher-pairs": ("QAT teacher pairs (data/curate.py)", ITEM_12),
    "info": ("checkpoint inspection (models/import_torch.py)", ITEM_1),
    "split-sources": ("checkpoint splitting (models/import_torch.py)", ITEM_1),
}


def _not_ported_cmd(name: str):
    what, item = NOT_PORTED[name]

    def fn(args) -> int:
        raise _not_ported(f"the {name} command: {what}", item)

    return fn


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="hdrtv_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert", help="play/convert video")
    _add_model_args(c, prefs_defaults=True)
    c.add_argument("--video", default=None)
    c.add_argument("--display", default=None, choices=["mpv", "side-by-side", "file", "null"])
    c.add_argument("--output", default=None)
    c.add_argument("--frames", type=int, default=None)
    c.add_argument("--no-realtime", action="store_true")
    c.add_argument("--prefetch", type=int, default=4,
                   help="reader prefetch queue size, 0 disables (main.py --prefetch)")
    c.add_argument("--start-frame", type=int, default=None,
                   help="initial frame index to seek to (gui_app_entry.py --start-frame)")
    c.add_argument("--target-fps", type=float, default=0.0,
                   help="pacing FPS override; 0 = source rate (main.py --target-fps)")
    c.add_argument("--warmup", type=int, default=0,
                   help="frames excluded from final timing stats (main.py --warmup)")
    c.add_argument("--timing-interval", type=int, default=0,
                   help="print a [timing] report every N frames; 0 = off (main.py --timing-interval)")
    c.add_argument("--log-session", default=None, help="write a Log Session dir (not ported yet)")
    c.add_argument("--hdr-input", default="reject", choices=["reject", "bypass"])
    c.add_argument("--audio", action="store_true", help="attach source audio (not ported yet)")
    c.add_argument("--audio-track", type=int, default=None, help="audio stream ordinal (probe_audio_streams)")
    c.add_argument("--audio-delay-ms", type=float, default=None,
                   help="audio delay 0-2000 ms (the reference's slider; env HDRTVNET_AUDIO_DELAY_MS)")
    c.add_argument("--interactive", action="store_true",
                   help="terminal shell: pause/seek/precision/resolution hot-keys (not ported yet)")
    c.add_argument("--stages", action="store_true", help="print the per-stage timing table")
    c.add_argument("--upscale", default=None,
                   choices=["ewa_lanczossharp", "fsr", "ssim_superres"],
                   help="display upscaler when --display-size exceeds the processing "
                        "resolution (gui_scaling.py policy; default FSR via prefs)")
    c.add_argument("--film-grain", action="store_true", default=None,
                   help="append the film-grain GLSL shader to the HDR pane chain "
                        "(gui_app_entry.py --film-grain)")
    c.add_argument("--display-size", default=None, metavar="WxH",
                   help="display output size for the mpv scale policy "
                        "(the reference GUI's output preset / window size)")
    c.add_argument("--mesh", default=None, choices=["spatial"],
                   help="shard each frame's W over all devices (not ported yet)")
    c.set_defaults(fn=cmd_convert)

    lv = sub.add_parser("live", help="live capture → HDR display (x11/v4l2/synthetic)")
    _add_model_args(lv)
    lv.add_argument("--capture", default=None,
                    help="grabber spec: x11[:title] | v4l2[:/dev/videoN] | synthetic | auto")
    lv.add_argument("--fps", type=float, default=24.0, help="process FPS budget")
    lv.add_argument("--display", default="mpv", choices=["mpv", "side-by-side", "file", "null"])
    lv.add_argument("--output", default=None)
    lv.add_argument("--frames", type=int, default=None)

    b = sub.add_parser("bench", help="playback performance benchmark")
    _add_model_args(b)
    b.add_argument("--video", default=None)
    b.add_argument("--duration", type=float, default=30.0)
    b.add_argument("--no-realtime", action="store_true")
    b.add_argument("--out", default=None)
    b.add_argument("--trace", default=None, help="write a device trace to this dir")
    b.add_argument("--loop-source", action="store_true",
                   help="loop the video at EOF so short clips sustain the duration")
    b.add_argument("--wall-clock", action="store_true",
                   help="measure for true wall-clock duration instead of duration×fps frames")
    b.add_argument("--sample-interval", type=int, default=120,
                   help="runtime sample CSV cadence in frames")
    b.add_argument("--device-resident", action="store_true",
                   help="also report sustained device-resident model throughput")
    b.add_argument("--device-resident-only", action="store_true",
                   help="skip the pipelined run; report only the device-resident number")
    b.add_argument("--resolutions", nargs="+", default=None,
                   choices=["540p", "720p", "1080p", "4K"],
                   help="batch matrix: run every resolution × --runs preset")
    b.add_argument("--runs", nargs="+", default=None, metavar="PRESET",
                   help="batch matrix: precision preset keys (config.PRECISIONS)")
    b.add_argument("--supervised", action="store_true",
                   help="run the benchmark in a supervised child process")

    q = sub.add_parser("quality", help="model quality benchmark")
    _add_model_args(q)
    q.add_argument("--video", required=True, help="SDR source")
    q.add_argument("--gt", required=True, help="HDR ground-truth video")
    q.add_argument("--frames", type=int, default=10)
    q.add_argument("--out", default=None)
    q.add_argument("--no-validate-gt", action="store_true",
                   help="skip the GT pair validation gate (synthetic/test material)")
    q.add_argument("--queue", default=None, metavar="PRESETS",
                   help="benchmark queue: 'main', 'all', or a comma list of precision presets")

    pr = sub.add_parser("presets", help="precision presets with availability")
    pr.set_defaults(fn=cmd_presets)

    dr = sub.add_parser("doctor", help="runtime environment check (CUDA, tools, weights, cache)")
    dr.add_argument("--no-device", action="store_true", help="skip the device query")

    sp = sub.add_parser("split-sources",
                        help="split a composite HR+HG checkpoint into HR/HG source files")
    sp.add_argument("--model", required=True, help="composite checkpoint (base.*/hg.* keys)")
    sp.add_argument("--out-hr", required=True)
    sp.add_argument("--out-hg", required=True)

    aa = sub.add_parser("assets", help="required weight files: presence + validation report")
    aa.add_argument("--require", action="store_true",
                    help="exit nonzero when any asset is missing/invalid")
    aa.set_defaults(fn=cmd_assets)

    e = sub.add_parser("engines", help="engine registry tools")
    _add_model_args(e)
    e.add_argument("action", choices=["list", "clear", "warm"])
    e.set_defaults(fn=cmd_engines)

    be = sub.add_parser("build-engines", help="batch warm-up (resolutions × precisions)")
    _add_model_args(be)
    be.add_argument("--resolutions", default="1080p,720p")
    be.add_argument("--precisions", default="FP16")
    be.add_argument("--benchmark-runs", type=int, default=0)
    be.set_defaults(fn=cmd_build_engines)

    z = sub.add_parser("quantize", help="PTQ quantization")
    z.add_argument("--model", required=True)
    z.add_argument("--out", required=True)
    z.add_argument("--mode", default="w8a8", choices=["w8", "w8a8"])
    z.add_argument("--asymmetric", action="store_true")
    z.add_argument("--layout", default=None, help="mixed layer list (qat_layouts txt)")
    z.add_argument("--use-hg", action="store_true")
    z.add_argument("--calib-video", default=None)
    z.add_argument("--calib-frames", type=int, default=16)
    z.add_argument("--calib-method", default="max", choices=["max", "percentile", "kl"])

    lo = sub.add_parser("layout", help="generate a mixed W8A8 layout via per-layer sensitivity probe")
    lo.add_argument("--model", required=True)
    lo.add_argument("--out", required=True)
    lo.add_argument("--count", type=int, default=29, help="W8A8 layer budget (reference no-HG recipe: 29)")
    lo.add_argument("--use-hg", action="store_true")
    lo.add_argument("--probe-video", default=None)
    lo.add_argument("--probe-frames", type=int, default=4)

    s = sub.add_parser("sweep", help="precision sweep with ΔEITP quality bench")
    s.add_argument("--model", required=True, help="fp32 reference checkpoint")
    s.add_argument("--frames", type=int, default=3)
    s.add_argument("--use-hg", action="store_true")
    s.add_argument("--preset-checkpoints", nargs="*", default=None,
                   help="name=path pairs (e.g. 'int8-mixed-qat=/path.pt'); default: PTQ ladder")

    t = sub.add_parser("qat", help="QAT fine-tune to int8 (teacher-distilled)")
    t.add_argument("--model", required=True)
    t.add_argument("--out", required=True)
    t.add_argument("--layout", default=None, help="mixed layer list (qat_layouts txt)")
    t.add_argument("--use-hg", action="store_true")
    t.add_argument("--steps", type=int, default=50)
    t.add_argument("--lr", type=float, default=2e-6)  # mixed recipe (README.md:1174)
    t.add_argument("--symmetric", action="store_true")
    t.add_argument("--frames-video", default=None)
    t.add_argument("--num-frames", type=int, default=8)
    t.add_argument("--crop", type=int, default=128)

    v = sub.add_parser("validate", help="checkpoint parity vs fp32 teacher")
    v.add_argument("--model", required=True)
    v.add_argument("--teacher", required=True)
    v.add_argument("--frames", type=int, default=4)
    v.add_argument("--use-hg", action="store_true")
    v.add_argument("--expect-w8a8", type=int, default=None, help="assert quantized-layer contract")
    v.add_argument("--asymmetric", action="store_true")
    v.add_argument("--temporal", action="store_true", help="run the temporal stability probe")
    v.add_argument("--out", default=None, help="write ×8 diff contact sheets + report.json")

    cp = sub.add_parser("compare", help="3-way compare snapshot (SDR | convert | GT) + metrics")
    _add_model_args(cp)
    cp.add_argument("--video", required=True)
    cp.add_argument("--gt", default=None)
    cp.add_argument("--frame", type=int, default=0)
    cp.add_argument("--out", default=None)

    pv = sub.add_parser("preview", help="exact-seek scrub thumbnails → contact sheet PNG")
    pv.add_argument("--video", required=True)
    pv.add_argument("--frames", type=int, default=12)
    pv.add_argument("--columns", type=int, default=4)
    pv.add_argument("--thumb-width", type=int, default=320)
    pv.add_argument("--out", default=None)

    ss = sub.add_parser("sessions", help="list past benchmark sessions (quality + playback) with summaries")
    ss.add_argument("--roots", nargs="*", default=["logs"])
    ss.add_argument("--limit", type=int, default=0)
    ss.add_argument("--json", action="store_true")

    fg = sub.add_parser("figures", help="render benchmark session frames to presentation PNGs + contact sheets")
    fg.add_argument("--input", required=True, help="benchmark session dir (or one frame dir)")
    fg.add_argument("--out", default="docs/images/figures")
    fg.add_argument("--kinds", default="sdr,hdr_convert,hdr_gt")
    fg.add_argument("--render-size", default=None, metavar="WxH")
    fg.add_argument("--scale", default=None, help="presentation scaler (fsr/ssim_superres)")
    fg.add_argument("--png-depth", type=int, default=8, choices=[8, 16])
    fg.add_argument("--no-sheet", action="store_true")
    fg.add_argument("--target-nits", type=float, default=203.0)
    fg.add_argument("--source-peak", type=float, default=1000.0)

    mh = sub.add_parser("mine-hard-frames",
                        help="rank SDR/HDR image pairs by int8-hardness (bright/flat/clipped) for QAT replay")
    mh.add_argument("--sdr-dir", required=True)
    mh.add_argument("--hdr-dir", required=True)
    mh.add_argument("--out", required=True)
    mh.add_argument("--top", type=int, default=256)
    mh.add_argument("--max-repeat", type=int, default=4)
    mh.add_argument("--max-long-edge", type=int, default=384)

    tp = sub.add_parser("teacher-pairs", help="generate SDR/fp32-teacher PNG pairs from movie frames (Film QAT)")
    _add_model_args(tp)
    tp.add_argument("--video", required=True)
    tp.add_argument("--out", required=True)
    tp.add_argument("--num-frames", type=int, default=160)
    tp.add_argument("--start-frame", type=int, default=0)
    tp.add_argument("--end-frame", type=int, default=0)
    tp.add_argument("--frames", default=None, help="explicit comma-separated frame indices")
    tp.add_argument("--max-long-edge", type=int, default=0)

    i = sub.add_parser("info", help="checkpoint inspection")
    i.add_argument("--model", required=True)
    i.add_argument("--use-hg", action="store_true")

    x = sub.add_parser("export", help="HDR10 video export")
    _add_model_args(x)
    x.add_argument("--video", required=True)
    x.add_argument("--output", default=None)
    x.add_argument("--codec", default="prores", choices=["prores", "hevc", "raw", "png16", "y4m"])
    x.add_argument("--batch", type=int, default=1, help="frames per process_rgb48_batch call when > 1")
    x.add_argument("--mesh", action="store_true", help="shard batches over a device mesh (not ported yet)")
    x.add_argument("--hosts", type=int, default=None,
                   help="export-farm width (not ported yet; env HDRTV_EXPORT_HOSTS)")
    x.add_argument("--host-id", type=int, default=None,
                   help="this host's index in the farm (env HDRTV_EXPORT_HOST_ID; host 0 reassembles)")
    x.set_defaults(fn=cmd_export)

    for name in NOT_PORTED:
        sub.choices[name].set_defaults(fn=_not_ported_cmd(name))
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
