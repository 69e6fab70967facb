"""Runtime environment check (the port of ``hdrtv_tpu/runtime/doctor.py``):
the CUDA analog of the reference's
`nvidia_runtime_check.check_nvidia_python_runtime` (:54-142). It validates
the accelerator Python runtime, the kernels' toolchain and the external tool
belt without building or running a kernel, and returns ``{ok, issues,
details}`` for the CLI / startup gate.

The card is queried in a budgeted subprocess, as the JAX check queries its
devices, so a diagnostics command never hangs on a driver that does not
answer. Without a card the report is ``ok: false`` with the issue named:
the port's programs run on the card and nothing falls back to the CPU.
"""

from __future__ import annotations

import os
import shutil
from typing import Any

# The port's kernels are built for this compute capability (ops/native.py
# ARCH_FLAGS: sm_90a).
KERNEL_CAPABILITY = (9, 0)
CUTLASS_INCLUDE = "/usr/local/cutlass/include"

# What the child prints: torch's view of the card, then nvidia-smi's.
_PROBE = r"""
import json, subprocess, torch
out = {"cuda_available": torch.cuda.is_available(), "device_count": torch.cuda.device_count()}
if out["cuda_available"] and out["device_count"]:
    out["device_name"] = torch.cuda.get_device_name(0)
    out["capability"] = list(torch.cuda.get_device_capability(0))
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,driver_version",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        out["nvidia_smi"] = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else smi.stderr.strip()[-200:]
    except (OSError, subprocess.TimeoutExpired) as e:
        out["nvidia_smi"] = f"unavailable: {e}"
print("DOCTOR " + json.dumps(out))
"""


def _bounded_device_probe(issues: list[str]) -> dict[str, Any]:
    """The card's name, compute capability, power limit and driver, queried in
    a budgeted subprocess (HDRTV_DOCTOR_PROBE_TIMEOUT_S, default 120 s)."""
    import json as _json
    import subprocess
    import sys

    from hdrtv_tpu_torch.utils.env import env_int

    budget = env_int("HDRTV_DOCTOR_PROBE_TIMEOUT_S", 120, lo=5)
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True, timeout=budget)
    except subprocess.TimeoutExpired:
        issues.append(f"device probe exceeded {budget}s (driver not answering?) — rerun with --no-device to skip")
        return {"device_probe": "timeout"}
    for line in r.stdout.splitlines():
        if line.startswith("DOCTOR "):
            out = _json.loads(line[len("DOCTOR "):])
            if not out.get("cuda_available") or not out.get("device_count"):
                issues.append("no CUDA device: the port's frame programs and kernels run on an NVIDIA card "
                              "(HDRTV_CLI_PLATFORM=cpu runs the CLI on the CPU by request)")
            elif tuple(out.get("capability", ())) != KERNEL_CAPABILITY:
                issues.append(f"the kernels build for sm_90a (compute capability 9.0); "
                              f"{out.get('device_name')} has {'.'.join(map(str, out.get('capability', [])))}")
            return out
    issues.append(f"device probe failed rc={r.returncode}: {(r.stderr or r.stdout).strip()[-200:]}")
    return {"device_probe": "failed"}


def _nvcc_version(nvcc: str) -> str:
    import subprocess

    try:
        r = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable: {e}"
    lines = [ln for ln in r.stdout.splitlines() if "release" in ln]
    return lines[-1].strip() if lines else r.stdout.strip()[-120:]


def check_runtime(*, probe_device: bool = True) -> dict[str, Any]:
    """Validate torch/CUDA, the card, the kernels' toolchain and build
    directory, binaries, weights, and the graph registry.

    ``probe_device=False`` skips the card query (the subprocess), as the JAX
    check skips its device query.
    """
    issues: list[str] = []
    details: dict[str, Any] = {}

    try:
        import torch

        details["torch"] = torch.__version__
        details["torch_cuda"] = torch.version.cuda
        if torch.version.cuda is None:
            issues.append(f"torch {torch.__version__} is built without CUDA")
        if probe_device:
            details.update(_bounded_device_probe(issues))
        else:
            details["device_probe"] = "skipped"
    except Exception as exc:  # noqa: BLE001 — report, never crash the check
        issues.append(f"torch import/device query failed: {type(exc).__name__}: {exc}")

    # The kernels' toolchain and where they are built (ops/native.py).
    from hdrtv_tpu_torch.ops import native

    try:
        nvcc = native._nvcc()
        details["nvcc"] = nvcc
        details["nvcc_version"] = _nvcc_version(nvcc)
    except RuntimeError as exc:
        issues.append(str(exc))
    # No kernel includes CUTLASS today: its headers are reported, not required.
    details["cutlass_include"] = CUTLASS_INCLUDE if os.path.isdir(CUTLASS_INCLUDE) else None
    build_dir = native.BUILD_ROOT / native.source_hash()
    details["kernel_build_dir"] = str(build_dir)
    details["kernels_built"] = (build_dir / native.LIB_NAME).is_file()
    try:
        native.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        probe = native.BUILD_ROOT / ".doctor_probe"
        probe.write_text("ok")
        probe.unlink()
    except OSError as exc:
        issues.append(f"kernel build directory not writable: {exc}")

    # External tool belt (each absence degrades a documented feature, never
    # crashes: exact GT decode, mpv display, HDR-VDP3 — the sink/reader
    # ladders fall back).
    for tool, role in (
        ("ffmpeg", "exact GT decode + ProRes export"),
        ("ffprobe", "media probing"),
        ("mpv", "HDR display sink + audio attach"),
        ("octave", "HDR-VDP3 bridge"),
    ):
        present = shutil.which(tool) is not None
        details[tool] = present
        if not present:
            details.setdefault("degraded", []).append(f"{tool} absent → {role} unavailable")

    # Weights inventory (the required-clone-assets gate).
    try:
        from hdrtv_tpu_torch.utils.assets import required_assets

        assets = required_assets()
        ok_n = sum(1 for a in assets if a.status == "ok")
        details["weights"] = f"{ok_n}/{len(assets)}"
        if ok_n == 0:
            issues.append("no preset weight files found (set HDRTVNET_WEIGHTS_ROOT).")
    except Exception as exc:  # noqa: BLE001
        issues.append(f"weights inventory failed: {type(exc).__name__}: {exc}")

    # The graph registry's root must be writable for warm startups.
    try:
        from hdrtv_tpu_torch.runtime.engine import EngineRegistry, default_cache_root

        root = default_cache_root()
        os.makedirs(root, exist_ok=True)
        probe = os.path.join(root, ".doctor_probe")
        with open(probe, "w") as f:
            f.write("ok")
        os.remove(probe)
        details["engine_cache"] = root
        details["engines_recorded"] = len(EngineRegistry().list())
    except OSError as exc:
        issues.append(f"engine cache root not writable: {exc}")

    return {"ok": not issues, "issues": issues, "details": details}
