"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for ``sm_90a`` (one process per source,
all started together) and link into one shared library with a plain C
interface, loaded with ``ctypes``. The build happens at first use, into
``build/`` at the repository root, keyed by a hash of the sources, so a
checkout builds everything it runs from its own files. Nothing here runs
at import: the CPU tests import every module on a machine without nvcc.

Every wrapper counts its launches in :data:`launch_counts` (one per call
that launches its kernel, nowhere else), so a run can show that the main
path went through the kernels. Launches may come from several threads (the
shards of a sharded frame, ``parallel/halo.py``): each runs on the device of
its tensors (the stream handle a wrapper passes carries it), and the counts
are kept under a lock.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libhdrtv_kernels.so"

# kernel name -> launches since the last reset_launch_counts()
launch_counts: dict[str, int] = {
    "block_conv3": 0, "down2": 0, "trunk3": 0, "pack_rgb48": 0,
    "sft_conv3": 0, "resblock": 0, "mix_chain": 0,
    "agcm_head": 0, "cond_chain": 0, "tail": 0,
    "hg_tail": 0, "colorimetric": 0,
    "block_conv3_w8a8": 0, "sft_conv3_w8a8": 0, "resblock_w8a8": 0, "tail_w8a8": 0,
    "down2_w8a8": 0, "cond_chain_w8a8": 0, "block_conv3_pool": 0, "block_conv3_pool_w8a8": 0,
    "d2s_add": 0, "rowmajor_head": 0,
}

_COUNT_LOCK = threading.Lock()

# Element types the kernels are instantiated for, and the suffix of their
# exported names (hdrtv_<kernel>_<suffix>).
DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda/bin or PATH): "
                           "the CUDA kernels build only on a machine with the CUDA toolkit")
    return found


def build() -> Path:
    """Compile csrc/*.cu into build/<hash>/libhdrtv_kernels.so (once per
    source hash) and return its path. The compiler's register and spill
    report goes to build/<hash>/build.log."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp_", dir=BUILD_ROOT))
    try:
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        (tmp / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
        try:
            os.rename(tmp, out_dir)  # atomic publish; a concurrent build may win
        except OSError:
            if not lib.exists():
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return lib


_LIB_LOCK = threading.Lock()


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, once however many
    threads ask)."""
    with _LIB_LOCK:
        return _load()


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every exported
    function's argument and result types declared."""
    so = ctypes.CDLL(str(build()))
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    q = ctypes.POINTER(QuantParams)
    per_dtype = {
        "hdrtv_pack_rgb48": ([p, p, ll, p], i),
        "hdrtv_block_conv3": ([p, p, p, q, p, p, p, i, i, i, i, i, i, i, p, i, p], i),
        "hdrtv_down2": ([p, p, p, q, i, p, p, i, i, i, i, i, i, i, i, p, i, p], i),
        "hdrtv_trunk3": ([p, p, p, p, p, p, i, i, i, i, i, p, i, p], i),
        "hdrtv_sft_conv3": ([p, p, p, p, p, q, p, p, p, i, i, i, i, i, i, i, p, i, p], i),
        "hdrtv_resblock": ([p, p, p, p, p, q, p, p, p, q, p, i, p, p, p, p, i, i, i, i, i, p, i, p], i),
        "hdrtv_mix_chain": ([p, p, p, p, p, p, p, i, i, i, i, i, p], i),
        "hdrtv_agcm_head": ([p, i, f, p, i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p], i),
        "hdrtv_cond_chain": ([p, p, p, p, p, p, p, p, i, i, p], i),
        "hdrtv_tail": ([p, p, p, p, p, p, p, q, p, p, p, p, p, p, i, i, i, i, i, i, i, p, i, p], i),
        "hdrtv_hg_tail": ([p, p, p, p, p, p, p, p, p, i, i, i, i, p], i),
        "hdrtv_colorimetric": ([p, p, ll, *([f] * 16), p], i),
    }
    sigs = {f"{name}_{sfx}": sig for name, sig in per_dtype.items()
            for sfx in DTYPE_SUFFIX.values()}
    sigs.update({
        # the probes' kernels exist in bf16 only, as the Pallas probes do
        "hdrtv_d2s_add_bf16": ([p, p, p, i, i, i, p], i),
        "hdrtv_rowmajor_head_raw_bf16": ([p, p, p, i, i, i, p], i),
        "hdrtv_rowmajor_head_pre_bf16": ([p, p, p, i, i, i, p], i),
        # agcm_head's s2d form exists in bf16 only (the fp32 instance keeps the dense kernels)
        "hdrtv_agcm_head_s2d_bf16": ([p, i, f, p, i, p, p, p, p, p, p, p, p, p, p, p, p, i, i, p], i),
        "hdrtv_trunk3_param_floats": ([i, i, i], ll),
        "hdrtv_mix_chain_max_steps": ([], i),
        "hdrtv_error_string": ([i], ctypes.c_char_p),
    })
    for name, (args, res) in sigs.items():
        fn = getattr(so, name)
        fn.argtypes = args
        fn.restype = res
    return so


class QuantParams(ctypes.Structure):
    """An int8 layer as the W8A8 kernels take it (``struct QuantParams`` of
    ``csrc/conv3x3_s8.cuh``): device addresses of the (Co, 9·C) int8 weight,
    the fp32 yscale and folded bias; x_scale, x_zero (0 when symmetric), the
    asymmetric flag and the pad code."""

    _fields_ = [("w", ctypes.c_void_p), ("yscale", ctypes.c_void_p), ("bias", ctypes.c_void_p),
                ("s", ctypes.c_float), ("z", ctypes.c_float), ("asym", ctypes.c_int), ("pad", ctypes.c_int)]


def _quant_struct(qa) -> QuantParams:
    return QuantParams(qa.w.data_ptr(), qa.yscale.data_ptr(), qa.bias.data_ptr(), qa.scale,
                       0.0 if qa.zero is None else qa.zero, int(qa.zero is not None), qa.pad)


def quant_params(qa):
    """What a kernel with an int8 form takes for an ``ops/w8a8.py`` ``QArgs``
    on the card: a reference to its :class:`QuantParams` (the kernel's host
    side reads it during the call), or None (the float form) for None."""
    if qa is None:
        return None
    return ctypes.byref(_quant_struct(qa))


def quant_params_array(qas) -> ctypes.Array:
    """Consecutive :class:`QuantParams` of several ``QArgs`` (the branches of
    a multi-branch layer), as a kernel taking ``const QuantParams*`` and a
    count reads them. Keep it alive across the call."""
    return (QuantParams * len(qas))(*[_quant_struct(qa) for qa in qas])


def quant_params_pointers(qas) -> tuple:
    """A host array of ``QuantParams*``, one per ``QArgs`` or None (null: a
    float step), and the structures it points to; keep both alive across
    the call and pass the array."""
    structs = [None if qa is None else _quant_struct(qa) for qa in qas]
    ptrs = (ctypes.c_void_p * len(qas))(*[None if st is None else ctypes.addressof(st) for st in structs])
    return ptrs, structs


class LaunchStream(int):
    """The handle of the stream a kernel launches on (an int, as the C
    functions take it) and the device it belongs to."""

    device: torch.device


def stream_of(t: torch.Tensor) -> LaunchStream:
    """The current stream of ``t``'s device, the one its kernel launches on."""
    s = LaunchStream(torch.cuda.current_stream(t.device).cuda_stream)
    s.device = t.device
    return s


def launch(kernel: str, dtype: torch.dtype, *args, counter: str | None = None) -> None:
    """Call the exported C function of ``kernel`` for element type ``dtype``
    (``hdrtv_<kernel>_f32`` or ``_bf16``) with the device of its stream
    argument (:func:`stream_of`) current; raise on a non-zero
    cudaGetLastError() and count the launch under ``counter`` (by default
    ``kernel``; a kernel's int8 form counts under ``<kernel>_w8a8``)."""
    so = lib()
    fn_name = f"hdrtv_{kernel}_{DTYPE_SUFFIX[dtype]}"
    device = next((a.device for a in args if isinstance(a, LaunchStream)), None)
    with torch.cuda.device(device) if device is not None else contextlib.nullcontext():
        rc = getattr(so, fn_name)(*[int(a) if isinstance(a, LaunchStream) else a for a in args])
    if rc != 0:
        msg = so.hdrtv_error_string(rc).decode()
        raise RuntimeError(f"{counter or kernel}: {fn_name} failed with CUDA error {rc} ({msg})")
    with _COUNT_LOCK:
        launch_counts[counter or kernel] += 1


def pointer_array(tensors) -> ctypes.Array:
    """Device addresses of ``tensors`` as a host array of ``void*`` (how a
    kernel takes a list of parameter tensors). Keep it alive across the call."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def element_type(name: str, x: torch.Tensor) -> torch.dtype:
    """The element type a kernel call runs in: that of its activation ``x``."""
    if x.dtype not in DTYPE_SUFFIX:
        raise ValueError(f"{name} must be float32 or bfloat16, got {x.dtype}")
    return x.dtype


def check_params(name: str, dtype: torch.dtype, weights, biases) -> None:
    """What every kernel takes as parameters, on the CPU as on the card:
    weights in the call's element type, biases in fp32 (the TPU kernels'
    contract: a bias rounded to bf16 would be another program)."""
    for w in weights:
        if w.dtype != dtype:
            raise ValueError(f"{name}: weights must be {dtype} like the activations, got {w.dtype}")
    for b in biases:
        if b.dtype != torch.float32:
            raise ValueError(f"{name}: biases must be float32, got {b.dtype}")


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple | None = None,
               align: int = 16) -> None:
    """What every kernel takes: a contiguous CUDA tensor of the kernel's
    dtype (and shape, when given), its data ``align``-byte aligned (16 but
    for a kernel that takes any element-aligned view)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when the call takes the plain version: every tensor lies on the
    CPU. A mix of devices, or any device other than CPU or CUDA, raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors must all lie on the CPU or all on CUDA, got {sorted(kinds)}")
