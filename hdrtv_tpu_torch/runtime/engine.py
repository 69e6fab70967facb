"""Engine cache of the port (counterpart of ``hdrtv_tpu/runtime/engine.py``):
one captured CUDA graph per frame signature, and the engine registry.

The JAX runtime runs one compiled XLA executable per (resolution, precision,
output) signature and keeps it in XLA's persistent compilation cache
(``enable_persistent_cache``, ``seed_cache``, ``_strip_mosaic_debuginfo``
there). The port's counterpart of "one executable per signature" is one
``torch.cuda.CUDAGraph`` per signature (:class:`GraphCache`): the frame
program's kernels and torch ops captured once and replayed, so that a frame
costs one graph launch on the host instead of a few hundred kernel launches.
A CUDA graph does not outlive its process, so nothing of it is persisted:
the port's persisted artefacts are the kernels ``ops/native.py`` builds into
``build/``, and the XLA cache functions have no counterpart here.

The registry (:class:`EngineRegistry`) keeps the same JSON metadata index as
the JAX one, ``{model}_{WxH}_{mode}`` records with the model's fingerprint,
for list/clear/validate tooling; ``warmup_compile`` records a signature's
capture in it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time

import numpy as np
import torch

from hdrtv_tpu_torch.ops import native, resize
from hdrtv_tpu_torch.utils.env import env_bool, env_str

# The switches the frame programs read at each call, with the default each
# call site gives them (models/s2d.py _mega_ok, _down2_qargs; models/hg_s2d.py
# for the runtime's tail_on=True; runtime/processor.py wants_pairs). A graph
# records the program these chose while it was captured, so each is part of
# the signature: a changed switch gets its own graph.
PER_CALL_SWITCHES = (
    ("HDRTV_MEGAKERNEL", True),
    ("HDRTV_PAIRS_BOUNDARY", True),
    ("HDRTV_HG_TAIL", True),
    ("HDRTV_INT8_DOWN2", False),
)


def default_cache_root() -> str:
    """Where the registry keeps its index: ``HDRTVNET_ENGINE_CACHE_DIR``, else
    ``HDRTVNET_CACHE_DIR`` (the engine-specific variable wins when both are
    set), else ``~/.cache/hdrtv_tpu_torch/engines``."""
    root = env_str("HDRTVNET_ENGINE_CACHE_DIR") or env_str("HDRTVNET_CACHE_DIR")
    if root:
        return root
    return os.path.join(os.path.expanduser("~"), ".cache", "hdrtv_tpu_torch", "engines")


def model_fingerprint(params: dict) -> str:
    """Order-independent hash of parameter names, shapes, dtypes and a
    strided sample of their bytes (truncated); the JAX package's hash of the
    same numpy parameters."""
    h = hashlib.sha256()
    for k in sorted(params):
        v = np.asarray(params[k])
        h.update(k.encode())
        h.update(str(v.shape).encode())
        h.update(str(v.dtype).encode())
        flat = v.reshape(-1)
        h.update(flat[:: max(1, flat.size // 4096)].tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class EngineRecord:
    """Metadata for one captured (model, resolution, mode) signature."""

    key: str
    model_hash: str
    width: int
    height: int
    precision: str
    use_hg: bool
    torch_version: str
    device_name: str
    compile_seconds: float
    created: float

    @staticmethod
    def make_key(model_tag: str, width: int, height: int, mode: str) -> str:
        return f"{model_tag}_{width}x{height}_{mode}"


class EngineRegistry:
    """JSON metadata index of the warmed signatures (list/clear/validate).
    The directory is made when the first record is written."""

    INDEX = "engines.json"

    def __init__(self, root: str | None = None):
        self.root = root or default_cache_root()
        self.index_path = os.path.join(self.root, self.INDEX)

    def _load(self) -> dict:
        try:
            with open(self.index_path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {}

    def _save(self, data: dict) -> None:
        os.makedirs(self.root, exist_ok=True)
        tmp = self.index_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
        os.replace(tmp, self.index_path)

    def record(self, rec: EngineRecord) -> None:
        data = self._load()
        data[rec.key] = dataclasses.asdict(rec)
        self._save(data)

    def lookup(self, key: str) -> EngineRecord | None:
        entry = self._load().get(key)
        return EngineRecord(**entry) if entry else None

    def list(self) -> list[EngineRecord]:
        return [EngineRecord(**v) for v in self._load().values()]

    def validate(self, key: str, model_hash: str) -> bool:
        """True when ``key`` was recorded for this model's fingerprint."""
        rec = self.lookup(key)
        return bool(rec and rec.model_hash == model_hash)

    def clear(self) -> int:
        """Remove the files this registry writes (its index and the index's
        temporary), nothing else in the directory; returns how many."""
        count = 0
        for name in (self.INDEX, self.INDEX + ".tmp"):
            path = os.path.join(self.root, name)
            if os.path.isfile(path):
                os.remove(path)
                count += 1
        return count


def graph_signature(shape, dtype, program: str, precision: str, proc_resolution, fast_condition_resize: bool,
                    fast_zero_condition: bool) -> tuple:
    """What chooses a frame's program or its shapes: the input's shape and
    dtype, the program (``pairs``, ``flat``, ``hg`` or ``natural``), the
    precision token, ``proc_resolution`` and the fast-condition flags, and
    the per-call switches (:data:`PER_CALL_SWITCHES`) as they are set now."""
    switches = tuple((name, env_bool(name, default)) for name, default in PER_CALL_SWITCHES)
    return (tuple(shape), str(dtype), program, precision,
            None if proc_resolution is None else tuple(proc_resolution),
            bool(fast_condition_resize), bool(fast_zero_condition), switches)


@dataclasses.dataclass
class CapturedGraph:
    """One signature's graph: its static input and output (in the graph's
    private memory pool), the cached device matrices its capture read
    outside that pool (``ops/resize.py hold_matrices``: the graph replays
    their addresses, so it keeps them), the launches its capture counted by
    kernel, the device memory its pool reserved, and the capture's seconds
    (after the eager run)."""

    graph: torch.cuda.CUDAGraph
    static_in: torch.Tensor
    static_out: torch.Tensor
    held: list
    launches: dict
    pool_bytes: int
    capture_s: float


class GraphCache:
    """One captured CUDA graph per signature.

    The first call of a signature runs ``fn`` eagerly once (this builds the
    kernels, fills the parameter-derived caches and lets cuDNN choose its
    algorithms), then captures ``fn`` on a side stream with the input in a
    static buffer. Every call works on the caller's current stream: it
    copies its input into that buffer, replays the graph and returns a copy
    of the static output, all enqueued there, so the tensor returned is the
    caller's: a later call never overwrites it. An input copied in on
    another stream must be waited for by the current stream first
    (``runtime/transfer.py copy_in`` does); a reader of the result on
    another stream marks it for that stream (``copy_out`` does, with
    ``record_stream``). A capture or replay that fails raises; nothing runs
    eagerly in its place.

    A capture prohibits unsafe CUDA calls from its own thread only
    (``capture_error_mode="thread_local"``): a pipeline's feeder thread may
    wait on its copies' events meanwhile. The pipelines also let their rings
    drain before a frame that may capture (``pipeline/runner.py``).

    Every graph keeps its private memory pool, about the size of the eager
    program's peak (``PERF.md`` §2), for as long as the cache holds it: a process that sees many frame signatures
    holds one pool each until :meth:`clear`. Nothing is evicted: the JAX
    runtime's executables keep no activations between calls, but a graph
    must keep the addresses it was captured with."""

    def __init__(self):
        self.entries: dict[tuple, CapturedGraph] = {}

    def __len__(self) -> int:
        return len(self.entries)

    def run(self, key: tuple, fn, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda":
            raise ValueError(f"CUDA graphs replay CUDA tensors, got one on {x.device}")
        with torch.inference_mode():
            entry = self.entries.get(key)
            if entry is None:
                entry = self.entries[key] = self._capture(key, fn, x)
            entry.static_in.copy_(x)
            try:
                entry.graph.replay()
            except Exception as e:
                raise RuntimeError(f"replay of the CUDA graph of {key} failed: {e}") from e
            return entry.static_out.clone()

    @staticmethod
    def _capture(key: tuple, fn, x: torch.Tensor) -> CapturedGraph:
        fn(x)
        static_in = x.clone()
        torch.cuda.synchronize(x.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(x.device)
        before = dict(native.launch_counts)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with resize.hold_matrices() as held, torch.cuda.graph(graph, capture_error_mode="thread_local"):
                static_out = fn(static_in)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {key} failed: {e}") from e
        capture_s = time.perf_counter() - t0
        launches = {k: v - before.get(k, 0) for k, v in native.launch_counts.items() if v != before.get(k, 0)}
        return CapturedGraph(graph, static_in, static_out, held, launches,
                             torch.cuda.memory_reserved(x.device) - reserved, capture_s)

    def clear(self) -> None:
        """Drop every graph, its static buffers and its memory pool (the
        pool's memory returns to the device with ``torch.cuda.empty_cache``)."""
        for entry in self.entries.values():
            entry.graph.reset()
        self.entries.clear()
