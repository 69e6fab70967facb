"""Multi-host scale-out: ``torch.distributed`` wiring and the export-farm plan
(port of ``hdrtv_tpu/parallel/multihost.py``).

The natural multi-host axis of this workload is frame ranges: video frames
are independent, so an export farm gives each host a contiguous frame range;
no activations cross hosts, only the finished segments, which are joined
losslessly (FFmpeg's concat demuxer for ProRes segments; raw RGB48 segments
are appended byte for byte).

``initialize_distributed`` starts ``torch.distributed`` from arguments or
the standard environment (``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE``
/ ``RANK``); ``plan_frame_ranges`` computes the per-host assignment;
``segment_paths`` / ``concat_command`` give the lossless reassembly.
"""

from __future__ import annotations

import os

__all__ = [
    "initialize_distributed",
    "plan_frame_ranges",
    "segment_paths",
    "concat_command",
]


def initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str = "gloo",
) -> bool:
    """Start ``torch.distributed`` from the arguments or the environment:
    ``coordinator`` (``host:port``, else ``MASTER_ADDR``:``MASTER_PORT``),
    ``num_processes`` (else ``WORLD_SIZE``), ``process_id`` (else ``RANK``).
    Returns True when a process group was started; False on a single host
    (no coordinator and no process count given), as the JAX package's does
    from its own variables. ``backend``: gloo by default: the farm's hosts
    exchange no tensors, the group is their rendezvous (and gloo takes
    several processes on one card, which NCCL refuses)."""
    import torch.distributed as dist

    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if coordinator is None and num_processes is None:
        return False  # single host: nothing to do
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator or 'localhost:29500'}",
        world_size=int(num_processes if num_processes is not None else 1),
        rank=int(process_id),
    )
    return True


def plan_frame_ranges(n_frames: int, n_hosts: int) -> list[tuple[int, int]]:
    """Contiguous [start, end) frame ranges per host, balanced to ±1 frame.
    Contiguity matters: each host decodes sequentially from its start frame
    (one seek), and its segment is a valid standalone clip."""
    if n_hosts <= 0:
        raise ValueError("n_hosts must be positive")
    base, extra = divmod(max(0, n_frames), n_hosts)
    ranges = []
    start = 0
    for h in range(n_hosts):
        size = base + (1 if h < extra else 0)
        ranges.append((start, start + size))
        start += size
    return ranges


def segment_paths(output: str, n_hosts: int) -> list[str]:
    """Per-host segment names: ``out.mov`` → ``out.seg000.mov`` …"""
    root, ext = os.path.splitext(output)
    return [f"{root}.seg{h:03d}{ext}" for h in range(n_hosts)]


def concat_command(segments: list[str], output: str, list_path: str) -> list[str]:
    """FFmpeg concat-demuxer command reassembling the segments losslessly
    (stream copy: no re-encode, bit-exact for intra-only codecs such as the
    export chain's ProRes). Writes the list file."""
    with open(list_path, "w") as f:
        for seg in segments:
            # Concat-demuxer quoting: a single quote inside a quoted string
            # is written as '\'' (close, escaped quote, reopen).
            path = os.path.abspath(seg).replace("'", "'\\''")
            f.write(f"file '{path}'\n")
    return [
        "ffmpeg", "-y", "-f", "concat", "-safe", "0",
        "-i", list_path, "-c", "copy", output,
    ]
