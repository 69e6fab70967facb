"""Host↔device frame copies through pinned host buffers on copy streams.

A pageable copy (``torch.from_numpy(a).to("cuda")``, ``t.cpu()``) runs on the
compute stream and holds the host until it is done, so it is serialized with
the frame programs. Here a host buffer is pinned once per frame shape and
reused: frames are staged in it and copied with ``non_blocking=True`` on a
copy stream of their own, and an event says when the copy is done.

- :class:`HostSlot` — one host buffer (pinned for a CUDA device) and the
  completion of the last copy into or out of it. Refilling a slot waits for
  that copy first, so a slot is never overwritten while a copy reads it.
- :class:`HostRing` — ``n`` slots handed out in turn to a consumer that holds
  each until it has used it (a sink, a writer thread): ``acquire`` blocks
  while every slot is held, ``release`` hands one back.
- :func:`copy_in` / :func:`copy_out` — the two directions on a copy stream.

The stream discipline: the device tensor :func:`copy_in` returns is
allocated on the copy stream and marked (``record_stream``) for the caller's
current stream, which waits for the copy's event before it reads the tensor;
:func:`copy_out` starts after the caller's current stream's work so far and
marks the tensor it reads for the copy stream, so the caching allocator
hands neither block out again while the other stream still uses it.

On the CPU nothing is pinned and no stream is used: :func:`copy_out` copies
at once and leaves no completion to wait for.
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch


class HostSlot:
    """One host buffer and the completion of the last copy that uses it
    (anything with ``synchronize()``: a ``torch.cuda.Event``, or a test's
    stand-in; None when no copy is pending)."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.tensor: torch.Tensor | None = None
        self.done = None

    def wait(self) -> None:
        """Block until the slot's last copy is done (only that copy, not the
        device as a whole)."""
        done, self.done = self.done, None
        if done is not None:
            done.synchronize()

    def buffer(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """The slot's buffer as ``shape`` and ``dtype``, after its last copy
        is done; allocated (pinned when the slot is) only when the slot does
        not hold one of that shape and type already. A buffer that should be
        pinned and is not raises: no copy falls back to pageable memory."""
        self.wait()
        shape = tuple(shape)
        if self.tensor is None or tuple(self.tensor.shape) != shape or self.tensor.dtype != dtype:
            self.tensor = None
            t = torch.empty(shape, dtype=dtype, pin_memory=self.pinned)
            if self.pinned and not t.is_pinned():
                raise RuntimeError(f"could not pin a host buffer of {shape} {dtype}")
            self.tensor = t
        return self.tensor

    def array(self) -> np.ndarray:
        """The buffer as numpy, after the slot's last copy is done: a view
        that the next use of the slot overwrites."""
        self.wait()
        return self.tensor.numpy()


class HostRing:
    """``n`` host slots handed out in turn: :meth:`acquire` blocks while the
    consumer holds every slot, :meth:`release` hands one back. No slot is
    handed out twice before it is released."""

    def __init__(self, n: int, *, pinned: bool):
        if n < 1:
            raise ValueError(f"a ring needs at least one slot, got {n}")
        self.slots = [HostSlot(pinned) for _ in range(n)]
        self._free = collections.deque(self.slots)
        self._cv = threading.Condition()

    @property
    def held(self) -> int:
        """Slots handed out and not yet released."""
        with self._cv:
            return len(self.slots) - len(self._free)

    def acquire(self, stop: threading.Event | None = None) -> HostSlot | None:
        """The next free slot, waiting while there is none; None once
        ``stop`` is set (so a producer never waits on a consumer that died)."""
        with self._cv:
            while not self._free:
                if stop is not None and stop.is_set():
                    return None
                self._cv.wait(0.05)
            return self._free.popleft()

    def release(self, slot: HostSlot) -> None:
        with self._cv:
            if any(s is slot for s in self._free) or not any(s is slot for s in self.slots):
                raise ValueError("released a slot that is not held from this ring")
            self._free.append(slot)
            self._cv.notify()


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def copy_in(arr: np.ndarray, slot: HostSlot, device: torch.device, stream: torch.cuda.Stream) -> torch.Tensor:
    """Host array → a new tensor on the CUDA ``device``: the bytes staged in
    the slot's pinned buffer (after the slot's last copy is done), copied
    with ``non_blocking=True`` on ``stream``; the caller's current stream
    waits for that copy before anything it enqueues next."""
    arr = np.ascontiguousarray(arr)
    buf = slot.buffer(arr.shape, _torch_dtype(arr.dtype))
    np.copyto(buf.numpy(), arr)
    current = torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        dev = torch.empty(arr.shape, dtype=buf.dtype, device=device)
        dev.copy_(buf, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    current.wait_event(done)
    dev.record_stream(current)
    slot.done = done
    return dev


def copy_out(t: torch.Tensor, slot: HostSlot, stream: torch.cuda.Stream | None) -> HostSlot:
    """Device tensor → the slot's host buffer, returned. On a CUDA tensor
    the copy runs on ``stream`` after the work the caller's current stream
    has enqueued so far, and ``slot.done`` is its event; on a CPU tensor the
    copy is made at once."""
    buf = slot.buffer(t.shape, t.dtype)
    if t.device.type != "cuda":
        buf.copy_(t)
        return slot
    if stream is None:
        raise ValueError("copying a CUDA tensor out needs a copy stream")
    stream.wait_stream(torch.cuda.current_stream(t.device))
    with torch.cuda.stream(stream):
        buf.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    t.record_stream(stream)
    slot.done = done
    return slot
