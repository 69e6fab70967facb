"""Manual W-halo exchange for the spatially sharded frame programs (port of
``hdrtv_tpu/parallel/halo.py``).

A sharded frame runs its program once per shard, each shard in a thread of
its own with its own CUDA stream of its device (:func:`run_sharded`), on its
W-columns of the frame. Every spatially overlapping stage fetches its halo
first, by **shifted windows**: before a stage of receptive radius r, each
shard extends its W-shard to ``W + 2r`` columns with a *shard-dependent
global start*:

    interior shard k : global cols [kW - r,        kW + W + r)
    left edge  (k=0) : global cols [0,             W + 2r)
    right edge (n-1) : global cols [nW - W - 2r,   nW)

Edge shards take their whole margin from their one neighbour, so the
window's outer edge is the TRUE frame edge: every kernel's own edge handling
(zero padding, reflect, the resample weights' renormalisation) applies
exactly where the frame's edge is, and interior window edges only reach
output columns that the shard-dependent :func:`crop` drops. No kernel learns
about sharding: the hand-written kernels run the single-device program's
launches on each shard's window.

After the stage, ``crop`` cuts each shard back to its canonical
``W/stride`` columns, so stages compose without global bookkeeping.
Alignment rules (all asserted, as in the JAX package):

- ``r % (4·stride so far)`` keeps window starts divisible for the s2d,
  stride-2 and quarter-res domains (a coarse companion input takes
  ``r/2``, aligned at the edges too);
- extended widths stay multiples of 8, so each shard routes as the
  single-device program does;
- ``W_local >= 2r``, so edge shards borrow their whole margin from one
  neighbour; narrower shards gather, run the stage replicated, and slice.

The exchanges go through a :class:`Collective` of the run: ``ppermute``
(one neighbour's columns), ``all_gather``, ``axis_index`` and ``axis_size``,
the four operations of JAX's ``shard_map`` the stages use, over a mailbox
that a barrier synchronises. A copy goes device to device, or on one
device stream to stream (the receiver's stream waits for the sender's
event). A shard that raises aborts the barrier, so the others raise too.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_TLS = threading.local()


class Collective:
    """The exchanges of one sharded run over ``devices`` (shard k on
    ``devices[k]``). Each call is made by every shard with its own value and
    returns once all have posted: one barrier an exchange, the mailbox
    alternating between two generations so the next exchange never
    overwrites a value still being read. ``abort`` breaks the barrier for
    every shard (a shard that raised)."""

    def __init__(self, devices: list[torch.device]):
        self.devices = [torch.device(d) for d in devices]
        self._barrier = threading.Barrier(len(self.devices))
        self._box = [[None] * len(self.devices), [None] * len(self.devices)]
        self._gen = [0] * len(self.devices)

    def axis_size(self) -> int:
        return len(self.devices)

    def axis_index(self) -> int:
        return _TLS.index

    def abort(self) -> None:
        self._barrier.abort()

    def _exchange(self, value) -> list:
        """Post ``value`` (a tensor, or a tuple of tensors and Nones; with an
        event of its stream on a CUDA device), wait for every shard, return
        the generation's posts."""
        k = self.axis_index()
        gen = self._gen[k] % 2
        self._gen[k] += 1
        cuda = [t for t in _tensors(value) if t.device.type == "cuda"]
        ev = None
        if cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(cuda[0].device))
        self._box[gen][k] = (value, ev)
        self._barrier.wait()
        return self._box[gen]

    def _receive(self, posted):
        """A copy of a posted value (each tensor of a tuple) on this shard's
        device and stream."""
        value, ev = posted
        if isinstance(value, tuple):
            return tuple(None if x is None else self._copy(x, ev) for x in value)
        return self._copy(value, ev)

    def _copy(self, x: torch.Tensor, ev) -> torch.Tensor:
        dev = self.devices[self.axis_index()]
        if x.device.type != "cuda" and dev.type != "cuda":
            return x.clone(memory_format=torch.contiguous_format)
        if x.device != dev:
            # another device: its stream synchronised before the copy (no
            # machine here has two cards to prove a finer ordering on)
            ev.synchronize()
            return x.to(dev, copy=True).contiguous()
        stream = torch.cuda.current_stream(dev)
        stream.wait_event(ev)
        y = x.clone(memory_format=torch.contiguous_format)
        x.record_stream(stream)  # the sender's block is read on this stream
        return y

    def ppermute(self, x, pairs: list[tuple[int, int]]):
        """Every shard sends ``x`` (a tensor or a tuple of them); shard d
        receives the x of the shard s of the pair (s, d), None where no pair
        names it."""
        box = self._exchange(x)
        k = self.axis_index()
        src = next((s for s, d in pairs if d == k), None)
        return None if src is None else self._receive(box[src])

    def all_gather(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Every shard's ``x`` concatenated along ``axis`` in shard order."""
        box = self._exchange(x)
        k = self.axis_index()
        parts = [x if j == k else self._receive(box[j]) for j in range(self.axis_size())]
        return torch.cat(parts, dim=axis)


def _stream_for(dev: torch.device, k: int):
    """Shard k's stream on a CUDA device (one per device and shard, kept)."""
    key = (dev.index if dev.index is not None else torch.cuda.current_device(), k)
    s = _STREAMS.get(key)
    if s is None:
        s = _STREAMS[key] = torch.cuda.Stream(torch.device("cuda", key[0]))
    return s


_STREAMS: dict[tuple[int, int], "torch.cuda.Stream"] = {}


def _tensors(v):
    if isinstance(v, torch.Tensor):
        yield v
    elif isinstance(v, (list, tuple)):
        for x in v:
            yield from _tensors(x)


def run_sharded(body, shard_args: list[tuple], devices: list[torch.device]) -> list:
    """Run ``body(k, *shard_args[k])`` once per shard, shard k in a thread
    of its own on ``devices[k]`` (under ``torch.inference_mode``; on a CUDA
    device on that device and its own stream), with the run's
    :class:`Collective` for the halo exchanges. Returns the results in shard
    order; a shard's exception is raised here (the first, not the barrier
    errors it caused in the others). On a CUDA device the shards' streams
    wait for the caller's current stream first, and the caller's current
    stream waits for every shard's results."""
    n = len(devices)
    devices = [torch.device(d) for d in devices]
    coll = Collective(devices)
    cuda = [d for d in devices if d.type == "cuda"]
    if cuda:
        from hdrtv_tpu_torch.ops import native

        native.lib()  # built once, before the shards launch
    streams = [_stream_for(d, k) if d.type == "cuda" else None for k, d in enumerate(devices)]
    for k, s in enumerate(streams):
        if s is not None:
            s.wait_stream(torch.cuda.current_stream(devices[k]))
            for t in _tensors(shard_args[k]):
                if t.device.type == "cuda":
                    t.record_stream(s)
    results: list = [None] * n
    errors: list = [None] * n
    done: list = [None] * n

    def worker(k: int) -> None:
        _TLS.coll, _TLS.index = coll, k
        try:
            ctx = contextlib.ExitStack()
            with ctx:
                ctx.enter_context(torch.inference_mode())
                if streams[k] is not None:
                    ctx.enter_context(torch.cuda.device(devices[k]))
                    ctx.enter_context(torch.cuda.stream(streams[k]))
                results[k] = body(k, *shard_args[k])
                if streams[k] is not None:
                    done[k] = torch.cuda.Event()
                    done[k].record(streams[k])
        except BaseException as e:  # every shard must leave the barrier
            errors[k] = e
            coll.abort()
        finally:
            _TLS.coll = _TLS.index = None

    threads = [threading.Thread(target=worker, args=(k,), name=f"shard{k}", daemon=True) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [e for e in errors if e is not None]
    if failed:
        first = next((e for e in failed if not isinstance(e, threading.BrokenBarrierError)), failed[0])
        raise first
    for k, ev in enumerate(done):
        if ev is not None:
            main = torch.cuda.current_stream(devices[k])
            main.wait_event(ev)
            for t in _tensors(results[k]):
                t.record_stream(main)
    return results


def _coll() -> Collective:
    coll = getattr(_TLS, "coll", None)
    if coll is None:
        raise RuntimeError("halo exchange outside a sharded run (parallel/halo.py run_sharded)")
    return coll


def axis_name() -> str | None:
    """The spatial mesh axis when running inside a sharded body."""
    return getattr(_TLS, "axis", None)


def active() -> bool:
    return getattr(_TLS, "axis", None) is not None


@contextlib.contextmanager
def manual_axis(name: str):
    """Mark the calling shard as running the program over spatial ``name``."""
    prev = getattr(_TLS, "axis", None)
    _TLS.axis = name
    try:
        yield
    finally:
        _TLS.axis = prev


@contextlib.contextmanager
def suspended():
    """Disable the halo hooks inside an already-haloed stage (a merged stage
    exchanges once; its inner stages must not)."""
    prev = getattr(_TLS, "axis", None)
    _TLS.axis = None
    try:
        yield
    finally:
        _TLS.axis = prev


def _axis_n(name: str) -> int:
    return _coll().axis_size()


def pick_radius(
    w_local: int, need: int, *, mod: int = 8, align: int = 2,
    coarse_w: int | None = None, coarse_mod: int = 8,
) -> int:
    """Smallest radius ≥ ``need`` that keeps the extended width eligible.

    ``mod``: the stage's extended-width divisibility (8 for the stride-1
    stages, 16 for the stride-2 down convs' (wb/2) % 8, 12 bytes for the
    ¼-res resample). ``align``: radius granularity (2 keeps coarse companion
    inputs at ``r/2`` aligned, 12 bytes for the ¼-res downsample).
    ``coarse_w``: when a half-res companion input is consumed by its OWN
    conv, its extended width ``coarse_w + r`` must satisfy ``coarse_mod``
    too. Shape arithmetic only."""
    r = max(need, align)
    r += (-r) % align
    for _ in range(4 * mod):
        if (w_local + 2 * r) % mod == 0 and (
            coarse_w is None or (coarse_w + r) % coarse_mod == 0
        ):
            return r
        r += align
    # Unreachable width/mod combination (odd shard width): the plain aligned radius.
    return max(need, align) + (-max(need, align)) % align


def _starts(k: int, n: int, r: int) -> int:
    """Window offset into the buffer [left 2r | own W | right 2r]."""
    return 2 * r if k == 0 else 0 if k == n - 1 else r


def ext(x: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    """Extend the local W-shard to ``W + 2r`` columns (shifted window)."""
    name = axis_name()
    if not name or r == 0 or _coll().axis_size() == 1:
        return x
    return _ext_all([x], [r], [axis])[0]


def _ext_all(xs: list, rs: list[int], axes: list[int]) -> list:
    """:func:`ext` of every input of a stage (None and r = 0 pass through),
    the neighbours' columns of all of them in two exchanges."""
    coll = _coll()
    n, k = coll.axis_size(), coll.axis_index()
    for x, r, ax in zip(xs, rs, axes):
        if x is not None:
            assert x.shape[ax] >= 2 * r, f"shard width {x.shape[ax]} < 2r={2 * r} — too many devices for this stage"
    live = [x is not None and r > 0 for x, r in zip(xs, rs)]
    right_pairs = [(i, i + 1) for i in range(n - 1)]  # data moves toward +k
    left_pairs = [(i + 1, i) for i in range(n - 1)]  # data moves toward -k
    lhs = coll.ppermute(tuple(x.narrow(ax, x.shape[ax] - 2 * r, 2 * r) if ok else None
                              for x, r, ax, ok in zip(xs, rs, axes, live)), right_pairs)
    rhs = coll.ppermute(tuple(x.narrow(ax, 0, 2 * r) if ok else None
                              for x, r, ax, ok in zip(xs, rs, axes, live)), left_pairs)
    out = []
    for i, (x, r, ax, ok) in enumerate(zip(xs, rs, axes, live)):
        if not ok:
            out.append(x)
            continue
        lh = None if lhs is None else lhs[i]
        rh = None if rhs is None else rhs[i]
        buf = torch.cat([p for p in (lh, x, rh) if p is not None], dim=ax)
        # the edge shards' buffers lack the missing side: offsets shift by 2r at k = 0
        off = _starts(k, n, r) - (2 * r if lh is None else 0)
        out.append(buf.narrow(ax, off, x.shape[ax] + 2 * r).contiguous())
    return out


def crop(y: torch.Tensor, r: int, axis: int, *, stride: int = 1, upscale: int = 1) -> torch.Tensor:
    """Undo ``ext`` after a stage: keep this shard's canonical columns.

    ``stride``: the stage's spatial downscale (2 for the stride-2 down
    convs and the HG encoder pools, 12 bytes → 1 pixel for the ¼-res
    condition downsample); ``upscale``: its upscale (2 for the HG decoder's
    conv + PixelShuffle). ``r`` is in *input* columns; ``r·upscale`` must
    divide by ``stride``."""
    name = axis_name()
    if not name or r == 0:
        return y
    coll = _coll()
    n = coll.axis_size()
    if n == 1:
        return y
    assert (r * upscale) % stride == 0, f"radius {r}·{upscale} not aligned to stride {stride}"
    rs = r * upscale // stride
    w_keep = y.shape[axis] - 2 * rs
    k = coll.axis_index()
    start = 0 if k == 0 else 2 * rs if k == n - 1 else rs
    return y.narrow(axis, start, w_keep).contiguous()


def _slice_local(y: torch.Tensor, out_axis: int, name: str) -> torch.Tensor:
    """This shard's canonical columns of a replicated (gathered) result."""
    coll = _coll()
    n, k = coll.axis_size(), coll.axis_index()
    w_out = y.shape[out_axis] // n
    return y.narrow(out_axis, k * w_out, w_out).contiguous()


def run_stage(
    fn,
    inputs,
    waxes,
    *,
    need: int,
    mod: int = 8,
    align: int = 2,
    out_axis: int,
    out_stride: int = 1,
    out_upscale: int = 1,
    coarse_idx=(),
    coarse_conv: bool = False,
):
    """Run one spatially overlapping stage on a sharded frame.

    ``fn(*inputs)`` is the unmodified single-device stage (kernels or torch
    ops); ``waxes[i]`` is input i's W axis; ``coarse_idx`` marks half-res
    companion inputs (radius r/2, window starts aligned). ``coarse_conv``:
    the first coarse input is consumed by its own conv, so its extended
    width must stay mod-8 eligible (see :func:`pick_radius`). Wide shards
    take shifted windows (ext → fn → crop); shards narrower than 2r (the
    deep UNet levels on wide meshes) gather → run fn replicated → slice,
    exact at those sizes. A tuple result has each element cropped on
    ``out_axis``; ``None`` inputs and a ``None`` result pass through."""
    if not active():
        return fn(*inputs)
    name = axis_name()
    # The radius eligibility is in the FINE domain: measure w on the first
    # non-coarse input (the coarse_conv merge sites pass the coarse one first).
    fine_i = next(
        (i for i, x in enumerate(inputs) if x is not None and i not in coarse_idx),
        0,
    )
    w = inputs[fine_i].shape[waxes[fine_i]]
    coarse_w = None
    if coarse_conv and coarse_idx:
        ci = coarse_idx[0]
        if inputs[ci] is not None:
            coarse_w = inputs[ci].shape[waxes[ci]]
    r = pick_radius(w, need, mod=mod, align=align, coarse_w=coarse_w)
    if _axis_n(name) == 1:
        with suspended():
            return fn(*inputs)
    if w >= 2 * r:
        ext_in = _ext_all(list(inputs), [r // 2 if i in coarse_idx else r for i in range(len(inputs))],
                          list(waxes))
        with suspended():
            y = fn(*ext_in)
        if y is None:
            return None
        if isinstance(y, tuple):
            return tuple(crop(e, r, out_axis, stride=out_stride, upscale=out_upscale) for e in y)
        return crop(y, r, out_axis, stride=out_stride, upscale=out_upscale)
    full = [None if x is None else gather_w(x, waxes[i]) for i, x in enumerate(inputs)]
    with suspended():
        y = fn(*full)
    if y is None:
        return None
    if isinstance(y, tuple):
        return tuple(_slice_local(e, out_axis, name) for e in y)
    return _slice_local(y, out_axis, name)


def gather_w(x: torch.Tensor, axis: int) -> torch.Tensor:
    """All-gather the W-shards into the full tensor (replicated). Used once
    a frame for the AGCM classifier's input: the ¼-res condition image is a
    few MB and the classifier needs global statistics (InstanceNorm and a
    global average pool), so it runs replicated on the gathered input."""
    name = axis_name()
    if not name:
        return x
    coll = _coll()
    if coll.axis_size() == 1:
        return x
    return coll.all_gather(x, axis)
