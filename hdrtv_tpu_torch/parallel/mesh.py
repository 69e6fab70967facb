"""Device meshes: frame-batch data parallelism × spatial W-sharding (port of
``hdrtv_tpu/parallel/mesh.py``).

- **data axis**: independent frames split across devices
  (``HDRTVNetTorch.process_rgb48_batch(..., mesh=)``): each device runs the
  single-device program on its frames; nothing crosses devices but the
  parameters, copied once.
- **spatial axis**: the W dimension of one frame split across devices
  (``HDRTVNetTorch(mesh=...)``): each shard runs the frame program on its
  columns, and every spatially overlapping stage fetches its neighbours'
  columns first (``parallel/halo.py``).

A :class:`Mesh` holds ``torch.device`` objects in a (data, spatial) grid.
By default it takes every visible CUDA device; without one it raises,
unless the caller lists the devices. A listed device may repeat: the tests
run a mesh of ``[torch.device("cpu")] * n``, the card's check one of
``[torch.device("cuda:0")] * n`` (n shards, one card). The shards of a
sharded run are threads, each on its own CUDA stream of its device
(``parallel/halo.py run_sharded``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


class Mesh:
    """Devices in a (data, spatial) grid, JAX's ``Mesh`` for the port:
    ``shape`` maps each axis name to its size, ``devices`` is the object
    array of ``torch.device``."""

    def __init__(self, devices, axis_names: tuple[str, str] = ("data", "spatial")):
        arr = np.empty(np.shape(devices)[:2], dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(devices[idx[0]][idx[1]])
        if arr.ndim != 2 or arr.size == 0:
            raise ValueError(f"a mesh is a non-empty 2-D grid of devices, got shape {arr.shape}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def row(self, d: int = 0) -> list[torch.device]:
        """The devices of data row ``d``: one frame's spatial shards."""
        return list(self.devices[d])

    def distinct_devices(self) -> list[torch.device]:
        """Each device of the mesh once, in mesh order."""
        out: list[torch.device] = []
        for dev in self.devices.flat:
            if dev not in out:
                out.append(dev)
        return out

    def __repr__(self) -> str:
        grid = [[str(d) for d in row] for row in self.devices]
        return f"Mesh({grid}, axis_names={self.axis_names})"


def _default_devices() -> list[torch.device]:
    """Every visible CUDA device; without one, raise (a CPU mesh is made by
    listing its devices)."""
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh takes every visible CUDA device by default and none is available; "
                           "list its devices (devices=[torch.device('cpu')] * n for a CPU mesh)")
    return [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]


def _pick(n_devices: int | None, devices) -> list[torch.device]:
    devs = [torch.device(d) for d in devices] if devices is not None else _default_devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return devs


def _factor2(n: int) -> tuple[int, int]:
    """Split n into (a, b), a·b = n, preferring square-ish with a ≤ b."""
    best = (1, n)
    for a in range(1, int(np.sqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


def make_mesh(n_devices: int | None = None, *, axes: tuple[str, str] = ("data", "spatial"),
              devices: list | None = None) -> Mesh:
    """2-D mesh over the first n devices: data (frame batch) × spatial (W)."""
    devs = _pick(n_devices, devices)
    a, b = _factor2(len(devs))
    return Mesh([devs[i * b:(i + 1) * b] for i in range(a)], axes)


def spatial_mesh(n_devices: int | None = None, *, devices: list | None = None) -> Mesh:
    """1×N mesh putting every device on the spatial axis: the single-frame
    latency configuration (``cli convert --mesh spatial``)."""
    return Mesh([_pick(n_devices, devices)], ("data", "spatial"))


class Sharding(NamedTuple):
    """Which mesh axis splits each dimension of an array (None: replicated
    along it), the ``PartitionSpec`` of a JAX ``NamedSharding``."""

    mesh: Mesh
    spec: tuple


def flat_sharding(mesh: Mesh) -> Sharding:
    """The flat byte-row contract (H, 3W): columns over the spatial axis. 3W/n
    stays channel-aligned whenever n divides W, so a flat column shard is a
    W-pixel shard."""
    return Sharding(mesh, (None, "spatial"))


def frame_sharding(mesh: Mesh, *, batch: bool = True, spatial: bool = True) -> Sharding:
    """NHWC frame batches: N over data, W over spatial. W (not H) is the
    sharded dimension: RGB48 rows stay contiguous per shard, and the LE
    UNet's deepest level keeps W/8 columns a shard."""
    return Sharding(mesh, ("data" if batch else None, None, "spatial" if spatial else None, None))


def _to(v, device: torch.device):
    """A parameter value on ``device``: tensors copied (unless already
    there), containers and dataclasses (``ops/w8a8.py QArgs``) field by
    field, anything else as it is."""
    if isinstance(v, torch.Tensor):
        return v if v.device == device else v.to(device)
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(_to(x, device) for x in v))
    if isinstance(v, (list, tuple)):
        return type(v)(_to(x, device) for x in v)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return dataclasses.replace(v, **{f.name: _to(getattr(v, f.name), device)
                                         for f in dataclasses.fields(v) if f.init})
    return v


def params_on(params: dict, device) -> dict:
    """The parameters on ``device`` (the tensors already there shared)."""
    return {k: _to(v, torch.device(device)) for k, v in params.items()}


def replicate_params(params: dict, mesh: Mesh) -> dict:
    """One copy of the parameters per distinct device of the mesh
    (device → parameters); a device the parameters already lie on shares
    them. CNN weights are small (~1.4M values without HG): replication is
    the right call, as in the JAX package."""
    return {dev: params_on(params, dev) for dev in mesh.distinct_devices()}
