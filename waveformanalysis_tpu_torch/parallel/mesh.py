"""Device meshes and event-axis sharded tensors.

Port of ``waveformanalysis_tpu/parallel/mesh.py``. The JAX package runs a
mesh as one SPMD program (``shard_map``) under a single controller: one
process builds the mesh, attaches it and gets whole results back. The port
keeps that contract with a mesh of explicit ``torch.device`` objects in one
process: each shard's work runs on its own device, one shard after another
from the host (their kernels overlap where the shards sit on distinct
cards). A device may repeat, as a JAX ``Mesh`` accepts: a mesh of
``[cuda:0] * 8`` runs eight real shards on one card, and ``[cpu] * 8`` is
the CPU tests' counterpart of the JAX tests' eight virtual devices.

The canonical layout is 1-D ``("data",)``: chunks of the time-sorted record
stream or blocks of events are the unit of data parallelism.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import resolve_device


class Mesh:
    """A grid of devices with named axes (the counterpart of a JAX Mesh).

    ``devices`` is an object ndarray of ``torch.device`` of the mesh's
    shape; ``shape`` maps each axis name to its size, in axis order.
    """

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]) -> None:
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh of {devices.ndim} dimensions with axis names {axis_names}"
            )
        types = {d.type for d in devices.flat}
        if len(types) > 1:
            raise ValueError(f"a mesh holds devices of one type, got {sorted(types)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_type(self) -> str:
        """The devices' type (``cuda`` or ``cpu``)."""
        return self.devices.flat[0].type

    def shard_devices(self, axis: str = "data") -> List[torch.device]:
        """The devices along ``axis``, one per shard (index 0 on any other
        axis: data sharded on ``axis`` is replicated over the others)."""
        if axis not in self.shape:
            raise ValueError(f"Mesh has no axis {axis!r} (axes: {self.axis_names})")
        k = self.axis_names.index(axis)
        index = [0] * len(self.axis_names)
        out = []
        for i in range(self.shape[axis]):
            index[k] = i
            out.append(self.devices[tuple(index)])
        return out

    def __repr__(self) -> str:
        sizes = ", ".join(f"{a!r}: {s}" for a, s in self.shape.items())
        return f"Mesh(shape={{{sizes}}}, devices={[str(d) for d in self.devices.flat]})"


@dataclass(frozen=True)
class NamedSharding:
    """How a tensor lies on a mesh: ``spec`` names the mesh axis of each
    leading dimension it is split over; ``()`` is replicated."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={self.mesh!r}, spec=PartitionSpec{self.spec!r})"


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, ...] = ("data",),
    shape: Optional[Tuple[int, ...]] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> Mesh:
    """Build a Mesh over the first ``n_devices`` devices.

    Default: a 1-D data-parallel mesh over every CUDA device; without one
    it raises. Pass ``devices`` for another grid, a device repeated as
    often as it should hold shards (``[torch.device("cpu")] * 8`` on the
    CPU, ``[torch.device("cuda:0")] * 8`` for eight shards on one card).
    """
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device (torch.cuda.is_available() is False); "
                "pass devices=, e.g. [torch.device('cpu')] * 8"
            )
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    for d in devs:
        if d.type == "cuda" and d.index is not None and d.index >= torch.cuda.device_count():
            raise ValueError(
                f"{d}: only {torch.cuda.device_count()} CUDA device(s) available"
            )
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"Requested {n_devices} devices but only {len(devs)} available"
            )
        devs = devs[:n_devices]
    if shape is None:
        if len(axis_names) == 1:
            shape = (len(devs),)
        else:
            raise ValueError("shape required for multi-axis meshes")
    if int(np.prod(shape)) != len(devs):
        raise ValueError(f"Mesh shape {shape} != device count {len(devs)}")
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(shape), tuple(axis_names))


def spread_devices(device: Union[str, torch.device], n_shards: int = 8) -> List[torch.device]:
    """``n_shards`` devices for a mesh on ``device``'s type: for CUDA, the
    cards in blocks (shard i on card ``i * count // n_shards``, so a single
    card holds every shard), else ``device`` repeated."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * n_shards
    count = torch.cuda.device_count()
    return [torch.device("cuda", i * count // n_shards) for i in range(n_shards)]


def data_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Shard the leading (event/chunk) dimension across the data axis."""
    return NamedSharding(mesh, (axis,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def pad_to_shards(n: int, n_shards: int) -> int:
    """Events must pad to a multiple of the shard count for even layouts."""
    return ((n + n_shards - 1) // n_shards) * n_shards


class ShardedTensor:
    """A tensor split on its leading dimension over one mesh axis: the
    per-shard tensors in mesh order, each on its shard's device (the
    counterpart of a jax.Array sharded with ``P(axis)``). ``numpy()`` and
    ``np.asarray`` concatenate the shards in shard order on the host."""

    def __init__(self, shards: Sequence[torch.Tensor], mesh: Mesh, axis: str = "data") -> None:
        shards = list(shards)
        if len(shards) != mesh.shape[axis]:
            raise ValueError(
                f"{len(shards)} shards for a mesh axis {axis!r} of {mesh.shape[axis]}"
            )
        self.shards = shards
        self.mesh = mesh
        self.axis = axis

    @property
    def sharding(self) -> NamedSharding:
        return data_sharding(self.mesh, self.axis)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (sum(int(s.shape[0]) for s in self.shards),) + tuple(self.shards[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def __len__(self) -> int:
        return self.shape[0]

    def numpy(self) -> np.ndarray:
        return np.concatenate([s.detach().cpu().numpy() for s in self.shards])

    def __array__(self, dtype: Any = None, copy: Any = None) -> np.ndarray:
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)

    def __repr__(self) -> str:
        return f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, {self.sharding!r})"


def shard_rows(x: Any, mesh: Mesh, axis: str = "data") -> ShardedTensor:
    """Split ``x`` (a tensor, an array or a ShardedTensor on ``mesh``) into
    equal row blocks, one on each shard's device. The row count must be a
    multiple of the shard count, as ``shard_map`` requires; rows of a tensor
    already on a shard's device are views, not copies."""
    if isinstance(x, ShardedTensor):
        if x.mesh is mesh and x.axis == axis:
            return x
        x = torch.from_numpy(x.numpy())
    elif not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    devs = mesh.shard_devices(axis)
    n = int(x.shape[0])
    if n % len(devs):
        raise ValueError(
            f"leading dimension {n} is not a multiple of the {len(devs)} shards "
            f"of mesh axis {axis!r}"
        )
    m = n // len(devs)
    return ShardedTensor(
        [x[i * m:(i + 1) * m].to(d) for i, d in enumerate(devs)], mesh, axis
    )
