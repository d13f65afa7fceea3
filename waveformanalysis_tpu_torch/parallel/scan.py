"""Sharded event-axis execution over a device mesh.

Port of ``waveformanalysis_tpu/parallel/scan.py``. Blocks of events become
shards on a 1-D ``("data",)`` mesh; windowed kernels receive halo rows from
their neighbouring shards (JAX's ``ppermute``: here a copy to the
receiving shard's device); run statistics are summed over the shards in
shard order (JAX's ``psum``) and returned once. Each shard's kernel runs
under its device (``torch.cuda.device``), so a CUDA kernel launches on the
shard's device and its current stream.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import on_device
from waveformanalysis_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedTensor,
    pad_to_shards,
    shard_rows,
)


def shard_halo_exchange(
    shards: Sequence[torch.Tensor], halo: int
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Exchange boundary rows between ring neighbours.

    Returns (left_halos, right_halos), one per shard on its device: the
    last ``halo`` rows of the left neighbour and the first ``halo`` rows of
    the right neighbour, zeroed at the open ends (shard 0's left, the last
    shard's right).
    """
    n = len(shards)
    left, right = [], []
    for i, x in enumerate(shards):
        tail, head = x[-halo:], x[:halo]
        left.append(torch.zeros_like(tail) if i == 0
                    else shards[i - 1][-halo:].to(x.device))
        right.append(torch.zeros_like(head) if i == n - 1
                     else shards[i + 1][:halo].to(x.device))
    return left, right


def sum_over_shards(values: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The shards' values summed in shard order on ``device`` (``psum``)."""
    total = values[0].to(device)
    for v in values[1:]:
        total = total + v.to(device)
    return total


def make_sharded_pipeline(
    mesh: Mesh,
    kernel: Callable[..., Dict[str, torch.Tensor]],
    n_inputs: int,
    out_keys: Tuple[str, ...],
    stats_keys: Tuple[str, ...] = (),
    axis_name: str = "data",
    halo: int = 0,
):
    """A step running ``kernel`` on each shard of the event axis.

    ``kernel(*arrays[, left_halo=, right_halo=])`` must return a dict whose
    keys include ``out_keys``; entries named in ``stats_keys`` are scalars,
    summed over the shards in shard order and returned once, on the mesh's
    first device; everything else comes back as a :class:`ShardedTensor`
    on the event axis like the inputs. The step takes ``n_inputs`` tensors,
    arrays or ShardedTensors whose leading dimension is a multiple of the
    shard count.
    """
    stats = set(stats_keys)
    devs = mesh.shard_devices(axis_name)

    def step(*arrays: Any) -> Dict[str, Any]:
        if len(arrays) != n_inputs:
            raise TypeError(f"sharded step takes {n_inputs} inputs, got {len(arrays)}")
        sharded = [shard_rows(a, mesh, axis_name).shards for a in arrays]
        halos = shard_halo_exchange(sharded[0], halo) if halo > 0 else None
        outs = []
        for i, dev in enumerate(devs):
            kwargs = {}
            if halos is not None:
                kwargs = {"left_halo": halos[0][i], "right_halo": halos[1][i]}
            with on_device(dev):
                out = kernel(*(s[i] for s in sharded), **kwargs)
            missing = set(out_keys) - set(out)
            if missing:
                raise ValueError(f"sharded kernel missing outputs: {sorted(missing)}")
            outs.append(out)
        return {
            k: (sum_over_shards([o[k] for o in outs], devs[0]) if k in stats
                else ShardedTensor([o[k] for o in outs], mesh, axis_name))
            for k in out_keys
        }

    return step


def shard_table_arrays(
    mesh: Mesh, *arrays: Any, axis_name: str = "data"
) -> Tuple[ShardedTensor, ...]:
    """Pad leading axes to a multiple of the shard count and split them
    onto the mesh's devices. Returns the sharded tensors (padding rows are
    zero; carry a validity column if the kernel must ignore them)."""
    n_shards = mesh.shape[axis_name]
    n = int(np.asarray(arrays[0]).shape[0])
    padded_n = pad_to_shards(n, n_shards)
    out = []
    for arr in arrays:
        arr = np.asarray(arr)
        if arr.shape[0] != n:
            raise ValueError("all arrays must share the leading event axis")
        if padded_n != n:
            pad = [(0, padded_n - n)] + [(0, 0)] * (arr.ndim - 1)
            arr = np.pad(arr, pad)
        out.append(shard_rows(arr, mesh, axis_name))
    return tuple(out)
