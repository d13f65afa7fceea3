"""Distributed time-sorted merge: records stay sharded across the mesh.

Port of ``waveformanalysis_tpu/parallel/sorted_merge.py``, the same
algorithm, so that rows with equal keys land in the same order as there:
a block odd-even transposition sort (merge-split) over the mesh axis.

1. Each shard stable-sorts its rows locally by the composite key (first key
   primary): successive stable ``torch.sort`` passes, least significant
   key first.
2. ``n_shards`` phases of neighbour merge-split (parity = phase % 2): in
   even phases shard pairs (0,1), (2,3), ... meet, in odd phases (1,2),
   (3,4), ... Each pair concatenates its blocks lower-shard-first on the
   lower shard's device, stable-sorts the doubled block, keeps the low half
   there and copies the high half to the upper shard's device. After the
   phases the concatenation of the shards is globally sorted, every shard
   still holding its row count.

Every step is a sort of two shards' rows and one shard-sized copy between
devices; no device holds more than two shards of rows. Keys stay native
int64 (timestamps in picoseconds).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import on_device
from waveformanalysis_tpu_torch.parallel.mesh import Mesh, ShardedTensor, shard_rows

SORTED_MERGE_VERSION = "sorted-merge-v1"

Cols = Dict[str, torch.Tensor]


def _lexsort_order(cols: Cols, key_names: Sequence[str]) -> torch.Tensor:
    """Stable sort order; the first name in ``key_names`` is the primary
    key (``np.lexsort`` of the keys in reverse)."""
    order = None
    for name in reversed(list(key_names)):
        v = cols[name] if order is None else cols[name][order]
        idx = torch.sort(v, stable=True).indices
        order = idx if order is None else order[idx]
    return order


def _apply_order(cols: Cols, order: torch.Tensor) -> Cols:
    return {k: v[order] for k, v in cols.items()}


def make_sharded_time_sort(
    mesh: Mesh,
    key_names: Sequence[str],
    axis: str = "data",
) -> Callable[[Dict[str, Any]], Dict[str, ShardedTensor]]:
    """Build the sharded sort for a fixed mesh, axis and key set.

    Returns ``fn(cols) -> cols``: ``cols`` maps names to equal-length
    columns (tensors, arrays or ShardedTensors on ``mesh``, any rank, a
    multiple of the shard count long); the result holds the same columns as
    ShardedTensors, globally sorted by ``key_names`` (first = primary)
    across the shard order.
    """
    devs = mesh.shard_devices(axis)
    n_shards = len(devs)
    key_names = list(key_names)

    def merge_phase(shards: List[Cols], parity: int) -> None:
        for a in range(parity, n_shards - 1, 2):
            lo, hi = shards[a], shards[a + 1]
            m = int(next(iter(lo.values())).shape[0])
            with on_device(devs[a]):
                cat = {k: torch.cat([lo[k], hi[k].to(devs[a])]) for k in lo}
                order = _lexsort_order(cat, key_names)
                shards[a] = _apply_order(cat, order[:m])
                shards[a + 1] = {k: v.to(devs[a + 1])
                                 for k, v in _apply_order(cat, order[m:]).items()}

    def fn(cols: Dict[str, Any]) -> Dict[str, ShardedTensor]:
        names = list(cols)
        split = {k: shard_rows(v, mesh, axis).shards for k, v in cols.items()}
        shards: List[Cols] = []
        for i, dev in enumerate(devs):
            with on_device(dev):
                local = {k: split[k][i] for k in names}
                shards.append(_apply_order(local, _lexsort_order(local, key_names)))
        if n_shards > 1:
            for phase in range(n_shards):
                merge_phase(shards, phase % 2)
        return {k: ShardedTensor([s[k] for s in shards], mesh, axis) for k in names}

    return fn


def _sortable(arr: np.ndarray, is_key: bool) -> Tuple[torch.Tensor, Callable]:
    """``arr`` as a tensor torch sorts and gathers, and the function that
    turns the sorted host copy back into ``arr``'s dtype: unsigned payload
    columns travel as the signed type of their width, unsigned keys widen to
    a signed type that keeps their order."""
    dt = arr.dtype
    arr = np.require(arr, requirements=["C", "W"])
    if dt.kind not in "biuf":
        raise TypeError(f"sharded_time_sort: column of dtype {dt} is not numeric")
    if dt.kind != "u" or dt == np.uint8:
        return torch.from_numpy(arr), lambda a: a
    if not is_key:
        signed = np.dtype(f"i{dt.itemsize}")
        return (torch.from_numpy(arr.view(signed)),
                lambda a: a.view(dt))
    if dt.itemsize >= 8:
        raise TypeError(f"sharded_time_sort: {dt} keys have no signed type to sort in")
    wide = np.dtype(f"i{2 * dt.itemsize}")
    return torch.from_numpy(arr.astype(wide)), lambda a: a.astype(dt)


def sharded_time_sort(
    cols: Dict[str, np.ndarray],
    key_names: Sequence[str],
    mesh: Mesh,
    axis: str = "data",
    pad_key: str = "timestamp",
) -> Dict[str, np.ndarray]:
    """Host-convenience wrapper: pad to the shard multiple, sort, unpad.

    Padding rows carry the maximum key value in ``pad_key`` (0 in every
    other column) so they sort to the global tail and slice off cleanly.
    Host arrays in, host arrays out; the sort itself runs sharded on the
    mesh (``make_sharded_time_sort``).
    """
    names = list(cols.keys())
    n = len(cols[names[0]])
    if n == 0:
        return {k: np.asarray(v) for k, v in cols.items()}
    n_shards = mesh.shape[axis]
    padded_n = ((n + n_shards - 1) // n_shards) * n_shards
    pad = padded_n - n

    tensors, restore = {}, {}
    for k in names:
        arr = np.asarray(cols[k])
        if pad:
            fill_value = (
                np.iinfo(arr.dtype).max
                if k == pad_key and np.issubdtype(arr.dtype, np.integer)
                else 0
            )
            fill = np.full((pad,) + arr.shape[1:], fill_value, arr.dtype)
            arr = np.concatenate([arr, fill])
        tensors[k], restore[k] = _sortable(arr, k in key_names)
    out = make_sharded_time_sort(mesh, key_names, axis=axis)(tensors)
    return {k: restore[k](out[k].numpy()[:n]) for k in names}
