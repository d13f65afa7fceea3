"""Device-side compaction of fixed-capacity slot tables.

Port of ``waveformanalysis_tpu/ops/compact.py``. The peak/hit kernels emit
(n, K) slot tables (K = device capacity per waveform) where typically only
~1 slot per row is valid. ``compact_slots`` front-packs the valid slots on
the device so the host copies only real rows (the first ``count`` rows of
the matrix); ``decode_slot_matrix`` splits a copied matrix back into
columns.

Used by the fused bundle executor (context/fusion.py) and the standalone
hit / hit_threshold plugin computes.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import to_numpy


def compact_slots(stage_out, fields: Sequence[str]):
    """Front-pack valid (n, K) slots into an (n*K, F+1) int32 matrix.

    Column 0 is the source-row index; columns 1.. are ``fields`` in order,
    float32 leaves bit-cast to int32. Valid slots land in row-major order,
    exactly the order ``np.nonzero(valid)`` yields on the host
    (``torch.nonzero`` returns indices in that order on the CPU and on
    CUDA), so downstream columns are bit-identical to the host-compaction
    path. Rows past the returned count are zero. Returns ``(mat, count)``
    with ``count`` a Python int (``torch.nonzero`` has already waited for
    the device to know it).
    """
    valid = stage_out["valid"]
    n, K = valid.shape
    dev = valid.device
    flat_idx = torch.nonzero(valid.reshape(-1), as_tuple=True)[0]
    count = flat_idx.numel()
    cols = [torch.div(flat_idx, K, rounding_mode="floor").to(torch.int32)]
    for f in fields:
        leaf = stage_out[f].reshape(-1)[flat_idx]
        if leaf.dtype == torch.float32:
            leaf = leaf.view(torch.int32)
        else:
            leaf = leaf.to(torch.int32)
        cols.append(leaf)
    mat = torch.zeros((n * K, len(fields) + 1), dtype=torch.int32, device=dev)
    mat[:count] = torch.stack(cols, dim=1)
    return mat, count


def decode_slot_matrix(
    chunk: np.ndarray, fields: Sequence[str], dtypes: Sequence[str]
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Host-side: (rows, {field: column}) from a fetched compact matrix
    (each column contiguous: the batched dispatch binary-searches ``rows``
    for every run's boundaries)."""
    rows = np.ascontiguousarray(chunk[:, 0])
    slots: Dict[str, np.ndarray] = {}
    for j, (f, dt) in enumerate(zip(fields, dtypes)):
        col = np.ascontiguousarray(chunk[:, j + 1])
        slots[f] = col.view(np.float32) if dt == "float32" else col
    return rows, slots


def field_dtypes(stage_out, fields: Sequence[str]) -> Tuple[str, ...]:
    """NumPy dtype names of the fields (``decode_slot_matrix``'s input)."""
    return tuple(str(stage_out[f].dtype).replace("torch.", "") for f in fields)


def compact_rows(
    stage_out, fields: Sequence[str]
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Compact on the device, copy only the valid rows to the host, decode."""
    mat, count = compact_slots(stage_out, fields)
    return decode_slot_matrix(
        to_numpy(mat[:count]), fields, field_dtypes(stage_out, fields)
    )
