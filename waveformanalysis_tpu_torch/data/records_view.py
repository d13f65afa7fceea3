"""Zero-copy access to variable-length waves in a wave_pool.

Port of ``waveformanalysis_tpu/data/records_view.py``. Behavioral analog of
the reference RecordsView
(reference: waveform_analysis/core/data/records_view.py:16-382): per-record
wave access by record_id (``waves``), polarity-normalized signal access
(``signals`` = baseline-relative, positive-going), and window slicing.

:meth:`RecordsView.padded_wave_matrix` materializes the pool as a padded
(n_records, L) matrix in one vectorized host gather -- the layout every
batched device kernel consumes -- with per-record true lengths;
:meth:`RecordsView.padded_wave_matrix_device` builds the same matrix with a
torch gather on a device from one upload of the pool. Each build of
either is a ``records.pad`` span of the active profiler, which counts the
matrix's bytes (``records.pad_bytes``), rows (``records.pad_rows``), cells
(``records.pad_cells``: rows times width) and the samples its rows hold
(``records.pad_samples``: the sum of their true lengths).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import resolve_device
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.foundation import profiler
from waveformanalysis_tpu_torch.foundation.constants import pad_to_multiple

# the JAX package pads rows to its TPU lane width; the port keeps the
# multiple so the padded matrices, and the tables built from them, agree
PAD_MULTIPLE = 128


class RecordsView:
    """Read-only view joining a records table with its wave_pool."""

    def __init__(self, records: Union[Table, np.ndarray], wave_pool: np.ndarray) -> None:
        if not isinstance(records, Table):
            records = Table.from_numpy(records)
        self.records = records
        self.wave_pool = np.asarray(wave_pool)
        self._offsets = np.asarray(records["wave_offset"], dtype=np.int64)
        self._lengths = np.asarray(records["event_length"], dtype=np.int64)
        self._baselines = (
            np.asarray(records["baseline"], dtype=np.float64)
            if "baseline" in records
            else np.zeros(len(records))
        )
        self._polarity = (
            np.asarray(records["polarity"], dtype=np.int8)
            if "polarity" in records
            else np.zeros(len(records), dtype=np.int8)
        )
        # record_id -> row: records are usually id == row; otherwise a
        # sorted copy of the ids answers each lookup by binary search
        rid = np.asarray(records["record_id"], dtype=np.int64)
        if len(rid) and not np.array_equal(rid, np.arange(len(rid))):
            self._rid_order = np.argsort(rid, kind="stable")
            self._rid_sorted = rid[self._rid_order]
        else:
            self._rid_order = None

    def __len__(self) -> int:
        return len(self.records)

    def _row(self, record_id: int) -> int:
        if self._rid_order is None:
            return int(record_id)
        i = int(np.searchsorted(self._rid_sorted, int(record_id)))
        if i == len(self._rid_sorted) or self._rid_sorted[i] != int(record_id):
            raise KeyError(int(record_id))
        return int(self._rid_order[i])

    # -- per-record access ----------------------------------------------------

    def waves(self, record_id: int, window: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """Raw uint16 samples of one record (zero-copy pool slice)."""
        i = self._row(record_id)
        off, length = self._offsets[i], self._lengths[i]
        wave = self.wave_pool[off : off + length]
        if window is not None:
            s, e = window
            wave = wave[s:e]
        return wave

    def signals(
        self,
        record_id: int,
        baseline: Optional[float] = None,
        window: Optional[Tuple[int, int]] = None,
    ) -> np.ndarray:
        """Polarity-normalized signal: positive-going pulse in float64.

        negative polarity (or unknown): baseline - wave
        positive polarity:             wave - baseline
        """
        i = self._row(record_id)
        wave = self.waves(record_id, window=window).astype(np.float64)
        b = self._baselines[i] if baseline is None else float(baseline)
        if self._polarity[i] > 0:
            return wave - b
        return b - wave

    def baseline(self, record_id: int) -> float:
        return float(self._baselines[self._row(record_id)])

    # -- batched access ---------------------------------------------------------

    def _width(self, lengths: np.ndarray, pad_to: Optional[int]) -> int:
        max_len = int(lengths.max()) if len(lengths) else 0
        L = pad_to if pad_to is not None else pad_to_multiple(max(max_len, 1), PAD_MULTIPLE)
        if max_len > L:
            raise ValueError(f"pad_to={L} smaller than longest wave {max_len}")
        return L

    def _whole_rows(self, offsets: np.ndarray, lengths: np.ndarray, L: int) -> bool:
        """Every record fills a row of L samples that starts at a multiple
        of L, so the pool read as (-1, L) rows holds each record whole."""
        return bool(L > 0 and np.all(lengths == L) and np.all(offsets % L == 0))

    def padded_wave_matrix(
        self,
        pad_to: Optional[int] = None,
        dtype: Any = np.int16,
        rows: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """All (or selected) waves as one padded matrix.

        Returns (waves[n, L], event_length[n]); padding samples are 0 and the
        length array marks each record's true extent. L pads up to a multiple
        of 128 unless ``pad_to`` overrides it. A uint16 pool cast to int16
        wraps, as numpy's ``astype`` does.
        """
        with profiler.span("records.pad"):
            out, lengths = self._padded_host(pad_to, dtype, rows)
            _count_pad(out.nbytes, out.shape, int(lengths.sum()))
        return out, lengths

    def _padded_host(self, pad_to, dtype, rows) -> Tuple[np.ndarray, np.ndarray]:
        offsets = self._offsets if rows is None else self._offsets[rows]
        lengths = self._lengths if rows is None else self._lengths[rows]
        n = len(offsets)
        if n == 0:
            return np.zeros((0, pad_to or 0), dtype=dtype), np.zeros(0, np.int32)
        L = self._width(lengths, pad_to)
        if self._whole_rows(offsets, lengths, L):
            pool = self.wave_pool[: self.wave_pool.size // L * L].reshape(-1, L)
            if np.array_equal(offsets, np.arange(n, dtype=np.int64) * L):
                # the pool's first n rows, in order: one copy, the cast
                return pool[:n].astype(dtype), lengths.astype(np.int32)
            return pool[offsets // L].astype(dtype, copy=False), lengths.astype(np.int32)
        col = np.arange(L, dtype=np.int64)[None, :]
        idx = offsets[:, None] + col
        mask = col < lengths[:, None]
        idx = np.where(mask, idx, 0)
        out = self.wave_pool[idx].astype(dtype, copy=False)
        out = np.where(mask, out, 0).astype(dtype, copy=False)
        return out, lengths.astype(np.int32)

    def padded_wave_matrix_device(
        self,
        pad_to: Optional[int] = None,
        dtype: Any = None,
        device: Any = "cuda",
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`padded_wave_matrix` built by a torch gather on ``device``.

        Uploads the flat pool once (a uint16 pool as its int16 view, the
        wrapping cast) and gathers the padded matrix there with int64
        indices, so pools past 2^31 samples need no host fallback. Returns
        (waves[n, L] of ``dtype``, int16 by default; event_length[n] int32),
        both on ``device``, equal to the host matrix. ``device="cuda"``
        without a GPU raises.
        """
        with profiler.span("records.pad"):
            out, lens = self._padded_device(pad_to, dtype, device)
            _count_pad(out.numel() * out.element_size(), tuple(out.shape),
                       int(self._lengths.sum()))
        return out, lens

    def _padded_device(self, pad_to, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = resolve_device(device)
        tdtype = _torch_dtype(np.int16 if dtype is None else dtype)
        n = len(self._offsets)
        if n == 0:
            return (torch.zeros((0, pad_to or 0), dtype=tdtype, device=dev),
                    torch.zeros(0, dtype=torch.int32, device=dev))
        L = self._width(self._lengths, pad_to)
        unsigned = self.wave_pool.dtype == np.uint16
        host = self.wave_pool.view(np.int16) if unsigned else self.wave_pool
        pool = torch.from_numpy(np.ascontiguousarray(host)).to(dev)
        lens = torch.from_numpy(self._lengths.astype(np.int32)).to(dev)
        if self._whole_rows(self._offsets, self._lengths, L):
            rows = torch.from_numpy(self._offsets // L).to(dev)
            out = pool[: pool.numel() // L * L].view(-1, L)[rows]
        else:
            offs = torch.from_numpy(self._offsets).to(dev)
            col = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
            mask = col < lens[:, None]
            out = torch.where(mask, pool[torch.where(mask, offs[:, None] + col, 0)],
                              torch.zeros((), dtype=pool.dtype, device=dev))
        if unsigned and tdtype != torch.int16:
            out = out.to(torch.int32) & 0xFFFF  # the unsigned sample values
        return out.to(tdtype), lens

    def signal_matrix(
        self, pad_to: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Polarity-normalized float32 signal matrix (positive-going)."""
        waves, lengths = self.padded_wave_matrix(pad_to=pad_to, dtype=np.float32)
        sign = np.where(self._polarity > 0, 1.0, -1.0).astype(np.float32)
        signal = sign[:, None] * (waves - self._baselines[:, None].astype(np.float32))
        col = np.arange(waves.shape[1])[None, :]
        signal = np.where(col < lengths[:, None], signal, 0.0)
        return signal.astype(np.float32), lengths


def _count_pad(nbytes: int, shape: Tuple[int, int], samples: int) -> None:
    rows, width = shape
    profiler.count("records.pad_bytes", int(nbytes))
    profiler.count("records.pad_rows", int(rows))
    profiler.count("records.pad_cells", int(rows) * int(width))
    profiler.count("records.pad_samples", int(samples))


def _torch_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype
