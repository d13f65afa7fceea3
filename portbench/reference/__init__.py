"""The plain references of the benchmark and the comparison they share.

``<kind>.py`` holds the reference of the traffic kind ``<kind>``: plain
PyTorch and NumPy that imports nothing of the program, computed from the
inputs the benchmark made itself. ``Tally`` compares what the program
produced with it and keeps three numbers, each with where its worst lies:

- ``structure``: tables, columns or per-event cells whose names, dtypes or
  lengths differ (compared exactly);
- ``exact_cells``: integer values, and the places of NaN, that differ
  (compared exactly);
- ``f32_gap``: the largest |program - reference| / max(|reference|, 1)
  over the float values.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

CHECKS = ("structure", "exact_cells", "f32_gap")


class Tally:
    def __init__(self) -> None:
        self.found: Dict[str, Tuple[float, str]] = {k: (0, "-") for k in CHECKS}

    def count(self, key: str, n: int, where: str) -> None:
        if n:
            total = self.found[key][0] + int(n)
            self.found[key] = (total, where)

    def gap(self, value: float, where: str) -> None:
        if value > self.found["f32_gap"][0]:
            self.found["f32_gap"] = (float(value), where)

    def arrays(self, ref: np.ndarray, out: np.ndarray, where: str) -> None:
        ref, out = np.asarray(ref), np.asarray(out)
        if ref.dtype != out.dtype or ref.shape != out.shape:
            self.count("structure", 1, f"{where}: {out.dtype}{out.shape} for "
                                       f"{ref.dtype}{ref.shape}")
            return
        if not np.issubdtype(ref.dtype, np.floating):
            self.count("exact_cells", int(np.sum(ref != out)), where)
            return
        a, b = ref.astype(np.float64), out.astype(np.float64)
        nan_a, nan_b = np.isnan(a), np.isnan(b)
        self.count("exact_cells", int(np.sum(nan_a != nan_b)), f"{where} (NaN)")
        both = ~(nan_a | nan_b)
        if both.any():
            d = np.abs(b[both] - a[both]) / np.maximum(np.abs(a[both]), 1.0)
            self.gap(float(d.max()), where)

    def columns(self, ref: dict, out: dict, where: str) -> None:
        """Two tables as dicts of column arrays."""
        if list(ref) != list(out):
            self.count("structure", 1, f"{where}: columns {list(out)}")
            return
        for k in ref:
            self.arrays(ref[k], out[k], f"{where}.{k}")

    def frame(self, ref, out, where: str) -> None:
        """Two DataFrames column by column with their dtypes; per-event
        array cells by their lengths and dtypes, then their values."""
        if list(ref.columns) != list(out.columns) or len(ref) != len(out):
            self.count("structure", 1, f"{where}: columns {list(out.columns)} x {len(out)}")
            return
        for col in ref.columns:
            a, b = ref[col], out[col]
            tag = f"{where}.{col}"
            if a.dtype != b.dtype:
                self.count("structure", 1, f"{tag}: dtype {b.dtype} for {a.dtype}")
            elif a.dtype == object:
                ca = [np.asarray(c) for c in a]
                cb = [np.asarray(c) for c in b]
                if [len(c) for c in ca] != [len(c) for c in cb] or \
                        {c.dtype for c in ca} != {c.dtype for c in cb}:
                    self.count("structure", 1, f"{tag}: cell lengths or dtypes")
                elif ca:
                    self.arrays(np.concatenate(ca), np.concatenate(cb), tag)
            else:
                self.arrays(a.to_numpy(), b.to_numpy(), tag)

    def result(self) -> Dict[str, Tuple[float, str]]:
        return dict(self.found)
