"""Dynamic worker-count suggestion.

Behavioral analog of the reference DynamicLoadBalancer
(reference: waveform_analysis/core/load_balancer.py:33-296): suggests worker
counts from CPU/memory pressure (psutil when available) and task history,
quantized to power-of-two buckets like the streaming engine
(reference: streaming.py:212-258).

Port of ``waveformanalysis_tpu/execution/load_balancer.py``. It governs
host-side pools only (decode, multi-run fan-out); on the device the analog
knob is the event batch size, exposed via ``suggest_batch_size``.
"""

from __future__ import annotations

import logging
import os
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Optional

logger = logging.getLogger(__name__)

try:
    import psutil  # type: ignore

    _HAS_PSUTIL = True
except ImportError:
    psutil = None
    _HAS_PSUTIL = False


def quantize_workers(n: int, max_workers: Optional[int] = None) -> int:
    """Round down to a power of two (bucketing keeps pool reuse high)."""
    n = max(1, int(n))
    if max_workers:
        n = min(n, max_workers)
    b = 1
    while b * 2 <= n:
        b *= 2
    return b


@dataclass
class TaskRecord:
    duration_s: float
    n_items: int
    workers: int


class DynamicLoadBalancer:
    """Suggests host worker counts from system load + history."""

    def __init__(
        self,
        cpu_threshold: float = 85.0,
        memory_threshold: float = 85.0,
        history_size: int = 32,
    ) -> None:
        self.cpu_threshold = cpu_threshold
        self.memory_threshold = memory_threshold
        self._history: Deque[TaskRecord] = deque(maxlen=history_size)

    # -- system state -----------------------------------------------------------

    def system_load(self) -> Dict[str, float]:
        if _HAS_PSUTIL:
            return {
                "cpu_percent": psutil.cpu_percent(interval=None),
                "memory_percent": psutil.virtual_memory().percent,
            }
        try:
            load1 = os.getloadavg()[0]
            ncpu = os.cpu_count() or 1
            return {"cpu_percent": 100.0 * load1 / ncpu, "memory_percent": 0.0}
        except OSError:  # pragma: no cover
            return {"cpu_percent": 0.0, "memory_percent": 0.0}

    # -- suggestions --------------------------------------------------------------

    def get_optimal_workers(
        self,
        requested: Optional[int] = None,
        max_workers: Optional[int] = None,
        task_kind: str = "",
    ) -> int:
        """Worker suggestion (reference: load_balancer.py:97)."""
        ncpu = os.cpu_count() or 4
        base = requested or ncpu
        load = self.system_load()
        if load["cpu_percent"] > self.cpu_threshold:
            base = max(1, base // 2)
        if load["memory_percent"] > self.memory_threshold:
            base = max(1, base // 2)
        return quantize_workers(base, max_workers=max_workers or ncpu)

    def suggest_batch_size(
        self,
        n_items: int,
        bytes_per_item: int,
        memory_budget_bytes: int = 2 << 30,
        min_batch: int = 1024,
    ) -> int:
        """Device-side analog: how many events per kernel launch."""
        if bytes_per_item <= 0:
            return n_items
        fit = max(min_batch, memory_budget_bytes // bytes_per_item)
        return min(n_items, int(fit))

    # -- history ----------------------------------------------------------------

    def record_task(self, duration_s: float, n_items: int, workers: int) -> None:
        self._history.append(TaskRecord(duration_s, n_items, workers))

    def throughput_by_workers(self) -> Dict[int, float]:
        """items/sec per observed worker count."""
        agg: Dict[int, list] = {}
        for rec in self._history:
            if rec.duration_s > 0:
                agg.setdefault(rec.workers, []).append(rec.n_items / rec.duration_s)
        return {w: sum(v) / len(v) for w, v in agg.items()}

    def best_known_workers(self) -> Optional[int]:
        tp = self.throughput_by_workers()
        if not tp:
            return None
        return max(tp, key=tp.get)
