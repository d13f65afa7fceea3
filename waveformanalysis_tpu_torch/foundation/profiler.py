"""Lightweight hierarchical wall-clock profiler.

Behavioral analog of the reference Profiler
(reference: waveform_analysis/core/foundation/utils.py:92): context-manager
timers aggregated per key, with a text summary. Extended here with an optional
device-sync hook so CUDA work is measured honestly: kernel launches return
before the device finishes, so timing without a sync would under-report
kernels.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional


@dataclass
class _TimerStats:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0
    last_s: float = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)
        self.last_s = dt

    def to_dict(self) -> Dict[str, Any]:
        avg = self.total_s / self.count if self.count else 0.0
        return {
            "count": self.count,
            "total_s": self.total_s,
            "avg_s": avg,
            "min_s": self.min_s if self.count else 0.0,
            "max_s": self.max_s,
            "last_s": self.last_s,
        }


class Profiler:
    """Aggregating timer. Thread-safe; keys are free-form strings.

    Usage::

        prof = Profiler()
        with prof.time("plugin.basic_features.compute"):
            ...
        print(prof.summary())
    """

    def __init__(self, enabled: bool = True, sync_device: bool = False) -> None:
        self.enabled = enabled
        self.sync_device = sync_device
        self._stats: Dict[str, _TimerStats] = {}
        self._lock = threading.Lock()

    @contextmanager
    def time(self, key: str, result: Any = None) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync_device and result is not None:
                _block_until_ready(result)
            dt = time.perf_counter() - t0
            with self._lock:
                self._stats.setdefault(key, _TimerStats()).add(dt)

    def record(self, key: str, seconds: float) -> None:
        """Record an externally measured duration."""
        with self._lock:
            self._stats.setdefault(key, _TimerStats()).add(seconds)

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            st = self._stats.get(key)
            return st.to_dict() if st else None

    def stats(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {k: v.to_dict() for k, v in self._stats.items()}

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()

    def summary(self, sort_by: str = "total_s") -> str:
        rows = sorted(self.stats().items(), key=lambda kv: -kv[1].get(sort_by, 0.0))
        if not rows:
            return "(no profiling data)"
        width = max(len(k) for k, _ in rows)
        lines = [f"{'key'.ljust(width)}  count    total(s)      avg(s)      max(s)"]
        for k, st in rows:
            lines.append(
                f"{k.ljust(width)}  {st['count']:5d}  {st['total_s']:10.4f}"
                f"  {st['avg_s']:10.6f}  {st['max_s']:10.6f}"
            )
        return "\n".join(lines)


def _block_until_ready(obj: Any) -> None:
    """``torch.cuda.synchronize()`` when ``obj`` holds a CUDA tensor (in a
    dict, list, tuple or Table); nothing otherwise."""
    import torch

    stack = [obj]
    while stack:
        o = stack.pop()
        if isinstance(o, torch.Tensor):
            if o.is_cuda:
                torch.cuda.synchronize(o.device)
                return
        elif isinstance(o, dict):
            stack.extend(o.values())
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
        elif hasattr(o, "columns"):  # Table
            stack.extend(o.columns.values())
