"""Per-plugin execution statistics.

Behavioral analog of the reference stats collector
(reference: waveform_analysis/core/plugins/core/stats.py:59-544): records per
execution (duration, cache hit, input/output sizes, errors) with modes
off/basic/detailed, aggregated into per-plugin statistics for
``Context.get_performance_report`` and the DependencyAnalyzer.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ExecutionRecord:
    plugin_name: str
    run_id: str
    duration_s: float
    cache_hit: bool = False
    success: bool = True
    error: Optional[str] = None
    input_mb: Optional[float] = None
    output_mb: Optional[float] = None
    timestamp: float = field(default_factory=time.time)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "plugin_name": self.plugin_name,
            "run_id": self.run_id,
            "duration_s": self.duration_s,
            "cache_hit": self.cache_hit,
            "success": self.success,
            "error": self.error,
            "input_mb": self.input_mb,
            "output_mb": self.output_mb,
            "timestamp": self.timestamp,
        }


@dataclass
class PluginStatistics:
    plugin_name: str
    n_executions: int = 0
    n_cache_hits: int = 0
    n_errors: int = 0
    total_duration_s: float = 0.0
    max_duration_s: float = 0.0
    total_output_mb: float = 0.0

    @property
    def avg_duration_s(self) -> float:
        return self.total_duration_s / self.n_executions if self.n_executions else 0.0

    @property
    def cache_hit_rate(self) -> float:
        total = self.n_executions + self.n_cache_hits
        return self.n_cache_hits / total if total else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "plugin_name": self.plugin_name,
            "n_executions": self.n_executions,
            "n_cache_hits": self.n_cache_hits,
            "n_errors": self.n_errors,
            "total_duration_s": self.total_duration_s,
            "avg_duration_s": self.avg_duration_s,
            "max_duration_s": self.max_duration_s,
            "cache_hit_rate": self.cache_hit_rate,
            "total_output_mb": self.total_output_mb,
        }


class PluginStatsCollector:
    """Collects execution records; modes: off | basic | detailed."""

    def __init__(self, mode: str = "off") -> None:
        if mode not in ("off", "basic", "detailed"):
            raise ValueError(f"stats mode must be off|basic|detailed, got {mode!r}")
        self.mode = mode
        self._records: List[ExecutionRecord] = []
        self._stats: Dict[str, PluginStatistics] = {}
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    def record_execution(
        self,
        plugin_name: str,
        run_id: str,
        duration_s: float,
        cache_hit: bool = False,
        success: bool = True,
        error: Optional[str] = None,
        input_mb: Optional[float] = None,
        output_mb: Optional[float] = None,
    ) -> None:
        if not self.enabled:
            return
        rec = ExecutionRecord(
            plugin_name=plugin_name,
            run_id=run_id,
            duration_s=duration_s,
            cache_hit=cache_hit,
            success=success,
            error=error,
            input_mb=input_mb if self.mode == "detailed" else None,
            output_mb=output_mb if self.mode == "detailed" else None,
        )
        with self._lock:
            self._records.append(rec)
            st = self._stats.setdefault(plugin_name, PluginStatistics(plugin_name))
            if cache_hit:
                st.n_cache_hits += 1
            else:
                st.n_executions += 1
                st.total_duration_s += duration_s
                st.max_duration_s = max(st.max_duration_s, duration_s)
                if output_mb:
                    st.total_output_mb += output_mb
            if not success:
                st.n_errors += 1

    def get_statistics(self, plugin_name: Optional[str] = None) -> Any:
        with self._lock:
            if plugin_name is not None:
                return self._stats.get(plugin_name)
            return dict(self._stats)

    def get_records(self, plugin_name: Optional[str] = None) -> List[ExecutionRecord]:
        with self._lock:
            if plugin_name is None:
                return list(self._records)
            return [r for r in self._records if r.plugin_name == plugin_name]

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._stats.clear()

    def report(self) -> str:
        stats = self.get_statistics()
        if not stats:
            return "(no plugin statistics collected)"
        lines = [
            f"{'plugin':<28} {'runs':>5} {'hits':>5} {'errs':>5} "
            f"{'total(s)':>10} {'avg(s)':>10} {'max(s)':>10}"
        ]
        for name, st in sorted(stats.items(), key=lambda kv: -kv[1].total_duration_s):
            lines.append(
                f"{name:<28} {st.n_executions:>5} {st.n_cache_hits:>5} "
                f"{st.n_errors:>5} {st.total_duration_s:>10.4f} "
                f"{st.avg_duration_s:>10.6f} {st.max_duration_s:>10.6f}"
            )
        return "\n".join(lines)


def estimate_mb(obj: Any) -> Optional[float]:
    """Best-effort size estimate of arrays/Tables in MB."""
    try:
        import numpy as np

        from waveformanalysis_tpu_torch.dtypes.table import Table

        if isinstance(obj, Table):
            return sum(np.asarray(v).nbytes for v in obj.to_host().columns.values()) / 1e6
        if hasattr(obj, "nbytes"):
            return float(obj.nbytes) / 1e6
        if isinstance(obj, (list, tuple)):
            vals = [estimate_mb(o) for o in obj]
            vals = [v for v in vals if v is not None]
            return sum(vals) if vals else None
    except Exception:
        pass
    return None
