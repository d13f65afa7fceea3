"""Runtime cache checks used inside the execution loop.

Behavioral analog of the reference RuntimeCacheManager
(reference: waveform_analysis/core/storage/cache_manager.py:26): memory-first,
then disk (with lineage validation handled by the Context cache domain), with
hit/miss statistics feeding the cache-statistics reports.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple


class RuntimeCacheManager:
    """Memory -> disk cache check used by the Context execution loop."""

    def __init__(self, context: Any) -> None:
        self.ctx = context
        self.stats: Dict[str, int] = {
            "memory_hits": 0,
            "disk_hits": 0,
            "misses": 0,
        }

    def check_cache(self, run_id: str, name: str, key: str) -> Tuple[Any, bool]:
        """Returns (data, cache_hit)."""
        data = self.ctx._get_data_from_memory(run_id, name)
        if data is not None:
            self.stats["memory_hits"] += 1
            return data, True
        data = self.ctx.cache_domain.load_from_disk_with_check(run_id, name, key)
        if data is not None:
            self.stats["disk_hits"] += 1
            return data, True
        self.stats["misses"] += 1
        return None, False

    def get_stats(self) -> Dict[str, Any]:
        total = sum(self.stats.values())
        hits = self.stats["memory_hits"] + self.stats["disk_hits"]
        return {
            **self.stats,
            "total": total,
            "hit_rate": (hits / total) if total else 0.0,
        }

    def reset_stats(self) -> None:
        for k in self.stats:
            self.stats[k] = 0
