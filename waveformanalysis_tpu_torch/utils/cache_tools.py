"""User-facing cache convenience helpers.

Behavioral analog of the reference cache tools
(reference: waveform_analysis/utils/cache_tools.py): notebook-friendly
wrappers around the cache-ops suite bound to a Context.

Port of ``waveformanalysis_tpu/utils/cache_tools.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from waveformanalysis_tpu_torch.storage.cache_ops import (
    CacheAnalyzer,
    CacheCleaner,
    CacheDiagnostics,
)


def cache_info(context: Any, run_id: Optional[str] = None) -> Dict[str, Any]:
    """Summary of the context's cache."""
    return CacheAnalyzer(context.storage).summary(run_id)


def cache_report(context: Any, run_id: Optional[str] = None) -> str:
    """Printable per-entry cache report."""
    return CacheAnalyzer(context.storage).report(run_id)


def cache_health(context: Any, run_id: Optional[str] = None) -> Dict[str, Any]:
    """Orphan/corruption/version diagnostics."""
    return CacheDiagnostics(context.storage).diagnose(run_id)


def clear_old_entries(context: Any, max_age_hours: float,
                      run_id: Optional[str] = None, dry_run: bool = False) -> int:
    """Delete entries older than the limit; returns the count."""
    cleaner = CacheCleaner(context.storage)
    plan = cleaner.plan(run_id=run_id, max_age_s=max_age_hours * 3600)
    return cleaner.execute(plan, dry_run=dry_run)


def enforce_size_budget(context: Any, max_total_mb: float,
                        run_id: Optional[str] = None, dry_run: bool = False) -> int:
    """Evict oldest entries until the cache fits the budget."""
    cleaner = CacheCleaner(context.storage)
    plan = cleaner.plan(run_id=run_id, max_total_bytes=int(max_total_mb * 1e6))
    return cleaner.execute(plan, dry_run=dry_run)


def clear_run(context: Any, run_id: str) -> int:
    """Remove every cache entry for one run (memory + disk)."""
    return context.clear_cache_for(run_id)
