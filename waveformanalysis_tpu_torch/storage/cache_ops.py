"""Cache observability and maintenance suite.

Behavioral analog of the reference cache-ops modules
(reference: waveform_analysis/core/storage/cache_analyzer.py:94,
cache_cleaner.py:65, cache_diagnostics.py:70, cache_statistics.py):

- CacheAnalyzer: scan entries with size/age/version/lineage metadata;
- CacheCleaner: plan/preview/execute deletion by age, size budget, storage
  version mismatch, or failed integrity;
- CacheDiagnostics: orphans (bin without metadata and vice versa), checksum
  failures, version mismatches;
- CacheStatistics: hit/miss tracking (wraps the runtime cache manager).

Port of ``waveformanalysis_tpu/storage/cache_ops.py``. One repair: the
fused program's slot-capacity hints (``{key}-caphint``, metadata with no
payload by design, ``context/fusion.py::_hint_key``) are not orphans; the
JAX package's diagnostics report every one of them as orphan metadata, so
its ``waveform-cache diagnose`` fails on any cache a fused run wrote.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

# key suffix of the fused program's slot-capacity hint records (metadata
# only; context/fusion.py writes them)
HINT_SUFFIX = "-caphint"


@dataclass
class CacheEntry:
    key: str
    run_id: Optional[str]
    size_bytes: int
    created_at: Optional[str]
    age_s: Optional[float]
    storage_version: Optional[str]
    data_format: Optional[str]
    n_rows: Optional[int]
    has_lineage: bool
    plugin_class: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


def _age_seconds(created_at: Optional[str]) -> Optional[float]:
    if not created_at:
        return None
    try:
        created = datetime.fromisoformat(created_at)
        if created.tzinfo is None:
            created = created.replace(tzinfo=timezone.utc)
        return (datetime.now(timezone.utc) - created).total_seconds()
    except ValueError:
        return None


class CacheAnalyzer:
    """Scans a storage backend's entries for one or all runs."""

    def __init__(self, storage: Any) -> None:
        self.storage = storage

    def list_runs(self) -> List[str]:
        work_dir = getattr(self.storage, "work_dir", None)
        if not work_dir:
            return []
        root = Path(work_dir)
        if not root.exists():
            return []
        subdir = getattr(self.storage, "data_subdir", "_cache")
        return sorted(
            child.name for child in root.iterdir()
            if child.is_dir() and (child / subdir).exists()
        )

    def scan(self, run_id: Optional[str] = None) -> List[CacheEntry]:
        runs = [run_id] if run_id is not None else (self.list_runs() or [None])
        entries: List[CacheEntry] = []
        for rid in runs:
            for key in self.storage.list_keys(rid):
                meta = self.storage.get_metadata(key, rid) or {}
                created = meta.get("created_at")
                lineage = meta.get("lineage") or {}
                entries.append(CacheEntry(
                    key=key,
                    run_id=rid,
                    size_bytes=self.storage.get_size(key, rid),
                    created_at=created,
                    age_s=_age_seconds(created),
                    storage_version=meta.get("storage_version"),
                    data_format=meta.get("format") or meta.get("type"),
                    n_rows=meta.get("n_rows"),
                    has_lineage=bool(lineage),
                    plugin_class=lineage.get("plugin_class"),
                ))
        return entries

    def summary(self, run_id: Optional[str] = None) -> Dict[str, Any]:
        entries = self.scan(run_id)
        total = sum(e.size_bytes for e in entries)
        by_run: Dict[str, int] = {}
        for e in entries:
            by_run[e.run_id or ""] = by_run.get(e.run_id or "", 0) + e.size_bytes
        return {
            "n_entries": len(entries),
            "total_bytes": total,
            "total_mb": total / 1e6,
            "by_run_bytes": by_run,
            "oldest_age_s": max((e.age_s or 0) for e in entries) if entries else 0,
        }

    def statistics(self, run_id: Optional[str] = None) -> "CacheStatsSnapshot":
        """Reference-shaped cache statistics snapshot
        (reference: cache_statistics.py CacheStatsCollector.collect):
        totals, per-run and per-data-name breakdowns, largest/oldest/newest
        entries, compression counts."""
        entries = self.scan(run_id)
        by_run: Dict[str, Dict[str, Any]] = {}
        by_data: Dict[str, Dict[str, Any]] = {}
        compressed = 0
        for e in entries:
            rid = e.run_id or ""
            r = by_run.setdefault(rid, {"entries": 0, "bytes": 0})
            r["entries"] += 1
            r["bytes"] += e.size_bytes
            name = _data_name_from_key(e.key, rid)
            d = by_data.setdefault(name, {"entries": 0, "bytes": 0})
            d["entries"] += 1
            d["bytes"] += e.size_bytes
            if e.data_format and "compress" in str(e.data_format):
                compressed += 1
        total = sum(e.size_bytes for e in entries)
        aged = [e for e in entries if e.age_s is not None]
        return CacheStatsSnapshot(
            total_runs=len(by_run),
            total_entries=len(entries),
            total_size_bytes=total,
            compressed_entries=compressed,
            avg_entry_size_bytes=(total / len(entries)) if entries else 0.0,
            largest_entry=max(entries, key=lambda e: e.size_bytes, default=None),
            oldest_entry=max(aged, key=lambda e: e.age_s, default=None),
            newest_entry=min(aged, key=lambda e: e.age_s, default=None),
            by_run=by_run,
            by_data_type=by_data,
        )

    def report(self, run_id: Optional[str] = None) -> str:
        entries = sorted(self.scan(run_id), key=lambda e: -e.size_bytes)
        s = self.summary(run_id)
        lines = [
            f"Cache: {s['n_entries']} entries, {s['total_mb']:.2f} MB",
            f"{'key':<48} {'run':<12} {'MB':>8} {'rows':>8} {'age(h)':>8}",
        ]
        for e in entries[:50]:
            age_h = (e.age_s or 0) / 3600
            lines.append(
                f"{e.key:<48} {str(e.run_id or ''):<12} "
                f"{e.size_bytes / 1e6:>8.2f} {str(e.n_rows or ''):>8} {age_h:>8.2f}"
            )
        return "\n".join(lines)


def _data_name_from_key(key: str, run_id: str) -> str:
    """Data name from a ``{run_id}-{data_name}-{hash8}`` cache key
    (cache-domain contract, context/cache_domain key_for)."""
    stem = key
    if run_id and stem.startswith(f"{run_id}-"):
        stem = stem[len(run_id) + 1:]
    # strip the trailing -hash8 (legacy multi-channel keys keep their
    # _ch{i} suffix inside the hash part and fall away with it)
    parts = stem.rsplit("-", 1)
    name = parts[0] if len(parts) == 2 else stem
    return name or stem


def human_size(n_bytes: float) -> str:
    val = float(n_bytes)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if val < 1024.0 or unit == "TB":
            return f"{val:.1f} {unit}"
        val /= 1024.0
    return f"{val:.1f} TB"


@dataclass
class CacheStatsSnapshot:
    """Point-in-time cache statistics
    (reference: cache_statistics.py CacheStatistics dataclass)."""

    total_runs: int
    total_entries: int
    total_size_bytes: int
    compressed_entries: int
    avg_entry_size_bytes: float
    largest_entry: Optional[CacheEntry]
    oldest_entry: Optional[CacheEntry]
    newest_entry: Optional[CacheEntry]
    by_run: Dict[str, Dict[str, Any]]
    by_data_type: Dict[str, Dict[str, Any]]

    @property
    def total_size_human(self) -> str:
        return human_size(self.total_size_bytes)

    @property
    def compression_ratio(self) -> float:
        return (self.compressed_entries / self.total_entries
                if self.total_entries else 0.0)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "total_runs": self.total_runs,
            "total_entries": self.total_entries,
            "total_size_bytes": self.total_size_bytes,
            "total_size_human": self.total_size_human,
            "compressed_entries": self.compressed_entries,
            "compression_ratio": self.compression_ratio,
            "avg_entry_size_bytes": self.avg_entry_size_bytes,
            "largest_entry": self.largest_entry.to_dict()
            if self.largest_entry else None,
            "oldest_entry": self.oldest_entry.to_dict()
            if self.oldest_entry else None,
            "newest_entry": self.newest_entry.to_dict()
            if self.newest_entry else None,
            "by_run": self.by_run,
            "by_data_type": self.by_data_type,
        }


@dataclass
class CleanPlan:
    to_delete: List[CacheEntry] = field(default_factory=list)
    reasons: Dict[str, str] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(e.size_bytes for e in self.to_delete)

    def preview(self) -> str:
        lines = [
            f"Clean plan: {len(self.to_delete)} entries, "
            f"{self.total_bytes / 1e6:.2f} MB"
        ]
        for e in self.to_delete:
            lines.append(f"  {e.key} ({self.reasons.get(e.key, '')})")
        return "\n".join(lines)


class CacheCleaner:
    """Plans and executes cache deletion by policy
    (reference: cache_cleaner.py:65)."""

    def __init__(self, storage: Any) -> None:
        self.storage = storage
        self.analyzer = CacheAnalyzer(storage)

    def plan(
        self,
        run_id: Optional[str] = None,
        max_age_s: Optional[float] = None,
        max_total_bytes: Optional[int] = None,
        storage_version: Optional[str] = None,
        failed_integrity: bool = False,
        data_name: Optional[str] = None,
        strategy: str = "oldest",
        keep_recent_s: Optional[float] = None,
    ) -> CleanPlan:
        """Build a deletion plan.

        strategy orders size-budget eviction: "oldest" (default) evicts
        oldest-first, "largest" evicts biggest-first (reference
        cache_cleaner.py strategies LRU/LARGEST). data_name restricts the
        whole plan to one data type; keep_recent_s protects entries younger
        than the window from every criterion (reference keep_recent_days).
        """
        if strategy not in ("oldest", "largest"):
            raise ValueError(f"unknown cleanup strategy {strategy!r}")
        entries = self.analyzer.scan(run_id)
        if data_name is not None:
            entries = [
                e for e in entries
                if _data_name_from_key(e.key, e.run_id or "") == data_name
            ]
        plan = CleanPlan()
        selected = set()

        if max_age_s is not None:
            for e in entries:
                if e.age_s is not None and e.age_s > max_age_s:
                    selected.add(e.key)
                    plan.reasons[e.key] = f"age {e.age_s / 3600:.1f}h > limit"

        if data_name is not None and max_age_s is None and \
                max_total_bytes is None and storage_version is None and \
                not failed_integrity:
            # pure data-type cleanup: everything of that type goes
            for e in entries:
                selected.add(e.key)
                plan.reasons[e.key] = f"data type '{data_name}'"

        if storage_version is not None:
            for e in entries:
                if e.storage_version != storage_version:
                    selected.add(e.key)
                    plan.reasons[e.key] = (
                        f"storage version {e.storage_version} != {storage_version}"
                    )

        if failed_integrity and hasattr(self.storage, "verify_integrity"):
            runs = [run_id] if run_id else self.analyzer.list_runs()
            for rid in runs:
                report = self.storage.verify_integrity(rid)
                for key in report.get("corrupt", []):
                    selected.add(key)
                    plan.reasons[key] = "failed integrity check"

        if max_total_bytes is not None:
            total = sum(e.size_bytes for e in entries)
            if total > max_total_bytes:
                remaining = [e for e in entries if e.key not in selected]
                if strategy == "largest":
                    remaining.sort(key=lambda e: -e.size_bytes)
                else:  # oldest first
                    remaining.sort(key=lambda e: -(e.age_s or 0))
                for e in remaining:
                    if total <= max_total_bytes:
                        break
                    selected.add(e.key)
                    plan.reasons[e.key] = f"size budget eviction ({strategy})"
                    total -= e.size_bytes

        if keep_recent_s is not None:
            protected = {
                e.key for e in entries
                if e.age_s is not None and e.age_s < keep_recent_s
            }
            for key in protected & selected:
                selected.discard(key)
                plan.reasons.pop(key, None)

        plan.to_delete = [e for e in entries if e.key in selected]
        return plan

    def execute(self, plan: CleanPlan, dry_run: bool = False) -> int:
        if dry_run:
            return len(plan.to_delete)
        n = 0
        for e in plan.to_delete:
            try:
                self.storage.delete(e.key, e.run_id)
                n += 1
            except Exception as ex:
                logger.warning("Failed to delete %s: %s", e.key, ex)
        return n

    def clean(self, run_id: Optional[str] = None, **policy: Any) -> int:
        return self.execute(self.plan(run_id=run_id, **policy))


class CacheDiagnostics:
    """Detects orphans, checksum failures, and version mismatches
    (reference: cache_diagnostics.py:70)."""

    def __init__(self, storage: Any) -> None:
        self.storage = storage
        self.analyzer = CacheAnalyzer(storage)

    def diagnose(self, run_id: Optional[str] = None) -> Dict[str, Any]:
        report: Dict[str, Any] = {
            "orphan_payloads": [],
            "orphan_metadata": [],
            "corrupt": [],
            "version_mismatch": [],
            "healthy": 0,
        }
        from waveformanalysis_tpu_torch.storage.memmap import STORAGE_VERSION

        runs = [run_id] if run_id is not None else (self.analyzer.list_runs() or [None])
        for rid in runs:
            work_dir = getattr(self.storage, "work_dir", None)
            subdir = getattr(self.storage, "data_subdir", "_cache")
            if work_dir:
                d = Path(work_dir) / (rid or "") / subdir
                if d.exists():
                    bins = {p.stem for p in d.glob("*.bin")}
                    metas = {p.stem for p in d.glob("*.json")}
                    report["orphan_payloads"] += sorted(bins - metas)
                    report["orphan_metadata"] += sorted(
                        m for m in metas - bins
                        if not (d / f"{m}.parquet").exists()
                        and not (d / f"{m}.pkl").exists()
                        and not m.endswith(HINT_SUFFIX)
                    )
            if hasattr(self.storage, "verify_integrity"):
                integrity = self.storage.verify_integrity(rid)
                report["corrupt"] += integrity.get("corrupt", [])
                report["healthy"] += integrity.get("ok", 0)
            for key in self.storage.list_keys(rid):
                meta = self.storage.get_metadata(key, rid) or {}
                version = meta.get("storage_version")
                if version and version != STORAGE_VERSION:
                    report["version_mismatch"].append(key)
        report["is_healthy"] = not (
            report["orphan_payloads"] or report["orphan_metadata"]
            or report["corrupt"] or report["version_mismatch"]
        )
        return report


class CacheStatistics:
    """Hit/miss bookkeeping over time (reference: cache_statistics.py)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.memory_hits = 0
        self.disk_hits = 0
        self.misses = 0
        self.saves = 0
        self._t0 = time.time()

    def record_hit(self, where: str = "memory") -> None:
        if where == "memory":
            self.memory_hits += 1
        else:
            self.disk_hits += 1

    def record_miss(self) -> None:
        self.misses += 1

    def record_save(self) -> None:
        self.saves += 1

    def merge_runtime(self, runtime_stats: Dict[str, int]) -> None:
        self.memory_hits += runtime_stats.get("memory_hits", 0)
        self.disk_hits += runtime_stats.get("disk_hits", 0)
        self.misses += runtime_stats.get("misses", 0)

    @property
    def hit_rate(self) -> float:
        total = self.memory_hits + self.disk_hits + self.misses
        return (self.memory_hits + self.disk_hits) / total if total else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "memory_hits": self.memory_hits,
            "disk_hits": self.disk_hits,
            "misses": self.misses,
            "saves": self.saves,
            "hit_rate": self.hit_rate,
            "uptime_s": time.time() - self._t0,
        }
