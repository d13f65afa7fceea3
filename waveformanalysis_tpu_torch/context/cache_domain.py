"""Context cache domain: keys, disk-cache validation, invalidation.

Behavioral analog of the reference cache domain
(reference: waveform_analysis/core/context_cache.py:12-344). The contract:

- cache key = ``{run_id}-{data_name}-{sha1(lineage_json)[:8]}``;
- disk loads validate stored lineage JSON against current lineage before use;
- clearing supports downstream invalidation via the reverse dependency graph.
"""

from __future__ import annotations

import hashlib
import json
import logging
import warnings
from typing import Any, Optional

from waveformanalysis_tpu_torch.context.resolution import collect_downstream

logger = logging.getLogger(__name__)


def lineage_json(lineage: Any) -> str:
    return json.dumps(lineage, sort_keys=True, default=str)


def lineage_hash(lineage: Any) -> str:
    return hashlib.sha1(lineage_json(lineage).encode()).hexdigest()[:8]


class CacheDomain:
    """Disk-cache read/validate/clear helpers used by Context."""

    def __init__(self, context: Any) -> None:
        self.ctx = context

    # -- keys ----------------------------------------------------------------

    def key_for(self, run_id: str, data_name: str) -> str:
        cache_key = (run_id, data_name)
        cached = self.ctx._key_cache.get(cache_key)
        if cached is not None:
            return cached
        h = self.ctx._lineage_hash_cache.get(data_name)
        if h is None:
            h = lineage_hash(self.ctx.get_lineage(data_name))
            self.ctx._lineage_hash_cache[data_name] = h
        key = f"{run_id}-{data_name}-{h}"
        self.ctx._key_cache[cache_key] = key
        return key

    # -- disk loads ----------------------------------------------------------

    def load_from_disk_with_check(self, run_id: str, name: str, key: str) -> Any:
        """Load cached data, but only if stored lineage matches current."""
        self.ctx.execution_domain.wait_for_pending_save(run_id, name)
        storage = self.ctx._get_storage_for_data_name(name)
        if not storage.exists(key, run_id):
            return None
        meta = storage.get_metadata(key, run_id)
        if meta and "lineage" in meta:
            current = self.ctx.get_lineage(name)
            if lineage_json(meta["lineage"]) != lineage_json(current):
                warnings.warn(
                    f"Lineage mismatch for '{name}' in cache. Recomputing.", UserWarning
                )
                return None
        meta = meta or {}
        if meta.get("type") == "dataframe":
            data = storage.load_dataframe(key, run_id)
        else:
            data = storage.load_memmap(key, run_id)
        if data is not None:
            if self.ctx.config.get("show_progress", True):
                print(f"[cache] Loaded '{name}' from disk (run_id: {run_id})")
            self.ctx._set_data(run_id, name, data)
        return data

    def is_disk_cache_valid(self, run_id: str, name: str, key: str) -> bool:
        """Existence + lineage equality, without loading the payload."""
        storage = self.ctx._get_storage_for_data_name(name)
        if not storage.exists(key, run_id):
            return False
        try:
            meta = storage.get_metadata(key, run_id)
        except Exception:
            return False
        if meta and "lineage" in meta:
            return lineage_json(meta["lineage"]) == lineage_json(
                self.ctx.get_lineage(name)
            )
        return True

    def is_cache_hit(self, run_id: str, name: str, load: bool = False) -> bool:
        if self.ctx._get_data_from_memory(run_id, name) is not None:
            return True
        if name not in self.ctx._plugins:
            return False
        self.ctx.execution_domain.wait_for_pending_save(run_id, name)
        key = self.key_for(run_id, name)
        if load:
            _data, hit = self.ctx._cache_manager.check_cache(run_id, name, key)
            return hit
        return self.is_disk_cache_valid(run_id, name, key)

    # -- clearing ------------------------------------------------------------

    def clear_cache_for(
        self,
        run_id: str,
        data_name: Optional[str] = None,
        downstream: bool = False,
        clear_memory: bool = True,
        clear_disk: bool = True,
        verbose: bool = False,
    ) -> int:
        """Clear memory/disk entries; optionally the whole downstream cone."""
        if data_name is None:
            names = list(self.ctx._plugins.keys())
        elif downstream:
            downstream_names = collect_downstream(
                data_name, self.ctx._plugins, self.ctx, run_id
            )
            names = [data_name] + sorted(downstream_names)
        else:
            names = [data_name]

        count = 0
        for name in names:
            if clear_memory:
                mem_key = (run_id, name)
                if mem_key in self.ctx._results:
                    del self.ctx._results[mem_key]
                    self.ctx._results_lineage.pop(mem_key, None)
                    count += 1
                    if verbose:
                        print(f"  cleared memory cache: ({run_id}, {name})")
            if clear_disk:
                try:
                    # an in-flight async save of this key would land AFTER
                    # the delete and resurrect the stale payload (the key is
                    # unchanged for run_config-driven invalidation); settle
                    # it first so the delete is final
                    self.ctx.execution_domain.wait_for_pending_save(
                        run_id, name
                    )
                    key = self.key_for(run_id, name)
                    storage = self.ctx._get_storage_for_data_name(name)
                    if storage.exists(key, run_id):
                        storage.delete(key, run_id)
                        count += 1
                        if verbose:
                            print(f"  cleared disk cache: {key}")
                except Exception as e:
                    logger.warning(
                        "Failed to clear disk cache for (%s, %s): %s", run_id, name, e
                    )
        return count

    # -- plan/hash invalidation ----------------------------------------------

    def clear_performance_caches(self) -> None:
        self.ctx._execution_plan_cache.clear()
        self.ctx._lineage_cache.clear()
        self.ctx._lineage_hash_cache.clear()
        self.ctx._key_cache.clear()

    def invalidate_caches_for(self, data_name: str) -> None:
        """Drop cached plans/lineage/keys affected by a data name change."""
        self.ctx._execution_plan_cache.pop(data_name, None)
        stale_plans = [
            name
            for name, plan in self.ctx._execution_plan_cache.items()
            if data_name in plan
        ]
        for name in stale_plans:
            del self.ctx._execution_plan_cache[name]

        # lineage of anything downstream embeds this name's lineage
        affected = {data_name} | collect_downstream(data_name, self.ctx._plugins, self.ctx)
        for name in affected:
            self.ctx._lineage_cache.pop(name, None)
            self.ctx._lineage_hash_cache.pop(name, None)
        stale_keys = [k for k in self.ctx._key_cache if k[1] in affected]
        for k in stale_keys:
            del self.ctx._key_cache[k]
