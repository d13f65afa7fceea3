"""Context: the DAG scheduler and cache orchestrator.

Behavioral analog of the reference Context
(reference: waveform_analysis/core/context.py:133-2555), keeping its public
API surface — ``register``, ``get_data``, ``set_config``, ``get_config``,
``get_lineage``, ``key_for``, ``clear_cache_for``, ``preview_execution``,
``clone``, ``create_context_factory`` — and its contracts:

- lineage dict = {plugin_class, plugin_version, description, config (tracked
  options only), depends_on (recursive), dtype, [spec_hash], [adapter_info]};
- cache key = ``{run_id}-{data_name}-{sha1(lineage_json)[:8]}``;
- memory results are validated against current lineage before reuse;
- per-data-name storage backend overrides via ``config["plugin_backends"]``.

Port of ``waveformanalysis_tpu/context/context.py``. Device work runs on
``config["device"]`` (default ``"cuda"``; tests pass ``"cpu"``), resolved
by ``device.resolve_device``: the fused program and the standalone computes
put every tensor there. Plugin results are struct-of-arrays Tables; storage
round-trips them through the packed per-field layout, and a plugin's
``kernel_version`` is folded into lineage so kernel revisions invalidate
caches like plugin version bumps do. ``attach_mesh`` runs the fused
program on every shard of a device mesh (``parallel/mesh.py``), with the
same tables and lineage keys.
"""

from __future__ import annotations

import logging
import tempfile
import threading
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from waveformanalysis_tpu_torch.config.adapter_info import get_adapter_info
from waveformanalysis_tpu_torch.config.compat import get_default_compat_manager
from waveformanalysis_tpu_torch.config.resolver import ConfigResolver
from waveformanalysis_tpu_torch.config.types import ResolvedConfig
from waveformanalysis_tpu_torch.context.cache_domain import CacheDomain, lineage_json
from waveformanalysis_tpu_torch.context.config_domain import ConfigDomain
from waveformanalysis_tpu_torch.context.execution_domain import ExecutionDomain
from waveformanalysis_tpu_torch.context.resolution import get_plugin_dependencies
from waveformanalysis_tpu_torch.device import resolve_device
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.foundation.error import ErrorManager
from waveformanalysis_tpu_torch.foundation.exceptions import ConfigError
from waveformanalysis_tpu_torch.foundation.profiler import Profiler
from waveformanalysis_tpu_torch.plugins.base import Plugin
from waveformanalysis_tpu_torch.plugins.spec import PluginSpec
from waveformanalysis_tpu_torch.plugins.stats import PluginStatsCollector
from waveformanalysis_tpu_torch.storage.backends import validate_backend
from waveformanalysis_tpu_torch.storage.cache_manager import RuntimeCacheManager
from waveformanalysis_tpu_torch.storage.memmap import MemmapStorage

logger = logging.getLogger(__name__)

# Context-owned config keys (documented for show_config; reference:
# context.py:215-231 _CONTEXT_CONFIG_NOTES).
CONTEXT_CONFIG_NOTES: Dict[str, str] = {
    "data_root": "Root directory containing run directories",
    "daq_adapter": "Registered DAQ adapter name used for decode + inference",
    "n_channels": "Number of channels to process",
    "start_channel": "First channel index",
    "show_progress": "Print progress / cache messages",
    "plugin_backends": "Per-data-name storage backend overrides",
    "run_config_path_template": "Template for per-run run_config.json path",
    "time_domain": "Which time field queries use: system_ns or raw_ps",
    "device": "torch device of the device programs (default cuda)",
}

RESERVED_DATA_NAMES = {
    "config",
    "storage",
    "plugins",
    "profiler",
    "stats",
    "register",
    "get_data",
    "set_config",
    "get_config",
    "get_lineage",
    "key_for",
    "clone",
}

# Data names removed during the reference's own API evolution: requests get
# a migration pointer instead of a bare unknown-name error
# (reference: core/context.py:187-190 _REMOVED_DATA_NAME_ALIASES).
REMOVED_DATA_NAME_ALIASES: Dict[str, str] = {
    "events_df": "df",
    "events_grouped": "df_events",
}


class Context:
    """Orchestrates a DAG of plugins keyed by data names, with
    content-addressed caching."""

    def __init__(
        self,
        storage_dir: Optional[str] = None,
        config: Optional[Dict[str, Any]] = None,
        storage: Optional[Any] = None,
        stats_mode: str = "off",
        register: Optional[Sequence[Any]] = None,
        profiler: Optional[Profiler] = None,
    ) -> None:
        self.config: Dict[str, Any] = dict(config or {})
        self.device = resolve_device(self.config.get("device", "cuda"))

        if storage is not None:
            missing = validate_backend(storage)
            if missing:
                raise ConfigError(
                    f"Storage backend missing required methods: {missing}"
                )
            self.storage = storage
            self.storage_dir = getattr(storage, "work_dir", None)
        else:
            self.storage_dir = storage_dir or self.config.get("storage_dir")
            if self.storage_dir is None:
                self.storage_dir = tempfile.mkdtemp(prefix="wfa_tpu_storage_")
                logger.info("No storage_dir given; using %s", self.storage_dir)
            self.storage = MemmapStorage(self.storage_dir)

        # per-data-name backend overrides
        self._plugin_backends: Dict[str, Any] = {}
        for name, backend in (self.config.get("plugin_backends") or {}).items():
            missing = validate_backend(backend)
            if missing:
                raise ConfigError(
                    f"plugin_backends['{name}'] missing methods: {missing}"
                )
            self._plugin_backends[name] = backend

        self._plugins: Dict[str, Plugin] = {}
        self._results: Dict[Tuple[str, str], Any] = {}
        self._results_lineage: Dict[Tuple[str, str], str] = {}
        self._manual_names: Set[str] = set()
        self._mesh: Optional[Tuple[Any, str]] = None
        # get_data calls in flight (nested ones included: plugins read their
        # inputs through get_data, possibly from a timeout worker thread) and
        # the results they stored; see _release_device_columns
        self._request_lock = threading.Lock()
        self._request_depth = 0
        self._request_stored: List[Tuple[str, str]] = []

        # performance caches
        self._execution_plan_cache: Dict[str, List[str]] = {}
        self._lineage_cache: Dict[str, Dict[str, Any]] = {}
        self._lineage_hash_cache: Dict[str, str] = {}
        self._key_cache: Dict[Tuple[str, str], str] = {}

        self.profiler = profiler or Profiler()
        self.stats = PluginStatsCollector(mode=stats_mode)
        self.error_manager = ErrorManager()
        self.compat = get_default_compat_manager()
        self.resolver = ConfigResolver(compat_manager=self.compat)

        self.cache_domain = CacheDomain(self)
        self.execution_domain = ExecutionDomain(self)
        self.config_domain = ConfigDomain(self)
        self._cache_manager = RuntimeCacheManager(self)

        from waveformanalysis_tpu_torch.context.time_domain import TimeDomain

        self.time_domain = TimeDomain(self)

        if register:
            self.register(*register)

    # ------------------------------------------------------------------
    # Registration
    # ------------------------------------------------------------------

    def register(self, *plugins: Any) -> "Context":
        """Register plugin instances or classes; returns self for chaining."""
        for p in plugins:
            plugin = p() if isinstance(p, type) else p
            if not isinstance(plugin, Plugin):
                raise TypeError(f"Cannot register {type(p).__name__}: not a Plugin")
            plugin.validate()
            name = plugin.provides
            if name in RESERVED_DATA_NAMES:
                raise ValueError(
                    f"Plugin provides reserved name '{name}'"
                )
            spec = PluginSpec.from_plugin(plugin)
            errors = spec.validate()
            if errors:
                raise ValueError(
                    f"Plugin '{name}' has an invalid spec: {errors}"
                )
            plugin._validated_spec = spec
            plugin._registered_from_module = type(plugin).__module__
            plugin._registered_class = type(plugin).__name__
            if name in self._plugins:
                logger.info("Re-registering plugin for '%s'", name)
            self._plugins[name] = plugin
            self.cache_domain.invalidate_caches_for(name)
        return self

    def unregister(self, data_name: str) -> bool:
        if data_name in self._plugins:
            del self._plugins[data_name]
            self.cache_domain.invalidate_caches_for(data_name)
            return True
        return False

    @property
    def plugins(self) -> Dict[str, Plugin]:
        return dict(self._plugins)

    def get_plugin(self, data_name: str) -> Optional[Plugin]:
        return self._plugins.get(data_name)

    # ------------------------------------------------------------------
    # Config
    # ------------------------------------------------------------------

    def set_config(self, config_or_key: Union[Dict[str, Any], str],
                   value: Any = None) -> "Context":
        """Update config; invalidates lineage/plan caches for affected names.

        Plugin-scoped (and other) dict values MERGE one level deep:
        ``set_config({"hit": {"height": 5}})`` followed by
        ``set_config({"hit": {"backend": "xla"}})`` keeps both keys. Pass a
        non-dict (e.g. None then the dict) to replace a scope outright.
        """
        if isinstance(config_or_key, dict):
            updates = config_or_key
        else:
            updates = {config_or_key: value}
        for k, v in updates.items():
            old = self.config.get(k)
            if isinstance(old, dict) and isinstance(v, dict):
                merged = dict(old)
                merged.update(v)
                self.config[k] = merged
            else:
                self.config[k] = v
            self._warn_unknown_scoped_keys(k, v)
        # Conservative invalidation: config keys may feed any plugin's options.
        self.cache_domain.clear_performance_caches()
        return self

    def _warn_unknown_scoped_keys(self, scope: str, value: Any) -> None:
        """Warn when a plugin-scoped config dict carries unregistered keys.

        A reference config ported over with a key this build doesn't
        implement (or a typo'd option name) would otherwise be accepted and
        silently ignored — the bug class the r4 differential sweeps kept
        catching. Global (non-plugin-scoped) keys stay free-form, matching
        the reference, and compat aliases resolve before the check. Plugins
        registered after set_config are covered by the same check in
        Plugin.validate_config at execution time.
        """
        if not isinstance(value, dict):
            return
        plugin = self._plugins.get(scope)
        if plugin is None or not isinstance(getattr(plugin, "options", None), dict):
            return
        unknown = [key for key in value if key not in plugin.options]
        if not unknown:
            return
        import warnings

        for key in list(unknown):
            canonical, was_alias = self.compat.resolve_alias(scope, key)
            if was_alias and canonical in plugin.options:
                unknown.remove(key)
        if unknown:
            warnings.warn(
                f"set_config: key(s) {sorted(unknown)} in the '{scope}' "
                f"section match no option of that plugin (known: "
                f"{sorted(plugin.options)}); they will be ignored",
                UserWarning,
                stacklevel=3,
            )

    def get_config(self, plugin_or_name: Any, key: str,
                   run_id: Optional[str] = None) -> Any:
        """Resolved value of one plugin option."""
        plugin = self._as_plugin(plugin_or_name)
        cfg = self._effective_config(plugin.provides, run_id)
        cv = self.resolver.resolve_value(
            plugin, key, cfg, adapter_info=self._adapter_info()
        )
        return cv.value

    def get_resolved_config(self, plugin_or_name: Any,
                            run_id: Optional[str] = None) -> ResolvedConfig:
        plugin = self._as_plugin(plugin_or_name)
        cfg = self._effective_config(plugin.provides, run_id)
        return self.resolver.resolve(
            plugin, cfg, adapter_name=self.config.get("daq_adapter"),
            adapter_info=self._adapter_info(),
        )

    def _as_plugin(self, plugin_or_name: Any) -> Plugin:
        if isinstance(plugin_or_name, str):
            plugin = self._plugins.get(plugin_or_name)
            if plugin is None:
                raise KeyError(f"No plugin registered for '{plugin_or_name}'")
            return plugin
        return plugin_or_name

    def _effective_config(self, plugin_name: str, run_id: Optional[str]) -> Dict[str, Any]:
        """Context config overlaid on the run_config plugin block (context wins)."""
        if run_id is None:
            return self.config
        run_block = self.config_domain.get_plugin_run_config(run_id, plugin_name)
        if not run_block:
            return self.config
        merged = dict(self.config)
        scoped = dict(run_block)
        existing = merged.get(plugin_name)
        if isinstance(existing, dict):
            scoped.update(existing)
        merged[plugin_name] = scoped
        return merged

    def _adapter_info(self):
        name = self.config.get("daq_adapter")
        return get_adapter_info(name) if name else None

    def get_run_config(self, run_id: str) -> Optional[Dict[str, Any]]:
        return self.config_domain.get_run_config(run_id)

    @classmethod
    def from_config_json(cls, path: str, **kwargs: Any) -> "Context":
        import json

        with open(path) as fh:
            config = json.load(fh)
        return cls(config=config, **kwargs)

    # ------------------------------------------------------------------
    # Lineage / keys
    # ------------------------------------------------------------------

    def get_lineage(self, data_name: str, _visited: Optional[set] = None) -> Dict[str, Any]:
        """Recursive recipe for a data name; cached at top level."""
        if _visited is None and data_name in self._lineage_cache:
            return self._lineage_cache[data_name]
        if _visited is None:
            _visited = set()
        if data_name in _visited:
            return {"plugin_class": "CircularDependency", "target": data_name}

        if data_name not in self._plugins:
            if data_name in self._manual_names:
                return {"plugin_class": "ManualData", "config": {}, "depends_on": {}}
            return {}

        plugin = self._plugins[data_name]
        if hasattr(plugin, "get_lineage"):
            return plugin.get_lineage(self)

        _visited.add(data_name)

        config: Dict[str, Any] = {}
        resolved = self.get_resolved_config(plugin)
        for k in plugin.config_keys:
            opt = plugin.options.get(k)
            if opt is not None and getattr(opt, "track", True):
                cv = resolved.get_value(k)
                if cv is not None:
                    config[k] = cv.value
        # a plugin whose EFFECTIVE config is resolved under another scope
        # (e.g. the hit-merge family defers gap/width to the
        # hit_merge_clusters plugin, mirroring the reference's data flow)
        # rewrites the tracked values here so cache invalidation follows
        # the scope that actually changes the output
        adjust = getattr(plugin, "adjust_lineage_config", None)
        if adjust is not None:
            config = adjust(self, config)

        dep_names = [
            plugin.get_dependency_name(d)
            for d in get_plugin_dependencies(plugin, self, None)
        ]
        lineage: Dict[str, Any] = {
            "plugin_class": type(plugin).__name__,
            "plugin_version": getattr(plugin, "version", "0.0.0"),
            "description": getattr(plugin, "description", ""),
            "config": config,
            "depends_on": {
                dep: self.get_lineage(dep, _visited=set(_visited)) for dep in dep_names
            },
        }

        kernel_version = getattr(plugin, "kernel_version", "")
        if kernel_version:
            lineage["kernel_version"] = kernel_version

        if plugin._validated_spec is not None:
            lineage["spec_hash"] = plugin._validated_spec.spec_hash()

        out_dtype = plugin.output_dtype
        if out_dtype is not None:
            try:
                lineage["dtype"] = np.dtype(out_dtype).descr
            except (TypeError, ValueError):
                lineage["dtype"] = str(out_dtype)

        if len(_visited) == 1:
            adapter_name = self.config.get("daq_adapter")
            if adapter_name:
                info = get_adapter_info(adapter_name)
                if info:
                    lineage["adapter_info"] = info.to_dict()
            self._lineage_cache[data_name] = lineage
        return lineage

    def key_for(self, run_id: str, data_name: str) -> str:
        return self.cache_domain.key_for(run_id, data_name)

    # ------------------------------------------------------------------
    # Data access
    # ------------------------------------------------------------------

    def get_data(self, run_id: str, data_name: Any, **kwargs: Any) -> Any:
        """The canonical read path: memory -> disk (lineage-checked) -> compute.

        ``data_name`` may be a list/tuple of names: the targets are planned
        TOGETHER, so the fused subgraph executor sees the union of their
        needed sets (e.g. ``get_data(run, ["hit", "basic_features",
        "hit_threshold"])`` computes all three in one device program where
        three separate calls would each run alone). Returns a dict
        {name: result} for list targets.

        When the outermost call returns, no table it stored in the memory
        cache holds a column on the device: the fused program and the
        standalone plugins read device columns (the filtered waves) inside
        the call, and afterwards the cache keeps host arrays, as the JAX
        package's plugins return them.
        """
        out, moved = self._in_request(self._get_data, run_id, data_name, **kwargs)
        if isinstance(out, dict):
            return {k: moved.get(id(v), v) for k, v in out.items()}
        return moved.get(id(out), out)

    def get_data_batched(
        self, run_ids: Any, data_name: Any, **kwargs: Any
    ) -> Dict[str, Any]:
        """Multi-RUN read: fused bundles batch across runs on the event axis.

        The reference's multi-run story is host process fan-out
        (reference: waveform_analysis/core/data/batch_processor.py:197);
        here runs still to compute are planned individually, but their
        fused wave-chain bundles are concatenated and run as ONE device
        program per matching device configuration, amortizing upload,
        launches and the copy back over the whole batch
        (context/fusion.py compute_many). Cached runs load as usual;
        outputs, lineage keys, and saves are identical to per-run
        ``get_data``, and like an outermost ``get_data`` the call moves the
        device columns of every table it cached, for any of its runs, to
        the host before it returns.

        Returns ``{run_id: result}`` for a single name, or
        ``{run_id: {name: result}}`` for a list of names.
        """
        multi = isinstance(data_name, (list, tuple))
        out, moved = self._in_request(
            self._get_data_batched, list(run_ids), data_name, **kwargs
        )
        if multi:
            return {rid: {k: moved.get(id(v), v) for k, v in res.items()}
                    for rid, res in out.items()}
        return {rid: moved.get(id(v), v) for rid, v in out.items()}

    def _in_request(self, fn, *args: Any, **kwargs: Any) -> Tuple[Any, Dict[int, Any]]:
        """``fn(*args, **kwargs)`` as one request: nested calls count their
        depth, and when the outermost returns, the device columns of the
        tables the request cached move to the host. Returns (result,
        {id(old table): host table})."""
        with self._request_lock:
            self._request_depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            with self._request_lock:
                self._request_depth -= 1
                stored, outermost = self._request_stored, not self._request_depth
                if outermost:
                    self._request_stored = []
            moved = self._release_device_columns(stored) if outermost else {}
        return out, moved

    def _release_device_columns(self, keys: List[Tuple[str, str]]) -> Dict[int, Any]:
        """Move the device columns of the memory-cached tables under
        ``keys`` to the host; returns {id(old table): host table}.

        Placed here, at the end of a request, rather than as a byte budget on
        device-held columns: a budget would still keep a run's filtered waves
        on the card between requests and leave its size to tune, while every
        device reader of a column runs inside the request that made it.
        """
        moved: Dict[int, Any] = {}
        if not keys:
            return moved
        with self.profiler.time("context.release_device_columns"):
            for key in dict.fromkeys(keys):
                data = self._results.get(key)
                if not isinstance(data, Table) or not any(
                        isinstance(v, torch.Tensor) for v in data.columns.values()):
                    continue
                host = data.to_host()
                self._results[key] = host
                moved[id(data)] = host
        return moved

    def _get_data(self, run_id: str, data_name: Any, **kwargs: Any) -> Any:
        if isinstance(data_name, (list, tuple)):
            return self._get_data_multi(run_id, list(data_name), **kwargs)
        self.config_domain.prepare_request(run_id)

        data = self._get_data_from_memory(run_id, data_name)
        if data is not None:
            self._cache_manager.stats["memory_hits"] += 1
            return data

        if data_name not in self._plugins:
            raise self._unknown_name_error(data_name)

        key = self.key_for(run_id, data_name)
        data = self.cache_domain.load_from_disk_with_check(run_id, data_name, key)
        if data is not None:
            return data

        return self.execution_domain.run_plugin(run_id, data_name, **kwargs)

    def _get_data_multi(
        self, run_id: str, names: List[str], **kwargs: Any
    ) -> Dict[str, Any]:
        """Jointly-planned multi-target read (fusion-friendly)."""
        self.config_domain.prepare_request(run_id)
        out: Dict[str, Any] = {}
        pending: List[str] = []
        for name in names:
            data = self._get_data_from_memory(run_id, name)
            if data is None and name in self._plugins:
                key = self.key_for(run_id, name)
                data = self.cache_domain.load_from_disk_with_check(
                    run_id, name, key
                )
            if data is not None:
                out[name] = data
            else:
                if name not in self._plugins:
                    raise self._unknown_name_error(name)
                pending.append(name)
        if pending:
            out.update(
                self.execution_domain.run_plugins(run_id, pending, **kwargs)
            )
        return {name: out[name] for name in names}

    def _get_data_batched(
        self, run_ids: List[str], data_name: Any, **kwargs: Any
    ) -> Dict[str, Any]:
        multi = isinstance(data_name, (list, tuple))
        names = list(data_name) if multi else [data_name]
        out: Dict[str, Dict[str, Any]] = {}
        pending_runs: Dict[str, List[str]] = {}
        for rid in run_ids:
            self.config_domain.prepare_request(rid)
            found: Dict[str, Any] = {}
            pending: List[str] = []
            for name in names:
                data = self._get_data_from_memory(rid, name)
                if data is None and name in self._plugins:
                    key = self.key_for(rid, name)
                    data = self.cache_domain.load_from_disk_with_check(
                        rid, name, key
                    )
                if data is not None:
                    found[name] = data
                elif name not in self._plugins:
                    raise self._unknown_name_error(name)
                else:
                    pending.append(name)
            out[rid] = found
            if pending:
                pending_runs[rid] = pending
        if pending_runs:
            computed = self.execution_domain.run_plugins_batched(
                list(pending_runs), pending_runs, **kwargs
            )
            for rid, pend in pending_runs.items():
                for name in pend:
                    out[rid][name] = computed[rid][name]
        if multi:
            return {rid: {n: out[rid][n] for n in names} for rid in run_ids}
        return {rid: out[rid][names[0]] for rid in run_ids}

    def _unknown_name_error(self, name: str) -> KeyError:
        """Unknown data name -> KeyError; removed legacy names get a
        migration pointer (reference: core/context.py:187-190)."""
        replacement = REMOVED_DATA_NAME_ALIASES.get(name)
        if replacement is not None:
            return KeyError(
                f"data name '{name}' was removed; request '{replacement}' "
                f"instead (see docs/migrating_from_reference.md)"
            )
        return KeyError(
            f"No plugin registered for '{name}'. "
            f"Registered: {sorted(self._plugins)}"
        )

    def _load_for_user(self, run_id: str, name: str) -> Any:
        data = self._get_data_from_memory(run_id, name)
        if data is not None:
            return data
        # stream outputs are not memory-cached
        return self._results.get((run_id, name))

    def _get_data_from_memory(self, run_id: str, name: str) -> Any:
        key = (run_id, name)
        data = self._results.get(key)
        if data is None:
            return None
        stored_lineage = self._results_lineage.get(key)
        if stored_lineage is not None and name in self._plugins:
            if stored_lineage != lineage_json(self.get_lineage(name)):
                # config/plugin changed since this result was computed
                del self._results[key]
                del self._results_lineage[key]
                return None
        return data

    def _set_data(self, run_id: str, name: str, data: Any) -> None:
        key = (run_id, name)
        self._results[key] = data
        with self._request_lock:
            if self._request_depth:
                self._request_stored.append(key)
        if name in self._plugins:
            self._results_lineage[key] = lineage_json(self.get_lineage(name))

    def inject_data(self, run_id: str, name: str, data: Any) -> None:
        """Manually provide data for a name (testing / notebooks)."""
        self._manual_names.add(name)
        self._results[(run_id, name)] = data
        self._results_lineage.pop((run_id, name), None)

    def has_manual_data(self, name: str) -> bool:
        return name in self._manual_names

    def is_cache_hit(self, run_id: str, name: str, load: bool = False) -> bool:
        return self.cache_domain.is_cache_hit(run_id, name, load=load)

    def clear_cache_for(self, run_id: str, data_name: Optional[str] = None,
                        downstream: bool = False, **kwargs: Any) -> int:
        return self.cache_domain.clear_cache_for(
            run_id, data_name, downstream=downstream, **kwargs
        )

    # ------------------------------------------------------------------
    # Time domain façade (reference: context_time.py)
    # ------------------------------------------------------------------

    def set_epoch(self, run_id: str, epoch: Any, source: str = "manual"):
        return self.time_domain.set_epoch(run_id, epoch, source=source)

    def get_epoch(self, run_id: str):
        return self.time_domain.get_epoch(run_id)

    def auto_extract_epoch(self, run_id: str):
        return self.time_domain.auto_extract_epoch(run_id)

    def get_time_converter(self, run_id: str):
        return self.time_domain.get_time_converter(run_id)

    def build_time_index(self, run_id: str, data_name: str,
                         channel: Optional[int] = None, force: bool = False):
        return self.time_domain.build_time_index(
            run_id, data_name, channel=channel, force=force
        )

    def time_range(self, run_id: str, data_name: str,
                   start: Optional[int] = None, end: Optional[int] = None,
                   channel: Optional[int] = None):
        return self.time_domain.time_range(
            run_id, data_name, start=start, end=end, channel=channel
        )

    def query_multi_channel_time_range(self, run_id: str, data_name: str,
                                       start: Optional[int] = None,
                                       end: Optional[int] = None,
                                       channels: Optional[Tuple[int, ...]] = None):
        return self.time_domain.query_multi_channel_time_range(
            run_id, data_name, start=start, end=end, channels=channels
        )

    def time_range_absolute(self, run_id: str, data_name: str,
                            start_dt: Any = None, end_dt: Any = None):
        return self.time_domain.time_range_absolute(
            run_id, data_name, start_dt=start_dt, end_dt=end_dt
        )

    # ------------------------------------------------------------------
    # Storage plumbing
    # ------------------------------------------------------------------

    def _get_storage_for_data_name(self, name: Optional[str]) -> Any:
        if name and name in self._plugin_backends:
            return self._plugin_backends[name]
        return self.storage

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    def preview_execution(self, run_id: str, data_name: str,
                          verbose: bool = False) -> Dict[str, Any]:
        """Dry-run: plan, cache status, needed set — no computation."""
        plan = self.execution_domain.resolve_execution_plan(data_name, run_id)
        cache_status = {
            name: (
                "memory"
                if self._results.get((run_id, name)) is not None
                else (
                    "disk"
                    if name in self._plugins
                    and self.cache_domain.is_disk_cache_valid(
                        run_id, name, self.key_for(run_id, name)
                    )
                    else "miss"
                )
            )
            for name in plan
        }
        needed = self.execution_domain.compute_needed_set(plan, data_name, run_id)
        # config deltas: every non-default resolved value per plugin
        from waveformanalysis_tpu_torch.config.types import ConfigSource

        config_deltas: Dict[str, Dict[str, Any]] = {}
        for name in plan:
            if name not in self._plugins:
                continue
            resolved = self.get_resolved_config(name, run_id)
            deltas = {
                key: {"value": cv.value, "source": cv.source.value}
                for key, cv in resolved.values.items()
                if cv.source != ConfigSource.PLUGIN_DEFAULT
            }
            if deltas:
                config_deltas[name] = deltas
        preview = {
            "run_id": run_id,
            "target": data_name,
            "plan": plan,
            "cache_status": cache_status,
            "needed": sorted(needed),
            "will_compute": [n for n in plan if n in needed],
            "config_deltas": config_deltas,
        }
        if verbose:
            print(f"Execution preview for ({run_id}, {data_name}):")
            for name in plan:
                mark = "compute" if name in needed else f"cached ({cache_status[name]})"
                print(f"  {name:<30} {mark}")
                for key, d in config_deltas.get(name, {}).items():
                    print(f"    {key} = {d['value']!r} ({d['source']})")
        return preview

    def analyze_dependencies(self, target_name: str,
                             include_performance: bool = True,
                             run_id: Optional[str] = None):
        """Critical-path / parallel-group analysis (reference: context.py:1290)."""
        from waveformanalysis_tpu_torch.data.dependency_analysis import DependencyAnalyzer

        return DependencyAnalyzer(self).analyze(
            target_name, include_performance=include_performance, run_id=run_id
        )

    def analyze_cache(self, run_id: Optional[str] = None):
        """Cache entry scan + summary (reference: context.py:2412)."""
        from waveformanalysis_tpu_torch.storage.cache_ops import CacheAnalyzer

        analyzer = CacheAnalyzer(self.storage)
        return {"entries": [e.to_dict() for e in analyzer.scan(run_id)],
                "summary": analyzer.summary(run_id)}

    def diagnose_cache(self, run_id: Optional[str] = None):
        """Cache health report (reference: context.py:2460)."""
        from waveformanalysis_tpu_torch.storage.cache_ops import CacheDiagnostics

        return CacheDiagnostics(self.storage).diagnose(run_id)

    def cache_stats(self):
        """Runtime hit/miss statistics (reference: context.py:2520)."""
        return self._cache_manager.get_stats()

    def get_performance_report(self) -> str:
        lines = [self.stats.report(), "", self.profiler.summary()]
        return "\n".join(lines)

    def profiling_summary(self) -> str:
        return self.profiler.summary()

    def list_data_names(self) -> List[str]:
        return sorted(self._plugins)

    def search_field(self, field_name: str) -> List[str]:
        """Data names whose output schema contains the given field."""
        hits = []
        for name, plugin in self._plugins.items():
            spec = plugin._validated_spec
            if spec and spec.output_schema:
                if any(f.name == field_name for f in spec.output_schema.fields):
                    hits.append(name)
        return hits

    def help(self, data_name: Optional[str] = None) -> str:
        """Human-readable overview of registered plugins."""
        if data_name is not None:
            plugin = self._plugins.get(data_name)
            if plugin is None:
                return f"No plugin registered for '{data_name}'"
            lines = [
                f"{data_name} <- {type(plugin).__name__} v{plugin.version}",
                f"  {plugin.description}",
                f"  depends_on: {plugin.depends_on or '(dynamic)' if not plugin.depends_on else plugin.depends_on}",
                f"  save_when: {plugin.save_when}",
                "  options:",
            ]
            for key, opt in plugin.options.items():
                lines.append(f"    {key} (default={opt.default!r}): {opt.help}")
            return "\n".join(lines)
        lines = ["Registered plugins:"]
        for name, plugin in sorted(self._plugins.items()):
            lines.append(
                f"  {name:<28} {type(plugin).__name__} v{plugin.version}"
            )
        return "\n".join(lines)

    def list_plugin_configs(
        self,
        plugin_name: Optional[str] = None,
        show_current_values: bool = True,
        verbose: bool = True,
        as_dataframe: bool = True,
        show_full_help: bool = False,
    ) -> Dict[str, Any]:
        """Option catalogue for registered plugins (reference:
        context.py:1458-1560): per plugin, every option's default, type,
        help, tracking flag, and (optionally) the currently-resolved value
        with a modified-vs-default marker.

        Returns the result dict; with ``verbose`` also prints a plugin
        overview table and an option table (pandas when ``as_dataframe``,
        plain text otherwise).
        """
        if plugin_name is not None:
            if plugin_name not in self._plugins:
                if verbose:
                    print(f"plugin '{plugin_name}' is not registered; "
                          f"registered: {', '.join(sorted(self._plugins))}")
                return {}
            plugins_to_show = {plugin_name: self._plugins[plugin_name]}
        else:
            plugins_to_show = self._plugins
        if not plugins_to_show:
            if verbose:
                print("no plugins registered")
            return {}

        result: Dict[str, Any] = {}
        for name, plugin in plugins_to_show.items():
            options: Dict[str, Any] = {}
            for opt_name, option in plugin.options.items():
                opt_type = option.type
                opt_info: Dict[str, Any] = {
                    "default": option.default,
                    "type": (opt_type.__name__
                             if hasattr(opt_type, "__name__")
                             else str(opt_type) if opt_type else "Any"),
                    "help": option.help,
                    "track": option.track,
                }
                if show_current_values:
                    try:
                        current = self.get_config(plugin, opt_name)
                    except Exception:
                        current = None
                    opt_info["current_value"] = current
                    opt_info["is_default"] = current == option.default
                options[opt_name] = opt_info
            result[name] = {
                "class": type(plugin).__name__,
                "description": getattr(plugin, "description", ""),
                "version": getattr(plugin, "version", "0.0.0"),
                "options": options,
            }

        if verbose:
            self._print_plugin_configs(result, show_current_values,
                                       as_dataframe, show_full_help)
        return result

    @staticmethod
    def _print_plugin_configs(result, show_current_values, as_dataframe,
                              show_full_help) -> None:
        overview = [
            {
                "plugin": pname,
                "class": info["class"],
                "version": info["version"],
                "options": len(info["options"]),
                "modified": sum(
                    1 for o in info["options"].values()
                    if show_current_values and not o.get("is_default", True)
                ),
            }
            for pname, info in result.items()
        ]
        opt_rows = [
            {
                "plugin": pname,
                "option": oname,
                "default": repr(o["default"]),
                **({"current": repr(o.get("current_value")),
                    "modified": "" if o.get("is_default", True) else "*"}
                   if show_current_values else {}),
                "type": o["type"],
                "help": o["help"] if show_full_help else
                (o["help"][:57] + "..." if len(o["help"]) > 60 else o["help"]),
            }
            for pname, info in result.items()
            for oname, o in info["options"].items()
        ]
        if as_dataframe:
            try:
                import pandas as pd

                with pd.option_context("display.max_rows", None,
                                       "display.width", 160,
                                       "display.max_colwidth", 64):
                    print(pd.DataFrame(overview).to_string(index=False))
                    print()
                    print(pd.DataFrame(opt_rows).to_string(index=False))
                return
            except Exception:  # pragma: no cover - pandas always present
                pass
        for row in overview:
            print(f"{row['plugin']:<28} {row['class']} v{row['version']} "
                  f"({row['options']} options, {row['modified']} modified)")
        for row in opt_rows:
            mark = row.get("modified", "")
            cur = f" current={row['current']}" if "current" in row else ""
            print(f"  {row['plugin']}.{row['option']}{mark} "
                  f"default={row['default']}{cur} [{row['type']}] "
                  f"{row['help']}")

    def plot_lineage(self, data_name: str, renderer: str = "labview",
                     **kwargs: Any):
        """Render the dependency/lineage graph for a data name
        (reference: context.py:1189). renderer: 'labview' (matplotlib) or
        'plotly'. Extra kwargs (verbose, style, interactive,
        analysis_result, highlight_*) pass through to the renderer."""
        from waveformanalysis_tpu_torch.utils.visualization import (
            plot_lineage_labview,
            plot_lineage_plotly,
        )

        lineage = self.get_lineage(data_name)
        if renderer == "plotly":
            return plot_lineage_plotly(lineage, data_name, context=self,
                                       **kwargs)
        if renderer == "labview":
            return plot_lineage_labview(lineage, data_name, context=self,
                                        **kwargs)
        raise ValueError(f"unknown renderer {renderer!r}; use labview|plotly")

    def quickstart(self) -> str:
        """Getting-started walkthrough for this Context (reference:
        context.py:2318). Prints runnable steps using the currently
        registered plugins and configuration."""
        target = "df_paired" if "df_paired" in self._plugins else (
            sorted(self._plugins)[-1] if self._plugins else "<data_name>"
        )
        data_root = self.config.get("data_root", "/path/to/data")
        adapter = self.config.get("daq_adapter", "vx2730")
        lines = [
            "Quickstart",
            "==========",
            "",
            "1. Point the context at a DAQ run directory:",
            "     ctx = Context(config={",
            f"         'data_root': {str(data_root)!r},",
            f"         'daq_adapter': {adapter!r},",
            "         'n_channels': 2,",
            "     }, storage_dir='./wfa_cache')",
            "",
            "2. Register plugins, e.g. the S1/S2 cone:",
            "     from waveformanalysis_tpu_torch.plugins.builtin.peak_finding import HitFinderPlugin",
            "     ctx.register(HitFinderPlugin(), ...)",
            "",
            f"3. Compute any data name (full DAG runs on demand):",
            f"     data = ctx.get_data('run_001', {target!r})",
            "",
            "4. Re-reads hit the lineage-hashed cache; config changes",
            "   invalidate exactly the affected subtree:",
            "     ctx.set_config({'hit.height': 40.0})",
            "",
            "5. Inspect before running:",
            "     print(ctx.preview_execution('run_001', " + repr(target) + "))",
            "     print(ctx.help())",
            "",
            "Registered now: "
            + (", ".join(sorted(self._plugins)) or "(nothing registered)"),
        ]
        return "\n".join(lines)

    # ------------------------------------------------------------------
    # Cloning / factories
    # ------------------------------------------------------------------

    def flush_saves(self) -> "Context":
        """Complete every in-flight async cache write (async_save mode)."""
        self.execution_domain.flush_saves()
        return self

    def close(self) -> None:
        """Flush in-flight cache writes. Safe to call repeatedly.

        Use this (or the ``with Context(...)`` form) before tearing down a
        temporary storage directory — the async writer may still be
        persisting the last outputs when the with-block exits otherwise.
        """
        self.flush_saves()

    def __enter__(self) -> "Context":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def clone(self, **config_updates: Any) -> "Context":
        """A new Context sharing storage + plugin classes, fresh caches.

        ``config_updates`` are applied on top of the current config.
        ``clone(config={...})`` is accepted as a synonym for passing the
        dict's items as keyword updates — it mirrors the
        ``Context(config=...)`` constructor, so treating it as a literal
        global key named ``"config"`` would silently change nothing (the
        mistake is invisible: every plugin keeps its old lineage).
        """
        self.flush_saves()  # the clone reads through the shared storage
        nested = config_updates.pop("config", None)
        if nested is not None:
            if not isinstance(nested, dict):
                raise TypeError(
                    "clone(config=...) expects a dict of config updates, "
                    f"got {type(nested).__name__}"
                )
            merged = dict(nested)
            merged.update(config_updates)  # explicit kwargs win
            config_updates = merged
        cfg = dict(self.config)
        cfg.update(config_updates)
        new = Context(
            storage=self.storage,
            config=cfg,
            stats_mode=self.stats.mode,
        )
        for plugin in self._plugins.values():
            new.register(type(plugin)())
        if self._mesh is not None:
            new.attach_mesh(self._mesh[0], axis=self._mesh[1])
        # manually-injected data travels with the clone (by reference):
        # thread-pool batch workers are clones and must see the same inputs
        # the parent was given (computed results do NOT carry over — clones
        # re-read those through the shared storage)
        for (run_id, name), data in self._results.items():
            if name in self._manual_names:
                new.inject_data(run_id, name, data)
        return new

    # ------------------------------------------------------------------
    # Device mesh (multi-chip execution)
    # ------------------------------------------------------------------

    def attach_mesh(self, mesh: Any, axis: str = "data") -> "Context":
        """Attach a device Mesh (``parallel.make_mesh``): fused device
        programs then run on every shard of ``axis`` (event-axis data
        parallelism) instead of on the Context's device alone. Purely an
        execution-strategy switch: results and lineage keys are unchanged.
        The mesh's devices must be of the Context's device type. Returns
        self for chaining; ``attach_mesh(None)`` detaches.
        """
        if mesh is not None:
            if axis not in mesh.shape:
                raise ConfigError(
                    f"Mesh has no axis {axis!r} (axes: {tuple(mesh.shape)})"
                )
            if mesh.device_type != self.device.type:
                raise ConfigError(
                    f"a mesh of {mesh.device_type} devices on a Context whose "
                    f"device is {self.device}"
                )
        self._mesh = None if mesh is None else (mesh, axis)
        return self

    @property
    def mesh(self) -> Optional[Tuple[Any, str]]:
        """The attached (mesh, axis) tuple, or None (single-device)."""
        return self._mesh

    def create_context_factory(self):
        """A picklable factory recreating an equivalent Context in another
        process (reference: context.py:518)."""
        self.flush_saves()  # worker processes read through the same storage
        spec = {
            "config": dict(self.config),
            "storage_dir": self.storage_dir,
            "stats_mode": self.stats.mode,
            "plugins": [
                (type(p).__module__, type(p).__name__)
                for p in self._plugins.values()
            ],
        }
        return _ContextFactory(spec)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"Context(plugins={sorted(self._plugins)}, "
            f"storage_dir={self.storage_dir!r})"
        )


class _ContextFactory:
    """Picklable context factory (module-level class so pickle works)."""

    def __init__(self, spec: Dict[str, Any]) -> None:
        self.spec = spec

    def __call__(self) -> Context:
        import importlib

        ctx = Context(
            storage_dir=self.spec["storage_dir"],
            config=self.spec["config"],
            stats_mode=self.spec.get("stats_mode", "off"),
        )
        for module_name, class_name in self.spec["plugins"]:
            module = importlib.import_module(module_name)
            ctx.register(getattr(module, class_name)())
        return ctx
