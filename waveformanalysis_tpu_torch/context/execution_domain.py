"""Context execution domain: plans, needed-set pruning, plugin execution.

Behavioral analog of the reference execution domain
(reference: waveform_analysis/core/context_execution.py:21-475):

- execution plans are topo-sorted and cached per target;
- the needed set prunes subtrees whose outputs are already cached;
- per-plugin execution: validate config -> validate input dtypes -> compute
  -> output contract -> save -> memory cache, instrumented by the profiler
  and stats collector, guarded against runtime re-entrancy cycles;
- stream outputs are wrapped so chunks persist incrementally while yielding;
- errors branch on severity, with on_error/cleanup hooks always running.
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import nullcontext
from typing import Any, Dict, Generator, List, Optional, Set

import numpy as np

from waveformanalysis_tpu_torch.context.resolution import (
    get_plugin_dependencies,
    resolve_dependencies,
)
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.foundation.exceptions import (
    ErrorSeverity,
    PluginError,
    TimeoutError_,
    ValidationError,
)
from waveformanalysis_tpu_torch.foundation.profiler import adopt, handoff
from waveformanalysis_tpu_torch.plugins.stats import estimate_mb

logger = logging.getLogger(__name__)

# Outputs that must be a single flat array/Table with a 'channel' field
# (reference: context.py _FLAT_CHANNEL_OUTPUTS).
FLAT_CHANNEL_OUTPUTS = {
    "st_waveforms",
    "filtered_waveforms",
    "basic_features",
    "signal_peaks_stream",
    "waveform_width",
    "waveform_width_integral",
    "s1_s2",
}


# in-flight async cache writes: (storage root, run_id, data_name) -> Future
_PENDING_SAVES: Dict[Tuple[str, str, str], Any] = {}
_PENDING_SAVES_LOCK = threading.Lock()


class ExecutionDomain:
    """Plan resolution and plugin execution for a Context."""

    def __init__(self, context: Any) -> None:
        self.ctx = context
        self._in_progress: Dict[Any, bool] = {}
        self._in_progress_lock = threading.Lock()
        # async save machinery (one writer thread per Context). The pending
        # registry is MODULE-GLOBAL keyed by (storage root, run, name):
        # a fresh Context constructed over the same storage dir (restart
        # pattern) must barrier on another context's in-flight writes too.
        self._save_pool: Optional[Any] = None

    # -- planning ------------------------------------------------------------

    def resolve_execution_plan(
        self, target: str, run_id: Optional[str] = None
    ) -> List[str]:
        cached = self.ctx._execution_plan_cache.get(target)
        if cached is not None:
            return list(cached)
        with self.ctx.profiler.time("context.resolve_dependencies"):
            plan = resolve_dependencies(self.ctx, target, self.ctx._plugins, run_id)
        self.ctx._execution_plan_cache[target] = list(plan)
        return plan

    def compute_needed_set(
        self, plan: List[str], target: str, run_id: str
    ) -> Set[str]:
        """Subset of the plan that actually needs executing.

        A node is needed iff it is not cache-valid and some needed consumer
        (or the target itself) requires it. Cached nodes load lazily when a
        plugin requests them.
        """
        needed: Set[str] = set()

        def need(name: str) -> None:
            if name in needed:
                return
            if self.ctx.cache_domain.is_cache_hit(run_id, name):
                return
            if name not in self.ctx._plugins:
                return  # manual data
            needed.add(name)
            plugin = self.ctx._plugins[name]
            for dep in get_plugin_dependencies(plugin, self.ctx, run_id):
                need(plugin.get_dependency_name(dep))

        need(target)
        return needed

    # -- execution -----------------------------------------------------------

    def run_plugin(self, run_id: str, target: str, **kwargs: Any) -> Any:
        """Execute the plan for ``target``; returns the target's data."""
        with self.ctx.profiler.time("context.plan"):
            plan = self.resolve_execution_plan(target, run_id)
            needed = self.compute_needed_set(plan, target, run_id)
            fusion_bundles = self._plan_fusion(run_id, needed, kwargs)
        fused_results: Dict[str, Any] = {}
        target_result = None
        target_ran = False
        for name in plan:
            if name not in needed:
                continue
            bundle = fusion_bundles.get(name)
            if bundle is not None and name not in fused_results:
                # first member reached: run the whole bundle in one fused
                # device program (deps are earlier in the topo-sorted plan)
                rule, members = bundle
                with self.ctx.profiler.time(f"fusion.{rule.name}.compute"):
                    fused_results.update(rule.compute(self.ctx, run_id, members))
            result = self.execute_single_plugin(
                run_id, name, is_target=(name == target),
                precomputed=fused_results, **kwargs
            )
            if name == target:
                target_result = result
                target_ran = True
        if target_ran:
            # streams are one-shot generators and never memory-cached
            return target_result
        return self.ctx._load_for_user(run_id, target)

    def run_plugins(
        self, run_id: str, targets: List[str], **kwargs: Any
    ) -> Dict[str, Any]:
        """Execute the union plan for several targets at once.

        Joint planning lets the fused subgraph executor cover members that
        span multiple targets' dependency trees — the reason
        ``Context.get_data(run, [names])`` exists.
        """
        seen: Set[str] = set()
        plan: List[str] = []
        needed: Set[str] = set()
        with self.ctx.profiler.time("context.plan"):
            for target in targets:
                for name in self.resolve_execution_plan(target, run_id):
                    if name not in seen:
                        seen.add(name)
                        plan.append(name)
                needed |= self.compute_needed_set(plan, target, run_id)
            fusion_bundles = self._plan_fusion(run_id, needed, kwargs)
        fused_results: Dict[str, Any] = {}
        results: Dict[str, Any] = {}
        target_set = set(targets)
        for name in plan:
            if name not in needed:
                continue
            bundle = fusion_bundles.get(name)
            if bundle is not None and name not in fused_results:
                rule, members = bundle
                with self.ctx.profiler.time(f"fusion.{rule.name}.compute"):
                    fused_results.update(rule.compute(self.ctx, run_id, members))
            result = self.execute_single_plugin(
                run_id, name, is_target=(name in target_set),
                precomputed=fused_results, **kwargs
            )
            if name in target_set:
                results[name] = result
        for target in targets:
            if target not in results:
                results[target] = self.ctx._load_for_user(run_id, target)
        return results

    def run_plugins_batched(
        self, run_ids: List[str], targets: Any, **kwargs: Any
    ) -> Dict[str, Dict[str, Any]]:
        """Execute ``targets`` for several runs, batching fused bundles
        ACROSS runs.

        ``targets`` is either one name list applied to every run, or a
        ``{run_id: [names]}`` mapping — per-run lists avoid computing (and
        caching) names a given run never asked for.

        Planning happens per run (caches and run_config differ), then every
        run's fused-bundle members are handed to the fusion rule's
        ``compute_many`` in one call — runs with matching device config are
        concatenated on the event axis and dispatched as one device program
        (see WaveChainFusion.compute_many). The per-run plan walk then
        consumes those results exactly like single-run fused execution, so
        save/lineage/stats semantics are unchanged.
        """
        ctx = self.ctx
        per_run_targets = (
            {rid: list(targets[rid]) for rid in run_ids}
            if isinstance(targets, dict)
            else {rid: list(targets) for rid in run_ids}
        )
        run_info = []
        with ctx.profiler.time("context.plan"):
            for rid in run_ids:
                ctx.config_domain.prepare_request(rid)
                seen: Set[str] = set()
                plan: List[str] = []
                needed: Set[str] = set()
                for target in per_run_targets[rid]:
                    for name in self.resolve_execution_plan(target, rid):
                        if name not in seen:
                            seen.add(name)
                            plan.append(name)
                    needed |= self.compute_needed_set(plan, target, rid)
                bundles = self._plan_fusion(rid, needed, kwargs, batched=True)
                run_info.append((rid, plan, needed, bundles))

        # hand each rule every run's member set in ONE call
        rule_runs: Dict[int, Any] = {}
        for rid, _plan, _needed, bundles in run_info:
            by_rule: Dict[int, Any] = {}
            for _m, (rule, members) in bundles.items():
                by_rule[id(rule)] = (rule, members)
            for rule_id, (rule, members) in by_rule.items():
                rule_runs.setdefault(rule_id, (rule, []))[1].append(
                    (rid, members)
                )
        precomputed: Dict[str, Dict[str, Any]] = {rid: {} for rid in run_ids}
        for rule, rms in rule_runs.values():
            if len(rms) >= 2 and hasattr(rule, "compute_many"):
                with ctx.profiler.time(f"fusion.{rule.name}.compute_many"):
                    batched = rule.compute_many(ctx, rms)
                for rid, results in batched.items():
                    precomputed[rid].update(results)

        out: Dict[str, Dict[str, Any]] = {}
        for rid, plan, needed, bundles in run_info:
            target_set = set(per_run_targets[rid])
            ctx.config_domain.prepare_request(rid)
            fused_results = dict(precomputed[rid])
            results: Dict[str, Any] = {}
            for name in plan:
                if name not in needed:
                    continue
                bundle = bundles.get(name)
                if bundle is not None and name not in fused_results:
                    rule, members = bundle
                    with ctx.profiler.time(f"fusion.{rule.name}.compute"):
                        fused_results.update(rule.compute(ctx, rid, members))
                result = self.execute_single_plugin(
                    rid, name, is_target=(name in target_set),
                    precomputed=fused_results, **kwargs
                )
                if name in target_set:
                    results[name] = result
            for target in per_run_targets[rid]:
                if target not in results:
                    results[target] = ctx._load_for_user(rid, target)
            out[rid] = results
        return out

    def _plan_fusion(
        self, run_id: str, needed: Set[str], kwargs: Dict[str, Any],
        batched: bool = False,
    ) -> Dict[str, Any]:
        """Map member data name -> (rule, members) for applicable fusions.

        ``batched`` uses the rule's relaxed ``plan_batched`` (single members
        qualify: cross-run batching amortizes dispatch even for one plugin).
        """
        if kwargs or not self.ctx.config.get("fused_execution", True):
            return {}
        from waveformanalysis_tpu_torch.context.fusion import get_fusion_rules

        bundles: Dict[str, Any] = {}
        covered: Set[str] = set()
        for rule in get_fusion_rules():
            planner = (
                getattr(rule, "plan_batched", rule.plan) if batched
                else rule.plan
            )
            try:
                members = planner(self.ctx, run_id, needed - covered)
            except Exception as exc:  # pragma: no cover - defensive
                logger.debug("fusion rule %s rejected: %s", rule.name, exc)
                members = None
            if members:
                for m in members:
                    bundles[m] = (rule, list(members))
                covered.update(members)
        return bundles

    def execute_single_plugin(
        self,
        run_id: str,
        name: str,
        is_target: bool = False,
        precomputed: Optional[Dict[str, Any]] = None,
        **kwargs: Any,
    ) -> Any:
        ctx = self.ctx
        plugin = ctx._plugins[name]
        guard_key = (run_id, name)

        with self._in_progress_lock:
            if self._in_progress.get(guard_key):
                raise PluginError(
                    f"Runtime circular dependency: '{name}' is already being "
                    f"computed for run '{run_id}'",
                    plugin_name=name,
                )
            self._in_progress[guard_key] = True

        t0 = time.perf_counter()
        cache_hit = False
        success = True
        error_msg = None
        result = None
        try:
            with ctx.profiler.time(f"plugin.{name}.prepare"):
                key = ctx.cache_domain.key_for(run_id, name)
                result, cache_hit = ctx._cache_manager.check_cache(run_id, name, key)
                if cache_hit:
                    return result

                self._validate_plugin_config(plugin)
                self._validate_plugin_inputs(plugin, run_id)
            if precomputed is not None and name in precomputed:
                # produced by a fused device program this run; still flows
                # through the full contract/dtype/save pipeline below
                result = precomputed[name]
            else:
                with ctx.profiler.time(f"plugin.{name}.compute"):
                    result = self._compute_with_timeout(plugin, run_id, **kwargs)

            if plugin.output_kind == "stream" and _is_generator(result):
                result = self.wrap_generator_to_save(
                    run_id, name, plugin, result, is_target=is_target
                )
                return result

            with ctx.profiler.time(f"plugin.{name}.postprocess"):
                result = self.postprocess_plugin_result(
                    run_id, name, plugin, result, is_target=is_target
                )
                ctx._set_data(run_id, name, result)
            return result
        except Exception as exc:
            success = False
            error_msg = str(exc)
            self._handle_plugin_error(plugin, run_id, exc)
            raise
        finally:
            with self._in_progress_lock:
                self._in_progress.pop(guard_key, None)
            try:
                plugin.cleanup(ctx)
            except Exception as e:  # pragma: no cover
                logger.warning("Plugin %s cleanup failed: %s", name, e)
            if ctx.stats.enabled:
                ctx.stats.record_execution(
                    plugin_name=name,
                    run_id=run_id,
                    duration_s=time.perf_counter() - t0,
                    cache_hit=cache_hit,
                    success=success,
                    error=error_msg,
                    output_mb=estimate_mb(result) if ctx.stats.mode == "detailed" else None,
                )

    # -- pieces --------------------------------------------------------------

    def _validate_plugin_config(self, plugin: Any) -> None:
        # get_config performs Option validation + unit conversion
        plugin.validate_config(self.ctx)

    def _validate_plugin_inputs(self, plugin: Any, run_id: str) -> None:
        """Declared input_dtype fields must exist on the actual inputs
        (reference: context_execution.py:293 validates config then input
        dtypes before compute). Cheap: only plugins declaring input_dtype,
        and inputs are loaded through the normal cached get_data path."""
        if not getattr(plugin, "input_dtype", None):
            return
        ctx = self.ctx
        # materialize declared inputs so the check sees them (they would be
        # loaded by compute anyway)
        for dep in plugin.input_dtype:
            if ctx._get_data_from_memory(run_id, dep) is None:
                try:
                    ctx.get_data(run_id, dep)
                except Exception:
                    # missing/failing deps surface from compute's own
                    # get_data with full context; don't pre-empt here
                    return
        from waveformanalysis_tpu_torch.execution.validation import (
            ValidationManager,
        )

        ValidationManager(ctx).validate_input_dtypes(plugin, run_id)

    def _compute_with_timeout(self, plugin: Any, run_id: str, **kwargs: Any) -> Any:
        timeout = getattr(plugin, "timeout", None)
        if not timeout:
            return plugin.compute(self.ctx, run_id, **kwargs)
        box: Dict[str, Any] = {}
        token = handoff()

        def runner() -> None:
            try:
                with adopt(token):
                    box["result"] = plugin.compute(self.ctx, run_id, **kwargs)
            except BaseException as e:  # noqa: BLE001
                box["error"] = e

        t = threading.Thread(target=runner, daemon=True)
        t.start()
        t.join(timeout)
        if t.is_alive():
            raise TimeoutError_(
                f"Plugin '{plugin.provides}' exceeded timeout of {timeout}s"
            )
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def _handle_plugin_error(self, plugin: Any, run_id: str, exc: Exception) -> None:
        ctx = self.ctx
        severity = getattr(exc, "severity", ErrorSeverity.FATAL)
        snapshot = ctx.error_manager.collect_context(plugin=plugin, context=ctx)
        ctx.error_manager.record(
            exc, plugin_name=plugin.provides, run_id=run_id, context=snapshot
        )
        try:
            plugin.on_error(ctx, exc)
        except Exception as hook_err:  # pragma: no cover
            logger.warning("Plugin %s on_error hook failed: %s", plugin.provides, hook_err)
        if severity is ErrorSeverity.RECOVERABLE:
            logger.warning(
                "Recoverable error in plugin %s: %s", plugin.provides, exc
            )

    def postprocess_plugin_result(
        self, run_id: str, name: str, plugin: Any, result: Any, is_target: bool
    ) -> Any:
        """Output contract enforcement + dtype conversion + save."""
        result = self._enforce_output_contract(name, plugin, result)
        result = self._convert_output_dtype(plugin, result)
        if self._should_save(plugin, is_target):
            self.save_plugin_result(run_id, name, plugin, result)
        return result

    def _should_save(self, plugin: Any, is_target: bool) -> bool:
        return plugin.save_when == "always" or (
            plugin.save_when == "target" and is_target
        )

    def _enforce_output_contract(self, name: str, plugin: Any, result: Any) -> Any:
        if name in FLAT_CHANNEL_OUTPUTS:
            is_flat = (
                isinstance(result, Table) and "channel" in result
            ) or (
                isinstance(result, np.ndarray)
                and result.dtype.names is not None
                and "channel" in result.dtype.names
            )
            if not is_flat:
                raise ValidationError(
                    f"Plugin '{name}' must return a single flat array/Table with "
                    f"a 'channel' field, got {type(result).__name__}"
                )
        return result

    def _convert_output_dtype(self, plugin: Any, result: Any) -> Any:
        out_dtype = plugin.output_dtype
        if (
            isinstance(result, np.ndarray)
            and result.dtype.names is not None
            and isinstance(out_dtype, np.dtype)
            and out_dtype.names is not None
            and result.dtype != out_dtype
            and result.dtype.names == out_dtype.names
        ):
            converted = np.zeros(len(result), dtype=out_dtype)
            for f in out_dtype.names:
                converted[f] = result[f]
            return converted
        return result

    def save_plugin_result(self, run_id: str, name: str, plugin: Any, result: Any) -> None:
        """Persist a plugin output (async by default).

        The write runs on the Context's single writer thread so downstream
        plugins start immediately — the reference's synchronous
        save-then-continue (context_execution.py:185) serialized the whole
        DAG behind storage. Plugin outputs are immutable by framework
        contract (the memory cache already shares them), so serializing
        from the same arrays off-thread is safe. Reads of a pending key
        barrier on the write (wait_for_pending_save); disable with
        config={"async_save": False}.
        """
        ctx = self.ctx
        # key/lineage/backend resolve on the CALLER thread: they touch
        # context caches that set_config may clear concurrently
        key = ctx.cache_domain.key_for(run_id, name)
        storage = ctx._get_storage_for_data_name(name)
        lineage = ctx.get_lineage(name)
        if ctx.config.get("async_save", True):
            from concurrent.futures import ThreadPoolExecutor

            if self._save_pool is None:
                self._save_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="wfa-save"
                )
            reg_key = (self._storage_root(), run_id, name)
            with _PENDING_SAVES_LOCK:
                # opportunistic purge: completed entries (never read back
                # through a barrier) must not accumulate in long processes
                done = [k for k, f in _PENDING_SAVES.items()
                        if f.done() and f.exception() is None]
                for k in done:
                    _PENDING_SAVES.pop(k, None)
                fut = self._save_pool.submit(
                    self._write, key, storage, lineage, run_id, name, result,
                    handoff(),
                )
                _PENDING_SAVES[reg_key] = fut
            return
        self._write(key, storage, lineage, run_id, name, result)

    def _storage_root(self) -> str:
        return str(getattr(self.ctx, "storage_dir", "") or "")

    def wait_for_pending_save(self, run_id: str, name: str) -> None:
        """Barrier: complete any in-flight async save of (run, name) —
        across every Context over this storage root in the process."""
        with _PENDING_SAVES_LOCK:
            fut = _PENDING_SAVES.pop((self._storage_root(), run_id, name), None)
        if fut is not None:
            fut.result()  # re-raises writer-thread failures

    def flush_saves(self) -> None:
        """Complete every in-flight async save under this storage root."""
        root = self._storage_root()
        with _PENDING_SAVES_LOCK:
            keys = [k for k in _PENDING_SAVES if k[0] == root]
            futs = [_PENDING_SAVES.pop(k) for k in keys]
        for fut in futs:
            fut.result()

    def _write(self, key: str, storage: Any, lineage: Any, run_id: str,
               name: str, result: Any, token: Any = None) -> None:
        """Save ``result`` under ``key`` and count the bytes the save added
        to the cache as ``cache.bytes_written.<name>``. On the writer thread
        ``token`` (the enqueuing thread's ``handoff()``) puts the span in the
        request and under the span that enqueued it."""
        ctx = self.ctx
        channels = isinstance(result, (list, tuple)) and all(
            isinstance(r, np.ndarray) for r in result
        )
        # the legacy multi-channel layout: one entry per channel
        keys = [f"{key}_ch{i}" for i in range(len(result))] if channels else [key]
        sized = getattr(storage, "stored_bytes", None)
        with adopt(token) if token else nullcontext(), ctx.profiler.time("context.save_cache"):
            before = sum(sized(k, run_id) for k in keys) if sized else 0
            if _is_dataframe(result):
                storage.save_dataframe(key, result, run_id=run_id, lineage=lineage)
            elif isinstance(result, (Table, np.ndarray)):
                storage.save_memmap(key, result, run_id=run_id, lineage=lineage)
            elif channels:
                for i, arr in enumerate(result):
                    storage.save_memmap(
                        keys[i], arr, run_id=run_id, lineage=lineage,
                        extra_metadata={"channel_index": i, "channel_count": len(result)},
                    )
            else:
                logger.debug(
                    "Result of '%s' (%s) is not persistable; skipping save",
                    name, type(result).__name__,
                )
                return
            if sized:
                ctx.profiler.count(f"cache.bytes_written.{name}",
                                   sum(sized(k, run_id) for k in keys) - before)

    # -- streaming save-through ----------------------------------------------

    def wrap_generator_to_save(
        self,
        run_id: str,
        name: str,
        plugin: Any,
        gen: Generator,
        is_target: bool,
    ) -> Generator:
        """Persist stream chunks incrementally while yielding them through."""
        if not self._should_save(plugin, is_target):
            return gen

        ctx = self.ctx
        key = ctx.cache_domain.key_for(run_id, name)
        storage = ctx._get_storage_for_data_name(name)
        lineage = ctx.get_lineage(name)

        def saving_gen() -> Generator:
            writer = storage.save_stream(key, run_id=run_id)
            try:
                for chunk in gen:
                    payload = chunk.data if hasattr(chunk, "data") else chunk
                    if isinstance(payload, (Table, np.ndarray)) and len(payload) > 0:
                        writer.append(payload)
                    yield chunk
                storage.finalize_save(key, writer, run_id=run_id, lineage=lineage)
            except BaseException:
                writer.abort()
                raise

        return saving_gen()


def _is_generator(obj: Any) -> bool:
    return hasattr(obj, "__next__") or isinstance(obj, Generator)


def _is_dataframe(obj: Any) -> bool:
    return type(obj).__name__ == "DataFrame" and hasattr(obj, "to_parquet")
