"""Multi-run batch fan-out.

Behavioral analog of the reference BatchProcessor
(reference: waveform_analysis/core/data/batch_processor.py:153-1068):
``process_runs`` fans run ids over a thread pool (cloned contexts) or a
process pool (picklable context factory); per-run error strategies
continue/stop/raise with retries; config-grid sweeps rerun the same run
under different configs; cooperative cancellation tokens abort the batch.

Port of ``waveformanalysis_tpu/data/batch_processor.py``. Process pools
start their workers with ``spawn`` (execution/manager.py), so a worker's
Context reaches the card from a fresh interpreter; the ``device`` executor
batches the runs into one fused program per device configuration on the
Context's own device.
"""

from __future__ import annotations

import logging
import time
import traceback
from concurrent.futures import FIRST_COMPLETED, as_completed, wait
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from waveformanalysis_tpu_torch.execution.cancellation import CancellationToken
from waveformanalysis_tpu_torch.execution.manager import get_executor, is_picklable
from waveformanalysis_tpu_torch.foundation.exceptions import CancelledError

logger = logging.getLogger(__name__)


@dataclass
class RunResult:
    run_id: str
    success: bool
    data: Any = None
    error: Optional[str] = None
    traceback_str: Optional[str] = None
    duration_s: float = 0.0
    attempts: int = 1
    config_overrides: Optional[Dict[str, Any]] = None


@dataclass
class BatchResult:
    results: Dict[str, RunResult] = field(default_factory=dict)
    cancelled: bool = False

    @property
    def succeeded(self) -> List[str]:
        return [r for r, res in self.results.items() if res.success]

    @property
    def failed(self) -> List[str]:
        return [r for r, res in self.results.items() if not res.success]

    def get(self, run_id: str) -> Optional[RunResult]:
        return self.results.get(run_id)

    def summary(self) -> str:
        lines = [
            f"Batch: {len(self.succeeded)} succeeded, {len(self.failed)} failed"
            + (" (cancelled)" if self.cancelled else "")
        ]
        for run_id in self.failed:
            lines.append(f"  FAILED {run_id}: {self.results[run_id].error}")
        return "\n".join(lines)


def _run_single_task(factory_or_ctx: Any, run_id: str, data_name: str,
                     config_overrides: Optional[Dict[str, Any]] = None) -> Any:
    """Worker body (module-level so process pools can pickle it)."""
    ctx = factory_or_ctx() if callable(factory_or_ctx) else factory_or_ctx
    if config_overrides:
        ctx.set_config(config_overrides)
    data = ctx.get_data(run_id, data_name)
    # async cache writes must be ON DISK before this task reports done:
    # the parent (or another worker) may read the shared storage the moment
    # the future resolves, and cross-process readers cannot barrier on this
    # process's pending-save registry
    if hasattr(ctx, "flush_saves"):
        ctx.flush_saves()
    return data


def _process_worker(
    factory: Any,
    run_id: str,
    data_name: str,
    config_overrides: Optional[Dict[str, Any]],
    retries: int,
) -> Dict[str, Any]:
    """Self-contained process-pool worker: only picklable args, plain-dict
    result (RunResult assembly happens in the parent)."""
    t0 = time.perf_counter()
    attempts = 0
    last_error: Optional[BaseException] = None
    while attempts <= retries:
        attempts += 1
        try:
            data = _run_single_task(factory, run_id, data_name, config_overrides)
            return {
                "success": True, "data": data, "attempts": attempts,
                "duration_s": time.perf_counter() - t0,
            }
        except Exception as e:  # noqa: BLE001
            last_error = e
    return {
        "success": False, "data": None, "attempts": attempts,
        "duration_s": time.perf_counter() - t0,
        "error": str(last_error),
        "traceback_str": "".join(traceback.format_exception(last_error)),
    }


class BatchProcessor:
    """Fans independent runs (or config variants) over executor pools."""

    def __init__(
        self,
        context: Any,
        executor_type: str = "thread",
        max_workers: Optional[int] = None,
        on_error: str = "continue",  # continue | stop | raise
        retries: int = 0,
        retry_on: Tuple[type, ...] = (Exception,),
        show_progress: bool = False,
    ) -> None:
        if on_error not in ("continue", "stop", "raise"):
            raise ValueError("on_error must be continue|stop|raise")
        if executor_type not in ("thread", "process", "device"):
            raise ValueError("executor_type must be thread|process|device")
        self.context = context
        self.executor_type = executor_type
        self.max_workers = max_workers
        self.on_error = on_error
        self.retries = retries
        self.retry_on = retry_on
        self.show_progress = show_progress

    # -- internals -----------------------------------------------------------

    def _worker_target(self) -> Any:
        """Context provider per executor type: clone (thread) or picklable
        factory (process)."""
        if self.executor_type == "process":
            factory = self.context.create_context_factory()
            if not is_picklable(factory):
                raise ValueError(
                    "Context factory is not picklable; use executor_type='thread'"
                )
            return factory
        return lambda: self.context.clone()

    def _attempt(
        self,
        provider: Any,
        run_id: str,
        data_name: str,
        config_overrides: Optional[Dict[str, Any]],
        token: Optional[CancellationToken],
    ) -> RunResult:
        t0 = time.perf_counter()
        attempts = 0
        last_error: Optional[BaseException] = None
        while attempts <= self.retries:
            attempts += 1
            if token is not None and token.cancelled:
                raise CancelledError(f"batch cancelled before run {run_id}")
            try:
                data = _run_single_task(provider, run_id, data_name, config_overrides)
                return RunResult(
                    run_id=run_id, success=True, data=data,
                    duration_s=time.perf_counter() - t0, attempts=attempts,
                    config_overrides=config_overrides,
                )
            except CancelledError:
                raise
            except self.retry_on as e:
                last_error = e
                if attempts <= self.retries:
                    logger.warning(
                        "run %s attempt %d failed (%s); retrying",
                        run_id, attempts, e,
                    )
        return RunResult(
            run_id=run_id, success=False,
            error=str(last_error),
            traceback_str="".join(traceback.format_exception(last_error)),
            duration_s=time.perf_counter() - t0, attempts=attempts,
            config_overrides=config_overrides,
        )

    # -- public API ------------------------------------------------------------

    def process_runs(
        self,
        run_ids: Sequence[str],
        data_name: str,
        cancellation_token: Optional[CancellationToken] = None,
        keep_data: bool = True,
        poll_interval_s: Optional[float] = None,
        on_progress: Optional[Callable[[int, int], None]] = None,
    ) -> BatchResult:
        """Compute ``data_name`` for every run id
        (reference: batch_processor.py:197).

        poll_interval_s enables polling mode (the reference's Jupyter mode,
        batch_processor.py:330): instead of blocking until each future
        completes, the loop wakes every interval and reports progress via
        ``on_progress(done, total)`` — keeping notebook output and
        cancellation responsive while workers run.
        """
        if self.executor_type == "device":
            return self._process_runs_device(
                run_ids, data_name, cancellation_token, keep_data, on_progress
            )
        tasks = [(rid, None) for rid in run_ids]
        return self._process_tasks(tasks, data_name, cancellation_token,
                                   keep_data, poll_interval_s, on_progress)

    def _process_runs_device(
        self,
        run_ids: Sequence[str],
        data_name: str,
        token: Optional[CancellationToken],
        keep_data: bool,
        on_progress: Optional[Callable[[int, int], None]],
    ) -> BatchResult:
        """Device-batched multi-run execution.

        The reference fans runs over host process pools
        (reference: batch_processor.py:197); on the card the batch dimension IS
        the parallel axis: all runs dispatch through
        ``Context.get_data_batched``, which concatenates their fused wave
        bundles into one device program per matching configuration. Falls
        back to a serial per-run loop (preserving on_error/retry isolation)
        if the batched dispatch fails as a whole.
        """
        result = BatchResult()
        if token is not None and token.cancelled:
            result.cancelled = True
            return result
        t0 = time.perf_counter()
        try:
            data = self.context.get_data_batched(list(run_ids), data_name)
            # mirror the pool workers' contract: saves are ON DISK before
            # the batch reports done (_run_single_task flushes the same way)
            if hasattr(self.context, "flush_saves"):
                self.context.flush_saves()
            per_run = time.perf_counter() - t0
            for rid in run_ids:
                result.results[rid] = RunResult(
                    run_id=rid, success=True,
                    data=data[rid] if keep_data else None,
                    duration_s=per_run / max(len(run_ids), 1),
                )
            if on_progress is not None:
                on_progress(len(run_ids), len(run_ids))
            return result
        except Exception as e:  # noqa: BLE001
            if self.on_error == "raise":
                raise
            logger.warning(
                "device-batched dispatch failed (%s); retrying runs "
                "individually", e,
            )
        provider = lambda: self.context  # noqa: E731 - same-context serial
        done = 0
        for rid in run_ids:
            if token is not None and token.cancelled:
                result.cancelled = True
                break
            run_result = self._attempt(provider, rid, data_name, None, token)
            if not keep_data:
                run_result.data = None
            result.results[rid] = run_result
            done += 1
            if on_progress is not None:
                on_progress(done, len(run_ids))
            if not run_result.success and self.on_error == "stop":
                break
        return result

    def process_runs_with_config_grid(
        self,
        run_ids: Sequence[str],
        data_name: str,
        config_grid: Sequence[Dict[str, Any]],
        cancellation_token: Optional[CancellationToken] = None,
        keep_data: bool = True,
    ) -> BatchResult:
        """Sweep each run over config variants
        (reference: batch_processor.py:956). Result keys are
        '{run_id}#{variant_index}'."""
        if self.executor_type == "device":
            raise ValueError(
                "config-grid sweeps vary per-task config and cannot share "
                "one batched device program; use executor_type='thread' or "
                "'process'"
            )
        tasks = []
        for rid in run_ids:
            for i, overrides in enumerate(config_grid):
                tasks.append((f"{rid}#{i}", dict(overrides, __run_id=rid)))
        return self._process_tasks(tasks, data_name, cancellation_token, keep_data)

    def _iter_completed(self, futures, poll_interval_s, on_progress, token,
                        result):
        """as_completed, or polling-mode wait loop with progress callbacks."""
        if not poll_interval_s:
            yield from as_completed(futures)
            return
        total = len(futures)
        pending = set(futures)
        while pending:
            done, pending = wait(pending, timeout=poll_interval_s,
                                 return_when=FIRST_COMPLETED)
            if on_progress is not None:
                try:
                    on_progress(total - len(pending), total)
                except Exception:  # progress display must never kill the batch
                    logger.debug("on_progress callback failed", exc_info=True)
            yield from done  # deliver finished work before honoring cancel
            if token is not None and token.cancelled:
                for fut in pending:
                    fut.cancel()
                result.cancelled = True
                return

    def process_func(
        self,
        run_ids: Sequence[str],
        fn: Callable[[Any, str], Any],
        cancellation_token: Optional[CancellationToken] = None,
    ) -> BatchResult:
        """Apply an arbitrary fn(context, run_id) per run (thread only;
        reference: batch_processor.py:630)."""
        result = BatchResult()
        with get_executor("batch", executor_type="thread",
                          max_workers=self.max_workers) as pool:
            futures = {
                pool.submit(self._func_attempt, fn, rid, cancellation_token): rid
                for rid in run_ids
            }
            for fut in as_completed(futures):
                rid = futures[fut]
                try:
                    result.results[rid] = fut.result()
                except CancelledError:
                    result.cancelled = True
                    break
        return result

    def _func_attempt(self, fn, run_id, token) -> RunResult:
        t0 = time.perf_counter()
        if token is not None and token.cancelled:
            raise CancelledError("cancelled")
        try:
            ctx = self.context.clone()
            data = fn(ctx, run_id)
            return RunResult(run_id=run_id, success=True, data=data,
                             duration_s=time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001
            if self.on_error == "raise":
                raise
            return RunResult(run_id=run_id, success=False, error=str(e),
                             traceback_str=traceback.format_exc(),
                             duration_s=time.perf_counter() - t0)

    def _process_tasks(
        self,
        tasks: List[Tuple[str, Optional[Dict[str, Any]]]],
        data_name: str,
        token: Optional[CancellationToken],
        keep_data: bool,
        poll_interval_s: Optional[float] = None,
        on_progress: Optional[Callable[[int, int], None]] = None,
    ) -> BatchResult:
        provider = self._worker_target()
        result = BatchResult()

        use_process = self.executor_type == "process"

        def submit_all(pool):
            futures = {}
            for key, overrides in tasks:
                if token is not None and token.cancelled:
                    result.cancelled = True
                    break
                run_id = key.split("#")[0] if overrides and "__run_id" in overrides \
                    else key
                clean = None
                if overrides:
                    clean = {k: v for k, v in overrides.items() if k != "__run_id"}
                if use_process:
                    fut = pool.submit(
                        _process_worker, provider, run_id, data_name, clean,
                        self.retries,
                    )
                else:
                    fut = pool.submit(
                        self._attempt, provider, run_id, data_name, clean, token
                    )
                futures[fut] = key
            return futures

        with get_executor("batch", executor_type=self.executor_type,
                          max_workers=self.max_workers) as pool:
            futures = submit_all(pool)
            stop = False
            for fut in self._iter_completed(futures, poll_interval_s,
                                            on_progress, token, result):
                key = futures[fut]
                try:
                    raw = fut.result()
                    if isinstance(raw, dict):  # process-pool plain-dict result
                        run_result = RunResult(run_id=key, **{
                            k: v for k, v in raw.items()
                            if k in ("success", "data", "error",
                                     "traceback_str", "duration_s", "attempts")
                        })
                    else:
                        run_result = raw
                except CancelledError:
                    result.cancelled = True
                    stop = True
                    continue
                except Exception as e:  # worker infra error
                    run_result = RunResult(
                        run_id=key, success=False, error=str(e),
                        traceback_str=traceback.format_exc(),
                    )
                if not keep_data:
                    run_result.data = None
                run_result.run_id = key
                result.results[key] = run_result
                if not run_result.success:
                    if self.on_error == "raise":
                        for other in futures:
                            other.cancel()
                        raise RuntimeError(
                            f"run {key} failed: {run_result.error}"
                        )
                    if self.on_error == "stop":
                        for other in futures:
                            other.cancel()
                        stop = True
                if stop:
                    break
        return result
