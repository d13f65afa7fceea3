"""Executor pools and convenience parallel helpers.

Behavioral analog of the reference execution manager
(reference: waveform_analysis/core/execution/manager.py:35-800): a
process-wide ExecutorManager hands out thread/process pools keyed by
(name, type, workers) with reference counting and context-manager
acquisition, plus ``parallel_map`` / ``parallel_apply`` conveniences with
optional progress.

Port of ``waveformanalysis_tpu/execution/manager.py``. These pools serve
*host-side* work only (file parsing, per-run fan-out); device parallelism is
the batch axis of the kernels. Named EXECUTOR_CONFIGS keep the reference's
tuning vocabulary. Process pools start their workers with ``spawn``: a
forked child of a process that has initialised CUDA cannot use the card.
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import threading
from concurrent.futures import (
    Executor,
    Future,
    ProcessPoolExecutor,
    ThreadPoolExecutor,
    as_completed,
)
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

# Named executor configurations (reference: core/execution/config.py:15-61).
EXECUTOR_CONFIGS: Dict[str, Dict[str, Any]] = {
    "io_intensive": {"executor_type": "thread", "max_workers": 16},
    "cpu_intensive": {"executor_type": "process", "max_workers": None},
    "large_data": {"executor_type": "process", "max_workers": 4},
    "small_data": {"executor_type": "thread", "max_workers": 8},
    "waveform_loading": {"executor_type": "thread", "max_workers": 16},
    "event_grouping": {"executor_type": "process", "max_workers": None},
    "feature_computation": {"executor_type": "thread", "max_workers": 8},
}


def resolve_executor_config(name: str) -> Dict[str, Any]:
    if name not in EXECUTOR_CONFIGS:
        raise KeyError(
            f"Unknown executor config {name!r}; available: {sorted(EXECUTOR_CONFIGS)}"
        )
    cfg = dict(EXECUTOR_CONFIGS[name])
    if cfg["max_workers"] is None:
        cfg["max_workers"] = os.cpu_count() or 4
    return cfg


def get_config(config_name: str) -> Dict[str, Any]:
    """Copy of a named executor config, unresolved
    (reference: core/execution/config.py:64 get_config)."""
    if config_name not in EXECUTOR_CONFIGS:
        raise KeyError(
            f"Unknown executor config {config_name!r}; "
            f"available: {sorted(EXECUTOR_CONFIGS)}"
        )
    return dict(EXECUTOR_CONFIGS[config_name])


def register_config(name: str, config: Dict[str, Any]) -> None:
    """Register/override a named executor config
    (reference: core/execution/config.py:84 register_config)."""
    EXECUTOR_CONFIGS[name] = dict(config)


@dataclass
class _PoolEntry:
    executor: Executor
    refcount: int = 0


class ExecutorManager:
    """Singleton pool registry with keyed reuse and refcounting."""

    _instance: Optional["ExecutorManager"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._pools: Dict[Tuple[str, str, int], _PoolEntry] = {}
        self._lock = threading.Lock()
        self._stats = {"created": 0, "reused": 0, "shutdown": 0}

    @classmethod
    def instance(cls) -> "ExecutorManager":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        """Shutdown all pools (tests / interpreter exit)."""
        with cls._instance_lock:
            if cls._instance is not None:
                cls._instance.shutdown_all()
                cls._instance = None

    # -- acquisition ------------------------------------------------------------

    @contextmanager
    def get_executor(
        self,
        name: str = "default",
        executor_type: str = "thread",
        max_workers: Optional[int] = None,
        reuse: bool = True,
    ) -> Iterator[Executor]:
        """Context-managed executor acquisition; reused pools stay alive."""
        if executor_type not in ("thread", "process"):
            raise ValueError(
                f"executor_type must be 'thread' or 'process', got {executor_type!r}"
            )
        workers = max_workers or (os.cpu_count() or 4)
        key = (name, executor_type, workers)

        if not reuse:
            executor = self._make(executor_type, workers)
            try:
                yield executor
            finally:
                executor.shutdown(wait=True)
            return

        with self._lock:
            entry = self._pools.get(key)
            if entry is None:
                entry = _PoolEntry(executor=self._make(executor_type, workers))
                self._pools[key] = entry
                self._stats["created"] += 1
            else:
                self._stats["reused"] += 1
            entry.refcount += 1
        try:
            yield entry.executor
        finally:
            with self._lock:
                entry.refcount -= 1

    def _make(self, executor_type: str, workers: int) -> Executor:
        if executor_type == "process":
            # spawn, not fork: a forked child inherits a CUDA context it
            # cannot use (and fork is unsafe in a threaded process)
            return ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("spawn"),
            )
        return ThreadPoolExecutor(max_workers=workers)

    # -- lifecycle ---------------------------------------------------------------

    def shutdown_all(self, wait: bool = True) -> None:
        with self._lock:
            for key, entry in list(self._pools.items()):
                entry.executor.shutdown(wait=wait)
                self._stats["shutdown"] += 1
            self._pools.clear()

    def shutdown_idle(self) -> int:
        """Shutdown pools with zero refcount; returns the count."""
        n = 0
        with self._lock:
            for key in list(self._pools):
                if self._pools[key].refcount <= 0:
                    self._pools.pop(key).executor.shutdown(wait=False)
                    n += 1
                    self._stats["shutdown"] += 1
        return n

    def get_stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                **self._stats,
                "active_pools": len(self._pools),
                "pools": {
                    f"{k[0]}/{k[1]}/{k[2]}": e.refcount
                    for k, e in self._pools.items()
                },
            }


def get_executor(
    name: str = "default",
    executor_type: str = "thread",
    max_workers: Optional[int] = None,
    reuse: bool = True,
):
    """Module-level convenience mirroring the reference API."""
    if name in EXECUTOR_CONFIGS and executor_type == "thread" and max_workers is None:
        cfg = resolve_executor_config(name)
        executor_type = cfg["executor_type"]
        max_workers = cfg["max_workers"]
    return ExecutorManager.instance().get_executor(
        name=name, executor_type=executor_type, max_workers=max_workers, reuse=reuse
    )


def parallel_map(
    fn: Callable[[Any], Any],
    items: Sequence[Any],
    executor_type: str = "thread",
    max_workers: Optional[int] = None,
    show_progress: bool = False,
    ordered: bool = True,
    name: str = "parallel_map",
) -> List[Any]:
    """Map fn over items in a pool; ordered results by default
    (reference: manager.py:425)."""
    items = list(items)
    if not items:
        return []
    if max_workers == 1 or len(items) == 1:
        iterator = items
        if show_progress:
            iterator = _progress(iterator, total=len(items), desc=name)
        return [fn(x) for x in iterator]

    results: List[Any] = [None] * len(items)
    with get_executor(name, executor_type=executor_type,
                      max_workers=max_workers) as pool:
        futures = {pool.submit(fn, item): i for i, item in enumerate(items)}
        done_iter = as_completed(futures)
        if show_progress:
            done_iter = _progress(done_iter, total=len(items), desc=name)
        for fut in done_iter:
            results[futures[fut]] = fut.result()
    return results


def parallel_apply(
    fns: Sequence[Callable[[], Any]],
    executor_type: str = "thread",
    max_workers: Optional[int] = None,
    show_progress: bool = False,
    name: str = "parallel_apply",
) -> List[Any]:
    """Run independent thunks concurrently (reference: manager.py:582)."""
    return parallel_map(
        lambda f: f(), list(fns), executor_type=executor_type,
        max_workers=max_workers, show_progress=show_progress, name=name,
    )


def _progress(iterable: Iterable, total: int, desc: str) -> Iterable:
    try:
        from tqdm.auto import tqdm  # type: ignore

        return tqdm(iterable, total=total, desc=desc, leave=False)
    except ImportError:
        return iterable


def is_picklable(obj: Any) -> bool:
    """Probe before handing work to a process pool
    (reference: streaming.py:84-89)."""
    import pickle

    try:
        pickle.dumps(obj)
        return True
    except Exception:
        return False


def get_executor_manager() -> ExecutorManager:
    """The global executor manager singleton
    (reference: core/execution/manager.py:389)."""
    return ExecutorManager.instance()
