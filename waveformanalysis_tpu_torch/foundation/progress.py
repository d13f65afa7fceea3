"""Progress tracking with ETA/throughput.

Behavioral analog of the reference ProgressTracker
(reference: waveform_analysis/core/foundation/progress.py:37). Uses tqdm when
available and enabled, otherwise a silent counter, so library code can always
call it unconditionally.
"""

from __future__ import annotations

import functools
import inspect
import threading
import time
from typing import (
    Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence,
)


class ProgressTracker:
    """Multi-bar progress tracker.

    ``track(name, total)`` opens a named bar; ``update(name, n)`` advances it;
    ``close(name)`` finishes it. Throughput and ETA come from wall-clock deltas.
    """

    def __init__(self, enabled: bool = True, use_tqdm: bool = True) -> None:
        self.enabled = enabled
        self._bars: Dict[str, Any] = {}
        self._state: Dict[str, Dict[str, Any]] = {}
        self._tqdm = None
        if use_tqdm:
            try:
                from tqdm.auto import tqdm  # type: ignore

                self._tqdm = tqdm
            except Exception:
                self._tqdm = None

    def track(self, name: str, total: Optional[int] = None, desc: str = "") -> None:
        if not self.enabled:
            return
        self._state[name] = {"total": total, "done": 0, "t0": time.perf_counter()}
        if self._tqdm is not None:
            self._bars[name] = self._tqdm(total=total, desc=desc or name, leave=False)

    def update(self, name: str, n: int = 1) -> None:
        st = self._state.get(name)
        if st is None:
            return
        st["done"] += n
        bar = self._bars.get(name)
        if bar is not None:
            bar.update(n)

    def close(self, name: str) -> None:
        bar = self._bars.pop(name, None)
        if bar is not None:
            bar.close()
        self._state.pop(name, None)

    def close_all(self) -> None:
        for name in list(self._state):
            self.close(name)

    def stats(self, name: str) -> Optional[Dict[str, Any]]:
        st = self._state.get(name)
        if st is None:
            return None
        elapsed = time.perf_counter() - st["t0"]
        done = st["done"]
        total = st["total"]
        rate = done / elapsed if elapsed > 0 else 0.0
        eta = (total - done) / rate if (total and rate > 0) else None
        return {"done": done, "total": total, "elapsed_s": elapsed, "rate": rate, "eta_s": eta}

    # context-manager form: all bars close on exit
    # (reference: foundation/progress.py:300)
    def __enter__(self) -> "ProgressTracker":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> bool:
        self.close_all()
        return False


# ---------------------------------------------------------------------------
# module-level helpers: global tracker, decorator, iterator/map wrappers,
# display formatting (reference: foundation/progress.py:307-680)
# ---------------------------------------------------------------------------

_local = threading.local()


def get_global_tracker() -> ProgressTracker:
    """The per-thread shared tracker (created on first use)."""
    tracker = getattr(_local, "tracker", None)
    if tracker is None:
        tracker = ProgressTracker()
        _local.tracker = tracker
    return tracker


def reset_global_tracker() -> None:
    """Close and discard the per-thread tracker (tests, state cleanup)."""
    tracker = getattr(_local, "tracker", None)
    if tracker is not None:
        tracker.close_all()
        del _local.tracker


def format_time(seconds: float) -> str:
    """``'42s'`` / ``'MM:SS'`` / ``'HH:MM:SS'`` depending on magnitude."""
    if seconds < 60:
        return f"{int(seconds):02d}s"
    if seconds < 3600:
        return f"{int(seconds // 60):02d}:{int(seconds % 60):02d}"
    hours = int(seconds // 3600)
    return f"{hours:02d}:{int((seconds % 3600) // 60):02d}:{int(seconds % 60):02d}"


def format_throughput(throughput: float, unit: str = "it") -> str:
    """Rate with magnitude-dependent precision: 0.50 / 5.1 / 123 unit/s."""
    if throughput < 1:
        return f"{throughput:.2f} {unit}/s"
    if throughput < 10:
        return f"{throughput:.1f} {unit}/s"
    return f"{int(throughput)} {unit}/s"


def progress_iter(
    iterable: Iterable[Any],
    total: Optional[int] = None,
    desc: str = "",
    tracker: Optional[ProgressTracker] = None,
    name: Optional[str] = None,
) -> Iterator[Any]:
    """Yield from ``iterable`` while advancing a progress bar.

    ``total`` is inferred via ``len()`` when possible; generators show an
    unbounded bar (reference: foundation/progress.py:588).
    """
    _tracker = tracker if tracker is not None else get_global_tracker()
    if total is None:
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
    bar = name or f"iter_{id(iterable)}"
    _tracker.track(bar, total=total, desc=desc)
    try:
        for item in iterable:
            yield item
            _tracker.update(bar)
    finally:
        _tracker.close(bar)


def progress_map(
    func: Callable[[Any], Any],
    iterable: Sequence[Any],
    desc: str = "",
    tracker: Optional[ProgressTracker] = None,
) -> List[Any]:
    """``list(map(func, iterable))`` with a progress bar
    (reference: foundation/progress.py:649)."""
    return [
        func(item)
        for item in progress_iter(iterable, desc=desc, tracker=tracker)
    ]


def with_progress(
    total: Optional[int] = None,
    desc: Optional[str] = None,
    disable: bool = False,
    tracker: Optional[ProgressTracker] = None,
    bar_name: Optional[str] = None,
) -> Callable:
    """Decorator adding progress tracking to a function
    (reference: foundation/progress.py:413-585).

    - generator functions: each yield advances the bar;
    - functions returning a list/tuple (or other sized iterable): the bar
      completes when the call returns, sized by the result;
    - regular functions: an indeterminate bar spans the call.

    The untouched return value/iteration behavior is preserved in every
    case.
    """

    def decorator(func: Callable) -> Callable:
        func_name = func.__name__
        is_gen = inspect.isgeneratorfunction(func)

        @functools.wraps(func)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            if disable:
                return func(*args, **kwargs)
            _tracker = tracker if tracker is not None else get_global_tracker()
            bar = bar_name or f"{func_name}_{id(wrapper)}"
            _desc = desc or func_name
            if is_gen:
                def gen() -> Iterator[Any]:
                    _tracker.track(bar, total=total, desc=_desc)
                    try:
                        for item in func(*args, **kwargs):
                            yield item
                            _tracker.update(bar)
                    finally:
                        _tracker.close(bar)

                return gen()
            _tracker.track(bar, total=total, desc=_desc)
            try:
                result = func(*args, **kwargs)
                n = total
                if n is None:
                    try:
                        n = len(result)  # type: ignore[arg-type]
                    except TypeError:
                        n = 1
                _tracker.update(bar, n or 1)
                return result
            finally:
                _tracker.close(bar)

        return wrapper

    return decorator
