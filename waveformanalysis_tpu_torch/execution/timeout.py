"""Per-task timeouts.

Behavioral analog of the reference TimeoutManager
(reference: waveform_analysis/core/execution/timeout.py:31-210): SIGALRM in
the main thread, thread-join elsewhere; ``with_timeout`` decorator; stats.

Port of ``waveformanalysis_tpu/execution/timeout.py``.
"""

from __future__ import annotations

import functools
import logging
import signal
import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, Optional

from waveformanalysis_tpu_torch.foundation.exceptions import TimeoutError_

logger = logging.getLogger(__name__)


class TimeoutManager:
    """Applies wall-clock timeouts to callables."""

    def __init__(self) -> None:
        self.stats: Dict[str, int] = {"applied": 0, "timed_out": 0}

    def run_with_timeout(
        self,
        fn: Callable[..., Any],
        timeout_s: Optional[float],
        *args: Any,
        task_name: str = "task",
        **kwargs: Any,
    ) -> Any:
        if not timeout_s or timeout_s <= 0:
            return fn(*args, **kwargs)
        self.stats["applied"] += 1

        if threading.current_thread() is threading.main_thread() and hasattr(
            signal, "SIGALRM"
        ):
            return self._run_signal(fn, timeout_s, task_name, *args, **kwargs)
        return self._run_thread(fn, timeout_s, task_name, *args, **kwargs)

    def _run_signal(self, fn, timeout_s, task_name, *args, **kwargs):
        def handler(signum, frame):
            raise TimeoutError_(f"'{task_name}' exceeded timeout of {timeout_s}s")

        old = signal.signal(signal.SIGALRM, handler)
        signal.setitimer(signal.ITIMER_REAL, timeout_s)
        try:
            return fn(*args, **kwargs)
        except TimeoutError_:
            self.stats["timed_out"] += 1
            raise
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, old)

    def _run_thread(self, fn, timeout_s, task_name, *args, **kwargs):
        box: Dict[str, Any] = {}

        def runner() -> None:
            try:
                box["result"] = fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001
                box["error"] = e

        t = threading.Thread(target=runner, daemon=True)
        t.start()
        t.join(timeout_s)
        if t.is_alive():
            self.stats["timed_out"] += 1
            raise TimeoutError_(f"'{task_name}' exceeded timeout of {timeout_s}s")
        if "error" in box:
            raise box["error"]
        return box.get("result")

    @contextmanager
    def timeout(self, timeout_s: Optional[float], task_name: str = "block") -> Iterator[None]:
        """Context-manager form (signal-based; main thread only)."""
        if not timeout_s or timeout_s <= 0 or not (
            threading.current_thread() is threading.main_thread()
            and hasattr(signal, "SIGALRM")
        ):
            yield
            return

        def handler(signum, frame):
            raise TimeoutError_(f"'{task_name}' exceeded timeout of {timeout_s}s")

        old = signal.signal(signal.SIGALRM, handler)
        signal.setitimer(signal.ITIMER_REAL, timeout_s)
        try:
            yield
        except TimeoutError_:
            self.stats["timed_out"] += 1
            raise
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, old)


_default_manager = TimeoutManager()


def with_timeout(timeout_s: float, task_name: Optional[str] = None):
    """Decorator applying a timeout to every call."""

    def decorator(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            return _default_manager.run_with_timeout(
                fn, timeout_s, *args,
                task_name=task_name or fn.__name__, **kwargs,
            )

        return wrapper

    return decorator


def get_timeout_manager() -> TimeoutManager:
    """The process-default timeout manager
    (reference facade: get_timeout_manager)."""
    return _default_manager
