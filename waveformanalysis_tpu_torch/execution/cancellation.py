"""Cooperative cancellation tokens with SIGINT integration.

Behavioral analog of the reference cancellation layer
(reference: waveform_analysis/core/cancellation.py:28-296): a process-wide
CancellationManager registers tokens, optionally hooks SIGINT so Ctrl-C
cancels all registered tokens, and long loops poll ``token.check()``.

Port of ``waveformanalysis_tpu/execution/cancellation.py``.
"""

from __future__ import annotations

import logging
import signal
import threading
import uuid
from typing import Any, Callable, Dict, List, Optional

from waveformanalysis_tpu_torch.foundation.exceptions import CancelledError

logger = logging.getLogger(__name__)

# reference-compat alias
TaskCancelledException = CancelledError


class CancellationToken:
    """A cooperative cancellation flag."""

    def __init__(self, name: str = "") -> None:
        self.name = name or f"token-{uuid.uuid4().hex[:6]}"
        self._event = threading.Event()
        self._callbacks: List[Callable[[], None]] = []
        self._lock = threading.Lock()

    def cancel(self) -> None:
        if self._event.is_set():
            return
        self._event.set()
        with self._lock:
            callbacks = list(self._callbacks)
        for cb in callbacks:
            try:
                cb()
            except Exception as e:  # pragma: no cover
                logger.warning("Cancellation callback failed: %s", e)

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    def is_cancelled(self) -> bool:
        return self._event.is_set()

    def check(self) -> None:
        """Raise if cancelled (call inside long loops)."""
        if self._event.is_set():
            raise CancelledError(f"Task cancelled: {self.name}")

    def on_cancel(self, callback: Callable[[], None]) -> None:
        with self._lock:
            self._callbacks.append(callback)
        if self._event.is_set():
            callback()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)


class CancellationManager:
    """Token registry with optional SIGINT hook."""

    _instance: Optional["CancellationManager"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._tokens: Dict[str, CancellationToken] = {}
        self._lock = threading.Lock()
        self._sigint_installed = False
        self._old_handler: Any = None

    @classmethod
    def instance(cls) -> "CancellationManager":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def create_token(self, name: str = "") -> CancellationToken:
        token = CancellationToken(name)
        with self._lock:
            self._tokens[token.name] = token
        return token

    def register(self, token: CancellationToken) -> None:
        with self._lock:
            self._tokens[token.name] = token

    def unregister(self, token: CancellationToken) -> None:
        with self._lock:
            self._tokens.pop(token.name, None)

    def cancel_all(self) -> int:
        with self._lock:
            tokens = list(self._tokens.values())
        for t in tokens:
            t.cancel()
        return len(tokens)

    def install_sigint_handler(self) -> None:
        """Ctrl-C cancels every registered token, then restores the default."""
        if self._sigint_installed:
            return
        if threading.current_thread() is not threading.main_thread():
            logger.warning("SIGINT handler can only be installed from the main thread")
            return

        def handler(signum: int, frame: Any) -> None:
            n = self.cancel_all()
            logger.warning("SIGINT: cancelled %d running tasks", n)
            if self._old_handler not in (None, signal.SIG_IGN, signal.SIG_DFL):
                self._old_handler(signum, frame)

        self._old_handler = signal.signal(signal.SIGINT, handler)
        self._sigint_installed = True

    def uninstall_sigint_handler(self) -> None:
        if self._sigint_installed and self._old_handler is not None:
            signal.signal(signal.SIGINT, self._old_handler)
            self._sigint_installed = False

    @property
    def active_tokens(self) -> List[str]:
        with self._lock:
            return sorted(self._tokens)
