"""Exception hierarchy and error severity model.

Mirrors the behavior of the reference exception layer
(reference: waveform_analysis/core/foundation/exceptions.py): a severity enum
drives how the execution engine reacts to plugin failures (FATAL aborts the
run, RECOVERABLE lets the scheduler continue / retry).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


class ErrorSeverity(enum.Enum):
    """Severity classes for plugin errors."""

    FATAL = "fatal"
    RECOVERABLE = "recoverable"
    WARNING = "warning"


@dataclass
class ErrorContext:
    """Structured snapshot attached to plugin failures
    (reference: foundation/exceptions.py:21 ErrorContext): where the
    error happened, with what config, against which inputs."""

    run_id: str = ""
    plugin_name: str = ""
    plugin_class: str = ""
    config: Dict[str, Any] = field(default_factory=dict)
    timestamp: str = ""
    dependencies_info: Dict[str, Any] = field(default_factory=dict)
    memory_mb: Optional[float] = None

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any],
                      run_id: str = "") -> "ErrorContext":
        """Build from an ``ErrorManager.collect_context`` snapshot dict."""
        import datetime

        return cls(
            run_id=run_id,
            plugin_name=str(snap.get("provides", "")),
            plugin_class=str(snap.get("plugin_class", "")),
            config=dict(snap.get("config", {}) or {}),
            timestamp=datetime.datetime.now().isoformat(),
            dependencies_info=dict(snap.get("inputs", {}) or {})
            if isinstance(snap.get("inputs"), dict) else
            {"inputs": snap.get("inputs")} if "inputs" in snap else {},
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "run_id": self.run_id,
            "plugin_name": self.plugin_name,
            "plugin_class": self.plugin_class,
            "config": self.config,
            "timestamp": self.timestamp,
            "dependencies_info": self.dependencies_info,
            "memory_mb": self.memory_mb,
        }


class WaveformAnalysisError(Exception):
    """Base class for all framework errors."""


class PluginError(WaveformAnalysisError):
    """Error raised by / attributed to a plugin execution.

    Attributes:
        plugin_name: provides-name of the failing plugin.
        severity: how the executor should react.
        recoverable: convenience flag (severity != FATAL).
        context: optional structured diagnostic snapshot.
    """

    def __init__(
        self,
        message: str,
        plugin_name: str = "",
        severity: ErrorSeverity = ErrorSeverity.FATAL,
        context: Optional[dict[str, Any]] = None,
        cause: Optional[BaseException] = None,
    ) -> None:
        super().__init__(message)
        self.plugin_name = plugin_name
        self.severity = severity
        self.context = context or {}
        self.cause = cause

    @property
    def recoverable(self) -> bool:
        return self.severity is not ErrorSeverity.FATAL

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        base = super().__str__()
        if self.plugin_name:
            return f"[{self.plugin_name}] {base}"
        return base


class ConfigError(WaveformAnalysisError):
    """Invalid or unresolvable configuration."""


class StorageError(WaveformAnalysisError):
    """Storage backend failure."""


class CacheError(StorageError):
    """Cache lookup / consistency failure."""


class ValidationError(WaveformAnalysisError):
    """Data contract violation (dtype/shape/time-ordering)."""


class CancelledError(WaveformAnalysisError):
    """Raised when a cancellation token fires mid-task."""


class TimeoutError_(WaveformAnalysisError):
    """Raised when a plugin exceeds its execution timeout."""
