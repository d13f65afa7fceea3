"""Error collection and diagnostics.

Behavioral analog of the reference ErrorManager
(reference: waveform_analysis/core/foundation/error.py:23): collects structured
context snapshots when a plugin fails (config, input shapes) so failures in
long pipelines are debuggable after the fact.
"""

from __future__ import annotations

import logging
import traceback
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


@dataclass
class ErrorRecord:
    plugin_name: str
    run_id: str
    exception_type: str
    message: str
    traceback_str: str
    context: Dict[str, Any] = field(default_factory=dict)
    timestamp: str = field(default_factory=lambda: datetime.now().isoformat())

    def to_dict(self) -> Dict[str, Any]:
        return {
            "plugin_name": self.plugin_name,
            "run_id": self.run_id,
            "exception_type": self.exception_type,
            "message": self.message,
            "traceback": self.traceback_str,
            "context": self.context,
            "timestamp": self.timestamp,
        }


class ErrorManager:
    """Collects error records with structural context snapshots."""

    def __init__(self, max_records: int = 100) -> None:
        self.max_records = max_records
        self._records: List[ErrorRecord] = []

    def collect_context(
        self, plugin: Any = None, context: Any = None, inputs: Any = None
    ) -> Dict[str, Any]:
        """Snapshot plugin config and input shapes for the error log."""
        snap: Dict[str, Any] = {}
        if plugin is not None:
            snap["plugin_class"] = type(plugin).__name__
            snap["provides"] = getattr(plugin, "provides", "")
            snap["version"] = getattr(plugin, "version", "")
            if context is not None and hasattr(plugin, "options"):
                cfg = {}
                for key in getattr(plugin, "options", {}):
                    try:
                        cfg[key] = repr(context.get_config(plugin, key))
                    except Exception:
                        cfg[key] = "<unresolvable>"
                snap["config"] = cfg
        if inputs is not None:
            snap["inputs"] = _describe(inputs)
        return snap

    def record(
        self,
        exc: BaseException,
        plugin_name: str = "",
        run_id: str = "",
        context: Optional[Dict[str, Any]] = None,
    ) -> ErrorRecord:
        rec = ErrorRecord(
            plugin_name=plugin_name,
            run_id=run_id,
            exception_type=type(exc).__name__,
            message=str(exc),
            traceback_str="".join(traceback.format_exception(exc)),
            context=context or {},
        )
        self._records.append(rec)
        if len(self._records) > self.max_records:
            self._records = self._records[-self.max_records :]
        logger.debug("Recorded error for plugin %s: %s", plugin_name, exc)
        return rec

    @property
    def records(self) -> List[ErrorRecord]:
        return list(self._records)

    def clear(self) -> None:
        self._records.clear()

    def summary(self) -> str:
        if not self._records:
            return "(no errors recorded)"
        lines = []
        for rec in self._records:
            lines.append(f"[{rec.timestamp}] {rec.plugin_name}: {rec.exception_type}: {rec.message}")
        return "\n".join(lines)


def _describe(obj: Any) -> Any:
    """Shape/dtype description of arrays, recursively for containers."""
    try:

        if hasattr(obj, "shape") and hasattr(obj, "dtype"):
            return {"shape": tuple(obj.shape), "dtype": str(obj.dtype)}
        if isinstance(obj, dict):
            return {k: _describe(v) for k, v in list(obj.items())[:32]}
        if isinstance(obj, (list, tuple)):
            return [_describe(v) for v in obj[:32]]
        if isinstance(obj, (int, float, str, bool, type(None))):
            return obj
    except Exception:
        pass
    return f"<{type(obj).__name__}>"
