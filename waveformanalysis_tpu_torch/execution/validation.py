"""Plugin config / input-dtype validation.

Behavioral analog of the reference ValidationManager
(reference: waveform_analysis/core/execution/validation.py:26-120): validates
resolved plugin configs and declared input dtypes before compute runs.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List

import numpy as np

from waveformanalysis_tpu_torch.dtypes.schema import Schema
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.foundation.exceptions import ValidationError

logger = logging.getLogger(__name__)


class ValidationManager:
    """Pre-compute validation hooks used by the execution domain."""

    def __init__(self, context: Any) -> None:
        self.ctx = context

    def validate_plugin_config(self, plugin: Any) -> Dict[str, Any]:
        """Resolve + Option-validate every option (raises on violations)."""
        return plugin.validate_config(self.ctx)

    def validate_input_dtypes(self, plugin: Any, run_id: str) -> List[str]:
        """Check declared input_dtype fields exist on the actual inputs.

        Returns a list of problems (empty = ok); missing fields raise.
        """
        problems: List[str] = []
        for dep, expected in (plugin.input_dtype or {}).items():
            data = self.ctx._get_data_from_memory(run_id, dep)
            if data is None:
                continue  # not loaded yet; contract checked lazily
            expected_fields = _field_names(expected)
            actual_fields = _actual_fields(data)
            if actual_fields is None:
                continue
            missing = [f for f in expected_fields if f not in actual_fields]
            if missing:
                problems.append(
                    f"input '{dep}' missing fields {missing} "
                    f"(expected by {plugin.provides})"
                )
        if problems:
            raise ValidationError("; ".join(problems))
        return problems

    def validate_output(self, plugin: Any, result: Any) -> None:
        """Shallow output check against the declared output dtype/schema."""
        expected = getattr(plugin, "output_dtype", None)
        if expected is None or result is None:
            return
        expected_fields = _field_names(expected)
        if not expected_fields:
            return
        actual = _actual_fields(result)
        if actual is None:
            return
        missing = [f for f in expected_fields if f not in actual]
        if missing:
            raise ValidationError(
                f"plugin '{plugin.provides}' output missing declared fields: {missing}"
            )


def _field_names(dtype_like: Any) -> List[str]:
    if isinstance(dtype_like, Schema):
        return list(dtype_like.field_names)
    if isinstance(dtype_like, (list, tuple)) and all(
        isinstance(f, str) for f in dtype_like
    ):
        # plain field-name list: the lightweight way to declare input_dtype
        return list(dtype_like)
    try:
        dt = np.dtype(dtype_like)
        return list(dt.names or ())
    except (TypeError, ValueError):
        return []


def _actual_fields(data: Any) -> Any:
    if isinstance(data, Table):
        return set(data.field_names)
    names = getattr(getattr(data, "dtype", None), "names", None)
    if names:
        return set(names)
    return None
