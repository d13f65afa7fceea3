"""Context layer: scheduler, cache/config/execution domains."""

from waveformanalysis_tpu_torch.context.context import Context
from waveformanalysis_tpu_torch.context.resolution import (
    CircularDependencyError,
    MissingDependencyError,
    VersionConflictError,
    resolve_dependencies,
)

__all__ = [
    "Context",
    "resolve_dependencies",
    "CircularDependencyError",
    "MissingDependencyError",
    "VersionConflictError",
]
