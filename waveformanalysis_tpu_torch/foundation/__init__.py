"""Foundation layer: errors, profiling, progress, time conversion, units, constants.

TPU-native rebuild of the reference foundation layer
(reference: waveform_analysis/core/foundation/).
"""

from waveformanalysis_tpu_torch.foundation.constants import (
    FeatureDefaults,
    ProcessingDefaults,
    StorageDefaults,
    ValidationDefaults,
)
from waveformanalysis_tpu_torch.foundation.exceptions import (
    CacheError,
    ConfigError,
    ErrorSeverity,
    PluginError,
    StorageError,
    WaveformAnalysisError,
)
from waveformanalysis_tpu_torch.foundation.error import ErrorManager
from waveformanalysis_tpu_torch.foundation.profiler import Profiler
from waveformanalysis_tpu_torch.foundation.progress import ProgressTracker
from waveformanalysis_tpu_torch.foundation.time_conversion import (
    EpochExtractor,
    EpochInfo,
    TimeConverter,
)
from waveformanalysis_tpu_torch.foundation.units import (
    StandardUnits,
    convert_frequency,
    convert_time,
)
from waveformanalysis_tpu_torch.foundation.utils import (
    OneTimeGenerator,
    get_plugins_from_context,
)

__all__ = [
    "FeatureDefaults",
    "ProcessingDefaults",
    "StorageDefaults",
    "ValidationDefaults",
    "WaveformAnalysisError",
    "ErrorSeverity",
    "PluginError",
    "ConfigError",
    "StorageError",
    "CacheError",
    "ErrorManager",
    "Profiler",
    "ProgressTracker",
    "EpochInfo",
    "TimeConverter",
    "EpochExtractor",
    "StandardUnits",
    "convert_time",
    "convert_frequency",
    "OneTimeGenerator",
    "get_plugins_from_context",
]
