"""DAQ format adapters: specs, readers, directory layouts, registry.

Port of ``waveformanalysis_tpu/formats/`` (host code, no device work). The
port keeps its own adapter registry; registering an adapter clears the
port's adapter-info cache, which config inference reads.
"""

from waveformanalysis_tpu_torch.formats.adapter import (
    DAQAdapter,
    get_adapter,
    is_adapter_registered,
    list_adapters,
    register_adapter,
    unregister_adapter,
)
from waveformanalysis_tpu_torch.formats.base import (
    ColumnMapping,
    FormatReader,
    FormatSpec,
    RawTimestampMode,
)
from waveformanalysis_tpu_torch.formats.directory import DirectoryLayout
from waveformanalysis_tpu_torch.foundation.units import TimestampUnit

__all__ = [
    "DAQAdapter",
    "register_adapter",
    "get_adapter",
    "list_adapters",
    "is_adapter_registered",
    "unregister_adapter",
    "FormatSpec",
    "FormatReader",
    "ColumnMapping",
    "RawTimestampMode",
    "TimestampUnit",
    "DirectoryLayout",
]
