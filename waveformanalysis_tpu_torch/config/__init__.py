"""Config system: options, resolver, adapter inference, compat layer."""

from waveformanalysis_tpu_torch.config.adapter_info import (
    AdapterInfo,
    clear_adapter_info_cache,
    get_adapter_info,
)
from waveformanalysis_tpu_torch.config.compat import (
    CompatManager,
    DeprecationInfo,
    compare_versions,
    get_default_compat_manager,
)
from waveformanalysis_tpu_torch.config.option import Option, option, takes_config
from waveformanalysis_tpu_torch.config.resolver import ConfigResolver
from waveformanalysis_tpu_torch.config.types import ConfigSource, ConfigValue, ResolvedConfig

__all__ = [
    "Option",
    "option",
    "takes_config",
    "ConfigResolver",
    "ConfigSource",
    "ConfigValue",
    "ResolvedConfig",
    "AdapterInfo",
    "get_adapter_info",
    "clear_adapter_info_cache",
    "CompatManager",
    "DeprecationInfo",
    "compare_versions",
    "get_default_compat_manager",
]
