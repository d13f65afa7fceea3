"""Plugin system: base class, specs, stats, loader, streaming."""

from waveformanalysis_tpu_torch.plugins.base import Option, Plugin, option, takes_config
from waveformanalysis_tpu_torch.plugins.spec import PluginSpec
from waveformanalysis_tpu_torch.plugins.stats import PluginStatsCollector

__all__ = ["Plugin", "Option", "option", "takes_config", "PluginSpec", "PluginStatsCollector"]
