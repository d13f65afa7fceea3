"""Config resolution: entry value -> effective value.

Behavioral analog of the reference ConfigResolver
(reference: waveform_analysis/core/config/resolver.py:29,51-67,149-209).
Precedence, highest first:

1. explicit config — plugin-scoped dict ``config[plugin][key]``, then dotted
   ``config["plugin.key"]``, then global ``config[key]``;
2. adapter-inferred values for a fixed set of timing keys;
3. the plugin option's default.

Aliases from the CompatManager are accepted anywhere an explicit key is
looked up, with deprecation warnings.
"""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING, Any, Callable, Dict, Optional, Tuple

from waveformanalysis_tpu_torch.config.adapter_info import AdapterInfo, get_adapter_info
from waveformanalysis_tpu_torch.config.types import ConfigSource, ConfigValue, ResolvedConfig

if TYPE_CHECKING:
    from waveformanalysis_tpu_torch.config.compat import CompatManager

logger = logging.getLogger(__name__)


class ConfigResolver:
    """Resolves plugin option values against global config + adapter info."""

    # config keys inferable from a DAQ adapter (reference: resolver.py:51-67)
    ADAPTER_INFERRED_OPTIONS: Dict[str, Callable[[AdapterInfo], Any]] = {
        "sampling_rate_hz": lambda info: info.sampling_rate_hz,
        # sampling_rate / fs follow the GHz convention
        "sampling_rate": lambda info: (
            (info.sampling_rate_hz / 1e9) if info.sampling_rate_hz else None
        ),
        "fs": lambda info: (info.sampling_rate_hz / 1e9) if info.sampling_rate_hz else None,
        "sampling_interval_ns": lambda info: info.dt_ns,
        "dt_ns": lambda info: info.dt_ns,
        "dt_ps": lambda info: info.dt_ps,
        "dt": lambda info: info.dt_ns,
        "records_dt_ns": lambda info: info.dt_ns,
        "events_dt_ns": lambda info: info.dt_ns,
        "timestamp_unit": lambda info: info.timestamp_unit,
        "raw_timestamp_mode": lambda info: info.raw_timestamp_mode,
    }

    def __init__(self, compat_manager: Optional["CompatManager"] = None) -> None:
        self._compat_manager = compat_manager

    def resolve(
        self,
        plugin: Any,
        config: Dict[str, Any],
        adapter_name: Optional[str] = None,
        adapter_info: Optional[AdapterInfo] = None,
    ) -> ResolvedConfig:
        """Resolve every option of ``plugin`` against ``config``."""
        plugin_name = plugin.provides
        values: Dict[str, ConfigValue] = {}

        if adapter_info is None and adapter_name:
            adapter_info = get_adapter_info(adapter_name)

        for opt_name, opt in plugin.options.items():
            canonical = opt_name
            if self._compat_manager:
                mapped, _ = self._compat_manager.resolve_alias(plugin_name, opt_name)
                if mapped in plugin.options:
                    canonical = mapped

            value, source, inferred_from, original = self._resolve_single_value(
                plugin_name, canonical, opt, config, adapter_info
            )
            validated = opt.validate_value(canonical, value, plugin_name=plugin_name)

            if (
                self._compat_manager
                and original != canonical
                and self._compat_manager.is_deprecated(original)
            ):
                self._compat_manager.warn_deprecation(original, plugin_name)

            values[canonical] = ConfigValue(
                value=validated,
                source=source,
                original_key=original,
                canonical_key=canonical,
                inferred_from=inferred_from,
            )

        return ResolvedConfig(
            plugin_name=plugin_name,
            values=values,
            adapter_name=adapter_name or (adapter_info.name if adapter_info else None),
        )

    def _resolve_single_value(
        self,
        plugin_name: str,
        opt_name: str,
        option: Any,
        config: Dict[str, Any],
        adapter_info: Optional[AdapterInfo],
    ) -> Tuple[Any, ConfigSource, Optional[str], str]:
        names_to_check = [opt_name]
        if self._compat_manager:
            for alias in self._compat_manager.get_aliases_for(plugin_name, opt_name):
                if alias not in names_to_check:
                    names_to_check.append(alias)
        # Option-declared alias is also accepted as a legacy input key.
        opt_alias = getattr(option, "alias", None)
        if opt_alias and opt_alias not in names_to_check:
            names_to_check.append(opt_alias)

        # 1a. plugin-scoped dict
        scoped = config.get(plugin_name)
        if isinstance(scoped, dict):
            for name in names_to_check:
                if name in scoped:
                    return scoped[name], ConfigSource.EXPLICIT, None, name
        # 1b. dotted key
        for name in names_to_check:
            dotted = f"{plugin_name}.{name}"
            if dotted in config:
                return config[dotted], ConfigSource.EXPLICIT, None, name
        # 1c. global key
        for name in names_to_check:
            if name in config:
                return config[name], ConfigSource.EXPLICIT, None, name

        # 2. adapter inference
        if adapter_info and opt_name in self.ADAPTER_INFERRED_OPTIONS:
            inferred = self.ADAPTER_INFERRED_OPTIONS[opt_name](adapter_info)
            if inferred is not None:
                return (
                    inferred,
                    ConfigSource.ADAPTER_INFERRED,
                    f"{adapter_info.name}.{opt_name}",
                    opt_name,
                )

        # 3. plugin default
        return option.default, ConfigSource.PLUGIN_DEFAULT, None, opt_name

    def resolve_value(
        self,
        plugin: Any,
        name: str,
        config: Dict[str, Any],
        adapter_name: Optional[str] = None,
        adapter_info: Optional[AdapterInfo] = None,
    ) -> ConfigValue:
        """Resolve a single option by name."""
        canonical = name
        if self._compat_manager:
            canonical, _ = self._compat_manager.resolve_alias(plugin.provides, name)
        if canonical not in plugin.options:
            if name in plugin.options:
                canonical = name
            else:
                raise KeyError(f"Plugin '{plugin.provides}' does not have option '{name}'")

        if adapter_info is None and adapter_name:
            adapter_info = get_adapter_info(adapter_name)
        opt = plugin.options[canonical]
        value, source, inferred_from, original = self._resolve_single_value(
            plugin.provides, canonical, opt, config, adapter_info
        )
        validated = opt.validate_value(canonical, value, plugin_name=plugin.provides)
        if (
            self._compat_manager
            and original != canonical
            and self._compat_manager.is_deprecated(original)
        ):
            self._compat_manager.warn_deprecation(original, plugin.provides)
        return ConfigValue(
            value=validated,
            source=source,
            original_key=original,
            canonical_key=canonical,
            inferred_from=inferred_from,
        )

    @classmethod
    def register_inferred_option(
        cls, key: str, extractor: Callable[[AdapterInfo], Any]
    ) -> None:
        """Extend the set of adapter-inferable config keys."""
        cls.ADAPTER_INFERRED_OPTIONS[key] = extractor
