"""Config resolution result types.

Behavioral analog of the reference config types
(reference: waveform_analysis/core/config/types.py:16-272): each resolved
value carries its source (explicit / adapter-inferred / plugin-default), the
original vs canonical key, and the inference provenance — these feed both
debugging summaries and the lineage dict.

Contract note: the ConfigSource enum values, the ConfigValue/ResolvedConfig
field names, and the accessor/`to_lineage_dict` semantics ARE the contract —
`to_lineage_dict` output feeds the lineage hash that keys every cache entry,
so its key set and value provenance filtering must match the reference
exactly. Presentation (summary/repr formatting) is deliberately our own.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple


class ConfigSource(enum.Enum):
    EXPLICIT = "explicit"
    PLUGIN_DEFAULT = "plugin_default"
    ADAPTER_INFERRED = "adapter_inferred"
    GLOBAL_DEFAULT = "global_default"


@dataclass
class ConfigValue:
    """A single resolved configuration value with provenance."""

    value: Any
    source: ConfigSource
    original_key: str
    canonical_key: str
    inferred_from: Optional[str] = None

    # human-readable source tags; presentation is deliberately our own
    # (the provenance semantics, not the strings, are the contract)
    _SOURCE_TAGS = {
        ConfigSource.EXPLICIT: "set-by-user",
        ConfigSource.PLUGIN_DEFAULT: "plugin-default",
        ConfigSource.ADAPTER_INFERRED: "from-adapter",
        ConfigSource.GLOBAL_DEFAULT: "global-default",
    }

    def summary(self) -> str:
        value_str = repr(self.value)
        if len(value_str) > 64:  # middle-ellipsize long reprs
            value_str = value_str[:40] + " … " + value_str[-20:]
        tag = self._SOURCE_TAGS.get(self.source, self.source.value)
        if self.source == ConfigSource.ADAPTER_INFERRED and self.inferred_from:
            tag = f"from-adapter:{self.inferred_from}"
        return f"{value_str}  [{tag}]"

    def is_explicit(self) -> bool:
        return self.source is ConfigSource.EXPLICIT

    def is_inferred(self) -> bool:
        return self.source is ConfigSource.ADAPTER_INFERRED


@dataclass
class ResolvedConfig:
    """All resolved config values for one plugin."""

    plugin_name: str
    values: Dict[str, ConfigValue] = field(default_factory=dict)
    adapter_name: Optional[str] = None

    def get(self, key: str, default: Any = None) -> Any:
        cv = self.values.get(key)
        return default if cv is None else cv.value

    def get_value(self, key: str) -> Optional[ConfigValue]:
        return self.values.get(key)

    def __getitem__(self, key: str) -> Any:
        try:
            return self.values[key].value
        except KeyError:
            raise KeyError(
                f"[{self.plugin_name}] no resolved config key {key!r} "
                f"(known: {sorted(self.values)})"
            ) from None

    def __contains__(self, key: str) -> bool:
        return key in self.values

    def keys(self) -> List[str]:
        return list(self.values)

    def items(self) -> Iterator[Tuple[str, Any]]:
        return ((k, cv.value) for k, cv in self.values.items())

    def to_dict(self) -> Dict[str, Any]:
        return {k: cv.value for k, cv in self.values.items()}

    _LINEAGE_SOURCES = (ConfigSource.EXPLICIT, ConfigSource.ADAPTER_INFERRED)

    def _values_from(self, *sources: ConfigSource) -> Dict[str, Any]:
        """Plain {key: value} restricted to the given provenance sources."""
        wanted = set(sources)
        return {
            k: cv.value for k, cv in self.values.items() if cv.source in wanted
        }

    def to_lineage_dict(self, include_non_tracked: bool = False) -> Dict[str, Any]:
        """Config dict for lineage: explicit + inferred values only (unless
        include_non_tracked)."""
        if include_non_tracked:
            return self.to_dict()
        return self._values_from(*self._LINEAGE_SOURCES)

    def get_explicit_values(self) -> Dict[str, Any]:
        return self._values_from(ConfigSource.EXPLICIT)

    def get_inferred_values(self) -> Dict[str, Any]:
        return self._values_from(ConfigSource.ADAPTER_INFERRED)

    def get_default_values(self) -> Dict[str, Any]:
        return self._values_from(ConfigSource.PLUGIN_DEFAULT)

    def summary(self, verbose: bool = False) -> str:
        """Aligned key/value/source table (defaults hidden unless verbose)."""
        header = f"config[{self.plugin_name}]"
        if self.adapter_name:
            header += f" adapter={self.adapter_name}"
        shown = [
            (key, cv)
            for key, cv in sorted(self.values.items())
            if verbose or cv.source in (
                ConfigSource.EXPLICIT, ConfigSource.ADAPTER_INFERRED
            )
        ]
        if not shown:
            return header + "\n  (all values at plugin defaults)"
        pad = max(len(k) for k, _ in shown)
        lines = [header]
        for key, cv in shown:
            lines.append(f"  {key.ljust(pad)}  {cv.summary()}")
        n_hidden = len(self.values) - len(shown)
        if n_hidden:
            lines.append(f"  … {n_hidden} plugin-default value(s) hidden "
                         "(verbose=True shows them)")
        return "\n".join(lines)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        n = len(self.values)
        return f"<ResolvedConfig {self.plugin_name}: {n} keys>"
