"""Adapter-derived configuration inference.

Behavioral analog of the reference AdapterInfo
(reference: waveform_analysis/core/config/adapter_info.py:18,175): a cached
snapshot of a registered DAQ adapter's timing metadata (sampling rate, dt,
timestamp unit/mode) from which the resolver infers plugin config values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional


@dataclass
class AdapterInfo:
    """Timing metadata snapshot of a DAQ adapter."""

    name: str
    sampling_rate_hz: float
    timestamp_unit: str
    raw_timestamp_mode: str
    dt_ns: int
    dt_ps: int

    @classmethod
    def from_adapter(cls, adapter_name: str) -> Optional["AdapterInfo"]:
        try:
            from waveformanalysis_tpu_torch.formats.adapter import (
                get_adapter,
                is_adapter_registered,
            )

            if not is_adapter_registered(adapter_name):
                return None
            return cls.from_adapter_object(get_adapter(adapter_name))
        except Exception:
            return None

    @classmethod
    def from_adapter_object(cls, adapter: Any) -> Optional["AdapterInfo"]:
        try:
            spec = adapter.format_spec
            sampling_rate = getattr(spec, "sampling_rate_hz", None) or 500e6
            ts_unit = getattr(spec, "timestamp_unit", None)
            ts_mode = getattr(spec, "raw_timestamp_mode", None)
            return cls(
                name=adapter.name,
                sampling_rate_hz=sampling_rate,
                timestamp_unit=ts_unit.value if ts_unit is not None else "ps",
                raw_timestamp_mode=ts_mode.value if ts_mode is not None else "unit",
                dt_ns=int(1e9 / sampling_rate),
                dt_ps=int(1e12 / sampling_rate),
            )
        except Exception:
            return None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "sampling_rate_hz": self.sampling_rate_hz,
            "timestamp_unit": self.timestamp_unit,
            "raw_timestamp_mode": self.raw_timestamp_mode,
            "dt_ns": self.dt_ns,
            "dt_ps": self.dt_ps,
        }

    def get_inferred_value(self, key: str) -> Any:
        """Value for an inferable config key, or None."""
        from waveformanalysis_tpu_torch.config.resolver import ConfigResolver

        fn = ConfigResolver.ADAPTER_INFERRED_OPTIONS.get(key)
        return fn(self) if fn else None

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"AdapterInfo({self.name}: {self.sampling_rate_hz / 1e6:.0f} MHz, "
            f"dt={self.dt_ns} ns, ts_unit={self.timestamp_unit})"
        )


_cache: Dict[str, Optional[AdapterInfo]] = {}


def get_adapter_info(adapter_name: str, use_cache: bool = True) -> Optional[AdapterInfo]:
    """Cached AdapterInfo lookup by registered adapter name."""
    if use_cache and adapter_name in _cache:
        return _cache[adapter_name]
    info = AdapterInfo.from_adapter(adapter_name)
    if use_cache:
        _cache[adapter_name] = info
    return info


def clear_adapter_info_cache() -> None:
    _cache.clear()
