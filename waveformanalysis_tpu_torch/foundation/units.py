"""Unit conventions and conversion helpers.

Semantics mirror the reference compat layer
(reference: waveform_analysis/core/compat.py:21,90,122): ADC timestamps are
picoseconds, system time is nanoseconds, sample intervals are nanoseconds,
rates are Hz. ``Option(unit=, internal_unit=)`` auto-conversion routes through
:func:`convert_time` / :func:`convert_frequency`.
"""

from __future__ import annotations

import enum
import warnings
from typing import Any, Dict, Tuple


class TimestampUnit(enum.Enum):
    """Units a DAQ format may report timestamps in.

    (reference analog: waveform_analysis/utils/formats/base.py TimestampUnit)
    """

    PICOSECONDS = "ps"
    NANOSECONDS = "ns"
    MICROSECONDS = "us"
    MILLISECONDS = "ms"
    SECONDS = "s"

    @property
    def to_ps(self) -> float:
        return StandardUnits.TIME_TO_PS[self.value]


class StandardUnits:
    """Global unit conventions for the whole framework."""

    TIMESTAMP_UNIT = "ps"  # ADC timestamps: picoseconds
    SYSTEM_TIME_UNIT = "ns"  # system time: nanoseconds
    SAMPLE_INTERVAL_UNIT = "ns"  # sample interval (dt): nanoseconds
    SAMPLING_RATE_UNIT = "Hz"  # sampling rates: Hz

    TIME_TO_PS: Dict[str, float] = {
        "ps": 1.0,
        "ns": 1e3,
        "us": 1e6,
        "ms": 1e9,
        "s": 1e12,
    }

    TIME_TO_NS: Dict[str, float] = {
        "ps": 1e-3,
        "ns": 1.0,
        "us": 1e3,
        "ms": 1e6,
        "s": 1e9,
    }

    FREQ_TO_HZ: Dict[str, float] = {
        "Hz": 1.0,
        "kHz": 1e3,
        "MHz": 1e6,
        "GHz": 1e9,
    }


def convert_time(value: float, from_unit: str, to_unit: str) -> float:
    """Convert a time quantity between ps/ns/us/ms/s."""
    try:
        f = StandardUnits.TIME_TO_PS[from_unit]
    except KeyError:
        raise ValueError(f"Unsupported time unit: {from_unit}") from None
    try:
        t = StandardUnits.TIME_TO_PS[to_unit]
    except KeyError:
        raise ValueError(f"Unsupported time unit: {to_unit}") from None
    return value * f / t


def convert_frequency(value: float, from_unit: str, to_unit: str) -> float:
    """Convert a frequency quantity between Hz/kHz/MHz/GHz."""
    try:
        f = StandardUnits.FREQ_TO_HZ[from_unit]
    except KeyError:
        raise ValueError(f"Unsupported frequency unit: {from_unit}") from None
    try:
        t = StandardUnits.FREQ_TO_HZ[to_unit]
    except KeyError:
        raise ValueError(f"Unsupported frequency unit: {to_unit}") from None
    return value * f / t


def sampling_rate_to_interval_ns(rate_hz: float) -> float:
    """Sampling rate (Hz) -> sample interval (ns)."""
    if rate_hz <= 0:
        raise ValueError(f"sampling rate must be positive, got {rate_hz}")
    return 1e9 / rate_hz


# Legacy name maps: "old_name" -> ("new_name", "deprecation message").
LEGACY_CONFIG_NAMES: Dict[str, Tuple[str, str]] = {}
LEGACY_FIELD_NAMES: Dict[str, Tuple[str, str]] = {}


def resolve_config_name(name: str, warn: bool = True) -> str:
    """Map a legacy config key to its canonical name, with a deprecation warning."""
    if name in LEGACY_CONFIG_NAMES:
        new_name, message = LEGACY_CONFIG_NAMES[name]
        if warn:
            warnings.warn(message, DeprecationWarning, stacklevel=3)
        return new_name
    return name


def migrate_config(config: Dict[str, Any], warn: bool = True) -> Dict[str, Any]:
    """Rewrite legacy config keys in a dict to their canonical names."""
    return {resolve_config_name(k, warn=warn): v for k, v in config.items()}
