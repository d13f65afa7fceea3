"""Plugin configuration options.

Behavioral analog of the reference Option class
(reference: waveform_analysis/core/plugins/core/base.py:38-317): typed,
range/choice-validated options with unit auto-conversion, lineage tracking
flags, deprecation warnings, and the ``@option`` / ``@takes_config`` class
decorators.
"""

from __future__ import annotations

import logging
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple, Type, Union

from waveformanalysis_tpu_torch.foundation.units import (
    StandardUnits,
    convert_frequency,
    convert_time,
)

logger = logging.getLogger(__name__)

_TRUTHY_STRINGS = frozenset(("true", "1", "yes", "on"))


def _coerce_bool(value: Any) -> bool:
    if isinstance(value, str):
        return value.lower() in _TRUTHY_STRINGS
    return bool(value)


# string/number coercion attempted before rejecting a mistyped value
_COERCERS: Dict[Any, Callable[[Any], Any]] = {
    int: int,
    float: float,
    bool: _coerce_bool,
}


class Option:
    """A configuration option declared by a plugin.

    Args:
        default: default value.
        type: expected type (int/float/bool/str/... or tuple of types); coercion
            from strings/numbers is attempted before rejecting.
        help: human-readable description.
        validate: custom predicate applied after all other checks.
        track: whether the value participates in lineage hashing.
        unit / internal_unit: user-facing vs stored unit; numeric values are
            auto-converted (time units ps..s, frequency units Hz..GHz).
        choices: allowed values.
        min_value / max_value: numeric range constraints.
        deprecated / deprecated_message: deprecation warning on use.
        alias: legacy name accepted for this option.
    """

    def __init__(
        self,
        default: Any = None,
        type: Optional[Union[Type, Tuple[Type, ...]]] = None,
        help: str = "",
        validate: Optional[Callable[[Any], bool]] = None,
        track: bool = True,
        unit: Optional[str] = None,
        internal_unit: Optional[str] = None,
        choices: Optional[List[Any]] = None,
        min_value: Optional[float] = None,
        max_value: Optional[float] = None,
        deprecated: bool = False,
        deprecated_message: str = "",
        alias: Optional[str] = None,
    ) -> None:
        self.default = default
        self.type = type
        self.help = help
        self.validate = validate
        self.track = track
        self.unit = unit
        self.internal_unit = internal_unit
        self.choices = choices
        self.min_value = min_value
        self.max_value = max_value
        self.deprecated = deprecated
        self.deprecated_message = deprecated_message
        self.alias = alias

    def _convert_unit(self, value: float, plugin_name: str, name: str) -> float:
        if self.unit is None or self.internal_unit is None or self.unit == self.internal_unit:
            return value
        if (
            self.unit in StandardUnits.TIME_TO_PS
            and self.internal_unit in StandardUnits.TIME_TO_PS
        ):
            return convert_time(value, self.unit, self.internal_unit)
        if (
            self.unit in StandardUnits.FREQ_TO_HZ
            and self.internal_unit in StandardUnits.FREQ_TO_HZ
        ):
            return convert_frequency(value, self.unit, self.internal_unit)
        logger.warning(
            "[%s] config key %r: no unit conversion path %s -> %s; "
            "value passed through unchanged",
            plugin_name, name, self.unit, self.internal_unit,
        )
        return value

    def validate_value(self, name: str, value: Any, plugin_name: str = "unknown") -> Any:
        """Validate and convert a config value.

        Order: deprecation warning -> type coercion/check -> choices ->
        range -> unit conversion -> custom validator.
        """
        if self.deprecated:
            msg = f"[{plugin_name}] config key {name!r} is deprecated"
            if self.deprecated_message:
                msg += f" — {self.deprecated_message}"
            warnings.warn(msg, DeprecationWarning, stacklevel=4)

        if value is None and self.default is None:
            return None

        if self.type is not None and not isinstance(value, self.type):
            coerce = _COERCERS.get(self.type)
            if coerce is not None:
                try:
                    value = coerce(value)
                except (ValueError, TypeError):
                    pass  # fall through to the type error below

        if self.type is not None and not isinstance(value, self.type):
            raise TypeError(
                f"[{plugin_name}] config key {name!r} expects "
                f"{self.type}; received {value!r} "
                f"({builtins_type_name(value)})"
            )

        if self.choices is not None and value not in self.choices:
            raise ValueError(
                f"[{plugin_name}] config key {name!r}: {value!r} is not "
                f"allowed — must be one of {self.choices}"
            )

        is_numeric = isinstance(value, (int, float)) and not isinstance(
            value, bool
        )
        if is_numeric:
            for bound, op, word in (
                (self.min_value, value.__lt__, "is below the minimum"),
                (self.max_value, value.__gt__, "exceeds the maximum"),
            ):
                if bound is not None and op(bound):
                    raise ValueError(
                        f"[{plugin_name}] config key {name!r}: "
                        f"{value} {word} {bound}"
                    )
            if self.unit and self.internal_unit:
                value = self._convert_unit(value, plugin_name, name)

        if self.validate is not None and not self.validate(value):
            raise ValueError(
                f"[{plugin_name}] config key {name!r}: custom validator "
                f"rejected {value!r}"
            )

        return value

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        bits = [f"default={self.default!r}"]
        if self.type is not None:
            bits.append(f"type={getattr(self.type, '__name__', self.type)}")
        if not self.track:
            bits.append("untracked")
        if self.unit:
            bits.append(f"unit={self.unit}")
        return "<Option " + " ".join(bits) + ">"


def builtins_type_name(value: Any) -> str:
    return type(value).__name__


def option(name: str, **kwargs: Any):
    """Class decorator adding a single Option to a Plugin class."""

    def decorator(cls):
        if "options" not in cls.__dict__:
            cls.options = dict(getattr(cls, "options", {}))
        cls.options[name] = Option(**kwargs)
        return cls

    return decorator


def takes_config(config_dict: Dict[str, Option]):
    """Class decorator adding multiple Options to a Plugin class."""

    def decorator(cls):
        if "options" not in cls.__dict__:
            cls.options = dict(getattr(cls, "options", {}))
        cls.options.update(config_dict)
        return cls

    return decorator
