"""Alias / deprecation registry for option names.

Behavioral analog of the reference CompatManager
(reference: waveform_analysis/core/config/compat.py:110): plugin-scoped and
global alias maps with versioned deprecation messages, consulted during config
resolution so legacy keys keep working with a warning.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

_GLOBAL_SCOPE = "__global__"


def get_current_version() -> str:
    """Package version used for deprecation-expiry checks."""
    from waveformanalysis_tpu_torch import __version__

    return __version__


def _parse_version(version: str) -> Tuple[int, ...]:
    parts = []
    for piece in version.split("."):
        digits = "".join(ch for ch in piece if ch.isdigit())
        parts.append(int(digits) if digits else 0)
    return tuple(parts)


def compare_versions(v1: str, v2: str) -> int:
    """-1 / 0 / 1 as v1 <, ==, > v2 (lenient numeric comparison)."""
    t1, t2 = _parse_version(v1), _parse_version(v2)
    n = max(len(t1), len(t2))
    t1 += (0,) * (n - len(t1))
    t2 += (0,) * (n - len(t2))
    return (t1 > t2) - (t1 < t2)


@dataclass
class DeprecationInfo:
    old_name: str
    new_name: str
    deprecated_in: str
    removed_in: str
    message: Optional[str] = None

    def get_warning_message(self) -> str:
        if self.message:
            return self.message
        return (
            f"'{self.old_name}' is deprecated since version {self.deprecated_in} "
            f"and will be removed in version {self.removed_in}. "
            f"Use '{self.new_name}' instead."
        )


class CompatManager:
    """Registry of option-name aliases and deprecations.

    Aliases are registered per-plugin or globally; class-level registries are
    shared across instances (matching the reference's process-wide behavior).
    """

    # (plugin_scope, old_name) -> new_name
    _aliases: Dict[Tuple[str, str], str] = {}
    _deprecations: Dict[str, DeprecationInfo] = {}

    def __init__(self) -> None:
        self._warned: set = set()

    # -- resolution ----------------------------------------------------------

    def resolve_alias(self, plugin_name: str, name: str) -> Tuple[str, bool]:
        """Map a (possibly legacy) name to its canonical form.

        Returns (canonical_name, was_aliased).
        """
        key = (plugin_name, name)
        if key in self._aliases:
            return self._aliases[key], True
        gkey = (_GLOBAL_SCOPE, name)
        if gkey in self._aliases:
            return self._aliases[gkey], True
        return name, False

    def get_aliases_for(self, plugin_name: str, canonical_name: str) -> List[str]:
        """All legacy names that map to canonical_name for this plugin."""
        out = []
        for (scope, old), new in self._aliases.items():
            if new == canonical_name and scope in (plugin_name, _GLOBAL_SCOPE):
                out.append(old)
        return out

    def is_deprecated(self, name: str) -> bool:
        return name in self._deprecations

    def get_deprecation_info(self, name: str) -> Optional[DeprecationInfo]:
        return self._deprecations.get(name)

    def warn_deprecation(self, name: str, plugin_name: str = "") -> None:
        """Warn on a deprecated name; raise once the deprecation expires.

        Matches the reference (core/config/compat.py:220-246): current
        version < removed_in -> DeprecationWarning (once per scope);
        current version >= removed_in -> ValueError.
        """
        info = self._deprecations.get(name)
        if info is None:
            return
        if (
            info.removed_in
            and info.removed_in != "?"
            and compare_versions(get_current_version(), info.removed_in) >= 0
        ):
            prefix = f"[{plugin_name}] " if plugin_name else ""
            raise ValueError(
                f"{prefix}'{name}' was removed in version {info.removed_in}. "
                f"Use '{info.new_name}' instead."
            )
        warn_key = (plugin_name, name)
        if warn_key in self._warned:
            return
        self._warned.add(warn_key)
        warnings.warn(info.get_warning_message(), DeprecationWarning, stacklevel=3)

    # -- registration --------------------------------------------------------

    @classmethod
    def register_alias(
        cls,
        old_name: str,
        new_name: str,
        plugin_name: str = _GLOBAL_SCOPE,
        deprecated_in: Optional[str] = None,
        removed_in: Optional[str] = None,
        message: Optional[str] = None,
    ) -> None:
        cls._aliases[(plugin_name, old_name)] = new_name
        if deprecated_in or removed_in or message:
            cls._deprecations[old_name] = DeprecationInfo(
                old_name=old_name,
                new_name=new_name,
                deprecated_in=deprecated_in or "0.0.0",
                removed_in=removed_in or "?",
                message=message,
            )

    @classmethod
    def register_deprecation(cls, info: DeprecationInfo) -> None:
        cls._deprecations[info.old_name] = info

    @classmethod
    def unregister_alias(cls, old_name: str, plugin_name: str = _GLOBAL_SCOPE) -> bool:
        removed = cls._aliases.pop((plugin_name, old_name), None) is not None
        cls._deprecations.pop(old_name, None)
        return removed

    # -- introspection --------------------------------------------------------

    def list_aliases(self, plugin_name: Optional[str] = None) -> Dict[str, str]:
        out = {}
        for (scope, old), new in self._aliases.items():
            if plugin_name is None or scope in (plugin_name, _GLOBAL_SCOPE):
                out[old] = new
        return out

    def list_deprecations(self) -> List[DeprecationInfo]:
        return list(self._deprecations.values())

    def summary(self) -> str:
        lines = ["CompatManager:"]
        for (scope, old), new in sorted(self._aliases.items()):
            lines.append(f"  [{scope}] {old} -> {new}")
        for info in self._deprecations.values():
            lines.append(f"  deprecated: {info.get_warning_message()}")
        return "\n".join(lines)


# Built-in aliases: r5 renamed the records/wave_pool sharding knob to the
# reference's canonical name (cpu/records.py:246 'records_part_size'); the
# r1-r4 name keeps working with a deprecation warning.
for _scope in ("records", "wave_pool"):
    CompatManager.register_alias(
        "part_size", "records_part_size", plugin_name=_scope,
        deprecated_in="0.5", removed_in="1.0",
    )
del _scope


_default_manager: Optional[CompatManager] = None


def get_default_compat_manager() -> CompatManager:
    global _default_manager
    if _default_manager is None:
        _default_manager = CompatManager()
    return _default_manager
