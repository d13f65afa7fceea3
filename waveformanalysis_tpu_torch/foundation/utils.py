"""Small foundation utilities.

Reference analog: waveform_analysis/core/foundation/utils.py (the pieces
without a better home — the reference file also hosts its Profiler and
plotting dataclasses, which live in their own modules here).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional


class OneTimeGenerator:
    """Generator wrapper that refuses silent double consumption.

    Re-iterating an exhausted generator yields nothing — a silent data
    loss when user code passes a stream around. Wrapping makes the second
    ``__iter__`` raise instead (reference:
    core/foundation/utils.py:280-313, which wraps every generator result
    its execution layer memoizes).

    Our Context does not need the guard internally — it re-streams fresh
    chunks on every ``get_data`` call (docs/PARITY.md #13 pins the
    reference returning the exhausted generator there) — so this is the
    user-facing helper for code that hands streams across call sites.
    """

    def __init__(self, generator: Iterator, name: str = "Generator") -> None:
        self.generator = generator
        self.name = name
        self.consumed = False

    def __iter__(self) -> Iterator:
        if self.consumed:
            raise RuntimeError(
                f"{self.name} has already been consumed. Generators are "
                "one-time use to prevent silent data loss; convert to a "
                "list, or call context.get_data() again — it re-streams."
            )
        self.consumed = True
        yield from self.generator

    def __next__(self) -> Any:
        # iterator protocol: first next() marks consumption
        if not self.consumed:
            self._it = iter(self.generator)
            self.consumed = True
        elif not hasattr(self, "_it"):
            raise RuntimeError(
                f"{self.name} has already been consumed (see __iter__)."
            )
        return next(self._it)


def get_plugins_from_context(ctx: Any) -> Dict[str, Any]:
    """Plugin name -> instance mapping from a Context-like object.

    Tolerant of ``_plugins`` / ``plugins`` attribute spellings (reference:
    core/foundation/utils.py:316-345); empty dict for None / plugin-less
    objects.
    """
    if ctx is None:
        return {}
    for attr in ("_plugins", "plugins"):
        plugins: Optional[Dict[str, Any]] = getattr(ctx, attr, None)
        if isinstance(plugins, dict):
            return dict(plugins)
    return {}
