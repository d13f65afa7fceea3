"""Plugin base class.

Behavioral analog of the reference Plugin ABC
(reference: waveform_analysis/core/plugins/core/base.py:321-663): each plugin
declares ``provides`` / ``depends_on`` / ``options`` / ``save_when`` /
``output_dtype`` / ``output_kind`` / ``version``; option dicts are merged
across the MRO in ``__init_subclass__``; dependencies may carry version
constraints ``(name, ">=1.0")``; ``resolve_depends_on`` enables dynamic
dependencies; ``validate`` enforces the structural contract at registration.

TPU-native difference: ``compute`` returns a
:class:`~waveformanalysis_tpu_torch.dtypes.table.Table` of (possibly device)
arrays, a NumPy structured array, or any host object — the Context
normalizes. A plugin may also expose ``kernel_version``: a string folded
into its lineage so cached results invalidate when the underlying jit/Pallas
kernel changes independently of plugin logic.
"""

from __future__ import annotations

import abc
import inspect
import logging
import warnings
from typing import Any, Dict, List, Literal, Optional, Tuple, Union

import numpy as np

from waveformanalysis_tpu_torch.config.option import Option, option, takes_config  # re-export

logger = logging.getLogger(__name__)

try:
    from packaging.specifiers import SpecifierSet
    from packaging.version import InvalidVersion, Version

    PACKAGING_AVAILABLE = True
except ImportError:  # pragma: no cover
    PACKAGING_AVAILABLE = False
    Version = SpecifierSet = InvalidVersion = None

DependencySpec = Union[str, Tuple[str, str]]


class Plugin(abc.ABC):
    """Base class for all processing plugins (strax-inspired)."""

    provides: str = ""
    depends_on: List[DependencySpec] = []
    options: Dict[str, Option] = {}
    save_when: str = "never"  # never | always | target
    output_dtype: Optional[Any] = None  # np.dtype, Schema, or description
    input_dtype: Dict[str, Any] = {}
    output_kind: Literal["static", "stream"] = "static"
    description: str = ""
    version: str = "0.0.0"
    kernel_version: str = ""  # extra lineage term for jit/Pallas kernel revs
    is_side_effect: bool = False
    uses_run_config: bool = False
    timeout: Optional[float] = None

    # registration metadata
    _registered_from_module: Optional[str] = None
    _registered_class: Optional[str] = None
    _validated_spec: Optional[Any] = None

    # -- versioning ----------------------------------------------------------

    @property
    def semantic_version(self):
        if not PACKAGING_AVAILABLE:
            return None
        try:
            return Version(self.version)
        except (InvalidVersion, TypeError):
            logger.warning(
                "Plugin %s has invalid version %r, using 0.0.0",
                type(self).__name__, self.version,
            )
            return Version("0.0.0")

    # -- dependency helpers --------------------------------------------------

    @staticmethod
    def get_dependency_name(dep: DependencySpec) -> str:
        return dep[0] if isinstance(dep, tuple) else dep

    @staticmethod
    def get_dependency_version_spec(dep: DependencySpec) -> Optional[str]:
        if isinstance(dep, tuple) and len(dep) > 1:
            return dep[1]
        return None

    def resolve_depends_on(
        self, context: Any, run_id: Optional[str] = None
    ) -> List[DependencySpec]:
        """Dynamic dependency hook; default returns the static list."""
        return list(self.depends_on) if self.depends_on else []

    def _build_depends_lineage(self, context: Any) -> Dict[str, Any]:
        """Helper for plugins overriding get_lineage: lineage of all deps."""
        try:
            deps = self.resolve_depends_on(context, run_id=None)
        except TypeError:
            deps = self.resolve_depends_on(context)  # type: ignore[call-arg]
        return {
            self.get_dependency_name(d): context.get_lineage(self.get_dependency_name(d))
            for d in (deps or [])
        }

    # -- option inheritance --------------------------------------------------

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        merged: Dict[str, Option] = {}
        for base in reversed(cls.__mro__):
            opts = base.__dict__.get("options")
            if isinstance(opts, dict):
                merged.update(opts)
            takes = base.__dict__.get("takes_config")
            if isinstance(takes, dict):  # strax-style attribute
                merged.update(takes)
        cls.options = merged

    @property
    def config_keys(self) -> List[str]:
        return list(self.options.keys())

    # -- validation ----------------------------------------------------------

    def validate(self) -> None:
        """Structural validation, run at registration time."""
        cls_name = type(self).__name__
        if not self.provides:
            raise ValueError(f"Plugin {cls_name} must specify 'provides'")
        if not isinstance(self.depends_on, (list, tuple)):
            raise TypeError(
                f"Plugin {self.provides}: 'depends_on' must be a list or tuple, "
                f"got {type(self.depends_on)}"
            )

        has_dynamic = type(self).resolve_depends_on is not Plugin.resolve_depends_on
        if has_dynamic and self.depends_on:
            location = None
            try:
                src = inspect.getsourcefile(type(self))
                line = inspect.getsourcelines(type(self))[1]
                location = f"{src}:{line}" if src else None
            except Exception:
                pass
            hint = f" @ {location}" if location else ""
            warnings.warn(
                f"Plugin {self.provides} ({cls_name}{hint}): resolve_depends_on() is "
                f"defined but depends_on is not empty ({self.depends_on!r}). "
                "Prefer depends_on=[] to avoid confusion.",
                UserWarning,
                stacklevel=2,
            )

        for dep in self.depends_on:
            if isinstance(dep, str):
                continue
            if isinstance(dep, tuple):
                if len(dep) != 2:
                    raise ValueError(
                        f"Plugin {self.provides}: dependency tuple must be "
                        f"(name, version_spec), got {dep}"
                    )
                name, spec = dep
                if not isinstance(name, str) or not isinstance(spec, str):
                    raise TypeError(
                        f"Plugin {self.provides}: dependency tuple entries must be strings"
                    )
                if PACKAGING_AVAILABLE:
                    try:
                        SpecifierSet(spec)
                    except Exception as e:
                        raise ValueError(
                            f"Plugin {self.provides}: invalid version specifier "
                            f"'{spec}': {e}"
                        ) from None
            else:
                raise TypeError(
                    f"Plugin {self.provides}: dependency must be str or "
                    f"(name, version_spec) tuple, got {type(dep)}"
                )

        if not isinstance(self.options, dict):
            raise TypeError(f"Plugin {self.provides}: 'options' must be a dict")
        for k, v in self.options.items():
            if not isinstance(v, Option):
                raise TypeError(
                    f"Plugin {self.provides}: option '{k}' must be an Option instance"
                )
        for key in self.config_keys:
            if key not in self.options:
                raise ValueError(
                    f"Plugin {self.provides}: config_key '{key}' not defined in 'options'"
                )

        if self.save_when not in ("never", "always", "target"):
            raise ValueError(
                f"Plugin {self.provides}: 'save_when' must be one of "
                "('never', 'always', 'target')"
            )
        if self.output_kind not in ("static", "stream"):
            raise ValueError(
                f"Plugin {self.provides}: 'output_kind' must be 'static' or 'stream'"
            )

        dep_names = [self.get_dependency_name(d) for d in self.depends_on]
        for dep in self.input_dtype:
            if dep not in dep_names:
                raise ValueError(
                    f"Plugin {self.provides}: input_dtype specified for '{dep}', "
                    "but it's not in depends_on"
                )

    # -- lifecycle -----------------------------------------------------------

    @abc.abstractmethod
    def compute(self, context: Any, run_id: str, **kwargs: Any) -> Any:
        """Produce this plugin's data. Inputs come from
        ``context.get_data(run_id, dep)``; config from
        ``context.get_config(self, key)``."""

    def on_error(self, context: Any, exception: Exception) -> None:
        """Hook called when compute() raises."""

    def cleanup(self, context: Any) -> None:
        """Hook called after compute() finishes (success or failure)."""

    def validate_config(self, context: Any) -> Dict[str, Any]:
        """Resolve + validate every option via the context.

        Also warns on unknown keys in this plugin's scoped config dict —
        a typo'd key (e.g. ``order`` vs ``filter_order``) silently falling
        back to the default is far harder to debug than a warning.
        """
        scoped = context.config.get(self.provides)
        if isinstance(scoped, dict):
            from waveformanalysis_tpu_torch.config.compat import CompatManager

            compat = CompatManager()
            for key in scoped:
                if key in self.options:
                    continue
                canonical, was_alias = compat.resolve_alias(self.provides, key)
                if was_alias and canonical in self.options:
                    continue
                import warnings

                warnings.warn(
                    f"config key '{key}' in the '{self.provides}' section is "
                    f"not an option of this plugin (known: "
                    f"{sorted(self.options)}); it will be ignored",
                    UserWarning,
                    stacklevel=2,
                )
        return {key: context.get_config(self, key) for key in self.options}

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        has_dynamic = type(self).resolve_depends_on is not Plugin.resolve_depends_on
        if has_dynamic:
            marker = f"<dynamic:{type(self).resolve_depends_on.__name__}>"
            if self.depends_on:
                return (
                    f"Plugin({self.provides}, depends_on={marker}, "
                    f"static_depends_on={self.depends_on})"
                )
            return f"Plugin({self.provides}, depends_on={marker})"
        return f"Plugin({self.provides}, depends_on={self.depends_on})"
