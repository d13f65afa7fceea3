"""Plugin discovery: entry points and directory scans.

Behavioral analog of the reference PluginLoader
(reference: waveform_analysis/core/plugins/core/loader.py:27-270): discovers
Plugin subclasses from entry points plus ad-hoc directory scans; failures
are collected into a report instead of aborting discovery.

Port of ``waveformanalysis_tpu/plugins/loader.py``. It reads the entry-point
groups ``waveformanalysis_tpu_torch.plugins`` (this package's own) and
``waveform_analysis.plugins`` (the reference's, for drop-in plugins); the
JAX package's group ``waveformanalysis_tpu.plugins`` is not read. Only
subclasses of this package's ``Plugin`` load: a class that declares
``provides`` and ``compute`` but derives from another ``Plugin`` (a JAX
package plugin, say) is reported as a ``LoadFailure``.
"""

from __future__ import annotations

import importlib
import importlib.util
import inspect
import logging
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, List, Optional, Type, Union

from waveformanalysis_tpu_torch.plugins.base import Plugin

logger = logging.getLogger(__name__)

ENTRY_POINT_GROUPS = (
    "waveformanalysis_tpu_torch.plugins",
    "waveform_analysis.plugins",  # reference group, for drop-in plugins
)



@dataclass
class LoadFailure:
    source: str
    error: str


@dataclass
class DiscoveryReport:
    plugins: List[Type[Plugin]] = field(default_factory=list)
    failures: List[LoadFailure] = field(default_factory=list)

    def summary(self) -> str:
        lines = [f"Discovered {len(self.plugins)} plugins"]
        for cls in self.plugins:
            lines.append(f"  {cls.__module__}.{cls.__name__} -> {cls.provides}")
        if self.failures:
            lines.append(f"Failures ({len(self.failures)}):")
            for f in self.failures:
                lines.append(f"  {f.source}: {f.error}")
        return "\n".join(lines)


class PluginLoader:
    """Discovers and optionally registers plugin classes."""

    def __init__(self) -> None:
        self.report = DiscoveryReport()

    # -- discovery ------------------------------------------------------------

    def discover_entry_points(self) -> List[Type[Plugin]]:
        from importlib import metadata

        found: List[Type[Plugin]] = []
        for group in ENTRY_POINT_GROUPS:
            try:
                eps = metadata.entry_points(group=group)
            except TypeError:  # older API
                eps = metadata.entry_points().get(group, [])  # type: ignore
            for ep in eps:
                try:
                    obj = ep.load()
                    found.extend(self._collect_plugin_classes(obj, source=str(ep)))
                except Exception as e:
                    self.report.failures.append(LoadFailure(str(ep), str(e)))
                    logger.warning("Failed to load entry point %s: %s", ep, e)
        self.report.plugins.extend(found)
        return found

    def discover_directory(
        self, directory: Union[str, Path], pattern: str = "*.py"
    ) -> List[Type[Plugin]]:
        """Import every matching file and collect Plugin subclasses."""
        directory = Path(directory)
        found: List[Type[Plugin]] = []
        if not directory.exists():
            self.report.failures.append(
                LoadFailure(str(directory), "directory does not exist")
            )
            return found
        for path in sorted(directory.glob(pattern)):
            if path.name.startswith("_"):
                continue
            try:
                module = self._import_file(path)
                found.extend(self._collect_plugin_classes(module, source=str(path)))
            except Exception as e:
                self.report.failures.append(LoadFailure(str(path), str(e)))
                logger.warning("Failed to import plugin file %s: %s", path, e)
        self.report.plugins.extend(found)
        return found

    def discover_module(self, module_name: str) -> List[Type[Plugin]]:
        try:
            module = importlib.import_module(module_name)
        except Exception as e:
            self.report.failures.append(LoadFailure(module_name, str(e)))
            return []
        found = self._collect_plugin_classes(module, source=module_name)
        self.report.plugins.extend(found)
        return found

    def discover_all(
        self, directories: Optional[List[Union[str, Path]]] = None
    ) -> DiscoveryReport:
        """Entry points + optional directories (reference: loader.py:217)."""
        self.discover_entry_points()
        for d in directories or []:
            self.discover_directory(d)
        return self.report

    # -- registration -----------------------------------------------------------

    def register_discovered(self, context: Any) -> int:
        n = 0
        for cls in self.report.plugins:
            try:
                context.register(cls())
                n += 1
            except Exception as e:
                self.report.failures.append(
                    LoadFailure(f"{cls.__module__}.{cls.__name__}", str(e))
                )
        return n

    # -- internals ----------------------------------------------------------------

    @staticmethod
    def _import_file(path: Path):
        name = f"_wfa_plugin_{path.stem}_{abs(hash(str(path))) % 10**8}"
        spec = importlib.util.spec_from_file_location(name, path)
        if spec is None or spec.loader is None:
            raise ImportError(f"cannot build import spec for {path}")
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
        return module

    def _collect_plugin_classes(self, obj: Any, source: str) -> List[Type[Plugin]]:
        """Plugin subclasses in ``obj`` (a class, or a module's classes);
        a plugin-like class of another Plugin hierarchy goes to the report."""
        if inspect.isclass(obj) and issubclass(obj, Plugin):
            return [obj]
        candidates = [obj] if inspect.isclass(obj) else [
            member for _name, member in inspect.getmembers(obj, inspect.isclass)
        ]
        out = []
        for member in candidates:
            if not issubclass(member, Plugin):
                if _foreign_plugin(member):
                    self.report.failures.append(LoadFailure(
                        source,
                        f"{member.__module__}.{member.__qualname__} is not a subclass "
                        f"of {Plugin.__module__}.Plugin",
                    ))
                continue
            if (
                member is not Plugin
                and not inspect.isabstract(member)
                and getattr(member, "provides", "")
            ):
                out.append(member)
        return out


def _foreign_plugin(cls: type) -> bool:
    """A class shaped like a plugin (a ``provides`` name and a ``compute``)
    that does not derive from this package's Plugin."""
    return bool(getattr(cls, "provides", "")) and callable(getattr(cls, "compute", None))
