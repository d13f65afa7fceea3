"""Plugin hot reloading during development.

Behavioral analog of the reference hot reloader
(reference: waveform_analysis/core/plugins/core/hot_reload.py:33-288):
watches plugin source files by mtime + content hash, re-imports changed
modules, re-registers their plugins on the Context, optionally clears
affected caches, and can poll in a background thread.

Port of ``waveformanalysis_tpu/plugins/hot_reload.py``. A reloaded fused
member's ``device_stage`` takes effect at its next compute here: the port's
fused executor reads each member's stage from its class at every dispatch,
where the JAX package's keeps the program it built first for the same
members and config (a divergence, ROADMAP Queue 3).
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import logging
import sys
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


@dataclass
class _WatchedFile:
    path: Path
    mtime_ns: int
    sha1: str


def _signature(path: Path) -> Optional[_WatchedFile]:
    try:
        data = path.read_bytes()
        return _WatchedFile(
            path=path,
            mtime_ns=path.stat().st_mtime_ns,
            sha1=hashlib.sha1(data).hexdigest(),
        )
    except OSError:
        return None


class PluginHotReloader:
    """Watches registered plugins' source modules and reloads on change."""

    def __init__(self, context: Any, clear_caches: bool = True) -> None:
        self.ctx = context
        self.clear_caches = clear_caches
        self._watched: Dict[str, _WatchedFile] = {}  # module name -> sig
        self._module_plugins: Dict[str, List[str]] = {}  # module -> provides
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.reload_count = 0

    # -- watching ------------------------------------------------------------

    def watch_registered(self) -> int:
        """Watch the source files of every currently registered plugin."""
        n = 0
        for name, plugin in self.ctx.plugins.items():
            module_name = type(plugin).__module__
            module = importlib.import_module(module_name)
            src = getattr(module, "__file__", None)
            if not src:
                continue
            sig = _signature(Path(src))
            if sig is None:
                continue
            self._watched[module_name] = sig
            self._module_plugins.setdefault(module_name, [])
            if name not in self._module_plugins[module_name]:
                self._module_plugins[module_name].append(name)
                n += 1
        return n

    def changed_modules(self) -> List[str]:
        out = []
        for module_name, old in self._watched.items():
            sig = _signature(old.path)
            if sig is None:
                continue
            if sig.mtime_ns != old.mtime_ns and sig.sha1 != old.sha1:
                out.append(module_name)
        return out

    # -- reloading -----------------------------------------------------------

    def reload_module(self, module_name: str) -> List[str]:
        """Re-import one module and re-register its plugins."""
        old_module = importlib.import_module(module_name)
        try:
            module = importlib.reload(old_module)
        except (ImportError, ModuleNotFoundError):
            # file-loaded synthetic modules (PluginLoader.discover_directory)
            # can't be reloaded by name; re-exec from the source file
            src = getattr(old_module, "__file__", None)
            if not src:
                raise
            spec = importlib.util.spec_from_file_location(module_name, src)
            module = importlib.util.module_from_spec(spec)
            sys.modules[module_name] = module
            spec.loader.exec_module(module)
        src = getattr(module, "__file__", None)
        if src:
            sig = _signature(Path(src))
            if sig is not None:
                self._watched[module_name] = sig

        reregistered = []
        for provides in self._module_plugins.get(module_name, []):
            old = self.ctx.get_plugin(provides)
            if old is None:
                continue
            cls = getattr(module, type(old).__name__, None)
            if cls is None:
                logger.warning(
                    "Plugin class %s vanished from %s after reload",
                    type(old).__name__, module_name,
                )
                continue
            self.ctx.register(cls())
            reregistered.append(provides)
            if self.clear_caches:
                self.ctx.cache_domain.invalidate_caches_for(provides)
        if reregistered:
            self.reload_count += 1
            logger.info("Hot-reloaded %s -> %s", module_name, reregistered)
        return reregistered

    def check_and_reload(self) -> List[str]:
        out = []
        for module_name in self.changed_modules():
            try:
                out.extend(self.reload_module(module_name))
            except Exception as e:
                logger.warning("Hot reload of %s failed: %s", module_name, e)
        return out

    # -- background polling ----------------------------------------------------

    def start(self, interval_s: float = 1.0) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval_s):
                self.check_and_reload()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="plugin-hot-reload")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=2.0)
            self._thread = None


def enable_hot_reload(context: Any, interval_s: float = 1.0,
                      background: bool = False) -> PluginHotReloader:
    """Convenience entry (reference: hot_reload.py:250)."""
    reloader = PluginHotReloader(context)
    reloader.watch_registered()
    if background:
        reloader.start(interval_s)
    return reloader
