"""Legacy function-level result cache.

Behavioral analog of the reference function cache
(reference: waveform_analysis/core/storage/cache.py:24): memoize expensive
function results to disk keyed by the argument hash plus "watch" file
signatures (path + mtime + size), so edits to watched inputs invalidate.

Port of ``waveformanalysis_tpu/storage/function_cache.py``.
"""

from __future__ import annotations

import functools
import hashlib
import logging
import pickle
from pathlib import Path
from typing import Any, Callable, Iterable, Optional, Sequence, Union

logger = logging.getLogger(__name__)


def file_signature(path: Union[str, Path]) -> str:
    p = Path(path)
    try:
        st = p.stat()
        return f"{p}:{st.st_mtime_ns}:{st.st_size}"
    except OSError:
        return f"{p}:missing"


class CacheManager:
    """Disk memoization with watched-file invalidation."""

    def __init__(self, cache_dir: Union[str, Path]) -> None:
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)

    def _key(self, fn_name: str, args: tuple, kwargs: dict,
             watch_files: Sequence[Union[str, Path]]) -> str:
        h = hashlib.sha1()
        h.update(fn_name.encode())
        try:
            h.update(pickle.dumps((args, sorted(kwargs.items()))))
        except Exception:
            h.update(repr((args, sorted(kwargs.items()))).encode())
        for f in watch_files:
            h.update(file_signature(f).encode())
        return h.hexdigest()[:16]

    def _path(self, fn_name: str, key: str) -> Path:
        return self.cache_dir / f"{fn_name}-{key}.pkl"

    def get(self, fn_name: str, key: str) -> Any:
        path = self._path(fn_name, key)
        if not path.exists():
            return None
        try:
            with open(path, "rb") as fh:
                return pickle.load(fh)
        except Exception as e:
            logger.warning("Failed to load function cache %s: %s", path, e)
            return None

    def put(self, fn_name: str, key: str, value: Any) -> None:
        path = self._path(fn_name, key)
        tmp = path.with_suffix(".pkl.tmp")
        try:
            with open(tmp, "wb") as fh:
                pickle.dump(value, fh)
            tmp.replace(path)
        except Exception as e:
            logger.warning("Failed to save function cache %s: %s", path, e)
            tmp.unlink(missing_ok=True)

    def clear(self, fn_name: Optional[str] = None) -> int:
        pattern = f"{fn_name}-*.pkl" if fn_name else "*.pkl"
        n = 0
        for p in self.cache_dir.glob(pattern):
            p.unlink(missing_ok=True)
            n += 1
        return n

    def cached(
        self,
        watch_files: Union[Sequence[Union[str, Path]], Callable[..., Iterable], None] = None,
    ) -> Callable:
        """Decorator: cache results; watch_files may be a static list or a
        callable(*args, **kwargs) -> iterable of paths."""

        def decorator(fn: Callable) -> Callable:
            @functools.wraps(fn)
            def wrapper(*args: Any, **kwargs: Any) -> Any:
                if callable(watch_files):
                    files = list(watch_files(*args, **kwargs))
                else:
                    files = list(watch_files or [])
                key = self._key(fn.__qualname__, args, kwargs, files)
                hit = self.get(fn.__qualname__, key)
                if hit is not None:
                    return hit
                result = fn(*args, **kwargs)
                if result is not None:
                    self.put(fn.__qualname__, key, result)
                return result

            wrapper.cache_manager = self  # type: ignore[attr-defined]
            return wrapper

        return decorator
