"""Memmap-backed content-addressed cache storage.

Behavioral analog of the reference MemmapStorage
(reference: waveform_analysis/core/storage/memmap.py:76): layout
``work_dir/{run_id}/_cache/{key}.bin|.json|.lock``, atomic ``.tmp``+rename
writes, fcntl lock files, zero-copy ``np.memmap`` loads,
buffered streaming saves, per-key JSON metadata carrying lineage / dtype /
checksum, and DataFrame persistence via Parquet/pickle.

TPU-native extension: in addition to NumPy structured arrays (format
"structured", byte-identical zero-copy memmap), a
:class:`~waveformanalysis_tpu_torch.dtypes.table.Table` is stored as packed
per-field buffers in a single ``.bin`` with a field offset table in the
metadata (format "table") — each field memmaps zero-copy and uploads to
device HBM without a transpose, which is the layout device kernels want.
"""

from __future__ import annotations

import json
import logging
import os
import time
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np

from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.foundation.constants import ProcessingDefaults, StorageDefaults
from waveformanalysis_tpu_torch.foundation.exceptions import StorageError
from waveformanalysis_tpu_torch.storage.compression import CompressionManager
from waveformanalysis_tpu_torch.storage.integrity import IntegrityChecker

try:
    import fcntl

    _HAS_FCNTL = True
except ImportError:  # pragma: no cover - non-posix
    fcntl = None
    _HAS_FCNTL = False

logger = logging.getLogger(__name__)

STORAGE_VERSION = StorageDefaults.STORAGE_VERSION


class FileLock:
    """fcntl-based advisory lock file with timeout.

    ``release`` unlinks the lock file, so a waiter may hold a descriptor on
    a file that no longer has the lock path's name. An acquirer therefore
    owns the lock only when the file it locked is still the one the path
    names (same inode); otherwise it drops it and opens the path again.
    There is no stale-file removal: the kernel releases the flock of a
    process that dies, and removing the file of a live holder would let a
    second writer in beside it.
    """

    def __init__(
        self,
        path: Union[str, Path],
        timeout: float = StorageDefaults.LOCK_TIMEOUT,
        retry_interval: float = StorageDefaults.LOCK_RETRY_INTERVAL,
    ) -> None:
        self.path = Path(path)
        self.timeout = timeout
        self.retry_interval = retry_interval
        self._fh = None

    def _try_lock(self, fh) -> bool:
        """Non-blocking flock of ``fh``; True when it is held and ``fh``
        is still the file the lock path names."""
        try:
            fcntl.flock(fh.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            return False
        try:
            same = os.stat(self.path).st_ino == os.fstat(fh.fileno()).st_ino
        except FileNotFoundError:
            same = False
        if not same:  # unlinked (or replaced) since fh was opened
            fcntl.flock(fh.fileno(), fcntl.LOCK_UN)
        return same

    def acquire(self) -> None:
        if not _HAS_FCNTL:
            return
        deadline = time.monotonic() + self.timeout
        self.path.parent.mkdir(parents=True, exist_ok=True)
        while True:
            fh = open(self.path, "a+")
            if self._try_lock(fh):
                self._fh = fh
                fh.seek(0)
                fh.truncate()
                fh.write(f"{os.getpid()} {time.time()}\n")
                fh.flush()
                return
            fh.close()
            if time.monotonic() > deadline:
                raise StorageError(
                    f"Timed out acquiring lock {self.path} after {self.timeout}s"
                )
            time.sleep(self.retry_interval)

    def release(self) -> None:
        if self._fh is None:
            return
        # unlink while still holding the flock: a waiter that locks the old
        # file afterwards sees that the path no longer names it
        self.path.unlink(missing_ok=True)
        fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)
        self._fh.close()
        self._fh = None

    def __enter__(self) -> "FileLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class BufferedStreamWriter:
    """Buffered append-writer for streaming saves (4 MB buffer by default).

    Accumulates structured-array (or Table) chunks, writes them to a ``.tmp``
    payload file, and records enough layout info for finalize_save to emit
    metadata atomically.
    """

    def __init__(self, tmp_path: Path, buffer_size: int = ProcessingDefaults.BUFFER_SIZE) -> None:
        self.tmp_path = tmp_path
        self.buffer_size = buffer_size
        self._fh = open(tmp_path, "wb", buffering=buffer_size)
        self.n_rows = 0
        self.dtype: Optional[np.dtype] = None
        self.schema = None
        self.closed = False

    def append(self, chunk: Any) -> None:
        if self.closed:
            raise StorageError("Stream writer already finalized")
        if isinstance(chunk, Table):
            self.schema = self.schema or chunk.schema
            chunk = chunk.to_numpy()
        arr = np.ascontiguousarray(chunk)
        if arr.dtype.names is None:
            raise StorageError("Stream writer expects structured arrays or Tables")
        if self.dtype is None:
            self.dtype = arr.dtype
        elif arr.dtype != self.dtype:
            raise StorageError(
                f"Stream chunk dtype {arr.dtype} != first chunk dtype {self.dtype}"
            )
        self._fh.write(arr.tobytes())
        self.n_rows += len(arr)

    def close(self) -> None:
        if not self.closed:
            self._fh.close()
            self.closed = True

    def abort(self) -> None:
        self.close()
        self.tmp_path.unlink(missing_ok=True)


class MemmapStorage:
    """Filesystem cache backend with zero-copy memmap loads."""

    data_subdir = "_cache"

    def __init__(
        self,
        work_dir: Union[str, Path],
        compression: str = "none",
        verify_checksums_on_load: bool = False,
        memmap_mode: str = ProcessingDefaults.MEMMAP_MODE,
    ) -> None:
        self.work_dir = str(work_dir)
        Path(self.work_dir).mkdir(parents=True, exist_ok=True)
        self.compression = CompressionManager(default_codec=compression)
        self.integrity = IntegrityChecker()
        self.verify_checksums_on_load = verify_checksums_on_load
        self.memmap_mode = memmap_mode

    # -- paths ---------------------------------------------------------------

    def _dir_for(self, run_id: Optional[str]) -> Path:
        base = Path(self.work_dir)
        if run_id:
            base = base / run_id
        return base / self.data_subdir

    def _bin_path(self, key: str, run_id: Optional[str]) -> Path:
        return self._dir_for(run_id) / f"{key}.bin"

    def _meta_path(self, key: str, run_id: Optional[str]) -> Path:
        return self._dir_for(run_id) / f"{key}.json"

    def _lock_path(self, key: str, run_id: Optional[str]) -> Path:
        return self._dir_for(run_id) / f"{key}.lock"

    # -- protocol ------------------------------------------------------------

    def exists(self, key: str, run_id: Optional[str] = None) -> bool:
        return self._bin_path(key, run_id).exists() or (
            self._meta_path(key, run_id).exists()
        )

    def get_size(self, key: str, run_id: Optional[str] = None) -> int:
        try:
            return self._bin_path(key, run_id).stat().st_size
        except OSError:
            return 0

    def stored_bytes(self, key: str, run_id: Optional[str] = None) -> int:
        """Bytes of every file kept for ``key``: payload and metadata (with
        its lineage); 0 for a key not stored."""
        d = self._dir_for(run_id)
        total = 0
        for suffix in (".bin", ".json", ".parquet", ".pkl"):
            try:
                total += (d / f"{key}{suffix}").stat().st_size
            except OSError:
                pass
        return total

    def list_keys(self, run_id: Optional[str] = None, prefix: str = "") -> List[str]:
        d = self._dir_for(run_id)
        if not d.exists():
            return []
        keys = set()
        for p in d.iterdir():
            if p.suffix in (".bin", ".json", ".parquet", ".pkl"):
                if p.stem.startswith(prefix):
                    keys.add(p.stem)
        return sorted(keys)

    def delete(self, key: str, run_id: Optional[str] = None) -> None:
        for path in (
            self._bin_path(key, run_id),
            self._meta_path(key, run_id),
            # not the lock file: a writer may hold it (FileLock.release
            # removes it)
            self._dir_for(run_id) / f"{key}.parquet",
            self._dir_for(run_id) / f"{key}.pkl",
        ):
            path.unlink(missing_ok=True)

    # -- metadata ------------------------------------------------------------

    def save_metadata(self, key: str, metadata: Dict[str, Any], run_id: Optional[str] = None) -> None:
        path = self._meta_path(key, run_id)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".json.tmp")
        with open(tmp, "w") as fh:
            json.dump(metadata, fh, default=str)
        os.replace(tmp, path)

    def get_metadata(self, key: str, run_id: Optional[str] = None) -> Optional[Dict[str, Any]]:
        path = self._meta_path(key, run_id)
        if not path.exists():
            return None
        try:
            with open(path) as fh:
                return json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            logger.warning("Failed to read metadata %s: %s", path, e)
            return None

    # -- save ----------------------------------------------------------------

    def save_memmap(
        self,
        key: str,
        data: Any,
        run_id: Optional[str] = None,
        lineage: Optional[Dict[str, Any]] = None,
        extra_metadata: Optional[Dict[str, Any]] = None,
        compression: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Save an array/Table payload atomically; returns the metadata dict."""
        bin_path = self._bin_path(key, run_id)
        bin_path.parent.mkdir(parents=True, exist_ok=True)

        meta: Dict[str, Any] = {
            "storage_version": STORAGE_VERSION,
            "created_at": datetime.now(timezone.utc).isoformat(),
            "key": key,
            "run_id": run_id,
        }
        if lineage is not None:
            meta["lineage"] = lineage

        if isinstance(data, Table):
            payload, fields_meta = _pack_table(data)
            meta["format"] = "table"
            meta["n_rows"] = len(data)
            meta["fields"] = fields_meta
            if data.schema is not None:
                meta["schema_name"] = data.schema.name
                meta["dtype_descr"] = _jsonable_descr(data)
        else:
            arr = np.ascontiguousarray(np.asarray(data))
            if arr.dtype.names is None and arr.dtype.kind in ("U", "S", "O"):
                raise StorageError(
                    f"Cannot memmap-save non-numeric unstructured array of dtype {arr.dtype}"
                )
            payload = arr.tobytes()
            meta["format"] = "structured" if arr.dtype.names else "array"
            meta["n_rows"] = int(arr.shape[0]) if arr.ndim else 0
            meta["dtype_descr"] = arr.dtype.descr if arr.dtype.names else str(arr.dtype)
            if arr.dtype.names is None:
                meta["shape"] = list(arr.shape)

        payload, codec = self.compression.compress(payload, compression)
        meta["compression"] = codec
        meta["nbytes"] = len(payload)

        with FileLock(self._lock_path(key, run_id)):
            tmp = bin_path.with_suffix(".bin.tmp")
            with open(tmp, "wb") as fh:
                fh.write(payload)
            os.replace(tmp, bin_path)
            meta["checksum"] = self.integrity.compute(bin_path)
            if extra_metadata:
                meta.update(extra_metadata)
            self.save_metadata(key, meta, run_id)
        return meta

    # -- load ----------------------------------------------------------------

    def load_memmap(self, key: str, run_id: Optional[str] = None) -> Any:
        """Load a payload; zero-copy memmap when uncompressed."""
        bin_path = self._bin_path(key, run_id)
        meta = self.get_metadata(key, run_id)
        if meta is None or not bin_path.exists():
            return None

        expected = meta.get("nbytes")
        actual = bin_path.stat().st_size
        if expected is not None and actual != expected:
            logger.warning(
                "Size mismatch for %s: %s != %s; treating as corrupt", key, actual, expected
            )
            return None
        if self.verify_checksums_on_load and not self.integrity.verify(
            bin_path, meta.get("checksum", {})
        ):
            logger.warning("Checksum mismatch for %s; treating as corrupt", key)
            return None

        codec = meta.get("compression", "none")
        fmt = meta.get("format", "structured")

        if codec != "none":
            raw = self.compression.decompress(bin_path.read_bytes(), codec)
            return _reconstruct_from_bytes(raw, meta)

        if fmt == "table":
            return _memmap_table(bin_path, meta, self.memmap_mode)
        if fmt == "structured":
            dtype = _dtype_from_descr(meta["dtype_descr"])
            if actual == 0:
                return np.zeros(0, dtype=dtype)  # mmap cannot map 0 bytes
            return np.memmap(bin_path, dtype=dtype, mode=self.memmap_mode)
        if fmt == "array":
            dtype = np.dtype(meta["dtype_descr"])
            shape = meta.get("shape")
            if actual == 0:
                return np.zeros(tuple(shape) if shape else 0, dtype=dtype)
            mm = np.memmap(bin_path, dtype=dtype, mode=self.memmap_mode)
            return mm.reshape(shape) if shape else mm
        raise StorageError(f"Unknown storage format {fmt!r} for key {key}")

    # -- streaming -----------------------------------------------------------

    def save_stream(self, key: str, run_id: Optional[str] = None) -> BufferedStreamWriter:
        """Open a buffered streaming writer; call finalize_save when done."""
        bin_path = self._bin_path(key, run_id)
        bin_path.parent.mkdir(parents=True, exist_ok=True)
        return BufferedStreamWriter(bin_path.with_suffix(".bin.tmp"))

    def finalize_save(
        self,
        key: str,
        writer: BufferedStreamWriter,
        run_id: Optional[str] = None,
        lineage: Optional[Dict[str, Any]] = None,
        extra_metadata: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Atomically promote a streamed .tmp payload + write metadata."""
        writer.close()
        bin_path = self._bin_path(key, run_id)
        with FileLock(self._lock_path(key, run_id)):
            os.replace(writer.tmp_path, bin_path)
            meta: Dict[str, Any] = {
                "storage_version": STORAGE_VERSION,
                "created_at": datetime.now(timezone.utc).isoformat(),
                "key": key,
                "run_id": run_id,
                "format": "structured",
                "n_rows": writer.n_rows,
                "dtype_descr": writer.dtype.descr if writer.dtype is not None else [],
                "compression": "none",
                "nbytes": bin_path.stat().st_size,
                "streamed": True,
            }
            if writer.schema is not None:
                meta["schema_name"] = writer.schema.name
            if lineage is not None:
                meta["lineage"] = lineage
            meta["checksum"] = self.integrity.compute(bin_path)
            if extra_metadata:
                meta.update(extra_metadata)
            self.save_metadata(key, meta, run_id)
        return meta

    # -- dataframes ----------------------------------------------------------

    def save_dataframe(
        self,
        key: str,
        df: Any,
        run_id: Optional[str] = None,
        lineage: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Persist a pandas DataFrame (Parquet preferred, pickle fallback)."""
        d = self._dir_for(run_id)
        d.mkdir(parents=True, exist_ok=True)
        fmt = "parquet"
        path = d / f"{key}.parquet"
        try:
            tmp = path.with_suffix(".parquet.tmp")
            df.to_parquet(tmp)
            os.replace(tmp, path)
        except Exception:
            path.unlink(missing_ok=True)
            fmt = "pickle"
            path = d / f"{key}.pkl"
            tmp = path.with_suffix(".pkl.tmp")
            df.to_pickle(tmp)
            os.replace(tmp, path)
        meta = {
            "storage_version": STORAGE_VERSION,
            "created_at": datetime.now(timezone.utc).isoformat(),
            "key": key,
            "run_id": run_id,
            "type": "dataframe",
            "format": fmt,
            "n_rows": int(len(df)),
            "nbytes": path.stat().st_size,
            "compression": "none",
        }
        if lineage is not None:
            meta["lineage"] = lineage
        self.save_metadata(key, meta, run_id)
        return meta

    def load_dataframe(self, key: str, run_id: Optional[str] = None) -> Any:
        import pandas as pd

        d = self._dir_for(run_id)
        pq = d / f"{key}.parquet"
        if pq.exists():
            return pd.read_parquet(pq)
        pkl = d / f"{key}.pkl"
        if pkl.exists():
            return pd.read_pickle(pkl)
        return None

    # -- integrity -----------------------------------------------------------

    def verify_integrity(self, run_id: Optional[str] = None) -> Dict[str, Any]:
        """Full checksum verification of every entry for a run."""
        report = {"checked": 0, "ok": 0, "corrupt": [], "missing_metadata": []}
        for key in self.list_keys(run_id):
            meta = self.get_metadata(key, run_id)
            bin_path = self._bin_path(key, run_id)
            if not bin_path.exists():
                continue
            report["checked"] += 1
            if meta is None:
                report["missing_metadata"].append(key)
                continue
            if self.integrity.verify(bin_path, meta.get("checksum", {})):
                report["ok"] += 1
            else:
                report["corrupt"].append(key)
        return report


# --------------------------------------------------------------------------
# Packing helpers
# --------------------------------------------------------------------------

def _pack_table(table: Table) -> tuple:
    """Pack Table columns into one contiguous buffer + field offset table.

    64-byte aligns each field so memmapped views are cache/TPU-DMA friendly.
    """
    host = table.to_host()
    parts: List[bytes] = []
    fields_meta: List[Dict[str, Any]] = []
    offset = 0
    for name, col in host.columns.items():
        arr = np.ascontiguousarray(col)
        if arr.dtype.kind in ("U", "S", "O"):
            raise StorageError(
                f"Table field '{name}' has non-numeric dtype {arr.dtype}; "
                "encode enums before saving"
            )
        pad = (-offset) % 64
        if pad:
            parts.append(b"\x00" * pad)
            offset += pad
        raw = arr.tobytes()
        fields_meta.append(
            {
                "name": name,
                "dtype": arr.dtype.str,
                "shape": list(arr.shape),
                "offset": offset,
                "nbytes": len(raw),
            }
        )
        parts.append(raw)
        offset += len(raw)
    return b"".join(parts), fields_meta


def _memmap_table(bin_path: Path, meta: Dict[str, Any], mode: str) -> Table:
    """Zero-copy per-field memmap views into a packed table payload."""
    cols: Dict[str, np.ndarray] = {}
    for f in meta["fields"]:
        dtype = np.dtype(f["dtype"])
        shape = tuple(f["shape"])
        if int(np.prod(shape)) == 0:
            # zero-row fields pack to zero bytes; mmap cannot map an empty
            # range, so materialize the empty array directly
            cols[f["name"]] = np.zeros(shape, dtype=dtype)
            continue
        mm = np.memmap(bin_path, dtype=dtype, mode=mode, offset=f["offset"],
                       shape=shape)
        cols[f["name"]] = mm
    schema = _schema_by_name(meta.get("schema_name"))
    return Table(cols, schema=schema, validate=False)


def _reconstruct_from_bytes(raw: bytes, meta: Dict[str, Any]) -> Any:
    fmt = meta.get("format", "structured")
    if fmt == "table":
        cols = {}
        for f in meta["fields"]:
            dtype = np.dtype(f["dtype"])
            shape = tuple(f["shape"])
            arr = np.frombuffer(
                raw, dtype=dtype, count=int(np.prod(shape)) if shape else -1,
                offset=f["offset"],
            ).reshape(shape)
            cols[f["name"]] = arr
        return Table(cols, schema=_schema_by_name(meta.get("schema_name")), validate=False)
    if fmt == "structured":
        dtype = _dtype_from_descr(meta["dtype_descr"])
        return np.frombuffer(raw, dtype=dtype).copy()
    dtype = np.dtype(meta["dtype_descr"])
    arr = np.frombuffer(raw, dtype=dtype)
    shape = meta.get("shape")
    return arr.reshape(shape) if shape else arr


def _dtype_from_descr(descr: Any) -> np.dtype:
    if isinstance(descr, str):
        return np.dtype(descr)
    out = []
    for item in descr:
        if isinstance(item, (list, tuple)):
            if len(item) == 3:
                out.append((item[0], item[1], tuple(item[2])))
            else:
                out.append(tuple(item))
        else:
            out.append(item)
    return np.dtype(out)


def _jsonable_descr(table: Table) -> list:
    try:
        return [list(x) if isinstance(x, tuple) else x
                for x in table.to_numpy().dtype.descr]
    except Exception:
        return []


def _schema_by_name(name: Optional[str]):
    if not name:
        return None
    from waveformanalysis_tpu_torch.dtypes import schema as S

    known = {
        "st_waveforms": S.ST_WAVEFORM_SCHEMA,
        "records": S.RECORDS_SCHEMA,
        "basic_features": S.BASIC_FEATURES_SCHEMA,
        "peaks": S.PEAK_SCHEMA,
    }
    if name == "filtered_waveforms":
        from waveformanalysis_tpu_torch.plugins.builtin.filtering import (
            FILTERED_WAVEFORM_SCHEMA,
        )

        return FILTERED_WAVEFORM_SCHEMA
    return known.get(name)
