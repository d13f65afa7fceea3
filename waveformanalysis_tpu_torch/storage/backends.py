"""Storage backend protocol and the SQLite alternative backend.

Behavioral analog of the reference backend layer
(reference: waveform_analysis/core/storage/backends.py:31,165): any object
implementing the protocol methods can serve as a Context storage backend
(validated at registration, reference: context.py:979-1007); SQLiteBackend
stores payload blobs + metadata rows in a single database file.
"""

from __future__ import annotations

import json
import sqlite3
import threading
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, List, Optional, Protocol, Union, runtime_checkable

import numpy as np

from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.storage.memmap import (
    BufferedStreamWriter,
    STORAGE_VERSION,
    _dtype_from_descr,
    _pack_table,
    _reconstruct_from_bytes,
    _jsonable_descr,
)

REQUIRED_BACKEND_METHODS = (
    "exists",
    "save_memmap",
    "load_memmap",
    "save_metadata",
    "get_metadata",
    "delete",
    "list_keys",
    "get_size",
    "save_stream",
    "finalize_save",
)


@runtime_checkable
class StorageBackend(Protocol):
    """Protocol every storage backend must satisfy."""

    def exists(self, key: str, run_id: Optional[str] = None) -> bool: ...

    def save_memmap(self, key: str, data: Any, run_id: Optional[str] = None,
                    lineage: Optional[dict] = None, **kwargs: Any) -> Dict[str, Any]: ...

    def load_memmap(self, key: str, run_id: Optional[str] = None) -> Any: ...

    def save_metadata(self, key: str, metadata: Dict[str, Any],
                      run_id: Optional[str] = None) -> None: ...

    def get_metadata(self, key: str, run_id: Optional[str] = None) -> Optional[Dict[str, Any]]: ...

    def delete(self, key: str, run_id: Optional[str] = None) -> None: ...

    def list_keys(self, run_id: Optional[str] = None, prefix: str = "") -> List[str]: ...

    def get_size(self, key: str, run_id: Optional[str] = None) -> int: ...

    def save_stream(self, key: str, run_id: Optional[str] = None) -> Any: ...

    def finalize_save(self, key: str, writer: Any, run_id: Optional[str] = None,
                      lineage: Optional[dict] = None, **kwargs: Any) -> Dict[str, Any]: ...


def validate_backend(backend: Any) -> List[str]:
    """Return the list of missing protocol methods (empty = valid)."""
    return [m for m in REQUIRED_BACKEND_METHODS if not callable(getattr(backend, m, None))]


class SQLiteBackend:
    """Single-file storage backend: payload blobs + metadata in SQLite."""

    def __init__(self, db_path: Union[str, Path]) -> None:
        self.db_path = str(db_path)
        Path(self.db_path).parent.mkdir(parents=True, exist_ok=True)
        self._local = threading.local()
        with self._conn() as conn:
            conn.execute(
                """CREATE TABLE IF NOT EXISTS cache (
                    run_id TEXT NOT NULL DEFAULT '',
                    key TEXT NOT NULL,
                    payload BLOB,
                    metadata TEXT,
                    nbytes INTEGER,
                    PRIMARY KEY (run_id, key)
                )"""
            )

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.db_path)
            conn.isolation_level = None  # autocommit
            self._local.conn = conn
        return conn

    # -- protocol ------------------------------------------------------------

    def exists(self, key: str, run_id: Optional[str] = None) -> bool:
        cur = self._conn().execute(
            "SELECT 1 FROM cache WHERE run_id=? AND key=?", (run_id or "", key)
        )
        return cur.fetchone() is not None

    def save_memmap(
        self,
        key: str,
        data: Any,
        run_id: Optional[str] = None,
        lineage: Optional[dict] = None,
        **kwargs: Any,
    ) -> Dict[str, Any]:
        meta: Dict[str, Any] = {
            "storage_version": STORAGE_VERSION,
            "created_at": datetime.now(timezone.utc).isoformat(),
            "key": key,
            "run_id": run_id,
            "compression": "none",
        }
        if lineage is not None:
            meta["lineage"] = lineage
        if isinstance(data, Table):
            payload, fields_meta = _pack_table(data)
            meta.update(format="table", n_rows=len(data), fields=fields_meta)
            if data.schema is not None:
                meta["schema_name"] = data.schema.name
                meta["dtype_descr"] = _jsonable_descr(data)
        else:
            arr = np.ascontiguousarray(np.asarray(data))
            payload = arr.tobytes()
            if arr.dtype.names:
                meta.update(format="structured", n_rows=int(arr.shape[0]),
                            dtype_descr=arr.dtype.descr)
            else:
                meta.update(format="array", n_rows=int(arr.shape[0]) if arr.ndim else 0,
                            dtype_descr=str(arr.dtype), shape=list(arr.shape))
        meta["nbytes"] = len(payload)
        self._conn().execute(
            "INSERT OR REPLACE INTO cache (run_id, key, payload, metadata, nbytes) "
            "VALUES (?,?,?,?,?)",
            (run_id or "", key, payload, json.dumps(meta, default=str), len(payload)),
        )
        return meta

    def load_memmap(self, key: str, run_id: Optional[str] = None) -> Any:
        cur = self._conn().execute(
            "SELECT payload, metadata FROM cache WHERE run_id=? AND key=?",
            (run_id or "", key),
        )
        row = cur.fetchone()
        if row is None or row[0] is None:
            return None
        meta = json.loads(row[1]) if row[1] else {}
        return _reconstruct_from_bytes(bytes(row[0]), meta)

    def save_metadata(self, key: str, metadata: Dict[str, Any], run_id: Optional[str] = None) -> None:
        self._conn().execute(
            "INSERT INTO cache (run_id, key, metadata) VALUES (?,?,?) "
            "ON CONFLICT(run_id, key) DO UPDATE SET metadata=excluded.metadata",
            (run_id or "", key, json.dumps(metadata, default=str)),
        )

    def get_metadata(self, key: str, run_id: Optional[str] = None) -> Optional[Dict[str, Any]]:
        cur = self._conn().execute(
            "SELECT metadata FROM cache WHERE run_id=? AND key=?", (run_id or "", key)
        )
        row = cur.fetchone()
        if row is None or row[0] is None:
            return None
        return json.loads(row[0])

    def delete(self, key: str, run_id: Optional[str] = None) -> None:
        self._conn().execute(
            "DELETE FROM cache WHERE run_id=? AND key=?", (run_id or "", key)
        )

    def list_keys(self, run_id: Optional[str] = None, prefix: str = "") -> List[str]:
        cur = self._conn().execute(
            "SELECT key FROM cache WHERE run_id=? AND key LIKE ? ORDER BY key",
            (run_id or "", prefix + "%"),
        )
        return [r[0] for r in cur.fetchall()]

    def get_size(self, key: str, run_id: Optional[str] = None) -> int:
        cur = self._conn().execute(
            "SELECT nbytes FROM cache WHERE run_id=? AND key=?", (run_id or "", key)
        )
        row = cur.fetchone()
        return int(row[0]) if row and row[0] else 0

    # -- streaming: buffer in a temp file, then insert as one blob -----------

    def save_stream(self, key: str, run_id: Optional[str] = None) -> BufferedStreamWriter:
        import tempfile

        tmp = Path(tempfile.mkstemp(suffix=".stream.tmp")[1])
        return BufferedStreamWriter(tmp)

    def finalize_save(
        self,
        key: str,
        writer: BufferedStreamWriter,
        run_id: Optional[str] = None,
        lineage: Optional[dict] = None,
        **kwargs: Any,
    ) -> Dict[str, Any]:
        writer.close()
        payload = writer.tmp_path.read_bytes()
        writer.tmp_path.unlink(missing_ok=True)
        meta = {
            "storage_version": STORAGE_VERSION,
            "created_at": datetime.now(timezone.utc).isoformat(),
            "key": key,
            "run_id": run_id,
            "format": "structured",
            "n_rows": writer.n_rows,
            "dtype_descr": writer.dtype.descr if writer.dtype is not None else [],
            "compression": "none",
            "nbytes": len(payload),
            "streamed": True,
        }
        if lineage is not None:
            meta["lineage"] = lineage
        self._conn().execute(
            "INSERT OR REPLACE INTO cache (run_id, key, payload, metadata, nbytes) "
            "VALUES (?,?,?,?,?)",
            (run_id or "", key, payload, json.dumps(meta, default=str), len(payload)),
        )
        return meta
