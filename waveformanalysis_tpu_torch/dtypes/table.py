"""Table: struct-of-arrays replacing NumPy structured arrays.

Port of ``waveformanalysis_tpu/dtypes/table.py``. The data model is a
``Table``: an ordered dict of equal-length columns, NumPy arrays on the host
and ``torch.Tensor``s on a device. Field access (``tbl["wave"]``), ``len``,
boolean-mask selection and ``.dtype.names`` mirror structured-array
ergonomics so reference-style user code ports naturally.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import to_numpy as _host
from waveformanalysis_tpu_torch.dtypes.schema import (
    Field,
    Schema,
    decode_polarity,
    encode_polarity,
)

ArrayLike = Any

_ENUM_CODECS = {
    "polarity": (encode_polarity, decode_polarity),
}


class Table:
    """An ordered mapping of field name -> equal-length column array.

    Columns may be NumPy arrays or torch tensors (mixed is allowed; ops
    move data as needed). The optional ``schema`` provides dtype/enums for host interop.
    """

    __slots__ = ("_columns", "schema")

    def __init__(
        self,
        columns: Mapping[str, ArrayLike],
        schema: Optional[Schema] = None,
        validate: bool = True,
    ) -> None:
        self._columns: Dict[str, ArrayLike] = dict(columns)
        self.schema = schema
        if validate and self._columns:
            lengths = {k: _leading_dim(v) for k, v in self._columns.items()}
            uniq = set(lengths.values())
            if len(uniq) > 1:
                raise ValueError(f"Table columns have unequal lengths: {lengths}")

    # -- basic mapping / array protocol ------------------------------------

    def __len__(self) -> int:
        if not self._columns:
            return 0
        return _leading_dim(next(iter(self._columns.values())))

    @property
    def columns(self) -> Dict[str, ArrayLike]:
        return self._columns

    @property
    def field_names(self) -> Tuple[str, ...]:
        return tuple(self._columns.keys())

    class _DtypeShim:
        """Duck-types ``.dtype.names`` for structured-array-style checks."""

        __slots__ = ("names",)

        def __init__(self, names: Tuple[str, ...]) -> None:
            self.names = names

    @property
    def dtype(self) -> "Table._DtypeShim":
        return Table._DtypeShim(self.field_names)

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def __getitem__(self, key: Union[str, slice, ArrayLike]) -> Any:
        if isinstance(key, str):
            return self._columns[key]
        # row selection: slice, int array, bool mask
        return Table(
            {k: v[key] for k, v in self._columns.items()},
            schema=self.schema,
            validate=False,
        )

    def __setitem__(self, key: str, value: ArrayLike) -> None:
        if self._columns and _leading_dim(value) != len(self):
            raise ValueError(
                f"Column '{key}' length {_leading_dim(value)} != table length {len(self)}"
            )
        self._columns[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        return self._columns.get(key, default)

    def row(self, i: int) -> Dict[str, Any]:
        """Materialize one row as a host dict (debug/inspection use)."""
        return {k: _host(v[i]) for k, v in self._columns.items()}

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        cols = ", ".join(
            f"{k}:{getattr(v, 'dtype', '?')}{list(getattr(v, 'shape', []))}"
            for k, v in self._columns.items()
        )
        return f"Table(len={len(self)}, {cols})"

    # -- transforms ---------------------------------------------------------

    def select(self, mask_or_idx: ArrayLike) -> "Table":
        return self[mask_or_idx]

    def with_columns(self, **cols: ArrayLike) -> "Table":
        merged = dict(self._columns)
        merged.update(cols)
        return Table(merged, schema=self.schema)

    def drop(self, *names: str) -> "Table":
        return Table(
            {k: v for k, v in self._columns.items() if k not in names},
            schema=self.schema,
            validate=False,
        )

    def to_device(self, device: Union[str, torch.device]) -> "Table":
        """All columns as tensors on ``device``.

        Enum-coded fields must already be numeric (use from_numpy for decode).
        """
        out = {}
        for k, v in self._columns.items():
            if isinstance(v, torch.Tensor):
                out[k] = v.to(device)
                continue
            arr = np.asarray(v)
            if arr.dtype.kind in ("U", "S", "O"):
                f = self.schema.field(k) if (self.schema and k in self.schema) else None
                if f is not None and f.enum:
                    enc, _ = _ENUM_CODECS[f.enum]
                    arr = enc(arr)
                else:
                    raise TypeError(
                        f"Column '{k}' has non-numeric dtype {arr.dtype} and no enum codec"
                    )
            out[k] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
        return Table(out, schema=self.schema, validate=False)

    def to_host(self) -> "Table":
        """Pull all columns to host NumPy (keeps enum fields numeric)."""
        return Table(
            {k: _host(v) for k, v in self._columns.items()},
            schema=self.schema,
            validate=False,
        )

    def sort_by(self, *keys: str, stable: bool = True) -> "Table":
        """Sort rows by the given keys (last key is the primary, lexsort-style
        is NOT used here: first listed key is primary)."""
        host = self.to_host()
        # np.lexsort uses last key as primary, so reverse
        sort_cols = [np.asarray(host[k]) for k in reversed(keys)]
        order = np.lexsort(sort_cols)
        return self[order]

    # -- NumPy structured-array interop -------------------------------------

    def to_numpy(self, schema: Optional[Schema] = None) -> np.ndarray:
        """Convert to a NumPy structured array (reference representation)."""
        schema = schema or self.schema
        host = self.to_host()
        n = len(host)
        if schema is not None:
            dims = _infer_dims(schema, host)
            dtype = schema.numpy_dtype(**dims)
            out = np.zeros(n, dtype=dtype)
            for f in schema.fields:
                if f.name not in host:
                    continue
                col = np.asarray(host[f.name])
                if f.enum and col.dtype.kind not in ("U", "S"):
                    _, dec = _ENUM_CODECS[f.enum]
                    col = dec(col)
                out[f.name] = col
            return out
        descr = []
        for k, v in host.columns.items():
            v = np.asarray(v)
            if v.ndim > 1:
                descr.append((k, v.dtype.str, v.shape[1:]))
            else:
                descr.append((k, v.dtype.str))
        out = np.zeros(n, dtype=np.dtype(descr))
        for k, v in host.columns.items():
            out[k] = np.asarray(v)
        return out

    @classmethod
    def from_numpy(
        cls, arr: np.ndarray, schema: Optional[Schema] = None
    ) -> "Table":
        """Build a Table from a NumPy structured array.

        Enum-coded fields (polarity) are converted to their device integer
        representation immediately so the Table is always jit-compatible.
        """
        if arr.dtype.names is None:
            raise TypeError("from_numpy expects a structured array")
        cols: Dict[str, np.ndarray] = {}
        for name in arr.dtype.names:
            col = np.ascontiguousarray(arr[name])
            f = schema.field(name) if (schema and name in schema) else None
            if col.dtype.kind in ("U", "S", "O"):
                if f is not None and f.enum:
                    enc, _ = _ENUM_CODECS[f.enum]
                    col = enc(col)
                elif name == "polarity":
                    col = encode_polarity(col)
            cols[name] = col
        return cls(cols, schema=schema)

    @classmethod
    def zeros(
        cls, n: int, schema: Schema,
        device: Optional[Union[str, torch.device]] = None, **dims: int
    ) -> "Table":
        """Zero rows; tensors on ``device`` when given, else NumPy."""
        cols: Dict[str, ArrayLike] = {}
        for f in schema.fields:
            shape = (n,) + f.resolve_shape(dims)
            if device is not None:
                cols[f.name] = torch.from_numpy(
                    np.zeros(shape, dtype=f.dev_dtype)
                ).to(device)
            else:
                if f.enum:
                    cols[f.name] = np.zeros(shape, dtype=f.dev_dtype)
                else:
                    cols[f.name] = np.zeros(shape, dtype=f.host_dtype)
        return cls(cols, schema=schema, validate=False)

    @staticmethod
    def concatenate(tables: Sequence["Table"]) -> "Table":
        tables = [t for t in tables if len(t) > 0] or list(tables)
        if not tables:
            return Table({})
        names = tables[0].field_names
        for t in tables[1:]:
            if t.field_names != names:
                raise ValueError("Cannot concatenate tables with differing fields")
        # column by column: a tensor column of the first table stays a
        # tensor on its device, a host column stays a host array
        cols = {}
        for k in names:
            first = tables[0][k]
            if isinstance(first, torch.Tensor):
                cols[k] = torch.cat(
                    [torch.as_tensor(t[k]).to(first.device) for t in tables], dim=0
                )
            else:
                cols[k] = np.concatenate([_host(t[k]) for t in tables], axis=0)
        return Table(cols, schema=tables[0].schema, validate=False)


def _leading_dim(v: ArrayLike) -> int:
    shape = getattr(v, "shape", None)
    if shape is None or len(shape) == 0:
        raise TypeError(f"Table columns must be arrays, got {type(v)}")
    return int(shape[0])


def _infer_dims(schema: Schema, table: Table) -> Dict[str, int]:
    """Resolve named trailing dims (e.g. wave_length) from actual columns."""
    dims: Dict[str, int] = {}
    for f in schema.fields:
        if not f.shape or f.name not in table:
            continue
        col_shape = tuple(table[f.name].shape[1:])
        for spec, actual in zip(f.shape, col_shape):
            if isinstance(spec, str):
                dims[spec] = int(actual)
    return dims
