"""Field schemas for structured waveform data.

XLA has no structured dtypes, so the reference's NumPy structured arrays
(reference: waveform_analysis/core/processing/dtypes.py:18,36,80) become
struct-of-arrays ``Table`` pytrees here — one device array per field. The
``Schema`` records field names, per-row shapes, NumPy dtypes and units so we
can round-trip to NumPy structured arrays at the host boundary (storage,
pandas export, parity tests) with identical field semantics.

String-valued fields (``polarity`` is U8 in the reference) are represented
on device as small integer enums; the schema carries the codec.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

DEFAULT_WAVE_LENGTH = 1500

# polarity enum codec: device int8 <-> reference U8 strings
POLARITY_CODES: Dict[str, int] = {"unknown": 0, "positive": 1, "negative": -1}
POLARITY_NAMES: Dict[int, str] = {v: k for k, v in POLARITY_CODES.items()}


def encode_polarity(values: Any) -> np.ndarray:
    """Map polarity strings (or already-encoded ints) to int8 codes.

    Vectorized: U/S arrays compare whole-array against the three known
    names (a python per-element loop costs ~50 ms at 32k rows); object
    arrays fall back to the per-element map.
    """
    arr = np.asarray(values)
    if arr.dtype.kind in ("U", "S"):
        names = arr.astype("U8") if arr.dtype.kind == "S" else arr
        out = np.zeros(arr.shape, dtype=np.int8)
        out[names == "positive"] = 1
        out[names == "negative"] = -1
        return out
    if arr.dtype.kind == "O":
        out = np.zeros(arr.shape, dtype=np.int8)
        flat = arr.ravel()
        out_flat = out.ravel()
        for i, v in enumerate(flat):
            s = v.decode() if isinstance(v, bytes) else str(v)
            out_flat[i] = POLARITY_CODES.get(s, 0)
        return out
    return arr.astype(np.int8)


def decode_polarity(codes: Any) -> np.ndarray:
    """Map int8 polarity codes back to U8 strings."""
    arr = np.asarray(codes).astype(np.int64)
    out = np.empty(arr.shape, dtype="U8")
    out[...] = "unknown"
    out[arr == 1] = "positive"
    out[arr == -1] = "negative"
    return out


@dataclass(frozen=True)
class Field:
    """One column of a Table.

    Attributes:
        name: field name (identical to the reference structured-dtype name).
        dtype: NumPy dtype string for the *host* representation ("f8", "i2",
            "U8", ...).
        shape: trailing per-row shape (e.g. ``("wave_length",)`` for waves) —
            entries may be ints or named dims resolved at instantiation.
        device_dtype: dtype used on device if different from ``dtype``
            (e.g. polarity U8 -> i1 enum).
        enum: optional name of the codec ("polarity") applied at host boundary.
        unit: physical unit for documentation ("ps", "ns", "ADC").
        doc: human-readable description.
    """

    name: str
    dtype: str
    shape: Tuple[Any, ...] = ()
    device_dtype: Optional[str] = None
    enum: Optional[str] = None
    unit: str = ""
    doc: str = ""

    def resolve_shape(self, dims: Mapping[str, int]) -> Tuple[int, ...]:
        out = []
        for s in self.shape:
            if isinstance(s, str):
                if s not in dims:
                    raise ValueError(f"Field '{self.name}': unresolved dim '{s}'")
                out.append(int(dims[s]))
            else:
                out.append(int(s))
        return tuple(out)

    @property
    def host_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)

    @property
    def dev_dtype(self) -> np.dtype:
        return np.dtype(self.device_dtype or self.dtype)


@dataclass(frozen=True)
class Schema:
    """An ordered collection of Fields, with NumPy structured-dtype interop."""

    name: str
    fields: Tuple[Field, ...]

    def __post_init__(self) -> None:
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"Schema {self.name}: duplicate field names")

    @property
    def field_names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in self.fields)

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(f"Schema {self.name} has no field '{name}'")

    def __contains__(self, name: str) -> bool:
        return any(f.name == name for f in self.fields)

    def numpy_dtype(self, **dims: int) -> np.dtype:
        """Build the equivalent NumPy structured dtype (host representation)."""
        descr = []
        for f in self.fields:
            shape = f.resolve_shape(dims) if f.shape else ()
            if shape:
                descr.append((f.name, f.dtype, shape))
            else:
                descr.append((f.name, f.dtype))
        return np.dtype(descr)

    def with_fields(self, *extra: Field, name: Optional[str] = None) -> "Schema":
        return Schema(name or self.name, self.fields + tuple(extra))

    def replace_field(
        self, fname: str, new: Field, name: Optional[str] = None
    ) -> "Schema":
        """Derived schema with one field replaced.

        Pass ``name`` when the derivative is a DIFFERENT data type: cache
        metadata stores ``schema.name`` and the loader re-attaches the
        registered schema of that name, so a derivative that silently keeps
        the parent's name gets the parent's field dtypes back on reload
        (the round-4 differential oracle caught filtered_waveforms' f4
        waves being floored to the st schema's int16 this way)."""
        return Schema(
            name or self.name,
            tuple(new if f.name == fname else f for f in self.fields),
        )

    def descr(self, **dims: int) -> list:
        """np.dtype(...).descr-style list, used in lineage/cache metadata."""
        return self.numpy_dtype(**dims).descr


# --------------------------------------------------------------------------
# Concrete schemas (field semantics match the reference dtypes exactly).
# --------------------------------------------------------------------------

# reference: waveform_analysis/core/processing/dtypes.py:18-64 (ST_WAVEFORM_DTYPE)
ST_WAVEFORM_SCHEMA = Schema(
    "st_waveforms",
    (
        Field("baseline", "f8", doc="baseline computed from the baseline window", unit="ADC"),
        Field("baseline_upstream", "f8", doc="optional upstream-provided baseline", unit="ADC"),
        Field("polarity", "U8", device_dtype="i1", enum="polarity",
              doc="hardware truth polarity: positive|negative|unknown"),
        Field("timestamp", "i8", unit="ps", doc="ADC raw timestamp"),
        Field("record_id", "i8", doc="sequential record id within the array"),
        Field("dt", "i4", unit="ns", doc="sample interval"),
        Field("event_length", "i4", doc="true number of samples in this event"),
        Field("board", "i2", doc="board index"),
        Field("channel", "i2", doc="physical channel number"),
        Field("wave", "i2", shape=("wave_length",), unit="ADC", doc="raw ADC samples"),
    ),
)

# reference: waveform_analysis/core/processing/dtypes.py:80-100 (RECORDS_DTYPE)
RECORDS_SCHEMA = Schema(
    "records",
    (
        Field("timestamp", "i8", unit="ps", doc="ADC timestamp"),
        Field("pid", "i4", doc="partition id (sort tie-breaker)"),
        Field("board", "i2"),
        Field("channel", "i2"),
        Field("baseline", "f8", unit="ADC"),
        Field("baseline_upstream", "f8", unit="ADC"),
        Field("polarity", "U8", device_dtype="i1", enum="polarity"),
        Field("record_id", "i8", doc="sequential record id after global sort"),
        Field("dt", "i4", unit="ns"),
        Field("trigger_type", "i2"),
        Field("flags", "u4"),
        Field("wave_offset", "i8", doc="start index into the wave_pool"),
        Field("event_length", "i4", doc="number of samples in the wave_pool slice"),
        Field("time", "i8", unit="ns", doc="system time"),
    ),
)

EVENTS_SCHEMA = RECORDS_SCHEMA

# reference: waveform_analysis/core/plugins/builtin/cpu/basic_features.py:29-40
BASIC_FEATURES_SCHEMA = Schema(
    "basic_features",
    (
        Field("height", "f4", doc="baseline deviation amplitude over height_range"),
        Field("amp", "f4", doc="peak-to-peak amplitude (max - min)"),
        Field("area", "f4", doc="integral of (baseline - wave) over area_range"),
        Field("max_abs_diff", "f4", doc="max |diff(wave)|"),
        Field("timestamp", "i8", unit="ps"),
        Field("board", "i2"),
        Field("channel", "i2"),
        Field("event_index", "i8"),
    ),
)

# reference: waveform_analysis/core/processing/dtypes.py:68-78 (PEAK_DTYPE)
PEAK_SCHEMA = Schema(
    "peaks",
    (
        Field("time", "i8"),
        Field("area", "f4"),
        Field("height", "f4"),
        Field("width", "f4"),
        Field("channel", "i2"),
        Field("event_index", "i8"),
    ),
)


def create_record_dtype(wave_length: int) -> np.dtype:
    """NumPy structured dtype for st_waveforms with a given wave length.

    (reference analog: waveform_analysis/core/processing/dtypes.py:36)
    """
    return ST_WAVEFORM_SCHEMA.numpy_dtype(wave_length=wave_length)


ST_WAVEFORM_DTYPE = create_record_dtype(DEFAULT_WAVE_LENGTH)
RECORDS_DTYPE = RECORDS_SCHEMA.numpy_dtype()
EVENTS_DTYPE = RECORDS_DTYPE
BASIC_FEATURES_DTYPE = BASIC_FEATURES_SCHEMA.numpy_dtype()
PEAK_DTYPE = PEAK_SCHEMA.numpy_dtype()
