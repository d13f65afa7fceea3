"""Data export to interchange formats.

Behavioral analog of the reference DataExporter
(reference: waveform_analysis/core/data/export.py:27,161): parquet / hdf5 /
csv / json / npy / npz single-item export plus batch_export over multiple
data names. Tables convert at the host boundary.

Port of ``waveformanalysis_tpu/data/export.py``.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np

from waveformanalysis_tpu_torch.dtypes.table import Table

logger = logging.getLogger(__name__)

SUPPORTED_FORMATS = ("parquet", "csv", "json", "npy", "npz", "hdf5")


class DataExporter:
    """Exports Context data items to files."""

    def __init__(self, context: Any) -> None:
        self.ctx = context

    def export(
        self,
        run_id: str,
        data_name: str,
        path: Union[str, Path],
        fmt: Optional[str] = None,
    ) -> Path:
        path = Path(path)
        fmt = (fmt or path.suffix.lstrip(".")).lower()
        if fmt not in SUPPORTED_FORMATS:
            raise ValueError(
                f"Unsupported export format {fmt!r}; use one of {SUPPORTED_FORMATS}"
            )
        data = self.ctx.get_data(run_id, data_name)
        path.parent.mkdir(parents=True, exist_ok=True)
        writer = getattr(self, f"_write_{fmt}")
        writer(data, path)
        logger.info("Exported %s/%s -> %s", run_id, data_name, path)
        return path

    def batch_export(
        self,
        run_id: str,
        data_names: Sequence[str],
        out_dir: Union[str, Path],
        fmt: str = "parquet",
    ) -> Dict[str, Path]:
        out_dir = Path(out_dir)
        out: Dict[str, Path] = {}
        for name in data_names:
            ext = "h5" if fmt == "hdf5" else fmt
            out[name] = self.export(run_id, name, out_dir / f"{name}.{ext}", fmt=fmt)
        return out

    # -- converters -----------------------------------------------------------

    @staticmethod
    def _to_dataframe(data: Any):
        import pandas as pd

        if isinstance(data, pd.DataFrame):
            return data
        if isinstance(data, Table):
            host = data.to_host()
            return pd.DataFrame({
                k: (list(np.asarray(v)) if np.asarray(v).ndim > 1 else np.asarray(v))
                for k, v in host.columns.items()
            })
        if isinstance(data, np.ndarray) and data.dtype.names:
            return pd.DataFrame({
                n: data[n] for n in data.dtype.names
                if data.dtype[n].shape == ()
            })
        if isinstance(data, np.ndarray):
            return pd.DataFrame({"value": data})
        raise TypeError(f"Cannot convert {type(data)} to a DataFrame")

    @staticmethod
    def _to_structured(data: Any) -> np.ndarray:
        if isinstance(data, Table):
            return data.to_numpy()
        if isinstance(data, np.ndarray):
            return data
        try:
            import pandas as pd

            if isinstance(data, pd.DataFrame):
                # ragged/object columns become object fields (npy/npz store
                # them pickled, matching the reference's np.save behavior)
                return data.to_records(index=False)
        except ImportError:  # pragma: no cover
            pass
        raise TypeError(f"Cannot convert {type(data)} to an array")

    # -- writers ---------------------------------------------------------------

    def _write_parquet(self, data: Any, path: Path) -> None:
        df = self._to_dataframe(data)
        try:
            df.to_parquet(path)
        except Exception:
            df2 = df.copy()
            for col in df2.columns:
                if df2[col].dtype == object:
                    df2[col] = df2[col].apply(
                        lambda x: json.dumps(np.asarray(x).tolist())
                        if hasattr(x, "__len__") and not isinstance(x, str) else x
                    )
            df2.to_parquet(path)

    def _write_csv(self, data: Any, path: Path) -> None:
        self._to_dataframe(data).to_csv(path, index=False)

    def _write_json(self, data: Any, path: Path) -> None:
        df = self._to_dataframe(data)
        df.to_json(path, orient="records", default_handler=str)

    def _write_npy(self, data: Any, path: Path) -> None:
        np.save(path, self._to_structured(data))

    def _write_npz(self, data: Any, path: Path) -> None:
        if isinstance(data, Table):
            np.savez_compressed(
                path, **{k: np.asarray(v) for k, v in data.to_host().columns.items()}
            )
        else:
            arr = self._to_structured(data)
            if arr.dtype.names:
                np.savez_compressed(path, **{n: arr[n] for n in arr.dtype.names})
            else:
                np.savez_compressed(path, data=arr)

    def _write_hdf5(self, data: Any, path: Path) -> None:
        try:
            import h5py  # type: ignore
        except ImportError:
            # pandas HDFStore fallback
            self._to_dataframe(data).to_hdf(path, key="data", mode="w")
            return
        def dataset_value(v: np.ndarray):
            # object columns (per-event ragged arrays from the event frames)
            # have no native HDF5 type — JSON-encode them like the parquet
            # writer's fallback does
            if v.dtype == object:
                return np.asarray([
                    json.dumps(np.asarray(x).tolist())
                    if hasattr(x, "__len__") and not isinstance(x, str)
                    else str(x)
                    for x in v
                ], dtype=h5py.string_dtype())
            return v

        with h5py.File(path, "w") as f:
            if isinstance(data, Table):
                for k, v in data.to_host().columns.items():
                    f.create_dataset(k, data=dataset_value(np.asarray(v)))
            else:
                arr = self._to_structured(data)
                if arr.dtype.names:
                    for n in arr.dtype.names:
                        f.create_dataset(n, data=dataset_value(arr[n]))
                else:
                    f.create_dataset("data", data=arr)
