"""strax interoperability adapters.

Behavioral analog of the reference strax compat layer
(reference: waveform_analysis/core/plugins/core/adapters.py:29-440): wrap
strax-style plugin classes as native plugins (``wrap_strax_plugin``), expose a
strax-like context façade (``get_array`` / ``get_df`` / ``search_field``),
and convert option/dtype declarations both ways. strax itself is optional —
the adapters duck-type against its plugin attribute conventions.

Port of ``waveformanalysis_tpu/plugins/adapters.py``. What the adapters hand
to strax-style code is host NumPy: a Table's device columns are fetched
(``Table.to_numpy``), and a bare tensor through ``device.to_host``.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List

import numpy as np

from waveformanalysis_tpu_torch.device import to_host
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.plugins.base import Option, Plugin

logger = logging.getLogger(__name__)


def convert_strax_options(strax_plugin_cls: Any) -> Dict[str, Option]:
    """strax takes_config -> native Options (reference: adapters.py:204)."""
    options: Dict[str, Option] = {}
    takes_config = getattr(strax_plugin_cls, "takes_config", None)
    if not takes_config:
        return options
    items = takes_config.items() if isinstance(takes_config, dict) else (
        (getattr(o, "name", f"opt{i}"), o) for i, o in enumerate(takes_config)
    )
    for name, strax_opt in items:
        options[name] = Option(
            default=getattr(strax_opt, "default", None),
            type=getattr(strax_opt, "type", None)
            if isinstance(getattr(strax_opt, "type", None), type) else None,
            help=getattr(strax_opt, "help", ""),
            track=getattr(strax_opt, "track", True),
        )
    return options


def convert_dtype_to_strax(dtype_like: Any) -> List[tuple]:
    """Native dtype/schema -> strax-style ((title, name), type) tuples
    (reference: adapters.py:231)."""
    from waveformanalysis_tpu_torch.dtypes.schema import Schema

    if isinstance(dtype_like, Schema):
        return [
            ((f.doc or f.name, f.name), f.dtype) if not f.shape
            else ((f.doc or f.name, f.name), f.dtype, tuple(f.shape))
            for f in dtype_like.fields
        ]
    dt = np.dtype(dtype_like)
    out = []
    for name in dt.names or ():
        sub = dt[name]
        if sub.shape:
            out.append(((name, name), sub.base.str, sub.shape))
        else:
            out.append(((name, name), sub.str))
    return out


def convert_dtype_from_strax(descr: Any) -> np.dtype:
    """strax ((title, name), type[, shape]) tuples -> numpy dtype."""
    fields = []
    for item in descr:
        head = item[0]
        name = head[1] if isinstance(head, tuple) else head
        if len(item) == 3:
            fields.append((name, item[1], item[2]))
        else:
            fields.append((name, item[1]))
    return np.dtype(fields)


class StraxPluginAdapter(Plugin):
    """Wraps one strax-style plugin instance as a native Plugin
    (reference: adapters.py:29)."""

    def __init__(self, strax_plugin: Any) -> None:
        self._strax = strax_plugin
        self.provides = _first(getattr(strax_plugin, "provides", ""))
        self.depends_on = [
            d for d in _as_list(getattr(strax_plugin, "depends_on", ()))
        ]
        self.version = str(
            getattr(strax_plugin, "__version__", None)
            or getattr(strax_plugin, "version", "0.0.0")
        )
        self.description = (getattr(strax_plugin, "__doc__", "") or "").strip()
        self.save_when = _convert_save_when(getattr(strax_plugin, "save_when", None))
        dtype = getattr(strax_plugin, "dtype", None)
        if dtype is not None:
            try:
                self.output_dtype = (
                    np.dtype(dtype) if not isinstance(dtype, np.dtype) else dtype
                )
            except (TypeError, ValueError):
                try:
                    self.output_dtype = convert_dtype_from_strax(dtype)
                except Exception:
                    self.output_dtype = None
        # per-instance options: each wrapped strax plugin has its own set
        self.options = convert_strax_options(type(strax_plugin))

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> Any:
        inputs = {}
        for dep in self.depends_on:
            name = self.get_dependency_name(dep)
            data = context.get_data(run_id, name)
            inputs[name] = data.to_numpy() if isinstance(data, Table) else to_host(data)
        # strax compute signatures vary: try kwargs-by-name, then positional
        compute = self._strax.compute
        try:
            return compute(**inputs)
        except TypeError:
            return compute(*inputs.values())

    def __repr__(self) -> str:  # pragma: no cover
        return f"StraxPluginAdapter({type(self._strax).__name__} -> {self.provides})"


def wrap_strax_plugin(strax_plugin_or_cls: Any) -> StraxPluginAdapter:
    """Entry point (reference: adapters.py:402)."""
    plugin = (
        strax_plugin_or_cls() if isinstance(strax_plugin_or_cls, type)
        else strax_plugin_or_cls
    )
    return StraxPluginAdapter(plugin)


class StraxContextAdapter:
    """strax-like façade over a Context (reference: adapters.py:251)."""

    def __init__(self, context: Any) -> None:
        self.ctx = context

    def get_array(self, run_id: str, data_name: str, **kwargs: Any) -> np.ndarray:
        data = self.ctx.get_data(run_id, data_name, **kwargs)
        if isinstance(data, Table):
            return data.to_numpy()
        return np.asarray(to_host(data))

    def get_df(self, run_id: str, data_name: str, **kwargs: Any):
        import pandas as pd

        data = self.ctx.get_data(run_id, data_name, **kwargs)
        if isinstance(data, pd.DataFrame):
            return data
        arr = data.to_numpy() if isinstance(data, Table) else np.asarray(to_host(data))
        return pd.DataFrame({
            n: arr[n] for n in (arr.dtype.names or ())
            if arr.dtype[n].shape == ()
        })

    def search_field(self, pattern: str) -> Dict[str, List[str]]:
        """Data names whose schema fields contain the pattern."""
        hits: Dict[str, List[str]] = {}
        for name, plugin in self.ctx.plugins.items():
            spec = plugin._validated_spec
            if spec is None or spec.output_schema is None:
                continue
            matched = [
                f.name for f in spec.output_schema.fields if pattern in f.name
            ]
            if matched:
                hits[name] = matched
        return hits

    def key_for(self, run_id: str, data_name: str) -> str:
        return self.ctx.key_for(run_id, data_name)

    def register(self, *plugins: Any) -> None:
        native = [
            wrap_strax_plugin(p)
            if not isinstance(p, Plugin) and not (
                isinstance(p, type) and issubclass(p, Plugin)
            )
            else p
            for p in plugins
        ]
        self.ctx.register(*native)


def _first(value: Any) -> str:
    if isinstance(value, (list, tuple)):
        return value[0] if value else ""
    return value


def _as_list(value: Any) -> List[str]:
    if isinstance(value, str):
        return [value]
    return list(value)


def _convert_save_when(value: Any) -> str:
    if value is None:
        return "always"
    name = getattr(value, "name", str(value)).upper()
    if "NEVER" in name:
        return "never"
    if "TARGET" in name or "EXPLICIT" in name:
        return "target"
    return "always"
