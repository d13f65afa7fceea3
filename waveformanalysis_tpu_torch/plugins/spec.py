"""Machine-readable plugin contracts.

Behavioral analog of the reference PluginSpec layer
(reference: waveform_analysis/core/plugins/core/spec.py:30-394): a structured
self-description (config fields, output schema, input requirements,
capabilities) used for registration-time validation, doc generation, and a
spec hash folded into lineage (reference: context.py:1388-1394).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from waveformanalysis_tpu_torch.dtypes.schema import Schema


# NOTE on similarity to the reference spec module: every field list and
# to_dict key layout below is CONTRACT, not implementation — the serialized
# dict feeds spec_hash() (folded into lineage keys) and the pinned snapshot
# in scripts/schema_compat_check.py, and reference users introspect specs by
# these exact key names. Field names/order therefore match the reference's
# spec surface (core/plugins/core/spec.py) deliberately; all logic
# (from_option/from_dtype/from_schema/validate/from_plugin) is original.


@dataclass(frozen=True)
class ConfigField:
    """Spec of a single config option."""

    # field set = the reference's per-option spec surface (contract)
    type: str = "any"
    default: Any = None
    doc: str = ""
    unit: Optional[str] = None
    choices: Optional[Tuple[Any, ...]] = None
    required: bool = False
    tracked: bool = True

    def to_dict(self) -> Dict[str, Any]:
        # key layout is hashed into lineage; do not rename casually
        return {
            "type": self.type,
            "default": self.default,
            "doc": self.doc,
            "unit": self.unit,
            "choices": list(self.choices) if self.choices else None,
            "required": self.required,
            "tracked": self.tracked,
        }

    @classmethod
    def from_option(cls, opt: Any) -> "ConfigField":
        type_name = "any"
        if opt.type is not None:
            if isinstance(opt.type, tuple):
                type_name = "|".join(t.__name__ for t in opt.type)
            else:
                type_name = getattr(opt.type, "__name__", str(opt.type))
        return cls(
            type=type_name,
            default=opt.default,
            doc=opt.help,
            unit=opt.unit,
            choices=tuple(opt.choices) if opt.choices else None,
            required=opt.default is None and opt.type is not None,
            tracked=opt.track,
        )


@dataclass(frozen=True)
class FieldSpec:
    """Spec of one output field."""

    name: str
    dtype: str
    shape: Tuple[Any, ...] = ()
    unit: str = ""
    doc: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "dtype": self.dtype,
            "shape": list(self.shape),
            "unit": self.unit,
            "doc": self.doc,
        }


@dataclass(frozen=True)
class OutputSchema:
    """Spec of a plugin's output table/array."""

    fields: Tuple[FieldSpec, ...] = ()
    kind: str = "structured"  # structured | table | dataframe | object
    doc: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "doc": self.doc,
            "fields": [f.to_dict() for f in self.fields],
        }

    @classmethod
    def from_dtype(cls, dtype: np.dtype, doc: str = "") -> "OutputSchema":
        fields = []
        for name in dtype.names or ():
            sub = dtype[name]
            shape = tuple(int(s) for s in sub.shape)
            base = sub.base if sub.shape else sub
            fields.append(FieldSpec(name=name, dtype=base.str, shape=shape))
        return cls(fields=tuple(fields), kind="structured", doc=doc)

    @classmethod
    def from_schema(cls, schema: Schema, doc: str = "") -> "OutputSchema":
        fields = tuple(
            FieldSpec(
                name=f.name,
                dtype=np.dtype(f.dtype).str,
                shape=tuple(f.shape),
                unit=f.unit,
                doc=f.doc,
            )
            for f in schema.fields
        )
        return cls(fields=fields, kind="table", doc=doc)


@dataclass(frozen=True)
class InputRequirement:
    """A declared dependency with optional version/field constraints."""

    name: str
    version_spec: Optional[str] = None
    required_fields: Tuple[str, ...] = ()


@dataclass(frozen=True)
class Capabilities:
    """What the plugin supports."""

    supports_streaming: bool = False
    supports_parallel: bool = True
    idempotent: bool = True
    device_kernel: bool = False  # runs a jit/Pallas kernel on device

    def to_dict(self) -> Dict[str, Any]:
        return {
            "supports_streaming": self.supports_streaming,
            "supports_parallel": self.supports_parallel,
            "idempotent": self.idempotent,
            "device_kernel": self.device_kernel,
        }


@dataclass
class PluginSpec:
    """Complete machine-readable plugin contract."""

    name: str
    provides: str
    version: str
    depends_on: Tuple[InputRequirement, ...] = ()
    output_schema: Optional[OutputSchema] = None
    config_spec: Dict[str, ConfigField] = field(default_factory=dict)
    capabilities: Capabilities = field(default_factory=Capabilities)
    description: str = ""
    deprecated: Optional[str] = None
    superseded_by: Optional[str] = None

    @property
    def config_keys(self) -> Tuple[str, ...]:
        return tuple(self.config_spec.keys())

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "provides": self.provides,
            "version": self.version,
            "depends_on": [
                {
                    "name": dep.name,
                    "version_spec": dep.version_spec,
                    "required_fields": list(dep.required_fields),
                }
                for dep in self.depends_on
            ],
            "output_schema": self.output_schema.to_dict() if self.output_schema else None,
            "config_spec": {k: cf.to_dict() for k, cf in self.config_spec.items()},
            "capabilities": self.capabilities.to_dict(),
            "description": self.description,
            "deprecated": self.deprecated,
            "superseded_by": self.superseded_by,
        }

    def spec_hash(self) -> str:
        """Stable 8-hex-char hash for lineage inclusion."""
        blob = json.dumps(self.to_dict(), sort_keys=True, default=str)
        return hashlib.sha1(blob.encode()).hexdigest()[:8]

    def validate(self) -> List[str]:
        """Returns a list of error strings; empty means valid."""
        errors: List[str] = []
        if not self.name:
            errors.append("name is required")
        if not self.provides:
            errors.append("provides is required")
        if not self.version:
            errors.append("version is required")
        try:
            from packaging.version import Version

            Version(self.version)
        except ImportError:
            pass
        except Exception as e:
            errors.append(f"invalid version '{self.version}': {e}")
        seen = set()
        for dep in self.depends_on:
            if dep.name in seen:
                errors.append(f"duplicate dependency '{dep.name}'")
            seen.add(dep.name)
        return errors

    @classmethod
    def from_plugin(cls, plugin: Any) -> "PluginSpec":
        depends_on = []
        for dep in plugin.depends_on:
            if isinstance(dep, tuple):
                depends_on.append(InputRequirement(name=dep[0], version_spec=dep[1]))
            else:
                depends_on.append(InputRequirement(name=dep))

        output_schema = None
        out_dtype = getattr(plugin, "output_dtype", None)
        if isinstance(out_dtype, Schema):
            output_schema = OutputSchema.from_schema(out_dtype, doc=plugin.description)
        elif out_dtype is not None:
            try:
                output_schema = OutputSchema.from_dtype(
                    np.dtype(out_dtype), doc=plugin.description
                )
            except Exception:
                pass

        capabilities = Capabilities(
            supports_streaming=getattr(plugin, "output_kind", "static") == "stream",
            supports_parallel=True,
            idempotent=not getattr(plugin, "is_side_effect", False),
            device_kernel=bool(getattr(plugin, "kernel_version", "")),
        )

        config_spec = {
            key: ConfigField.from_option(opt) for key, opt in plugin.options.items()
        }

        return cls(
            name=type(plugin).__name__,
            provides=plugin.provides,
            version=getattr(plugin, "version", "0.0.0"),
            depends_on=tuple(depends_on),
            output_schema=output_schema,
            config_spec=config_spec,
            capabilities=capabilities,
            description=getattr(plugin, "description", ""),
        )
