"""hit_merge_clusters / hit_merged / hit_merged_components plugins.

Behavioral analog of the reference hit-merge plugin family
(reference: waveform_analysis/core/plugins/builtin/cpu/hit_merge.py:
325,413,445): same-hardware-channel time clustering of hit_threshold by
merge_gap_ns, emitting merged windows, the cluster membership table, and a
component index (offset+count into components per merged hit).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from waveformanalysis_tpu_torch.dtypes.schema import Field, Schema
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.ops import hit_merge as HM
from waveformanalysis_tpu_torch.plugins.base import Option, Plugin

HIT_MERGED_SCHEMA = Schema(
    "hit_merged",
    (
        Field("position", "i8"),
        Field("height", "f4"),
        Field("integral", "f4"),
        Field("sample_start", "i4"),
        Field("sample_end", "i4"),
        Field("width", "f4"),
        Field("dt", "i4"),
        Field("rise_time", "f4"),
        Field("fall_time", "f4"),
        Field("timestamp", "i8"),
        Field("board", "i2"),
        Field("channel", "i2"),
        Field("record_id", "i8"),
        Field("component_offset", "i8"),
        Field("component_count", "i4"),
    ),
)
HIT_MERGED_DTYPE = HIT_MERGED_SCHEMA.numpy_dtype()

HIT_MERGE_CLUSTERS_SCHEMA = Schema(
    "hit_merge_clusters",
    (Field("cluster_index", "i8"), Field("hit_index", "i8")),
)
HIT_MERGE_CLUSTERS_DTYPE = HIT_MERGE_CLUSTERS_SCHEMA.numpy_dtype()

HIT_MERGED_COMPONENTS_SCHEMA = Schema(
    "hit_merged_components",
    (Field("merged_index", "i8"), Field("hit_index", "i8")),
)
HIT_MERGED_COMPONENTS_DTYPE = HIT_MERGED_COMPONENTS_SCHEMA.numpy_dtype()


def _merge_options() -> Dict[str, Option]:
    return {
        # defaults MATCH THE REFERENCE (hit_merge.py:336-345: merge_gap_ns
        # 0.0 = merging disabled out of the box, max_total_width_ns 1e4).
        # The r1-r4 defaults (50.0 / 1e6) silently merged by default — a
        # divergence the config-sweep differential caught (the default-
        # config oracle's single-pulse fixtures never produced hits closer
        # than 50 ns, so it stayed invisible until a multi-pulse sweep).
        "merge_gap_ns": Option(
            default=0.0, type=float,
            help="Max gap (ns) between hit windows to merge; <=0 disables",
        ),
        "max_total_width_ns": Option(
            default=10000.0, type=float,
            help="Max total merged window width (ns)",
        ),
        "dt": Option(default=None, type=int,
                     help="Sample interval (ns) override for hits lacking dt"),
    }


def _hits_as_columns(hits: Any) -> Dict[str, np.ndarray]:
    if isinstance(hits, Table):
        return {k: np.asarray(v) for k, v in hits.columns.items()}
    if isinstance(hits, np.ndarray) and hits.dtype.names:
        return {name: np.asarray(hits[name]) for name in hits.dtype.names}
    raise ValueError("hit_merge expects hit_threshold as a Table or structured array")


def merge_kernel_config(context: Any, plugin: Plugin) -> dict:
    """Resolved merge options (shared with the fused subgraph executor).

    The cluster DEFINITION is owned by the ``hit_merge_clusters`` plugin:
    in the reference, ``hit_merged`` consumes that plugin's precomputed
    cluster rows, so the gap/width values that take effect for a
    ``hit_merged``/``hit_merged_components`` fetch are the ones resolved
    under the ``hit_merge_clusters`` scope — a ``{"hit_merged":
    {"merge_gap_ns": ...}}`` plugin-scoped override is inert there
    (reference: cpu/hit_merge.py:353-371 fetches hit_merge_clusters; the
    self-scoped values only feed its unused fallback path). Resolving
    gap/width against the registered clusters plugin reproduces that
    scoping exactly (global and dotted keys behave identically either
    way). ``dt`` stays self-scoped and is read RAW (see ``_raw_dt``): it is
    a per-plugin input-compat shim, and per-row dt from the hits always
    outranks it (ops/hit_merge.py). Pinned by the config-sweep
    differential (tests/test_reference_differential_configs.py merge_*
    sweeps, including the inert-scope one).
    """
    owner = plugin
    getter = getattr(context, "get_plugin", None)
    if getter is not None:
        owner = getter("hit_merge_clusters") or plugin
    return {
        "merge_gap_ns": float(context.get_config(owner, "merge_gap_ns")),
        "max_total_width_ns": float(
            context.get_config(owner, "max_total_width_ns")
        ),
        "dt": _raw_dt(context, plugin),
    }


def _raw_dt(context: Any, plugin: Any) -> Any:
    """Read the ``dt`` migration fallback RAW, as the reference does
    (cpu/_dt_compat.py:12-24 get_raw_config_value: plugin-scoped dict,
    dotted key, then the bare global — explicitly-set values only). Going
    through the resolver would adapter-infer dt (4 ns on v1725), turning
    the dormant fallback into a value that exists on every adapter run."""
    provides = plugin.provides
    cfg = context.config
    scoped = cfg.get(provides)
    if isinstance(scoped, dict) and "dt" in scoped:
        return scoped["dt"]
    dotted = f"{provides}.dt"
    if dotted in cfg:
        return cfg[dotted]
    return cfg.get("dt")


def merge_from_table(cfg: dict, hits: Any):
    """(merged, clusters, components) from a materialized hit_threshold
    table — the standalone computes and the fused executor both call this,
    so fused outputs are bit-identical by construction."""
    return HM.merge_hits(
        _hits_as_columns(hits),
        merge_gap_ns=cfg["merge_gap_ns"],
        max_total_width_ns=cfg["max_total_width_ns"],
        explicit_dt=cfg["dt"],
    )


def _run_merge(context: Any, plugin: Plugin, run_id: str):
    hits = context.get_data(run_id, "hit_threshold")
    return merge_from_table(merge_kernel_config(context, plugin), hits)


class _MergeFamilyPlugin(Plugin):
    """Shared fused-executor phase structure for the merge family."""

    def kernel_config(self, context: Any) -> dict:
        return merge_kernel_config(context, self)

    def adjust_lineage_config(self, context: Any, config: dict) -> dict:
        """Track the EFFECTIVE gap/width (owner-scope, see
        merge_kernel_config) so changing the hit_merge_clusters scope
        invalidates every member of the family, and the inert self-scope
        values never produce stale cache hits."""
        cfg = merge_kernel_config(context, self)
        out = dict(config)
        out["merge_gap_ns"] = cfg["merge_gap_ns"]
        out["max_total_width_ns"] = cfg["max_total_width_ns"]
        return out


def merged_table(triple) -> Table:
    merged, _clusters, _components = triple
    return Table(merged, schema=HIT_MERGED_SCHEMA)


def clusters_table(triple) -> Table:
    _merged, clusters, _components = triple
    return Table(
        {"cluster_index": clusters[:, 0], "hit_index": clusters[:, 1]},
        schema=HIT_MERGE_CLUSTERS_SCHEMA,
    )


def components_table(triple) -> Table:
    _merged, _clusters, components = triple
    return Table(
        {"merged_index": components[:, 0], "hit_index": components[:, 1]},
        schema=HIT_MERGED_COMPONENTS_SCHEMA,
    )


class HitMergePlugin(_MergeFamilyPlugin):
    """Merged hit windows per hardware channel."""

    provides = "hit_merged"
    depends_on = ["hit_threshold"]
    description = "Merge same-channel threshold hits within merge_gap_ns."
    version = "0.8.0"
    kernel_version = HM.KERNEL_VERSION
    save_when = "always"
    output_dtype = HIT_MERGED_SCHEMA
    options = _merge_options()

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> Table:
        return merged_table(_run_merge(context, self, run_id))


class HitMergeClustersPlugin(_MergeFamilyPlugin):
    """(cluster_index, hit_index) membership rows."""

    provides = "hit_merge_clusters"
    # outputs depend on run_config channel_metadata (hardware overrides)
    uses_run_config = True
    depends_on = ["hit_threshold"]
    description = "Cluster membership table for merged threshold hits."
    version = "0.8.0"
    kernel_version = HM.KERNEL_VERSION
    save_when = "always"
    output_dtype = HIT_MERGE_CLUSTERS_SCHEMA
    options = _merge_options()

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> Table:
        return clusters_table(_run_merge(context, self, run_id))


class HitMergedComponentsPlugin(_MergeFamilyPlugin):
    """(merged_index, hit_index) component rows aligned with hit_merged."""

    provides = "hit_merged_components"
    depends_on = ["hit_threshold"]
    description = "Component index table for merged threshold hits."
    version = "0.8.0"
    kernel_version = HM.KERNEL_VERSION
    save_when = "always"
    output_dtype = HIT_MERGED_COMPONENTS_SCHEMA
    options = _merge_options()

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> Table:
        return components_table(_run_merge(context, self, run_id))
