"""Typed lineage-graph data model.

Pure data structures describing the plugin DAG's topology — nodes with
typed in/out ports, port-to-port edges, and a Mermaid flowchart export —
built from a Context lineage dict. Visualizers and doc tooling consume
this model instead of re-walking raw lineage dicts.

Reference surface: waveform_analysis/core/foundation/model.py:13-228
(PortModel/NodeModel/EdgeModel/LineageGraphModel, build_lineage_graph
with converged longest-path depth). Rebuilt against our lineage shape
(context/context.py get_lineage): same keys ``plugin_class``,
``description``, ``config``, ``depends_on``.

Port of ``waveformanalysis_tpu/foundation/model.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "PortModel",
    "NodeModel",
    "EdgeModel",
    "LineageGraphModel",
    "build_lineage_graph",
    "get_plugin_dtypes",
    "get_plugin_title",
]


@dataclass
class PortModel:
    """One typed connection point on a node ('in' consumes, 'out' provides)."""

    id: str
    name: str
    kind: str  # 'in' or 'out'
    dtype: str
    parent_node_id: str
    index: int


@dataclass
class NodeModel:
    """One plugin in the DAG with its ports and longest-path depth."""

    id: str
    key: str
    title: str
    plugin_class: str
    description: str = ""
    config: Dict[str, Any] = field(default_factory=dict)
    in_ports: List[PortModel] = field(default_factory=list)
    out_ports: List[PortModel] = field(default_factory=list)
    depth: int = 0


@dataclass
class EdgeModel:
    """A directed wire from a source out-port to a target in-port."""

    source_node_id: str
    source_port_id: str
    target_node_id: str
    target_port_id: str
    dtype: str = "unknown"


def _mermaid_safe(node_id: str) -> str:
    return (
        node_id.replace("[", "_").replace("]", "_").replace(".", "_")
        .replace(" ", "_").replace("-", "_")
    )


@dataclass
class LineageGraphModel:
    """The whole DAG: nodes keyed by data name, port-level edges, metadata."""

    nodes: Dict[str, NodeModel] = field(default_factory=dict)
    edges: List[EdgeModel] = field(default_factory=list)
    metadata: Dict[str, Any] = field(default_factory=dict)

    def to_mermaid(self) -> str:
        """Render as a left-to-right Mermaid.js flowchart string."""
        lines = ["graph LR"]
        for node_id, node in self.nodes.items():
            safe_id = _mermaid_safe(node_id)
            label = f"{node.title}<br/>({node.plugin_class})"
            lines.append(f'    {safe_id}["{label}"]')
        for edge in self.edges:
            src = _mermaid_safe(edge.source_node_id)
            dst = _mermaid_safe(edge.target_node_id)
            lines.append(f'    {src} -- "{edge.dtype}" --> {dst}')
        return "\n".join(lines)

    def roots(self) -> List[str]:
        """Data names with no in-edges (the DAG's sources)."""
        targets = {e.target_node_id for e in self.edges}
        return sorted(n for n in self.nodes if n not in targets)

    def max_depth(self) -> int:
        return max((n.depth for n in self.nodes.values()), default=0)


def _dtype_str(dt: Any) -> str:
    if dt is None:
        return "unknown"
    try:
        import numpy as np

        return str(np.dtype(dt))
    except Exception:
        return str(dt)


def get_plugin_dtypes(name: str, plugins: Optional[Dict[str, Any]]
                      ) -> Tuple[str, str]:
    """(input dtype str, output dtype str) for a registered plugin, or
    ('unknown', 'unknown') when unavailable."""
    plugin = (plugins or {}).get(name)
    if plugin is None:
        return "unknown", "unknown"
    out = _dtype_str(getattr(plugin, "output_dtype", None))
    in_dt = getattr(plugin, "input_dtype", None)
    if isinstance(in_dt, dict):
        in_s = ", ".join(f"{k}: {_dtype_str(v)}" for k, v in in_dt.items())
        in_s = in_s or "unknown"
    else:
        in_s = _dtype_str(in_dt)
    return in_s, out


def get_plugin_title(name: str, info: Dict[str, Any],
                     plugins: Optional[Dict[str, Any]]) -> str:
    """Human title for a node: plugin attribute, else the data name."""
    plugin = (plugins or {}).get(name)
    title = getattr(plugin, "title", None)
    if title:
        return str(title)
    return str(info.get("title", name))


def build_lineage_graph(
    lineage: Dict[str, Any],
    target_name: str,
    plugins: Optional[Dict[str, Any]] = None,
) -> LineageGraphModel:
    """Convert a nested lineage dict into a :class:`LineageGraphModel`.

    ``lineage`` is the target's own lineage entry (as returned by
    ``Context.get_lineage``); ``depends_on`` entries nest recursively.
    Depth is the longest path FROM the target: the target is 0 and each
    node's depth converges to ``max(depth of nodes depending on it) + 1``;
    unreachable sources land at ``max_depth + 1``.
    """
    model = LineageGraphModel()
    plugins = plugins or {}

    visited: set = set()
    plugin_info: Dict[str, Dict[str, Any]] = {}
    dependencies: Dict[str, List[str]] = {}

    def traverse(name: str, info: Optional[Dict[str, Any]]) -> None:
        if name in visited:
            return
        visited.add(name)
        info = info or {}
        plugin_info[name] = info
        deps = info.get("depends_on", {}) or {}
        dependencies[name] = list(deps.keys())
        for dep_name, dep_info in deps.items():
            traverse(dep_name, dep_info)

    traverse(target_name, lineage)

    # longest-path depth from the target, iterated to convergence (the
    # graph is a DAG so this terminates; iteration count <= longest path)
    plugin_depth: Dict[str, int] = {target_name: 0}
    dependents: Dict[str, List[str]] = {name: [] for name in plugin_info}
    for node_name, deps in dependencies.items():
        for dep in deps:
            if dep in dependents:
                dependents[dep].append(node_name)

    changed = True
    while changed:
        changed = False
        for node_name in plugin_info:
            if node_name == target_name:
                continue
            max_dep_depth = -1
            for dependent in dependents[node_name]:
                if dependent in plugin_depth:
                    max_dep_depth = max(max_dep_depth,
                                        plugin_depth[dependent])
            if max_dep_depth >= 0:
                new_depth = max_dep_depth + 1
                if plugin_depth.get(node_name) != new_depth:
                    plugin_depth[node_name] = new_depth
                    changed = True

    max_depth = max(plugin_depth.values()) if plugin_depth else 0
    for node_name in plugin_info:
        plugin_depth.setdefault(node_name, max_depth + 1)

    for p, info in plugin_info.items():
        node = NodeModel(
            id=p,
            key=p,
            title=get_plugin_title(p, info, plugins),
            plugin_class=info.get("plugin_class", "UnknownPlugin"),
            description=info.get("description", ""),
            config=info.get("config", {}) or {},
            depth=plugin_depth.get(p, 0),
        )

        _, out_dtype_str = get_plugin_dtypes(p, plugins)

        deps = sorted((info.get("depends_on", {}) or {}).keys())
        for i, dep_p in enumerate(deps):
            _, dep_out_dtype = get_plugin_dtypes(dep_p, plugins)
            node.in_ports.append(PortModel(
                id=f"IN::{p}::{i}", name=dep_p, kind="in",
                dtype=dep_out_dtype, parent_node_id=p, index=i,
            ))

        provides = info.get("provides", p)
        prov_list = ([provides] if isinstance(provides, str)
                     else list(provides or [p]))
        for i, label in enumerate(prov_list):
            node.out_ports.append(PortModel(
                id=f"OUT::{p}::{i}", name=label, kind="out",
                dtype=out_dtype_str, parent_node_id=p, index=i,
            ))

        model.nodes[p] = node

    # wire each dependency: A.OUT(A) -> B.IN(A)
    for target_p, info in plugin_info.items():
        for dep_p in (info.get("depends_on", {}) or {}):
            if dep_p not in model.nodes:
                continue
            source_node = model.nodes[dep_p]
            target_node = model.nodes[target_p]
            source_port = next(
                (o for o in source_node.out_ports if o.name == dep_p), None)
            target_port = next(
                (i for i in target_node.in_ports if i.name == dep_p), None)
            if source_port and target_port:
                model.edges.append(EdgeModel(
                    source_node_id=source_node.id,
                    source_port_id=source_port.id,
                    target_node_id=target_node.id,
                    target_port_id=target_port.id,
                    dtype=source_port.dtype,
                ))

    return model
