"""Lineage and waveform visualization.

Behavioral analog of the reference visualizers
(reference: waveform_analysis/utils/visualization/lineage_visualizer.py and
waveform_visualizer.py): layered "labview"-style lineage rendering with
matplotlib, an optional plotly variant, node-type color classification,
verbose text blocks, orthogonal wire routing with obstacle avoidance,
critical-path/bottleneck/parallel-group highlighting, interactive
hover/click handlers, and channel-aware waveform plots with hit overlays.

All pure-data helpers (graph flatten, layout, classification, routing)
work without a display; the renderers require matplotlib (Agg is enough).

Port of ``waveformanalysis_tpu/utils/visualization.py``. The waveform plots
read their inputs on the host: a Table or a tensor on any device is fetched
first (``device.to_host``; ``Table.to_numpy`` fetches the browser's
st_waveforms and hits).
"""

from __future__ import annotations

import logging
import textwrap
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from waveformanalysis_tpu_torch.device import to_host

logger = logging.getLogger(__name__)


# ----------------------------------------------------------------------
# Style
# ----------------------------------------------------------------------

def _default_type_colors() -> Dict[str, str]:
    return {
        "DataFrame": "#f57c00",
        "ndarray": "#388e3c",
        "Unknown": "#95a5a6",
    }


def _default_wire_styles() -> Dict[str, Dict[str, Any]]:
    return {
        "dataframe": {"color": "#f57c00", "width": 1.6},
        "structured": {"color": "#388e3c"},
        "array": {"color": "#5c7fb0"},
        "list_array": {"color": "#7b1fa2", "dash": "dash"},
        "unknown": {"color": "#95a5a6", "alpha": 0.7},
    }


@dataclass
class LineageStyle:
    """Layout/appearance knobs for the lineage renderers
    (reference: foundation/utils.py LineageStyle)."""

    node_width: float = 1.6
    node_height: float = 0.7
    x_gap: float = 1.1
    y_gap: float = 0.55
    header_height: float = 0.24
    port_size: float = 0.045
    font_size: float = 8.0
    verbose: int = 0
    max_label_chars: int = 24
    max_config_lines: int = 5
    wire_linewidth: float = 1.4
    wire_alpha: float = 0.85
    auto_fit_text: bool = True
    orthogonal_wires: bool = True
    show_ports: bool = True
    show_legend: bool = False
    type_colors: Dict[str, str] = field(default_factory=_default_type_colors)
    wire_style_by_category: Dict[str, Dict[str, Any]] = field(
        default_factory=_default_wire_styles
    )
    wire_style_overrides: Dict[str, Dict[str, Any]] = field(
        default_factory=dict
    )


# ----------------------------------------------------------------------
# Graph model
# ----------------------------------------------------------------------

def lineage_to_graph(lineage: Dict[str, Any], target: str
                     ) -> Tuple[List[str], List[Tuple[str, str]], Dict[str, Dict]]:
    """Flatten a recursive lineage dict into (nodes, edges, node_info)."""
    nodes: List[str] = []
    edges: List[Tuple[str, str]] = []
    info: Dict[str, Dict] = {}

    def walk(name: str, lin: Dict[str, Any]) -> None:
        if name in info:
            return
        nodes.append(name)
        info[name] = {
            "plugin_class": lin.get("plugin_class", "?"),
            "version": lin.get("plugin_version", ""),
            "description": lin.get("description", ""),
            "config": lin.get("config", {}),
        }
        for dep, sub in (lin.get("depends_on") or {}).items():
            edges.append((dep, name))
            walk(dep, sub or {})

    walk(target, lineage)
    return nodes, edges, info


def _attach_context_details(info: Dict[str, Dict], context: Any) -> None:
    """Enrich node info with output dtype / save_when from live plugins."""
    if context is None:
        return
    plugins = getattr(context, "_plugins", {}) or {}
    for name, details in info.items():
        plugin = plugins.get(name)
        if plugin is None:
            continue
        dtype = getattr(plugin, "output_dtype", None)
        if dtype is None:
            schema = getattr(plugin, "schema", None)
            dtype = getattr(schema, "numpy_dtype", lambda: None)() \
                if schema is not None else None
        if dtype is not None:
            details["dtype"] = str(dtype)
        save_when = getattr(plugin, "save_when", None)
        if save_when is not None:
            details["save_when"] = str(save_when)
        if not details.get("description"):
            doc = (getattr(type(plugin), "__doc__", "") or "").strip()
            if doc:
                details["description"] = doc.splitlines()[0]


# ----------------------------------------------------------------------
# Classification (node colors / wire styles)
# ----------------------------------------------------------------------

NODE_TYPE_COLORS: Dict[str, Tuple[str, str, str]] = {
    # node_type -> (face, border, header)
    "raw_data": ("#e3f2fd", "#1976d2", "#bbdefb"),
    "structured_array": ("#e8f5e9", "#388e3c", "#c8e6c9"),
    "dataframe": ("#fff3e0", "#f57c00", "#ffe0b2"),
    "grouped": ("#f3e5f5", "#7b1fa2", "#e1bee7"),
    "side_effect": ("#fce4ec", "#c2185b", "#f8bbd0"),
    "intermediate": ("#fafafa", "#424242", "#e0e0e0"),
}


def classify_node_type(name: str, details: Dict[str, Any]) -> str:
    """Heuristic node-type classification used for color highlighting
    (reference: lineage_visualizer.py:158 _classify_node_type)."""
    cls = str(details.get("plugin_class", "")).lower()
    key = name.lower()
    dtype = str(details.get("dtype", "")).lower()

    if any(k in cls for k in ("rawfiles", "loader", "reader")):
        return "raw_data"
    if "dataframe" in cls or "dataframe" in key or name == "df" \
            or "dataframe" in dtype:
        return "dataframe"
    if any(k in cls for k in ("group", "pair", "aggregate", "merge")):
        return "grouped"
    if any(k in key for k in ("grouped", "paired", "merged")):
        return "grouped"
    if any(k in cls for k in ("export", "save", "write")):
        return "side_effect"
    if ("[(" in dtype or ", " in dtype) and "list" not in dtype:
        return "structured_array"
    return "intermediate"


def classify_edge_category(dtype: str) -> str:
    """Bucket an edge's payload dtype string into a wire-style category
    (reference: lineage_visualizer.py:475)."""
    if not dtype:
        return "unknown"
    d = dtype.lower()
    if "dataframe" in d:
        return "dataframe"
    if "list" in d and "ndarray" in d:
        return "list_array"
    if "[(" in d or "structured" in d:
        return "structured"
    if "ndarray" in d or d.startswith("[("):
        return "array"
    return "unknown"


def resolve_wire_style(src: str, dst: str, dtype: str,
                       style: LineageStyle) -> Dict[str, Any]:
    """Edge draw attributes: category defaults, then substring overrides."""
    resolved = {
        "color": style.type_colors.get(
            dtype, style.type_colors.get("Unknown", "#95a5a6")),
        "width": style.wire_linewidth,
        "alpha": style.wire_alpha,
        "dash": "solid",
    }
    cat = classify_edge_category(dtype)
    for k, v in style.wire_style_by_category.get(cat, {}).items():
        resolved[k] = v
    match_text = f"{src} {dst} {dtype}".lower()
    for needle, overrides in style.wire_style_overrides.items():
        if needle.lower() in match_text:
            resolved.update(overrides)
    return resolved


def _mpl_linestyle(dash: Optional[str]) -> str:
    return {"dash": "dashed", "dot": "dotted",
            "dashdot": "dashdot"}.get(dash or "solid", "solid") \
        if dash not in (None, "solid") else "solid"


# ----------------------------------------------------------------------
# Text fitting
# ----------------------------------------------------------------------

def wrap_text_lines(text: str, max_width: int,
                    max_lines: Optional[int] = None) -> List[str]:
    """Wrap text; truncate to max_lines with a trailing ellipsis."""
    lines = textwrap.wrap(str(text), width=max_width,
                          break_long_words=False)
    if max_lines is None or max_lines <= 0 or len(lines) <= max_lines:
        return lines
    lines = lines[:max_lines]
    lines[-1] = lines[-1].rstrip(".") + "..."
    return lines


def node_text_lines(name: str, details: Dict[str, Any],
                    style: LineageStyle) -> List[str]:
    """Body lines under the header, grown by verbose level:
    0 = nothing, 1 = class, 2+ = class + description + config."""
    lines: List[str] = []
    if style.verbose >= 1:
        cls = details.get("plugin_class", "")
        if cls:
            lines.extend(wrap_text_lines(cls, style.max_label_chars, 1))
    if style.verbose >= 2:
        desc = details.get("description", "")
        if desc:
            lines.extend(wrap_text_lines(desc, style.max_label_chars, 2))
        for i, (k, v) in enumerate(sorted(
                (details.get("config") or {}).items())):
            if i >= style.max_config_lines:
                lines.append("...")
                break
            lines.extend(wrap_text_lines(f"{k}={v!r}",
                                         style.max_label_chars, 1))
    return lines


def estimate_node_height(name: str, details: Dict[str, Any],
                         style: LineageStyle) -> float:
    """Node height that fits the verbose text block."""
    if not style.auto_fit_text:
        return style.node_height
    n_lines = len(node_text_lines(name, details, style))
    line_h = 0.16
    body = n_lines * line_h + (0.12 if n_lines else 0.0)
    return max(style.node_height, style.header_height + 0.22 + body)


# ----------------------------------------------------------------------
# Layout
# ----------------------------------------------------------------------

def _levels(nodes: Sequence[str], edges: Sequence[Tuple[str, str]]
            ) -> Dict[str, int]:
    deps: Dict[str, List[str]] = {n: [] for n in nodes}
    for src, dst in edges:
        deps.setdefault(dst, []).append(src)
        deps.setdefault(src, [])
    level: Dict[str, int] = {}

    def level_of(n: str, seen=frozenset()) -> int:
        if n in level:
            return level[n]
        if n in seen:
            return 0
        lvl = max((level_of(d, seen | {n})
                   for d in deps.get(n, [])), default=-1) + 1
        level[n] = lvl
        return lvl

    for n in nodes:
        level_of(n)
    return level


def order_layers(by_level: Dict[int, List[str]],
                 edges: Sequence[Tuple[str, str]],
                 sweeps: int = 2) -> Dict[int, List[str]]:
    """Barycenter crossing reduction: order each layer by the mean row of
    its neighbors in the adjacent layer, sweeping left-to-right then back
    (reference: lineage_visualizer.py:312 _reorder_layers)."""
    preds: Dict[str, List[str]] = {}
    succs: Dict[str, List[str]] = {}
    for src, dst in edges:
        preds.setdefault(dst, []).append(src)
        succs.setdefault(src, []).append(dst)
    ordered = {lvl: sorted(members) for lvl, members in by_level.items()}
    lvls = sorted(ordered)

    def sweep(levels: Sequence[int], neighbor_of: Dict[str, List[str]],
              ref_offset: int) -> None:
        for lvl in levels:
            ref = ordered.get(lvl + ref_offset)
            if not ref:
                continue
            rank = {n: i for i, n in enumerate(ref)}
            cur = ordered[lvl]
            cur_rank = {n: i for i, n in enumerate(cur)}

            def bary(n: str) -> float:
                rows = [rank[m] for m in neighbor_of.get(n, []) if m in rank]
                return float(np.mean(rows)) if rows else float(cur_rank[n])

            ordered[lvl] = sorted(cur, key=lambda n: (bary(n), n))

    for _ in range(max(1, sweeps)):
        sweep(lvls[1:], preds, -1)          # left→right, order by preds
        sweep(list(reversed(lvls[:-1])), succs, +1)  # right→left
    return ordered


def layered_layout(nodes: Sequence[str], edges: Sequence[Tuple[str, str]]
                   ) -> Dict[str, Tuple[float, float]]:
    """Left-to-right layered positions (dependencies left of consumers),
    with barycenter row ordering to reduce wire crossings."""
    level = _levels(nodes, edges)
    by_level: Dict[int, List[str]] = {}
    for n in nodes:
        by_level.setdefault(level[n], []).append(n)
    ordered = order_layers(by_level, edges)
    pos: Dict[str, Tuple[float, float]] = {}
    for lvl, members in ordered.items():
        for i, n in enumerate(members):
            pos[n] = (float(lvl), -float(i) + (len(members) - 1) / 2.0)
    return pos


def scaled_positions(pos: Dict[str, Tuple[float, float]],
                     heights: Dict[str, float],
                     style: LineageStyle) -> Dict[str, Tuple[float, float]]:
    """Scale unit grid positions into data coordinates, spacing rows by
    the tallest node in each layer."""
    cols: Dict[float, List[str]] = {}
    for n, (x, _y) in pos.items():
        cols.setdefault(x, []).append(n)
    out: Dict[str, Tuple[float, float]] = {}
    x_pitch = style.node_width + style.x_gap
    for x, members in cols.items():
        pitch = max(heights.get(n, style.node_height)
                    for n in members) + style.y_gap
        for n in members:
            out[n] = (pos[n][0] * x_pitch, pos[n][1] * pitch)
    return out


# ----------------------------------------------------------------------
# Wire routing
# ----------------------------------------------------------------------

def _node_boxes(pos: Dict[str, Tuple[float, float]],
                heights: Dict[str, float],
                style: LineageStyle) -> List[Dict[str, Any]]:
    margin = max(0.06, style.port_size * 2)
    boxes = []
    for n, (x, y) in pos.items():
        h = heights.get(n, style.node_height)
        boxes.append({
            "id": n,
            "x_min": x - style.node_width / 2 - margin,
            "x_max": x + style.node_width / 2 + margin,
            "y_min": y - h / 2 - margin,
            "y_max": y + h / 2 + margin,
        })
    return boxes


def _segment_hits_box(p1: Tuple[float, float], p2: Tuple[float, float],
                      box: Dict[str, Any]) -> bool:
    """Axis-aligned segment vs box overlap (wires are orthogonal)."""
    (x1, y1), (x2, y2) = p1, p2
    lo_x, hi_x = min(x1, x2), max(x1, x2)
    lo_y, hi_y = min(y1, y2), max(y1, y2)
    return not (hi_x <= box["x_min"] or lo_x >= box["x_max"]
                or hi_y <= box["y_min"] or lo_y >= box["y_max"])


def _path_clear(path: List[Tuple[float, float]],
                boxes: List[Dict[str, Any]], skip: set) -> bool:
    for a, b in zip(path[:-1], path[1:]):
        for box in boxes:
            if box["id"] in skip:
                continue
            if _segment_hits_box(a, b, box):
                return False
    return True


def route_edge(start: Tuple[float, float], end: Tuple[float, float],
               boxes: List[Dict[str, Any]], skip: set,
               ) -> Optional[List[Tuple[float, float]]]:
    """Orthogonal H-V-H wire from an out-port to an in-port, nudging the
    vertical jog sideways to dodge node boxes
    (reference: lineage_visualizer.py:407 _route_edge_path). Returns the
    polyline, or None when no clear orthogonal route was found (caller
    falls back to an arc)."""
    sx, sy = start
    ex, ey = end
    base_mid = (sx + ex) / 2.0
    span = max(abs(ex - sx), 1e-6)
    for frac in (0.5, 0.35, 0.65, 0.2, 0.8, 0.1, 0.9):
        mid = sx + (ex - sx) * frac
        path = [(sx, sy), (mid, sy), (mid, ey), (ex, ey)]
        if _path_clear(path, boxes, skip):
            return path
    # try jogging above/below the obstacle band
    ys = [b["y_min"] for b in boxes] + [b["y_max"] for b in boxes]
    if ys:
        for detour_y in (max(ys) + 0.3, min(ys) - 0.3):
            path = [(sx, sy), (base_mid - 0.15 * span, sy),
                    (base_mid - 0.15 * span, detour_y),
                    (base_mid + 0.15 * span, detour_y),
                    (base_mid + 0.15 * span, ey), (ex, ey)]
            if _path_clear(path, boxes, skip):
                return path
    return None


# ----------------------------------------------------------------------
# Interactive helpers (testable without a display)
# ----------------------------------------------------------------------

def upstream_nodes(edges: Sequence[Tuple[str, str]], node: str) -> set:
    """All transitive dependencies of `node` (clicked-node highlight)."""
    preds: Dict[str, List[str]] = {}
    for src, dst in edges:
        preds.setdefault(dst, []).append(src)
    seen: set = set()
    stack = [node]
    while stack:
        cur = stack.pop()
        for p in preds.get(cur, []):
            if p not in seen:
                seen.add(p)
                stack.append(p)
    return seen


def format_node_info(name: str, details: Dict[str, Any],
                     verbose: int = 2) -> str:
    """Hover-box text for a node."""
    lines = [name]
    if details.get("plugin_class"):
        lines.append(f"class: {details['plugin_class']}")
    if details.get("version"):
        lines.append(f"version: {details['version']}")
    if details.get("dtype"):
        lines.append(f"dtype: {details['dtype'][:60]}")
    if verbose >= 2:
        if details.get("description"):
            lines.append(details["description"][:120])
        for k, v in sorted((details.get("config") or {}).items()):
            lines.append(f"  {k} = {v!r}")
    return "\n".join(lines)


# ----------------------------------------------------------------------
# Matplotlib renderer
# ----------------------------------------------------------------------

def plot_lineage_labview(
    lineage: Dict[str, Any],
    target: str,
    context: Any = None,
    analysis_result: Any = None,
    highlight_critical_path: bool = False,
    highlight_bottlenecks: bool = False,
    highlight_parallel_groups: bool = False,
    style: Optional[LineageStyle] = None,
    verbose: Optional[int] = None,
    interactive: bool = False,
    ax: Any = None,
):
    """Matplotlib block-diagram lineage plot (reference:
    lineage_visualizer.py:577 plot_lineage_labview).

    Nodes are classified (raw data / structured array / dataframe /
    grouped / side effect / intermediate) and colored accordingly; a
    header strip carries the data name, the body carries class /
    description / config lines per ``verbose``; wires route orthogonally
    around node boxes with per-dtype styles. ``interactive=True`` attaches
    hover (node info box) and click (upstream highlight) handlers.
    """
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib.patches import (Circle, FancyArrowPatch,
                                    FancyBboxPatch, Rectangle)

    style = style or LineageStyle()
    if verbose is not None:
        style.verbose = int(verbose)

    nodes, edges, info = lineage_to_graph(lineage, target)
    _attach_context_details(info, context)
    heights = {n: estimate_node_height(n, info[n], style) for n in nodes}
    pos = scaled_positions(layered_layout(nodes, edges), heights, style)
    boxes = _node_boxes(pos, heights, style)

    critical: set = set()
    bottlenecks: set = set()
    parallel_group_of: Dict[str, int] = {}
    if analysis_result is not None:
        if highlight_critical_path:
            critical = set(getattr(analysis_result, "critical_path", []))
        if highlight_bottlenecks:
            bottlenecks = {n for n, _ in
                           getattr(analysis_result, "bottlenecks", [])}
        if highlight_parallel_groups:
            for gi, group in enumerate(
                    getattr(analysis_result, "parallel_groups", []) or []):
                for n in group:
                    parallel_group_of[n] = gi

    if ax is None:
        xs = [x for x, _ in pos.values()]
        ys = [y for _, y in pos.values()]
        width = max(8.0, (max(xs) - min(xs)) + 3 * style.node_width)
        height = max(4.0, (max(ys) - min(ys)) + 4 * style.node_height)
        _fig, ax = plt.subplots(figsize=(min(width, 28), min(height, 20)))

    W = style.node_width
    group_cmap = ("#dbe9ff", "#ffe9db", "#e3ffdb", "#f3dbff", "#fffadb")
    node_face: Dict[str, Any] = {}
    node_patch: Dict[str, Any] = {}
    in_degree: Dict[str, int] = {n: 0 for n in nodes}
    for _s, d in edges:
        in_degree[d] = in_degree.get(d, 0) + 1

    for name in nodes:
        x, y = pos[name]
        h = heights[name]
        ntype = classify_node_type(name, info[name])
        face, border, header = NODE_TYPE_COLORS[ntype]
        if name in parallel_group_of:
            face = group_cmap[parallel_group_of[name] % len(group_cmap)]
        if name in critical:
            face = "#9fd3a5"
        if name in bottlenecks:
            face = "#ffd27f"
        box = FancyBboxPatch(
            (x - W / 2, y - h / 2), W, h,
            boxstyle="round,pad=0.03", facecolor=face, edgecolor=border,
            linewidth=1.2, zorder=2,
        )
        ax.add_patch(box)
        node_face[name] = face
        node_patch[name] = box
        # header strip + title
        hdr = Rectangle((x - W / 2, y + h / 2 - style.header_height),
                        W, style.header_height, facecolor=header,
                        edgecolor="none", zorder=3)
        ax.add_patch(hdr)
        title = name
        if info[name].get("version") and style.verbose == 0:
            title += f" v{info[name]['version']}"
        ax.text(x, y + h / 2 - style.header_height / 2, title,
                ha="center", va="center", fontsize=style.font_size,
                weight="bold", zorder=4)
        body = node_text_lines(name, info[name], style)
        if body:
            ax.text(x, y + h / 2 - style.header_height - 0.08,
                    "\n".join(body), ha="center", va="top",
                    fontsize=style.font_size - 1.2, zorder=4)
        if style.show_ports:
            if in_degree.get(name, 0):
                ax.add_patch(Circle((x - W / 2, y), style.port_size,
                                    facecolor="#36558f", zorder=4))
            if any(s == name for s, _ in edges):
                ax.add_patch(Circle((x + W / 2, y), style.port_size,
                                    facecolor="#8f5b36", zorder=4))

    for src, dst in edges:
        x0, y0 = pos[src]
        x1, y1 = pos[dst]
        start = (x0 + W / 2, y0)
        end = (x1 - W / 2, y1)
        wstyle = resolve_wire_style(src, dst, info[src].get("dtype", ""),
                                    style)
        path = route_edge(start, end, boxes, {src, dst}) \
            if style.orthogonal_wires else None
        if path is not None:
            px = [p[0] for p in path]
            py = [p[1] for p in path]
            ax.plot(px, py, color=wstyle["color"],
                    lw=wstyle["width"], alpha=wstyle["alpha"],
                    ls=_mpl_linestyle(wstyle.get("dash")), zorder=1,
                    solid_capstyle="round")
            arrow = FancyArrowPatch(
                path[-2], path[-1], arrowstyle="-|>", mutation_scale=11,
                color=wstyle["color"], lw=0, zorder=1)
            ax.add_patch(arrow)
        else:
            arrow = FancyArrowPatch(
                start, end, arrowstyle="-|>", mutation_scale=12,
                color=wstyle["color"], alpha=wstyle["alpha"],
                lw=wstyle["width"],
                linestyle=_mpl_linestyle(wstyle.get("dash")),
                connectionstyle="arc3,rad=0.15", zorder=1)
            ax.add_patch(arrow)

    xs = [x for x, _ in pos.values()]
    ys = [y for _, y in pos.values()]
    ax.set_xlim(min(xs) - W, max(xs) + W)
    ax.set_ylim(min(ys) - 2 * style.node_height,
                max(ys) + 2 * style.node_height)
    ax.set_aspect("auto")
    ax.axis("off")
    ax.set_title(f"Lineage: {target}")

    if style.show_legend:
        from matplotlib.patches import Patch
        handles = [Patch(facecolor=v[0], edgecolor=v[1], label=k)
                   for k, v in NODE_TYPE_COLORS.items()]
        ax.legend(handles=handles, fontsize=style.font_size - 1,
                  loc="lower right", framealpha=0.8)

    if interactive:
        _attach_interactive(ax, nodes, edges, info, pos, heights,
                            node_patch, node_face, style)
    return ax


def _attach_interactive(ax, nodes, edges, info, pos, heights,
                        node_patch, node_face, style: LineageStyle):
    """Hover = node info annotation; click = upstream highlight
    (reference: lineage_visualizer.py:950 _add_interactive_features)."""
    fig = ax.figure
    annot = ax.annotate(
        "", xy=(0, 0), xytext=(12, 12), textcoords="offset points",
        bbox=dict(boxstyle="round", fc="#fffbe8", ec="#999", alpha=0.95),
        fontsize=style.font_size - 1, zorder=10, visible=False,
    )

    def node_at(x: float, y: float) -> Optional[str]:
        if x is None or y is None:
            return None
        for n in nodes:
            nx, ny = pos[n]
            h = heights[n]
            if (abs(x - nx) <= style.node_width / 2
                    and abs(y - ny) <= h / 2):
                return n
        return None

    def on_hover(event):
        if event.inaxes is not ax:
            return
        n = node_at(event.xdata, event.ydata)
        if n is None:
            if annot.get_visible():
                annot.set_visible(False)
                fig.canvas.draw_idle()
            return
        annot.xy = pos[n]
        annot.set_text(format_node_info(n, info[n],
                                        max(2, style.verbose)))
        annot.set_visible(True)
        fig.canvas.draw_idle()

    def on_click(event):
        if event.inaxes is not ax:
            return
        n = node_at(event.xdata, event.ydata)
        ups = upstream_nodes(edges, n) | {n} if n is not None else set()
        for name, patch in node_patch.items():
            if not ups:
                patch.set_facecolor(node_face[name])
                patch.set_alpha(1.0)
            elif name in ups:
                patch.set_facecolor("#ffe9a8" if name != n else "#ffd27f")
                patch.set_alpha(1.0)
            else:
                patch.set_alpha(0.25)
        fig.canvas.draw_idle()

    fig.canvas.mpl_connect("motion_notify_event", on_hover)
    fig.canvas.mpl_connect("button_press_event", on_click)
    # keep references alive for the figure's lifetime
    ax._wfa_interactive = (on_hover, on_click, annot)  # type: ignore


# ----------------------------------------------------------------------
# Plotly renderer (optional dependency)
# ----------------------------------------------------------------------

def plot_lineage_plotly(lineage: Dict[str, Any], target: str,
                        context: Any = None,
                        verbose: int = 1,
                        style: Optional[LineageStyle] = None) -> Any:
    """Plotly variant with shape-drawn rectangles and hover details;
    returns a Figure (raises ImportError if plotly missing)
    (reference: lineage_visualizer.py:1186)."""
    import plotly.graph_objects as go  # type: ignore

    style = style or LineageStyle()
    style.verbose = verbose
    nodes, edges, info = lineage_to_graph(lineage, target)
    _attach_context_details(info, context)
    heights = {n: estimate_node_height(n, info[n], style) for n in nodes}
    pos = scaled_positions(layered_layout(nodes, edges), heights, style)

    fig = go.Figure()
    W = style.node_width
    for src, dst in edges:
        x0, y0 = pos[src]
        x1, y1 = pos[dst]
        wstyle = resolve_wire_style(src, dst, info[src].get("dtype", ""),
                                    style)
        fig.add_trace(go.Scatter(
            x=[x0 + W / 2, (x0 + x1) / 2, (x0 + x1) / 2, x1 - W / 2],
            y=[y0, y0, y1, y1], mode="lines",
            line=dict(color=wstyle["color"], width=wstyle["width"]),
            hoverinfo="none", showlegend=False))
    for n in nodes:
        x, y = pos[n]
        h = heights[n]
        ntype = classify_node_type(n, info[n])
        face, border, header = NODE_TYPE_COLORS[ntype]
        fig.add_shape(type="rect", x0=x - W / 2, x1=x + W / 2,
                      y0=y - h / 2, y1=y + h / 2,
                      fillcolor=face, line=dict(color=border))
        fig.add_shape(type="rect", x0=x - W / 2, x1=x + W / 2,
                      y0=y + h / 2 - style.header_height, y1=y + h / 2,
                      fillcolor=header, line=dict(width=0))
        fig.add_annotation(x=x, y=y + h / 2 - style.header_height / 2,
                           text=f"<b>{n}</b>", showarrow=False,
                           font=dict(size=10))
    fig.add_trace(go.Scatter(
        x=[pos[n][0] for n in nodes],
        y=[pos[n][1] for n in nodes],
        mode="markers",
        marker=dict(size=18, color="rgba(0,0,0,0)"),
        hovertext=[format_node_info(n, info[n], verbose).replace(
            "\n", "<br>") for n in nodes],
        hoverinfo="text", showlegend=False))
    fig.update_layout(title=f"Lineage: {target}", showlegend=False,
                      xaxis_visible=False, yaxis_visible=False,
                      yaxis_scaleanchor="x")
    return fig


# ----------------------------------------------------------------------
# Waveform viewer
# ----------------------------------------------------------------------

def _parse_channel_selector(channel: Any) -> Tuple[int, int]:
    """Accept HardwareChannel | (board, channel) | 'b0c3' | '0:3' | int
    and normalize to a (board, channel) tuple
    (reference: waveform_visualizer.py:41)."""
    from waveformanalysis_tpu_torch.hardware import HardwareChannel

    if isinstance(channel, HardwareChannel):
        return (channel.board, channel.channel)
    if isinstance(channel, tuple) and len(channel) == 2:
        return (int(channel[0]), int(channel[1]))
    if isinstance(channel, (int, np.integer)):
        return (0, int(channel))
    if isinstance(channel, str):
        s = channel.strip().lower()
        if s.startswith("b") and "c" in s:
            b, c = s[1:].split("c", 1)
            return (int(b), int(c))
        if ":" in s:
            b, c = s.split(":", 1)
            return (int(b), int(c))
        return (0, int(s.lstrip("ch")))
    raise ValueError(f"unrecognized channel selector: {channel!r}")


def _channel_label(bc: Tuple[int, int]) -> str:
    return f"B{bc[0]}:CH{bc[1]}"


def _hits_field(hits: Any, name: str) -> Optional[np.ndarray]:
    """Field access that works for structured arrays, Tables, and dicts."""
    if hits is None:
        return None
    dtype = getattr(hits, "dtype", None)
    if dtype is not None and getattr(dtype, "names", None):
        return np.asarray(hits[name]) if name in dtype.names else None
    try:
        if name in hits:
            return np.asarray(hits[name])
    except TypeError:
        pass
    return None


def plot_waveforms(
    waves: Any,
    baselines: Optional[Any] = None,
    hits: Optional[Any] = None,
    max_events: int = 16,
    event_index: Optional[int] = None,
    channels: Optional[Sequence[Any]] = None,
    title: str = "Waveform Viewer",
    ax: Any = None,
):
    """Waveform plot (reference: waveform_visualizer.py:59 plot_waveforms).

    Two modes:
    - **flat matrix** (2D array of samples): overlay up to ``max_events``
      traces with optional baseline lines and hit markers (dict or
      structured HIT array with ``position``).
    - **structured records** (numpy structured array with a ``wave``
      field, e.g. st_waveforms): per-hardware-channel subplots of one
      ``event_index``, baseline dashed line, hit markers + edge spans
      matched by board/channel (+record_id when present). Returns the
      figure in this mode.
    """
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    waves, baselines, hits = to_host(waves), to_host(baselines), to_host(hits)
    if hasattr(waves, "to_numpy") and not isinstance(waves, np.ndarray):
        waves = waves.to_numpy()          # Table -> structured array
    if hits is not None and hasattr(hits, "to_numpy") \
            and not isinstance(hits, np.ndarray):
        hits = hits.to_numpy()

    names = getattr(getattr(waves, "dtype", None), "names", None)
    if names and "wave" in names:
        return _plot_structured_event(
            waves, hits, event_index or 0, channels, title, plt)

    waves = np.asarray(waves)[:max_events]
    if ax is None:
        _fig, ax = plt.subplots(figsize=(10, 5))
    for i, w in enumerate(waves):
        ax.plot(w, alpha=0.6, lw=0.9,
                label=f"evt {i}" if len(waves) <= 8 else None)
    if baselines is not None:
        for b in np.asarray(baselines)[:max_events]:
            ax.axhline(float(b), color="gray", ls="--", lw=0.5, alpha=0.4)
    positions = _hits_field(hits, "position")
    if positions is not None:
        for p in positions:
            ax.axvline(int(p), color="crimson", ls=":", lw=0.8, alpha=0.6)
    if len(waves) <= 8:
        ax.legend(fontsize=7)
    ax.set_xlabel("sample")
    ax.set_ylabel("ADC")
    return ax


def _plot_structured_event(waves: np.ndarray, hits: Any, event_index: int,
                           channels: Optional[Sequence[Any]], title: str,
                           plt: Any):
    """Per-channel subplot view of one event from structured records."""
    names = waves.dtype.names
    has_hw = "board" in names and "channel" in names
    if channels is not None:
        chans = [_parse_channel_selector(c) for c in channels]
    elif has_hw:
        chans = sorted({(int(b), int(c)) for b, c in
                        zip(waves["board"], waves["channel"])})
    else:
        chans = [(0, 0)]
    fig, axes = plt.subplots(len(chans), 1, figsize=(10, 2.6 * len(chans)),
                             sharex=True, squeeze=False)
    for i, bc in enumerate(chans):
        sub_ax = axes[i][0]
        if has_hw:
            ch_waves = waves[(waves["board"] == bc[0])
                             & (waves["channel"] == bc[1])]
        else:
            ch_waves = waves
        sub_ax.set_title(_channel_label(bc), fontsize=9, loc="left")
        if event_index >= len(ch_waves):
            sub_ax.text(0.5, 0.5, "no event", transform=sub_ax.transAxes,
                        ha="center", fontsize=8, color="gray")
            continue
        row = ch_waves[event_index]
        y = np.asarray(row["wave"], dtype=np.float64)
        if "event_length" in names:
            y = y[: int(row["event_length"])]
        sub_ax.plot(y, lw=1.0, color="#36558f")
        baseline = float(row["baseline"]) if "baseline" in names else 0.0
        if baseline:
            sub_ax.axhline(baseline, color="gray", ls="--", lw=0.8,
                           label="baseline")
        if hits is not None:
            hb = _hits_field(hits, "board")
            hc = _hits_field(hits, "channel")
            mask = np.ones(len(_hits_field(hits, "position")), bool)
            if hb is not None:
                mask &= hb == bc[0]
            if hc is not None:
                mask &= hc == bc[1]
            hr = _hits_field(hits, "record_id")
            if hr is not None and "record_id" in names:
                mask &= hr == row["record_id"]
            pos = _hits_field(hits, "position")[mask]
            e0 = _hits_field(hits, "edge_start")
            e1 = _hits_field(hits, "edge_end")
            for j, p in enumerate(pos):
                p = int(p)
                if e0 is not None and e1 is not None:
                    lo = max(0, int(round(float(e0[mask][j]))))
                    hi = min(len(y) - 1, int(round(float(e1[mask][j]))))
                    if hi < lo:
                        lo, hi = hi, lo
                    sub_ax.axvspan(lo, hi, color="red", alpha=0.15, lw=0)
                if 0 <= p < len(y):
                    sub_ax.plot([p], [y[p]], "rx", ms=7)
        sub_ax.set_ylabel("ADC")
    axes[-1][0].set_xlabel("sample index")
    fig.suptitle(f"{title} - Event {event_index}")
    return fig


def create_interactive_browser(context: Any, run_id: str):
    """Return a ``browse(event_index=0)`` closure over a run's
    st_waveforms + hits, for use with ipywidgets.interact in notebooks
    (reference: waveform_visualizer.py:235)."""
    waveforms = context.get_data(run_id, "st_waveforms")
    try:
        hits = context.get_data(run_id, "hit")
    except Exception:  # hit plugin may not be registered
        hits = None
    if hasattr(waveforms, "to_numpy"):
        waveforms = waveforms.to_numpy()
    if hits is not None and hasattr(hits, "to_numpy"):
        hits = hits.to_numpy()

    def browse(event_index: int = 0):
        return plot_waveforms(waveforms, hits=hits,
                              event_index=event_index,
                              title=f"Run {run_id}")

    return browse
