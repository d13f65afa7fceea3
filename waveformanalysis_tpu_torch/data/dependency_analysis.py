"""Dependency-graph analysis: critical paths, parallel groups, bottlenecks.

Behavioral analog of the reference DependencyAnalyzer
(reference: waveform_analysis/core/data/dependency_analysis.py:245-787):
walks a target's dependency graph, merges per-plugin execution statistics,
and reports the critical (slowest) path, levels that could run concurrently,
and bottleneck plugins; exports dict/markdown.

Port of ``waveformanalysis_tpu/data/dependency_analysis.py``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from waveformanalysis_tpu_torch.context.resolution import get_plugin_dependencies

logger = logging.getLogger(__name__)


@dataclass
class DependencyAnalysisResult:
    target: str
    plan: List[str]
    edges: Dict[str, List[str]]  # node -> its dependencies
    levels: List[List[str]]  # parallelizable groups (topological levels)
    critical_path: List[str]
    critical_path_s: float
    durations: Dict[str, float]
    bottlenecks: List[Tuple[str, float]]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "target": self.target,
            "plan": self.plan,
            "edges": self.edges,
            "levels": self.levels,
            "critical_path": self.critical_path,
            "critical_path_s": self.critical_path_s,
            "durations": self.durations,
            "bottlenecks": self.bottlenecks,
        }

    def summary(self) -> str:
        lines = [
            f"Dependency analysis for '{self.target}'",
            f"  plan ({len(self.plan)}): {' -> '.join(self.plan)}",
            f"  parallel levels: {len(self.levels)}",
        ]
        for i, level in enumerate(self.levels):
            lines.append(f"    level {i}: {', '.join(level)}")
        if self.critical_path:
            lines.append(
                f"  critical path ({self.critical_path_s:.4f}s): "
                f"{' -> '.join(self.critical_path)}"
            )
        if self.bottlenecks:
            lines.append("  bottlenecks:")
            for name, frac in self.bottlenecks:
                lines.append(f"    {name}: {frac * 100:.1f}% of total time")
        return "\n".join(lines)

    def to_markdown(self, path: Optional[str] = None) -> str:
        lines = [
            f"# Dependency analysis: `{self.target}`",
            "",
            "## Execution plan",
            "",
        ]
        lines += [f"{i+1}. `{name}` ({self.durations.get(name, 0):.4f}s)"
                  for i, name in enumerate(self.plan)]
        lines += ["", "## Parallelizable levels", ""]
        for i, level in enumerate(self.levels):
            lines.append(f"- level {i}: " + ", ".join(f"`{n}`" for n in level))
        lines += ["", "## Critical path", "",
                  " -> ".join(f"`{n}`" for n in self.critical_path)
                  + f" ({self.critical_path_s:.4f}s)"]
        text = "\n".join(lines)
        if path:
            with open(path, "w") as fh:
                fh.write(text)
        return text


class DependencyAnalyzer:
    """Analyzes a Context's plugin graph, optionally with runtime stats."""

    def __init__(self, context: Any) -> None:
        self.ctx = context

    def analyze(
        self,
        target_name: str,
        include_performance: bool = True,
        run_id: Optional[str] = None,
    ) -> DependencyAnalysisResult:
        plan = self.ctx.execution_domain.resolve_execution_plan(target_name, run_id)
        edges: Dict[str, List[str]] = {}
        for name in plan:
            plugin = self.ctx.get_plugin(name)
            if plugin is None:
                edges[name] = []
                continue
            deps = get_plugin_dependencies(plugin, self.ctx, run_id)
            edges[name] = [
                plugin.get_dependency_name(d) for d in deps
                if plugin.get_dependency_name(d) in plan
            ]

        levels = self._levels(plan, edges)
        durations = self._durations(plan) if include_performance else {}
        critical, critical_s = self._critical_path(target_name, edges, durations)
        total = sum(durations.values())
        bottlenecks = sorted(
            ((n, d / total) for n, d in durations.items() if total > 0),
            key=lambda kv: -kv[1],
        )[:3]
        return DependencyAnalysisResult(
            target=target_name, plan=plan, edges=edges, levels=levels,
            critical_path=critical, critical_path_s=critical_s,
            durations=durations, bottlenecks=bottlenecks,
        )

    def _levels(self, plan: List[str], edges: Dict[str, List[str]]) -> List[List[str]]:
        level_of: Dict[str, int] = {}
        for name in plan:  # plan is topologically ordered
            deps = edges.get(name, [])
            level_of[name] = (max((level_of[d] for d in deps), default=-1)) + 1
        levels: List[List[str]] = []
        for name, lvl in level_of.items():
            while len(levels) <= lvl:
                levels.append([])
            levels[lvl].append(name)
        return levels

    def _durations(self, plan: List[str]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        stats = self.ctx.stats.get_statistics() if self.ctx.stats.enabled else {}
        for name in plan:
            st = stats.get(name)
            if st is not None and st.n_executions:
                out[name] = st.avg_duration_s
                continue
            prof = self.ctx.profiler.get(f"plugin.{name}.compute")
            out[name] = prof["avg_s"] if prof else 0.0
        return out

    def _critical_path(
        self, target: str, edges: Dict[str, List[str]], durations: Dict[str, float]
    ) -> Tuple[List[str], float]:
        memo: Dict[str, Tuple[float, List[str]]] = {}

        def longest(name: str) -> Tuple[float, List[str]]:
            if name in memo:
                return memo[name]
            deps = edges.get(name, [])
            best_cost, best_path = 0.0, []
            for d in deps:
                cost, path = longest(d)
                if cost >= best_cost:
                    best_cost, best_path = cost, path
            result = (best_cost + durations.get(name, 0.0), best_path + [name])
            memo[name] = result
            return result

        cost, path = longest(target)
        return path, cost
