"""Plugin dependency resolution (topological ordering).

Behavioral analog of the reference resolution mixin
(reference: waveform_analysis/core/foundation/mixins.py:56-321): DFS
topo-sort with cycle detection, dynamic dependencies via
``plugin.resolve_depends_on(context, run_id)``, and version-constraint
checks for ``(name, ">=1.0")`` dependency specs.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

try:
    from packaging.specifiers import SpecifierSet
    from packaging.version import Version

    PACKAGING_AVAILABLE = True
except ImportError:  # pragma: no cover
    PACKAGING_AVAILABLE = False


class CircularDependencyError(ValueError):
    pass


class MissingDependencyError(KeyError):
    pass


class VersionConflictError(ValueError):
    pass


def get_plugin_dependencies(
    plugin: Any, context: Any, run_id: Optional[str] = None
) -> List[Any]:
    """Dependency specs for a plugin, honoring dynamic resolve_depends_on."""
    try:
        deps = plugin.resolve_depends_on(context, run_id=run_id)
    except TypeError:
        deps = plugin.resolve_depends_on(context)
    return list(deps or [])


def check_version_constraint(
    dep_name: str, version_spec: Optional[str], provider: Any, consumer: Any
) -> None:
    """Raise VersionConflictError if the provider violates the constraint."""
    if not version_spec or not PACKAGING_AVAILABLE:
        return
    provider_version = getattr(provider, "version", "0.0.0")
    try:
        ok = Version(provider_version) in SpecifierSet(version_spec)
    except Exception:
        logger.warning(
            "Could not evaluate version constraint %r for dependency %s",
            version_spec, dep_name,
        )
        return
    if not ok:
        raise VersionConflictError(
            f"Plugin '{consumer.provides}' requires '{dep_name}{version_spec}', "
            f"but registered version is {provider_version}"
        )


def resolve_dependencies(
    context: Any,
    target: str,
    plugins: Dict[str, Any],
    run_id: Optional[str] = None,
) -> List[str]:
    """Topologically ordered execution plan ending at ``target``.

    Names without a registered plugin are allowed if the context already holds
    that data (manually injected); otherwise MissingDependencyError.
    """
    order: List[str] = []
    done: set = set()
    in_stack: set = set()

    def visit(name: str, chain: List[str]) -> None:
        if name in done:
            return
        if name in in_stack:
            cycle = " -> ".join(chain + [name])
            raise CircularDependencyError(f"Circular dependency detected: {cycle}")
        plugin = plugins.get(name)
        if plugin is None:
            if context is not None and context.has_manual_data(name):
                done.add(name)
                return
            raise MissingDependencyError(
                f"No plugin registered for '{name}' "
                f"(required by: {chain[-1] if chain else 'target'})"
            )
        in_stack.add(name)
        for dep in get_plugin_dependencies(plugin, context, run_id):
            dep_name = plugin.get_dependency_name(dep)
            spec = plugin.get_dependency_version_spec(dep)
            provider = plugins.get(dep_name)
            if provider is not None:
                check_version_constraint(dep_name, spec, provider, plugin)
            visit(dep_name, chain + [name])
        in_stack.discard(name)
        done.add(name)
        order.append(name)

    visit(target, [])
    return order


def collect_downstream(
    data_name: str,
    plugins: Dict[str, Any],
    context: Any = None,
    run_id: Optional[str] = None,
) -> set:
    """Names of all plugins that (transitively) depend on ``data_name``."""
    # build reverse edges
    consumers: Dict[str, set] = {}
    for name, plugin in plugins.items():
        try:
            deps = get_plugin_dependencies(plugin, context, run_id)
        except Exception:
            deps = list(plugin.depends_on or [])
        for dep in deps:
            dep_name = plugin.get_dependency_name(dep)
            consumers.setdefault(dep_name, set()).add(name)

    out: set = set()
    frontier = [data_name]
    while frontier:
        cur = frontier.pop()
        for consumer in consumers.get(cur, ()):
            if consumer not in out:
                out.add(consumer)
                frontier.append(consumer)
    return out
