#!/usr/bin/env python
"""Change-impact assessor of the port: which data names and caches a change
to a plugin or to a source file of the port touches.

The twin of scripts/assess_change_impact.py: given plugin data names or
port source files, report every downstream data name whose lineage, and so
whose cache key, changes, and with ``--storage-dir`` and ``--run-id`` the
cache entries on disk that the change leaves stale.

    python scripts/assess_change_impact_torch.py hit basic_features
    python scripts/assess_change_impact_torch.py --file waveformanalysis_tpu_torch/ops/peaks.py
    python scripts/assess_change_impact_torch.py --file waveformanalysis_tpu_torch/csrc/width_scan.cu
    python scripts/assess_change_impact_torch.py hit --storage-dir ./data --run-id run42 \
        --config-json '{"data_root": "./DAQ", "daq_adapter": "vx2730"}'

A Python file maps to the plugins of the ``cuda`` profile whose module
(or a base class's) is that file or imports it, lazy imports inside
functions included, or that reach it through ``ops/`` modules; from a
kernel wrapper (``ops/*_cuda.py``) only its imports of other wrappers are
followed, not its plain fallbacks. A CUDA source (``csrc/*.cu``) maps
through the wrapper that builds it (its ``_scan_library("<name>", ...)``
call) to the plugins that reach that wrapper from their own module or from
an ``ops/`` module that is not a wrapper; a header (``csrc/*.cuh``) maps
through every source that includes it. A wrapper that builds several
sources maps each of them to every plugin that reaches it. Specs and
lineage keys do not depend on the device, so the Context is built on the
CPU and the tool needs no card; a run's cache keys depend on its Context
config, so ``--config-json`` takes the config the run was computed with
(data_root, daq_adapter, ...).
"""

from __future__ import annotations

import argparse
import ast
import inspect
import json
import re
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

PKG = "waveformanalysis_tpu_torch"
CSRC = REPO / PKG / "csrc"
OPS = REPO / PKG / "ops"


def module_file(name: str) -> Path | None:
    """The source file of a module of the port, or None."""
    if name != PKG and not name.startswith(PKG + "."):
        return None
    base = REPO.joinpath(*name.split("."))
    for cand in (base.with_suffix(".py"), base / "__init__.py"):
        if cand.is_file():
            return cand.resolve()
    return None


def imported_files(path: Path) -> set:
    """The port's module files that ``path`` imports anywhere in its code."""
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return {f for f in map(module_file, names) if f is not None and f != path}


def is_wrapper(path: Path) -> bool:
    return path.parent == OPS.resolve() and path.name.endswith("_cuda.py")


def built_sources(wrapper: Path) -> set:
    """The ``csrc/*.cu`` files a wrapper builds, with the headers they include."""
    names = re.findall(r'_scan_library\(\s*"(\w+)"', wrapper.read_text())
    out = set()
    todo = [(CSRC / f"{n}.cu").resolve() for n in names]
    while todo:
        src = todo.pop()
        if src in out or not src.is_file():
            continue
        out.add(src)
        todo += [(CSRC / h).resolve()
                 for h in re.findall(r'#include\s+"([\w.]+)"', src.read_text())]
    return out


def backing_files(plugin) -> set:
    """Every file whose change reaches ``plugin``'s outputs (see the module
    docstring for the rules)."""
    files = set()
    for cls in type(plugin).__mro__:
        if cls.__module__.split(".")[0] != PKG:
            continue
        try:
            files.add(Path(inspect.getfile(cls)).resolve())
        except TypeError:
            continue
    reached = set()
    for f in list(files):
        reached |= imported_files(f)
    kernels = {f for f in reached if is_wrapper(f)}
    todo = [f for f in reached if f.parent == OPS.resolve()]
    while todo:
        f = todo.pop()
        for g in imported_files(f):
            if is_wrapper(f) and not is_wrapper(g):
                continue  # a wrapper's plain fallback, not what it launches
            if is_wrapper(g) and not is_wrapper(f):
                kernels.add(g)
            if g.parent == OPS.resolve() and g not in reached:
                todo.append(g)
            reached.add(g)
    files |= reached
    for w in kernels:
        files |= built_sources(w)
    return files


def plugins_for_file(ctx, path: str) -> list:
    """Map a source file of the port to the registered plugins it backs."""
    target = Path(path).resolve()
    return sorted(name for name, plugin in ctx.plugins.items()
                  if target in backing_files(plugin))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("plugins", nargs="*", help="changed plugin data names")
    ap.add_argument("--file", action="append", default=[],
                    help="changed source file (mapped to plugins)")
    ap.add_argument("--storage-dir", help="inspect on-disk caches here")
    ap.add_argument("--run-id", help="run to check cache entries for")
    ap.add_argument("--config-json", default="{}",
                    help="Context config of the run, as a JSON object")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.context.resolution import collect_downstream
    from waveformanalysis_tpu_torch.plugins.plugin_sets import get_profile

    config = {"show_progress": False, **json.loads(args.config_json), "device": "cpu"}
    ctx = Context(storage_dir=args.storage_dir or tempfile.mkdtemp(prefix="wfa_impact_"),
                  config=config)
    ctx.register(*get_profile("cuda"))

    changed = list(args.plugins)
    for f in args.file:
        mapped = plugins_for_file(ctx, f)
        if not mapped:
            print(f"warning: {f} maps to no registered plugin", file=sys.stderr)
        changed.extend(mapped)
    changed = sorted(set(changed))
    unknown = [c for c in changed if c not in ctx.plugins]
    if unknown:
        print(f"error: unknown plugin(s): {unknown}", file=sys.stderr)
        return 2
    if not changed:
        ap.print_help()
        return 2

    impacted = set(changed)
    for name in changed:
        impacted |= set(collect_downstream(name, ctx.plugins, context=ctx))

    report = {
        "changed": changed,
        "impacted": sorted(impacted),
        "unaffected": sorted(set(ctx.plugins) - impacted),
    }

    if args.storage_dir and args.run_id:
        stale = []
        for name in sorted(impacted):
            try:
                key = ctx.key_for(args.run_id, name)
            except Exception:
                continue
            if ctx.storage.exists(key, args.run_id):
                stale.append({"data_name": name, "key": key})
        report["stale_cache_entries"] = stale

    if args.as_json:
        print(json.dumps(report, indent=2))
    else:
        print(f"changed:    {', '.join(report['changed'])}")
        print(f"impacted:   {', '.join(report['impacted'])}")
        print(f"unaffected: {', '.join(report['unaffected'])}")
        for e in report.get("stale_cache_entries", []):
            print(f"stale cache: {e['data_name']} ({e['key']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
