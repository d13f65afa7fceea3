#!/usr/bin/env python
"""Doc-sync check of the port: fail when the plugin pages the port
generates drift from the committed docs/plugins/.

The twin of scripts/check_doc_sync.py: regenerate the plugin doc pages of
the port's default profile (``cuda``) into a temporary directory and diff
them against the committed pages, both variants by default: the human
pages in docs/plugins/ and the agent pages in docs/plugins/agent/. The
port carries the JAX package's option help word for word, so the pages of
both packages are the same.

    python scripts/check_doc_sync_torch.py [--show-diff]
    python scripts/check_doc_sync_torch.py --docs-dir DIR [--variant agent]

The pages come from specs alone, so the documented Context is built on the
CPU and the check needs no card. Exit 0 when in sync, 1 with a per-file
report otherwise.
"""

from __future__ import annotations

import argparse
import difflib
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

DOCS = Path(__file__).resolve().parent.parent / "docs" / "plugins"


def check_dir(ctx: object, committed: Path, variant: str, show_diff: bool) -> int:
    from waveformanalysis_tpu_torch.utils.plugin_doc_generator import PluginDocGenerator

    if not committed.exists():
        print(f"error: {committed} does not exist; generate docs first", file=sys.stderr)
        return 1

    with tempfile.TemporaryDirectory() as tmp:
        fresh_dir = Path(tmp) / "docs"
        PluginDocGenerator(ctx).generate_all(fresh_dir, variant=variant)
        fresh = {p.name: p.read_text() for p in sorted(fresh_dir.glob("*.md"))}
    old = {p.name: p.read_text() for p in sorted(committed.glob("*.md"))}

    drifted = []
    for name, text in fresh.items():
        if name not in old:
            drifted.append((name, "missing from committed docs"))
        elif old[name] != text:
            drifted.append((name, "content drift"))
    for name in old:
        if name not in fresh:
            drifted.append((name, "stale page (plugin removed?)"))

    if not drifted:
        print(f"doc-sync OK [{variant}]: {len(fresh)} pages match {committed}")
        return 0
    print(f"doc-sync FAILED [{variant}] in {committed}: "
          f"{len(drifted)} page(s) out of date:")
    for name, why in drifted:
        print(f"  {name}: {why}")
        if show_diff and name in old and name in fresh:
            diff = difflib.unified_diff(
                old[name].splitlines(), fresh[name].splitlines(),
                fromfile=f"committed/{name}", tofile=f"generated/{name}", lineterm="",
            )
            for line in list(diff)[:60]:
                print(f"    {line}")
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs-dir", default=None,
                    help="Check ONE directory instead of the default pair")
    ap.add_argument("--variant", default="human", choices=["human", "agent"],
                    help="Variant for --docs-dir single-directory mode")
    ap.add_argument("--show-diff", action="store_true",
                    help="Print unified diffs for drifted pages")
    args = ap.parse_args(argv)

    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.plugins.plugin_sets import get_profile

    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(storage_dir=tmp, config={"show_progress": False, "device": "cpu"})
        ctx.register(*get_profile("cuda"))
        if args.docs_dir is not None:
            return check_dir(ctx, Path(args.docs_dir), args.variant, args.show_diff)
        rc = check_dir(ctx, DOCS, "human", args.show_diff)
        if (DOCS / "agent").exists():
            rc = check_dir(ctx, DOCS / "agent", "agent", args.show_diff) or rc
        return rc


if __name__ == "__main__":
    raise SystemExit(main())
