#!/usr/bin/env python
"""Schema compatibility check of the port: detect breaking output-schema
changes against the committed snapshot.

The twin of scripts/schema_compat_check.py. It snapshots every plugin of
the port's ``cuda`` profile (version, ``spec_hash``, field dtypes) on a CPU
Context, since specs need no card, and compares it with a stored snapshot
by the JAX tool's rules: a removed plugin, a removed or retyped field, or a
changed spec without a version bump fails the check.

    python scripts/schema_compat_check_torch.py
    python scripts/schema_compat_check_torch.py --snapshot other.json [--update]

The default snapshot is the JAX package's ``docs/schema_snapshot.json``,
which this tool never writes: ``--update`` writes the current snapshot to
the path ``--snapshot`` names, and refuses the committed one. Exit 0 when
compatible, 1 with one line per problem otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

COMMITTED = Path(__file__).resolve().parent.parent / "docs" / "schema_snapshot.json"


def snapshot() -> dict:
    """{data name: {"version", "spec_hash", "fields"}} of the ``cuda`` profile."""
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.plugins.plugin_sets import get_profile

    with tempfile.TemporaryDirectory(prefix="wfa_schema_") as tmp:
        ctx = Context(storage_dir=tmp, config={"show_progress": False, "device": "cpu"})
        ctx.register(*get_profile("cuda"))
        out = {}
        for name, plugin in sorted(ctx.plugins.items()):
            spec = plugin._validated_spec
            out[name] = {
                "version": spec.version,
                "spec_hash": spec.spec_hash(),
                "fields": {
                    f.name: f.dtype for f in (
                        spec.output_schema.fields if spec.output_schema else []
                    )
                },
            }
    return out


def compare(old: dict, new: dict) -> list:
    """The JAX tool's rules, problem by problem."""
    problems = []
    for name, old_spec in old.items():
        new_spec = new.get(name)
        if new_spec is None:
            problems.append(f"plugin '{name}' was removed")
            continue
        version_bumped = new_spec["version"] != old_spec["version"]
        for field, dtype in old_spec["fields"].items():
            if field not in new_spec["fields"]:
                if not version_bumped:
                    problems.append(
                        f"{name}: field '{field}' removed without a version bump"
                    )
            elif new_spec["fields"][field] != dtype and not version_bumped:
                problems.append(
                    f"{name}: field '{field}' dtype changed "
                    f"{dtype} -> {new_spec['fields'][field]} without a version bump"
                )
        if new_spec["spec_hash"] != old_spec["spec_hash"] and not version_bumped:
            problems.append(
                f"{name}: spec changed (hash {old_spec['spec_hash']} -> "
                f"{new_spec['spec_hash']}) without a version bump"
            )
    return problems


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--snapshot", default=str(COMMITTED))
    p.add_argument("--update", action="store_true",
                   help="Write the current schemas to --snapshot (not the committed file)")
    args = p.parse_args(argv)

    snap_path = Path(args.snapshot)
    if args.update and snap_path.resolve() == COMMITTED:
        print(f"error: refusing to write {COMMITTED}, the JAX package's snapshot; "
              "pass --snapshot PATH", file=sys.stderr)
        return 2
    current = snapshot()
    if args.update:
        snap_path.parent.mkdir(parents=True, exist_ok=True)
        with open(snap_path, "w") as fh:
            json.dump(current, fh, indent=2, sort_keys=True)
        print(f"snapshot written to {snap_path} ({len(current)} plugins)")
        return 0
    if not snap_path.exists():
        print(f"error: {snap_path} does not exist (write one with --update)", file=sys.stderr)
        return 1

    with open(snap_path) as fh:
        stored = json.load(fh)
    problems = compare(stored, current)
    if problems:
        print("SCHEMA COMPATIBILITY PROBLEMS:")
        for line in problems:
            print(" ", line)
        return 1
    print(f"schemas compatible ({len(current)} plugins)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
