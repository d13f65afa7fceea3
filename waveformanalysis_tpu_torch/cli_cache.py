"""waveform-cache CLI: inspect and maintain the pipeline cache.

Behavioral analog of the reference cache CLI
(reference: waveform_analysis/cli_cache.py:12-300): info / stats / list /
diagnose / clean subcommands over the cache-ops suite.

Port of ``waveformanalysis_tpu/cli_cache.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="waveform-cache",
        description="Inspect and maintain the waveform pipeline cache",
    )
    p.add_argument("--storage-dir", default=None, help="Cache storage directory")
    p.add_argument("--run-name", default=None, help="Restrict to one run")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--json", action="store_true", help="JSON output")
    # accept the global flags after the subcommand too (the natural CLI
    # habit); SUPPRESS so an absent subcommand-level flag never clobbers a
    # value given before the subcommand
    common.add_argument("--storage-dir", dest="storage_dir",
                        default=argparse.SUPPRESS, help=argparse.SUPPRESS)
    common.add_argument("--run-name", dest="run_name",
                        default=argparse.SUPPRESS, help=argparse.SUPPRESS)
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("info", help="Cache summary", parents=[common])
    sub.add_parser("stats", help="Alias of info (reference parity)", parents=[common])
    sub.add_parser("list", help="List cache entries", parents=[common])
    sub.add_parser("diagnose", help="Orphans / corruption / version mismatches",
                   parents=[common])

    clean = sub.add_parser("clean", help="Delete cache entries by policy",
                           parents=[common])
    clean.add_argument("--max-age-hours", type=float, default=None,
                       help="Delete entries older than this")
    clean.add_argument("--max-total-mb", type=float, default=None,
                       help="Evict oldest entries beyond this budget")
    clean.add_argument("--storage-version", default=None,
                       help="Delete entries whose version differs")
    clean.add_argument("--failed-integrity", action="store_true",
                       help="Delete entries failing checksum verification")
    clean.add_argument("--all", action="store_true",
                       help="Delete every entry (for the selected run)")
    clean.add_argument("--dry-run", action="store_true",
                       help="Preview without deleting")
    clean.add_argument("--yes", action="store_true",
                       help="Skip the confirmation prompt")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.storage_dir:
        parser.error("--storage-dir is required")

    from waveformanalysis_tpu_torch.storage.cache_ops import (
        CacheAnalyzer,
        CacheCleaner,
        CacheDiagnostics,
        CleanPlan,
    )
    from waveformanalysis_tpu_torch.storage.memmap import MemmapStorage

    storage = MemmapStorage(args.storage_dir)
    run_id = args.run_name

    if args.command in ("info", "stats"):
        analyzer = CacheAnalyzer(storage)
        if args.json:
            print(json.dumps(analyzer.summary(run_id), indent=2))
        else:
            s = analyzer.summary(run_id)
            print(f"entries: {s['n_entries']}")
            print(f"total:   {s['total_mb']:.2f} MB")
            for run, size in sorted(s["by_run_bytes"].items()):
                print(f"  {run or '(no run)'}: {size / 1e6:.2f} MB")
        return 0

    if args.command == "list":
        analyzer = CacheAnalyzer(storage)
        if args.json:
            print(json.dumps([e.to_dict() for e in analyzer.scan(run_id)], indent=2))
        else:
            print(analyzer.report(run_id))
        return 0

    if args.command == "diagnose":
        report = CacheDiagnostics(storage).diagnose(run_id)
        if args.json:
            print(json.dumps(report, indent=2))
        else:
            print(f"healthy entries:   {report['healthy']}")
            print(f"orphan payloads:   {len(report['orphan_payloads'])}")
            print(f"orphan metadata:   {len(report['orphan_metadata'])}")
            print(f"corrupt:           {len(report['corrupt'])}")
            print(f"version mismatch:  {len(report['version_mismatch'])}")
            print("status:", "OK" if report["is_healthy"] else "ISSUES FOUND")
        return 0 if report["is_healthy"] else 1

    if args.command == "clean":
        cleaner = CacheCleaner(storage)
        if args.all:
            entries = cleaner.analyzer.scan(run_id)
            plan = CleanPlan(to_delete=entries,
                             reasons={e.key: "--all" for e in entries})
        else:
            policy = {}
            if args.max_age_hours is not None:
                policy["max_age_s"] = args.max_age_hours * 3600
            if args.max_total_mb is not None:
                policy["max_total_bytes"] = int(args.max_total_mb * 1e6)
            if args.storage_version is not None:
                policy["storage_version"] = args.storage_version
            if args.failed_integrity:
                policy["failed_integrity"] = True
            if not policy:
                print("error: specify a clean policy (or --all)", file=sys.stderr)
                return 2
            plan = cleaner.plan(run_id=run_id, **policy)

        print(plan.preview())
        if args.dry_run:
            return 0
        if not args.yes and plan.to_delete:
            answer = input(f"Delete {len(plan.to_delete)} entries? [y/N] ")
            if answer.strip().lower() not in ("y", "yes"):
                print("aborted")
                return 1
        n = cleaner.execute(plan)
        print(f"deleted {n} entries")
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())
