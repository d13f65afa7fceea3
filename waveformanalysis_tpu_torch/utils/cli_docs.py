"""waveform-docs CLI: generate and check plugin documentation.

Behavioral analog of the reference docs CLI
(reference: waveform_analysis/utils/cli_docs.py): generate human/agent
markdown pages for the registered profile and check doc-coverage drift
(CI-enforceable via exit code).

Port of ``waveformanalysis_tpu/utils/cli_docs.py``, run as
``python -m waveformanalysis_tpu_torch.utils.cli_docs``. The documented
Context runs on ``--device`` (default ``cuda``; raises without a card), and
``--profile`` takes the port's profile names (default ``cuda``).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from waveformanalysis_tpu_torch.plugins.plugin_sets import PROFILES, get_profile


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="waveform-docs",
        description="Generate / check plugin documentation",
    )
    p.add_argument("--out-dir", default="docs/plugins",
                   help="Documentation output directory")
    p.add_argument("--profile", default="cuda", choices=sorted(PROFILES),
                   help="Plugin profile to document")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device of the documented Context (default cuda; "
                        "raises when no card is present, never falls back)")
    p.add_argument("--variant", default="human", choices=["human", "agent"],
                   help="Documentation style")
    sub = p.add_subparsers(dest="command", required=True)
    sub.add_parser("generate", help="Write documentation pages")
    sub.add_parser("check", help="Fail when docs drift from the code")
    cov = sub.add_parser(
        "coverage",
        help="Graded per-plugin doc-coverage + spec-quality report",
    )
    cov.add_argument("--min-coverage", type=float, default=100.0,
                     help="Fail below this page-coverage percent")
    cov.add_argument("--strict", action="store_true",
                     help="Treat spec-quality warnings as failures")
    cov.add_argument("--quiet", action="store_true",
                     help="Summary line only")
    show = sub.add_parser("show", help="Print one plugin's page")
    show.add_argument("data_name")
    return p


def _make_context(profile: str, device: str = "cuda"):
    import tempfile

    from waveformanalysis_tpu_torch.context.context import Context

    ctx = Context(storage_dir=tempfile.mkdtemp(prefix="wfa_docs_"),
                  config={"show_progress": False, "device": device})
    ctx.register(*get_profile(profile))
    return ctx


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from waveformanalysis_tpu_torch.utils.plugin_doc_generator import (
        PluginDocGenerator,
        check_doc_coverage,
    )

    ctx = _make_context(args.profile, args.device)

    if args.command == "generate":
        gen = PluginDocGenerator(ctx)
        written = gen.generate_all(args.out_dir, variant=args.variant)
        print(f"wrote {len(written)} pages to {args.out_dir}")
        return 0

    if args.command == "check":
        report = check_doc_coverage(ctx, args.out_dir, variant=args.variant)
        print(f"ok: {len(report['ok'])}, stale: {len(report['stale'])}, "
              f"missing: {len(report['missing'])}")
        for name in report["missing"]:
            print(f"  missing: {name}")
        for name in report["stale"]:
            print(f"  stale:   {name}")
        return 0 if report["is_complete"] else 1

    if args.command == "coverage":
        from waveformanalysis_tpu_torch.utils.doc_coverage import DocCoverageChecker

        report = DocCoverageChecker(
            ctx, args.out_dir, variant=args.variant
        ).check()
        print(report.format(verbose=not args.quiet))
        ok = report.gate(min_coverage=args.min_coverage, strict=args.strict)
        return 0 if ok else 1

    if args.command == "show":
        gen = PluginDocGenerator(ctx)
        try:
            print(gen.render_plugin(args.data_name, variant=args.variant))
        except KeyError:
            print(f"error: no plugin registered for {args.data_name!r}; "
                  f"known: {', '.join(sorted(ctx.plugins))}", file=sys.stderr)
            return 1
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())
