"""Per-plugin documentation coverage + spec-quality reporting.

Behavioral analog of the reference doc-coverage checker
(reference: waveform_analysis/utils/doc_coverage.py:83 DocCoverageChecker):
beyond the drift check in ``plugin_doc_generator.check_doc_coverage``, this
grades every registered plugin's self-description quality and produces a
thresholded report the CI docs job can gate on:

- page coverage: every ``provides`` name must have an up-to-date page
  (missing or stale page = error);
- spec quality: missing description/docstring, missing-or-placeholder
  version, options without help text, and a missing output schema are
  warnings (errors under ``--strict``).

Use via ``waveform-docs coverage`` (see utils/cli_docs.py) or directly::

    checker = DocCoverageChecker(ctx, "docs/plugins")
    report = checker.check()
    print(report.format())
    sys.exit(0 if report.gate(min_coverage=100.0) else 1)

Port of ``waveformanalysis_tpu/utils/doc_coverage.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, List, Union

SEV_ERROR = "error"
SEV_WARNING = "warning"


@dataclass(frozen=True)
class SpecIssue:
    """One graded finding about a plugin's docs or self-description."""

    data_name: str
    plugin_class: str
    severity: str  # SEV_ERROR | SEV_WARNING
    message: str
    category: str  # "page" | "spec"


@dataclass
class DocCoverageReport:
    total_plugins: int
    pages_ok: int
    coverage_percent: float
    issues: List[SpecIssue] = field(default_factory=list)

    @property
    def errors(self) -> List[SpecIssue]:
        return [i for i in self.issues if i.severity == SEV_ERROR]

    @property
    def warnings(self) -> List[SpecIssue]:
        return [i for i in self.issues if i.severity == SEV_WARNING]

    @property
    def passed(self) -> bool:
        return not self.errors

    def gate(self, min_coverage: float = 100.0, strict: bool = False) -> bool:
        """CI gate: page errors always fail; coverage below the threshold
        fails; ``strict`` also fails on spec-quality warnings."""
        if not self.passed:
            return False
        if self.coverage_percent < min_coverage:
            return False
        if strict and self.warnings:
            return False
        return True

    def format(self, verbose: bool = True) -> str:
        lines = [
            "plugin doc coverage: "
            f"{self.pages_ok}/{self.total_plugins} pages current "
            f"({self.coverage_percent:.1f}%) — "
            f"{len(self.errors)} error(s), {len(self.warnings)} warning(s)",
        ]
        if verbose:
            for issue in self.issues:
                lines.append(
                    f"  {issue.severity:7s} [{issue.category}] "
                    f"{issue.data_name} ({issue.plugin_class}): "
                    f"{issue.message}"
                )
        return "\n".join(lines)


class DocCoverageChecker:
    """Grades doc pages + plugin self-description for a live Context."""

    # versions that mean "nobody set one"
    _PLACEHOLDER_VERSIONS = ("", "0.0.0", None)

    def __init__(self, context: Any, doc_dir: Union[str, Path],
                 variant: str = "human") -> None:
        self.context = context
        self.doc_dir = Path(doc_dir)
        self.variant = variant

    def check(self, require_spec_quality: bool = True) -> DocCoverageReport:
        from waveformanalysis_tpu_torch.utils.plugin_doc_generator import (
            PluginDocGenerator,
        )

        gen = PluginDocGenerator(self.context)
        issues: List[SpecIssue] = []
        names = sorted(self.context.plugins)
        pages_ok = 0
        for name in names:
            plugin = self.context._plugins[name]
            cls_name = type(plugin).__name__
            page = self.doc_dir / f"{name}.md"
            if not page.exists():
                issues.append(SpecIssue(
                    name, cls_name, SEV_ERROR,
                    f"no documentation page ({page})", "page",
                ))
            elif page.read_text() != gen.render_plugin(
                name, variant=self.variant
            ):
                issues.append(SpecIssue(
                    name, cls_name, SEV_ERROR,
                    "documentation page is stale (regenerate with "
                    "`waveform-docs generate`)", "page",
                ))
            else:
                pages_ok += 1
            if require_spec_quality:
                issues.extend(self._spec_quality(name, plugin))

        total = len(names)
        coverage = (pages_ok / total * 100.0) if total else 100.0
        return DocCoverageReport(
            total_plugins=total, pages_ok=pages_ok,
            coverage_percent=coverage, issues=issues,
        )

    def _spec_quality(self, name: str, plugin: Any) -> List[SpecIssue]:
        cls = type(plugin)
        issues: List[SpecIssue] = []

        def warn(message: str) -> None:
            issues.append(SpecIssue(name, cls.__name__, SEV_WARNING,
                                    message, "spec"))

        if not getattr(plugin, "description", "") and not cls.__doc__:
            warn("no description attribute and no class docstring")
        if getattr(plugin, "version", None) in self._PLACEHOLDER_VERSIONS:
            warn("missing or placeholder version")
        for opt_name, opt in (getattr(plugin, "options", {}) or {}).items():
            if not getattr(opt, "help", ""):
                warn(f"option {opt_name!r} has no help text")
        if getattr(plugin, "output_dtype", None) is None and \
                getattr(plugin, "output_kind", "static") == "static":
            warn("no output_dtype declared")
        return issues
