"""cache_analysis plugin: cache introspection as a plugin.

Behavioral analog of the reference CacheAnalysisPlugin
(reference: waveform_analysis/core/plugins/builtin/cpu/cache_analysis.py:125):
scans the context's storage and returns an analysis report dict; never
persisted (it describes the cache, it should not live in it).

Port of ``waveformanalysis_tpu/plugins/builtin/cache_analysis.py``.
"""

from __future__ import annotations

from typing import Any, Dict

from waveformanalysis_tpu_torch.plugins.base import Option, Plugin
from waveformanalysis_tpu_torch.storage.cache_ops import CacheAnalyzer, CacheDiagnostics


class CacheAnalysisPlugin(Plugin):
    """Analyze the context's cache for one run."""

    provides = "cache_analysis"
    depends_on = []
    description = "Scan and summarize the cache entries for this run."
    version = "1.0.0"
    save_when = "never"
    is_side_effect = True
    options = {
        "include_diagnostics": Option(
            default=True, type=bool,
            help="Also run orphan/integrity diagnostics",
        ),
        "all_runs": Option(
            default=False, type=bool,
            help="Analyze every run in the storage, not just this one",
        ),
    }

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> Dict[str, Any]:
        if hasattr(context, "flush_saves"):
            context.flush_saves()  # the scan inspects cache files directly
        target_run = None if context.get_config(self, "all_runs") else run_id
        analyzer = CacheAnalyzer(context.storage)
        report: Dict[str, Any] = {
            "run_id": run_id,
            "summary": analyzer.summary(target_run),
            "entries": [e.to_dict() for e in analyzer.scan(target_run)],
            "runtime_stats": context.cache_stats(),
        }
        if context.get_config(self, "include_diagnostics"):
            report["diagnostics"] = CacheDiagnostics(
                context.storage
            ).diagnose(target_run)
        return report
