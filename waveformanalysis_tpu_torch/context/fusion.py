"""Fused subgraph execution: several plugins in ONE device program.

Port of ``waveformanalysis_tpu/context/fusion.py`` (the single-run path).
The reference executes its plugin DAG strictly one plugin at a time, each
materializing its output before the next starts
(reference: waveform_analysis/core/context_execution.py:293-475). Here, when
the needed set of an execution plan contains several wave-derived plugins
that share the same wave source, their ``device_stage`` programs run as one
program on the Context's device: the wave matrix is copied to the device
once, every stage reads it there, slot tables are compacted on the device,
and the host copies back only the valid rows and the dense per-event
leaves.

Correctness contract: fusion is a pure execution strategy. Each member
plugin's ``kernel_config`` / ``host_prep`` / ``device_stage`` / ``finalize``
phases are exactly the ones its standalone ``compute`` runs, so outputs are
bit-identical, lineage/cache keys are untouched, and save_when semantics
apply per plugin as usual (tests/test_torch_context_route.py asserts it).

Not ported yet (ROADMAP.md): the batched multi-run path, the sticky
slot-capacity hints (outputs do not depend on them), the sharded path.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import to_device
from waveformanalysis_tpu_torch.ops.compact import (
    compact_slots,
    decode_slot_matrix,
    field_dtypes,
)

logger = logging.getLogger(__name__)

# members whose device_stage runs inside the one device program (they sweep
# the wave matrix); waveform_width consumes the hit member's peak slots on
# the device
FUSED_DEVICE_MEMBERS = (
    "basic_features", "hit", "hit_threshold", "waveform_width_integral",
    "waveform_width",
)
# members computed on host INSIDE the bundle from other members' finalized
# tables (hits are orders of magnitude fewer than samples, so these are
# bandwidth-trivial; running them in the bundle removes their standalone
# round trips and re-reads)
FUSED_HOST_MEMBERS = (
    "hit_merge_clusters", "hit_merged", "hit_merged_components", "s1_s2",
)
FUSED_CHAIN_MEMBERS = FUSED_DEVICE_MEMBERS + FUSED_HOST_MEMBERS

# members whose device stage emits fixed-capacity (n, K) slot tables; the
# fused program compacts valid slots on the device so the host copy carries
# only real hits, not the K-slot padding. Fields are packed in this order.
_SLOT_FIELDS = {
    "hit": ("position", "peak_heights", "left_ips", "right_ips"),
    "hit_threshold": (
        "position", "height", "integral", "seg_start", "seg_end",
        "run_start", "run_end",
    ),
    "waveform_width": (
        "position", "rise_samples", "fall_samples", "total_samples",
        "peak_height", "width_valid",
    ),
}
# (count key, capacity cfg key) of each member's overflow counter
# (waveform_width has none: its rows mirror the hit member's slots, whose
# counter already reports capacity overflow)
_SLOT_OVERFLOW = {
    "hit": ("n_candidates", "max_peaks"),
    "hit_threshold": ("n_runs", "max_hits"),
}


class WaveChainFusion:
    """Fuses basic_features / hit / hit_threshold over a shared wave source."""

    name = "wave_chain"

    # -- applicability -------------------------------------------------------

    @staticmethod
    def _expected_classes() -> Dict[str, Any]:
        from waveformanalysis_tpu_torch.plugins.builtin.basic_features import (
            BasicFeaturesPlugin,
        )
        from waveformanalysis_tpu_torch.plugins.builtin.hit_finder import (
            ThresholdHitPlugin,
        )
        from waveformanalysis_tpu_torch.plugins.builtin.hit_merge import (
            HitMergeClustersPlugin,
            HitMergedComponentsPlugin,
            HitMergePlugin,
        )
        from waveformanalysis_tpu_torch.plugins.builtin.peak_finding import (
            HitFinderPlugin,
        )
        from waveformanalysis_tpu_torch.plugins.builtin.s1_s2_classifier import (
            S1S2ClassifierPlugin,
        )
        from waveformanalysis_tpu_torch.plugins.builtin.waveform_width import (
            WaveformWidthPlugin,
        )
        from waveformanalysis_tpu_torch.plugins.builtin.waveform_width_integral import (
            WaveformWidthIntegralPlugin,
        )

        return {
            "basic_features": BasicFeaturesPlugin,
            "hit": HitFinderPlugin,
            "hit_threshold": ThresholdHitPlugin,
            "waveform_width_integral": WaveformWidthIntegralPlugin,
            "waveform_width": WaveformWidthPlugin,
            "hit_merged": HitMergePlugin,
            "hit_merge_clusters": HitMergeClustersPlugin,
            "hit_merged_components": HitMergedComponentsPlugin,
            "s1_s2": S1S2ClassifierPlugin,
        }

    @staticmethod
    def _is_builtin(ctx: Any, name: str, expected: Dict[str, Any]) -> bool:
        """Only the builtin implementations are fusable: a subclass with its
        own compute must run through the normal path."""
        plugin = ctx._plugins.get(name)
        return (plugin is not None
                and type(plugin).compute is expected[name].compute)

    @staticmethod
    def _member_source(ctx: Any, name: str) -> Optional[str]:
        """Wave-source data name a device member's kernels read."""
        from waveformanalysis_tpu_torch.plugins.builtin._wave_source import (
            resolve_wave_input_spec,
        )

        plugin = ctx._plugins[name]
        try:
            if name == "waveform_width":
                return plugin.expected_wave_source(ctx)
            spec = resolve_wave_input_spec(ctx, plugin)
            if spec.is_records:
                # two records-source members may still read DIFFERENT
                # pools (use_filtered -> wave_pool_filtered); a fused
                # bundle uploads one wave matrix, so the pool is part of
                # the source identity
                return f"records:{spec.wave_pool_name}"
            return spec.expected_name
        except Exception:
            return None

    def plan(
        self, ctx: Any, run_id: str, needed: set, min_members: int = 2
    ) -> Optional[List[str]]:
        """Member names this rule can produce in one dispatch, or None.

        Device members must share ONE wave source (the bundle uploads one
        wave matrix); when their sources differ, the largest same-source
        group wins and the rest run standalone. Host members join when
        their inputs are bundle members or already cache-valid:

        - waveform_width additionally needs a usable hit stage over the same
          source — as a bundle member, or recomputed as an unemitted support
          stage when hit is cache-valid (deterministic device program + same
          lineage => identical positions);
        - s1_s2 needs waveform_width in the bundle and basic_features in the
          bundle or cached;
        - the hit_merge family needs hit_threshold in the bundle or cached.
        """
        expected = self._expected_classes()
        members = [m for m in FUSED_CHAIN_MEMBERS if m in needed]
        if len(members) < min_members:
            return None

        # -- device members: group by wave source, keep the largest group --
        by_source: Dict[str, List[str]] = {}
        for m in members:
            if m not in FUSED_DEVICE_MEMBERS:
                continue
            if not self._is_builtin(ctx, m, expected):
                continue
            src = self._member_source(ctx, m)
            if src is not None:
                by_source.setdefault(src, []).append(m)
        if not by_source:
            return None
        source, device = max(
            by_source.items(), key=lambda kv: (len(kv[1]),
                                               kv[0].startswith("records"))
        )

        # waveform_width needs the hit stage over the bundle's source
        if "waveform_width" in device:
            hit_ok = (
                self._is_builtin(ctx, "hit", expected)
                and self._member_source(ctx, "hit") == source
                and ("hit" in device
                     or ctx.cache_domain.is_cache_hit(run_id, "hit"))
            )
            if not hit_ok:
                device = [m for m in device if m != "waveform_width"]
        if not device:
            return None

        # -- host members ---------------------------------------------------
        def available(name: str) -> bool:
            return name in device or ctx.cache_domain.is_cache_hit(
                run_id, name
            )

        host: List[str] = []
        for m in members:
            if m not in FUSED_HOST_MEMBERS:
                continue
            if not self._is_builtin(ctx, m, expected):
                continue
            if m == "s1_s2":
                if available("waveform_width") and available("basic_features"):
                    host.append(m)
            elif available("hit_threshold"):
                host.append(m)

        usable = [m for m in FUSED_CHAIN_MEMBERS if m in device or m in host]
        if len(usable) < min_members:
            return None
        return usable

    # -- execution -----------------------------------------------------------

    def compute(self, ctx: Any, run_id: str, members: List[str]) -> Dict[str, Any]:
        """Run the fused program; returns {data_name: finalized result}."""
        from waveformanalysis_tpu_torch.plugins.builtin.peak_finding import (
            _load_wave_matrix,
        )

        device_members = [m for m in members if m in FUSED_DEVICE_MEMBERS]
        host_members = [m for m in members if m in FUSED_HOST_MEMBERS]
        plugins = {m: ctx._plugins[m] for m in members}
        cfgs = {m: plugins[m].kernel_config(ctx) for m in members}
        support_hit_cfg = self._support_hit_cfg(ctx, device_members)

        # one wave-input load for the whole bundle (keeps the native integer
        # dtype; every device stage casts on device). waveform_width has no
        # wave_source option, so the load rides another member (or the hit
        # plugin, whose source the planner verified matches).
        load_via = next(
            (m for m in device_members if m != "waveform_width"), None
        )
        load_plugin = (
            plugins[load_via] if load_via is not None else ctx._plugins["hit"]
        )
        with ctx.profiler.time("fusion.single.load"):
            waves, lengths, meta = _load_wave_matrix(
                ctx, load_plugin, run_id, keep_integer_waves=True
            )
        n = len(lengths)
        if n == 0:
            return self._empty_results(members)

        # host preps (config machinery producing device inputs)
        sign = np.where(meta["polarity"] > 0, 1.0, -1.0).astype(np.float32)
        thresholds = np.zeros((n,), np.float32)
        if "hit_threshold" in device_members:
            thresholds = plugins["hit_threshold"].host_prep(
                cfgs["hit_threshold"], ctx, run_id, meta
            ).astype(np.float32)
        bf_baselines = None
        if "basic_features" in device_members:
            bf_baselines = plugins["basic_features"].host_prep(
                cfgs["basic_features"], ctx, run_id,
                np.asarray(meta["baseline"], dtype=np.float64),
                meta["board"], meta["channel"],
            )

        dev = ctx.device
        inputs = (
            waves,  # a host array or a device-resident tensor
            lengths.astype(np.int32),
            sign,
            meta["baseline"].astype(np.float32),
            thresholds,
        )
        with ctx.profiler.time("fusion.single.upload"):
            dev_in = tuple(to_device(x, dev) for x in inputs)
        with ctx.profiler.time("fusion.single.device_program"):
            out = self._run_stages(
                tuple(device_members), cfgs, plugins, support_hit_cfg, *dev_in
            )
            compacted, host_out = self._compact(device_members, cfgs, out)
            if dev.type == "cuda":  # the phase ends when the device is done
                torch.cuda.synchronize(dev)
        with ctx.profiler.time("fusion.single.fetch"):
            slot_out = {}
            for m, (mat, count, fields, dtypes) in compacted.items():
                slot_out[m] = decode_slot_matrix(
                    mat[:count].cpu().numpy(), fields, dtypes
                )
            for m in device_members:
                if m not in _SLOT_FIELDS:
                    host_out[m] = {k: v.cpu().numpy() for k, v in out[m].items()}

        results: Dict[str, Any] = {}
        with ctx.profiler.time("fusion.single.finalize"):
            for m in device_members:
                results[m] = self._finalize_member(
                    ctx, m, plugins, cfgs, support_hit_cfg, host_out,
                    slot_out, meta, lengths, n, bf_baselines=bf_baselines,
                )
            self._finalize_host_members(
                ctx, run_id, host_members, plugins, cfgs, results
            )
        logger.debug(
            "fused %s over %d waveforms in one device program", members, n
        )
        return results

    @staticmethod
    def _support_hit_cfg(ctx: Any, device_members: List[str]):
        """Kernel config for the UNEMITTED hit stage backing waveform_width
        when hit itself is cache-valid and outside the bundle."""
        if "waveform_width" in device_members and "hit" not in device_members:
            return ctx._plugins["hit"].kernel_config(ctx)
        return None

    @staticmethod
    def _run_stages(
        members: Tuple[str, ...], cfgs: Dict, plugins: Dict,
        support_hit_cfg: Optional[dict],
        waves_d, lengths_d, sign_d, baselines_d, thresholds_d,
    ) -> Dict[str, Dict[str, torch.Tensor]]:
        """The member composition: every device stage over the same device
        inputs, waveform_width reading the hit stage's peak slots (or an
        unemitted support hit stage's, when hit itself is cached)."""
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        peaks_stage = None
        for m in members:
            stage = type(plugins[m]).device_stage
            if m == "basic_features":
                out[m] = stage(cfgs[m], waves_d, lengths_d)
            elif m == "hit":
                out[m] = stage(cfgs[m], waves_d, lengths_d, sign_d, baselines_d)
                peaks_stage = out[m]
            elif m == "hit_threshold":
                out[m] = stage(cfgs[m], waves_d, lengths_d, sign_d,
                               baselines_d, thresholds_d)
            elif m == "waveform_width_integral":
                out[m] = stage(cfgs[m], waves_d, lengths_d, sign_d, baselines_d)
            elif m == "waveform_width":
                if peaks_stage is None:
                    from waveformanalysis_tpu_torch.plugins.builtin.peak_finding import (
                        HitFinderPlugin,
                    )

                    peaks_stage = HitFinderPlugin.device_stage(
                        support_hit_cfg, waves_d, lengths_d, sign_d, baselines_d
                    )
                out[m] = stage(cfgs[m], waves_d, peaks_stage)
        return out

    @staticmethod
    def _compact(device_members: List[str], cfgs: Dict, out: Dict):
        """Compact each slot member on the device and count its overflow.

        Returns ({member: (matrix, count, fields, dtypes)},
        {member + "__overflow": int}).
        """
        compacted = {}
        overflow: Dict[str, int] = {}
        for m in device_members:
            if m not in _SLOT_FIELDS:
                continue
            stage = out[m]
            fields = _SLOT_FIELDS[m]
            mat, count = compact_slots(stage, fields)
            compacted[m] = (mat, count, fields, field_dtypes(stage, fields))
            if m in _SLOT_OVERFLOW:
                count_key, cap_key = _SLOT_OVERFLOW[m]
                overflow[m + "__overflow"] = int(
                    (stage[count_key] > cfgs[m][cap_key]).sum()
                )
        return compacted, overflow

    def _finalize_member(
        self, ctx: Any, m: str, plugins: Dict, cfgs: Dict, support_hit_cfg,
        host_out: Dict, slot_out: Dict, meta: dict, lengths: np.ndarray,
        n: int, bf_baselines=None,
    ):
        """Finalize ONE device member from the copied outputs."""
        if m == "basic_features":
            pol = np.where(
                meta["polarity"] == 0, np.int8(-1), meta["polarity"]
            ).astype(np.int8)
            return plugins[m].finalize(
                cfgs[m], host_out[m], bf_baselines, pol,
                meta["timestamp"], meta["board"], meta["channel"],
            )
        if m == "hit":
            rows, slots = slot_out[m]
            return plugins[m].finalize_compact(
                cfgs[m], rows, slots, host_out[m + "__overflow"], meta, n,
            )
        if m == "hit_threshold":
            rows, slots = slot_out[m]
            return plugins[m].finalize_compact(
                cfgs[m], rows, slots, host_out[m + "__overflow"],
                meta, np.asarray(lengths, np.int64), n,
            )
        if m == "waveform_width_integral":
            return plugins[m].finalize(cfgs[m], host_out[m], meta, n)
        if m == "waveform_width":
            hit_cfg = cfgs.get("hit") or support_hit_cfg
            dt_ns = ctx._plugins["hit"]._resolve_dt(hit_cfg, meta, n)
            rows, slots = slot_out[m]
            return plugins[m].finalize_compact(
                cfgs[m], rows, slots, meta, dt_ns
            )
        raise KeyError(m)

    @staticmethod
    def _finalize_host_members(
        ctx: Any, run_id: str, host_members: List[str], plugins: Dict,
        cfgs: Dict, results: Dict[str, Any],
    ) -> None:
        """Compute the bundle's host members from finalized member tables.

        Inputs outside the bundle are cache-valid by the planner's contract
        and load through the normal (cached) get_data path. The SAME pure
        functions the standalone computes call run here, so outputs are
        bit-identical (reference cones: s1_s2_classifier.py:73,
        hit_merge.py:325-445).
        """
        if not host_members:
            return

        def table_input(name: str):
            if name in results:
                return results[name]
            return ctx.get_data(run_id, name)

        if "s1_s2" in host_members:
            results["s1_s2"] = plugins["s1_s2"].classify(
                cfgs["s1_s2"], table_input("waveform_width"),
                table_input("basic_features"),
            )
        merge_members = [m for m in host_members if m != "s1_s2"]
        if merge_members:
            from waveformanalysis_tpu_torch.plugins.builtin.hit_merge import (
                clusters_table,
                components_table,
                merge_from_table,
                merged_table,
            )

            emit = {
                "hit_merged": merged_table,
                "hit_merge_clusters": clusters_table,
                "hit_merged_components": components_table,
            }
            hits_th = table_input("hit_threshold")
            triples: Dict[Tuple, Any] = {}
            for m in merge_members:
                ckey = tuple(sorted(
                    (k, v) for k, v in cfgs[m].items()
                ))
                if ckey not in triples:
                    # one merge per distinct config serves every member that
                    # shares it (standalone runs the merge once per plugin)
                    triples[ckey] = merge_from_table(cfgs[m], hits_th)
                results[m] = emit[m](triples[ckey])

    @staticmethod
    def _empty_results(members: List[str]) -> Dict[str, Any]:
        from waveformanalysis_tpu_torch.dtypes.table import Table
        from waveformanalysis_tpu_torch.plugins.builtin.basic_features import (
            BASIC_FEATURES_SCHEMA,
        )
        from waveformanalysis_tpu_torch.plugins.builtin.hit_finder import (
            THRESHOLD_HIT_SCHEMA,
        )
        from waveformanalysis_tpu_torch.plugins.builtin.hit_merge import (
            HIT_MERGE_CLUSTERS_SCHEMA,
            HIT_MERGED_COMPONENTS_SCHEMA,
            HIT_MERGED_SCHEMA,
        )
        from waveformanalysis_tpu_torch.plugins.builtin.peak_finding import HIT_SCHEMA
        from waveformanalysis_tpu_torch.plugins.builtin.s1_s2_classifier import (
            S1_S2_CLASSIFIER_SCHEMA,
        )
        from waveformanalysis_tpu_torch.plugins.builtin.waveform_width import (
            WAVEFORM_WIDTH_SCHEMA,
        )
        from waveformanalysis_tpu_torch.plugins.builtin.waveform_width_integral import (
            WAVEFORM_WIDTH_INTEGRAL_SCHEMA,
        )

        schemas = {
            "basic_features": BASIC_FEATURES_SCHEMA,
            "hit": HIT_SCHEMA,
            "hit_threshold": THRESHOLD_HIT_SCHEMA,
            "waveform_width_integral": WAVEFORM_WIDTH_INTEGRAL_SCHEMA,
            "waveform_width": WAVEFORM_WIDTH_SCHEMA,
            "hit_merged": HIT_MERGED_SCHEMA,
            "hit_merge_clusters": HIT_MERGE_CLUSTERS_SCHEMA,
            "hit_merged_components": HIT_MERGED_COMPONENTS_SCHEMA,
            "s1_s2": S1_S2_CLASSIFIER_SCHEMA,
        }
        return {m: Table.zeros(0, schemas[m]) for m in members}


_DEFAULT_RULES: Optional[List[Any]] = None


def get_fusion_rules() -> List[Any]:
    global _DEFAULT_RULES
    if _DEFAULT_RULES is None:
        _DEFAULT_RULES = [WaveChainFusion()]
    return _DEFAULT_RULES
