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

Several runs go through one program too (``compute_many``, behind
``Context.get_data_batched``): runs whose device configuration matches are
concatenated on the event axis, padded with zero-length events to a
multiple of ``config["fused_batch_bucket"]``, and split at the run
boundaries on the host. A run computed again over the same lineage shrinks
its slot capacities to the count it had (the sticky slot-capacity hints);
an overflow of a shrunken capacity re-dispatches at the configured one.

With a mesh attached (``Context.attach_mesh``), both paths run the
program on every shard of the mesh instead (``_run_sharded``): the event
axis padded to the shard multiple, each shard's stages and slot
compaction on its device, the shards fetched and joined in shard order,
with no capacity hint (as in the JAX package, which also skips the
compaction there; the tables are the same).

Not ported (ROADMAP.md): the JAX package's AOT program cache and packed
bucketed fetch.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import on_device, to_device
from waveformanalysis_tpu_torch.parallel.mesh import pad_to_shards
from waveformanalysis_tpu_torch.storage.cache_ops import HINT_SUFFIX
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

# sticky slot-capacity buckets: observed per-event max candidate counts are
# recorded per (run, member lineage) in cache metadata, so a LATER compute
# over the same run+lineage runs a right-sized K instead of the static
# default capacity (a member's device cost grows with K). Capacity knobs are
# untracked options, so a shrunken K leaves lineage/cache keys untouched;
# outputs are identical by construction: every hinted stage emits an
# overflow counter against its shrunken capacity, and any overflow (stale
# hint -- e.g. data re-injected under the same run id) discards the hint and
# re-dispatches at the configured capacity. Disable via config
# ``{"capacity_hints": False}``.
_CAP_BUCKETS = (8, 16, 32)

# device_stage-relevant config keys per member: runs batch into one program
# only when these agree (host-only keys like channel_config affect inputs,
# not the program)
_DEVICE_CFG_KEYS = {
    "basic_features": ("height_range", "area_range"),
    "hit": (
        "use_derivative", "height", "distance", "prominence", "width",
        "height_method", "height_window_extension", "max_peaks", "backend",
    ),
    "hit_threshold": (
        "left_extension", "right_extension", "max_hits", "backend",
    ),
    "waveform_width_integral": ("q_low", "q_high"),
    "waveform_width": (
        "rise_low", "rise_high", "fall_high", "fall_low", "interpolation",
        "backend",
    ),
}


def _host_rows(waves: np.ndarray) -> torch.Tensor:
    """A host wave matrix (possibly a strided view of the st_waveforms
    records) as a contiguous CPU tensor, for one copy to the device."""
    return torch.from_numpy(np.ascontiguousarray(waves))


def _dtype_name(waves) -> str:
    """The wave matrix's dtype by name, the same for a host array and a
    tensor of one dtype (``int16`` for both ``np.int16`` and
    ``torch.int16``), so batched runs group on it."""
    if isinstance(waves, torch.Tensor):
        return str(waves.dtype).replace("torch.", "")
    return np.dtype(waves.dtype).name


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

    def plan_batched(
        self, ctx: Any, run_id: str, needed: set
    ) -> Optional[List[str]]:
        """Batched-dispatch planning: a SINGLE member qualifies -- batching
        runs on the event axis amortizes upload/dispatch/fetch latency even
        when only one wave-chain plugin is in the needed set."""
        return self.plan(ctx, run_id, needed, min_members=1)

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

        inputs = (
            waves,  # a host array or a device-resident tensor
            lengths.astype(np.int32),
            sign,
            meta["baseline"].astype(np.float32),
            thresholds,
        )
        mesh_info = ctx.mesh
        if mesh_info is not None:
            host_out, slot_out = self._run_sharded(
                ctx, device_members, cfgs, plugins, support_hit_cfg, inputs,
                n, mesh_info, "fusion.single",
            )
        else:
            host_out, slot_out = self._run_one_device(
                ctx, run_id, device_members, cfgs, plugins, support_hit_cfg,
                inputs, n,
            )

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

    def _run_one_device(
        self, ctx: Any, run_id: str, device_members: List[str], cfgs: Dict,
        plugins: Dict, support_hit_cfg, inputs: Tuple, n: int,
    ):
        """The single-run program on the Context's device: the capacity
        hints, the upload, the stages, the device compaction and the fetch
        (again at the configured capacities after a stale hint). Returns
        (host_out, slot_out) as ``_fetch`` does."""
        dev = ctx.device
        hinted = self._apply_capacity_hints(
            ctx, run_id, device_members, cfgs, support_hit_cfg, n
        )
        with ctx.profiler.time("fusion.single.upload"):
            dev_in = tuple(to_device(x, dev) for x in inputs)
        while True:
            with ctx.profiler.time("fusion.single.device_program"):
                out = self._run_stages(
                    tuple(device_members), cfgs, plugins, support_hit_cfg,
                    *dev_in
                )
                compacted, counters = self._compact(
                    device_members, cfgs, support_hit_cfg, out
                )
                if dev.type == "cuda":  # the phase ends when the device is done
                    torch.cuda.synchronize(dev)
            with ctx.profiler.time("fusion.single.fetch"):
                host_out, slot_out = self._fetch(
                    device_members, out, compacted, counters
                )
            stale = [
                m for m in hinted
                if host_out.get(m + "__overflow",
                                host_out.get("__" + m + "_support__overflow", 0))
            ]
            if not stale:
                break
            # a hinted capacity overflowed: the recorded hint no longer
            # matches the run's data (e.g. re-injected under the same run
            # id). Restore configured capacities and re-dispatch -- outputs
            # stay identical to the never-hinted program.
            logger.warning(
                "stale slot-capacity hint for %s on run %s; "
                "re-dispatching at configured capacity", stale, run_id,
            )
            for m in stale:
                self._drop_hint(ctx, run_id, m)
            for m, orig in hinted.items():
                for cfg in self._capacity_targets(
                    m, device_members, cfgs, support_hit_cfg
                ):
                    cfg[_SLOT_OVERFLOW[m][1]] = orig
            hinted = {}
        self._record_capacity_hints(ctx, run_id, host_out, n)
        return host_out, slot_out

    def _run_sharded(
        self, ctx: Any, device_members: List[str], cfgs: Dict, plugins: Dict,
        support_hit_cfg, inputs: Tuple, n: int, mesh_info, phase: str,
    ):
        """The program on every shard of the attached mesh: the event axis
        padded to the shard multiple, each shard's rows on its device, every
        device stage and the slot compaction there (each kernel launches
        once a shard), each shard fetched and the shards joined in shard
        order on the host (slot rows rebased by the shard's first row), the
        padding cut. Returns (host_out, slot_out) as ``_fetch`` does for n
        rows, with per-event overflow vectors as the batched path has them.

        Pad rows carry event_length 0 (no samples -> no features, no peaks,
        no hits). As in the JAX package, the mesh program applies no
        capacity hint.
        """
        mesh, axis = mesh_info
        devs = mesh.shard_devices(axis)
        m = pad_to_shards(n, len(devs)) // len(devs)

        def rows(x, i: int, dev) -> torch.Tensor:
            lo, hi = min(i * m, n), min((i + 1) * m, n)
            part = x[lo:hi]
            if not isinstance(part, torch.Tensor):  # a host slice, maybe of a read-only map
                part = torch.from_numpy(np.require(part, requirements=["C", "W"]))
            t = part.to(dev)
            if hi - lo < m:
                t = torch.cat([t, t.new_zeros((m - (hi - lo),) + tuple(t.shape[1:]))])
            return t

        with ctx.profiler.time(phase + ".upload"):
            shard_in = [tuple(rows(x, i, dev) for x in inputs)
                        for i, dev in enumerate(devs)]
        with ctx.profiler.time(phase + ".device_program"):
            outs = []
            for dev, args in zip(devs, shard_in):
                with on_device(dev):
                    outs.append(self._run_stages(
                        tuple(device_members), cfgs, plugins, support_hit_cfg, *args
                    ))
            # compacted once every shard's stages are queued: the compaction
            # waits for its device to count the valid slots
            shard_out = []
            for dev, out in zip(devs, outs):
                with on_device(dev):
                    shard_out.append((out,) + self._compact(
                        device_members, cfgs, support_hit_cfg, out,
                        per_event_overflow=True,
                    ))
            del outs
            for dev in dict.fromkeys(d for d in devs if d.type == "cuda"):
                torch.cuda.synchronize(dev)  # the phase ends when the devices are done
        del shard_in
        with ctx.profiler.time(phase + ".fetch"):
            fetched = [self._fetch(device_members, *o) for o in shard_out]
            del shard_out
            host_out = {
                k: ({f: np.concatenate([h[k][f] for h, _ in fetched])[:n]
                     for f in v} if isinstance(v, dict)
                    else np.concatenate([h[k] for h, _ in fetched])[:n])
                for k, v in fetched[0][0].items()
            }
            slot_out = {}
            for mem, (_, fields) in fetched[0][1].items():
                rows_ = np.concatenate(
                    [s[mem][0] + i * m for i, (_, s) in enumerate(fetched)])
                keep = rows_ < n
                slot_out[mem] = (rows_[keep], {
                    f: np.concatenate([s[mem][1][f] for _, s in fetched])[keep]
                    for f in fields})
        return host_out, slot_out

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
                    # the support stage's candidate counts feed the
                    # overflow and max-count leaves of the capacity hints
                    out["__hit_support"] = peaks_stage
                out[m] = stage(cfgs[m], waves_d, peaks_stage)
        return out

    @staticmethod
    def _compact(
        device_members: List[str], cfgs: Dict, support_hit_cfg, out: Dict,
        per_event_overflow: bool = False,
    ):
        """Compact each slot member on the device and count its overflow
        against its (possibly hinted) capacity.

        Returns ({member: (matrix, count, fields, dtypes)}, {name: tensor})
        with the counters ``m + "__overflow"`` (the number of events over
        capacity, or with ``per_event_overflow`` the per-event 0/1 vector
        the batched dispatch splits by run) and, single-run only,
        ``m + "__max_count"`` (the largest per-event count: the capacity
        hint); the unemitted support hit stage's as
        ``"__hit_support__overflow"`` / ``"__hit_support__max_count"``.
        """
        compacted = {}
        counters: Dict[str, torch.Tensor] = {}
        for m in device_members:
            if m not in _SLOT_FIELDS:
                continue
            stage = out[m]
            fields = _SLOT_FIELDS[m]
            mat, count = compact_slots(stage, fields)
            compacted[m] = (mat, count, fields, field_dtypes(stage, fields))
        stages = [(m, m, out[m], cfgs[m]) for m in device_members
                  if m in _SLOT_OVERFLOW]
        if "__hit_support" in out and not per_event_overflow:
            stages.append(("__hit_support", "hit", out["__hit_support"],
                           support_hit_cfg))
        for name, m, stage, cfg in stages:
            count_key, cap_key = _SLOT_OVERFLOW[m]
            over = (stage[count_key] > cfg[cap_key]).to(torch.int32)
            if per_event_overflow:
                counters[name + "__overflow"] = over
            else:
                counters[name + "__overflow"] = over.sum()
                counters[name + "__max_count"] = stage[count_key].max().to(torch.int64)
        return compacted, counters

    @staticmethod
    def _fetch(device_members: List[str], out: Dict, compacted: Dict,
               counters: Dict):
        """Copy the valid slot rows, the dense leaves and the counters to
        the host; returns (host_out, {member: (rows, slots)})."""
        slot_out = {}
        for m, (mat, count, fields, dtypes) in compacted.items():
            slot_out[m] = decode_slot_matrix(
                mat[:count].cpu().numpy(), fields, dtypes
            )
        host_out: Dict[str, Any] = {}
        for m in device_members:
            if m not in _SLOT_FIELDS:
                host_out[m] = {k: v.cpu().numpy() for k, v in out[m].items()}
        scalars = [k for k, v in counters.items() if v.dim() == 0]
        if scalars:  # one copy for every scalar counter
            values = torch.stack([counters[k].to(torch.int64) for k in scalars])
            host_out.update(zip(scalars, values.tolist()))
        host_out.update({k: v.cpu().numpy() for k, v in counters.items()
                         if v.dim()})
        return host_out, slot_out

    # -- sticky slot-capacity hints -------------------------------------------

    @staticmethod
    def _hint_store(ctx: Any) -> Dict[str, Optional[Tuple[int, int]]]:
        store = getattr(ctx, "_slot_capacity_hints", None)
        if store is None:
            store = {}
            ctx._slot_capacity_hints = store
        return store

    @staticmethod
    def _hint_key(ctx: Any, run_id: str, member: str) -> str:
        # lineage-hashed like the data caches: a config/version change that
        # could alter candidate counts changes the key, orphaning the hint
        return ctx.cache_domain.key_for(run_id, member) + HINT_SUFFIX

    def _get_hint(self, ctx: Any, run_id: str, member: str, n: int):
        """Observed max per-event candidate count, or None. ``n`` guards
        against re-injected data: a hint recorded over a different event
        count is ignored."""
        key = self._hint_key(ctx, run_id, member)
        store = self._hint_store(ctx)
        if key not in store:
            entry = None
            try:
                storage = ctx._get_storage_for_data_name(member)
                meta = storage.get_metadata(key, run_id)
                if meta and "max_slot_count" in meta:
                    entry = (int(meta["max_slot_count"]),
                             int(meta.get("n_events", -1)))
            except Exception:  # noqa: BLE001 - hint misses are never fatal
                entry = None
            store[key] = entry
        entry = store[key]
        if entry is None or entry[1] != n:
            return None
        return entry[0]

    def _put_hint(
        self, ctx: Any, run_id: str, member: str, observed: int, n: int
    ) -> None:
        key = self._hint_key(ctx, run_id, member)
        self._hint_store(ctx)[key] = (observed, n)
        try:
            storage = ctx._get_storage_for_data_name(member)
            storage.save_metadata(
                key, {"max_slot_count": int(observed), "n_events": int(n)},
                run_id,
            )
        except Exception as e:  # noqa: BLE001
            logger.debug("capacity hint persist failed for %s: %s", key, e)

    def _drop_hint(self, ctx: Any, run_id: str, member: str) -> None:
        key = self._hint_key(ctx, run_id, member)
        self._hint_store(ctx)[key] = None
        try:
            storage = ctx._get_storage_for_data_name(member)
            storage.save_metadata(key, {}, run_id)
        except Exception:  # noqa: BLE001
            pass

    @staticmethod
    def _capacity_targets(m: str, device_members: List[str], cfgs: Dict,
                          support_hit_cfg) -> List[dict]:
        """The kernel configs whose capacity member ``m``'s hint sets: its
        own, and for hit the support stage's."""
        targets = [cfgs[m]] if m in device_members else []
        if m == "hit" and support_hit_cfg is not None:
            targets.append(support_hit_cfg)
        return targets

    def _apply_capacity_hints(
        self, ctx: Any, run_id: str, device_members: List[str],
        cfgs: Dict, support_hit_cfg, n: int,
    ) -> Dict[str, int]:
        """Shrink slot capacities to the smallest bucket covering the
        recorded hint; returns {member: original capacity} for the stale-
        hint rerun path. Only ever shrinks -- a hint above the configured
        capacity never widens it."""
        if not ctx.config.get("capacity_hints", True):
            return {}
        hinted: Dict[str, int] = {}
        for m, (_count_key, cap_key) in _SLOT_OVERFLOW.items():
            targets = self._capacity_targets(
                m, device_members, cfgs, support_hit_cfg
            )
            if not targets:
                continue
            hint = self._get_hint(ctx, run_id, m, n)
            if hint is None:
                continue
            new = next((b for b in _CAP_BUCKETS if b >= max(hint, 1)), None)
            if new is None:
                continue
            for cfg in targets:
                if new < cfg[cap_key]:
                    hinted.setdefault(m, cfg[cap_key])
                    cfg[cap_key] = new
        return hinted

    def _record_capacity_hints(
        self, ctx: Any, run_id: str, host_out: Dict, n: int,
    ) -> None:
        for m in _SLOT_OVERFLOW:
            for key in (m + "__max_count", "__" + m + "_support__max_count"):
                if key in host_out:
                    self._put_hint(ctx, run_id, m, int(host_out[key]), n)
                    break

    def _finalize_member(
        self, ctx: Any, m: str, plugins: Dict, cfgs: Dict, support_hit_cfg,
        host_out: Dict, slot_out: Dict, meta: dict, lengths: np.ndarray,
        n: int, offset: Optional[int] = None, bf_baselines=None,
    ):
        """Finalize ONE device member from the copied outputs.

        ``offset=None`` = single-run path (whole arrays); otherwise the
        batched path passes the run's offset in the concatenated batch, so
        dense leaves slice rows [offset, offset + n) and slot rows rebase.
        """

        def dense(name):
            if offset is None:
                return host_out[name]
            return {k: v[offset:offset + n] for k, v in host_out[name].items()}

        def slot_rows(name):
            rows, slots = slot_out[name]
            if offset is None:
                return rows, slots
            # compact_slots front-packs in row-major order, so each run's
            # rows are one sorted stretch
            lo = int(np.searchsorted(rows, offset))
            hi = int(np.searchsorted(rows, offset + n))
            return rows[lo:hi] - offset, {f: c[lo:hi] for f, c in slots.items()}

        if m == "basic_features":
            pol = np.where(
                meta["polarity"] == 0, np.int8(-1), meta["polarity"]
            ).astype(np.int8)
            return plugins[m].finalize(
                cfgs[m], dense(m), bf_baselines, pol,
                meta["timestamp"], meta["board"], meta["channel"],
            )
        if m == "hit":
            rows, slots = slot_rows(m)
            return plugins[m].finalize_compact(
                cfgs[m], rows, slots,
                self._member_overflow(host_out, m, offset, n), meta, n,
            )
        if m == "hit_threshold":
            rows, slots = slot_rows(m)
            return plugins[m].finalize_compact(
                cfgs[m], rows, slots,
                self._member_overflow(host_out, m, offset, n),
                meta, np.asarray(lengths, np.int64), n,
            )
        if m == "waveform_width_integral":
            return plugins[m].finalize(cfgs[m], dense(m), meta, n)
        if m == "waveform_width":
            hit_cfg = cfgs.get("hit") or support_hit_cfg
            dt_ns = ctx._plugins["hit"]._resolve_dt(hit_cfg, meta, n)
            rows, slots = slot_rows(m)
            return plugins[m].finalize_compact(
                cfgs[m], rows, slots, meta, dt_ns
            )
        raise KeyError(m)

    @staticmethod
    def _member_overflow(host_out: Dict, m: str, offset: Optional[int],
                         n: int) -> int:
        over = host_out[m + "__overflow"]  # a count, or per event (batched, mesh)
        if offset is not None:
            over = over[offset:offset + n]
        return int(np.sum(over))

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

    # -- multi-run batched execution ----------------------------------------

    def compute_many(
        self, ctx: Any, run_members: List[Tuple[str, List[str]]]
    ) -> Dict[str, Dict[str, Any]]:
        """Run the fused bundle for SEVERAL runs in as few device programs
        as possible.

        The reference fans multiple runs out over host processes
        (reference: waveform_analysis/core/data/batch_processor.py:197);
        here runs whose device configuration matches are CONCATENATED along
        the event axis and run as ONE program, so R runs pay one upload,
        one kernel launch per stage and one copy back instead of R of each.
        Outputs are split at the run boundaries on the host and
        finalized/saved per run -- bit-identical to per-run execution
        (tests/test_torch_batched.py).

        The concatenated event count is padded up to a multiple of
        ``config["fused_batch_bucket"]`` (default 4096) with zero-length
        events (no samples -> no features, no peaks, no hits), and narrower
        runs are padded to the group's widest L. The capacity hints are not
        applied here: the group runs at the configured capacities. With a
        mesh attached, the padded count is also a multiple of the shard
        count and the group runs on every shard (``_run_sharded``).
        """
        out: Dict[str, Dict[str, Any]] = {}

        # per-run prep under that run's prepared request (run_config may
        # differ per run, so group keys include the device-relevant cfg)
        groups: Dict[Tuple, List[dict]] = {}
        for run_id, members in run_members:
            ctx.config_domain.prepare_request(run_id)
            with ctx.profiler.time("fusion.batched.prep_run"):
                prep = self._prep_run(ctx, run_id, members)
            if prep is None:  # empty run: finalize immediately
                out[run_id] = self._empty_results(members)
                continue
            groups.setdefault(prep.pop("group_key"), []).append(prep)

        for preps in groups.values():
            out.update(self._dispatch_group(ctx, preps))
        return out

    def _prep_run(self, ctx: Any, run_id: str, members: List[str]):
        """Load + host-prep one run's bundle inputs; None for empty runs."""
        from waveformanalysis_tpu_torch.plugins.builtin.peak_finding import (
            _load_wave_matrix,
        )

        device_members = [m for m in members if m in FUSED_DEVICE_MEMBERS]
        plugins = {m: ctx._plugins[m] for m in members}
        cfgs = {m: plugins[m].kernel_config(ctx) for m in members}
        support_hit_cfg = self._support_hit_cfg(ctx, device_members)
        load_via = next(
            (m for m in device_members if m != "waveform_width"), None
        )
        load_plugin = (
            plugins[load_via] if load_via is not None else ctx._plugins["hit"]
        )
        waves, lengths, meta = _load_wave_matrix(
            ctx, load_plugin, run_id, keep_integer_waves=True
        )
        n = len(lengths)
        if n == 0:
            return None

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

        cfg_key = tuple(
            (m, tuple((k, cfgs[m][k]) for k in _DEVICE_CFG_KEYS[m]))
            for m in device_members
        )
        if support_hit_cfg is not None:
            cfg_key += (("__hit_support", tuple(
                (k, support_hit_cfg[k])
                for k in _DEVICE_CFG_KEYS["hit"]
            )),)
        return {
            "run_id": run_id,
            "members": list(members),
            "device_members": device_members,
            "host_members": [m for m in members if m in FUSED_HOST_MEMBERS],
            "plugins": plugins,
            "cfgs": cfgs,
            "support_hit_cfg": support_hit_cfg,
            "waves": waves,  # a host array or a device-resident tensor
            "lengths": lengths.astype(np.int32),
            "sign": sign,
            "baseline_f32": meta["baseline"].astype(np.float32),
            "thresholds": thresholds,
            "bf_baselines": bf_baselines,
            "meta": meta,
            "n": n,
            "group_key": (tuple(members), cfg_key, _dtype_name(waves)),
        }

    @staticmethod
    def _batch_waves(preps: List[dict], L: int, padded: int, dev):
        """The group's (padded, L) wave matrix on ``dev``: zeros (the
        padding rows and the columns past a narrower run's L), each run's
        rows copied into their slice -- a device-resident run's on the
        device, a host run's straight from its array, so no host matrix of
        the whole group is assembled (fresh host pages of its size cost
        more on the card's host than the copies; PERF.md)."""
        dtype = getattr(torch, _dtype_name(preps[0]["waves"]))
        waves = torch.zeros((padded, L), dtype=dtype, device=dev)
        off = 0
        for p in preps:
            w = p["waves"]
            if not isinstance(w, torch.Tensor):
                w = _host_rows(w)
            waves[off:off + p["n"], : w.shape[1]].copy_(w)
            off += p["n"]
        return waves

    def _dispatch_group(
        self, ctx: Any, preps: List[dict]
    ) -> Dict[str, Dict[str, Any]]:
        """One concatenated device program for runs with matching config."""
        members = preps[0]["members"]
        device_members = preps[0]["device_members"]
        cfgs = preps[0]["cfgs"]
        plugins = preps[0]["plugins"]
        support_hit_cfg = preps[0]["support_hit_cfg"]

        L = max(p["waves"].shape[1] for p in preps)
        total = sum(p["n"] for p in preps)
        bucket = int(ctx.config.get("fused_batch_bucket", 4096))
        padded = -(-total // bucket) * bucket if bucket > 1 else total
        mesh_info = ctx.mesh
        if mesh_info is not None:
            # runs compose with event-axis sharding: the padded batch splits
            # evenly over the shards
            padded = pad_to_shards(padded, mesh_info[0].shape[mesh_info[1]])

        lengths = np.zeros((padded,), np.int32)  # padding: zero-length events
        sign = np.ones((padded,), np.float32)
        baselines = np.zeros((padded,), np.float32)
        thresholds = np.zeros((padded,), np.float32)
        offsets = []
        off = 0
        for p in preps:
            n = p["n"]
            lengths[off:off + n] = p["lengths"]
            sign[off:off + n] = p["sign"]
            baselines[off:off + n] = p["baseline_f32"]
            thresholds[off:off + n] = p["thresholds"]
            offsets.append(off)
            off += n

        dev = ctx.device
        if mesh_info is not None:
            inputs = (self._batch_waves(preps, L, padded, dev), lengths, sign,
                      baselines, thresholds)
            host_out, slot_out = self._run_sharded(
                ctx, device_members, cfgs, plugins, support_hit_cfg, inputs,
                padded, mesh_info, "fusion.batched",
            )
            del inputs
        else:
            with ctx.profiler.time("fusion.batched.upload"):
                dev_in = (self._batch_waves(preps, L, padded, dev),) + tuple(
                    to_device(x, dev) for x in (lengths, sign, baselines, thresholds)
                )
            with ctx.profiler.time("fusion.batched.device_program"):
                out = self._run_stages(
                    tuple(device_members), cfgs, plugins, support_hit_cfg, *dev_in
                )
                compacted, counters = self._compact(
                    device_members, cfgs, support_hit_cfg, out,
                    per_event_overflow=True,
                )
                if dev.type == "cuda":  # the phase ends when the device is done
                    torch.cuda.synchronize(dev)
            del dev_in
            with ctx.profiler.time("fusion.batched.fetch"):
                host_out, slot_out = self._fetch(
                    device_members, out, compacted, counters
                )
            del out, compacted, counters

        results_by_run: Dict[str, Dict[str, Any]] = {}
        with ctx.profiler.time("fusion.batched.finalize"):
            for p, off in zip(preps, offsets):
                run_id, n, meta = p["run_id"], p["n"], p["meta"]
                results: Dict[str, Any] = {}
                for m in p["device_members"]:
                    results[m] = self._finalize_member(
                        ctx, m, p["plugins"], p["cfgs"],
                        p["support_hit_cfg"], host_out, slot_out, meta,
                        p["lengths"], n, offset=off,
                        bf_baselines=p["bf_baselines"],
                    )
                self._finalize_host_members(
                    ctx, run_id, p["host_members"], p["plugins"], p["cfgs"],
                    results,
                )
                results_by_run[run_id] = results
        logger.debug(
            "batched fused %s over %d runs / %d waveforms (padded %d) in one "
            "device program", members, len(preps), total, padded,
        )
        return results_by_run

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
