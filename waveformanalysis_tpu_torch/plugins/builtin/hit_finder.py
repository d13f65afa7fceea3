"""hit_threshold plugin: threshold-crossing hit detector.

Behavioral analog of the reference ThresholdHitPlugin
(reference: waveform_analysis/core/plugins/builtin/cpu/hit_finder.py:82):
polarity-normalized signal (baseline - wave for negative pulses) crossed
against per-channel thresholds; contiguous runs with left/right extension
become hits with rise/fall times and record-clipped edges.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import scan_backend, to_device, to_numpy
from waveformanalysis_tpu_torch.dtypes.schema import Field, Schema
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.hardware import resolve_channel_value_arrays
from waveformanalysis_tpu_torch.ops import hits as HT
from waveformanalysis_tpu_torch.plugins.base import Option, Plugin
from waveformanalysis_tpu_torch.plugins.builtin._wave_source import (
    WAVE_SOURCE_AUTO,
    resolve_wave_input_spec,
)
from waveformanalysis_tpu_torch.plugins.builtin.peak_finding import _load_wave_matrix

logger = logging.getLogger(__name__)

THRESHOLD_HIT_SCHEMA = Schema(
    "hit_threshold",
    (
        Field("position", "i8", doc="hit peak position (sample index)"),
        Field("height", "f4"),
        Field("integral", "f4"),
        Field("edge_start", "i4", doc="record-clipped window start"),
        Field("edge_end", "i4", doc="record-clipped window end"),
        Field("width", "f4", doc="edge_end - edge_start (samples)"),
        Field("dt", "i4", unit="ns"),
        Field("rise_time", "f4", unit="ns", doc="(pos - run start) * dt"),
        Field("fall_time", "f4", unit="ns", doc="(run end - 1 - pos) * dt"),
        Field("timestamp", "i8", unit="ps"),
        Field("board", "i2"),
        Field("channel", "i2"),
        Field("record_id", "i8"),
    ),
)
THRESHOLD_HIT_DTYPE = THRESHOLD_HIT_SCHEMA.numpy_dtype()


class ThresholdHitPlugin(Plugin):
    """Threshold-only hit detector with THRESHOLD_HIT output.

    ``hits_backend`` on the port: ``scan`` runs the hand-written CUDA
    threshold-run kernel (``ops/chain_scan_cuda.py::threshold_hits_scan``),
    ``xla`` the plain PyTorch formulation (``ops/hits.py``), and ``auto``
    picks ``scan`` on a CUDA device and ``xla`` on the CPU. The option's
    help text is the JAX package's, kept for the lineage keys.
    """

    provides = "hit_threshold"
    # outputs depend on run_config channel_metadata (hardware overrides)
    uses_run_config = True
    depends_on = []  # dynamic
    description = "Threshold-only hit detector with THRESHOLD_HIT_DTYPE output."
    version = "0.12.0"
    kernel_version = HT.KERNEL_VERSION
    save_when = "always"
    output_dtype = THRESHOLD_HIT_SCHEMA
    options = {
        "threshold": Option(default=10.0, type=float, help="Hit threshold"),
        "use_filtered": Option(default=False, type=bool,
                               help="Use filtered_waveforms"),
        "wave_source": Option(default=WAVE_SOURCE_AUTO, type=str,
                              help="auto|records|st_waveforms|filtered_waveforms"),
        "left_extension": Option(default=2, type=int, help="Window left extension"),
        "right_extension": Option(default=2, type=int, help="Window right extension"),
        "dt": Option(default=None, type=int,
                     help="Sample interval (ns) fallback when data lacks dt"),
        "channel_config": Option(default=None, type=dict,
                                 help="Per-(board,channel) threshold overrides"),
        "max_hits_per_waveform": Option(
            default=HT.DEFAULT_MAX_HITS, type=int, track=False,
            help="Fixed device capacity per waveform (perf knob)"),
        # the JAX package's help text, word for word: it feeds `spec_hash` and so every lineage key
        "hits_backend": Option(
            default="auto", type=str, track=False,
            choices=["auto", "scan", "xla"],
            help="threshold-run kernel: streaming-scan Pallas (TPU) or XLA; "
                 "auto picks scan on TPU"),
        "overflow_policy": Option(
            default="warn", type=str, track=False,
            choices=["warn", "raise", "ignore"],
            help="Waveforms with more threshold runs than the device "
                 "capacity: warn (drop beyond-K + log), raise (strict), "
                 "ignore"),
    }

    def resolve_depends_on(self, context: Any, run_id: Optional[str] = None):
        return list(resolve_wave_input_spec(context, self).depends_on)

    # -- three-phase structure (shared with the fused subgraph executor) ----

    def kernel_config(self, context: Any) -> dict:
        backend = scan_backend(
            context.get_config(self, "hits_backend"), context.device
        )
        return {
            "threshold": float(context.get_config(self, "threshold")),
            "left_extension": int(context.get_config(self, "left_extension")),
            "right_extension": int(context.get_config(self, "right_extension")),
            "dt": context.get_config(self, "dt"),
            "channel_config": context.get_config(self, "channel_config"),
            "max_hits": int(context.get_config(self, "max_hits_per_waveform")),
            "backend": backend,
            "overflow_policy": context.get_config(self, "overflow_policy"),
        }

    def host_prep(self, cfg: dict, context: Any, run_id: str, meta: dict) -> np.ndarray:
        """Per-channel threshold resolution (host config machinery)."""
        overrides = resolve_channel_value_arrays(
            context, self, run_id, meta["board"], meta["channel"],
            option_names=("threshold",),
            defaults={"threshold": cfg["threshold"]},
            channel_config=cfg["channel_config"],
        )
        thresholds = overrides["threshold"]
        return np.where(np.isnan(thresholds), cfg["threshold"], thresholds)

    @staticmethod
    def device_stage(
        cfg: dict,
        waves_d: torch.Tensor,
        lengths_d: torch.Tensor,
        sign_d: torch.Tensor,
        baselines_d: torch.Tensor,
        thresholds_d: torch.Tensor,
    ) -> dict:
        """Composable device program: signal -> threshold runs. The signal
        past each row's length is -inf: a run's extended segment that
        reaches the end of a padded record (the records source) takes no
        padding sample as its height or into its integral, whatever the
        polarity makes of the zeros there."""
        w32 = waves_d.to(torch.float32)
        signal = sign_d[:, None] * (w32 - baselines_d[:, None].to(torch.float32))
        col = torch.arange(signal.shape[1], device=signal.device)
        signal.masked_fill_(col[None, :] >= lengths_d[:, None], float("-inf"))
        if cfg["backend"] == "scan":
            from waveformanalysis_tpu_torch.ops.chain_scan_cuda import (
                threshold_hits_scan,
            )

            return dict(threshold_hits_scan(
                signal, thresholds_d.to(torch.float32),
                lengths_d.to(torch.int32),
                left_extension=cfg["left_extension"],
                right_extension=cfg["right_extension"],
                max_hits=cfg["max_hits"],
            ))
        return dict(HT.threshold_hits_batch(
            signal, thresholds_d.to(torch.float32),
            lengths_d.to(torch.int32),
            left_extension=cfg["left_extension"],
            right_extension=cfg["right_extension"],
            max_hits=cfg["max_hits"],
        ))

    # slot fields the finalize step consumes, in the order the fused
    # executor's device compaction packs them (fusion.py _SLOT_FIELDS)
    COMPACT_SLOT_FIELDS = (
        "position", "height", "integral", "seg_start", "seg_end",
        "run_start", "run_end",
    )

    def _check_overflow(self, cfg: dict, overflow: int) -> None:
        if overflow and cfg.get("overflow_policy", "warn") != "ignore":
            msg = (
                f"hit_threshold: {overflow} waveforms exceeded the "
                f"{cfg['max_hits']}-hit capacity; excess runs dropped "
                f"(raise max_hits_per_waveform or set overflow_policy)"
            )
            if cfg.get("overflow_policy") == "raise":
                raise ValueError(msg)
            logger.warning(msg)

    def _resolve_dt(self, cfg: dict, meta: dict, n: int) -> np.ndarray:
        dt = meta["dt"]
        if dt is None:
            if cfg["dt"] is None:
                raise ValueError("[hit_threshold] dt must be provided (config or data)")
            dt = np.full(n, int(cfg["dt"]), dtype=np.int64)
        return dt

    def finalize(
        self, cfg: dict, results: dict, meta: dict, lengths: np.ndarray, n: int
    ) -> Table:
        results = {k: to_numpy(v) for k, v in results.items()}
        self._check_overflow(
            cfg, int(np.sum(results["n_runs"] > cfg["max_hits"]))
        )
        dt = self._resolve_dt(cfg, meta, n)
        cols = HT.compact_threshold_hits(
            results,
            timestamps=meta["timestamp"], boards=meta["board"],
            channels=meta["channel"], record_ids=meta["record_id"],
            dt_ns=dt, record_lengths=lengths,
        )
        return Table(cols, schema=THRESHOLD_HIT_SCHEMA)

    def finalize_compact(
        self, cfg: dict, rows: np.ndarray, slots: dict, overflow: int,
        meta: dict, lengths: np.ndarray, n: int,
    ) -> Table:
        """Finalize from device-compacted per-run slot values (fused path).

        Bit-identical to ``finalize``: the device compaction gathers the same
        leaves ``compact_threshold_hits`` would, in the same row-major order.
        """
        self._check_overflow(cfg, overflow)
        dt = self._resolve_dt(cfg, meta, n)
        cols = HT.threshold_columns_from_flat(
            rows=rows, position=slots["position"], height=slots["height"],
            integral=slots["integral"], seg_start=slots["seg_start"],
            seg_end=slots["seg_end"], run_start=slots["run_start"],
            run_end=slots["run_end"],
            timestamps=meta["timestamp"], boards=meta["board"],
            channels=meta["channel"], record_ids=meta["record_id"],
            dt_ns=dt, record_lengths=lengths,
        )
        return Table(cols, schema=THRESHOLD_HIT_SCHEMA)

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> Table:
        cfg = self.kernel_config(context)
        waves, lengths, meta = _load_wave_matrix(context, self, run_id)
        n = len(lengths)
        if n == 0:
            return Table.zeros(0, THRESHOLD_HIT_SCHEMA)

        from waveformanalysis_tpu_torch.ops.compact import compact_rows

        dev = context.device
        thresholds = self.host_prep(cfg, context, run_id, meta)
        sign = np.where(meta["polarity"] > 0, 1.0, -1.0).astype(np.float32)
        out = self.device_stage(
            cfg, to_device(waves, dev), to_device(lengths.astype(np.int32), dev),
            to_device(sign, dev), to_device(meta["baseline"].astype(np.float32), dev),
            to_device(thresholds.astype(np.float32), dev),
        )
        rows, slots = compact_rows(out, self.COMPACT_SLOT_FIELDS)
        overflow = int((out["n_runs"] > cfg["max_hits"]).sum())
        return self.finalize_compact(
            cfg, rows, slots, overflow, meta, lengths, n
        )
