"""hit plugin: peak detection with find_peaks-parity device kernel.

Behavioral analog of the reference HitFinderPlugin
(reference: waveform_analysis/core/plugins/builtin/cpu/peak_finding.py:49):
detection on -diff(wave) (derivative mode, polarity-aware) or the
baseline-inverted wave; scipy find_peaks semantics with height/distance/
prominence/width; peak height via 'minmax' window or 'diff' telescoping;
global timestamp = event ts + position * dt(ns) * 1000 ps.

The per-waveform scipy loop and its thread-pool chunking
(peak_finding.py:309-444) are replaced by one batched device kernel — event
parallelism is the batch axis, so the parallel/chunk_size knobs vanish.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import scan_backend, to_device, to_numpy
from waveformanalysis_tpu_torch.dtypes.schema import Field, Schema
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.ops import peaks as PK
from waveformanalysis_tpu_torch.plugins.base import Option, Plugin
from waveformanalysis_tpu_torch.plugins.builtin._wave_source import (
    wave_matrix_view,
    WAVE_SOURCE_AUTO,
    load_wave_input,
    resolve_wave_input_spec,
)

logger = logging.getLogger(__name__)

HIT_SCHEMA = Schema(
    "hit",
    (
        Field("position", "i8", doc="peak position (sample index)"),
        Field("height", "f4"),
        Field("integral", "f4"),
        Field("edge_start", "f4", doc="interpolated left ip"),
        Field("edge_end", "f4", doc="interpolated right ip"),
        Field("dt", "i4", unit="ns"),
        Field("timestamp", "i8", unit="ps", doc="event ts + pos*dt*1000"),
        Field("board", "i2"),
        Field("channel", "i2"),
        Field("record_id", "i8"),
    ),
)
HIT_DTYPE = HIT_SCHEMA.numpy_dtype()
ADVANCED_PEAK_DTYPE = HIT_DTYPE  # legacy alias (reference parity)


def _normalize_threshold(value: Any):
    """scipy threshold condition -> (tmin, tmax) floats-or-None, or None.

    Accepts the scipy forms the reference forwards verbatim
    (peak_finding.py:108,201): a scalar (min only) or a 2-sequence
    (min, max). Per-peak arrays are rejected — the batched kernel has no
    per-peak broadcast for them and the reference's own Option is typed
    scalar."""
    if value is None:
        return None
    if isinstance(value, (tuple, list)):
        if len(value) != 2:
            raise ValueError(
                "threshold: expected a scalar or a (min, max) 2-sequence, "
                f"got length {len(value)}"
            )
        tmin, tmax = value
        return (
            None if tmin is None else float(tmin),
            None if tmax is None else float(tmax),
        )
    return (float(value), None)


class HitFinderPlugin(Plugin):
    """Detect peaks in waveforms and extract peak features."""

    provides = "hit"
    depends_on = []  # dynamic
    description = "Detect peaks in waveforms and extract peak features."
    # 3.2.0: scipy neighbor-threshold condition supported (was rejected)
    version = "3.3.0"
    kernel_version = PK.KERNEL_VERSION
    save_when = "always"
    output_dtype = HIT_SCHEMA
    options = {
        "use_filtered": Option(default=True, type=bool,
                               help="Use filtered_waveforms when registered"),
        "wave_source": Option(default=WAVE_SOURCE_AUTO, type=str,
                              help="auto|records|st_waveforms|filtered_waveforms"),
        "use_derivative": Option(default=True, type=bool,
                                 help="Detect peaks on the first derivative"),
        "height": Option(default=30.0, type=float, help="Minimum peak height"),
        "distance": Option(default=2, type=int, help="Minimum peak separation"),
        "prominence": Option(default=0.7, type=float, help="Minimum prominence"),
        "width": Option(default=4, type=int, help="Minimum peak width"),
        "threshold": Option(
            default=None,
            help="scipy neighbor threshold: min required vertical distance "
                 "to BOTH direct neighbor samples; scalar = min only, "
                 "2-sequence = (min, max)"),
        "height_method": Option(default="minmax", type=str,
                                choices=["minmax", "diff"],
                                help="Peak height: window minmax or diff telescoping"),
        "height_window_extension": Option(default=4, type=int,
                                          help="minmax window extension (samples)"),
        "dt": Option(default=None, type=int,
                     help="Sample interval (ns) fallback when data lacks dt"),
        "max_peaks_per_waveform": Option(
            default=PK.DEFAULT_MAX_PEAKS, type=int, track=False,
            help="Fixed device capacity per waveform (perf knob)"),
        "peaks_backend": Option(
            default="auto", type=str, track=False,
            choices=["auto", "scan", "xla"],
            help="find_peaks kernel: scan (the CUDA kernel) or xla (the "
                 "plain PyTorch formulation); auto picks scan on a CUDA "
                 "device and xla on the CPU"),
        "overflow_policy": Option(
            default="warn", type=str, track=False,
            choices=["warn", "raise", "ignore"],
            help="Events with more candidate peaks than the device capacity: "
                 "warn (drop beyond-K + log), raise (strict), ignore"),
        # Reference event-chunk parallelism knobs (cpu/peak_finding.py:127-
        # 146), accepted untracked for config portability. The device kernel
        # processes every event in one batched dispatch, so CPU worker
        # scheduling has no equivalent and no effect on outputs (perf-only on
        # the reference too). Ledgered in docs/PARITY.md "Inert reference
        # options".
        "parallel": Option(
            default=True, type=bool, track=False,
            help="Reference per-event-chunk parallel toggle (inert here)"),
        "n_workers": Option(
            default=0, type=int, track=False,
            help="Reference parallel worker count (inert here)"),
        "chunk_size": Option(
            default=1024, type=int, track=False,
            help="Reference parallel chunk size (inert here)"),
        "parallel_min_events": Option(
            default=20480, type=int, track=False,
            help="Reference parallel activation threshold (inert here)"),
    }

    def resolve_depends_on(self, context: Any, run_id: Optional[str] = None):
        return list(resolve_wave_input_spec(context, self).depends_on)

    # -- three-phase structure (shared with the fused subgraph executor) ----

    def kernel_config(self, context: Any) -> dict:
        """Resolve + validate every option the kernels depend on."""
        threshold = _normalize_threshold(context.get_config(self, "threshold"))
        backend = scan_backend(
            context.get_config(self, "peaks_backend"), context.device
        )
        if threshold is not None and backend == "scan":
            # the streaming-scan kernel does not carry the neighbor-diff
            # state the threshold condition needs; the plain formulation
            # does (ops/peaks.py find_peaks_batch) — route there
            backend = "xla"
        return {
            "threshold": threshold,
            "use_derivative": bool(context.get_config(self, "use_derivative")),
            "height": float(context.get_config(self, "height")),
            "distance": int(context.get_config(self, "distance")),
            "prominence": float(context.get_config(self, "prominence")),
            "width": float(context.get_config(self, "width")),
            "height_method": context.get_config(self, "height_method"),
            "height_window_extension": int(
                context.get_config(self, "height_window_extension")
            ),
            "dt": context.get_config(self, "dt"),
            "max_peaks": int(context.get_config(self, "max_peaks_per_waveform")),
            "backend": backend,
            "overflow_policy": context.get_config(self, "overflow_policy"),
        }

    @staticmethod
    def device_stage(
        cfg: dict,
        waves_d: torch.Tensor,
        lengths_d: torch.Tensor,
        sign_d: torch.Tensor,
        baselines_d: torch.Tensor,
    ) -> dict:
        """Composable device program: detection signal -> peaks.

        ``waves_d`` may be int16 or float32; converted on device so the
        fused executor uploads the raw wave matrix exactly once.
        """
        w32 = waves_d.to(torch.float32)
        if cfg["use_derivative"]:
            det = sign_d[:, None] * (w32[:, 1:] - w32[:, :-1])
            det_len = (lengths_d - 1).clamp(min=0)
        else:
            det = sign_d[:, None] * (w32 - baselines_d[:, None].to(torch.float32))
            det_len = lengths_d
        if cfg["backend"] == "scan":
            from waveformanalysis_tpu_torch.ops.chain_scan_cuda import (
                find_peaks_scan,
            )

            results = find_peaks_scan(
                det, height=cfg["height"], prominence=cfg["prominence"],
                width=cfg["width"], distance=cfg["distance"],
                max_peaks=cfg["max_peaks"],
                valid_length=det_len.to(torch.int32),
            )
        else:
            results = PK.find_peaks_batch(
                det, height=cfg["height"], prominence=cfg["prominence"],
                width=cfg["width"], distance=cfg["distance"],
                max_peaks=cfg["max_peaks"],
                valid_length=det_len.to(torch.int32),
                threshold=cfg.get("threshold"),
            )
        results = dict(results)
        results["peak_heights"] = PK.peak_heights_batch(
            w32,
            results["left_ips"], results["right_ips"], results["valid"],
            method=cfg["height_method"],
            window_extension=cfg["height_window_extension"],
        )
        return results

    # slot fields the finalize step consumes, in the order the fused
    # executor's device compaction packs them (fusion.py _SLOT_FIELDS)
    COMPACT_SLOT_FIELDS = ("position", "peak_heights", "left_ips", "right_ips")

    def _check_overflow(self, cfg: dict, overflow: int) -> None:
        if overflow and cfg.get("overflow_policy", "warn") != "ignore":
            msg = (
                f"hit: {overflow} waveforms exceeded the "
                f"{cfg['max_peaks']}-peak device capacity; excess peaks "
                f"dropped (raise max_peaks_per_waveform or set "
                f"overflow_policy)"
            )
            if cfg.get("overflow_policy") == "raise":
                raise ValueError(msg)
            logger.warning(msg)

    def _resolve_dt(self, cfg: dict, meta: dict, n: int) -> np.ndarray:
        dt = meta["dt"] if meta["dt"] is not None else None
        if dt is None:
            if cfg["dt"] is None:
                raise ValueError("[hit] dt must be provided (config or data)")
            dt = np.full(n, int(cfg["dt"]), dtype=np.int64)
        if np.any(dt <= 0):
            raise ValueError("[hit] dt must be > 0")
        return dt

    def finalize(self, cfg: dict, results: dict, meta: dict, n: int) -> Table:
        """Host compaction of the device outputs into the hit Table."""
        heights = results.pop("peak_heights")
        results = {k: to_numpy(v) for k, v in results.items()}
        self._check_overflow(
            cfg, int(np.sum(results["n_candidates"] > cfg["max_peaks"]))
        )
        dt = self._resolve_dt(cfg, meta, n)
        cols = PK.compact_hits(
            results, to_numpy(heights),
            timestamps=meta["timestamp"], boards=meta["board"],
            channels=meta["channel"], record_ids=meta["record_id"], dt_ns=dt,
        )
        return Table(cols, schema=HIT_SCHEMA)

    def finalize_compact(
        self, cfg: dict, rows: np.ndarray, slots: dict, overflow: int,
        meta: dict, n: int,
    ) -> Table:
        """Finalize from device-compacted per-hit slot values (fused path).

        ``slots`` holds one flat array per COMPACT_SLOT_FIELDS entry, already
        restricted to valid slots in row-major order; ``rows`` maps each hit
        to its source waveform. Bit-identical to ``finalize`` (the device
        compaction gathers the same leaves ``compact_hits`` would).
        """
        self._check_overflow(cfg, overflow)
        dt = self._resolve_dt(cfg, meta, n)
        cols = PK.hit_columns_from_flat(
            rows=rows, position=slots["position"],
            heights=slots["peak_heights"], left_ips=slots["left_ips"],
            right_ips=slots["right_ips"],
            timestamps=meta["timestamp"], boards=meta["board"],
            channels=meta["channel"], record_ids=meta["record_id"], dt_ns=dt,
        )
        return Table(cols, schema=HIT_SCHEMA)

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> Table:
        cfg = self.kernel_config(context)
        waves, lengths, meta = _load_wave_matrix(context, self, run_id)
        n = len(lengths)
        if n == 0:
            return Table.zeros(0, HIT_SCHEMA)

        from waveformanalysis_tpu_torch.ops.compact import compact_rows

        dev = context.device
        sign = np.where(meta["polarity"] > 0, 1.0, -1.0).astype(np.float32)
        out = self.device_stage(
            cfg, to_device(waves, dev), to_device(lengths.astype(np.int32), dev),
            to_device(sign, dev), to_device(meta["baseline"].astype(np.float32), dev),
        )
        rows, slots = compact_rows(out, self.COMPACT_SLOT_FIELDS)
        overflow = int((out["n_candidates"] > cfg["max_peaks"]).sum())
        return self.finalize_compact(cfg, rows, slots, overflow, meta, n)


def _load_wave_matrix(
    context: Any, plugin: Plugin, run_id: str, keep_integer_waves: bool = False
):
    """(waves, lengths, meta columns) from the configured flat-array source.

    ``keep_integer_waves`` is the records source's option to keep its native
    integer dtype; that source is not ported, and flat sources always keep
    the wave column's dtype.
    """
    wave_input = load_wave_input(context, plugin, run_id, needs_wave_samples=True)
    data = wave_input.waveform_data
    n = len(data)
    waves = wave_matrix_view(data["wave"])
    lengths = (
        np.asarray(data["event_length"], dtype=np.int64)
        if "event_length" in data
        else np.full(n, waves.shape[1], dtype=np.int64)
    )
    meta = {
        "baseline": np.asarray(data["baseline"], dtype=np.float64)
        if "baseline" in data else np.zeros(n),
        "polarity": np.asarray(data["polarity"], dtype=np.int8)
        if "polarity" in data else np.full(n, -1, np.int8),
        "timestamp": np.asarray(data["timestamp"], dtype=np.int64)
        if "timestamp" in data else np.zeros(n, np.int64),
        "board": np.asarray(data["board"], dtype=np.int16)
        if "board" in data else np.zeros(n, np.int16),
        "channel": np.asarray(data["channel"], dtype=np.int16)
        if "channel" in data else np.zeros(n, np.int16),
        "record_id": np.asarray(data["record_id"], dtype=np.int64)
        if "record_id" in data else np.arange(n, dtype=np.int64),
        "dt": np.asarray(data["dt"], dtype=np.int64) if "dt" in data else None,
    }
    return waves, lengths, meta
