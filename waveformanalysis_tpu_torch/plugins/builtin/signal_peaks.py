"""signal_peaks_stream plugin: chunked streaming peak detection.

Behavioral analog of the reference streaming peak finder
(reference: waveform_analysis/core/plugins/builtin/streaming/cpu/
signal_peaks.py:36): streams filtered (or raw) waveforms in chunks and emits
HIT-shaped chunks; never persisted (save_when=never). Each chunk runs the
batched find_peaks device stage instead of a per-waveform scipy loop.

Port of ``waveformanalysis_tpu/plugins/builtin/signal_peaks.py``. The stage
follows the ``hit`` plugin's rule for its kernel: on a CUDA device with no
``threshold`` it calls ``find_peaks_scan``, the find_peaks kernel (K2), at
``find_peaks_batch``'s default capacity; with a threshold set (K2 has no
neighbor-threshold condition), and on the CPU, the plain
``find_peaks_batch``.
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import to_device, to_numpy
from waveformanalysis_tpu_torch.dtypes.chunk import Chunk
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.ops import peaks as PK
from waveformanalysis_tpu_torch.plugins.base import Option
from waveformanalysis_tpu_torch.plugins.builtin.peak_finding import HIT_SCHEMA
from waveformanalysis_tpu_torch.plugins.streaming import StreamingConfig, StreamingPlugin

logger = logging.getLogger(__name__)


class SignalPeaksStreamPlugin(StreamingPlugin):
    """Streamed peak detection over waveform chunks."""

    provides = "signal_peaks_stream"
    depends_on: List[str] = []
    description = "Streaming peak detection over filtered waveforms."
    version = "1.2.0"  # 1.2: neighbor-threshold condition supported
    kernel_version = PK.KERNEL_VERSION
    save_when = "never"
    output_dtype = HIT_SCHEMA
    options = {
        "use_filtered": Option(default=True, type=bool,
                               help="Prefer filtered_waveforms when registered"),
        "use_derivative": Option(default=True, type=bool,
                                 help="Detect on the first derivative (True) "
                                      "or the baseline-corrected signal"),
        "height": Option(default=30.0, type=float, help="Minimum peak height"),
        "distance": Option(default=2, type=int, help="Minimum peak separation"),
        "prominence": Option(default=0.7, type=float, help="Minimum prominence"),
        "width": Option(default=4, type=int, help="Minimum peak width"),
        "threshold": Option(default=None,
                            help="scipy neighbor threshold: scalar min or "
                                 "(min, max) vertical distance to both "
                                 "direct neighbor samples"),
        "height_method": Option(default="diff", type=str,
                                choices=["diff", "minmax"],
                                help="Peak height: integrated -diff between "
                                     "edges, or window max-min"),
        "minmax_window_expand": Option(default=2, type=int,
                                       help="minmax window extension "
                                            "(samples each side)"),
        "dt": Option(default=None, type=int, help="Sample interval fallback (ns)"),
        "streaming_config": Option(
            default=None, type=dict, track=False,
            help="Streaming knobs; default chunk_size 4096",
        ),
    }

    def resolve_depends_on(self, context: Any, run_id: Optional[str] = None):
        use_filtered = context.get_config(self, "use_filtered")
        if use_filtered and "filtered_waveforms" in context.plugins:
            return ["filtered_waveforms", "st_waveforms"]
        return ["st_waveforms"]

    def input_stream(self, context: Any, run_id: str, cfg: StreamingConfig):
        if cfg.chunk_size == StreamingConfig().chunk_size:
            cfg.chunk_size = 4096  # reference default for this plugin
        deps = self.resolve_depends_on(context, run_id)
        from waveformanalysis_tpu_torch.plugins.streaming import data_to_chunks

        data = context.get_data(run_id, deps[0])
        yield from data_to_chunks(data, run_id=run_id, data_type=deps[0], cfg=cfg)

    # -- device chunk hooks (plugins/streaming.py _compute_device): the SAME
    # three phases back compute_chunk, so the host serial/thread paths and
    # the device executor are numerically identical per row.
    device_parallel = True

    def device_stream_config(self, context: Any) -> dict:
        from waveformanalysis_tpu_torch.plugins.builtin.peak_finding import (
            _normalize_threshold,
        )

        return {
            "threshold": _normalize_threshold(
                context.get_config(self, "threshold")
            ),
            "use_derivative": bool(context.get_config(self, "use_derivative")),
            "height": float(context.get_config(self, "height")),
            "distance": int(context.get_config(self, "distance")),
            "prominence": float(context.get_config(self, "prominence")),
            "width": float(context.get_config(self, "width")),
            "height_method": str(context.get_config(self, "height_method")),
            "minmax_window_expand": int(
                context.get_config(self, "minmax_window_expand")
            ),
        }

    def device_chunk_inputs(
        self, context: Any, run_id: str, chunk: Chunk
    ) -> dict:
        data = chunk.data
        if not isinstance(data, Table):
            data = Table.from_numpy(data)
        n = len(data)
        waves = to_numpy(data["wave"]).astype(np.float32)
        pol = to_numpy(data["polarity"]).astype(np.int8) \
            if "polarity" in data else np.full(n, -1, np.int8)
        lengths = to_numpy(data["event_length"]).astype(np.int64) \
            if "event_length" in data else np.full(n, waves.shape[1], np.int64)
        baselines = (
            to_numpy(data["baseline"]).astype(np.float64)
            if "baseline" in data else np.zeros(n, np.float64)
        )
        return {
            "waves": waves,
            "sign": np.where(pol > 0, 1.0, -1.0).astype(np.float32),
            "lengths": lengths.astype(np.int32),
            "baselines": baselines.astype(np.float32),
        }

    @staticmethod
    def device_chunk_stage(cfg: dict, inputs: dict) -> dict:
        """Per-chunk device stage on tensors (rows independent, so outputs
        per row do not depend on the batch shape)."""
        waves = inputs["waves"]
        sign = inputs["sign"]
        # reference semantics (streaming/cpu/signal_peaks.py:313-320):
        # -diff(waveform) when use_derivative, else baseline - waveform —
        # generalized polarity-aware (sign = -1 for negative/unknown
        # reproduces the reference exactly; +1 supports positive pulses the
        # reference cannot detect)
        if cfg["use_derivative"]:
            det = sign[:, None] * (waves[:, 1:] - waves[:, :-1])
            det_len = (inputs["lengths"] - 1).clamp(min=0)
        else:
            det = sign[:, None] * (
                waves - inputs["baselines"][:, None].to(torch.float32)
            )
            det_len = inputs["lengths"]
        peak_kw = dict(
            height=cfg["height"], prominence=cfg["prominence"],
            width=cfg["width"], distance=cfg["distance"],
            max_peaks=PK.DEFAULT_MAX_PEAKS, valid_length=det_len,
        )
        if cfg.get("threshold") is None and det.device.type == "cuda":
            from waveformanalysis_tpu_torch.ops.chain_scan_cuda import (
                find_peaks_scan,
            )

            results = dict(find_peaks_scan(det, **peak_kw))
        else:
            results = dict(PK.find_peaks_batch(
                det, threshold=cfg.get("threshold"), **peak_kw
            ))
        results["peak_heights"] = PK.peak_heights_batch(
            waves, results["left_ips"], results["right_ips"],
            results["valid"], method=cfg["height_method"],
            window_extension=cfg["minmax_window_expand"],
        )
        return results

    def device_chunk_finalize(
        self, context: Any, run_id: str, chunk: Chunk, stage_out: dict
    ) -> Table:
        data = chunk.data
        if not isinstance(data, Table):
            data = Table.from_numpy(data)
        n = len(data)
        results = {k: to_numpy(v) for k, v in stage_out.items()}
        heights = results.pop("peak_heights")
        dt = to_numpy(data["dt"]).astype(np.int64) if "dt" in data else None
        if dt is None:
            dt_cfg = context.get_config(self, "dt")
            dt = np.full(n, int(dt_cfg or 2), dtype=np.int64)
        cols = PK.compact_hits(
            results, heights,
            timestamps=to_numpy(data["timestamp"]).astype(np.int64)
            if "timestamp" in data else np.zeros(n, np.int64),
            boards=to_numpy(data["board"]).astype(np.int16)
            if "board" in data else np.zeros(n, np.int16),
            channels=to_numpy(data["channel"]).astype(np.int16)
            if "channel" in data else np.zeros(n, np.int16),
            record_ids=to_numpy(data["record_id"]).astype(np.int64)
            if "record_id" in data else np.arange(n, dtype=np.int64),
            dt_ns=dt,
        )
        return Table(cols, schema=HIT_SCHEMA)

    def compute_chunk(self, context: Any, run_id: str, chunk: Chunk) -> Table:
        n = len(chunk.data)
        if n == 0:
            return Table.zeros(0, HIT_SCHEMA)
        cfg = self.device_stream_config(context)
        inputs = self.device_chunk_inputs(context, run_id, chunk)
        out = type(self).device_chunk_stage(
            cfg, {k: to_device(v, context.device) for k, v in inputs.items()}
        )
        return self.device_chunk_finalize(context, run_id, chunk, out)
