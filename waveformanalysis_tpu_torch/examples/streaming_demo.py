"""Chunked streaming execution: halos, break segmentation, clipping.

    python -m waveformanalysis_tpu_torch.examples.streaming_demo [--device cuda]

The port's counterpart of the JAX package's examples/streaming_demo.py.
Runs a windowed stream plugin over a synthetic run through the
StreamingContext, showing chunk iteration with time-window clipping, and
demonstrates the core invariant directly: a windowed kernel streamed with
halo extensions produces exactly the unchunked result. Then it streams the
static ``hit`` plugin chunk by chunk through the device chunk executor
(``executor_type="device"``: the find_peaks kernel once per chunk on a
CUDA device) and checks that the merged chunks equal the static table.
Runs on ``--device`` (default ``cuda``; ``--device cpu`` runs the plain
versions on the CPU).
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Any, Dict, Optional, Sequence

import numpy as np

from waveformanalysis_tpu_torch.plugins.streaming import StreamingPlugin


class MovingAverage(StreamingPlugin):
    """Average `value` over rows within +-window_ns — needs halo rows to be
    correct at chunk boundaries."""

    provides = "smoothed"
    depends_on = ["readings"]
    version = "1.0"
    WINDOW_NS = 5

    def compute_chunk(self, context, run_id, chunk):
        t = np.asarray(chunk.data["time"], np.int64)
        v = np.asarray(chunk.data["value"], np.float64)
        win = self.WINDOW_NS * 1000  # ps
        lo = np.searchsorted(t, t - win, "left")
        hi = np.searchsorted(t, t + win, "right")
        csum = np.concatenate([[0.0], np.cumsum(v)])
        return chunk.data.with_columns(value=(csum[hi] - csum[lo]) / (hi - lo))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the demo; returns what it checked."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device of the device chunk stages (default cuda)")
    parser.add_argument("--events", type=int, default=2048,
                        help="waveforms of the hit stream's run")
    args = parser.parse_args(argv)

    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.dtypes.table import Table
    from waveformanalysis_tpu_torch.plugins.plugin_sets import get_profile
    from waveformanalysis_tpu_torch.plugins.streaming import get_streaming_context
    from waveformanalysis_tpu_torch.testing.fixtures import make_fake_st_waveforms

    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(storage_dir=tmp,
                      config={"show_progress": False, "device": args.device})
        print(f"device: {ctx.device}")
        rng = np.random.default_rng(0)
        times = np.cumsum(rng.integers(1000, 5000, 200)).astype(np.int64)
        readings = Table({
            "time": times,
            "dt": np.full(200, 2, np.int32),
            "channel": np.zeros(200, np.int16),
            "value": rng.normal(100, 15, 200),
        })
        ctx.inject_data("demo", "readings", readings)
        ctx.register(MovingAverage())
        ctx.set_config({"smoothed": {"streaming_config": {
            "chunk_size": 32,
            "required_halo_ns": MovingAverage.WINDOW_NS,
        }}})

        sctx = get_streaming_context(ctx)
        chunks = list(sctx.get_stream("demo", "smoothed"))
        print(f"streamed {len(chunks)} chunks:")
        for c in chunks[:4]:
            print(f"  [{c.start:>9} .. {c.end:>9}) ps  {len(c.data)} rows")
        streamed = np.concatenate([np.asarray(c.data["value"]) for c in chunks])

        whole = MovingAverage().compute_chunk(
            None, "demo", type("C", (), {"data": readings})())
        assert np.allclose(streamed, np.asarray(whole["value"]))
        print("chunk-invariance verified: streamed == unchunked "
              f"({len(streamed)} rows)")

        # ctx.get_data on a stream plugin returns its chunk generator
        out = list(ctx.get_data("demo", "smoothed"))
        print(f"via Context: {len(out)} chunks")

        # a static plugin streamed through the device chunk executor
        ctx.register(*get_profile("streaming"))
        ctx.inject_data("waves", "st_waveforms", make_fake_st_waveforms(
            n_events=args.events, wave_length=128, n_channels=2,
            pulse_height=300, seed=1))
        dev_chunks = list(sctx.get_stream("waves", "hit", chunk_size=512,
                                          executor_type="device"))
        merged = sctx.merge_stream(dev_chunks, sort=False).to_numpy()
        static = ctx.get_data("waves", "hit").to_numpy()
        merged = merged[np.lexsort((merged["position"], merged["record_id"]))]
        static = static[np.lexsort((static["position"], static["record_id"]))]
        same = len(merged) == len(static) and all(
            np.array_equal(merged[f], static[f]) for f in static.dtype.names)
        assert same, "the device stream of hit differs from the static table"
        print(f"hit through the device chunk executor: {len(dev_chunks)} chunks, "
              f"{len(merged)} hits = the static table")
        ctx.flush_saves()  # the static hit's save, before its directory goes
        return {"chunks": len(chunks), "rows": len(streamed),
                "hit_chunks": len(dev_chunks), "hits": len(merged)}


if __name__ == "__main__":
    main()
