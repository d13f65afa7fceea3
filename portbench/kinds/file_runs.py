"""Closed-loop requests of ``Context.get_data`` over VX2730 run files.

Set-up makes ``events`` waveforms on the device from the seed with bench.py's
arithmetic (``portbench.gen.make_batch``), writes them as one VX2730 run of
the configuration's layout (2 channels x ``files`` CSV files) under a fresh
directory in the given TMPDIR, builds a Context over those files with the
configuration's profile and plugin settings and an on-disk cache, and makes
one request at the cell's own shapes (the kernels' and the native decoder's
build or load, and the first launch). In the window one client asks
``get_data(run, request)`` of a fresh run name each time, a symlink to the
seed's files (nothing is cached for it), and waits for it; the run in flight
at the deadline completes and counts, and the window ends after a final
``flush_saves()``, when every cached table is on disk: the end-to-end
metric is the cache's growth over the window per waveform served, and the
waveforms a second of the window (``files_waveforms_per_s``, which drifts
with the host's CPU) is read per layer. The Context's
profiler is the program's, with each span also recorded by the window's
``Recorder``. After the window two runs drawn from the seed are read back
from the cache for the check.
"""

from __future__ import annotations

import gc
import time
import traceback
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from portbench.gen import generator, link_run, make_batch, vx2730_arrays, vx2730_run


def _tuples(value):
    """JSON lists as the tuples the plugins' range options take."""
    if isinstance(value, list):
        return tuple(_tuples(v) for v in value)
    if isinstance(value, dict):
        return {k: _tuples(v) for k, v in value.items()}
    return value


def waves(config: dict, seed: int, device) -> np.ndarray:
    """The run's (events, L) int16 waves, made on ``device`` from the seed."""
    fmt = config["format"]
    return make_batch(int(config["events"]), int(fmt["wave_length"]),
                      generator(seed, device)).cpu().numpy()


def control_inputs(config: dict, params: dict, seed: int, device) -> dict:
    """What ``Driver.inputs`` gives after a run of this seed, without the run."""
    fmt = config["format"]
    return vx2730_arrays(waves(config, seed, device), int(fmt["row_dt_ps"]),
                         int(fmt["channel_offset_ps"]))


def tree_bytes(path: Path) -> int:
    """Bytes of the files under ``path``."""
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def span_profiler():
    """The program's Profiler, each of whose spans is also recorded by the
    ``Recorder`` set as its ``sink`` (none outside the window)."""
    from waveformanalysis_tpu_torch.foundation.profiler import Profiler

    class SpanProfiler(Profiler):
        sink = None

        @contextmanager
        def time(self, key, result=None):
            sink = self.sink
            with super().time(key, result):
                if sink is None:
                    yield
                else:
                    with sink.span(key):
                        yield

    return SpanProfiler()


class Driver:
    def __init__(self, config: dict, workload: dict, seed: int, device: torch.device,
                 workdir: Path) -> None:
        self.config, self.workload, self.seed, self.dev = config, workload, seed, device
        self.n = int(config["events"])
        self.workdir = workdir
        self.request = list(workload["request"])
        self.runs: list = []
        self.ctx = None

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def setup(self) -> None:
        from waveformanalysis_tpu_torch.context.context import Context
        from waveformanalysis_tpu_torch.plugins.plugin_sets import get_profile

        fmt = self.config["format"]
        t = time.perf_counter()
        self.daq = str(self.workdir / "daq")
        self.arrays = vx2730_run(self.daq, "seed", waves(self.config, self.seed, self.dev),
                                 int(fmt["files"]), int(fmt["row_dt_ps"]),
                                 int(fmt["channel_offset_ps"]))
        self.setup_phases = {"write_files": time.perf_counter() - t}
        ctx_config = dict(self.config["context"], data_root=self.daq, device=self.dev.type)
        self.ctx = Context(storage_dir=str(self.workdir / "cache"), config=ctx_config,
                           profiler=span_profiler())
        self.ctx.register(*get_profile(self.config["profile"]))
        self.ctx.set_config(_tuples(self.config["plugins"]))
        t = time.perf_counter()
        self.ctx.get_data(link_run(self.daq, "seed", "warm"), self.request)
        self.sync()
        self.setup_phases["first_request"] = time.perf_counter() - t
        t = time.perf_counter()
        self.ctx.flush_saves()
        self.setup_phases["first_flush"] = time.perf_counter() - t

    def window(self, seconds: float, rec) -> dict:
        ctx = self.ctx
        ctx.profiler.reset()
        ctx.profiler.sink = rec
        walls, failed = [], 0
        cache0 = tree_bytes(self.workdir / "cache")
        t0 = time.perf_counter()
        while True:
            run = link_run(self.daq, "seed", f"w{len(walls)}")
            s0 = time.perf_counter()
            with rec.span("portbench.request"):
                try:
                    ctx.get_data(run, self.request)
                    self.sync()
                    self.runs.append(run)
                except Exception:  # a failed request counts against the run
                    failed += 1
                    traceback.print_exc()
            walls.append(round(time.perf_counter() - s0, 6))
            if time.perf_counter() - t0 >= seconds:
                break
        with rec.span("portbench.flush"):
            ctx.flush_saves()
        window_s = time.perf_counter() - t0
        cache1 = tree_bytes(self.workdir / "cache")
        ctx.profiler.sink = None
        done = len(self.runs)
        e2e = {"cache_bytes_per_waveform": (cache1 - cache0) / (done * self.n)} if done else {}
        return {"end_to_end": e2e, "attempted": len(walls), "failed": failed,
                "counts": {"runs": done, "events": self.n, "waveforms": done * self.n,
                           "window_s": window_s, "cache_bytes": cache1 - cache0,
                           "files_bytes": tree_bytes(self.workdir / "daq") + cache1},
                "walls": walls}

    def answers(self, rng) -> list:
        """The compared tables of runs drawn from the seed, read back from
        the cache (nothing is computed for them again: that is checked)."""
        ctx = self.ctx
        picked = sorted(rng.sample(self.runs, min(int(self.workload["compared_runs"]),
                                                  len(self.runs))))
        before = {k: v["count"] for k, v in ctx.profiler.stats().items()}
        out = []
        for run in picked:
            tables = {}
            for name in self.workload["compared"]:
                data = ctx.get_data(run, name)
                tables[name] = data if hasattr(data, "iloc") else {
                    f: np.asarray(data[f]) for f in data.field_names}
            out.append((run, tables))
        again = sorted(k for k, v in ctx.profiler.stats().items()
                       if k.endswith("compute") and v["count"] > before.get(k, 0))
        if again:
            raise RuntimeError(f"reading the cached tables back computed {again}: a compared "
                               "table is not one the request saved")
        self.ctx = None
        del ctx
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def inputs(self) -> dict:
        return dict(self.arrays)

    def close(self) -> None:
        if self.ctx is not None:
            self.ctx.flush_saves()
            self.ctx = None
