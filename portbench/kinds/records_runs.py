"""Closed-loop requests of ``Context.get_data`` over VX2730 runs read through
the records set, each channel at its own record length.

The ``file_runs`` kind's ``Driver`` (imported) with another run: set-up
makes each channel's waves on the device from the seed with bench.py's
arithmetic (``portbench.gen.make_batch``) at that channel's length of the
configuration's ``format.wave_lengths`` (channel 0's batch drawn first),
and writes them as one VX2730 run of ``files`` CSV files a channel; the
records plugins read it (``wave_source`` ``records`` in the configuration).
The run holds ``events`` records in all, the workload's ``events`` where it
gives one (the tests shrink a cell so), else the configuration's, half of
them on each channel. The window, the client and the end-to-end metric are
``file_runs``': one client asks ``get_data(run, request)`` of a fresh run
name each time, and the window ends after a final ``flush_saves()``. The
compared tables of two runs drawn from the seed are read back from the
cache, the sample pools (``wave_pool``, ``wave_pool_filtered``) as one
column each.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from portbench.gen import generator, link_run, make_batch, write_vx2730_run
from portbench.kinds.file_runs import Driver as FilesDriver
from portbench.kinds.file_runs import _tuples, span_profiler


def events(config: dict, params: dict) -> int:
    return int(params.get("events", config["events"]))


def channel_waves(config: dict, n: int, seed: int, device) -> list:
    """Each channel's (n / 2, L_c) int16 waves, made on ``device`` from the seed."""
    gen = generator(seed, device)
    return [make_batch(n // 2, int(L), gen).cpu().numpy()
            for L in config["format"]["wave_lengths"]]


def run_arrays(waves: list, dt_ps: int, offset_ps: int, epoch_ns: int = 0) -> dict:
    """The arrays of the run, by channel: channel c's row i is at
    ``i * dt_ps + c * offset_ps``; ``epoch_ns`` is the run's file epoch."""
    return {"waves": waves,
            "timestamps": [np.arange(len(w), dtype=np.int64) * dt_ps + c * offset_ps
                           for c, w in enumerate(waves)],
            "epoch_ns": int(epoch_ns)}


def control_inputs(config: dict, params: dict, seed: int, device) -> dict:
    """What ``Driver.inputs`` gives after a run of this seed, without the run
    (and so with no file epoch)."""
    fmt = config["format"]
    return run_arrays(channel_waves(config, events(config, params), seed, device),
                      int(fmt["row_dt_ps"]), int(fmt["channel_offset_ps"]))


class Driver(FilesDriver):
    def __init__(self, config, workload, seed, device, workdir) -> None:
        super().__init__(config, workload, seed, device, workdir)
        self.n = events(config, workload)

    def setup(self) -> None:
        from waveformanalysis_tpu_torch.context.context import Context
        from waveformanalysis_tpu_torch.plugins.plugin_sets import get_profile

        fmt = self.config["format"]
        t = time.perf_counter()
        self.daq = str(self.workdir / "daq")
        arrays = run_arrays(channel_waves(self.config, self.n, self.seed, self.dev),
                            int(fmt["row_dt_ps"]), int(fmt["channel_offset_ps"]))
        paths = [write_vx2730_run(self.daq, "seed", w, ts, c, n_files=int(fmt["files"]))
                 for c, (w, ts) in enumerate(zip(arrays["waves"], arrays["timestamps"]))]
        # the records' system time counts from the run's first file's ctime
        arrays["epoch_ns"] = int(os.stat(paths[0][0]).st_ctime * 1e9)
        self.arrays = arrays
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

    def answers(self, rng) -> list:
        """The compared tables of runs drawn from the seed, read back from
        the cache (nothing is computed for them again: that is checked); a
        sample pool is a table of one column named after it."""
        ctx = self.ctx
        picked = sorted(rng.sample(self.runs, min(int(self.workload["compared_runs"]),
                                                  len(self.runs))))
        before = {k: v["count"] for k, v in ctx.profiler.stats().items()}
        out = []
        for run in picked:
            tables = {}
            for name in self.workload["compared"]:
                data = ctx.get_data(run, name)
                if isinstance(data, np.ndarray):
                    tables[name] = {name: data}
                elif hasattr(data, "iloc"):
                    tables[name] = data
                else:
                    tables[name] = {f: np.asarray(data[f]) for f in data.field_names}
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

