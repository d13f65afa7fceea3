"""Closed-loop requests of ``Context.get_data`` over V1725 DAW runs read
through the records set: sixteen self-triggered channels, each record at
its own length.

The ``records_runs`` kind's ``Driver`` (imported) with another run: set-up
draws the run's records on the device from the seed
(``portbench.gen_v1725.daw_run``: one record a channel an interaction,
lengths drawn per record) and writes them as one board's DAW_DEMO files
(``write_daw_files``, the configuration's ``files``); the records plugins
read them through the V1725 adapter (``wave_source`` ``records`` in the
configuration). The run holds ``events`` records in all, the workload's
``events`` where it gives one (the tests shrink a cell so), else the
configuration's. The window, the client, the end-to-end metric and the
read-back of two runs for the check are ``records_runs``'.
"""

from __future__ import annotations

import os
import time

from portbench.gen import link_run
from portbench.gen_v1725 import daw_run, write_daw_files
from portbench.kinds.file_runs import _tuples, span_profiler
from portbench.kinds.records_runs import Driver as RecordsDriver
from portbench.kinds.records_runs import events


def control_inputs(config: dict, params: dict, seed: int, device) -> dict:
    """What ``Driver.inputs`` gives after a run of this seed, without the run
    (and so with no file epoch)."""
    return dict(daw_run(config["format"], events(config, params), seed, device), epoch_ns=0)


class Driver(RecordsDriver):
    def setup(self) -> None:
        from waveformanalysis_tpu_torch.context.context import Context
        from waveformanalysis_tpu_torch.plugins.plugin_sets import get_profile

        fmt = self.config["format"]
        t = time.perf_counter()
        self.daq = str(self.workdir / "daq")
        arrays = daw_run(fmt, self.n, self.seed, self.dev)
        paths = write_daw_files(self.daq, "seed", arrays, int(fmt["channels"]),
                                int(fmt["files"]))
        # the records' system time counts from the run's first file's ctime
        arrays["epoch_ns"] = int(os.stat(paths[0]).st_ctime * 1e9)
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
