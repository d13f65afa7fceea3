"""The port's span recorder: the Profiler's log of spans and counts, request
ids and parents across nested calls and the cache writer's thread, self
time, the bounded log, the module-level span and count, the Chrome trace
export, the host-device copy counts, and the benchmark's readers of the log
on a tiny VX2730 run on the CPU."""

import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.trace import Recorder
from waveformanalysis_tpu_torch.context.context import Context
from waveformanalysis_tpu_torch.device import to_device, to_host, to_numpy
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.foundation import profiler as P
from waveformanalysis_tpu_torch.plugins.base import Plugin

SEED = 2**31 + 977
NEW_METRICS = ("context_overhead_ms.run", "d2h_mb.run", "h2d_mb.run", "decode_mb_per_s.run",
               "saved_bytes_per_waveform.ingest", "saved_bytes_per_waveform.members",
               "saved_bytes_per_waveform.events")


def test_nested_spans_carry_parent_and_request():
    prof = P.Profiler()
    t0 = time.time_ns()
    with prof.request("req"):
        with prof.time("outer"):
            with P.span("inner"):
                P.count("things", 3)
    with prof.time("after"):
        pass
    spans = {s.key: s for s in P.spans(t0)}
    req, outer, inner = spans["req"], spans["outer"], spans["inner"]
    assert req.parent_id == 0 and outer.parent_id == req.span_id
    assert inner.parent_id == outer.span_id
    assert req.request_id > 0 and {outer.request_id, inner.request_id} == {req.request_id}
    assert spans["after"].request_id == 0 and spans["after"].parent_id == 0
    assert len({s.thread for s in spans.values()}) == 1 == len({threading.get_ident()})
    (c,) = P.counts(t0)
    assert (c.key, c.n, c.span_id, c.request_id) == ("things", 3, inner.span_id,
                                                     req.request_id)
    assert prof.counters() == {"things": 3}
    assert prof.stats()["inner"]["count"] == 1  # the module-level span reached prof


def test_self_time_is_duration_less_the_children():
    prof = P.Profiler()
    t0 = time.time_ns()
    with prof.time("parent"):
        for _ in range(2):
            with prof.time("child"):
                time.sleep(0.002)
        time.sleep(0.001)
    spans = P.spans(t0)
    (parent,) = [s for s in spans if s.key == "parent"]
    children = [s for s in spans if s.key == "child"]
    assert all(c.parent_id == parent.span_id for c in children)
    duration = parent.end_ns - parent.start_ns
    st = prof.stats()["parent"]
    assert st["self_s"] == pytest.approx(
        (duration - sum(c.end_ns - c.start_ns for c in children)) / 1e9, abs=1e-12)
    assert st["total_s"] == pytest.approx(duration / 1e9, abs=1e-12)
    assert prof.stats()["child"]["self_s"] == prof.stats()["child"]["total_s"]
    assert "self(s)" in prof.summary() and "counter" not in prof.summary()


def test_log_is_bounded_and_counts_drops(monkeypatch):
    monkeypatch.setattr(P, "_LOG", P._Log(4))
    prof = P.Profiler()
    t0 = time.time_ns()
    for i in range(6):
        with prof.time(f"k{i}"):
            pass
    assert P.dropped() == 2
    with pytest.raises(RuntimeError, match="dropped"):
        P.spans(t0)
    oldest_end = P._LOG._records[0][3]
    assert [s.key for s in P.spans(oldest_end)] == ["k2", "k3", "k4", "k5"]
    assert prof.stats()["k0"]["count"] == 1  # the aggregates keep everything


def test_module_span_reaches_an_overriding_time():
    seen = []

    class Sub(P.Profiler):
        def time(self, key, result=None):
            seen.append(key)
            return super().time(key, result)

    prof = Sub()
    with prof.time("outer"):
        with P.span("inner"):
            pass
        P.count("n", 2)
    assert seen == ["outer", "inner"] and prof.counters() == {"n": 2}
    with P.span("nobody"):  # no active profiler: nothing is recorded
        pass
    assert seen == ["outer", "inner"]


def test_count_without_an_active_profiler_goes_to_the_log():
    prof = P.Profiler()
    t0 = time.time_ns()
    P.count("loose", 7)
    (c,) = P.counts(t0)
    assert (c.key, c.n, c.span_id, c.request_id) == ("loose", 7, 0, 0)
    assert prof.counters() == {}


def test_chrome_trace_export(tmp_path):
    prof = P.Profiler()
    t0 = time.time_ns()
    with prof.request("req"):
        with prof.time("work"):
            prof.count("bytes", 10)
            prof.count("bytes", 5)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path), t0)
    events = json.loads(path.read_text())["traceEvents"]
    xs = {e["name"]: e for e in events if e["ph"] == "X"}
    cs = [e for e in events if e["ph"] == "C"]
    assert set(xs) == {"req", "work"}
    assert xs["work"]["args"]["parent_id"] == xs["req"]["args"]["span_id"]
    assert xs["work"]["ts"] >= xs["req"]["ts"] and xs["work"]["dur"] <= xs["req"]["dur"]
    assert xs["req"]["ts"] == pytest.approx(t0 / 1e3, abs=1e6)  # microseconds, same clock
    assert [c["args"]["total"] for c in cs] == [10, 15]


@pytest.mark.parametrize("columns", ["numpy", "cpu_tensors"])
def test_host_tables_count_no_copies(columns):
    cols = {"a": np.arange(6, dtype=np.int32), "w": np.ones((6, 4), np.float32)}
    if columns == "cpu_tensors":
        cols = {k: torch.from_numpy(v) for k, v in cols.items()}
    table = Table(cols)
    t0 = time.time_ns()
    host = table.to_host()
    table.row(2)
    table.to_numpy()
    Table.concatenate([table.to_device("cpu"), table])
    to_numpy(host["w"])
    to_host(table)
    to_device(host["a"], torch.device("cpu"))
    assert [c for c in P.counts(t0) if c.key.startswith("device.")] == []


def test_upload_to_the_card_counts_its_bytes(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "to", lambda self, *a, **k: self)  # no card here
    t0 = time.time_ns()
    to_device(np.zeros((3, 5), np.int16), "cuda")
    Table({"x": np.zeros(4, np.float64)}).to_device(torch.device("cuda"))
    assert [(c.key, c.n) for c in P.counts(t0)] == [("device.h2d_bytes", 30),
                                                     ("device.h2d_bytes", 32)]


class _Inner(Plugin):
    provides = "inner"
    version = "1.0"
    save_when = "always"

    def compute(self, context, run_id, **kwargs):
        return Table({"x": np.arange(5, dtype=np.int64)})


class _Outer(Plugin):
    """Reads ``inner`` through get_data inside its compute (undeclared, so
    the nested call computes it)."""

    provides = "outer"
    version = "1.0"
    save_when = "always"

    def compute(self, context, run_id, **kwargs):
        inner = context.get_data(run_id, "inner")
        return Table({"y": np.asarray(inner["x"]) * 2})


def test_nested_get_data_and_the_writer_stay_in_the_request(tmp_path):
    ctx = Context(storage_dir=str(tmp_path), config={"device": "cpu"})
    ctx.register(_Inner(), _Outer())
    t0 = time.time_ns()
    ctx.get_data("run0", "outer")
    ctx.flush_saves()
    spans = P.spans(t0)
    (req,) = [s for s in spans if s.key == "context.get_data"]
    assert req.parent_id == 0 and req.thread == threading.get_ident()
    assert {s.request_id for s in spans} == {req.request_id}
    by_id = {s.span_id: s for s in spans}

    def ancestors(s):
        while s.parent_id:
            s = by_id[s.parent_id]
            yield s.key

    (inner,) = [s for s in spans if s.key == "plugin.inner.compute"]
    assert "plugin.outer.compute" in list(ancestors(inner))
    saves = [s for s in spans if s.key == "context.save_cache"]
    post = {s.span_id: s.key for s in spans if s.key.endswith(".postprocess")}
    assert len(saves) == 2 and all(s.thread != req.thread for s in saves)
    assert sorted(post[s.parent_id] for s in saves) == ["plugin.inner.postprocess",
                                                        "plugin.outer.postprocess"]
    saved = {c.key: c.n for c in P.counts(t0) if c.key.startswith("cache.bytes_written.")}
    assert set(saved) == {"cache.bytes_written.inner", "cache.bytes_written.outer"}
    assert all(v > 0 for v in saved.values())
    assert "self(s)" in ctx.get_performance_report()


def _tiny_tables_window(tmp_path):
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    spec = harness.cell(manifest, "vx2730_default.tables")
    spec.config["events"] = 1024
    kind = harness.load_named("kinds", "file_runs")
    d = kind.Driver(spec.config, spec.workload, SEED, torch.device("cpu"), tmp_path)
    try:
        d.setup()
        with Recorder(trace=False, cuda=False) as rec:
            out = d.window(0.3, rec)
    finally:
        d.close()
    run = SimpleNamespace(rec=rec, device=rec.device_summary(), window_s=rec.window_s,
                          counts=out["counts"], written_bytes=None, workload=spec.workload,
                          config=spec.config)
    return run, out


def test_readers_on_a_tiny_vx2730_run(tmp_path, monkeypatch):
    run, out = _tiny_tables_window(tmp_path)
    counts = P.counts(run.rec.t0, run.rec.t1)
    saved = sum(c.n for c in counts if c.key.startswith("cache.bytes_written."))
    assert saved == out["counts"]["cache_bytes"] > 0
    values = {m: harness.load_named("metrics", m).read(run) for m in NEW_METRICS}
    assert all(isinstance(v, float) for v in values.values()), values
    assert values["d2h_mb.run"] == values["h2d_mb.run"] == 0  # no card: no copies
    assert all(v > 0 for m, v in values.items() if not m.endswith("_mb.run")), values
    per_wf = out["end_to_end"]["cache_bytes_per_waveform"]
    assert sum(v for m, v in values.items() if m.startswith("saved_bytes")) == pytest.approx(
        per_wf, rel=1e-12)
    files = sum(p.stat().st_size for p in (tmp_path / "daq" / "seed").rglob("*.CSV"))
    decoded = sum(c.n for c in counts if c.key == "st_waveforms.decode_bytes")
    assert decoded == files * run.counts["runs"]
    # a program without the log (the benchmark's readers meet older ones)
    monkeypatch.delattr(P, "spans")
    assert all(harness.load_named("metrics", m).read(run) is None for m in NEW_METRICS)
