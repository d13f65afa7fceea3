"""The port's resident pipeline server against the JAX package's.

The cases of tests/test_server.py run against
``waveformanalysis_tpu_torch.server`` on a CPU Context (ping and stats,
persist and reload by a second Context, warm reuse, the batched op, errors
that are not fatal, an unknown op and bad JSON, a mixed soak); the row
counts of the same requests equal the JAX server's on the same injected
runs (exactly); ``shutdown`` waits for the async writer before it replies;
one ``python -m waveformanalysis_tpu_torch.server --device cpu`` process
serves a DAQ run whose persisted tables a second Context loads; without a
card the default device raises.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from utils import create_daq_run
from waveformanalysis_tpu_torch.context.context import Context
from waveformanalysis_tpu_torch.context.execution_domain import _PENDING_SAVES
from waveformanalysis_tpu_torch.plugins.builtin.basic_features import BasicFeaturesPlugin
from waveformanalysis_tpu_torch.plugins.builtin.dataframe import DataFramePlugin
from waveformanalysis_tpu_torch.plugins.builtin.event_analysis import GroupedEventsPlugin
from waveformanalysis_tpu_torch.server import PipelineServer, main, request, wait_ready
from waveformanalysis_tpu_torch.testing.fixtures import make_fake_st_waveforms

ROOT = Path(__file__).resolve().parents[1]
N_EVENTS = 24


def fake_run(make, seed: int):
    st = make(n_events=N_EVENTS, pulse_height=300, polarity="positive", seed=seed)
    st["channel"] = (np.arange(N_EVENTS) % 2).astype(np.int16)
    return st


def make_context(storage_dir: str) -> Context:
    ctx = Context(storage_dir=storage_dir, config={"show_progress": False, "device": "cpu"})
    ctx.register(BasicFeaturesPlugin(), DataFramePlugin(), GroupedEventsPlugin())
    return ctx


def start(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    assert wait_ready(server.socket_path, timeout=30.0)
    return t


def stop(sock: str, t: threading.Thread) -> None:
    assert request(sock, {"op": "shutdown"})["bye"] is True
    t.join(timeout=30.0)
    assert not t.is_alive()


@pytest.fixture()
def short_dir():
    # unix socket paths are limited to about 107 bytes
    d = tempfile.mkdtemp(prefix="wfa")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture()
def running_server(tmp_path, short_dir):
    ctx = make_context(str(tmp_path / "store"))
    for i in range(3):
        ctx.inject_data(f"r{i}", "st_waveforms", fake_run(make_fake_st_waveforms, i))
    sock = f"{short_dir}/wfa.sock"
    t = start(PipelineServer(ctx, sock))
    yield ctx, sock
    stop(sock, t)


def test_ping_and_stats(running_server):
    _ctx, sock = running_server
    assert request(sock, {"op": "ping"})["pong"] is True
    stats = request(sock, {"op": "stats"})
    assert stats["ok"] and "df" in stats["registered"]


def test_get_data_computes_and_persists(running_server):
    ctx, sock = running_server
    resp = request(sock, {"op": "get_data", "run_id": "r0", "names": ["df_events"]})
    assert resp["ok"], resp
    assert resp["results"]["df_events"]["rows"] == N_EVENTS
    request(sock, {"op": "flush"})

    # a SEPARATE Context over the same storage reads the served result under
    # the port's own key (same inputs injected -> same lineage -> same key)
    ctx2 = make_context(str(ctx.storage_dir))
    ctx2.inject_data("r0", "st_waveforms", fake_run(make_fake_st_waveforms, 0))
    assert resp["results"]["df_events"]["key"] == ctx2.key_for("r0", "df_events")
    assert ctx2.cache_domain.is_cache_hit("r0", "df_events")
    assert len(ctx2.get_data("r0", "df_events")) == N_EVENTS
    assert not any(k.startswith("plugin.") for k in ctx2.profiler.stats())


def test_warm_second_request_is_cached(running_server):
    _ctx, sock = running_server
    r1 = request(sock, {"op": "get_data", "run_id": "r1", "names": ["basic_features"]})
    r2 = request(sock, {"op": "get_data", "run_id": "r1", "names": ["basic_features"]})
    assert r1["ok"] and r2["ok"]
    assert r2["seconds"] < r1["seconds"]
    assert r2["results"]["basic_features"]["key"] == r1["results"]["basic_features"]["key"]


def test_batched_op(running_server):
    _ctx, sock = running_server
    resp = request(sock, {"op": "get_data_batched", "run_ids": ["r0", "r1", "r2"],
                          "names": ["basic_features"]})
    assert resp["ok"], resp
    for rid in ("r0", "r1", "r2"):
        assert resp["results"][rid]["basic_features"]["rows"] == N_EVENTS


def test_error_reported_not_fatal(running_server):
    _ctx, sock = running_server
    resp = request(sock, {"op": "get_data", "run_id": "missing", "names": ["df"]})
    assert resp["ok"] is False and "error" in resp
    assert request(sock, {"op": "ping"})["pong"] is True


def test_unknown_op_and_bad_json(running_server):
    _ctx, sock = running_server
    assert request(sock, {"op": "dance"})["ok"] is False
    with socket.socket(socket.AF_UNIX) as s:
        s.connect(sock)
        s.sendall(b"this is not json\n")
        buf = s.recv(1 << 16)
    assert json.loads(buf)["ok"] is False


def test_soak_mixed_requests(running_server):
    """Interleaved computes, errors, malformed payloads and flushes leave the
    server healthy and the pending-save registry drained."""
    ctx, sock = running_server
    for i in range(40):
        if i % 7 == 3:
            assert request(sock, {"op": "get_data", "run_id": "nope",
                                  "names": ["df"]})["ok"] is False
        elif i % 11 == 5:
            assert request(sock, {"op": "nonsense"})["ok"] is False
        else:
            resp = request(sock, {"op": "get_data", "run_id": f"r{i % 3}",
                                  "names": ["basic_features", "df"]})
            assert resp["ok"], resp
    request(sock, {"op": "flush"})
    assert request(sock, {"op": "stats"})["requests"] >= 42
    root = str(ctx.storage_dir)
    assert not any(k[0] == root for k in _PENDING_SAVES), "flush must drain the writer"


def test_shutdown_waits_for_the_writer(tmp_path, short_dir):
    """The reply to shutdown comes after every pending save of the request
    before it is on disk."""
    ctx = make_context(str(tmp_path / "store"))
    ctx.inject_data("r0", "st_waveforms", fake_run(make_fake_st_waveforms, 0))
    sock = f"{short_dir}/wfa.sock"
    t = start(PipelineServer(ctx, sock))
    assert request(sock, {"op": "get_data", "run_id": "r0", "names": ["df_events"]})["ok"]
    assert request(sock, {"op": "shutdown"})["bye"] is True
    root = str(ctx.storage_dir)
    assert not any(k[0] == root for k in _PENDING_SAVES)
    assert ctx.storage.exists(ctx.key_for("r0", "df_events"), "r0")
    t.join(timeout=30.0)
    assert not t.is_alive() and not os.path.exists(sock)


def test_answers_equal_the_jax_server(tmp_path, short_dir):
    """The same requests on the same injected runs: the port's answers carry
    the JAX server's row counts and result types (keys differ: the port
    folds each plugin's kernel_version into its lineage)."""
    from waveformanalysis_tpu.context.context import Context as JaxContext
    from waveformanalysis_tpu.plugins.builtin import basic_features, dataframe, event_analysis
    from waveformanalysis_tpu.server import PipelineServer as JaxServer
    from waveformanalysis_tpu.testing.fixtures import make_fake_st_waveforms as jax_fake

    jctx = JaxContext(storage_dir=str(tmp_path / "jax"), config={"show_progress": False})
    jctx.register(basic_features.BasicFeaturesPlugin(), dataframe.DataFramePlugin(),
                  event_analysis.GroupedEventsPlugin())
    tctx = make_context(str(tmp_path / "port"))
    for i in range(2):
        jctx.inject_data(f"r{i}", "st_waveforms", fake_run(jax_fake, i))
        tctx.inject_data(f"r{i}", "st_waveforms", fake_run(make_fake_st_waveforms, i))
    socks = (f"{short_dir}/jax.sock", f"{short_dir}/port.sock")
    threads = [start(JaxServer(jctx, socks[0])), start(PipelineServer(tctx, socks[1]))]
    reqs = [{"op": "get_data", "run_id": "r0", "names": ["df_events", "basic_features"]},
            {"op": "get_data", "run_id": "r1", "names": ["df"]},
            {"op": "get_data_batched", "run_ids": ["r0", "r1"], "names": ["basic_features"]},
            {"op": "get_data", "run_id": "missing", "names": ["df"]},
            {"op": "dance"}]

    def answers(resp):
        if not resp["ok"]:
            return False
        res = resp["results"]
        if "run_ids" in req:
            return {r: {n: (d["rows"], d["type"]) for n, d in res[r].items()} for r in res}
        return {n: (d["rows"], d["type"]) for n, d in res.items()}

    for req in reqs:
        want, got = (answers(request(s, req)) for s in socks)
        assert got == want, req
    for s, t in zip(socks, threads):
        stop(s, t)


def test_process_server_on_cpu(tmp_path, short_dir):
    """``python -m waveformanalysis_tpu_torch.server --device cpu`` serves a
    DAQ run; after flush and shutdown it exits 0, and a Context over its
    storage loads the persisted df_events with no compute, equal to a
    fresh CPU Context's."""
    create_daq_run(tmp_path / "DAQ", "run_srv", n_channels=2, n_rows=12, n_samples=48,
                   pulse_height=-300)
    sock = f"{short_dir}/wfa.sock"
    store = str(tmp_path / "served")
    config = {"n_channels": 2}
    cmd = [sys.executable, "-m", "waveformanalysis_tpu_torch.server", "--socket", sock,
           "--storage-dir", store, "--data-root", str(tmp_path / "DAQ"), "--device", "cpu",
           "--profile", "cpu", "--config-json", json.dumps(config)]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        assert wait_ready(sock, timeout=120.0), proc.stderr.read() if proc.poll() else ""
        resp = request(sock, {"op": "get_data", "run_id": "run_srv", "names": ["df_events"]})
        assert resp["ok"], resp
        assert request(sock, {"op": "flush"})["ok"]
        assert request(sock, {"op": "shutdown"})["bye"]
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert "listening on" in proc.stdout.read()

    from waveformanalysis_tpu_torch.plugins.plugin_sets import get_profile

    def daq_context(storage_dir: str) -> Context:
        ctx = Context(storage_dir=storage_dir, config=dict(
            config, data_root=str(tmp_path / "DAQ"), daq_adapter="vx2730",
            show_progress=False, device="cpu"))
        ctx.register(*get_profile("cpu"))
        return ctx

    loaded, fresh = daq_context(store), daq_context(str(tmp_path / "fresh"))
    assert resp["results"]["df_events"]["key"] == loaded.key_for("run_srv", "df_events")
    got = loaded.get_data("run_srv", "df_events")
    assert not any(k.startswith("plugin.") for k in loaded.profiler.stats())
    want = fresh.get_data("run_srv", "df_events")
    assert resp["results"]["df_events"]["rows"] == len(want) == len(got)
    for col in want.columns:
        for a, b in zip(want[col], got[col]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_default_device_needs_a_card(tmp_path, short_dir, monkeypatch):
    """Without a card the default ``--device cuda`` raises before the
    socket exists; nothing runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sock = f"{short_dir}/wfa.sock"
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--socket", sock, "--storage-dir", str(tmp_path / "s")])
    assert not os.path.exists(sock)
