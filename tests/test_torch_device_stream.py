"""The port's device chunk executor with hooks derived from the static
plugins' own stages (``plugins/device_stream.py``), on a CPU Context,
against the port's host serial engine and the JAX package's.

Mirrors tests/test_device_stream.py for each of ``basic_features``,
``hit``, ``hit_threshold`` and ``waveform_width_integral`` on the JAX
tests' fixture (``make_fake_st_waveforms(n_events=40, wave_length=64,
n_channels=2)``, chunk size 8). Tolerance: the device executor = the
port's host serial engine bit for bit, and merged streams = the static
tables bit for bit, as the JAX package pins them; against JAX's host serial
engine, integer, index and count fields exact, float32 fields atol 1e-3 /
rtol 1e-4. On the card the executor launches K2 (``hit``) and K3
(``hit_threshold``) once per chunk: ``chip_smoke.py`` phase 5l checks that
at 262,144 waveforms.
"""

import logging

import numpy as np
import pytest

from waveformanalysis_tpu_torch.context.context import Context
from waveformanalysis_tpu_torch.ops import hits as HT
from waveformanalysis_tpu_torch.ops import peaks as PK
from waveformanalysis_tpu_torch.plugins.device_stream import DeviceKernelStream
from waveformanalysis_tpu_torch.plugins.plugin_sets import cuda_default
from waveformanalysis_tpu_torch.plugins.streaming import (
    StreamingConfig,
    StreamingContext,
)
from waveformanalysis_tpu_torch.testing.fixtures import make_fake_st_waveforms

ATOL, RTOL = 1e-3, 1e-4
DEVICE_NAMES = ["basic_features", "hit", "hit_threshold", "waveform_width_integral"]


def _st(n=40):
    return make_fake_st_waveforms(
        n_events=n, wave_length=64, n_channels=2, pulse_start=20,
        pulse_width=6, pulse_height=250, noise_rms=2.0, seed=7,
    )


def _ctx(tmp_path, n=40):
    ctx = Context(storage_dir=str(tmp_path / "s"),
                  config={"show_progress": False, "device": "cpu"})
    ctx.register(*cuda_default())
    ctx.inject_data("r", "st_waveforms", _st(n))
    return ctx


def _jax_ctx(tmp_path, n=40):
    from waveformanalysis_tpu.context.context import Context as JContext
    from waveformanalysis_tpu.plugins.plugin_sets import tpu_default

    ctx = JContext(storage_dir=str(tmp_path / "j"), config={"show_progress": False})
    ctx.register(*tpu_default())
    ctx.inject_data("r", "st_waveforms", _st(n))
    return ctx


def _serial(adapter, ctx, chunk_size=8, config_cls=StreamingConfig):
    cfg = config_cls.resolve(ctx, adapter)
    cfg.chunk_size = chunk_size
    return list(adapter._compute_serial(ctx, "r", adapter.input_stream(ctx, "r", cfg), cfg))


def _arr(t):
    return t.to_numpy() if hasattr(t, "to_numpy") else np.asarray(t)


def _tables_equal(a, b, msg="", exact=True):
    a, b = _arr(a), _arr(b)
    assert a.dtype == b.dtype, f"{msg}: dtype"
    assert len(a) == len(b), f"{msg}: length {len(a)} vs {len(b)}"
    for f in a.dtype.names:
        if exact or a[f].dtype.kind != "f":
            np.testing.assert_array_equal(a[f], b[f], err_msg=f"{msg}.{f}")
        else:
            np.testing.assert_allclose(a[f], b[f], atol=ATOL, rtol=RTOL, err_msg=f"{msg}.{f}")


def _same_chunks(port, ref, name, exact=True):
    assert len(port) == len(ref) > 1  # really chunked
    for i, (d, h) in enumerate(zip(port, ref)):
        assert (d.start, d.end, d.metadata) == (h.start, h.end, h.metadata)
        _tables_equal(d.data, h.data, msg=f"{name}[chunk {i}]", exact=exact)


@pytest.mark.parametrize("name", DEVICE_NAMES)
def test_device_stream_matches_host_serial_and_jax(tmp_path, name):
    """The device executor = the port's host serial engine over identical
    chunks, bit for bit, and = the JAX package's host serial engine."""
    from waveformanalysis_tpu.plugins.device_stream import (
        DeviceKernelStream as JDeviceKernelStream,
    )
    from waveformanalysis_tpu.plugins.streaming import StreamingConfig as JStreamingConfig

    ctx = _ctx(tmp_path)
    device_chunks = list(StreamingContext(ctx).get_stream(
        "r", name, chunk_size=8, executor_type="device"))
    host_chunks = _serial(DeviceKernelStream.for_data_name(ctx, name), ctx)
    _same_chunks(device_chunks, host_chunks, name)
    for c in device_chunks:  # host tables, as the stream yields them
        assert all(isinstance(v, np.ndarray) for v in c.data.columns.values())

    jctx = _jax_ctx(tmp_path)
    jax_chunks = _serial(JDeviceKernelStream.for_data_name(jctx, name), jctx,
                         config_cls=JStreamingConfig)
    _same_chunks(device_chunks, jax_chunks, name, exact=False)


def test_device_stream_identity_is_global(tmp_path):
    ctx = _ctx(tmp_path)
    sc = StreamingContext(ctx)
    merged = _arr(sc.merge_stream(sc.get_stream(
        "r", "basic_features", chunk_size=8, executor_type="device"), sort=False))
    ids = np.sort(merged["event_index"])
    assert len(np.unique(ids)) == len(ids)
    st = _arr(ctx.get_data("r", "st_waveforms"))
    assert set(ids.tolist()) == set(st["record_id"].tolist())


@pytest.mark.parametrize("name", ["basic_features", "waveform_width_integral"])
def test_device_stream_merged_matches_static(tmp_path, name):
    ctx = _ctx(tmp_path)
    static = _arr(ctx.get_data("r", name))
    sc = StreamingContext(ctx)
    arr = _arr(sc.merge_stream(
        sc.get_stream("r", name, chunk_size=8, executor_type="device"), sort=False))
    _tables_equal(arr[np.argsort(arr["event_index"], kind="stable")],
                  static[np.argsort(static["event_index"], kind="stable")], name)


@pytest.mark.parametrize("name", ["hit", "hit_threshold"])
def test_device_stream_hits_merged_matches_static_with_halo(tmp_path, name):
    """A left halo covering the wave duration makes the time partition of
    the hit rows exact against the static compute."""
    ctx = _ctx(tmp_path)
    static = _arr(ctx.get_data("r", name))
    sc = StreamingContext(ctx)
    arr = _arr(sc.merge_stream(
        sc.get_stream("r", name, chunk_size=8, executor_type="device",
                      required_halo_left_ns=200.0), sort=False))
    assert len(static) > 0
    _tables_equal(arr[np.lexsort((arr["position"], arr["record_id"]))],
                  static[np.lexsort((static["position"], static["record_id"]))], name)


def test_thread_pool_over_the_adapter_is_ordered(tmp_path):
    """The host thread pool over a derived adapter (several threads
    launching its stage) yields the serial engine's chunks in order."""
    ctx = _ctx(tmp_path)
    adapter = DeviceKernelStream.for_data_name(ctx, "hit")
    cfg = StreamingConfig(chunk_size=4, parallel=True, max_workers=4, parallel_batch_size=3)
    par = list(adapter._compute_parallel(ctx, "r", adapter.input_stream(ctx, "r", cfg), cfg))
    _same_chunks(par, _serial(adapter, ctx, chunk_size=4), "hit")


@pytest.mark.parametrize("name,module,attr", [("hit", PK, "find_peaks_batch"),
                                              ("hit_threshold", HT, "threshold_hits_batch")])
def test_stage_failure_propagates(tmp_path, monkeypatch, name, module, attr):
    """A failing stage (on the card: K2's or K3's build or launch) ends the
    stream with its error: no chunk executor catches it."""
    ctx = _ctx(tmp_path)

    def boom(*args, **kwargs):
        raise RuntimeError(f"{attr} failed")

    monkeypatch.setattr(module, attr, boom)
    with pytest.raises(RuntimeError, match=f"{attr} failed"):
        list(StreamingContext(ctx).get_stream("r", name, chunk_size=8,
                                              executor_type="device"))


def test_unknown_name_falls_back_to_host_view(tmp_path, caplog):
    ctx = _ctx(tmp_path, n=12)
    with caplog.at_level(logging.WARNING):
        chunks = list(StreamingContext(ctx).get_stream("r", "st_waveforms", chunk_size=6,
                                                       executor_type="device"))
    assert any("no derivable device hooks" in r.message for r in caplog.records)
    assert sum(len(c) for c in chunks) == 12


def test_for_data_name_rejects_names_without_hooks(tmp_path):
    ctx = _ctx(tmp_path, n=4)
    assert DeviceKernelStream.for_data_name(ctx, "df") is None
    assert DeviceKernelStream.for_data_name(ctx, "basic_features") is not None


def test_stream_memory_and_empty_output(tmp_path):
    """A consumed stream leaves no table of it in the memory cache, and an
    empty chunk gives the inner plugin's zero-row table."""
    ctx = _ctx(tmp_path)
    before = set(ctx._results)
    list(StreamingContext(ctx).get_stream("r", "hit", chunk_size=8, executor_type="device"))
    assert set(ctx._results) - before <= {("r", "st_waveforms"), ("r", "filtered_waveforms")}
    adapter = DeviceKernelStream.for_data_name(ctx, "hit_threshold")
    empty = adapter._empty_output()
    assert len(empty) == 0 and empty.field_names == ctx.get_data("r", "hit_threshold").field_names
