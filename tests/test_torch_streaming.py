"""The port's chunked streaming engine (``plugins/streaming.py``) and
``signal_peaks_stream`` against the JAX package's, on the CPU.

Mirrors tests/test_streaming.py, test_streaming_optimization.py and
test_streaming_parallel.py. Each numpy-only stream plugin is defined once
per package (``_plugins``), both Contexts get the same injected tables made
from seeds with numpy, and the port's chunks are held to JAX's chunk for
chunk: the same ``(start, end)`` windows and metadata, and the same tables.
Tolerance against JAX: integer, index and count fields exact; float32
fields atol 1e-3 / rtol 1e-4 (``signal_peaks_stream``'s heights and
interpolated edges). Sizes are the JAX tests': 20-40 timed rows, chunk
sizes 1-16, ``make_fake_st_waveforms(n_events=40, wave_length=64,
n_channels=2)``.
"""

import logging
import threading
import time

import numpy as np
import pytest

import waveformanalysis_tpu.plugins.streaming as jstreaming
from waveformanalysis_tpu.dtypes.table import Table as JTable
from waveformanalysis_tpu.testing.fixtures import make_tiny_context as jax_tiny_context
from waveformanalysis_tpu_torch.dtypes import chunk as C
from waveformanalysis_tpu_torch.dtypes.table import Table
import waveformanalysis_tpu_torch.plugins.streaming as tstreaming
from waveformanalysis_tpu_torch.testing.fixtures import (
    make_fake_st_waveforms,
    make_tiny_context,
)

ATOL, RTOL = 1e-3, 1e-4
PACKAGES = {"port": (tstreaming, Table), "jax": (jstreaming, JTable)}


def _plugins(pkg: str) -> dict:
    """The stream plugins of these tests, subclassing ``pkg``'s
    StreamingPlugin (numpy only, so both packages run the same code)."""
    S, T = PACKAGES[pkg]

    class Doubled(S.StreamingPlugin):
        provides = "doubled_stream"
        depends_on = ["source_data"]
        version = "1.0"

        def compute_chunk(self, context, run_id, chunk):
            return chunk.data.with_columns(value=np.asarray(chunk.data["value"]) * 2)

    class SlowSquare(S.StreamingPlugin):
        """The first chunk sleeps longest: an unordered pool would yield it
        last."""

        provides = "slow_square_stream"
        depends_on = ["source_data"]
        save_when = "never"

        def compute_chunk(self, context, run_id, chunk):
            first = int(np.asarray(chunk.data["time"])[0]) == 1000
            time.sleep(0.05 if first else 0.001)
            return T({"time": np.asarray(chunk.data["time"]),
                      "value": np.asarray(chunk.data["value"]) ** 2})

    class Boom(S.StreamingPlugin):
        provides = "boom_stream"
        depends_on = ["source_data"]
        save_when = "never"
        computed = []
        lock = threading.Lock()

        def compute_chunk(self, context, run_id, chunk):
            with self.lock:
                self.computed.append(int(np.asarray(chunk.data["time"])[0]))
            if np.asarray(chunk.data["time"])[0] >= 3000:
                raise RuntimeError("boom on third chunk")
            return chunk.data

    class Stateful(S.StreamingPlugin):
        provides = "stateful_stream"
        depends_on = ["source_data"]
        save_when = "never"
        is_stateful = True

        def __init__(self):
            self.count = 0
            self.resets = 0

        def reset_state(self):
            self.resets += 1
            self.count = 0

        def compute_chunk(self, context, run_id, chunk):
            self.count += len(chunk)
            return T({"time": np.asarray(chunk.data["time"]),
                      "value": np.full(len(chunk), self.count, dtype=np.float64)})

    class Smoothed(S.StreamingPlugin):
        """+-3 ns moving average: correct at chunk edges only with halos."""

        provides = "smoothed_stream"
        depends_on = ["source_data"]
        version = "1.0"

        def compute_chunk(self, context, run_id, chunk):
            t = np.asarray(chunk.data["time"], np.int64)
            v = np.asarray(chunk.data["value"], np.float64)
            lo = np.searchsorted(t, t - 3000, side="left")
            hi = np.searchsorted(t, t + 3000, side="right")
            csum = np.concatenate([[0.0], np.cumsum(v)])
            return chunk.data.with_columns(value=(csum[hi] - csum[lo]) / (hi - lo))

    class Saving(S.StreamingPlugin):
        provides = "saving_stream"
        depends_on = ["source_data"]
        save_when = "always"

        def compute_chunk(self, context, run_id, chunk):
            if np.asarray(chunk.data["time"])[0] > self.fail_after:
                raise RuntimeError("mid-stream failure")
            return chunk.data

        fail_after = np.inf

    class Unpicklable(S.StreamingPlugin):
        provides = "unpicklable_stream"
        depends_on = ["source_data"]
        save_when = "never"

        def __init__(self):
            self.lock = threading.Lock()

        def compute_chunk(self, context, run_id, chunk):
            return chunk.data

    return {c.provides: c for c in (Doubled, SlowSquare, Boom, Stateful, Smoothed, Saving,
                                    Unpicklable)}


def _records(pkg, times, **extra):
    times = np.asarray(times, dtype=np.int64)
    n = len(times)
    cols = {"time": times, "dt": np.full(n, 2, np.int32), "length": np.full(n, 10, np.int32),
            "channel": np.zeros(n, np.int16), "value": np.arange(n, dtype=np.float64)}
    cols.update(extra)
    return PACKAGES[pkg][1](cols)


def _ctx(tmp_path, pkg, times, name=None, config=None, **plugin_kw):
    """A tiny Context of ``pkg`` with ``source_data`` at ``times`` and the
    stream plugin ``name`` registered under ``config``."""
    if pkg == "port":
        ctx = make_tiny_context(tmp_path / pkg, config={"device": "cpu"},
                                st_waveforms=make_fake_st_waveforms(4, 32))
    else:
        ctx = jax_tiny_context(tmp_path / pkg, st_waveforms=make_fake_st_waveforms(4, 32))
    ctx.inject_data("test_run", "source_data", _records(pkg, times))
    plugin = None
    if name is not None:
        plugin = _plugins(pkg)[name](**plugin_kw)
        ctx.register(plugin)
        if config is not None:
            ctx.set_config({name: {"streaming_config": config}})
    return ctx, plugin


def _cols(data):
    if hasattr(data, "field_names"):
        return {k: C._col(data, k) for k in data.field_names}
    return {k: np.asarray(data[k]) for k in data.dtype.names}


def _same_table(port, ref, tag=""):
    a, b = _cols(port), _cols(ref)
    assert list(a) == list(b), tag
    for k in a:
        assert a[k].dtype == b[k].dtype, f"{tag}.{k}"
        if a[k].dtype.kind == "f":
            np.testing.assert_allclose(a[k], b[k], atol=ATOL, rtol=RTOL, err_msg=f"{tag}.{k}")
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{tag}.{k}")


def _same_chunks(port, ref):
    port, ref = list(port), list(ref)
    assert len(port) == len(ref) > 0
    for i, (p, r) in enumerate(zip(port, ref)):
        assert (p.start, p.end, p.metadata, p.data_type) == (r.start, r.end, r.metadata,
                                                               r.data_type)
        _same_table(p.data, r.data, f"chunk {i}")
    return port


def _both(tmp_path, times, name, config, **kw):
    """The stream ``name`` of both packages' Contexts (port, JAX)."""
    out = []
    for pkg in ("port", "jax"):
        ctx, _ = _ctx(tmp_path, pkg, times, name, config, **kw)
        out.append(list(ctx.get_data("test_run", name)))
    return out


TIMES = (np.arange(40, dtype=np.int64) + 1) * 1000


class TestDataToChunks:
    @pytest.mark.parametrize("times,cfg", [
        (np.arange(10) * 1000, dict(chunk_size=4)),
        (np.concatenate([np.arange(5) * 100, 20_000_000_000_000 + np.arange(5) * 100]),
         dict(chunk_size=100, break_threshold_ps=1_000_000)),
        (np.arange(10) * 1000, dict(chunk_size=5, required_halo_left_ns=2.0,
                                    required_halo_right_ns=2.0)),
        ([5000, 1000, 3000], {}),
        (np.array([], np.int64), dict(chunk_size=10)),
    ])
    def test_chunks_equal_jax(self, times, cfg):
        chunks = [list(S.data_to_chunks(_records(pkg, times), "r", "records",
                                        S.StreamingConfig(**cfg)))
                  for pkg, (S, _T) in PACKAGES.items()]
        if len(times):
            _same_chunks(*chunks)
        else:
            assert chunks == [[], []]


class TestEngine:
    def test_serial(self, tmp_path):
        port, _ = _both(tmp_path, np.arange(20) * 1000, "doubled_stream", {"chunk_size": 6})
        assert len(port) == 4
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(c.data["value"]) for c in port]), np.arange(20) * 2)

    @pytest.mark.parametrize("batch_size", [1, 2, 100])
    def test_thread_parallel_ordered(self, tmp_path, batch_size):
        cfg = {"chunk_size": 5, "parallel": True, "executor_type": "thread",
               "max_workers": 4, "parallel_batch_size": batch_size}
        port, ref = _both(tmp_path, TIMES, "slow_square_stream", cfg)
        _same_chunks(port, ref)
        times = np.concatenate([np.asarray(c.data["time"]) for c in port])
        np.testing.assert_array_equal(times, TIMES)  # submission order kept

    def test_parallel_equals_serial(self, tmp_path):
        ctx, _ = _ctx(tmp_path, "port", TIMES, "slow_square_stream",
                      {"chunk_size": 7, "parallel": True, "max_workers": 3})
        par = list(ctx.get_data("test_run", "slow_square_stream"))
        ctx.set_config({"slow_square_stream": {"streaming_config": {"chunk_size": 7}}})
        _same_chunks(par, ctx.get_data("test_run", "slow_square_stream"))

    def test_fail_fast(self, tmp_path):
        cfg = {"chunk_size": 1, "parallel": True, "executor_type": "thread",
               "max_workers": 2, "parallel_batch_size": 4}
        for pkg in ("port", "jax"):
            ctx, plugin = _ctx(tmp_path, pkg, TIMES, "boom_stream", cfg)
            with pytest.raises(RuntimeError, match="boom on third"):
                list(ctx.get_data("test_run", "boom_stream"))
            # the failing chunk is in the first batch of 4: no later batch
            # was submitted
            assert len(plugin.computed) <= 4, pkg

    def test_stateful_resets_at_breaks(self, tmp_path, caplog):
        times = np.concatenate([TIMES[:10], TIMES[:10] + 10**14])
        cfg = {"chunk_size": 4, "parallel": True, "break_threshold_ps": 1e9}
        got = []
        for pkg in ("port", "jax"):
            ctx, plugin = _ctx(tmp_path, pkg, times, "stateful_stream", cfg)
            with caplog.at_level(logging.WARNING):
                chunks = list(ctx.get_data("test_run", "stateful_stream"))
            got.append((chunks, plugin.resets))
        assert any("stateful" in r.message for r in caplog.records)
        _same_chunks(got[0][0], got[1][0])
        assert got[0][1] == got[1][1] == 2  # one reset per segment

    def test_unpicklable_process_pool_falls_back_to_threads(self, tmp_path, caplog):
        cfg = {"chunk_size": 10, "parallel": True, "executor_type": "process",
               "max_workers": 2}
        ctx, _ = _ctx(tmp_path, "port", TIMES, "unpicklable_stream", cfg)
        with caplog.at_level(logging.WARNING):
            chunks = list(ctx.get_data("test_run", "unpicklable_stream"))
        assert sum(len(c) for c in chunks) == 40
        assert any("not picklable" in r.message for r in caplog.records)

    def test_device_executor_without_hooks_warns(self, tmp_path, caplog):
        ctx, _ = _ctx(tmp_path, "port", TIMES, "doubled_stream",
                      {"chunk_size": 8, "executor_type": "device"})
        with caplog.at_level(logging.WARNING):
            chunks = list(ctx.get_data("test_run", "doubled_stream"))
        assert sum(len(c) for c in chunks) == 40
        assert any("device-parallel" in r.message for r in caplog.records)


class TestHaloAndBreaks:
    @pytest.mark.parametrize("chunk_size", [3, 7, 20, 50])
    def test_windowed_kernel_chunk_invariant(self, tmp_path, chunk_size):
        rng = np.random.default_rng(chunk_size)
        times = np.cumsum(rng.integers(500, 4000, 40)).astype(np.int64)
        port, ref = _both(tmp_path, times, "smoothed_stream",
                          {"chunk_size": chunk_size, "required_halo_ns": 3})
        _same_chunks(port, ref)
        whole = _plugins("port")["smoothed_stream"]().compute_chunk(
            None, "test_run", type("C", (), {"data": _records("port", times)})())
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(c.data["time"]) for c in port]), times)
        np.testing.assert_allclose(
            np.concatenate([np.asarray(c.data["value"]) for c in port]),
            np.asarray(whole["value"]))

    @pytest.mark.parametrize("gap,cfg,segments", [
        (10**13 + 10**9, {"chunk_size": 100}, 2),
        (10**7, {"chunk_size": 100}, 1),
        (10**7, {"chunk_size": 100, "break_threshold_ps": 1e6}, 2),
    ])
    def test_break_threshold(self, tmp_path, gap, cfg, segments):
        times = np.concatenate([TIMES[:10], TIMES[:10] + gap])
        port, ref = _both(tmp_path, times, "doubled_stream", cfg)
        _same_chunks(port, ref)
        assert len({c.metadata["segment_id"] for c in port}) == segments

    def test_halo_attached_and_clipped(self, tmp_path):
        port, ref = _both(tmp_path, TIMES[:30], "doubled_stream",
                          {"chunk_size": 10, "required_halo_ns": 3})
        _same_chunks(port, ref)
        assert sum(len(c) for c in port) == 30


class TestConfig:
    def test_precedence_and_untracked(self, tmp_path):
        ctx, plugin = _ctx(tmp_path, "port", TIMES, "doubled_stream")
        key = ctx.key_for("test_run", "doubled_stream")
        assert tstreaming.StreamingConfig.resolve(ctx, plugin).chunk_size == 50_000
        ctx.set_config({"doubled_stream": {"streaming_config": {
            "chunk_size": 123, "parallel": True, "max_workers": 3, "required_halo_ns": 2}}})
        cfg = tstreaming.StreamingConfig.resolve(ctx, plugin, override={"chunk_size": 9})
        assert (cfg.chunk_size, cfg.parallel, cfg.max_workers) == (9, True, 3)
        assert cfg.required_halo_left_ns == cfg.required_halo_right_ns == 2.0
        assert ctx.key_for("test_run", "doubled_stream") == key  # untracked
        assert tstreaming.STREAMING_CONFIG_KEYS == jstreaming.STREAMING_CONFIG_KEYS

    def test_get_stream_overrides_reach_stream_plugins(self, tmp_path):
        got = []
        for pkg in ("port", "jax"):
            ctx, _ = _ctx(tmp_path, pkg, TIMES, "doubled_stream", {"chunk_size": 50})
            got.append(list(PACKAGES[pkg][0].get_streaming_context(ctx).get_stream(
                "test_run", "doubled_stream", chunk_size=6)))
        assert len(_same_chunks(*got)) == 7


class TestSaveThrough:
    def test_incremental_persistence(self, tmp_path):
        ctx, _ = _ctx(tmp_path, "port", TIMES, "saving_stream", {"chunk_size": 8})
        chunks = list(ctx.get_data("test_run", "saving_stream"))
        assert len(chunks) == 5
        clone = ctx.clone()
        clone.inject_data("test_run", "source_data", _records("port", TIMES))
        loaded = clone.get_data("test_run", "saving_stream")  # merged, from the cache
        assert len(loaded) == 40
        np.testing.assert_array_equal(np.asarray(loaded["time"]), TIMES)

    def test_abort_leaves_no_partial_cache(self, tmp_path):
        ctx, plugin = _ctx(tmp_path, "port", TIMES, "saving_stream", {"chunk_size": 8})
        plugin.fail_after = 20_000
        with pytest.raises(RuntimeError, match="mid-stream"):
            list(ctx.get_data("test_run", "saving_stream"))
        assert not ctx.storage.exists(ctx.key_for("test_run", "saving_stream"),
                                      run_id="test_run")


class TestStreamingContext:
    def test_static_data_streams_and_merges(self, tmp_path):
        got = []
        for pkg in ("port", "jax"):
            ctx, _ = _ctx(tmp_path, pkg, np.arange(20) * 1000)
            sc = PACKAGES[pkg][0].get_streaming_context(ctx)
            chunks = list(sc.get_stream("test_run", "source_data", chunk_size=7))
            got.append((chunks, sc.merge_stream(chunks, backend="host")))
        _same_chunks(got[0][0], got[1][0])
        assert len(got[0][0]) == 3
        _same_table(got[0][1], got[1][1])

    def test_time_range(self, tmp_path):
        got = []
        for pkg in ("port", "jax"):
            ctx, _ = _ctx(tmp_path, pkg, np.arange(20) * 1000)
            got.append(list(PACKAGES[pkg][0].get_streaming_context(ctx).get_stream(
                "test_run", "source_data", time_range=(5000, 12_000), chunk_size=7)))
        chunks = _same_chunks(*got)
        times = np.concatenate([np.asarray(c.data["time"]) for c in chunks])
        assert times.min() >= 5000 - 20 and times.max() < 12_000

    def test_merge_stream_device_backend_on_mesh(self, tmp_path):
        """With no mesh the device backend asks for the card and raises here;
        backend="device" (and "auto" with a mesh of 8) sorts on an 8-shard
        CPU mesh: = the host merge = the JAX package's device merge on its 8
        virtual devices; time ties are kept (every time twice)."""
        from waveformanalysis_tpu.parallel.mesh import make_mesh as jax_make_mesh
        from waveformanalysis_tpu_torch.parallel.mesh import make_mesh

        times = np.repeat(np.arange(20) * 1000, 2)[::-1].copy()
        mesh = make_mesh(devices=["cpu"] * 8)
        got = {}
        for pkg in ("port", "jax"):
            ctx, _ = _ctx(tmp_path, pkg, times)
            sc = PACKAGES[pkg][0].get_streaming_context(ctx)
            m = mesh if pkg == "port" else jax_make_mesh(8)
            got[pkg] = [sc.merge_stream(sc.get_stream("test_run", "source_data",
                                                      chunk_size=7), **kw)
                        for kw in ({"backend": "host"}, {"backend": "device", "mesh": m},
                                   {"mesh": m})]
        for merged in got["port"][1:]:
            _same_table(got["port"][0], merged)
        for a, b in zip(got["jax"], got["port"]):
            _same_table(a, b)
        ctx, _ = _ctx(tmp_path, "port", times)
        sc = tstreaming.get_streaming_context(ctx)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sc.merge_stream(sc.get_stream("test_run", "source_data", chunk_size=7),
                            backend="device")
        assert len(sc.merge_stream([])) == 0


# ---------------------------------------------------------------------------
# signal_peaks_stream
# ---------------------------------------------------------------------------


def _peaks_contexts(tmp_path, options):
    from waveformanalysis_tpu.context.context import Context as JContext
    from waveformanalysis_tpu.plugins.builtin.filtering import FilteredWaveformsPlugin as JF
    from waveformanalysis_tpu.plugins.builtin.signal_peaks import SignalPeaksStreamPlugin as JS
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.plugins.builtin.filtering import FilteredWaveformsPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.signal_peaks import (
        SignalPeaksStreamPlugin,
    )

    st = make_fake_st_waveforms(n_events=40, wave_length=64, n_channels=2, pulse_start=20,
                                pulse_width=4, pulse_height=300, noise_rms=2.0, seed=3)
    # and a negative triangle, whose apex clears its neighbours (the
    # threshold condition) where the square pulse's plateau does not
    st["wave"][:, 40:47] -= np.array([0, 100, 200, 300, 200, 100, 0], np.int16)
    out = []
    for tag, ctx_cls, plugins, cfg in (
            ("port", Context, (FilteredWaveformsPlugin(), SignalPeaksStreamPlugin()),
             {"device": "cpu"}),
            ("jax", JContext, (JF(), JS()), {})):
        ctx = ctx_cls(storage_dir=str(tmp_path / tag), config={"show_progress": False, **cfg})
        ctx.register(*plugins)
        ctx.inject_data("test_run", "st_waveforms", st.copy())
        ctx.set_config({"signal_peaks_stream": dict(options)})
        out.append(ctx)
    return out


@pytest.mark.parametrize("use_filtered", [True, False])
@pytest.mark.parametrize("use_derivative,threshold", [
    (True, None), (False, None), (True, (5.0, None)), (False, (5.0, None))])
def test_signal_peaks_stream_matches_jax(tmp_path, use_filtered, use_derivative, threshold):
    options = {"use_filtered": use_filtered, "use_derivative": use_derivative,
               "threshold": threshold, "height": 50.0 if use_derivative else 100.0,
               "prominence": 10.0, "width": 1, "streaming_config": {"chunk_size": 16}}
    port, ref = _peaks_contexts(tmp_path, options)
    assert port.get_plugin("signal_peaks_stream").resolve_depends_on(port)[0] == (
        "filtered_waveforms" if use_filtered else "st_waveforms")
    chunks = _same_chunks(port.get_data("test_run", "signal_peaks_stream"),
                          ref.get_data("test_run", "signal_peaks_stream"))
    assert len(chunks) == 3 and sum(len(c) for c in chunks) > 0
    for c in chunks:
        assert "channel" in c.data


def test_signal_peaks_default_chunk_and_device_executor(tmp_path):
    """The plugin's own default chunk of 4096 (one chunk here), and the
    device executor on a CPU Context = the host serial engine chunk for
    chunk."""
    options = {"height": 50.0, "prominence": 10.0, "width": 1}
    port, ref = _peaks_contexts(tmp_path, options)
    chunks = _same_chunks(port.get_data("test_run", "signal_peaks_stream"),
                          ref.get_data("test_run", "signal_peaks_stream"))
    assert len(chunks) == 1
    port.set_config({"signal_peaks_stream": {"streaming_config": {
        "chunk_size": 8, "executor_type": "device"}}})
    dev = list(port.get_data("test_run", "signal_peaks_stream"))
    port.set_config({"signal_peaks_stream": {"streaming_config": {"chunk_size": 8}}})
    host = list(port.get_data("test_run", "signal_peaks_stream"))
    assert len(dev) == 5
    for d, h in zip(dev, host):
        assert (d.start, d.end) == (h.start, h.end)
        for f in h.data.field_names:
            np.testing.assert_array_equal(np.asarray(d.data[f]), np.asarray(h.data[f]))


def test_streaming_profile():
    """``get_profile("streaming")`` = the default profile plus
    ``signal_peaks_stream``, the JAX package's plugins in its order."""
    from waveformanalysis_tpu.plugins import plugin_sets as jsets
    from waveformanalysis_tpu_torch.plugins import plugin_sets as tsets

    for name in ("streaming", "streaming_default"):
        provides = [p.provides for p in tsets.get_profile(name)]
        assert provides == [p.provides for p in jsets.get_profile(name)]
        assert provides == [p.provides for p in tsets.cuda_default()] + ["signal_peaks_stream"]


def test_signal_peaks_options_are_jax_word_for_word():
    from waveformanalysis_tpu.plugins.builtin.signal_peaks import SignalPeaksStreamPlugin as JS
    from waveformanalysis_tpu_torch.plugins.builtin.signal_peaks import (
        SignalPeaksStreamPlugin,
    )

    port, ref = SignalPeaksStreamPlugin, JS
    assert (port.version, port.kernel_version, port.save_when, port.output_kind) == (
        ref.version, ref.kernel_version, ref.save_when, ref.output_kind)
    assert list(port.options) == list(ref.options)
    for k in ref.options:
        a, b = port.options[k], ref.options[k]
        assert (a.default, a.help, a.type, a.track) == (b.default, b.help, b.type, b.track), k


def test_streaming_demo_on_cpu(capsys):
    from waveformanalysis_tpu_torch.examples import streaming_demo

    out = streaming_demo.main(["--device", "cpu", "--events", "512"])
    assert out == {"chunks": 7, "rows": 200, "hit_chunks": 1, "hits": 512}
    assert "device: cpu" in capsys.readouterr().out
