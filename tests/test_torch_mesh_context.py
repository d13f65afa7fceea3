"""The port's mesh-attached Context, mesh chunk executor and mesh merges, on
an 8-shard CPU mesh, against the JAX package on its 8 virtual devices and
against the port's own one-device paths.

The port's mesh is ``make_mesh(devices=[torch.device("cpu")] * 8)``. Cases
mirror tests/test_fusion.py's mesh tests, tests/test_streaming.py's device
chunk executor and tests/test_multidevice_adversarial.py (a one-device
mesh, fewer events than shards, a zero-row chunk in a device group, break
segments across shard edges, a last group missing most shards, a slot
overflow on a shard). Within the port, the mesh path = the one-device path
bit for bit, lineage keys included. Against JAX: integer, index, count and
label fields exact; float32 fields atol 1e-3 / rtol 1e-4.
"""

import importlib
import logging

import numpy as np
import pytest
import torch

import jax

from waveformanalysis_tpu_torch.context import fusion as tfusion
from waveformanalysis_tpu_torch.context.context import Context
from waveformanalysis_tpu_torch.dtypes.chunk import Chunk
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.foundation.exceptions import ConfigError
from waveformanalysis_tpu_torch.parallel.mesh import Mesh, make_mesh
from waveformanalysis_tpu_torch.plugins.builtin.signal_peaks import SignalPeaksStreamPlugin
from waveformanalysis_tpu_torch.plugins.device_stream import DeviceKernelStream
from waveformanalysis_tpu_torch.plugins.plugin_sets import cuda_default
from waveformanalysis_tpu_torch.plugins.streaming import StreamingConfig
from waveformanalysis_tpu_torch.testing.fixtures import make_fake_st_waveforms

pytestmark = pytest.mark.multidevice

ATOL, RTOL = 1e-3, 1e-4
CPU = torch.device("cpu")
FULL_CONE = (
    "basic_features", "hit", "hit_threshold", "waveform_width_integral",
    "waveform_width", "hit_merged", "hit_merge_clusters",
    "hit_merged_components", "s1_s2",
)
# tests/test_fusion.py's settings for its square-pulse fixture
FUSION_CONFIG = {"hit": {"use_filtered": False, "use_derivative": False,
                         "height": 100.0, "prominence": 50.0, "width": 2},
                 "s1_s2": {"s1_width_range": (0.0, 30.0),
                           "s2_width_range": (40.0, 10000.0)}}
_CLASSES = (
    ("basic_features", "BasicFeaturesPlugin"), ("peak_finding", "HitFinderPlugin"),
    ("hit_finder", "ThresholdHitPlugin"), ("waveform_width", "WaveformWidthPlugin"),
    ("s1_s2_classifier", "S1S2ClassifierPlugin"), ("hit_merge", "HitMergePlugin"),
    ("hit_merge", "HitMergeClustersPlugin"), ("hit_merge", "HitMergedComponentsPlugin"),
    ("waveform_width_integral", "WaveformWidthIntegralPlugin"),
)


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(devices=[CPU] * 8)


def _jax_mesh(n):
    from waveformanalysis_tpu.parallel.mesh import make_mesh as jax_make_mesh

    return jax_make_mesh(n)


def _fusion_st(n=300, L=128, seed=0):
    st = make_fake_st_waveforms(n_events=n, wave_length=L, pulse_height=300,
                                polarity="positive", seed=seed)
    st["channel"] = (np.arange(n) % 2).astype(np.int16)
    return st


def _fusion_ctx(tmp_path, sub, st, mesh=None, jax_pkg=False, runs=("r",), **config):
    """tests/test_fusion.py's full-cone Context (the port's, or the JAX
    package's with ``jax_pkg``), ``st`` injected under each of ``runs``."""
    pkg = "waveformanalysis_tpu" if jax_pkg else "waveformanalysis_tpu_torch"
    ctx_cls = importlib.import_module(pkg + ".context.context").Context
    cfg = {"show_progress": False, **config}
    if not jax_pkg:
        cfg["device"] = "cpu"
    ctx = ctx_cls(storage_dir=str(tmp_path / sub), config=cfg)
    ctx.register(*(getattr(importlib.import_module(f"{pkg}.plugins.builtin.{mod}"), cls)()
                   for mod, cls in _CLASSES))
    ctx.set_config({k: dict(v) for k, v in FUSION_CONFIG.items()})
    if mesh is not None:
        ctx.attach_mesh(mesh)
    for rid in runs:
        ctx.inject_data(rid, "st_waveforms", st)
    return ctx


def _arr(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tables_equal(a, b, msg="", exact=True):
    a = a.to_numpy() if hasattr(a, "to_numpy") else np.asarray(a)
    b = b.to_numpy() if hasattr(b, "to_numpy") else np.asarray(b)
    assert len(a) == len(b), f"{msg}: {len(a)} vs {len(b)}"
    assert a.dtype.names == b.dtype.names, msg
    for f in a.dtype.names:
        if not exact and a[f].dtype.kind == "f":
            np.testing.assert_allclose(a[f], b[f], atol=ATOL, rtol=RTOL, err_msg=f"{msg}.{f}")
        else:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f"{msg}.{f}")


def _count_shards(monkeypatch):
    """Count the fused program's stage runs (one a shard on a mesh)."""
    calls = []
    orig = tfusion.WaveChainFusion._run_stages

    def spy(*args, **kwargs):
        calls.append(args[0])
        return orig(*args, **kwargs)

    monkeypatch.setattr(tfusion.WaveChainFusion, "_run_stages", staticmethod(spy))
    return calls


# ---------------------------------------------------------------------------
# the mesh Context
# ---------------------------------------------------------------------------


def test_mesh_context_matches_one_device_and_jax(tmp_path, mesh8, monkeypatch):
    """300 events (no multiple of 8: padded, then cut): every member of the
    full cone on the mesh = the one-device Context bit for bit = the JAX
    package's mesh Context; lineage keys equal; the fused program's stages
    run once a shard; the clone keeps the mesh; no table keeps a tensor."""
    st = _fusion_st()
    one = _fusion_ctx(tmp_path, "one", st)
    mesh = _fusion_ctx(tmp_path, "mesh", st, mesh=mesh8)
    ref = _fusion_ctx(tmp_path, "jax", st, mesh=_jax_mesh(8), jax_pkg=True)
    calls = _count_shards(monkeypatch)
    got = mesh.get_data("r", list(FULL_CONE))
    assert len(calls) == 8
    assert "fusion.single.device_program" in mesh.profiler.stats()
    want = one.get_data("r", list(FULL_CONE))
    jax_out = ref.get_data("r", list(FULL_CONE))
    for name in FULL_CONE:
        _tables_equal(want[name], got[name], f"one-device.{name}")
        _tables_equal(jax_out[name], got[name], f"jax.{name}", exact=False)
        assert mesh.key_for("r", name) == one.key_for("r", name)
        assert not any(isinstance(v, torch.Tensor) for v in got[name].columns.values())
    assert len(got["s1_s2"]) > 0
    clone = mesh.clone()
    assert clone.mesh == (mesh8, "data") and one.clone().mesh is None


def test_attach_mesh_checks(tmp_path, mesh8):
    ctx = _fusion_ctx(tmp_path, "c", _fusion_st(n=16))
    with pytest.raises(ConfigError, match="no axis 'x'"):
        ctx.attach_mesh(mesh8, axis="x")
    meta = Mesh(np.array([torch.device("meta")] * 2, dtype=object), ("data",))
    with pytest.raises(ConfigError, match="a mesh of meta devices"):
        ctx.attach_mesh(meta)
    assert ctx.attach_mesh(mesh8) is ctx and ctx.mesh == (mesh8, "data")
    assert ctx.attach_mesh(None).mesh is None


def test_batched_on_the_mesh(tmp_path, mesh8, monkeypatch):
    """get_data_batched over 3 runs on the mesh: one program of 8 shards;
    every table = per-run get_data on the one-device Context (which
    tests/test_torch_batched.py holds to the JAX package)."""
    runs = {"a": _fusion_st(n=180, seed=1), "b": _fusion_st(n=77, seed=2),
            "c": _fusion_st(n=300, seed=3)}
    names = ["s1_s2", "hit_merged", "hit_threshold"]
    mesh = _fusion_ctx(tmp_path, "bm", None, mesh=mesh8, runs=(), fused_batch_bucket=256)
    one = _fusion_ctx(tmp_path, "bo", None, runs=())
    for ctx in (mesh, one):
        for rid, st in runs.items():
            ctx.inject_data(rid, "st_waveforms", st)
    calls = _count_shards(monkeypatch)
    got = mesh.get_data_batched(list(runs), names)
    assert len(calls) == 8
    assert "fusion.batched.device_program" in mesh.profiler.stats()
    for rid in runs:
        for name in names:
            _tables_equal(one.get_data(rid, name), got[rid][name], f"{rid}.{name}")
            assert mesh.key_for(rid, name) == one.key_for(rid, name)


@pytest.mark.parametrize("n_devices, n_events", [(1, 40), (8, 3)])
def test_degenerate_meshes(tmp_path, n_devices, n_events):
    """A one-device mesh behaves as no mesh; with fewer events than shards
    the shards past the events hold only padding (event_length 0)."""
    st = make_fake_st_waveforms(n_events=n_events, wave_length=64, pulse_start=20,
                                pulse_height=250)
    mesh = make_mesh(devices=[CPU] * n_devices)
    ref = _fusion_ctx(tmp_path, "ref", st)
    dev = _fusion_ctx(tmp_path, "dev", st, mesh=mesh)
    names = ["basic_features", "hit", "hit_threshold", "s1_s2"]
    want, got = ref.get_data("r", names), dev.get_data("r", names)
    for name in names:
        _tables_equal(want[name], got[name], f"{n_devices}x{n_events}.{name}")


def _multi_pulse_st(n=24):
    """Waveforms with 4 well-separated pulses each."""
    st = make_fake_st_waveforms(n_events=n, wave_length=128, pulse_start=10,
                                pulse_width=4, pulse_height=300)
    st = st.copy()
    waves = st["wave"].astype(np.int64)
    for off in (40, 70, 100):
        waves[:, off:off + 4] -= 300
    st["wave"] = np.clip(waves, -32768, 32767).astype(np.int16)
    return st


@pytest.mark.parametrize("policy", ["raise", "warn"])
def test_mesh_fused_overflow(tmp_path, mesh8, caplog, policy):
    """A slot overflow in the mesh program raises or warns as the one-device
    program does; with warn the tables are equal."""
    st = _multi_pulse_st()
    cfgs = {"hit_threshold": {"max_hits_per_waveform": 2, "overflow_policy": policy}}
    names = ["hit_threshold", "basic_features"]
    ctxs = [_fusion_ctx(tmp_path, f"ovf{i}", st, mesh=m, capacity_hints=False)
            for i, m in enumerate((None, mesh8))]
    for ctx in ctxs:
        ctx.set_config(cfgs)
    if policy == "raise":
        for ctx in ctxs:
            with pytest.raises(ValueError, match="exceeded"):
                ctx.get_data("r", names)
        return
    with caplog.at_level(logging.WARNING):
        got = ctxs[1].get_data("r", names)
    assert any("exceeded" in r.message for r in caplog.records)
    _tables_equal(ctxs[0].get_data("r", "hit_threshold"), got["hit_threshold"], "overflow")


# ---------------------------------------------------------------------------
# the mesh chunk executor
# ---------------------------------------------------------------------------


def _stream_ctx(tmp_path, sub, st, mesh=None):
    ctx = Context(storage_dir=str(tmp_path / sub),
                  config={"show_progress": False, "device": "cpu"})
    ctx.register(*cuda_default())
    if mesh is not None:
        ctx.attach_mesh(mesh)
    ctx.inject_data("r", "st_waveforms", st)
    return ctx


def _device_vs_serial(ctx, name, chunk_size, chunks=None, **cfg_kw):
    adapter = DeviceKernelStream.for_data_name(ctx, name)
    cfg = StreamingConfig.resolve(ctx, adapter)
    cfg.chunk_size = chunk_size
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    src = (lambda: iter(chunks)) if chunks is not None else (
        lambda: adapter.input_stream(ctx, "r", cfg))
    dev = list(adapter._compute_device(ctx, "r", src(), cfg))
    host = list(adapter._compute_serial(ctx, "r", src(), cfg))
    assert len(dev) == len(host)
    for i, (d, h) in enumerate(zip(dev, host)):
        assert (d.start, d.end, d.metadata.get("segment_id")) == (
            h.start, h.end, h.metadata.get("segment_id"))
        _tables_equal(h.data, d.data, f"{name}[{i}]")
    return dev


def _stream_st(n, seed):
    return make_fake_st_waveforms(n_events=n, wave_length=64, n_channels=2, pulse_start=20,
                                  pulse_width=6, pulse_height=250, noise_rms=2.0, seed=seed)


@pytest.mark.parametrize("name", ["basic_features", "hit_threshold"])
def test_mesh_stream_matches_host_engine(tmp_path, mesh8, monkeypatch, name):
    """36 events in chunks of 4 over 8 shards: 9 chunks, the last group one
    chunk and 7 missing shards; each chunk's stage runs once."""
    ctx = _stream_ctx(tmp_path, "u", _stream_st(36, 6), mesh=mesh8)
    cls = type(DeviceKernelStream.for_data_name(ctx, name))
    stage = cls.device_chunk_stage
    calls = []
    monkeypatch.setattr(cls, "device_chunk_stage",
                        staticmethod(lambda cfg, inputs: calls.append(1) or stage(cfg, inputs)))
    assert len(_device_vs_serial(ctx, name, 4)) == 9
    assert len(calls) == 2 * 9  # the mesh executor's 9, then the host engine's


def test_mesh_stream_zero_row_chunk(tmp_path, mesh8):
    """A chunk whose rows all clipped away round-trips the mesh executor."""
    ctx = _stream_ctx(tmp_path, "z", _stream_st(40, 3), mesh=mesh8)
    adapter = DeviceKernelStream.for_data_name(ctx, "basic_features")
    cfg = StreamingConfig.resolve(ctx, adapter)
    cfg.chunk_size = 8
    chunks = list(adapter.input_stream(ctx, "r", cfg))
    donor = chunks[1]
    empty = Chunk(donor.data[0:0], start=donor.start, end=donor.start,
                  run_id=donor.run_id, data_type=donor.data_type,
                  time_field=donor.time_field, dt_field=donor.dt_field,
                  length_field=donor.length_field, endtime_field=donor.endtime_field,
                  dt=donor.dt, metadata=dict(donor.metadata))
    out = _device_vs_serial(ctx, "basic_features", 8, chunks=[chunks[0], empty] + chunks[1:])
    assert sum(1 for c in out if len(c) == 0) >= 1


def test_mesh_stream_break_segments(tmp_path):
    """A time gap splits segments; chunks of both segments share a group."""
    st = _stream_st(32, 5).copy()
    st["timestamp"][16:] += np.int64(5e13)
    ctx = _stream_ctx(tmp_path, "b", st, mesh=make_mesh(devices=[CPU] * 4))
    out = _device_vs_serial(ctx, "hit_threshold", 6, break_threshold_ps=1e13)
    assert len({c.metadata.get("segment_id") for c in out}) >= 2


def test_mesh_signal_peaks_stream_matches_jax(tmp_path, mesh8):
    """signal_peaks_stream through get_data with executor_type="device":
    the mesh executor's chunks (100 events, chunk 16: 7 chunks in one
    group) = the host engine's = the JAX package's mesh executor's."""
    from waveformanalysis_tpu.plugins.builtin.signal_peaks import (
        SignalPeaksStreamPlugin as JSignalPeaks,
    )
    from waveformanalysis_tpu.testing.fixtures import make_tiny_context as jax_tiny
    from waveformanalysis_tpu_torch.testing.fixtures import make_tiny_context

    st = make_fake_st_waveforms(n_events=100, wave_length=64, pulse_start=20,
                                pulse_width=4, pulse_height=300)
    out = {}
    for tag, make, plugin, mesh, sc in (
        ("host", make_tiny_context, SignalPeaksStreamPlugin, None, {"chunk_size": 16}),
        ("mesh", make_tiny_context, SignalPeaksStreamPlugin, mesh8,
         {"chunk_size": 16, "executor_type": "device"}),
        ("jax", jax_tiny, JSignalPeaks, _jax_mesh(8),
         {"chunk_size": 16, "executor_type": "device"}),
    ):
        kw = {} if tag == "jax" else {"config": {"device": "cpu"}}
        ctx = make(tmp_path / tag, st_waveforms=st, **kw)
        ctx.register(plugin())
        ctx.set_config({"signal_peaks_stream": {"height": 50.0, "prominence": 10.0,
                                                "width": 1, "streaming_config": sc}})
        if mesh is not None:
            ctx.attach_mesh(mesh)
        out[tag] = list(ctx.get_data("test_run", "signal_peaks_stream"))
    assert len(out["host"]) == len(out["mesh"]) == len(out["jax"]) == 7
    for h, m, j in zip(out["host"], out["mesh"], out["jax"]):
        assert (h.start, h.end) == (m.start, m.end) == (j.start, j.end)
        _tables_equal(h.data, m.data, "host")
        _tables_equal(j.data, m.data, "jax", exact=False)


def test_stream_without_mesh_stays_on_the_context_device(tmp_path, monkeypatch):
    """No mesh: one chunk a group on the Context's device, no make_mesh."""
    import waveformanalysis_tpu_torch.parallel.mesh as tmesh

    monkeypatch.setattr(tmesh, "make_mesh", lambda *a, **k: pytest.fail("make_mesh called"))
    ctx = _stream_ctx(tmp_path, "n", _stream_st(20, 2))
    assert len(_device_vs_serial(ctx, "hit_threshold", 8)) == 3


# ---------------------------------------------------------------------------
# records and streams merged on the mesh
# ---------------------------------------------------------------------------


def test_records_mesh_merge_matches_host_and_jax(mesh8):
    """Per-channel records parts with random timestamps merged on the
    mesh = the host merge = the JAX package's mesh merge (JAX
    tests/test_sorted_merge.py's case), records and pool bit for bit."""
    from waveformanalysis_tpu.processing import records_builder as JRB
    from waveformanalysis_tpu.testing.fixtures import make_fake_st_waveforms as jax_fake
    from waveformanalysis_tpu_torch.processing import records_builder as TRB

    rng = np.random.default_rng(42)
    parts = {"port": [], "jax": []}
    for ch in range(3):
        ts = rng.integers(0, 10**9, 77).astype(np.int64) * 1000
        for pkg, fake, rb in (("port", make_fake_st_waveforms, TRB), ("jax", jax_fake, JRB)):
            st = fake(n_events=77, wave_length=32, n_channels=1, seed=ch)
            st["channel"] = ch
            st["timestamp"] = ts
            parts[pkg].append(rb.build_records_from_st_waveforms(st))
    host = TRB.merge_records_parts(parts["port"])
    got = TRB.merge_records_parts(parts["port"], mesh=mesh8)
    ref = JRB.merge_records_parts(parts["jax"], mesh=_jax_mesh(8))
    assert len(got.records) == 3 * 77
    for k in host.records.field_names:
        np.testing.assert_array_equal(_arr(host.records[k]), _arr(got.records[k]), err_msg=k)
        np.testing.assert_array_equal(np.asarray(ref.records[k]), _arr(got.records[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(host.wave_pool, got.wave_pool)
    np.testing.assert_array_equal(ref.wave_pool, got.wave_pool)


def test_merge_stream_device_on_mesh_matches_host(tmp_path, mesh8):
    """A hit_threshold stream merged on the mesh (timestamp, record_id
    keys) = the host merge; "auto" with a one-device mesh takes the host
    path."""
    from waveformanalysis_tpu_torch.plugins.streaming import get_streaming_context

    ctx = _stream_ctx(tmp_path, "m", _stream_st(40, 9))
    sc = get_streaming_context(ctx)

    def stream():
        return sc.get_stream("r", "hit_threshold", chunk_size=8, executor_type="device")

    host = sc.merge_stream(stream(), backend="host")
    assert len(host) > 0
    _tables_equal(host, sc.merge_stream(stream(), backend="device", mesh=mesh8), "device")
    _tables_equal(host, sc.merge_stream(stream(), mesh=make_mesh(devices=[CPU])), "auto-1")
    assert isinstance(sc.merge_stream(stream(), mesh=mesh8), Table)

