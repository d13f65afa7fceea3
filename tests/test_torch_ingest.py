"""The port's front end from DAQ files, on the CPU, against the JAX package.

The same files, written from a seed by the JAX package's
``testing/fixtures.make_synthetic_vx2730_run`` and by ``tests/utils``'s
V1725 writer, go through the JAX package and the port: the VX2730 reader
on every parse engine, the V1725 host reader, and ``st_waveforms`` through
each package's CPU Context in the flat and ``streaming_mode`` paths. Every
column must be equal, exactly.

Also pinned here: the adapter-inference repair (the port's
``config/adapter_info.py`` read a ``formats`` package the port did not
have, so no option was ever inferred from the DAQ adapter), the
``device_unpack`` and records set at work and the streaming profile, the
default profile = the JAX package's ``tpu_default``, and the native
decoder's build directory.
"""

from pathlib import Path

import numpy as np
import pytest

from bench import make_batch
from utils import make_v1725_event, write_v1725_run
from waveformanalysis_tpu.context.context import Context as JContext
from waveformanalysis_tpu.formats import adapter as jadapter
from waveformanalysis_tpu.plugins import plugin_sets as jsets
from waveformanalysis_tpu.testing.fixtures import make_synthetic_vx2730_run
from waveformanalysis_tpu_torch import native
from waveformanalysis_tpu_torch.config.resolver import ConfigResolver
from waveformanalysis_tpu_torch.context.context import Context as TContext
from waveformanalysis_tpu_torch.formats import adapter as tadapter
from waveformanalysis_tpu_torch.plugins import plugin_sets as tsets
from waveformanalysis_tpu_torch.testing.fixtures import st_waveforms_from_waves

ROOT = Path(__file__).resolve().parents[1]
ENGINES = ("native", "pyarrow", "pandas", "numpy")
RECORDS_SET = ("records", "wave_pool", "wave_pool_filtered")


def _vx_run(root: Path, **kw) -> Path:
    args = dict(n_channels=2, n_files_per_channel=2, n_rows=40, n_samples=96,
                noise=5, seed=3, channel_offset_ps=20_000)
    args.update(kw)
    return Path(make_synthetic_vx2730_run(str(root), "run_vx", **args))


def _v1725_run(root: Path, n_events: int = 24, n_samples: int = 64, seed: int = 4) -> Path:
    """A seeded V1725 run: two files of noisy two-channel events with pulses
    at random places (tests/utils.write_v1725_run writes identical events)."""
    rng = np.random.default_rng(seed)
    raw = root / "run_bin" / "RAW"
    raw.mkdir(parents=True, exist_ok=True)
    for seg in range(2):
        blob = b""
        for i in range(n_events):
            waves = {}
            for ch, base in ((0, 900), (2, 1100)):
                w = base + rng.integers(-4, 5, n_samples)
                at = int(rng.integers(8, n_samples - 12))
                w[at:at + int(rng.integers(2, 9))] -= int(rng.integers(80, 300))
                waves[ch] = w.astype(np.int16)
            ts = 1000 + (seg * n_events + i) * 700
            blob += make_v1725_event(waves, timestamps={0: ts, 2: ts + 3},
                                     baselines={0: 900, 2: 1100})
        (raw / f"run_bin_raw_b1_seg{seg}.bin").write_bytes(blob)
    return root / "run_bin"


def _config(root: Path, adapter: str, **extra):
    return {"data_root": str(root), "daq_adapter": adapter, "n_channels": 2,
            "show_progress": False, **extra}


def _contexts(tmp_path: Path, root: Path, adapter: str, plugin_config=None, **extra):
    jctx = JContext(storage_dir=str(tmp_path / "jax"), config=_config(root, adapter, **extra))
    jctx.register(*jsets.tpu_default())
    tctx = TContext(storage_dir=str(tmp_path / "port"),
                    config=_config(root, adapter, device="cpu", **extra))
    tctx.register(*tsets.get_profile("cuda"))
    if plugin_config:
        jctx.set_config(plugin_config)
        tctx.set_config(plugin_config)
    return jctx, tctx


def _lineage(ctx, name):
    """A data name's whole lineage, plugin spec hashes included."""
    return ctx.get_lineage(name)


def _same_table(ref, out, tag):
    assert out.field_names == ref.field_names, tag
    assert len(out) == len(ref), tag
    for f in ref.field_names:
        a, b = np.asarray(ref[f]), np.asarray(out[f])
        assert a.dtype == b.dtype and a.shape == b.shape, (tag, f, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f"{tag}.{f}")


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_vx2730_reader_matches_jax(tmp_path, engine):
    """Each VX2730 file, with and without its header rows, parses to the
    same float64 matrix in both packages on every engine."""
    run = _vx_run(tmp_path)
    jr = jadapter.get_adapter("vx2730").format_reader
    tr = tadapter.get_adapter("vx2730").format_reader
    files = sorted((run / "RAW").glob("*.CSV"))
    assert len(files) == 4
    for path in files:
        first = path.name.endswith("_0.CSV")
        ref = jr.read_file(path, is_first_file=first, parse_engine=engine)
        out = tr.read_file(path, is_first_file=first, parse_engine=engine)
        assert out.dtype == ref.dtype == np.float64 and out.shape == ref.shape == (40, 103)
        np.testing.assert_array_equal(out, ref, err_msg=f"{engine} {path.name}")


def test_vx2730_native_engine_is_the_auto_engine(tmp_path, monkeypatch):
    """``auto`` reads through the native decoder first; with the library
    unavailable it falls back to pyarrow, and ``native`` then raises."""
    run = _vx_run(tmp_path, n_files_per_channel=1)
    path = sorted((run / "RAW").glob("*.CSV"))[0]
    reader = tadapter.get_adapter("vx2730").format_reader
    ref = reader.read_file(path, parse_engine="numpy")
    calls = []
    real = native.decode_csv_bytes
    monkeypatch.setattr(native, "decode_csv_bytes",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    np.testing.assert_array_equal(reader.read_file(path), ref)
    assert calls == [1]
    monkeypatch.setattr(native, "decode_csv_bytes", lambda *a, **k: None)
    np.testing.assert_array_equal(reader.read_file(path), ref)
    with pytest.raises(RuntimeError, match="native"):
        reader.read_file(path, parse_engine="native")


def test_vectorised_vx2730_writer_matches_the_fixture_writer(tmp_path):
    """testing.fixtures.write_vx2730_run (numpy, a block at a time; what
    chip_smoke.py writes its runs with) writes the JAX fixture writer's
    files byte for byte from the same samples and timestamps."""
    from waveformanalysis_tpu_torch.testing.fixtures import write_vx2730_run

    run = _vx_run(tmp_path / "a", n_files_per_channel=3, n_rows=20, n_samples=50)
    reader = jadapter.get_adapter("vx2730").format_reader
    for ch in range(2):
        files = sorted((run / "RAW").glob(f"Data_CH{ch}_*.CSV"))
        rows = np.vstack([reader.read_file(f, is_first_file=(i == 0), parse_engine="numpy")
                          for i, f in enumerate(files)]).astype(np.int64)
        written = write_vx2730_run(str(tmp_path / "b"), "run_vx", rows[:, 7:], rows[:, 2], ch,
                                   n_files=3, chunk_rows=7)
        assert [Path(w).read_bytes() for w in written] == [f.read_bytes() for f in files]
    with pytest.raises(ValueError, match="65535"):
        write_vx2730_run(str(tmp_path / "c"), "r", -np.ones((2, 4), np.int64),
                         np.zeros(2, np.int64), 0)


@pytest.mark.parametrize("writer", ["write_v1725_run", "seeded"])
def test_v1725_host_reader_matches_jax(tmp_path, writer):
    run = write_v1725_run(tmp_path, n_events=5) if writer == "write_v1725_run" \
        else _v1725_run(tmp_path)
    jad, tad = jadapter.get_adapter("v1725"), tadapter.get_adapter("v1725")
    groups = jad.scan_run(str(tmp_path), run.name)
    assert {ch: [str(p) for p in fs] for ch, fs in tad.scan_run(str(tmp_path), run.name).items()} \
        == {ch: [str(p) for p in fs] for ch, fs in groups.items()}
    files = [f for fs in groups.values() for f in fs]
    ref, out = jad.format_reader.read_files(files), tad.format_reader.read_files(files)
    assert out.dtype == ref.dtype and len(out) == len(ref) > 0
    for name in ("board", "channel", "timestamp", "baseline", "trunc"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    for a, b in zip(ref["wave"], out["wave"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


def test_adapter_registry_matches_jax():
    assert tadapter.list_adapters() == jadapter.list_adapters() == ["v1725", "vx2730"]
    for name in ("vx2730", "v1725"):
        js, ts = jadapter.get_adapter(name).format_spec, tadapter.get_adapter(name).format_spec
        assert (ts.sampling_rate_hz, ts.timestamp_unit.value, ts.raw_timestamp_mode.value,
                ts.delimiter) == (js.sampling_rate_hz, js.timestamp_unit.value,
                                  js.raw_timestamp_mode.value, js.delimiter)
    with pytest.raises(KeyError, match="nope"):
        tadapter.get_adapter("nope")


# ---------------------------------------------------------------------------
# st_waveforms through the Contexts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["flat", "streaming", "streaming_chunked"])
def test_st_waveforms_vx2730_matches_jax(tmp_path, mode):
    """raw_files and every st_waveforms column from VX2730 files, exactly,
    in the threaded flat parse and the streaming path (one file at a time,
    or 16-row slices)."""
    run = _vx_run(tmp_path / "DAQ")
    cfg = {"flat": {}, "streaming": {"streaming_mode": True},
           "streaming_chunked": {"streaming_mode": True, "chunksize": 16}}[mode]
    jctx, tctx = _contexts(tmp_path, run.parent, "vx2730", {"st_waveforms": cfg})
    assert tctx.get_data("run_vx", "raw_files") == jctx.get_data("run_vx", "raw_files")
    ref, out = jctx.get_data("run_vx", "st_waveforms"), tctx.get_data("run_vx", "st_waveforms")
    _same_table(ref, out, f"st_waveforms {mode}")
    assert len(out) == 160 and out["wave"].shape == (160, 96)
    assert tctx.key_for("run_vx", "st_waveforms") == jctx.key_for("run_vx", "st_waveforms")


def test_st_waveforms_v1725_matches_jax(tmp_path):
    run = _v1725_run(tmp_path / "DAQ")
    jctx, tctx = _contexts(tmp_path, run.parent, "v1725")
    ref, out = jctx.get_data("run_bin", "st_waveforms"), tctx.get_data("run_bin", "st_waveforms")
    _same_table(ref, out, "st_waveforms v1725")
    assert len(out) == 96 and set(np.unique(out["channel"])) == {0, 2}


def test_st_waveforms_options_match_jax(tmp_path):
    """A baseline window and a fixed wave length through the Contexts; a
    channel mapping and the WaveformStruct shim on the parsed arrays."""
    from waveformanalysis_tpu.plugins.builtin import waveforms as jwf
    from waveformanalysis_tpu_torch.plugins.builtin import waveforms as twf

    run = _vx_run(tmp_path / "DAQ", n_files_per_channel=1)
    cfg = {"st_waveforms": {"baseline_samples": (2, 30), "wave_length": 64, "n_jobs": 1}}
    jctx, tctx = _contexts(tmp_path, run.parent, "vx2730", cfg)
    ref, out = jctx.get_data("run_vx", "st_waveforms"), tctx.get_data("run_vx", "st_waveforms")
    _same_table(ref, out, "st_waveforms options")
    assert out["wave"].shape == (80, 64)

    reader = tadapter.get_adapter("vx2730").format_reader
    arrs = [reader.read_file(p) for p in sorted((run / "RAW").glob("*.CSV"))]
    spec = tadapter.get_adapter("vx2730").format_spec
    mapping = {(0, 0): 5, (0, 1): 3}
    for i, arr in enumerate(arrs):
        kw = dict(dt_ns=2, wave_length=50, baseline_samples=12, channel_idx=i,
                  channel_mapping=mapping)
        a = jwf.structure_channel_array(arr, jadapter.get_adapter("vx2730").format_spec, **kw)
        b = twf.structure_channel_array(arr, spec, **kw)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        assert set(b["channel"]) == {(5, 3)[i]}
    jcfg = jwf.WaveformStructConfig.from_adapter("vx2730")
    tcfg = twf.WaveformStructConfig.from_adapter("vx2730")
    assert tcfg.get_wave_length() == jcfg.get_wave_length()
    assert tcfg.get_record_dtype() == jcfg.get_record_dtype()
    _same_table(jcfg.make_struct(arrs, 2).structure_waveforms(),
                tcfg.make_struct(arrs, 2).structure_waveforms(), "WaveformStruct")


# ---------------------------------------------------------------------------
# refusals, profile, native build
# ---------------------------------------------------------------------------


def test_device_unpack_records_and_streaming_raise(tmp_path):
    """The V1725 device unpack and the records set are ported (slice 9):
    the unpack gives the host walk's st_waveforms and the records set its
    three plugins. The streaming profile is ported (slice 11): it is the
    JAX package's, the default profile plus signal_peaks_stream."""
    run = _v1725_run(tmp_path / "DAQ", n_events=4)
    _, tctx = _contexts(tmp_path, run.parent, "v1725", {"st_waveforms": {"device_unpack": True}})
    _, host = _contexts(tmp_path / "host", run.parent, "v1725")
    _same_table(host.get_data("run_bin", "st_waveforms"), tctx.get_data("run_bin", "st_waveforms"),
                "device_unpack")
    assert [p.provides for p in tsets.get_plugin_set("records")] == [
        p.provides for p in jsets.get_plugin_set("records")] == list(RECORDS_SET)
    for name in ("streaming", "streaming_default"):
        provides = [p.provides for p in tsets.get_profile(name)]
        assert provides == [p.provides for p in jsets.get_profile(name)]
        assert provides[-1] == "signal_peaks_stream"


def test_default_profile_is_tpu_default_minus_records():
    """The default profile registers the JAX package's tpu_default plugins,
    in the same order: since slice 9 the records set is no longer left
    out."""
    jax_provides = [p.provides for p in jsets.tpu_default()]
    for name in ("cuda", "cuda_default", "default", "cpu", "cpu_default"):
        provides = [p.provides for p in tsets.get_profile(name)]
        assert provides == jax_provides, name
    assert set(RECORDS_SET) <= set(provides)
    assert [type(p).__name__ for p in tsets.cuda_default()] == [
        type(p).__name__ for p in jsets.tpu_default()]
    for name in ("tpu", "jax", "jax_accel"):
        with pytest.raises(KeyError):
            tsets.get_profile(name)


def test_native_library_builds_under_build_dir():
    """g++ builds the decoder at first use into <checkout>/build/native,
    never into the package directory."""
    assert native.get_lib() is not None
    path = native.loaded_path()
    assert path.parent == ROOT / "build" / "native" and path.is_file()
    assert path == native.library_path()
    assert not list((ROOT / "waveformanalysis_tpu_torch").rglob("*.so"))


# ---------------------------------------------------------------------------
# adapter inference (the repair)
# ---------------------------------------------------------------------------


# the plugins of the port's Context route (present before the formats
# package was ported), keyed by the option each reads from the adapter
_INFERRED = ConfigResolver.ADAPTER_INFERRED_OPTIONS


def _route_plugins(pkg):
    import importlib

    mods = {m: importlib.import_module(f"{pkg}.plugins.builtin.{m}") for m in (
        "basic_features", "peak_finding", "hit_finder", "waveform_width",
        "waveform_width_integral", "s1_s2_classifier", "filtering", "hit_merge")}
    return [mods["basic_features"].BasicFeaturesPlugin(), mods["peak_finding"].HitFinderPlugin(),
            mods["hit_finder"].ThresholdHitPlugin(), mods["waveform_width"].WaveformWidthPlugin(),
            mods["waveform_width_integral"].WaveformWidthIntegralPlugin(),
            mods["s1_s2_classifier"].S1S2ClassifierPlugin(),
            mods["filtering"].FilteredWaveformsPlugin(), mods["hit_merge"].HitMergePlugin()]


@pytest.mark.parametrize("adapter", ["vx2730", "v1725"])
def test_adapter_inferred_options_match_jax(tmp_path, adapter):
    """For each DAQ adapter, every adapter-inferable option of every plugin
    resolves to the JAX package's value and ConfigSource, and the lineage
    lineages agree. Before the port had its formats package, the port resolved
    none of them (filtered_waveforms.fs 0.5 and hit_threshold.dt None under
    v1725, where JAX infers 0.25 and 4)."""
    cfg = {"daq_adapter": adapter, "show_progress": False}
    jctx = JContext(storage_dir=str(tmp_path / "jax"), config=cfg)
    jctx.register(*_route_plugins("waveformanalysis_tpu"))
    tctx = TContext(storage_dir=str(tmp_path / "port"), config=dict(cfg, device="cpu"))
    tctx.register(*_route_plugins("waveformanalysis_tpu_torch"))
    st = st_waveforms_from_waves(make_batch(8, 256, seed=0))
    seen = 0
    for ctx in (jctx, tctx):
        ctx.inject_data("r", "st_waveforms", st)
    for name in tctx.plugins:
        ref, out = jctx.get_resolved_config(name), tctx.get_resolved_config(name)
        for key in sorted(set(ref.keys()) & set(_INFERRED)):
            a, b = ref.get_value(key), out.get_value(key)
            assert (b.value, b.source.value) == (a.value, a.source.value), (adapter, name, key)
            seen += a.source.value == "adapter_inferred"
        assert _lineage(tctx, name) == _lineage(jctx, name), name
    assert seen >= 3  # fs, and dt of hit and hit_threshold at least
    fs = {"vx2730": 0.5, "v1725": 0.25}[adapter]
    assert tctx.get_config("filtered_waveforms", "fs") == fs
    assert tctx.get_config("hit_threshold", "dt") == {"vx2730": 2, "v1725": 4}[adapter]


@pytest.mark.parametrize("adapter", ["vx2730", "v1725"])
def test_profile_inferred_options_match_jax(tmp_path, adapter):
    """The same over the whole default profile (raw files to df_paired)."""
    jctx, tctx = _contexts(tmp_path, tmp_path / "DAQ", adapter)
    for name in tctx.plugins:
        ref, out = jctx.get_resolved_config(name), tctx.get_resolved_config(name)
        for key in sorted(set(ref.keys()) & set(_INFERRED)):
            a, b = ref.get_value(key), out.get_value(key)
            assert (b.value, b.source.value) == (a.value, a.source.value), (adapter, name, key)
        assert _lineage(tctx, name) == _lineage(jctx, name), name


N_ROUTE_B = 4096
MEMBERS = ("basic_features", "hit", "hit_threshold", "waveform_width", "s1_s2")
# route B without an explicit fs: under v1725 the adapter's 0.25 GHz, where
# these band edges are route B's (0.8 % and 40 % of Nyquist); dt is 4 ns, so
# the S1/S2 width ranges are config 7's at twice the ns
_ROUTE_B_V1725 = {
    "filtered_waveforms": {"filter_type": "BW", "filter_order": 4,
                           "lowcut": 0.001, "highcut": 0.05},
    "basic_features": {"wave_source": "filtered_waveforms"},
    "hit": {"use_derivative": False, "height": 80.0, "prominence": 50.0, "width": 2},
    "hit_threshold": {"wave_source": "filtered_waveforms"},
    "waveform_width": {"use_filtered": True},
    "s1_s2": {"s1_width_range": (0.0, 60.0), "s2_width_range": (80.0, 20000.0)},
}


def _route_b_context(pkg, path, st, filtered=None):
    cls = JContext if pkg == "waveformanalysis_tpu" else TContext
    cfg = {"daq_adapter": "v1725", "show_progress": False}
    if cls is TContext:
        cfg["device"] = "cpu"
    ctx = cls(storage_dir=str(path), config=cfg)
    ctx.register(*[p for p in _route_plugins(pkg) if p.provides != "hit_merged"])
    ctx.set_config(_ROUTE_B_V1725)
    ctx.inject_data("r", "st_waveforms", st)
    if filtered is not None:
        ctx.inject_data("r", "filtered_waveforms", filtered)
    ctx.get_data("r", ["s1_s2", "hit_threshold"])
    return ctx


def test_route_b_under_v1725_matches_jax(tmp_path):
    """Route B (the Butterworth bandpass, every member on
    filtered_waveforms) with daq_adapter v1725 and fs and dt left to the
    adapter, on 4,096 injected events, against the JAX route, whose filter
    runs the Pallas kernel in interpret mode (tests/test_torch_filtered_route.py
    says why). The filtered waves agree within 5e-4 of the largest
    |reference| (the port filtered at 0.5 GHz before the repair); hit
    decisions on float32 filtered waves are not exact across two float32
    filters (docs/PARITY.md:35), so the members are held, each table field
    by field (integers exact, float32 within atol 1e-3 / rtol 1e-4, table
    lengths and S1/S2 counts equal), on the JAX route's filtered table."""
    from waveformanalysis_tpu.ops import filtering as JF
    from waveformanalysis_tpu.ops.filter_pallas import sosfiltfilt_pallas

    st = st_waveforms_from_waves(make_batch(N_ROUTE_B, 256, seed=0), baseline=0.0, dt_ns=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JF, "sosfiltfilt_device", lambda waves, sos, dtype=np.float32:
                   sosfiltfilt_pallas(waves, sos, dtype=dtype, interpret=True))
        jctx = _route_b_context("waveformanalysis_tpu", tmp_path / "jax", st)
    port = _route_b_context("waveformanalysis_tpu_torch", tmp_path / "port", st)
    for ctx in (jctx, port):
        assert (ctx.get_config("filtered_waveforms", "fs"),
                ctx.get_config("hit_threshold", "dt")) == (0.25, 4)
    ref_filtered = jctx.get_data("r", "filtered_waveforms")
    a = np.asarray(ref_filtered["wave"], np.float64)
    b = np.asarray(port.get_data("r", "filtered_waveforms")["wave"], np.float64)
    assert np.max(np.abs(a - b)) < 5e-4 * np.max(np.abs(a))
    assert _lineage(port, "s1_s2") == _lineage(jctx, "s1_s2")

    shared = _route_b_context("waveformanalysis_tpu_torch", tmp_path / "shared", st,
                              filtered=ref_filtered.to_numpy())
    counts = []
    for ctx in (jctx, shared):
        lab = np.asarray(ctx.get_data("r", "s1_s2")["label"])
        counts.append({m: len(ctx.get_data("r", m)) for m in MEMBERS})
        counts[-1].update(n_s1=int(np.sum(lab == 1)), n_s2=int(np.sum(lab == 2)))
    assert counts[1] == counts[0]
    assert counts[0]["n_s1"] > 1000 and counts[0]["n_s2"] > 1000, counts[0]
    for m in MEMBERS:
        ref, got = jctx.get_data("r", m), shared.get_data("r", m)
        assert got.field_names == ref.field_names, m
        for f in ref.field_names:
            x, y = np.asarray(ref[f]), np.asarray(got[f])
            assert x.dtype == y.dtype and x.shape == y.shape, (m, f)
            if np.issubdtype(x.dtype, np.floating):
                np.testing.assert_allclose(y, x, atol=1e-3, rtol=1e-4, err_msg=f"{m}.{f}")
            else:
                np.testing.assert_array_equal(y, x, err_msg=f"{m}.{f}")
    for ctx in (jctx, port, shared):
        ctx.flush_saves()
