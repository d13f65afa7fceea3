"""Slice 3's routes through filtered_waveforms, in the port's CPU Context, against JAX.

Both routes run ``ctx.get_data(run, ["s1_s2", "hit_threshold"])`` over the
five S1/S2-cone plugins plus ``FilteredWaveformsPlugin`` with config 7's hit
and S1/S2 settings (scripts/benchmark_suite.py) on bench.py's waves:

- route A, the defaults: SG filter (window 11, poly 2); only ``hit`` reads
  ``filtered_waveforms`` (its ``use_filtered`` default), so the fusion plan
  fuses basic_features and hit_threshold and runs hit, waveform_width and
  s1_s2 through their standalone computes;
- route B: the Butterworth bandpass (order 4, 0.002-0.1 GHz at fs 0.5 GHz),
  every wave-reading member on ``filtered_waveforms`` and an st_waveforms
  baseline of 0 (the bandpass removes the DC level, and ``hit`` subtracts
  the st baseline), so all five members run in one fused program over the
  float32 filtered matrix.

The JAX reference for route B filters with the JAX package's Pallas kernel
(``sosfiltfilt_pallas``, in interpret mode), the path its TPU build takes
(ops/filtering.py:191-195): its CPU path, the XLA associative scan, sits
about 1e-4 of the wave scale from scipy for this design (lowcut at 0.8 % of
Nyquist), ten times further than the Pallas kernel and the port, which is
enough to move threshold decisions. Even so, hit decisions on float32
filtered waves are not exact across float32 filters (docs/PARITY.md:35):
route B is compared end to end by table lengths and S1/S2 counts, and
member by member on one shared filtered matrix.

Tolerance: integer, index, count, validity and label outputs exact; float32
outputs atol 1e-3 / rtol 1e-4; SG waves rtol 1e-5; Butterworth waves within
5e-4 of the largest |reference| (tests/test_filter_pallas.py's class).
"""

import numpy as np
import pytest
import torch

from bench import make_batch
from waveformanalysis_tpu.context.context import Context as JContext
from waveformanalysis_tpu.plugins.builtin import basic_features as jbf
from waveformanalysis_tpu.plugins.builtin import filtering as jfl
from waveformanalysis_tpu.plugins.builtin import hit_finder as jhf
from waveformanalysis_tpu.plugins.builtin import peak_finding as jpf
from waveformanalysis_tpu.plugins.builtin import s1_s2_classifier as js12
from waveformanalysis_tpu.plugins.builtin import waveform_width as jww
from waveformanalysis_tpu_torch.context.context import Context as TContext
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.plugins.builtin import basic_features as tbf
from waveformanalysis_tpu_torch.plugins.builtin import filtering as tfl
from waveformanalysis_tpu_torch.plugins.builtin import hit_finder as thf
from waveformanalysis_tpu_torch.plugins.builtin import peak_finding as tpf
from waveformanalysis_tpu_torch.plugins.builtin import s1_s2_classifier as ts12
from waveformanalysis_tpu_torch.plugins.builtin import waveform_width as tww
from waveformanalysis_tpu_torch.testing.fixtures import st_waveforms_from_waves

ATOL, RTOL = 1e-3, 1e-4
MEMBERS = ("basic_features", "hit", "hit_threshold", "waveform_width", "s1_s2")
N_REF = 4096  # chip_smoke.py's reference size (one shape: the JAX filter compiles per shape)
_HIT = {"use_derivative": False, "height": 80.0, "prominence": 50.0, "width": 2}
_S1S2 = {"s1_width_range": (0.0, 30.0), "s2_width_range": (40.0, 10000.0)}
ROUTES = {
    "A": ({"hit": _HIT, "s1_s2": _S1S2}, 1000.0),
    "B": ({"filtered_waveforms": {"filter_type": "BW", "filter_order": 4,
                                  "lowcut": 0.002, "highcut": 0.1, "fs": 0.5},
           "basic_features": {"wave_source": "filtered_waveforms"},
           "hit": _HIT,
           "hit_threshold": {"wave_source": "filtered_waveforms"},
           "waveform_width": {"use_filtered": True},
           "s1_s2": _S1S2}, 0.0),
}
# members each route computes outside the fused program (the JAX plan)
STANDALONE = {"A": {"hit", "waveform_width", "s1_s2"}, "B": set()}


def _st(route, n):
    return st_waveforms_from_waves(make_batch(n, 256, seed=0), baseline=ROUTES[route][1])


def _jax_ctx(path, config, st):
    ctx = JContext(storage_dir=str(path), config={"show_progress": False})
    ctx.register(jbf.BasicFeaturesPlugin(), jpf.HitFinderPlugin(), jhf.ThresholdHitPlugin(),
                 jww.WaveformWidthPlugin(), js12.S1S2ClassifierPlugin(),
                 jfl.FilteredWaveformsPlugin())
    ctx.set_config(config)
    ctx.inject_data("r", "st_waveforms", st)
    return ctx


def _port_ctx(path, config, st, **context_config):
    ctx = TContext(storage_dir=str(path),
                   config={"show_progress": False, "device": "cpu", **context_config})
    ctx.register(tbf.BasicFeaturesPlugin(), tpf.HitFinderPlugin(), thf.ThresholdHitPlugin(),
                 tww.WaveformWidthPlugin(), ts12.S1S2ClassifierPlugin(),
                 tfl.FilteredWaveformsPlugin())
    ctx.set_config(config)
    ctx.inject_data("r", "st_waveforms", st)
    return ctx


def _counts(tables):
    lab = np.asarray(tables["s1_s2"]["label"])
    got = {m: len(tables[m]) for m in MEMBERS}
    got.update(n_s1=int(np.sum(lab == 1)), n_s2=int(np.sum(lab == 2)))
    return got


def _standalone(ctx):
    return {m for m in MEMBERS if f"plugin.{m}.compute" in ctx.profiler.stats()}


def _same(a, b, key):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (key, a.dtype, b.dtype, a.shape, b.shape)
    if np.issubdtype(a.dtype, np.floating):
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL, err_msg=key)
    else:
        np.testing.assert_array_equal(b, a, err_msg=key)


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))


@pytest.fixture(scope="module")
def jax_routes(tmp_path_factory):
    """The JAX routes on N_REF events: member tables, filtered waves and
    the members computed standalone (route B's filter: the Pallas kernel)."""
    from waveformanalysis_tpu.ops import filtering as JF
    from waveformanalysis_tpu.ops.filter_pallas import sosfiltfilt_pallas

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JF, "sosfiltfilt_device", lambda waves, sos, dtype=np.float32:
                   sosfiltfilt_pallas(waves, sos, dtype=dtype, interpret=True))
        for route in ROUTES:
            ctx = _jax_ctx(tmp_path_factory.mktemp(route), ROUTES[route][0], _st(route, N_REF))
            ctx.get_data("r", ["s1_s2", "hit_threshold"])
            tables = {m: ctx.get_data("r", m) for m in MEMBERS + ("filtered_waveforms",)}
            ctx.flush_saves()
            out[route] = (tables, _standalone(ctx))
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_chip_smoke_route_constants(jax_routes, route):
    """chip_smoke.py's route configs and its REF_FILTER_ROUTES, recomputed
    with the JAX routes; the JAX plans are the ones documented above."""
    import chip_smoke

    assert chip_smoke.FILTER_ROUTES[route] == ROUTES[route]
    assert chip_smoke.N_FILTER_REF == N_REF
    tables, standalone = jax_routes[route]
    assert standalone == STANDALONE[route]
    got = _counts(tables)
    assert got == chip_smoke.REF_FILTER_ROUTES[route]
    assert got["n_s1"] > 1000 and got["n_s2"] > 1000  # both classes occur


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_jax(tmp_path, jax_routes, route, fused):
    ref, ref_standalone = jax_routes[route]
    ctx = _port_ctx(tmp_path, ROUTES[route][0], _st(route, N_REF), fused_execution=fused)
    out = ctx.get_data("r", ["s1_s2", "hit_threshold"])
    assert list(out) == ["s1_s2", "hit_threshold"]
    tables = {m: ctx.get_data("r", m) for m in MEMBERS + ("filtered_waveforms",)}
    assert _standalone(ctx) == (ref_standalone if fused else set(MEMBERS))
    assert _counts(tables) == _counts(ref)
    wave, ref_wave = tables["filtered_waveforms"]["wave"], ref["filtered_waveforms"]["wave"]
    # once get_data returns, the cached filtered waves are a host float32
    # matrix, as the JAX plugin returns them
    assert isinstance(wave, np.ndarray) and wave.dtype == np.asarray(ref_wave).dtype == np.float32
    if route == "A":
        np.testing.assert_allclose(wave, np.asarray(ref_wave), rtol=1e-5)
        for m in MEMBERS:
            assert tables[m].field_names == ref[m].field_names, m
            for f in ref[m].field_names:
                _same(ref[m][f], tables[m][f], f"{m}.{f}")
    else:
        assert _rel(wave, ref_wave) < 5e-4
    ctx.flush_saves()


def test_route_b_members_match_jax_on_shared_filtered_waves(tmp_path):
    """Every route-B member, fused over the float32 filtered matrix, against
    the JAX route given the same filtered table; and fused = unfused in the
    port, bit for bit."""
    st = _st("B", 512)
    src = _port_ctx(tmp_path / "src", ROUTES["B"][0], st)
    filtered = src.get_data("r", "filtered_waveforms").to_numpy()
    jctx = _jax_ctx(tmp_path / "jax", ROUTES["B"][0], st)
    ports = [_port_ctx(tmp_path / f"port{i}", ROUTES["B"][0], st, fused_execution=fused)
             for i, fused in enumerate((True, False))]
    for ctx in [jctx] + ports:
        ctx.inject_data("r", "filtered_waveforms", filtered)
        ctx.get_data("r", ["s1_s2", "hit_threshold"])
    assert _standalone(jctx) == _standalone(ports[0]) == set()
    assert len(jctx.get_data("r", "hit")) > 256
    for m in MEMBERS:
        ref, fused, unfused = (c.get_data("r", m) for c in [jctx] + ports)
        assert fused.field_names == ref.field_names, m
        for f in ref.field_names:
            _same(ref[f], fused[f], f"{m}.{f}")
            np.testing.assert_array_equal(np.asarray(fused[f]), np.asarray(unfused[f]),
                                          err_msg=f"fused != unfused: {m}.{f}")
    for ctx in [jctx] + ports:
        ctx.flush_saves()


class _DeviceOnly(torch.Tensor):
    """A tensor that refuses conversion to a host array, as a CUDA tensor does."""

    def __array__(self, *args, **kwargs):
        raise TypeError("a device tensor does not convert to a host array")


def test_standalone_width_gathers_a_device_wave_column(tmp_path):
    """waveform_width's standalone compute reads a device-resident
    filtered_waveforms column (route B unfused on a CUDA Context) on the
    device; it used to convert the column with np.asarray, which a CUDA
    tensor refuses."""
    st = _st("B", 256)
    ref = _port_ctx(tmp_path / "ref", ROUTES["B"][0], st, fused_execution=False)
    expected = ref.get_data("r", "waveform_width")
    filtered = ref.get_data("r", "filtered_waveforms")
    wave = torch.from_numpy(np.asarray(filtered["wave"])).as_subclass(_DeviceOnly)
    device_only = Table(dict(filtered.columns, wave=wave), schema=filtered.schema,
                        validate=False)
    ctx = _port_ctx(tmp_path / "dev", ROUTES["B"][0], st, fused_execution=False)
    ctx.inject_data("r", "filtered_waveforms", device_only)
    out = ctx.get_data("r", "waveform_width")
    assert len(out) > 100
    for f in expected.field_names:
        np.testing.assert_array_equal(np.asarray(out[f]), np.asarray(expected[f]), err_msg=f)
    for c in (ref, ctx):
        c.flush_saves()


def test_memory_cache_holds_no_device_columns_after_route_b_runs(tmp_path, monkeypatch):
    """After two route-B requests no table in the memory cache holds a
    tensor column (the filtered waves were one on the Context's device), the
    columns are released once per outermost get_data (not by the plugins'
    nested reads), and every table equals the one a Context that keeps its
    device columns returns."""
    cfg = ROUTES["B"][0]
    names = MEMBERS + ("filtered_waveforms",)
    kept = _port_ctx(tmp_path / "kept", cfg, _st("B", 256))
    monkeypatch.setattr(kept, "_release_device_columns", lambda keys: {})
    ctx = _port_ctx(tmp_path / "released", cfg, _st("B", 256))
    releases = []
    release = ctx._release_device_columns
    monkeypatch.setattr(ctx, "_release_device_columns",
                        lambda keys: releases.append(list(keys)) or release(keys))
    for run in ("r", "r2"):
        for c in (kept, ctx):
            if run != "r":
                c.inject_data(run, "st_waveforms", _st("B", 256))
            c.get_data(run, ["s1_s2", "hit_threshold"])
    assert [("filtered_waveforms" in {n for _, n in keys}) for keys in releases if keys] == [
        True, True]
    assert isinstance(kept.get_data("r", "filtered_waveforms")["wave"], torch.Tensor)
    for key, table in ctx._results.items():
        if isinstance(table, Table):
            assert not any(isinstance(v, torch.Tensor) for v in table.columns.values()), key
    for run in ("r", "r2"):
        for m in names:
            ref, out = kept.get_data(run, m), ctx.get_data(run, m)
            assert out.field_names == ref.field_names, m
            for f in ref.field_names:
                np.testing.assert_array_equal(np.asarray(out[f]), np.asarray(ref[f]),
                                              err_msg=f"{run}/{m}.{f}")
    for c in (kept, ctx):
        c.flush_saves()


def test_bandpass_hit_against_the_st_baseline_finds_nothing(tmp_path):
    """Why route B sets the st baseline to 0: the bandpass removes the DC
    level while hit subtracts the st_waveforms baseline, so with the
    fixture's baseline of 1000 and hit alone on the Butterworth-filtered
    waves no peak reaches the height, in the JAX package and in the port."""
    config = {"filtered_waveforms": ROUTES["B"][0]["filtered_waveforms"],
              "hit": _HIT, "s1_s2": _S1S2}
    st = _st("A", 512)  # baseline 1000
    for ctx in (_jax_ctx(tmp_path / "jax", config, st), _port_ctx(tmp_path / "port", config, st)):
        out = ctx.get_data("r", ["s1_s2", "hit_threshold"])
        assert len(ctx.get_data("r", "hit")) == 0 and len(out["s1_s2"]) == 0
        assert len(out["hit_threshold"]) > 512  # the st-source members still work
        ctx.flush_saves()
