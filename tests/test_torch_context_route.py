"""The port's Context S1/S2 route and the ops under it, against JAX, on the CPU.

The same numpy inputs (from seeds) go through the JAX package and the port:
the ported ops (compaction, features, slot widths, integral widths), the
Table and profiler pieces the route uses, and the whole route
``Context.get_data(run, ["s1_s2", "hit_threshold"])`` over the five
S1/S2-cone plugins, set up as tests/test_fusion.py sets up the JAX one, with
the port's Context on ``device="cpu"``. Within the port, the fused program
must equal the unfused plugin path bit for bit, as tests/test_fusion.py
pins it in JAX. One test recomputes with JAX the constants chip_smoke.py
checks the route against on the card.

Tolerance: integer, index, count, validity and label outputs exact;
float32 outputs atol 1e-3 / rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bench import make_batch
from waveformanalysis_tpu.context.context import Context as JContext
from waveformanalysis_tpu.ops import compact as jcompact
from waveformanalysis_tpu.ops import features as jfeat
from waveformanalysis_tpu.ops import peaks as jpeaks
from waveformanalysis_tpu.ops import widths as jwidths
from waveformanalysis_tpu.plugins.builtin import basic_features as jbf
from waveformanalysis_tpu.plugins.builtin import hit_finder as jhf
from waveformanalysis_tpu.plugins.builtin import peak_finding as jpf
from waveformanalysis_tpu.plugins.builtin import s1_s2_classifier as js12
from waveformanalysis_tpu.plugins.builtin import waveform_width as jww
from waveformanalysis_tpu_torch.context.context import Context as TContext
from waveformanalysis_tpu_torch.device import scan_backend
from waveformanalysis_tpu_torch.dtypes.schema import ST_WAVEFORM_SCHEMA
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.foundation.profiler import Profiler
from waveformanalysis_tpu_torch.ops import compact as tcompact
from waveformanalysis_tpu_torch.ops import features as tfeat
from waveformanalysis_tpu_torch.ops import widths as twidths
from waveformanalysis_tpu_torch.plugins.builtin import basic_features as tbf
from waveformanalysis_tpu_torch.plugins.builtin import hit_finder as thf
from waveformanalysis_tpu_torch.plugins.builtin import peak_finding as tpf
from waveformanalysis_tpu_torch.plugins.builtin import s1_s2_classifier as ts12
from waveformanalysis_tpu_torch.plugins.builtin import waveform_width as tww
from waveformanalysis_tpu_torch.testing.fixtures import st_waveforms_from_waves

ATOL, RTOL = 1e-3, 1e-4
MEMBERS = ("basic_features", "hit", "hit_threshold", "waveform_width", "s1_s2")
ROUTE_CONFIG = {
    "hit": {"use_filtered": False, "use_derivative": False,
            "height": 80.0, "prominence": 50.0, "width": 2},
    "s1_s2": {"s1_width_range": (0.0, 30.0), "s2_width_range": (40.0, 10000.0)},
}


def _same(a, b, key):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
    assert a.shape == b.shape, (key, a.shape, b.shape)
    if np.issubdtype(a.dtype, np.floating):
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL, err_msg=key)
    else:
        np.testing.assert_array_equal(b, a, err_msg=key)


def _tables_close(ref, out, tag):
    assert ref.field_names == out.field_names, tag
    for f in ref.field_names:
        _same(ref[f], out[f], f"{tag}.{f}")


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def test_compact_slots_layout_and_order():
    """The (n*K, F+1) int32 layout, f32 bit-cast, row-major order and zero
    tail of the JAX compaction."""
    rng = np.random.default_rng(0)
    n, K = 64, 8
    stage = {
        "valid": rng.random((n, K)) < 0.3,
        "position": rng.integers(-1, 200, (n, K)).astype(np.int32),
        "value": rng.normal(0, 50, (n, K)).astype(np.float32),
        "flag": rng.integers(0, 2, (n, K)).astype(np.int32),
    }
    fields = ("position", "value", "flag")
    ref_mat, ref_count = jcompact.compact_slots({k: jnp.asarray(v) for k, v in stage.items()},
                                                fields)
    mat, count = tcompact.compact_slots({k: torch.as_tensor(v) for k, v in stage.items()},
                                        fields)
    assert count == int(ref_count) == int(stage["valid"].sum())
    _same(ref_mat, mat.numpy(), "matrix")
    rows, slots = tcompact.decode_slot_matrix(mat[:count].numpy(), fields,
                                              tcompact.field_dtypes(
                                                  {k: torch.as_tensor(v)
                                                   for k, v in stage.items()}, fields))
    r, c = np.nonzero(stage["valid"])
    np.testing.assert_array_equal(rows, r)
    np.testing.assert_array_equal(slots["value"], stage["value"][r, c])
    assert slots["value"].dtype == np.float32 and slots["position"].dtype == np.int32
    jrows, jslots = jcompact.decode_slot_matrix(np.asarray(ref_mat[: int(ref_count)]), fields,
                                                ("int32", "float32", "int32"))
    np.testing.assert_array_equal(jrows, rows)
    for f in fields:
        np.testing.assert_array_equal(jslots[f], slots[f])


def test_combine_features_and_device_variant():
    rng = np.random.default_rng(1)
    n, L = 64, 128
    waves = np.round(1000 + rng.normal(0, 30, (n, L))).astype(np.int16)
    el = rng.integers(0, L + 1, n).astype(np.int32)
    bl = (1000 + rng.normal(0, 2, n)).astype(np.float32)
    pol = rng.choice(np.array([-1, 0, 1], np.int8), n)
    win = dict(height_start=10, height_end=90, area_start=5, area_end=None)
    red = {k: np.asarray(v) for k, v in
           jfeat.feature_reductions(jnp.asarray(waves), jnp.asarray(el), **win).items()}
    ref = jfeat.combine_features(red, bl, pol)
    out = tfeat.combine_features(red, bl, pol)
    assert list(ref) == list(out)
    for k in ref:
        _same(ref[k], out[k], k)
    ref_d = jfeat.basic_features_device(jnp.asarray(waves), jnp.asarray(el), jnp.asarray(bl),
                                        jnp.asarray(pol), **win)
    out_d = tfeat.basic_features_device(torch.as_tensor(waves), torch.as_tensor(el),
                                        torch.as_tensor(bl), torch.as_tensor(pol), **win)
    assert set(ref_d) == set(out_d)
    for k in ref_d:
        _same(ref_d[k], out_d[k].numpy(), k)


def test_compute_baselines():
    rng = np.random.default_rng(2)
    waves = np.round(1000 + rng.normal(0, 5, (40, 96))).astype(np.int16)
    el = rng.integers(0, 97, 40).astype(np.int32)
    for window in ((0, 20), (5, 50)):
        ref = jfeat.compute_baselines(waves, window=window, event_length=el)
        out = tfeat.compute_baselines(waves, window=window, event_length=el, device="cpu")
        _same(ref, out, f"baselines{window}")


@pytest.mark.parametrize("interpolation", [True, False])
def test_width_from_peak_slots(interpolation):
    waves = make_batch(96, 128, seed=3)
    sig = jnp.asarray(waves, jnp.float32) - 1000.0
    peaks = jpeaks.find_peaks_batch(sig, 40.0, 20.0, 1.0, distance=2, max_peaks=4)
    pos, valid = np.array(peaks["position"]), np.array(peaks["valid"])
    ref = jwidths.width_from_peak_slots(jnp.asarray(waves, jnp.float32), jnp.asarray(pos),
                                        jnp.asarray(valid), interpolation=interpolation)
    out = twidths.width_from_peak_slots(torch.as_tensor(waves).float(), torch.as_tensor(pos),
                                        torch.as_tensor(valid),
                                        interpolation=interpolation)
    assert set(ref) == set(out)
    for k in ref:
        _same(ref[k], out[k].numpy(), k)
    assert np.asarray(ref["width_valid"]).sum() > 50


def test_integral_quantile_width():
    rng = np.random.default_rng(4)
    waves, n = make_batch(64, 128, seed=4), 64
    sign = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    sig = sign[:, None] * (waves.astype(np.float32) - 1000.0)  # integer-valued
    vlen = rng.integers(0, 129, n).astype(np.int32)
    ref = jwidths.integral_quantile_width(jnp.asarray(sig), jnp.asarray(vlen), q_low=0.1,
                                          q_high=0.9)
    out = twidths.integral_quantile_width(torch.as_tensor(sig), torch.as_tensor(vlen),
                                          q_low=0.1, q_high=0.9)
    assert set(ref) == set(out)
    for k in ref:
        _same(ref[k], out[k].numpy(), k)


# ---------------------------------------------------------------------------
# Table, profiler, backend choice
# ---------------------------------------------------------------------------

def test_table_device_columns():
    st = st_waveforms_from_waves(make_batch(8, 128, seed=0))
    host = Table.from_numpy(st, schema=ST_WAVEFORM_SCHEMA)
    dev = host.to_device("cpu")
    assert all(isinstance(v, torch.Tensor) for v in dev.columns.values())
    assert dev["polarity"].dtype == torch.int8  # enum coded on the way
    np.testing.assert_array_equal(dev.to_host()["wave"], st["wave"])
    both = Table.concatenate([dev, dev])
    assert len(both) == 16 and isinstance(both["wave"], torch.Tensor)
    zeros = Table.zeros(3, ST_WAVEFORM_SCHEMA, device="cpu", wave_length=128)
    assert zeros["wave"].shape == (3, 128) and zeros["wave"].dtype == torch.int16
    assert isinstance(Table.zeros(0, ST_WAVEFORM_SCHEMA, wave_length=4)["wave"], np.ndarray)


def test_profiler_sync_ignores_cpu_tensors(monkeypatch):
    prof = Profiler(sync_device=True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: pytest.fail("synchronized for CPU tensors"))
    with prof.time("x", result={"a": [torch.zeros(2)], "t": Table({"c": torch.ones(3)})}):
        pass
    assert prof.get("x")["count"] == 1


def test_scan_backend_choice():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert scan_backend("auto", cpu) == "xla"
    assert scan_backend("auto", cuda) == "scan"
    assert scan_backend("xla", cuda) == "xla"
    assert scan_backend("scan", cuda) == "scan"
    with pytest.raises(ValueError, match="scan"):
        scan_backend("scan", cpu)


# ---------------------------------------------------------------------------
# the route as a whole
# ---------------------------------------------------------------------------

def _st():
    """bench.py's pulses (S1-like and S2-like events), 512 x 128."""
    return st_waveforms_from_waves(make_batch(512, 128, seed=0))


def _jax_ctx(tmp_path, st):
    ctx = JContext(storage_dir=str(tmp_path / "jax"), config={"show_progress": False})
    ctx.register(jbf.BasicFeaturesPlugin(), jpf.HitFinderPlugin(), jhf.ThresholdHitPlugin(),
                 jww.WaveformWidthPlugin(), js12.S1S2ClassifierPlugin())
    ctx.set_config(ROUTE_CONFIG)
    ctx.inject_data("r", "st_waveforms", st)
    return ctx


def _port_ctx(path, st, **config):
    ctx = TContext(storage_dir=str(path),
                   config={"show_progress": False, "device": "cpu", **config})
    ctx.register(tbf.BasicFeaturesPlugin(), tpf.HitFinderPlugin(), thf.ThresholdHitPlugin(),
                 tww.WaveformWidthPlugin(), ts12.S1S2ClassifierPlugin())
    ctx.set_config(ROUTE_CONFIG)
    ctx.inject_data("r", "st_waveforms", st)
    return ctx


@pytest.fixture(scope="module")
def route_reference(tmp_path_factory):
    """The JAX route's member tables on _st() (computed once)."""
    st = _st()
    ctx = _jax_ctx(tmp_path_factory.mktemp("route"), st)
    ctx.get_data("r", ["s1_s2", "hit_threshold"])
    tables = {m: ctx.get_data("r", m) for m in MEMBERS}
    ctx.flush_saves()
    lab = np.asarray(tables["s1_s2"]["label"])
    assert (lab == 1).sum() > 100 and (lab == 2).sum() > 100  # both classes occur
    return st, tables


@pytest.mark.parametrize("variant", ["list_fused", "single_target", "unfused"])
def test_route_matches_jax(tmp_path, route_reference, variant):
    st, ref = route_reference
    ctx = _port_ctx(tmp_path, st, fused_execution=variant != "unfused")
    target = "s1_s2" if variant == "single_target" else ["s1_s2", "hit_threshold"]
    out = ctx.get_data("r", target)
    fused = "fusion.wave_chain.compute" in ctx.profiler.stats()
    assert fused == (variant != "unfused")
    if variant == "list_fused":
        assert list(out) == ["s1_s2", "hit_threshold"]
    for m in MEMBERS:
        _tables_close(ref[m], ctx.get_data("r", m), f"{variant}/{m}")
    ctx.flush_saves()


def test_other_bundle_members_match_jax(tmp_path):
    """waveform_width_integral (a fused device member without a kernel) and
    the hit_merge host members, fused in one bundle, against JAX."""
    from waveformanalysis_tpu.plugins.builtin import hit_merge as jhm
    from waveformanalysis_tpu.plugins.builtin import waveform_width_integral as jwwi
    from waveformanalysis_tpu_torch.plugins.builtin import hit_merge as thm
    from waveformanalysis_tpu_torch.plugins.builtin import waveform_width_integral as twwi

    st = st_waveforms_from_waves(make_batch(256, 128, seed=6))
    jctx = _jax_ctx(tmp_path, st)
    jctx.register(jwwi.WaveformWidthIntegralPlugin(), jhm.HitMergePlugin(),
                  jhm.HitMergeClustersPlugin())
    tctx = _port_ctx(tmp_path / "port", st)
    tctx.register(twwi.WaveformWidthIntegralPlugin(), thm.HitMergePlugin(),
                  thm.HitMergeClustersPlugin())
    names = ["waveform_width_integral", "hit_merged", "hit_merge_clusters", "s1_s2"]
    ref = jctx.get_data("r", names)
    out = tctx.get_data("r", names)
    assert "fusion.wave_chain.compute" in tctx.profiler.stats()
    for m in names:
        assert len(ref[m]) > 0, m
        _tables_close(ref[m], out[m], m)
    for ctx in (jctx, tctx):
        ctx.flush_saves()


def test_port_fused_equals_unfused_bit_for_bit(tmp_path):
    st = _st()
    fused = _port_ctx(tmp_path / "f", st, fused_execution=True)
    unfused = _port_ctx(tmp_path / "u", st, fused_execution=False)
    for ctx in (fused, unfused):
        ctx.get_data("r", ["s1_s2", "hit_threshold"])
    for m in MEMBERS:
        a, b = fused.get_data("r", m), unfused.get_data("r", m)
        assert len(a) > 0 and a.field_names == b.field_names, m
        for f in a.field_names:
            np.testing.assert_array_equal(np.asarray(a[f]), np.asarray(b[f]),
                                          err_msg=f"{m}.{f}")
    for ctx in (fused, unfused):
        ctx.flush_saves()


def test_port_route_reads_back_from_storage(tmp_path):
    """A second Context over the same storage loads every member from the
    cache the first one saved, with equal contents."""
    st = _st()
    first = _port_ctx(tmp_path, st)
    first.get_data("r", ["s1_s2", "hit_threshold"])
    first.flush_saves()
    second = _port_ctx(tmp_path, st)
    for m in MEMBERS:
        assert second.is_cache_hit("r", m), m
        a, b = first.get_data("r", m), second.get_data("r", m)
        for f in a.field_names:
            np.testing.assert_array_equal(np.asarray(a[f]), np.asarray(b[f]),
                                          err_msg=f"{m}.{f}")
    assert "fusion.wave_chain.compute" not in second.profiler.stats()


def test_scan_backend_on_cpu_context_raises(tmp_path):
    ctx = _port_ctx(tmp_path, _st())
    ctx.set_config({"hit": {"peaks_backend": "scan"}})
    with pytest.raises(ValueError, match="scan"):
        ctx.get_data("r", "hit")


def test_attach_mesh_route_matches_jax_and_one_device(tmp_path, route_reference):
    """The route on an 8-shard CPU mesh (the fused program on every shard)
    = the JAX route, and = the port's one-device route bit for bit."""
    from waveformanalysis_tpu_torch.parallel.mesh import make_mesh

    st, ref = route_reference
    one = _port_ctx(tmp_path / "one", st)
    ctx = _port_ctx(tmp_path / "mesh", st).attach_mesh(make_mesh(devices=["cpu"] * 8))
    out = ctx.get_data("r", ["s1_s2", "hit_threshold"])
    assert "fusion.single.device_program" in ctx.profiler.stats()
    one.get_data("r", ["s1_s2", "hit_threshold"])
    for m in MEMBERS:
        got = ctx.get_data("r", m)
        _tables_close(ref[m], got, m)
        want = one.get_data("r", m)
        for f in want.field_names:
            np.testing.assert_array_equal(np.asarray(got[f]), np.asarray(want[f]), err_msg=m)
    assert len(out["s1_s2"]) == len(ref["s1_s2"])


def test_chip_smoke_route_constants(tmp_path):
    """chip_smoke.py's REF_ROUTE_8192, recomputed with the JAX route on
    bench.make_batch(8192, 256, seed=0)."""
    import chip_smoke

    assert chip_smoke.ROUTE_CONFIG == ROUTE_CONFIG
    ctx = _jax_ctx(tmp_path, st_waveforms_from_waves(make_batch(8192, 256, seed=0)))
    ctx.get_data("r", ["s1_s2", "hit_threshold"])
    got = {m: len(ctx.get_data("r", m)) for m in MEMBERS}
    lab = np.asarray(ctx.get_data("r", "s1_s2")["label"])
    got.update(n_s1=int(np.sum(lab == 1)), n_s2=int(np.sum(lab == 2)))
    ctx.flush_saves()
    assert got == chip_smoke.REF_ROUTE_8192
