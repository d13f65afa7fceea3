"""The port's multi-run batched dispatch and the sticky slot-capacity hints,
on the CPU, against the JAX package and against the port's own per-run path.

``Context.get_data_batched`` concatenates runs on the event axis into one
fused device program per device configuration
(context/fusion.py compute_many). The runs are the JAX package's fixture
(tests/test_batched_dispatch.py: 180 / 300 / 77 events x 128, bucket 256),
built from seeds with numpy. Tolerance against JAX: integer, index, count,
validity and label outputs exact; float32 outputs atol 1e-3 / rtol 1e-4.
Within the port, batched = per-run bit for bit, as the JAX package pins it.
The hint tests mirror tests/test_fusion.py's.

JAX is imported inside the one test that runs it, so the card test at the
end runs on a machine without JAX:
``python -m pytest --noconftest -q -m cuda tests/test_torch_batched.py``.
"""

import logging

import numpy as np
import pytest
import torch

from waveformanalysis_tpu_torch.context import fusion as tfusion
from waveformanalysis_tpu_torch.context.context import Context
from waveformanalysis_tpu_torch.context.fusion import WaveChainFusion
from waveformanalysis_tpu_torch.data.batch_processor import BatchProcessor
from waveformanalysis_tpu_torch.dtypes.table import Table
from waveformanalysis_tpu_torch.plugins.builtin.basic_features import BasicFeaturesPlugin
from waveformanalysis_tpu_torch.plugins.builtin.dataframe import DataFramePlugin
from waveformanalysis_tpu_torch.plugins.builtin.event_analysis import GroupedEventsPlugin
from waveformanalysis_tpu_torch.plugins.builtin.hit_finder import ThresholdHitPlugin
from waveformanalysis_tpu_torch.plugins.builtin.peak_finding import HitFinderPlugin
from waveformanalysis_tpu_torch.plugins.builtin.s1_s2_classifier import S1S2ClassifierPlugin
from waveformanalysis_tpu_torch.plugins.builtin.waveform_width import WaveformWidthPlugin
from waveformanalysis_tpu_torch.plugins.builtin.waveform_width_integral import (
    WaveformWidthIntegralPlugin,
)
from waveformanalysis_tpu_torch.testing.fixtures import make_fake_st_waveforms

ATOL, RTOL = 1e-3, 1e-4
# the JAX package's members (tests/test_batched_dispatch.py) ...
MEMBERS = ["basic_features", "hit", "hit_threshold", "waveform_width_integral"]
# ... and the whole bundle, waveform_width and s1_s2 with them
ALL_MEMBERS = MEMBERS + ["waveform_width", "s1_s2"]
HIT_CONFIG = {"use_filtered": False, "use_derivative": False,
              "height": 100.0, "prominence": 50.0, "width": 2}


def _st(n, L=128, seed=0, pulse_height=300):
    st = make_fake_st_waveforms(
        n_events=n, wave_length=L, pulse_height=pulse_height,
        polarity="positive", noise_rms=3.0, seed=seed,
    )
    st["channel"] = (np.arange(n) % 2).astype(np.int16)
    return st


def _plugins(module=None):
    """The fixture's plugin instances, from the port or from ``module``'s
    package (the JAX package)."""
    classes = (BasicFeaturesPlugin, HitFinderPlugin, ThresholdHitPlugin,
               WaveformWidthIntegralPlugin, WaveformWidthPlugin, S1S2ClassifierPlugin,
               DataFramePlugin, GroupedEventsPlugin)
    if module is None:
        return [c() for c in classes]
    import importlib

    out = []
    for c in classes:
        mod = importlib.import_module(c.__module__.replace("waveformanalysis_tpu_torch",
                                                          module))
        out.append(getattr(mod, c.__name__)())
    return out


def _make_ctx(tmp_path, sub, runs, bucket=256, ctx_cls=Context, plugins=None, **config):
    cfg = {"show_progress": False, "fused_batch_bucket": bucket, **config}
    if ctx_cls is Context:
        cfg["device"] = "cpu"
    ctx = ctx_cls(storage_dir=str(tmp_path / sub), config=cfg)
    ctx.register(*(plugins if plugins is not None else _plugins()))
    ctx.set_config({"hit": dict(HIT_CONFIG)})
    for rid, st in runs.items():
        ctx.inject_data(rid, "st_waveforms", st)
    return ctx


def _col(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tables_equal(a, b, label=""):
    """Bit for bit: same length, columns, dtypes and values."""
    if isinstance(a, Table):
        assert isinstance(b, Table), label
        assert len(a) == len(b), f"{label}: {len(a)} vs {len(b)}"
        cols = a.columns
    else:  # a pandas DataFrame (the event tables)
        assert len(a) == len(b), f"{label}: {len(a)} vs {len(b)}"
        cols = list(a.columns)
    assert set(cols) == set(b.columns), label
    for col in cols:
        x, y = _col(a[col]), _col(b[col])
        assert x.dtype == y.dtype, f"{label}.{col}: {x.dtype} vs {y.dtype}"
        np.testing.assert_array_equal(x, y, err_msg=f"{label}.{col}")


@pytest.fixture()
def runs():
    # different sizes, so run boundaries are non-trivial and the bucket
    # padding (to a multiple of 256) is exercised
    return {"run_a": _st(180, seed=1), "run_b": _st(300, seed=2), "run_c": _st(77, seed=3)}


def test_batched_matches_jax(tmp_path, runs):
    """The port's get_data_batched against the JAX package's on the same
    injected runs, every member of the JAX package's batched tests: ints
    exact, f32 within atol/rtol. (waveform_width and s1_s2 are held to JAX
    on the single-run route, tests/test_torch_context_route.py, and batched
    = per-run below; the JAX package's CPU build of the batched
    waveform_width program alone takes half a minute.)"""
    from waveformanalysis_tpu.context.context import Context as JContext

    jctx = _make_ctx(tmp_path, "jax", runs, ctx_cls=JContext,
                     plugins=_plugins("waveformanalysis_tpu"))
    ref = jctx.get_data_batched(list(runs), MEMBERS)
    assert "fusion.wave_chain.compute_many" in jctx.profiler.stats()
    ctx = _make_ctx(tmp_path, "port", runs)
    got = ctx.get_data_batched(list(runs), MEMBERS)
    assert "fusion.wave_chain.compute_many" in ctx.profiler.stats()
    for rid in runs:
        for m in MEMBERS:
            a, b = ref[rid][m], got[rid][m]
            assert len(a) == len(b) and set(a.columns) == set(b.columns), (rid, m)
            for col in a.columns:
                x, y = np.asarray(a[col]), _col(b[col])
                assert x.dtype == y.dtype, (rid, m, col, x.dtype, y.dtype)
                if x.dtype.kind == "f":
                    np.testing.assert_allclose(y, x, atol=ATOL, rtol=RTOL,
                                               err_msg=f"{rid}.{m}.{col}")
                else:
                    np.testing.assert_array_equal(y, x, err_msg=f"{rid}.{m}.{col}")
        assert len(got[rid]["hit"]) > 0 and len(got[rid]["hit_threshold"]) > 0
    jctx.flush_saves()
    ctx.flush_saves()


def _dense_runs():
    """Dense multi-pulse waves: 40 pulses a waveform (negative polarity),
    past the slot capacity, so both slot members overflow."""
    n = 64
    st = make_fake_st_waveforms(n_events=n, wave_length=256, pulse_height=0,
                                polarity="negative", seed=9)
    waves = np.full((n, 256), 1000.0)
    for k in range(40):
        waves[:, 6 + 6 * k: 9 + 6 * k] -= 400.0
    st["wave"] = waves.astype(np.int16)
    st["channel"] = (np.arange(n) % 2).astype(np.int16)
    return {"dense_a": st, "dense_b": st.copy()}


IGNORE_OVERFLOW = {"hit": {"overflow_policy": "ignore"},
                   "hit_threshold": {"overflow_policy": "ignore"}}


@pytest.mark.parametrize("case", [
    "members", "all_members", "df_events", "mixed_wave_lengths", "overflow",
    "device_resident_waves",
])
def test_batched_equals_per_run(tmp_path, runs, case):
    """get_data_batched = per-run get_data, bit for bit: the bundle's
    members, the host plugins downstream of it (df, df_events), runs of
    different wave lengths (padded to the widest), dense runs that overflow
    the slot capacity, and waves held as tensors (copied into the group's
    matrix as tensors, never through a host array)."""
    names = ALL_MEMBERS if case in ("all_members", "mixed_wave_lengths") else MEMBERS
    if case == "df_events":
        names = ["df", "df_events"]
    elif case == "mixed_wave_lengths":
        runs = {"short": _st(100, L=64, seed=5), "long": _st(120, L=128, seed=6)}
    elif case == "overflow":
        runs = _dense_runs()
    ctx_ref = _make_ctx(tmp_path, "ref", runs)
    if case == "overflow":
        ctx_ref.set_config(IGNORE_OVERFLOW)
    ref = {rid: ctx_ref.get_data(rid, names) for rid in runs}

    if case == "device_resident_waves":
        runs = {rid: Table.from_numpy(st).with_columns(wave=torch.from_numpy(st["wave"]))
                for rid, st in runs.items()}

        def no_host_rows(*args):
            raise AssertionError("tensor waves went through a host array")

        orig = tfusion._host_rows
        tfusion._host_rows = no_host_rows
    ctx_b = _make_ctx(tmp_path, "batched", runs)
    if case == "overflow":
        ctx_b.set_config(IGNORE_OVERFLOW)
    try:
        got = ctx_b.get_data_batched(list(runs), names)
    finally:
        if case == "device_resident_waves":
            tfusion._host_rows = orig
    assert "fusion.wave_chain.compute_many" in ctx_b.profiler.stats()
    for rid in runs:
        for m in names:
            _assert_tables_equal(ref[rid][m], got[rid][m], f"{rid}.{m}")
    if case == "overflow":  # every event fills its slots: both members overflowed
        for m, cap in (("hit", "max_peaks"), ("hit_threshold", "max_hits")):
            k = ctx_b._plugins[m].kernel_config(ctx_b)[cap]
            assert {len(got[rid][m]) for rid in runs} == {64 * k}, m
    ctx_ref.flush_saves()
    ctx_b.flush_saves()


def test_batched_saves_caches_and_mixes_with_cached_runs(tmp_path, runs):
    """A run already computed per run reads from the cache inside a batched
    call; the batched results are saved, and a fresh Context over the same
    storage reads every run from disk, equal to what the batched call
    returned."""
    ctx = _make_ctx(tmp_path, "c", runs)
    pre = ctx.get_data("run_a", MEMBERS)
    got = ctx.get_data_batched(list(runs), MEMBERS)
    for m in MEMBERS:
        _assert_tables_equal(pre[m], got["run_a"][m], f"cached run_a.{m}")
    ctx.flush_saves()
    ctx2 = _make_ctx(tmp_path, "c", runs)
    for rid in runs:
        for m in MEMBERS:
            assert ctx2.cache_domain.is_cache_hit(rid, m), (rid, m)
            _assert_tables_equal(got[rid][m], ctx2.get_data(rid, m), f"reload {rid}.{m}")


def test_batched_single_name_and_single_member_bundle(tmp_path, runs):
    """A single name returns {run: Table}; with only basic_features
    registered the bundle has one member and still batches
    (plan_batched), its df_events = per run."""
    ctx = _make_ctx(tmp_path, "c", runs)
    got = ctx.get_data_batched(list(runs), "basic_features")
    assert set(got) == set(runs)
    for rid in runs:
        assert isinstance(got[rid], Table) and len(got[rid]) == len(runs[rid])
    ctx.flush_saves()

    def mk(sub):
        return _make_ctx(tmp_path, sub, runs, plugins=[
            BasicFeaturesPlugin(), DataFramePlugin(), GroupedEventsPlugin()])

    ref_ctx, b_ctx = mk("ref"), mk("batched")
    ref = {rid: ref_ctx.get_data(rid, "df_events") for rid in runs}
    got = b_ctx.get_data_batched(list(runs), "df_events")
    assert "fusion.wave_chain.compute_many" in b_ctx.profiler.stats()
    for rid in runs:
        _assert_tables_equal(ref[rid], got[rid], f"{rid}.df_events")
    ref_ctx.flush_saves()
    b_ctx.flush_saves()


def test_batched_per_run_targets_no_overcompute(tmp_path, runs):
    """A run computes and caches only the names pending FOR IT (the per-run
    mapping form of run_plugins_batched)."""
    ctx = _make_ctx(tmp_path, "c", runs)
    out = ctx.execution_domain.run_plugins_batched(
        ["run_a", "run_b"], {"run_a": ["hit"], "run_b": ["basic_features"]},
    )
    assert len(out["run_a"]["hit"]) > 0 and len(out["run_b"]["basic_features"]) > 0
    assert "basic_features" not in out["run_a"] and "hit" not in out["run_b"]
    ctx.flush_saves()
    assert not ctx.cache_domain.is_cache_hit("run_a", "basic_features")
    assert not ctx.cache_domain.is_cache_hit("run_b", "hit")
    assert ctx.cache_domain.is_cache_hit("run_a", "hit")
    assert ctx.cache_domain.is_cache_hit("run_b", "basic_features")


def test_batched_empty_run(tmp_path):
    runs = {"full": _st(50, seed=11), "empty": _st(1, seed=12)[:0]}
    ctx = _make_ctx(tmp_path, "c", runs)
    got = ctx.get_data_batched(list(runs), MEMBERS)
    for m in MEMBERS:
        assert len(got["empty"][m]) == 0, m
    assert len(got["full"]["basic_features"]) == 50
    ctx.flush_saves()


def test_batched_groups_by_wave_dtype(tmp_path):
    """Runs whose wave dtype differs go to separate programs (a run with
    int32 waves); host int16 arrays and int16 tensors share one group (the
    dtype key is the dtype's name). Each run's tables = its per-run
    tables."""
    st32 = _st(90, seed=8)
    runs = {"a": _st(70, seed=7), "b": _st(60, seed=9), "c": st32,
            "t": Table.from_numpy(_st(50, seed=10))}
    runs["t"] = runs["t"].with_columns(wave=torch.from_numpy(np.asarray(runs["t"]["wave"])))
    runs["c"] = Table.from_numpy(st32).with_columns(
        wave=np.asarray(st32["wave"]).astype(np.int32))
    rule = WaveChainFusion()
    ctx = _make_ctx(tmp_path, "c", runs)
    keys = {}
    for rid in runs:
        ctx.config_domain.prepare_request(rid)
        keys[rid] = rule._prep_run(ctx, rid, MEMBERS)["group_key"]
    assert keys["a"] == keys["b"] == keys["t"] != keys["c"]
    assert keys["c"][2] == "int32" and keys["a"][2] == "int16"
    ctx_ref = _make_ctx(tmp_path, "ref", runs)
    ref = {rid: ctx_ref.get_data(rid, MEMBERS) for rid in runs}
    calls = []
    orig = WaveChainFusion._dispatch_group

    def spy(self, ctx_, preps):
        calls.append(sorted(p["run_id"] for p in preps))
        return orig(self, ctx_, preps)

    WaveChainFusion._dispatch_group = spy
    try:
        got = ctx.get_data_batched(list(runs), MEMBERS)
    finally:
        WaveChainFusion._dispatch_group = orig
    assert sorted(calls) == [["a", "b", "t"], ["c"]]
    for rid in runs:
        for m in MEMBERS:
            _assert_tables_equal(ref[rid][m], got[rid][m], f"{rid}.{m}")
    ctx.flush_saves()
    ctx_ref.flush_saves()


# -- sticky slot-capacity hints (tests/test_fusion.py's, and the stale path) --

def _hint_ctx(store, **config):
    ctx = Context(storage_dir=store, config={"show_progress": False, "device": "cpu",
                                             **config})
    ctx.register(BasicFeaturesPlugin(), HitFinderPlugin(), ThresholdHitPlugin())
    ctx.set_config({"hit": dict(HIT_CONFIG)})
    return ctx


def _capacities(monkeypatch):
    """Record the (max_peaks, max_hits) each fused program runs with."""
    seen = []
    orig = WaveChainFusion._run_stages

    def spy(members, cfgs, *args):
        seen.append(tuple(cfgs[m][k] for m, k in (("hit", "max_peaks"),
                                                 ("hit_threshold", "max_hits"))))
        return orig(members, cfgs, *args)

    monkeypatch.setattr(WaveChainFusion, "_run_stages", staticmethod(spy))
    return seen


MEMBERS_HINT = ["basic_features", "hit", "hit_threshold"]


def test_capacity_hints_shrink_and_match_unhinted(tmp_path, monkeypatch):
    """With hints on (the default), compute 1 runs the configured capacity
    and records the observed per-event max; compute 2 runs the smallest
    bucket covering it; every output equals the unhinted program's."""
    seen = _capacities(monkeypatch)
    rule = WaveChainFusion()
    st = _st(128)
    ctx = _hint_ctx(str(tmp_path / "h"))
    ctx.inject_data("r", "st_waveforms", st)
    members = rule.plan(ctx, "r", set(MEMBERS_HINT))
    r1 = rule.compute(ctx, "r", members)
    r2 = rule.compute(ctx, "r", members)
    off = _hint_ctx(str(tmp_path / "off"), capacity_hints=False)
    off.inject_data("r", "st_waveforms", st)
    r0 = rule.compute(off, "r", members)
    configured = (ctx._plugins["hit"].kernel_config(ctx)["max_peaks"],
                  ctx._plugins["hit_threshold"].kernel_config(ctx)["max_hits"])
    assert seen[0] == configured == seen[2]
    assert seen[1] == (8, 8) and configured != (8, 8)
    for m in members:
        _assert_tables_equal(r0[m], r1[m], m)
        _assert_tables_equal(r0[m], r2[m], m)
    for m in ("hit", "hit_threshold"):  # JAX's key and content
        meta = ctx.storage.get_metadata(ctx.key_for("r", m) + "-caphint", "r")
        assert set(meta) == {"max_slot_count", "n_events"} and meta["n_events"] == 128
        assert 1 <= meta["max_slot_count"] <= 8, meta


def test_capacity_hint_persists_across_contexts(tmp_path, monkeypatch):
    """Hints live in cache metadata: a FRESH Context over the same storage
    runs the hinted capacity at once; outputs identical."""
    seen = _capacities(monkeypatch)
    rule = WaveChainFusion()
    st = _st(128)
    store = str(tmp_path / "p")
    ctx1 = _hint_ctx(store)
    ctx1.inject_data("r", "st_waveforms", st)
    members = rule.plan(ctx1, "r", set(MEMBERS_HINT))
    r1 = rule.compute(ctx1, "r", members)
    ctx1.flush_saves()
    ctx2 = _hint_ctx(store)
    ctx2.inject_data("r", "st_waveforms", st)
    assert 1 <= rule._get_hint(ctx2, "r", "hit_threshold", len(st)) <= 8
    r2 = rule.compute(ctx2, "r", members)
    assert seen[1] == (8, 8)
    for m in members:
        _assert_tables_equal(r1[m], r2[m], m)


def test_stale_capacity_hint_redispatches(tmp_path, monkeypatch, caplog):
    """Data re-injected under the same run id overflows the hinted
    capacity: the hint is dropped and the program re-dispatched at the
    configured capacity, giving the unhinted program's tables; the new
    count is recorded."""
    seen = _capacities(monkeypatch)
    rule = WaveChainFusion()
    ctx = _hint_ctx(str(tmp_path / "s"))
    ctx.inject_data("r", "st_waveforms", _st(64))
    members = rule.plan(ctx, "r", set(MEMBERS_HINT))
    rule.compute(ctx, "r", members)  # records a max count <= 8 -> bucket 8
    dense = _dense_runs()["dense_a"]  # 64 events again, 40 pulses each
    ctx.inject_data("r", "st_waveforms", dense)
    ctx.set_config(IGNORE_OVERFLOW)
    with caplog.at_level(logging.WARNING, logger=tfusion.__name__):
        got = rule.compute(ctx, "r", members)
    assert "stale slot-capacity hint" in caplog.text
    configured = seen[0]
    assert seen[1:] == [(8, 8), configured]
    off = _hint_ctx(str(tmp_path / "off"), capacity_hints=False)
    off.inject_data("r", "st_waveforms", dense)
    off.set_config(IGNORE_OVERFLOW)
    ref = rule.compute(off, "r", members)
    for m in members:
        _assert_tables_equal(ref[m], got[m], m)
    hint = rule._get_hint(ctx, "r", "hit", 64)
    assert hint is not None and hint > 8


def test_capacity_hint_of_the_support_hit_stage(tmp_path, monkeypatch):
    """waveform_width alone in the bundle (hit cached) runs an unemitted
    support hit stage: its max count is the hit hint, and its hinted
    capacity gives the same widths."""
    rule = WaveChainFusion()
    st = _st(96)
    ctx = _hint_ctx(str(tmp_path / "w"))
    ctx.register(WaveformWidthPlugin())
    ctx.inject_data("r", "st_waveforms", st)
    ctx.get_data("r", "hit")
    members = rule.plan(ctx, "r", {"waveform_width"}, min_members=1)
    assert members == ["waveform_width"]
    w1 = rule.compute(ctx, "r", members)
    assert 1 <= rule._get_hint(ctx, "r", "hit", 96) <= 8
    w2 = rule.compute(ctx, "r", members)
    _assert_tables_equal(w1["waveform_width"], w2["waveform_width"], "waveform_width")
    _assert_tables_equal(ctx.get_data("r", "waveform_width"), w1["waveform_width"],
                         "standalone")
    ctx.flush_saves()


def test_device_executor_runs_the_batched_program(tmp_path, runs):
    """BatchProcessor(executor_type="device") goes through get_data_batched
    (one compute_many), saves before it returns, and gives per-run
    df_events."""
    ctx_ref = _make_ctx(tmp_path, "ref", runs)
    ref = {rid: ctx_ref.get_data(rid, "df_events") for rid in runs}
    ctx = _make_ctx(tmp_path, "c", runs)
    res = BatchProcessor(ctx, executor_type="device", on_error="raise").process_runs(
        list(runs), "df_events")
    assert sorted(res.succeeded) == sorted(runs)
    assert ctx.profiler.stats()["fusion.wave_chain.compute_many"]["count"] == 1
    for rid in runs:
        _assert_tables_equal(ref[rid], res.get(rid).data, rid)
    ctx2 = _make_ctx(tmp_path, "c", runs)
    for rid in runs:
        assert ctx2.cache_domain.is_cache_hit(rid, "df_events"), rid
    ctx_ref.flush_saves()


def test_batched_multirun_demo_on_cpu():
    from waveformanalysis_tpu_torch.examples import batched_multirun_demo

    result = batched_multirun_demo.main(["--device", "cpu", "--runs", "3", "--events", "128"])
    assert result["events"] == 384 and result["batched_programs"] >= 1
    assert result["succeeded"] == ["run_000", "run_001", "run_002"]
    assert all(v > 0 for v in result["peaks"].values())


@pytest.mark.cuda
def test_batched_route_on_card(tmp_path):
    """Two 65,536 x 256 runs of bench.py's waves through slice 2's request
    on a CUDA Context: get_data_batched launches K2, K3 and K4 once each,
    its tables equal per-run get_data's on a second CUDA Context bit for
    bit, no cached table keeps a column on the card, and the memory
    allocated after each batched call stays flat."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    import chip_smoke
    from bench import make_batch
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc
    from waveformanalysis_tpu_torch.ops import width_scan_cuda as wsc
    from waveformanalysis_tpu_torch.testing.fixtures import st_waveforms_from_waves

    plugins = chip_smoke.route_plugin_classes()[:5]
    kernels = (csc.find_peaks_scan, csc.threshold_hits_scan, wsc.width_crossings_scan)
    request = ["s1_s2", "hit_threshold"]
    ctx = chip_smoke.make_route_context(Context, plugins, str(tmp_path / "b"), "cuda")
    ref = chip_smoke.make_route_context(Context, plugins, str(tmp_path / "r"), "cuda")
    held = []
    for call in range(3):
        rids = [f"c{call}r{i}" for i in range(2)]
        for i, rid in enumerate(rids):
            st = st_waveforms_from_waves(make_batch(65_536, 256, seed=10 * call + i))
            ctx.inject_data(rid, "st_waveforms", st)
            ref.inject_data(rid, "st_waveforms", st)
        for fn in kernels:
            fn.launches = 0
        got = ctx.get_data_batched(rids, request)
        torch.cuda.synchronize()
        assert [fn.launches for fn in kernels] == [1, 1, 1]
        for rid in rids:
            want = ref.get_data(rid, request)
            for m in chip_smoke.MEMBERS:
                _assert_tables_equal(ref.get_data(rid, m), ctx.get_data(rid, m), f"{rid}.{m}")
            for m in request:
                _assert_tables_equal(want[m], got[rid][m], f"{rid}.{m}")
        assert not [k for k, t in ctx._results.items() if isinstance(t, Table) and any(
            isinstance(v, torch.Tensor) and v.is_cuda for v in t.columns.values())]
        ctx.flush_saves()
        ref.flush_saves()
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
    assert max(held) - min(held) <= 16 << 20, held


@pytest.mark.parametrize("on_error", ["continue", "raise"])
def test_device_executor_retries_runs_one_by_one(tmp_path, runs, on_error):
    """A run that cannot be computed (no st_waveforms) fails the batched
    dispatch as a whole: on_error="continue" retries the runs one by one
    on the same Context, isolating the bad run; on_error="raise" raises the
    batched dispatch's error."""
    ctx = _make_ctx(tmp_path, "c", runs)
    bp = BatchProcessor(ctx, executor_type="device", on_error=on_error)
    if on_error == "raise":
        with pytest.raises(KeyError, match="st_waveforms"):
            bp.process_runs(list(runs) + ["missing_run"], "df_events")
        return
    res = bp.process_runs(list(runs) + ["missing_run"], "df_events")
    assert sorted(res.succeeded) == sorted(runs) and res.failed == ["missing_run"]
    assert ctx.profiler.stats()["fusion.wave_chain.compute_many"]["count"] == 1
    ctx.flush_saves()
