"""Slice 9, records ingest, on the CPU, against the JAX package.

The same inputs, made from a seed with numpy (or written as DAQ files by
the packages' fixtures), go through the JAX package's records modules and
the port's: the sort order and its torch device form, the pool gather, the
part merge, the builders from st_waveforms and from VX2730 (the typed
native decode and the generic one) and V1725 files, the streaming builder,
partitioned builds, ``RecordsView``, ``TimeRangeQueryEngine``, the three
records plugins, and the records route of ``chip_smoke.py``
(``get_data(run, RECORDS_REQUEST)`` with ``wave_source="records"``) at
4,096 waveforms on both of its filter settings, table for table.

Tolerance: records, pools, orders, integer and index columns exact;
float32 outputs atol 1e-3 / rtol 1e-4; the SG-filtered pool rtol 1e-5;
the Butterworth-filtered pool within 5e-4 of its largest |value| against
the JAX package's Pallas kernel in interpret mode (the class of
tests/test_filter_pallas.py and tests/test_torch_filtered_route.py: at
route B's design both float32 cascades sit up to 2e-3 ADC from scipy on
short rows with 300-count pulses, beyond docs/PARITY.md:34's atol 5e-4). Route B's tables are
compared with the port's filtered pool given to the JAX route, since a
float32 filter's last digits may move a threshold decision.
"""

from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
from waveformanalysis_tpu import native as jnative
from waveformanalysis_tpu.context.context import Context as JContext
from waveformanalysis_tpu.data.query import TimeRangeQueryEngine as JQuery
from waveformanalysis_tpu.data.records_view import RecordsView as JView
from waveformanalysis_tpu.dtypes.schema import RECORDS_SCHEMA as J_RECORDS_SCHEMA
from waveformanalysis_tpu.dtypes.table import Table as JTable
from waveformanalysis_tpu.plugins import plugin_sets as jsets
from waveformanalysis_tpu.processing import records_builder as JRB
from waveformanalysis_tpu.processing.loader import get_raw_files
from waveformanalysis_tpu.testing.fixtures import make_fake_st_waveforms, make_synthetic_vx2730_run
from waveformanalysis_tpu_torch import native as tnative
from waveformanalysis_tpu_torch.context.context import Context as TContext
from waveformanalysis_tpu_torch.data.query import TimeRangeQueryEngine as TQuery
from waveformanalysis_tpu_torch.data.records_view import RecordsView as TView
from waveformanalysis_tpu_torch.dtypes.schema import RECORDS_SCHEMA as T_RECORDS_SCHEMA
from waveformanalysis_tpu_torch.dtypes.table import Table as TTable
from waveformanalysis_tpu_torch.plugins import plugin_sets as tsets
from waveformanalysis_tpu_torch.processing import records_builder as TRB
from waveformanalysis_tpu_torch.testing.fixtures import write_v1725_run

ATOL, RTOL = 1e-3, 1e-4
BW = chip_smoke.RECORDS_ROUTES["B"]["wave_pool_filtered"]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _same_array(ref, out, tag, rtol=RTOL, atol=ATOL):
    a, b = np.asarray(ref), np.asarray(out)
    assert a.dtype == b.dtype and a.shape == b.shape, (tag, a.dtype, b.dtype, a.shape, b.shape)
    if np.issubdtype(a.dtype, np.floating):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=tag)
    else:
        np.testing.assert_array_equal(b, a, err_msg=tag)


def _same(ref, out, tag, rtol=RTOL, atol=ATOL):
    """A Table field by field, a DataFrame column by column (per-event
    array cells one by one), or an array; dtypes and shapes equal."""
    if isinstance(ref, pd.DataFrame):
        assert list(out.columns) == list(ref.columns) and len(out) == len(ref), tag
        assert list(out.dtypes) == list(ref.dtypes), (tag, list(ref.dtypes), list(out.dtypes))
        for col in ref.columns:
            if ref[col].dtype == object:
                for i, (x, y) in enumerate(zip(ref[col], out[col])):
                    _same_array(x, y, f"{tag}.{col}[{i}]")
            else:
                _same_array(ref[col].to_numpy(), out[col].to_numpy(), f"{tag}.{col}")
        return
    if isinstance(ref, np.ndarray):
        assert isinstance(out, np.ndarray), (tag, type(out))
        _same_array(ref, out, tag, rtol, atol)
        return
    assert out.field_names == ref.field_names and len(out) == len(ref), tag
    for f in ref.field_names:
        _same_array(ref[f], out[f], f"{tag}.{f}", rtol, atol)


def _rel(ref, out):
    """max |out - ref| over the largest |ref|: the Butterworth class."""
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))


def _same_bundle(ref, out, tag, skip=()):
    """Two RecordsBundles exactly (NaN where NaN)."""
    assert out.records.field_names == ref.records.field_names, tag
    for f in ref.records.field_names:
        if f not in skip:
            _same_array(ref.records[f], out.records[f], f"{tag}.{f}", rtol=0, atol=0)
    _same_array(ref.wave_pool, out.wave_pool, f"{tag}.wave_pool", rtol=0, atol=0)


def _tables(cols, n):
    """The same records table in both packages: zeros of the records
    schema with ``cols`` set."""
    return (JTable.zeros(n, J_RECORDS_SCHEMA).with_columns(**cols),
            TTable.zeros(n, T_RECORDS_SCHEMA).with_columns(**cols))


def _sort_keys(case, n=600, seed=3):
    """Sort-key columns of ``n`` records. ``channel_ties``: two channels,
    each time-sorted, concatenated in channel order with a third of the
    timestamps shared (the builder's layout, the fast path);
    ``board_ties``: the same with board 1's part first (ties need the
    fallback); ``pid_ties``: interleaved pids; ``duplicates``: every key
    drawn from a handful of values; ``distinct``: no ties."""
    rng = np.random.default_rng(seed)
    h = n // 2
    ts = np.sort(rng.integers(0, n, h)).astype(np.int64) * 1000
    if case in ("channel_ties", "board_ties"):
        other = np.sort(np.where(rng.random(h) < 0.33, ts, ts + 7))
        first = 1 if case == "board_ties" else 0
        return {"timestamp": np.r_[ts, other], "pid": np.zeros(n, np.int32),
                "board": np.r_[np.full(h, first), np.full(h, 1 - first)].astype(np.int16),
                "channel": np.r_[np.zeros(h), np.ones(h)].astype(np.int16)}
    if case == "pid_ties":
        return {"timestamp": np.r_[ts, ts], "pid": np.r_[np.ones(h), np.zeros(h)].astype(np.int32),
                "board": np.zeros(n, np.int16), "channel": np.zeros(n, np.int16)}
    if case == "duplicates":
        return {"timestamp": rng.integers(0, 50, n).astype(np.int64) * 1_000_000,
                "pid": rng.integers(0, 3, n).astype(np.int32),
                "board": rng.integers(0, 2, n).astype(np.int16),
                "channel": rng.integers(0, 2, n).astype(np.int16)}
    return {"timestamp": rng.permutation(n).astype(np.int64), "pid": np.zeros(n, np.int32),
            "board": np.zeros(n, np.int16), "channel": np.zeros(n, np.int16)}


def _random_bundles(tables_cls, schema, seed, n_parts=3, ragged=True):
    """Parts with random keys, lengths and samples (the same in both
    packages for the same seed)."""
    rng = np.random.default_rng(seed)
    out = []
    for p in range(n_parts):
        n = int(rng.integers(5, 40))
        lengths = (rng.integers(1, 9, n) if ragged else np.full(n, 4)).astype(np.int32)
        offsets = np.r_[0, np.cumsum(lengths)[:-1]].astype(np.int64)
        cols = {"timestamp": rng.integers(0, 30, n).astype(np.int64) * 1000,
                "pid": np.full(n, p, np.int32), "board": rng.integers(0, 2, n).astype(np.int16),
                "channel": rng.integers(0, 3, n).astype(np.int16),
                "event_length": lengths, "wave_offset": offsets,
                "baseline": rng.normal(1000, 3, n)}
        rec = tables_cls.zeros(n, schema).with_columns(**cols)
        pool = rng.integers(0, 1 << 16, int(lengths.sum()), dtype=np.uint16)
        out.append((rec, pool))
    return out


# ---------------------------------------------------------------------------
# sort, gather, merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["channel_ties", "board_ties", "pid_ties", "duplicates",
                                  "distinct"])
def test_records_sort_order_matches_jax(case):
    """The host order (fast path or fallback) = the JAX package's = the
    five-key lexsort; the torch device order on the CPU = the host order."""
    cols = _sort_keys(case)
    jt, tt = _tables(cols, len(cols["timestamp"]))
    want = np.lexsort((np.arange(len(cols["timestamp"])), cols["channel"], cols["board"],
                       cols["pid"], cols["timestamp"]))
    ref = JRB.records_sort_order(jt)
    got = TRB.records_sort_order(tt)
    dev = TRB.records_sort_order_device(tt, device="cpu")
    for order in (ref, got, dev):
        np.testing.assert_array_equal(order, want)
    assert dev.dtype == got.dtype == np.int64
    fast = np.argsort(cols["timestamp"], kind="stable")
    # the layouts that need the fallback do not take the single-sort order
    assert np.array_equal(fast, want) == (case in ("channel_ties", "distinct"))


def test_records_sort_order_device_empty_and_backends(monkeypatch):
    jt, tt = _tables(_sort_keys("distinct", n=0), 0)
    assert len(TRB.records_sort_order_device(tt, device="cpu")) == 0
    for backend in ("auto", "host", "device"):
        assert TRB.resolve_records_sort_backend(backend) == \
            JRB.resolve_records_sort_backend(backend)
    monkeypatch.setenv("WFA_RECORDS_SORT_BACKEND", "device")
    assert TRB.resolve_records_sort_backend("auto") == "device"
    monkeypatch.delenv("WFA_RECORDS_SORT_BACKEND")
    with pytest.raises(ValueError):
        TRB.resolve_records_sort_backend("nope")


def test_device_entry_points_refuse_cuda_without_a_gpu(monkeypatch):
    """A device="cuda" sort order or padded gather raises where no GPU is,
    rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tt = _tables(_sort_keys("distinct", n=8), 8)
    view = TView(tt.with_columns(event_length=np.full(8, 4, np.int32),
                                 wave_offset=np.arange(8, dtype=np.int64) * 4),
                 np.zeros(32, np.uint16))
    with pytest.raises(RuntimeError, match="cuda"):
        TRB.records_sort_order_device(tt, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        view.padded_wave_matrix_device()


@pytest.mark.parametrize("case", ["contiguous", "fixed_rows", "ragged", "empty"])
def test_gather_pool_matches_jax(case):
    rng = np.random.default_rng(11)
    n, L = 50, 6
    pool = rng.integers(0, 1 << 16, n * L, dtype=np.uint16)
    lengths = np.full(n, L) if case != "ragged" else rng.integers(0, L + 1, n)
    offsets = np.arange(n, dtype=np.int64) * L
    if case in ("fixed_rows", "ragged"):
        offsets = rng.permutation(offsets)
    if case == "empty":
        lengths = lengths[:0]
        offsets = offsets[:0]
    ref_pool, ref_off = JRB.gather_pool(pool, offsets, lengths)
    got_pool, got_off = TRB.gather_pool(pool, offsets, lengths)
    _same_array(ref_pool, got_pool, "pool", 0, 0)
    _same_array(ref_off, got_off, "offsets", 0, 0)


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "fixed"])
def test_merge_records_parts_matches_jax_and_one_global_sort(ragged):
    jparts = [JRB.RecordsBundle(r, p) for r, p in
              _random_bundles(JTable, J_RECORDS_SCHEMA, 5, ragged=ragged)]
    tparts = [TRB.RecordsBundle(r, p) for r, p in
              _random_bundles(TTable, T_RECORDS_SCHEMA, 5, ragged=ragged)]
    ref = JRB.merge_records_parts(jparts)
    got = TRB.merge_records_parts(tparts)
    _same_bundle(ref, got, "merge")
    # one global sort of the concatenation (offsets rebased) is the same
    records, pool = TRB._concat_rebased(tparts)
    _same_bundle(got, TRB.sort_bundle(TRB.RecordsBundle(records, pool)), "global sort")
    _same_bundle(got, TRB.sort_bundle(TRB.RecordsBundle(records, pool), sort_backend="device",
                                      device="cpu"), "device sort")
    np.testing.assert_array_equal(np.asarray(got.records["record_id"]), np.arange(len(got)))


def test_merge_over_a_mesh_matches_host_and_jax():
    """The sharded merge on an 8-shard CPU mesh (timestamp ties across
    boards and channels, a row count that is no multiple of 8) = the host
    merge = the JAX package's mesh merge on its 8 virtual devices, bit for
    bit; a one-device mesh takes the host path."""
    import jax

    from waveformanalysis_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from waveformanalysis_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=[torch.device("cpu")] * 8)
    tparts = [TRB.RecordsBundle(r, p) for r, p in
              _random_bundles(TTable, T_RECORDS_SCHEMA, 6, n_parts=3)]
    jparts = [JRB.RecordsBundle(r, p) for r, p in
              _random_bundles(JTable, J_RECORDS_SCHEMA, 6, n_parts=3)]
    assert sum(len(p.records) for p in tparts) % 8
    host = TRB.merge_records_parts(tparts)
    got = TRB.merge_records_parts(tparts, mesh=mesh)
    _same_bundle(host, got, "mesh merge")
    _same_bundle(JRB.merge_records_parts(jparts, mesh=jax_make_mesh(8, devices=jax.devices()[:8])),
                 got, "JAX mesh merge")
    one = make_mesh(devices=[torch.device("cpu")])
    _same_bundle(host, TRB.merge_records_parts(tparts, mesh=one), "one-device mesh")


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded_tails"])
def test_build_records_from_st_waveforms_matches_jax(padded):
    st = make_fake_st_waveforms(n_events=40, wave_length=32, seed=2)
    st["timestamp"] = np.random.default_rng(2).integers(0, 10, 40) * 1000
    st["board"] = np.arange(40) % 2
    if padded:
        st["event_length"] = np.random.default_rng(3).integers(10, 33, 40)
    _same_bundle(JRB.build_records_from_st_waveforms(st, default_dt_ns=2),
                 TRB.build_records_from_st_waveforms(st, default_dt_ns=2), "st build")


def _vx_run(root: Path) -> Path:
    make_synthetic_vx2730_run(str(root), "r", n_channels=3, n_files_per_channel=2,
                              n_rows=40, n_samples=24, noise=5, seed=3)
    return root


def _v1725_run(root: Path, seed: int = 4, n_events: int = 30) -> Path:
    """Two boards with the same timestamps (ties across boards), noisy
    waves with pulses, variable lengths between the files."""
    rng = np.random.default_rng(seed)
    for board, n_samples in ((0, 40), (1, 52)):
        waves = {c: (900 + 100 * c + rng.integers(-4, 5, (n_events, n_samples))).astype(np.int16)
                 for c in (0, 3)}
        for c in waves:
            at = rng.integers(5, n_samples - 10, n_events)
            waves[c][np.arange(n_events), at] -= rng.integers(80, 300, n_events).astype(np.int16)
        ts = 1000 + np.arange(n_events, dtype=np.int64) * 700
        write_v1725_run(str(root), "r", n_events=n_events, n_samples=n_samples, board=board,
                        waves=waves, timestamps={0: ts, 3: ts + 2},
                        baselines={0: 900, 3: 1200}, n_files=2 if board else 1)
    return root


@pytest.mark.parametrize("decode", ["typed_native", "generic", "v1725_native", "v1725_python"])
def test_build_records_from_raw_files_matches_jax(tmp_path, monkeypatch, decode):
    adapter = "v1725" if decode.startswith("v1725") else "vx2730"
    root = (_v1725_run if adapter == "v1725" else _vx_run)(tmp_path / "daq")
    raw = get_raw_files("r", data_root=str(root), daq_adapter=adapter)
    if decode == "generic":  # the strict typed parser declines: generic decode
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "decode_csv_vx2730_typed", lambda *a, **k: None)
    if decode == "v1725_python":  # no native library: the Python reader
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "get_lib", lambda: None)
    kw = dict(adapter_name=adapter, default_dt_ns=2, epoch_ns=10**18)
    ref = JRB.build_records_from_raw_files(raw, **kw)
    got = TRB.build_records_from_raw_files(raw, **kw)
    assert len(got) == len(ref) > 0
    _same_bundle(ref, got, decode)
    if adapter == "v1725":  # timestamps tie across the boards
        ts = np.asarray(got.records["timestamp"])
        assert np.any(ts[1:] == ts[:-1])
        assert set(np.asarray(got.records["board"]).tolist()) == {0, 1}


@pytest.mark.parametrize("part_size", [None, 7, 25])
def test_streaming_builder_is_bit_identical(tmp_path, part_size):
    root = _vx_run(tmp_path / "daq")
    raw = get_raw_files("r", data_root=str(root), daq_adapter="vx2730")
    kw = dict(adapter_name="vx2730", default_dt_ns=2, part_size=part_size)
    whole = TRB.build_records_from_raw_files(raw, **kw)
    streamed = TRB.build_records_from_raw_files_streaming(raw, tmp_dir=str(tmp_path / "t"), **kw)
    _same_bundle(whole, streamed, "streaming")
    ref = JRB.build_records_from_raw_files_streaming(raw, tmp_dir=str(tmp_path / "j"), **kw)
    _same_bundle(ref, streamed, "streaming vs JAX")


@pytest.mark.parametrize("part_size,workers", [(7, 1), (25, 4), (1000, 4)])
def test_partitioning_invariant(tmp_path, part_size, workers):
    """Part size and channel workers are performance knobs: the bundle is
    the same (pid, the part index, aside), and the JAX package's for the
    same knobs."""
    root = _vx_run(tmp_path / "daq")
    raw = get_raw_files("r", data_root=str(root), daq_adapter="vx2730")
    one = TRB.build_records_from_raw_files(raw, adapter_name="vx2730", default_dt_ns=2)
    kw = dict(adapter_name="vx2730", default_dt_ns=2, part_size=part_size,
              channel_workers=workers)
    got = TRB.build_records_from_raw_files(raw, **kw)
    _same_bundle(one, got, "partitioned", skip=("pid",))
    _same_bundle(JRB.build_records_from_raw_files(raw, **kw), got, "partitioned vs JAX")


# ---------------------------------------------------------------------------
# RecordsView, TimeRangeQueryEngine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["whole_rows", "ragged", "shuffled_ids", "filtered"])
def test_records_view_matches_jax(layout):
    rng = np.random.default_rng(7)
    n, L = 60, 48
    lengths = np.full(n, L) if layout in ("whole_rows", "filtered") else rng.integers(1, 200, n)
    offsets = np.r_[0, np.cumsum(lengths)[:-1]].astype(np.int64)
    pool = rng.integers(0, 1 << 16, int(lengths.sum()), dtype=np.uint16)
    if layout == "filtered":
        pool = rng.normal(0, 300, pool.size).astype(np.float32)
    rid = rng.permutation(n) * 3 if layout == "shuffled_ids" else np.arange(n)
    cols = {"wave_offset": offsets, "event_length": lengths.astype(np.int32),
            "record_id": rid.astype(np.int64), "baseline": rng.normal(1000, 5, n),
            "polarity": rng.choice([-1, 0, 1], n).astype(np.int8)}
    ref, got = JView(JTable(cols), pool), TView(TTable(cols), pool)
    for r in rid[:5]:
        _same_array(ref.waves(r), got.waves(r), "waves", 0, 0)
        _same_array(ref.waves(r, window=(2, 9)), got.waves(r, window=(2, 9)), "window", 0, 0)
        _same_array(ref.signals(r), got.signals(r), "signals", 0, 0)
        _same_array(ref.signals(r, baseline=3.0, window=(1, 4)),
                    got.signals(r, baseline=3.0, window=(1, 4)), "signals window", 0, 0)
        assert ref.baseline(r) == got.baseline(r)
    if layout == "shuffled_ids":
        with pytest.raises(KeyError):
            got.waves(1)  # not an id: ids are multiples of 3
    rows = rng.permutation(n)[:17]
    for kw in ({}, {"dtype": np.float32}, {"pad_to": 300}, {"rows": rows},
               {"rows": rows, "dtype": np.float32}):
        for a, b in zip(ref.padded_wave_matrix(**kw), got.padded_wave_matrix(**kw)):
            _same_array(a, b, f"padded {kw}", 0, 0)
    for a, b in zip(ref.signal_matrix(), got.signal_matrix()):
        _same_array(a, b, "signal_matrix", 0, 0)
    # the torch gather = the host matrix, with every dtype the plugins ask
    for kw in ({}, {"dtype": np.float32}, {"pad_to": 256}, {"dtype": torch.int16}):
        waves_d, lens_d = got.padded_wave_matrix_device(device="cpu", **kw)
        host_kw = {k: (np.int16 if v is torch.int16 else v) for k, v in kw.items()}
        waves, lens = got.padded_wave_matrix(**host_kw)
        assert isinstance(waves_d, torch.Tensor) and waves_d.device.type == "cpu"
        _same_array(waves, waves_d.numpy(), f"device {kw}", 0, 0)
        _same_array(lens, lens_d.numpy(), "lengths", 0, 0)


class _Ctx:
    """The one method TimeRangeQueryEngine needs from a Context."""

    def __init__(self, data):
        self.data = data

    def get_data(self, run_id, name):
        return self.data


def test_time_range_query_matches_jax():
    rng = np.random.default_rng(9)
    n = 200
    cols = {"timestamp": np.sort(rng.integers(0, 10**6, n)).astype(np.int64),
            "time": np.sort(rng.integers(0, 10**6, n)).astype(np.int64),
            "channel": rng.integers(0, 3, n).astype(np.int16),
            "event_length": rng.integers(1, 50, n).astype(np.int32),
            "dt": np.full(n, 4, np.int32)}
    ref, got = JQuery(_Ctx(JTable(cols))), TQuery(_Ctx(TTable(cols)))
    for start, end in ((None, None), (1000, 400_000), (500_000, None), (None, 10)):
        for field in ("time", "timestamp"):
            a = ref.query_time_range("r", "records", start, end, time_field=field)
            b = got.query_time_range("r", "records", start, end, time_field=field)
            _same(a, b, f"query {start}..{end} {field}")
        a = ref.query_multi_channel_time_range("r", "records", start, end)
        b = got.query_multi_channel_time_range("r", "records", start, end)
        assert sorted(a) == sorted(b)
        for c in a:
            _same(a[c], b[c], f"channel {c}")
    assert got.cache_stats == ref.cache_stats


# ---------------------------------------------------------------------------
# the plugins, the profile, the examples
# ---------------------------------------------------------------------------


def _contexts(tmp_path, root, adapter, config):
    base = {"data_root": str(root), "daq_adapter": adapter, "show_progress": False}
    jctx = JContext(storage_dir=str(tmp_path / "jax"), config=dict(base))
    jctx.register(*jsets.tpu_default())
    tctx = TContext(storage_dir=str(tmp_path / "port"), config=dict(base, device="cpu"))
    tctx.register(*tsets.get_profile("cuda"))
    for ctx in (jctx, tctx):
        ctx.set_config(config)
    return jctx, tctx


def _pallas_bw(monkeypatch):
    """The JAX package's Butterworth path through its Pallas kernel in
    interpret mode (its TPU path; the CPU scan sits 1e-4 of the wave scale
    from scipy at route B's design)."""
    from waveformanalysis_tpu.ops import filtering as JF
    from waveformanalysis_tpu.ops.filter_pallas import sosfiltfilt_pallas

    def pallas(waves, sos, dtype=np.float32):
        if np.shape(waves)[-1] <= JF.sosfiltfilt_padlen(sos):  # the pass-through guard
            return np.array(waves, dtype=dtype)
        return sosfiltfilt_pallas(waves, sos, dtype=dtype, interpret=True)

    monkeypatch.setattr(JF, "sosfiltfilt_device", pallas)


@pytest.mark.parametrize("adapter", ["vx2730", "v1725"])
@pytest.mark.parametrize("filt", ["SG", "BW"])
def test_records_plugins_match_jax(tmp_path, monkeypatch, adapter, filt):
    """records and wave_pool exactly; wave_pool_filtered per (board,
    channel) group at each record's true length (the V1725 run's lengths
    differ between boards): SG within rtol 1e-5 of the JAX package's, BW
    within 5e-4 of the largest |value| of the JAX package's Pallas kernel's
    pool; on the scipy engine, the JAX plugin's within rtol 1e-6."""
    root = (_v1725_run if adapter == "v1725" else _vx_run)(tmp_path / "daq")
    cfg = {"channel_metadata": {"defaults": {"polarity": "positive"}}}
    if filt == "BW":
        cfg["wave_pool_filtered"] = dict(BW)
        _pallas_bw(monkeypatch)
    jctx, tctx = _contexts(tmp_path, root, adapter, cfg)
    for name in ("records", "wave_pool"):
        _same(jctx.get_data("r", name), tctx.get_data("r", name), name, 0, 0)
    assert set(np.asarray(tctx.get_data("r", "records")["polarity"]).tolist()) == {1}
    got = tctx.get_data("r", "wave_pool_filtered")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    ref = jctx.get_data("r", "wave_pool_filtered")
    if filt == "SG":
        _same(ref, got, "SG pool", rtol=1e-5, atol=0)
    else:
        assert ref.dtype == np.float32 and ref.shape == got.shape
        assert _rel(ref, got) < 5e-4
    # the engine is untracked (no lineage change): fresh Contexts
    scipy_cfg = dict(cfg, wave_pool_filtered=dict(cfg.get("wave_pool_filtered", {}),
                                                  engine="scipy"))
    jsci, tsci = _contexts(tmp_path / "scipy", root, adapter, scipy_cfg)
    _same(jsci.get_data("r", "wave_pool_filtered"), tsci.get_data("r", "wave_pool_filtered"),
          "scipy engine", rtol=1e-6, atol=0)
    for ctx in (jctx, tctx, jsci, tsci):
        ctx.flush_saves()


@pytest.mark.parametrize("members", [["hit_threshold"], ["basic_features", "hit_threshold"]],
                         ids=["alone", "fused"])
def test_threshold_hits_of_a_negative_record_stay_inside_it(tmp_path, members):
    """Repair: on the records source each record's row is padded with zeros
    past its length, and hit_threshold formed its signal over the whole row,
    so on a negative channel the padding read as +baseline. A run that
    reached the record's end took that padding into its extended segment:
    height the baseline, integral the baseline more. The signal past a
    row's length is now left out, and every hit is the record's own (the
    threshold runs of each record alone, at its true length)."""
    from waveformanalysis_tpu_torch.ops.hits import threshold_hits_batch

    n_events, length, baseline = 6, 40, 900
    waves = np.full((n_events, length), baseline, np.int16)
    waves[:, 10:13] -= 150
    waves[:, -3:] -= 200  # a negative pulse that runs to the record's end
    write_v1725_run(str(tmp_path / "daq"), "r", n_events=n_events, n_samples=length,
                    waves={0: waves}, timestamps={0: 1000 + 700 * np.arange(n_events)},
                    baselines={0: baseline})
    ctx = TContext(storage_dir=str(tmp_path / "port"),
                   config={"data_root": str(tmp_path / "daq"), "daq_adapter": "v1725",
                           "show_progress": False, "device": "cpu"})
    ctx.register(*tsets.get_profile("cuda"))
    ctx.set_config({"channel_metadata": {"defaults": {"polarity": "negative"}},
                    "hit_threshold": {"wave_source": "records", "threshold": 10.0},
                    "basic_features": {"wave_source": "records"}})
    got = ctx.get_data("r", members)["hit_threshold"]
    signal = torch.from_numpy(baseline - waves.astype(np.float32))  # each record alone
    runs = threshold_hits_batch(signal, torch.full((n_events,), 10.0),
                                torch.full((n_events,), length, dtype=torch.int32))
    valid = runs["valid"].numpy()
    for k in ("position", "height", "integral"):
        np.testing.assert_array_equal(np.asarray(got[k]), runs[k].numpy()[valid], err_msg=k)
    assert np.asarray(got["height"]).max() == 200.0
    ctx.flush_saves()


@pytest.mark.parametrize("cell", ["v1725_records.tables", "vx2730_records.tables"])
def test_records_counters_count_batches_cells_and_samples(tmp_path, cell):
    """The records layer's counts over one window of each records cell at
    512 records: ``wave_pool_filtered.batches`` one a (board, channel) and
    length; ``records.pad_cells`` rows times width and ``records.pad_samples``
    the rows' true lengths, for the two padded matrices a run (int16 for the
    fused members, float32 for hit); ``records.pad_rows`` and
    ``records.pad_bytes`` as they were (the VX2730 cell: 1,024 rows, 512
    wide, 6 bytes a cell)."""
    from portbench import harness
    from portbench.trace import Recorder
    from waveformanalysis_tpu_torch.foundation import profiler

    spec = harness.cell(harness.load_json(Path(harness.ROOT) / "BENCHMARK.json"), cell)
    spec.workload["events"] = n = 512
    kind = harness.load_named("kinds", spec.workload["kind"])
    d = kind.Driver(spec.config, spec.workload, 2**31 + 977, torch.device("cpu"), tmp_path)
    try:
        d.setup()
        with Recorder(trace=False, cuda=False) as rec:
            d.window(0.05, rec)
        records = d.ctx.get_data(d.runs[0], "records")
    finally:
        d.close()
    counts = {}
    for c in profiler.counts(rec.t0, rec.t1):
        counts[c.key] = counts.get(c.key, 0) + c.n
    runs = len(d.runs)
    lengths = np.asarray(records["event_length"], np.int64)
    pairs = set(zip(np.asarray(records["board"]).tolist(),
                    np.asarray(records["channel"]).tolist(), lengths.tolist()))
    width = 128 * -(-int(lengths.max()) // 128)
    assert counts["wave_pool_filtered.batches"] == runs * len(pairs)
    assert counts["records.pad_cells"] == runs * 2 * n * width
    assert counts["records.pad_samples"] == runs * 2 * int(lengths.sum())
    assert counts["records.pad_rows"] == runs * 2 * n
    assert counts["records.pad_bytes"] == runs * n * width * (2 + 4)
    if cell.startswith("vx2730"):
        assert len(pairs) == 2 and width == 512
    else:
        assert len(pairs) > 16 * 20 and width == 1024


def test_examples_on_cpu(capsys):
    from waveformanalysis_tpu_torch.examples import records_pipeline_example as rp
    from waveformanalysis_tpu_torch.examples import records_view_example as rv

    assert rp.main(["--device", "cpu"]) == {"records": 256, "pool": 256 * 48, "df": 256}
    out = rv.main(["--device", "cpu"])
    assert out["records"] == 128 and out["same"] and out["padded"] == (128, 128)
    assert out["subset"] > 0
    assert "device: cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the records route (chip_smoke.py's main path 9) against the JAX route
# ---------------------------------------------------------------------------


N_REF = chip_smoke.N_INGEST_REF


@pytest.fixture(scope="module")
def route_runs(tmp_path_factory):
    """chip_smoke's N_INGEST_REF run (write_ingest_run, seed 0) through the
    JAX package's records route A and B; route B's filter is the Pallas
    kernel in interpret mode (the JAX package's CPU scan sits 1e-4 of the
    wave scale from scipy at this design)."""
    root = tmp_path_factory.mktemp("records_route")
    daq = str(root / "DAQ")
    chip_smoke.write_ingest_run(daq, "ref", N_REF, seed=0)
    out = {"daq": daq, "root": root}
    with pytest.MonkeyPatch.context() as mp:
        _pallas_bw(mp)
        for route in ("A", "B"):
            ctx = chip_smoke.records_context(JContext, jsets.tpu_default(), daq,
                                             str(root / f"jax{route}"), route)
            ctx.get_data("ref", chip_smoke.RECORDS_REQUEST)
            out[route] = ctx
    yield out
    for route in ("A", "B"):
        out[route].flush_saves()


def _port_route(tmp_path, daq, route):
    ctx = chip_smoke.records_context(TContext, tsets.get_profile("cuda"), daq,
                                     str(tmp_path / f"port{route}"), route, "cpu")
    res = ctx.get_data("ref", chip_smoke.RECORDS_REQUEST)
    assert list(res) == chip_smoke.RECORDS_REQUEST
    return ctx


@pytest.mark.parametrize("route", ["A", "B"])
def test_records_route_matches_jax(tmp_path, route_runs, route):
    """The port's CPU Context on the records route: the JAX plan (route A:
    hit alone, on the SG pool; route B: one fused program), chip_smoke's
    REF_RECORDS_4096 = the JAX counts = the port's, every table of the
    request equal to the JAX route's (route B given the port's filtered
    pool, within 5e-4 of the largest |value| of the Pallas kernel's)."""
    jctx = route_runs[route]
    ctx = _port_route(tmp_path, route_runs["daq"], route)
    assert chip_smoke.records_standalone(ctx) == chip_smoke.RECORDS_STANDALONE[route]
    assert chip_smoke.records_standalone(jctx) == chip_smoke.RECORDS_STANDALONE[route]
    assert "fusion.wave_chain.compute" in ctx.profiler.stats()
    counts = chip_smoke.records_counts(ctx, "ref")
    assert counts == chip_smoke.records_counts(jctx, "ref") == chip_smoke.REF_RECORDS_4096[route]
    pool = ctx.get_data("ref", "wave_pool_filtered")
    if route == "A":
        _same(jctx.get_data("ref", "wave_pool_filtered"), pool, "SG pool", rtol=1e-5, atol=0)
    else:
        assert _rel(jctx.get_data("ref", "wave_pool_filtered"), pool) < 5e-4
        jctx = chip_smoke.records_context(JContext, jsets.tpu_default(), route_runs["daq"],
                                          str(tmp_path / "jaxB_shared"), route)
        jctx.inject_data("ref", "wave_pool_filtered", pool)
        jctx.get_data("ref", chip_smoke.RECORDS_REQUEST)
    for name in chip_smoke.RECORDS_COMPARED:
        _same(jctx.get_data("ref", name), ctx.get_data("ref", name), f"route {route} {name}")
    for c in (ctx, jctx):
        c.flush_saves()


def test_chip_smoke_records_constants():
    """The routes as documented: route B sets the Butterworth design and
    use_filtered on every member that has the option and reads waves."""
    assert chip_smoke.RECORDS_ROUTES["A"] == {"wave_source": "records"}
    b = chip_smoke.RECORDS_ROUTES["B"]
    assert b["wave_pool_filtered"] == {"filter_type": "BW", "filter_order": 4,
                                       "lowcut": 0.002, "highcut": 0.1, "fs": 0.5}
    with_option = {p.provides for p in tsets.cuda_default()
                   if "use_filtered" in p.options and p.provides != "waveform_width"}
    assert {m for m, v in b.items() if isinstance(v, dict) and v.get("use_filtered")} | \
        {"hit"} == with_option  # hit's default is use_filtered=True


def test_integral_width_prefix_sums_are_the_jax_association():
    """Repair: the port's integral quantile width summed its float32 prefix
    sums with ``torch.cumsum``, whose association differs from the JAX
    package's (XLA's 16-sample blocks on the CPU), so a prefix sum within a
    rounding step of the 90 % target moved t_high by a sample (one of
    bench.py's 20,000 waves with a fractional baseline; one of the records
    route's 4,096). The prefix sums are now the JAX package's bit for bit,
    and so are the widths."""
    import jax
    import jax.numpy as jnp
    from bench import make_batch
    from waveformanalysis_tpu.ops.widths import integral_quantile_width as jwidth
    from waveformanalysis_tpu_torch.ops.widths import cumsum_xla, integral_quantile_width

    rng = np.random.default_rng(0)
    for L in (1, 16, 17, 250, 256, 5000):
        x = rng.normal(0, 100, (32, L)).astype(np.float32).clip(min=0)
        np.testing.assert_array_equal(cumsum_xla(torch.from_numpy(x)).numpy(),
                                      np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(x)))
    w = make_batch(20000, 256, seed=3).astype(np.float32) - 1000.3
    lengths = np.full(len(w), 256, np.int32)
    ref = jax.jit(jwidth)(w, lengths)
    got = integral_quantile_width(torch.from_numpy(w), torch.from_numpy(lengths))
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
