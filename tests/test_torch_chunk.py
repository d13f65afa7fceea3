"""The port's chunk time algebra (``dtypes/chunk.py``) against the JAX
package's, on the same inputs.

Mirrors tests/test_chunk.py and, with fewer examples, the hypothesis laws of
tests/test_chunk_properties.py: every case runs both modules on the same
structured arrays or on a Table of each package built from the same numpy
columns, and holds the port to JAX's result exactly (the algebra is integer
and index work on the host; float columns are carried, not computed). The
port's own additions: a Table with ``torch.Tensor`` columns on the CPU is
read through ``device.to_numpy`` and keeps its tensor columns tensors
through selection, sorting and concatenation.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from waveformanalysis_tpu.dtypes import chunk as JC
from waveformanalysis_tpu.dtypes.table import Table as JTable
from waveformanalysis_tpu_torch.dtypes import chunk as C
from waveformanalysis_tpu_torch.dtypes.table import Table

EXAMPLES = 15


def make_records(times, dt=2, length=10):
    n = len(times)
    arr = np.zeros(
        n,
        dtype=[("time", "i8"), ("dt", "i4"), ("length", "i4"), ("channel", "i2")],
    )
    arr["time"] = times
    arr["dt"] = dt
    arr["length"] = length
    return arr


def _tables(cols):
    """(port Table, JAX Table) over copies of the same numpy columns."""
    return (Table({k: np.array(v) for k, v in cols.items()}),
            JTable({k: np.array(v) for k, v in cols.items()}))


def _timed(times):
    times = np.asarray(sorted(times), dtype=np.int64)
    return _tables({"time": times, "value": np.arange(len(times), dtype=np.int64)})


def _host(data):
    """A structured array or Table of either package as {field: ndarray}."""
    if hasattr(data, "field_names"):
        return {k: np.asarray(torch.as_tensor(v).numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in data.columns.items()}
    return {k: np.asarray(data[k]) for k in data.dtype.names}


def _same(port, ref):
    a, b = _host(port), _host(ref)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _same_stream(port, ref):
    port, ref = list(port), list(ref)
    assert len(port) == len(ref)
    for (pd, pi), (rd, ri) in zip(port, ref):
        assert vars(pi) == vars(ri)
        _same(pd, rd)


class TestEndtime:
    @pytest.mark.parametrize("kw", [{}, {"dt": 5}])
    def test_compute_endtime(self, kw):
        arr = make_records([0, 100, 200], dt=2, length=10)
        et = C.compute_endtime(arr, **kw)
        np.testing.assert_array_equal(et, JC.compute_endtime(arr, **kw))
        np.testing.assert_array_equal(et, [20, 120, 220] if not kw else [50, 150, 250])

    def test_time_field_fallback_to_timestamp(self):
        arr = np.zeros(2, dtype=[("timestamp", "i8"), ("dt", "i4"), ("event_length", "i4")])
        arr["timestamp"] = [10, 20]
        arr["dt"] = 1
        arr["event_length"] = 5
        np.testing.assert_array_equal(C.compute_endtime(arr), [15, 25])
        np.testing.assert_array_equal(C.compute_endtime(arr), JC.compute_endtime(arr))

    def test_get_endtime_instantaneous_without_length(self):
        arr = np.zeros(2, dtype=[("time", "i8")])
        arr["time"] = [5, 9]
        np.testing.assert_array_equal(C.get_endtime(arr), JC.get_endtime(arr))

    def test_add_and_validate_endtime_field(self):
        arr = make_records([0, 50])
        out = C.add_endtime_field(arr)
        _same(out, JC.add_endtime_field(arr))
        assert C.validate_endtime(out).is_valid
        out["endtime"][1] += 3
        res, ref = C.validate_endtime(out), JC.validate_endtime(out)
        assert (res.is_valid, res.errors, res.stats) == (ref.is_valid, ref.errors, ref.stats)

    def test_works_on_table(self):
        pt, jt = _tables({
            "time": np.array([0, 100], dtype=np.int64),
            "dt": np.array([2, 2], dtype=np.int32),
            "length": np.array([10, 10], dtype=np.int32),
        })
        np.testing.assert_array_equal(C.compute_endtime(pt), JC.compute_endtime(jt))
        _same(C.add_endtime_field(pt), JC.add_endtime_field(jt))


class TestChecks:
    @pytest.mark.parametrize("times,strict", [([0, 1, 2], False), ([0, 2, 1], False),
                                              ([0, 0, 1], False), ([0, 0, 1], True)])
    def test_monotonic(self, times, strict):
        arr = make_records(times)
        res, ref = C.check_monotonic(arr, strict=strict), JC.check_monotonic(arr, strict=strict)
        assert (res.is_valid, res.errors, res.stats) == (ref.is_valid, ref.errors, ref.stats)

    @pytest.mark.parametrize("times", [[0, 100], [0, 10]])
    def test_overlap(self, times):
        arr = make_records(times, dt=2, length=10)
        res, ref = C.check_overlap(arr), JC.check_overlap(arr)
        assert (res.is_valid, res.errors, res.stats) == (ref.is_valid, ref.errors, ref.stats)

    @pytest.mark.parametrize("start,end", [(0, 100), (20, 100), (0, 55)])
    def test_chunk_boundaries(self, start, end):
        arr = make_records([10, 50], dt=1, length=10)
        res, ref = (C.check_chunk_boundaries(arr, start, end),
                    JC.check_chunk_boundaries(arr, start, end))
        assert (res.is_valid, res.errors, res.stats) == (ref.is_valid, ref.errors, ref.stats)


class TestSelection:
    @pytest.mark.parametrize("strict", [False, True])
    def test_select_intersect_vs_strict(self, strict):
        arr = make_records([0, 100, 200], dt=2, length=10)  # ends 20,120,220
        out = C.select_time_range(arr, start=15, end=205, strict=strict)
        _same(out, JC.select_time_range(arr, start=15, end=205, strict=strict))
        np.testing.assert_array_equal(out["time"], [100] if strict else [0, 100, 200])

    @pytest.mark.parametrize("start,end", [(10, 110), (95, 130), (None, 105), (5, None)])
    def test_clip(self, start, end):
        arr = make_records([0, 100], dt=2, length=10)
        _same(C.clip_to_time_range(arr, start=start, end=end),
              JC.clip_to_time_range(arr, start=start, end=end))
        pt, jt = _tables({k: arr[k] for k in arr.dtype.names})
        _same(C.clip_to_time_range(pt, start=start, end=end),
              JC.clip_to_time_range(jt, start=start, end=end))

    def test_select_time_range_keeps_point_rows_on_window_start(self):
        pt, jt = _tables({"time": np.array([100, 200, 300], dtype=np.int64),
                          "value": np.arange(3.0)})
        out = C.select_time_range(pt, start=200, end=400)
        _same(out, JC.select_time_range(jt, start=200, end=400))
        np.testing.assert_array_equal(out["time"], [200, 300])


class TestSplitting:
    def test_split_by_count(self):
        arr = make_records(np.arange(10) * 100)
        _same_stream(C.split_by_count(arr, chunk_size=4), JC.split_by_count(arr, chunk_size=4))

    def test_split_by_breaks(self):
        times = [0, 100, 200, 10_000_000_000_000_000, 10_000_000_000_000_100]
        arr = make_records(times, dt=1, length=10)
        _same_stream(C.split_by_breaks(arr, break_threshold_ps=1_000_000),
                     JC.split_by_breaks(arr, break_threshold_ps=1_000_000))

    def test_split_by_time(self):
        arr = make_records([0, 100, 200, 300], dt=1, length=10)
        _same_stream(C.split_by_time(arr, chunk_duration_ns=200),
                     JC.split_by_time(arr, chunk_duration_ns=200))

    def test_find_break_indices(self):
        arr = make_records([0, 100, 5_000_000_000_000_000], dt=1, length=10)
        idx = C.find_break_indices(arr, break_threshold_ps=1_000)
        np.testing.assert_array_equal(idx, JC.find_break_indices(arr, break_threshold_ps=1_000))
        np.testing.assert_array_equal(idx, [0, 2])


class TestMergeRechunk:
    def test_merge_chunks_sorts(self):
        parts = [make_records([200, 300]), make_records([0, 100])]
        _same(C.merge_chunks(parts), JC.merge_chunks(parts))

    def test_rechunk_targets_size(self):
        src = [make_records(np.arange(3) * 1000 + i * 100000) for i in range(5)]
        _same_stream(C.rechunk(((d, C.ChunkInfo(n_records=len(d))) for d in src), 6),
                     JC.rechunk(((d, JC.ChunkInfo(n_records=len(d))) for d in src), 6))

    def test_rechunk_to_boundaries(self):
        arr = make_records([0, 100, 200, 300], dt=1, length=10)
        _same_stream(C.rechunk_to_boundaries(iter([(arr, C.ChunkInfo())]), np.array([150])),
                     JC.rechunk_to_boundaries(iter([(arr, JC.ChunkInfo())]), np.array([150])))

    @pytest.mark.parametrize("bounds", [((0, 100), (100, 200)), ((0, 150), (100, 200)),
                                        ((0, 100), (300, 400))])
    def test_continuity_check(self, bounds):
        def infos(mod):
            return [(None, mod.ChunkInfo(start_time=s, end_time=e)) for s, e in bounds]

        res, ref = C.check_chunk_continuity(infos(C)), JC.check_chunk_continuity(infos(JC))
        assert (res.is_valid, res.errors, res.stats) == (ref.is_valid, ref.errors, ref.stats)


class TestChunkObject:
    def test_boundary_validation(self):
        arr = make_records([10, 50], dt=1, length=10)
        ch = C.Chunk(arr, start=0, end=100, run_id="r")
        assert (len(ch), ch.duration, ch.nbytes) == (2, 100, JC.Chunk(arr, 0, 100).nbytes)
        for start, end in ((20, 100), (0, 55)):
            with pytest.raises(ValueError):
                C.Chunk(arr, start=start, end=end)
            with pytest.raises(ValueError):
                JC.Chunk(arr, start=start, end=end)

    def test_split(self):
        arr = make_records([10, 50], dt=1, length=10)
        for p, j in zip(C.Chunk(arr, start=0, end=100).split(40),
                        JC.Chunk(arr, start=0, end=100).split(40)):
            assert (p.start, p.end, len(p)) == (j.start, j.end, len(j))
            _same(p.data, j.data)


class TestTensorColumns:
    """A port Table with torch.Tensor columns (the card's layout, here on
    the CPU): the helpers read it on the host and keep its tensors."""

    def _pair(self):
        times = np.array([300, 100, 200, 500, 400], dtype=np.int64)
        cols = {"time": times, "dt": np.full(5, 2, np.int32),
                "length": np.full(5, 10, np.int32), "value": np.arange(5.0)}
        tensor = Table({k: torch.from_numpy(v.copy()) if k != "value" else v.copy()
                        for k, v in cols.items()})
        return tensor, JTable(cols)

    def test_algebra_reads_tensor_columns(self):
        tt, jt = self._pair()
        np.testing.assert_array_equal(C.get_endtime(tt), JC.get_endtime(jt))
        assert C.is_sorted_by_time(tt) is JC.is_sorted_by_time(jt) is False
        ordered = C.sort_by_time(tt)
        assert isinstance(ordered["time"], torch.Tensor)
        assert isinstance(ordered["value"], np.ndarray)
        _same(ordered, JC.sort_by_time(jt))
        sel = C.select_time_range(ordered, start=150, end=450)
        assert isinstance(sel["time"], torch.Tensor)
        _same(sel, JC.select_time_range(JC.sort_by_time(jt), start=150, end=450))
        _same(C.clip_to_time_range(ordered, start=105, end=405),
              JC.clip_to_time_range(JC.sort_by_time(jt), start=105, end=405))

    def test_concat_and_chunk_keep_tensors(self):
        tt, jt = self._pair()
        ordered = C.sort_by_time(tt)
        parts = [d for d, _ in C.split_by_count(ordered, 2)]
        merged = C.merge_chunks(parts)
        assert isinstance(merged["time"], torch.Tensor)
        _same(merged, JC.merge_chunks([d for d, _ in JC.split_by_count(JC.sort_by_time(jt), 2)]))
        ch = C.Chunk(ordered, start=100, end=600)
        left, right = ch.split(300)
        assert isinstance(left.data["time"], torch.Tensor) and len(left) + len(right) == 5
        assert ch.nbytes == JC.Chunk(JC.sort_by_time(jt), start=100, end=600).nbytes


times_strategy = st.lists(st.integers(min_value=0, max_value=10**12), min_size=1, max_size=200)


class TestProperties:
    @settings(max_examples=EXAMPLES, deadline=None)
    @given(times=times_strategy, size=st.integers(1, 50))
    def test_split_by_count_and_rechunk(self, times, size):
        pt, jt = _timed(times)
        _same_stream(C.split_by_count(pt, size), JC.split_by_count(jt, size))
        merged = C.concat_sorted([d for d, _ in C.rechunk(C.split_by_count(pt, max(1, size // 2)),
                                                          target_size=size)])
        _same(merged, pt)

    @settings(max_examples=EXAMPLES, deadline=None)
    @given(times=times_strategy,
           cuts=st.tuples(st.integers(0, 10**12), st.integers(0, 10**12),
                          st.integers(0, 10**12)))
    def test_select_composes(self, times, cuts):
        a, b, c = sorted(cuts)
        pt, jt = _timed(times)
        direct = C.select_time_range(pt, start=a, end=c, strict=False)
        _same(direct, JC.select_time_range(jt, start=a, end=c, strict=False))
        combined = C._concat([C.select_time_range(pt, start=a, end=b),
                              C.select_time_range(pt, start=b, end=c)])
        np.testing.assert_array_equal(direct["time"], combined["time"])

    @settings(max_examples=EXAMPLES, deadline=None)
    @given(times=st.lists(st.integers(0, 10**10), min_size=2, max_size=120),
           threshold=st.integers(1, 10**9))
    def test_breaks_partition_at_gaps(self, times, threshold):
        pt, jt = _timed(times)
        _same_stream(C.split_by_breaks(pt, break_threshold_ps=threshold),
                     JC.split_by_breaks(jt, break_threshold_ps=threshold))

    @settings(max_examples=EXAMPLES, deadline=None)
    @given(times=times_strategy, length=st.integers(1, 1000), dt=st.integers(1, 16))
    def test_endtime_and_sort(self, times, length, dt):
        n = len(times)
        cols = {"time": np.asarray(times, np.int64), "length": np.full(n, length, np.int32),
                "dt": np.full(n, dt, np.int32)}
        pt, jt = _tables(cols)
        np.testing.assert_array_equal(C.get_endtime(pt), JC.get_endtime(jt))
        _same(C.sort_by_time(pt), JC.sort_by_time(jt))
        res, ref = C.check_overlap(C.sort_by_time(pt)), JC.check_overlap(JC.sort_by_time(jt))
        assert (res.is_valid, res.stats) == (ref.is_valid, ref.stats)


def test_strict_end_boundary():
    pt, jt = _timed([10, 20])
    for strict, want in ((True, [10, 20]), (False, [10])):
        out = C.select_time_range(pt, start=0, end=20, strict=strict)
        _same(out, JC.select_time_range(jt, start=0, end=20, strict=strict))
        np.testing.assert_array_equal(out["time"], want)


def test_sample_time_conversions():
    assert (C.time_to_samples(105, 2), C.samples_to_time(7, 4)) == (
        JC.time_to_samples(105, 2), JC.samples_to_time(7, 4)) == (52, 28)
