"""The port's tail of the path from DAQ files, on the CPU, against the JAX package.

``df``, ``df_events``, ``events``, ``event_hits``, ``hit_grouped`` and
``df_paired`` (both of its event sources) from the same VX2730 and V1725
files through each package's CPU Context under its default profile, with
the port's grouping on the host and on the device backend (torch ops, here
on the CPU). Then the grouping ops alone: the port's torch backend against
the JAX package's device backend (XLA on the CPU, under x64) and against
the host backend, on ties, a zero window, empty tables and empty segments,
with JAX's output dtypes. Also: chip_smoke.py's 4,096-waveform constants,
recomputed with JAX, and the port's tutorial on the CPU.

Tolerance: DataFrames column by column with their dtypes
(``pandas.testing``), integer and label columns exact, float32 within atol
1e-3 / rtol 1e-4; Table columns the same way.
"""

from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from utils import make_v1725_event
from waveformanalysis_tpu.context.context import Context as JContext
from waveformanalysis_tpu.ops import grouping as JG
from waveformanalysis_tpu.ops import grouping_device as JGD
from waveformanalysis_tpu.plugins import plugin_sets as jsets
from waveformanalysis_tpu.testing.fixtures import make_synthetic_vx2730_run
from waveformanalysis_tpu_torch.context.context import Context as TContext
from waveformanalysis_tpu_torch.ops import grouping as TG
from waveformanalysis_tpu_torch.ops import grouping_device as TGD
from waveformanalysis_tpu_torch.plugins import plugin_sets as tsets

ATOL, RTOL = 1e-3, 1e-4
CPU = "cpu"
TABLES = ("df", "df_events", "events", "event_hits", "hit_grouped", "df_paired")
GROUPING_PLUGINS = ("df_events", "events", "event_hits", "hit_grouped", "df_paired")
# (adapter, run name, channel 1's stagger in ps): paired within df_events'
# 100 ns window, or never paired (one-hit events, NaN-filled df_paired)
RUNS = {"vx_paired": ("vx2730", "run_vx", 20_000),
        "vx_apart": ("vx2730", "run_vx", 150_000),
        "v1725": ("v1725", "run_bin", None)}


def _same_cell(a, b, tag):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (tag, a.dtype, b.dtype)
    if np.issubdtype(a.dtype, np.floating):
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL, err_msg=tag)
    else:
        np.testing.assert_array_equal(b, a, err_msg=tag)


def _same_frame(ref: pd.DataFrame, out: pd.DataFrame, tag: str) -> None:
    """Column by column with dtypes: numbers through pandas.testing (floats
    within the tolerance, the rest exact), per-event array cells one by one."""
    assert list(out.columns) == list(ref.columns), tag
    assert list(out.dtypes) == list(ref.dtypes), (tag, list(ref.dtypes), list(out.dtypes))
    assert len(out) == len(ref), tag
    pd.testing.assert_index_equal(out.index, ref.index)
    for col in ref.columns:
        a, b = ref[col], out[col]
        if a.dtype == object:
            for i, (x, y) in enumerate(zip(a, b)):
                _same_cell(x, y, f"{tag}.{col}[{i}]")
        elif np.issubdtype(a.dtype, np.floating):
            pd.testing.assert_series_equal(b, a, check_exact=False, atol=ATOL, rtol=RTOL)
        else:
            pd.testing.assert_series_equal(b, a, check_exact=True)


def _same(ref, out, tag):
    if isinstance(ref, pd.DataFrame):
        _same_frame(ref, out, tag)
        return
    assert out.field_names == ref.field_names and len(out) == len(ref), tag
    for f in ref.field_names:
        _same_cell(ref[f], out[f], f"{tag}.{f}")


def _write_v1725(root: Path) -> None:
    """Seeded two-channel V1725 events; channel 2's timestamps 3 samples
    after channel 0's, a few events without channel 2."""
    rng = np.random.default_rng(8)
    raw = root / "run_bin" / "RAW"
    raw.mkdir(parents=True, exist_ok=True)
    blob = b""
    for i in range(40):
        waves = {}
        for ch in ((0, 2) if i % 7 else (0,)):
            w = 1000 + rng.integers(-4, 5, 64)
            at = int(rng.integers(10, 50))
            w[at:at + int(rng.integers(2, 9))] -= int(rng.integers(80, 300))
            waves[ch] = w.astype(np.int16)
        ts = 1000 + i * 900
        blob += make_v1725_event(waves, timestamps={0: ts, 2: ts + 3},
                                 baselines={0: 1000, 2: 1000})
    (raw / "run_bin_raw_b0_seg0.bin").write_bytes(blob)


def _context(cls, profile, root, adapter, path, device=None):
    config = {"data_root": str(root), "daq_adapter": adapter, "n_channels": 2,
              "show_progress": False}
    if device is not None:
        config["device"] = device
    ctx = cls(storage_dir=str(path), config=config)
    ctx.register(*profile)
    return ctx


def _event_tables(ctx, run):
    out = {m: ctx.get_data(run, m) for m in TABLES}
    ctx.set_config({"df_paired": {"events_source": "columnar"}})
    out["df_paired_columnar"] = ctx.get_data(run, "df_paired")
    ctx.flush_saves()
    return out


@pytest.fixture(scope="module")
def jax_tables(tmp_path_factory):
    """The JAX package's event tables (host grouping) for each run in RUNS."""
    out = {}
    for key, (adapter, run, offset) in RUNS.items():
        root = tmp_path_factory.mktemp(key) / "DAQ"
        if adapter == "vx2730":
            make_synthetic_vx2730_run(str(root), run, n_channels=2, n_files_per_channel=2,
                                      n_rows=48, n_samples=96, noise=5, seed=5,
                                      channel_offset_ps=offset)
        else:
            _write_v1725(root)
        ctx = _context(JContext, jsets.tpu_default(), root, adapter, root.parent / "jax")
        ctx.set_config({m: {"grouping_backend": "host"} for m in GROUPING_PLUGINS})
        out[key] = (root, _event_tables(ctx, run))
    return out


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("case", sorted(RUNS))
def test_event_tables_from_files_match_jax(tmp_path, jax_tables, case, backend):
    adapter, run, _ = RUNS[case]
    root, ref = jax_tables[case]
    ctx = _context(TContext, tsets.get_profile("cuda"), root, adapter, tmp_path, device=CPU)
    ctx.set_config({m: {"grouping_backend": backend} for m in GROUPING_PLUGINS})
    got = _event_tables(ctx, run)
    assert len(ref["df_events"]) > 0 and len(ref["hit_grouped"]) > 0
    for name in ref:
        _same(ref[name], got[name], f"{case}/{backend}/{name}")
    paired = ref["df_paired"]
    if case == "vx_apart":  # one-hit events: channel 1's columns are NaN, f8
        assert paired["area_ch7"].dtype == np.float64 and paired["area_ch7"].isna().all()
    else:
        assert paired["area_ch7"].notna().any()


# ---------------------------------------------------------------------------
# grouping ops: the port's torch backend against JAX's device backend
# ---------------------------------------------------------------------------


def _timestamps(rng, n, tie_share=0.3, gap=300_000):
    gaps = rng.integers(0, gap, n)
    gaps[rng.random(n) < tie_share] = 0  # ties
    return np.sort(10**15 + np.cumsum(gaps)).astype(np.int64)


ID_CASES = {
    "ties": (lambda rng: _timestamps(rng, 1500), 250_000.0),
    "window_0": (lambda rng: _timestamps(rng, 700, tie_share=0.5), 0.0),
    "fractional": (lambda rng: _timestamps(rng, 900), 123_456.7),
    "all_ties": (lambda rng: np.full(64, 5 * 10**14, np.int64), 10.0),
    "one": (lambda rng: np.array([7], np.int64), 100.0),
    "empty": (lambda rng: np.zeros(0, np.int64), 100.0),
}


@pytest.mark.parametrize("case", sorted(ID_CASES))
def test_anchor_event_ids_match_jax_and_host(case):
    make, window = ID_CASES[case]
    ts = make(np.random.default_rng(3))
    out = TGD.anchor_window_event_ids(ts, window, device=CPU)
    ref = np.asarray(JGD.anchor_window_event_ids(ts, window))
    assert out.dtype == torch.int32 and ref.dtype == np.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(TGD.boundaries_from_event_ids(out),
                                  TG.anchor_window_boundaries(ts, window))
    np.testing.assert_array_equal(TGD.boundaries_from_event_ids(out),
                                  JGD.boundaries_from_event_ids(ref))


@pytest.mark.parametrize("case", ["ties", "gap_0", "nested", "empty"])
def test_chained_gap_ids_match_jax_and_host(case):
    rng = np.random.default_rng(4)
    n = 0 if case == "empty" else 800
    starts = np.sort(rng.integers(0, 10**7, n)).astype(np.float64)
    if case == "ties":
        starts = np.repeat(starts[: n // 4], 4)
    ends = starts + rng.uniform(0, 5e4 if case != "nested" else 5e5, n)
    gap = 0.0 if case == "gap_0" else 2.5e3
    out = TGD.chained_gap_cluster_ids(starts, ends, gap, device=CPU)
    ref = np.asarray(JGD.chained_gap_cluster_ids(starts, ends, gap))
    assert out.dtype == torch.int32 and ref.dtype == np.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), TG.chained_gap_cluster_ids(starts, ends, gap))


def test_segment_aggregates_match_jax_with_empty_segments():
    """num_segments beyond the event count: the padded rows are JAX's
    (zeros over the segment identities), dtypes included."""
    import jax

    rng = np.random.default_rng(5)
    ts = _timestamps(rng, 600)
    eid = np.array(JGD.anchor_window_event_ids(ts, 200_000.0))  # a writable copy
    areas, heights = rng.uniform(0, 50, 600), rng.uniform(-5, 5, 600)
    n_seg = int(eid[-1]) + 1 + 37
    with jax.enable_x64(True):
        ref = JGD.segment_aggregates(jnp.asarray(eid), jnp.asarray(ts), jnp.asarray(areas),
                                     jnp.asarray(heights), num_segments=n_seg)
        ref = {k: np.asarray(v) for k, v in ref.items()}
    out = TGD.segment_aggregates(torch.from_numpy(eid), torch.from_numpy(ts),
                                 torch.from_numpy(areas), torch.from_numpy(heights),
                                 num_segments=n_seg)
    assert sorted(out) == sorted(ref)  # a jitted function returns its dict keys sorted
    for k in ref:
        b = out[k].numpy()
        assert b.dtype == ref[k].dtype and b.shape == ref[k].shape, k
        if k == "area_sum":
            np.testing.assert_allclose(b, ref[k], rtol=1e-12, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(b, ref[k], err_msg=k)
    assert int(out["n_events"]) == n_seg - 37
    assert not out["n_hits"][-37:].any() and not out["t_min"][-37:].any()


def test_group_events_device_matches_jax():
    rng = np.random.default_rng(6)
    ts = rng.permutation(_timestamps(rng, 1200))
    areas, heights = rng.uniform(0, 50, 1200), rng.uniform(0, 5, 1200)
    ch = rng.integers(0, 4, 1200).astype(np.int16)
    ref = JGD.group_events_device(ts, ch, areas, heights, time_window_ns=200.0)
    out = TGD.group_events_device(ts, ch, areas, heights, time_window_ns=200.0, device=CPU)
    assert list(out) == list(ref)
    for k, v in ref.items():
        if k == "area_sum":
            np.testing.assert_allclose(out[k], v, rtol=1e-12, atol=0)
        else:
            assert np.asarray(out[k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(out[k], v, err_msg=k)
    empty = TGD.group_events_device(np.zeros(0, np.int64), [], [], [], 100.0, device=CPU)
    assert empty["n_events"] == 0 and empty["event_id"].dtype == np.int32


def _df_events(rng, n_events, max_hits=4, dtype=np.float32):
    cells = {"timestamps": [], "areas": [], "heights": [], "channels": []}
    spans, t = [], 0
    for _ in range(n_events):
        k = int(rng.integers(0, max_hits))  # 0 hits: NaN fill and empty cells
        cells["timestamps"].append(np.sort(rng.integers(t, t + 400_000, k)).astype(np.int64))
        cells["areas"].append(rng.normal(5, 1, k).astype(dtype))
        cells["heights"].append(rng.normal(0.5, 0.1, k).astype(dtype))
        cells["channels"].append(np.arange(k, dtype=np.int16))
        spans.append(float(rng.uniform(0, 200)))
        t += 1_000_000
    return pd.DataFrame({"event_id": np.arange(n_events), "dt/ns": spans,
                         "n_hits": [len(c) for c in cells["timestamps"]], **cells})


@pytest.mark.parametrize("n_events", [0, 96])
def test_pair_events_device_matches_jax(n_events):
    rng = np.random.default_rng(7)
    df_events = _df_events(rng, n_events)
    triples = [JG._flat_cells(df_events[c], dtype=np.int64 if c == "timestamps" else None)
               for c in ("timestamps", "areas", "heights")]
    span = np.asarray(df_events["dt/ns"], np.float64)
    ref = JGD.pair_events_device(*triples, span, 100.0, n_channels=3)
    out = TGD.pair_events_device(*triples, span, 100.0, n_channels=3, device=CPU)
    assert list(out) == list(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype and out[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    for backend in ("host", "device"):
        ref_df = JG.pair_events(df_events, 100.0, n_channels=3, start_channel=1, backend=backend)
        out_df = TG.pair_events(df_events, 100.0, n_channels=3, start_channel=1,
                                backend="device", device=CPU)
        _same_frame(ref_df, out_df, f"pair_events vs JAX {backend}")


@pytest.mark.parametrize("backend", ["host", "device"])
def test_grouping_entries_match_jax(backend):
    """group_multi_channel_hits, group_events_columnar, pair_events_columnar
    and group_hit_windows through the port's backend against the JAX
    package's same backend and its host oracle."""
    rng = np.random.default_rng(9)
    n = 2000
    df = pd.DataFrame({
        "timestamp": rng.permutation(_timestamps(rng, n)),
        "channel": rng.integers(0, 4, n).astype(np.int16),
        "area": rng.uniform(0, 100, n).astype(np.float32),
        "height": rng.uniform(0, 10, n).astype(np.float32),
    })
    kw = dict(backend=backend, device=CPU)
    for jb in (backend, "host"):
        _same_frame(JG.group_multi_channel_hits(df, 250.0, backend=jb),
                    TG.group_multi_channel_hits(df, 250.0, **kw), f"grouped {jb}")
        ref_cols = JG.group_events_columnar(df, 250.0, backend=jb)
        out_cols = TG.group_events_columnar(df, 250.0, **kw)
        assert list(out_cols) == list(ref_cols)
        for k in ref_cols:
            _same_cell(ref_cols[k], out_cols[k], f"columnar {jb} {k}")
        ev = {k: ref_cols[k] for k in ("event_id", "t_min", "t_max", "dt_ns", "n_hits",
                                       "hit_offset")}
        hits = {k: ref_cols[k] for k in ("hit_timestamp", "hit_area", "hit_height")}
        _same_frame(JG.pair_events_columnar(ev, hits, 100.0, 2, start_channel=6, backend=jb),
                    TG.pair_events_columnar(ev, hits, 100.0, 2, start_channel=6, **kw),
                    f"pair columnar {jb}")
    hits = {
        "timestamp": _timestamps(rng, n, gap=500_000),
        "position": rng.uniform(5, 20, n),
        "board": np.zeros(n, np.int16),
        "channel": rng.integers(0, 4, n).astype(np.int16),
        "height": rng.uniform(1, 10, n).astype(np.float32),
        "integral": rng.uniform(10, 100, n).astype(np.float32),
        "record_id": np.arange(n, dtype=np.int64),
        "dt": np.full(n, 2, np.int32),
        "sample_start": rng.integers(0, 10, n).astype(np.int32),
        "sample_end": rng.integers(20, 40, n).astype(np.int32),
    }
    for window in (0.0, 300.0):
        for jb in (backend, "host"):
            _same_frame(JG.group_hit_windows(hits, window, backend=jb),
                        TG.group_hit_windows(hits, window, **kw), f"hit windows {jb} {window}")
    empty = {k: v[:0] for k, v in hits.items()}
    assert len(TG.group_hit_windows(empty, 100.0, **kw)) == 0
    assert len(TG.group_multi_channel_hits(df[:0], 100.0, **kw)) == 0


def test_auto_picks_the_jax_backend():
    assert TG.DEVICE_BACKEND_MIN_ROWS == JG.DEVICE_BACKEND_MIN_ROWS == 1_000_000
    for n in (0, 999_999, 1_000_000):
        assert TG._resolve_backend("auto", n) == JG._resolve_backend("auto", n)
    with pytest.raises(ValueError):
        TG._resolve_backend("gpu", 1)


def test_device_backend_defaults_to_cuda(monkeypatch):
    """The device backend runs on the card unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TGD.anchor_window_event_ids(np.arange(4), 1.0)
    with pytest.raises(RuntimeError, match="cuda"):
        TG.group_multi_channel_hits(pd.DataFrame({
            "timestamp": [1, 2], "channel": [0, 1], "area": [1.0, 2.0],
            "height": [1.0, 2.0]}), 100.0, backend="device")


def _hit_columns(rng, n, with_optional=True):
    """A hit_threshold-like column set: 2 boards x 3 channels, runs of
    close hits (some in one record, some across records), mixed dt."""
    ts = np.sort(10**12 + np.cumsum(rng.integers(0, 40_000, n))).astype(np.int64)
    start = rng.integers(0, 30, n).astype(np.int32)
    hits = {
        "timestamp": ts,
        "position": (start + rng.integers(0, 5, n)).astype(np.int64),
        "height": rng.choice(np.array([5.0, 7.5, 9.0], np.float32), n),
        "integral": rng.uniform(10, 100, n).astype(np.float32),
        "edge_start": start,
        "edge_end": (start + rng.integers(1, 12, n)).astype(np.int32),
        "dt": rng.choice(np.array([2, 2, 2, 4], np.int32), n),
        "board": rng.integers(0, 2, n).astype(np.int16),
        "channel": rng.integers(0, 3, n).astype(np.int16),
        "record_id": (np.arange(n) // 3).astype(np.int64),
    }
    if with_optional:
        hits.update(width=(hits["edge_end"] - start).astype(np.float32),
                    rise_time=rng.uniform(0, 5, n).astype(np.float32),
                    fall_time=rng.uniform(0, 5, n).astype(np.float32))
    return hits


@pytest.mark.parametrize("gap, width, optional", [(0.0, 1e4, True), (40.0, 1e4, True),
                                                  (40.0, 60.0, False)],
                         ids=["no_merge", "merge", "merge_width_split"])
def test_merge_hits_matches_jax(gap, width, optional):
    """hit_merged's op (one pass of vectorised one-hit rows, a stable sort
    per channel in place of a scan per cluster) against the JAX package's
    merge_hits: every merged column, the cluster and component pairs."""
    from waveformanalysis_tpu.ops import hit_merge as jhm
    from waveformanalysis_tpu_torch.ops import hit_merge as thm

    hits = _hit_columns(np.random.default_rng(10), 3000, optional)
    ref = jhm.merge_hits(hits, merge_gap_ns=gap, max_total_width_ns=width)
    out = thm.merge_hits(hits, merge_gap_ns=gap, max_total_width_ns=width)
    assert list(out[0]) == list(ref[0])
    for k in ref[0]:
        assert out[0][k].dtype == ref[0][k].dtype, k
        np.testing.assert_array_equal(out[0][k], ref[0][k], err_msg=k)
    for a, b in zip(ref[1:], out[1:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    sizes = out[0]["component_count"]
    assert (sizes == 1).any() and ((sizes > 1).any() or gap == 0)


# ---------------------------------------------------------------------------
# chip_smoke.py's constants and the tutorial
# ---------------------------------------------------------------------------


def test_chip_smoke_ingest_constants(tmp_path):
    """chip_smoke.py's REF_INGEST_4096, recomputed with the JAX package's
    default profile on the run chip_smoke writes; the port's CPU Context
    gives the same."""
    import chip_smoke as cs

    assert cs.N_INGEST_REF == 4096 and cs.N_INGEST % (2 * cs.INGEST_FILES) == 0
    root = str(tmp_path / "DAQ")
    cs.write_ingest_run(root, "r", cs.N_INGEST_REF, seed=0)
    jctx = cs.ingest_context(JContext, jsets.tpu_default(), root, str(tmp_path / "jax"))
    jctx.get_data("r", cs.INGEST_REQUEST)
    got = cs.ingest_counts(jctx, "r")
    assert got == cs.REF_INGEST_4096
    assert got["n_s1"] == got["n_s2"] == cs.N_INGEST_REF // 2  # S1 even, S2 odd rows
    tctx = cs.ingest_context(TContext, tsets.get_profile("cuda"), root, str(tmp_path / "port"),
                             device=CPU)
    tctx.get_data("r", cs.INGEST_REQUEST)
    assert cs.ingest_counts(tctx, "r") == got
    for ctx in (jctx, tctx):
        ctx.flush_saves()


def test_tutorial_on_cpu(capsys):
    from waveformanalysis_tpu_torch.examples import tutorial

    out = tutorial.main(["--device", "cpu"])
    assert out == {"st_waveforms": 192, "df": 192, "df_paired": 96, "key_changed": True}
    printed = capsys.readouterr().out
    assert "device: cpu" in printed and "waves.png" in printed
