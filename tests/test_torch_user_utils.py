"""The port's user utilities on the CPU, against the JAX package.

``utils/io.py`` (the flat-pool parse, the generator, row counts),
``utils/event_filters.py`` (every filter on one seeded df_events-like frame)
and ``utils/preview.py`` (``WaveformPreviewer``'s loads, features, summary
and plots, ``preview_waveforms``, ``plot_records_waveforms``) on the same
files and frames in both packages; then the slice as a whole on a 4,096 x
256 VX2730 run (``make_synthetic_vx2730_run``): a port CPU Context and a
JAX Context give the same ``StraxContextAdapter.get_df(run, "df_paired")``,
the same filtered ``df_events`` and the same ``plot_records_waveforms``
lines. Last, the device boundary: tensors that refuse NumPy as CUDA
tensors do never reach the plots, ``RecordsView`` or the strax facade.

Tolerance: parsed arrays, Tables, filtered frames and plot lines exactly;
f64 preview features exactly; df_paired's integer columns exactly and its
float32 columns within atol 1e-3 / rtol 1e-4 (the feature kernels' split).
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from torch_figures import assert_same_figure  # noqa: E402
from waveformanalysis_tpu.context.context import Context as JContext  # noqa: E402
from waveformanalysis_tpu.plugins import plugin_sets as jsets  # noqa: E402
from waveformanalysis_tpu.plugins.adapters import StraxContextAdapter as JStrax  # noqa: E402
from waveformanalysis_tpu.utils import event_filters as JF  # noqa: E402
from waveformanalysis_tpu.utils import io as JIO  # noqa: E402
from waveformanalysis_tpu.utils import preview as JP  # noqa: E402
from waveformanalysis_tpu_torch.context.context import Context as TContext  # noqa: E402
from waveformanalysis_tpu_torch.dtypes.table import Table  # noqa: E402
from waveformanalysis_tpu_torch.plugins import plugin_sets as tsets  # noqa: E402
from waveformanalysis_tpu_torch.plugins.adapters import StraxContextAdapter as TStrax  # noqa: E402
from waveformanalysis_tpu_torch.testing.fixtures import make_synthetic_vx2730_run  # noqa: E402
from waveformanalysis_tpu_torch.utils import event_filters as TF  # noqa: E402
from waveformanalysis_tpu_torch.utils import io as TIO  # noqa: E402
from waveformanalysis_tpu_torch.utils import preview as TP  # noqa: E402

ATOL, RTOL = 1e-3, 1e-4


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


@pytest.fixture(scope="module")
def daq(tmp_path_factory):
    """A VX2730 run of 2 channels x 3 files x 40 rows, channel 1 staggered."""
    root = tmp_path_factory.mktemp("daq")
    make_synthetic_vx2730_run(str(root), "run_io", n_channels=2, n_files_per_channel=3,
                              n_rows=40, n_samples=64, noise=4, seed=2,
                              channel_offset_ps=30_000)
    return root


def _files(root, run="run_io"):
    from waveformanalysis_tpu_torch.formats.adapter import get_adapter

    by_channel = get_adapter("vx2730").scan_run(str(root), run)
    return [by_channel[ch] for ch in sorted(by_channel)]


def _same_tables(ref, got, tag):
    assert list(got.field_names) == list(ref.field_names) and len(got) == len(ref), tag
    for f in ref.field_names:
        a, b = np.asarray(ref[f]), np.asarray(got[f])
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{tag}.{f}"


# ---------------------------------------------------------------------------
# io
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_jobs", [None, 1, 3])
def test_parse_and_stack_files_matches_jax(daq, n_jobs):
    files = _files(daq) + [[]]  # an empty channel stays None
    ref = JIO.parse_and_stack_files(files, n_jobs=n_jobs)
    got = TIO.parse_and_stack_files(files, n_jobs=n_jobs)
    assert len(got) == len(ref) == 3 and got[2] is None and ref[2] is None
    for a, b in zip(ref[:2], got[:2]):
        assert b.shape == a.shape == (120, a.shape[1]) and b.dtype == a.dtype
        assert np.array_equal(a, b)
    assert TIO.parse_and_stack_files([[], []]) == [None, None]


def test_parse_generator_and_count_rows_match_jax(daq):
    files = _files(daq)
    for chunk in (1, 2, 10):
        ref = list(JIO.parse_files_generator(files, chunk_files=chunk))
        got = list(TIO.parse_files_generator(files, chunk_files=chunk))
        assert [c for c, _ in got] == [c for c, _ in ref]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(ref, got))
    assert TIO.count_rows(files) == JIO.count_rows(files) == [120, 120]


# ---------------------------------------------------------------------------
# event filters
# ---------------------------------------------------------------------------


def _events_frame(n=300, seed=9):
    """A df_events-shaped frame: 1-4 hits an event on channels 0-3, ps
    timestamps, float32 areas."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        k = int(rng.integers(1, 5))
        ch = rng.choice(4, size=k, replace=False).astype(np.int16)
        ts = (i * 10**6 + rng.integers(0, 300_000, k)).astype(np.int64)
        rows.append({"event_id": i, "t_min": int(ts.min()), "t_max": int(ts.max()),
                     "dt/ns": (ts.max() - ts.min()) / 1e3, "n_hits": np.int32(k),
                     "channels": ch, "areas": rng.uniform(10, 900, k).astype(np.float32),
                     "heights": rng.uniform(5, 300, k).astype(np.float32),
                     "timestamps": ts})
    return pd.DataFrame(rows)


FILTERS = {
    "n_hits": lambda m, df: m.filter_by_n_hits(df, min_hits=2, max_hits=3),
    "n_hits_open": lambda m, df: m.filter_by_n_hits(df),
    "channels": lambda m, df: m.filter_by_channels(df, [0, 2]),
    "channels_exact": lambda m, df: m.filter_by_channels(df, [1, 3], exact=True),
    "time_span": lambda m, df: m.filter_by_time_span(df, 150.0),
    "coincidence": lambda m, df: m.filter_coincidence(df, 0, 1, max_dt_ns=120.0),
    "function_rows": lambda m, df: m.filter_events_by_function(
        df, lambda row: row["n_hits"] % 2 == 0),
    "function_vector": lambda m, df: m.filter_events_by_function(
        df, lambda col: col > 1.5, column="n_hits"),
    "function_cells": lambda m, df: m.filter_events_by_function(
        df, lambda a: float(np.max(a)) > 500.0, column="areas"),
    "coincidence_events": lambda m, df: m.filter_coincidence_events(df, [0, 3]),
    "area": lambda m, df: m.filter_by_area(df, min_total_area=400.0, max_total_area=1500.0),
    "area_min": lambda m, df: m.filter_by_area(df, min_total_area=900.0),
}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_event_filter_matches_jax(name):
    df = _events_frame()
    ref, got = FILTERS[name](JF, df.copy()), FILTERS[name](TF, df.copy())
    assert 0 < len(got) < len(df), name
    pd.testing.assert_frame_equal(got, ref)


def test_extract_channel_attributes_matches_jax():
    df = _events_frame()
    for attr in ("areas", "heights", "timestamps"):
        ref = JF.extract_channel_attributes(df, [0, 1, 3], attribute=attr)
        got = TF.extract_channel_attributes(df, [0, 1, 3], attribute=attr)
        assert list(got) == list(ref)
        for ch in ref:
            assert np.array_equal(np.asarray(got[ch]), np.asarray(ref[ch])), (attr, ch)


# ---------------------------------------------------------------------------
# preview
# ---------------------------------------------------------------------------


@pytest.fixture
def previewers(daq):
    return (JP.WaveformPreviewer(str(daq), "run_io"), TP.WaveformPreviewer(str(daq), "run_io"))


@pytest.mark.parametrize("channel,start,n,max_files", [
    (0, 0, 16, None), (0, 35, 20, None), (1, 100, 50, None), (1, 0, 60, 1), (5, 0, 4, None),
])
def test_previewer_load_events_matches_jax(previewers, channel, start, n, max_files):
    jp, tp = previewers
    ref = jp.load_events(channel, start=start, n_events=n, max_files=max_files)
    got = tp.load_events(channel, start=start, n_events=n, max_files=max_files)
    _same_tables(ref, got, "load_events")
    fr, fg = jp.preview_features(ref), tp.preview_features(got)
    assert list(fg) == list(fr)
    for k in fr:  # f64 features exactly
        assert fg[k].dtype == fr[k].dtype and np.array_equal(fg[k], fr[k]), k
    assert tp.summary(got) == jp.summary(ref)


@pytest.mark.parametrize("channel,lo,hi", [(0, 0, 200_000_000), (1, 350_000_000, 900_000_000),
                                          (0, 10**15, 10**15 + 1)])
def test_previewer_load_by_timestamp_matches_jax(previewers, channel, lo, hi):
    jp, tp = previewers
    _same_tables(jp.load_by_timestamp(channel, lo, hi), tp.load_by_timestamp(channel, lo, hi),
                 "load_by_timestamp")


def test_previewer_plots_match_jax(previewers):
    jp, tp = previewers
    ref, got = jp.load_events(0, n_events=10), tp.load_events(0, n_events=10)
    for kwargs in ({}, {"annotate": True}, {"annotate": True, "dt": 2.0}):
        assert_same_figure(jp.plot_overlay(ref, max_events=6, **kwargs),
                           tp.plot_overlay(got, max_events=6, **kwargs), f"overlay {kwargs}")
    assert_same_figure(jp.plot_grid(ref, n_cols=3, max_events=7, annotate=True),
                       tp.plot_grid(got, n_cols=3, max_events=7, annotate=True), "grid")
    with pytest.warns(DeprecationWarning):
        fig = tp.plot_grid(got, n_cols=2, max_events=2, sampling_interval_ns=4.0)
    assert fig.axes[0].lines[0].get_xdata()[1] == 4.0


@pytest.mark.parametrize("kwargs", [
    {"event_range": (2, 9)},
    {"timestamp_range": (0, 60_000_000), "plot_mode": "grid"},
])
def test_preview_waveforms_matches_jax(daq, tmp_path, kwargs):
    ref = JP.preview_waveforms("run_io", 1, data_root=str(daq), **kwargs)
    got = TP.preview_waveforms("run_io", 1, data_root=str(daq),
                               save_path=str(tmp_path / "p.png"), **kwargs)
    assert_same_figure(ref, got, str(kwargs))
    assert (tmp_path / "p.png").stat().st_size > 0
    with pytest.raises(ValueError, match="exactly one"):
        TP.preview_waveforms("run_io", 1, data_root=str(daq))
    with pytest.raises(ValueError, match="invalid plot_mode"):
        TP.preview_waveforms("run_io", 1, data_root=str(daq), event_range=(0, 2),
                             plot_mode="nope")


# ---------------------------------------------------------------------------
# the slice as a whole: 4,096 x 256 through both Contexts
# ---------------------------------------------------------------------------

SLICE_RUN = "run_slice"


@pytest.fixture(scope="module")
def contexts(tmp_path_factory):
    """A JAX Context and a port CPU Context over one 4,096 x 256 VX2730 run
    (2 channels x 2,048 rows, channel 1 staggered 20 ns, default profiles)."""
    root = tmp_path_factory.mktemp("slice")
    daq = root / "DAQ"
    make_synthetic_vx2730_run(str(daq), SLICE_RUN, n_channels=2, n_files_per_channel=2,
                              n_rows=1024, n_samples=256, noise=6, seed=13,
                              channel_offset_ps=20_000)
    out = {}
    for side, cls, profile, extra in (("jax", JContext, jsets.tpu_default(), {}),
                                      ("port", TContext, tsets.get_profile("cuda"),
                                       {"device": "cpu"})):
        ctx = cls(storage_dir=str(root / side), config={
            "data_root": str(daq), "daq_adapter": "vx2730", "n_channels": 2,
            "show_progress": False, **extra})
        ctx.register(*profile)
        out[side] = ctx
    yield out
    for ctx in out.values():
        ctx.flush_saves()


def test_strax_get_df_of_df_paired_matches_jax(contexts):
    ref = JStrax(contexts["jax"]).get_df(SLICE_RUN, "df_paired")
    got = TStrax(contexts["port"]).get_df(SLICE_RUN, "df_paired")
    assert len(ref) == 2048 and list(got.columns) == list(ref.columns)
    assert list(got.dtypes) == list(ref.dtypes)
    for col in ref.columns:
        if ref[col].dtype == np.float32:
            np.testing.assert_allclose(got[col], ref[col], atol=ATOL, rtol=RTOL, err_msg=col)
        else:
            pd.testing.assert_series_equal(got[col], ref[col], check_exact=True)


@pytest.mark.parametrize("name", ["n_hits", "channels", "coincidence", "area", "function_cells"])
def test_filtered_df_events_match_jax(contexts, name):
    """The same filter on each Context's df_events gives the same rows; the
    area filter cuts at the JAX frame's median total area."""
    ref = contexts["jax"].get_data(SLICE_RUN, "df_events")
    got = contexts["port"].get_data(SLICE_RUN, "df_events")
    if name == "area":
        cut = float(np.median([np.sum(a) for a in ref["areas"]]))
        apply = (lambda m, df: m.filter_by_area(df, min_total_area=cut))
    elif name == "coincidence":
        apply = (lambda m, df: m.filter_coincidence(df, 0, 1, max_dt_ns=25.0))
    elif name == "channels":
        apply = (lambda m, df: m.filter_by_channels(df, [0, 1]))
    else:
        apply = FILTERS[name]
    fr, fg = apply(JF, ref), apply(TF, got)
    assert len(fr) > 0
    assert fg["event_id"].tolist() == fr["event_id"].tolist()
    for col in ("n_hits", "t_min", "t_max"):
        np.testing.assert_array_equal(fg[col].to_numpy(), fr[col].to_numpy())
    for col in ("channels", "timestamps"):
        assert all(np.array_equal(a, b) for a, b in zip(fr[col], fg[col])), col
    for a, b in zip(fr["areas"], fg["areas"]):
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kwargs", [
    {}, {"record_ids": [5, 4000, 17]}, {"channel": 1, "limit": 4, "sample_start": 10,
                                        "sample_end": 200, "show_baseline": False},
])
def test_plot_records_waveforms_matches_jax(contexts, kwargs):
    ref = JP.plot_records_waveforms(contexts["jax"], SLICE_RUN, title="r", **kwargs)
    got = TP.plot_records_waveforms(contexts["port"], SLICE_RUN, title="r", **kwargs)
    assert_same_figure(ref, got, str(kwargs))


# ---------------------------------------------------------------------------
# the device boundary
# ---------------------------------------------------------------------------


class CardTensor(torch.Tensor):
    """A CPU tensor that refuses NumPy as a CUDA tensor does: np.asarray
    and .numpy() raise; .cpu() fetches a plain tensor."""

    def __array__(self, *args, **kwargs):
        raise TypeError("can't convert cuda:0 device type tensor to numpy")

    def numpy(self, *args, **kwargs):
        raise TypeError("can't convert cuda:0 device type tensor to numpy")

    def cpu(self, *args, **kwargs):
        return self.as_subclass(torch.Tensor).clone()


def _card(table):
    """A Table whose numeric columns are CardTensors."""
    return Table({k: torch.from_numpy(np.ascontiguousarray(np.asarray(v))).as_subclass(CardTensor)
                  for k, v in table.columns.items()}, schema=table.schema, validate=False)


class CardContext:
    """A Context stand-in whose tables hold their columns on the 'card'."""

    def __init__(self, ctx, run):
        self.ctx, self.run = ctx, run

    def get_data(self, run_id, name, **kwargs):
        data = self.ctx.get_data(self.run, name)
        if isinstance(data, Table):
            return _card(data)
        if isinstance(data, np.ndarray) and data.dtype.names is None:
            return torch.from_numpy(data).as_subclass(CardTensor)
        return data


def test_card_tensor_refuses_numpy():
    t = torch.arange(3).as_subclass(CardTensor)
    with pytest.raises(TypeError, match="cuda"):
        np.asarray(t)
    with pytest.raises(TypeError, match="cuda"):
        np.asarray(_card(Table({"x": np.arange(3)}))["x"])


def test_no_device_tensor_reaches_host_utilities(contexts):
    """Tables with device columns and a device wave pool, as a Context holds
    them inside a request: the browser, plot_waveforms, the records plot,
    the strax facade and a wrapped strax plugin read them on the host, and
    draw or return what the host tables give."""
    from waveformanalysis_tpu_torch.plugins.adapters import wrap_strax_plugin
    from waveformanalysis_tpu_torch.utils.visualization import (
        create_interactive_browser,
        plot_waveforms,
    )

    port = contexts["port"]
    card = CardContext(port, SLICE_RUN)
    assert isinstance(card.get_data(SLICE_RUN, "hit")["position"], CardTensor)
    assert isinstance(card.get_data(SLICE_RUN, "wave_pool"), CardTensor)

    assert_same_figure(create_interactive_browser(port, SLICE_RUN)(3),
                       create_interactive_browser(card, SLICE_RUN)(3), "browser")
    st = port.get_data(SLICE_RUN, "st_waveforms")
    hits = port.get_data(SLICE_RUN, "hit")
    assert_same_figure(plot_waveforms(st, hits=hits, event_index=1),
                       plot_waveforms(_card(st), hits=_card(hits), event_index=1), "structured")
    waves, few = np.asarray(st["wave"][:6]), hits.select(np.arange(12))
    assert_same_figure(
        plot_waveforms(waves, baselines=np.asarray(st["baseline"][:6]), hits=few),
        plot_waveforms(torch.from_numpy(waves).as_subclass(CardTensor),
                       baselines=_card(st)["baseline"][:6], hits=_card(few)), "flat")
    assert_same_figure(TP.plot_records_waveforms(port, SLICE_RUN, limit=3),
                       TP.plot_records_waveforms(card, SLICE_RUN, limit=3), "records")

    facade = TStrax(card)
    arr = facade.get_array(SLICE_RUN, "hit")
    assert isinstance(arr, np.ndarray) and np.array_equal(arr, hits.to_numpy())
    pool = facade.get_array(SLICE_RUN, "wave_pool")
    assert isinstance(pool, np.ndarray)
    assert np.array_equal(pool, np.asarray(port.get_data(SLICE_RUN, "wave_pool")))
    pd.testing.assert_frame_equal(facade.get_df(SLICE_RUN, "hit"),
                                  TStrax(port).get_df(SLICE_RUN, "hit"))

    seen = {}

    class CountHits:
        provides = "n_hit_rows"
        depends_on = ("wave_pool",)

        def compute(self, wave_pool):
            seen["type"] = type(wave_pool)
            return np.array([(len(wave_pool),)], dtype=[("n", np.int64)])

    assert wrap_strax_plugin(CountHits).compute(card, SLICE_RUN)["n"][0] == len(pool)
    assert seen["type"] is np.ndarray
